"""The import guard: the reference imports nothing of the program, the
JAX package or JAX; nothing in the benchmark imports the JAX package or
JAX; a run refuses when such a module is loaded, without a card, and in a
directory that holds only the benchmark."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

BENCH_DIR = harness.ROOT / "perfbench"


def _imports(path) -> set[str]:
    """The top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"msda_tpu_torch", "msda_tpu", "jax",
                                 "jaxlib", "flax", "optax", "orbax"}


def test_benchmark_imports_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "msda_tpu_torch_extra", sys)
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "msda_tpu.ops", sys)
    assert set(harness.forbidden_modules()) - set(before) == {
        "jax.numpy", "msda_tpu.ops"}


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "msda-op-ddetr.enc-f32-800x1333", "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_line():
    done = _command(harness.ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA" in done.stderr


def test_benchmark_alone_prints_no_line(tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``perfbench/``: the
    program is not there, so no run is made."""
    shutil.copytree(BENCH_DIR, tmp_path / "perfbench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    done = _command(tmp_path)
    assert done.returncode != 0 and done.stdout == ""
    with pytest.raises((harness.Refused, ImportError)):
        harness.program_in(tmp_path)


def test_a_loaded_jax_module_refuses_the_run(monkeypatch, capsys):
    """The guard runs once the window has closed, on what the process
    loaded: a run that ends with a JAX module loaded prints no line."""
    import torch

    monkeypatch.setitem(sys.modules, "flax.linen", sys)

    def fake_execute(*args, **kwargs):
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(harness, "execute", fake_execute)
    code = harness.main(["--workload", "msda-op-ddetr.enc-f32-800x1333",
                         "--seed", "1", "--seconds", "1"], started=0.0,
                        device=torch.device("cpu"))
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "flax.linen" in out.err
