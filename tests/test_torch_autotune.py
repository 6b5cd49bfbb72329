"""The kernels' variant builds (``msda_tpu_torch.ops._build`` with
``defines=``) and the launch-constant sweep's plan
(``msda_tpu_torch.autotune``), on the CPU with ``find_nvcc`` and
``subprocess.Popen`` stubbed: the commands that would run, not a build."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

from msda_tpu_torch import autotune
from msda_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "msda_tpu_torch" / "csrc"


class _FakeNvcc:
    """Records each command; "builds" by writing the ``-o`` file."""

    def __init__(self, cmd, **kwargs):
        self.cmd = cmd
        self.returncode = 0
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        _FakeNvcc.calls.append(cmd)

    def communicate(self):
        return "", "ptxas info: 0 bytes spill"

    def poll(self):
        return self.returncode


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    _FakeNvcc.calls = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/fake/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    return _FakeNvcc.calls


def _split(cmd, tmp_path, stem):
    """The command with its temporary output replaced by a marker, after
    checking that it is a fresh file of the build directory."""
    i = cmd.index("-o") + 1
    out = Path(cmd[i])
    assert out.parent == tmp_path and re.fullmatch(
        rf"\.{re.escape(stem)}\.\w+\.so", out.name), out
    return [*cmd[:i], "<tmp>", *cmd[i + 1:]]


@pytest.mark.parametrize("name", ["msda_fwd", "msda_bwd", "msda_stream"])
def test_default_build_command_is_unchanged(fake_nvcc, tmp_path, name):
    """Without defines, the nvcc command is the one the build always ran:
    nvcc, the flags, -o, the source; no -D flag."""
    _build.build([name])
    (cmd,) = fake_nvcc
    assert _split(cmd, tmp_path, name) == [
        "/fake/cuda/bin/nvcc",
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", "<tmp>", str(CSRC / f"{name}.cu")]
    assert (tmp_path / f"lib{name}.so").exists()
    assert _build.build_log(name) == "ptxas info: 0 bytes spill"


def test_variant_build_flags_and_library_name(fake_nvcc, tmp_path):
    defines = {"STREAM_SLICE": 256, "BWD_CHUNKS_PER_BLOCK": 16}
    stem = "msda_stream-BWD_CHUNKS_PER_BLOCK=16-STREAM_SLICE=256"
    assert _build.variant("msda_stream", defines) == stem
    assert _build.variant("msda_stream") == "msda_stream"
    _build.build(["msda_stream"], defines)
    (cmd,) = fake_nvcc
    assert _split(cmd, tmp_path, stem) == [
        "/fake/cuda/bin/nvcc", *_build.NVCC_FLAGS,
        "-DBWD_CHUNKS_PER_BLOCK=16", "-DSTREAM_SLICE=256",
        "-o", "<tmp>", str(CSRC / "msda_stream.cu")]
    assert (tmp_path / f"lib{stem}.so").exists()
    assert not (tmp_path / "libmsda_stream.so").exists()


def test_variants_build_side_by_side_and_only_when_stale(fake_nvcc, tmp_path):
    """One define mapping a name: every variant at once, one nvcc each;
    a second build finds them current."""
    todo = autotune.variants(autotune.CANDIDATES)
    names = ["msda_fwd"] * len(todo)
    _build.build(names, [d for _, d in todo])
    assert sorted(Path(c[c.index("-o") + 1]).name.split(".")[1]
                  for c in fake_nvcc) == sorted(
        _build.variant("msda_fwd", d) for _, d in todo)
    _build.build(names, [d for _, d in todo])
    assert len(fake_nvcc) == len(todo)


def test_candidate_lists():
    """Each constant's candidates, its default (the source's value) first,
    and the sweep's variants: the default, then one constant moved."""
    assert autotune.CANDIDATES == {
        "MSDA_FWD_WARPS": (4, 2, 8),
        "MSDA_FWD_STAGES": (3, 2, 4),
        "MSDA_FWD_BLOCKS_PER_SM": (8, 4, 16),
        "MSDA_FWD_CHUNK": (32, 8, 64),
        "MSDA_FWD_BATCH": (2, 1, 4),
        "MSDA_BWD_WARPS": (4, 2, 8),
        "MSDA_BWD_STAGES": (3, 2, 4),
        "MSDA_BWD_BLOCKS_PER_SM": (8, 4, 16),
        "MSDA_BWD_CHUNK": (32, 8, 64),
        "MSDA_BWD_BATCH": (4, 1, 2),
    }
    assert autotune.STREAM_CANDIDATES == {
        "STREAM_SLICE": (512, 256, 1024),
        "FWD_CHUNKS_PER_BLOCK": (4, 2, 8),
        "BWD_CHUNKS_PER_BLOCK": (8, 4, 16),
    }
    sources = "".join((CSRC / f).read_text() for f in (
        "msda_fwd_plan.cuh", "msda_bwd_plan.cuh", "msda_stream.cu"))
    for name, values in {**autotune.CANDIDATES,
                         **autotune.STREAM_CANDIDATES}.items():
        guard = rf"#ifndef {name}\n#define {name} (\d+)\n#endif"
        assert int(re.search(guard, sources).group(1)) == values[0], name
    assert autotune.variants(autotune.STREAM_CANDIDATES, 2) == [
        ("default", {}),
        ("STREAM_SLICE=256", {"STREAM_SLICE": 256}),
        ("FWD_CHUNKS_PER_BLOCK=2", {"FWD_CHUNKS_PER_BLOCK": 2}),
        ("BWD_CHUNKS_PER_BLOCK=4", {"BWD_CHUNKS_PER_BLOCK": 4}),
    ]
    assert len(autotune.variants(autotune.CANDIDATES)) == 21
    # K1's constants reach K1 alone, K2's K2 alone
    assert autotune.reached({}) == ("msda_fwd", "msda_bwd")
    assert autotune.reached({"MSDA_FWD_STAGES": 3}) == ("msda_fwd",)
    assert autotune.reached({"MSDA_BWD_STAGES": 2}) == ("msda_bwd",)
    assert autotune.reached({"STREAM_SLICE": 256}, True) == ("msda_stream",)


def test_help():
    run = subprocess.run([sys.executable, "-m", "msda_tpu_torch.autotune",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    for flag in ("--stream", "--queries", "--dtype", "--iters",
                 "--per-constant"):
        assert flag in run.stdout


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(autotune.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        autotune.main(["--per-constant", "2"])
