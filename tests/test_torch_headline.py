"""``python -m msda_tpu_torch.headline`` (the port's counterpart of root
``bench.py``) on the CPU.

The lines' names, modes, dtypes and anchors are held against the
``configs`` of ``bench.py`` (read from its source: importing it would
import JAX's TPU probing); ``vs_baseline`` is the anchor over the value;
``--device cpu`` on a small workload prints the one reference line and
exits 0; without a card and without ``--device cpu`` it prints an error
line and exits non-zero (this machine has no card); a line that fails
makes the run exit non-zero.  The card's three lines are driven with a
stubbed measurement, so that their order, names and exit status are
checked here too.
"""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from msda_tpu_torch import headline

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_queries=10, shapes=((8, 8), (4, 4)), iters=2, repeats=1)
KEYS = ["metric", "value", "unit", "vs_baseline"]


def _bench_configs():
    """bench.py's (metric, dtype name, mode, anchor) tuples, in order."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Tuple) and len(node.elts) == 4
                and isinstance(node.elts[0], ast.Constant)
                and str(node.elts[0].value).startswith("MSDA ")):
            name, dtype, mode, anchor = node.elts
            found.append((name.value, dtype.attr, mode.value, anchor.value))
    return found


def _lines(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def test_lines_are_bench_py_configs():
    want = _bench_configs()
    assert len(want) == 3
    got = [(name, str(dtype).removeprefix("torch."), mode, anchor)
           for name, dtype, mode, anchor in headline.CONFIGS]
    assert got == want
    assert headline.NUM_QUERIES == 10000
    assert headline.ITERS == {"cuda": (150, 3), "cpu": (15, 2)}


@pytest.mark.parametrize("ms", [2.5, 0.1234567, 31.0])
def test_vs_baseline_is_anchor_over_value(ms):
    line = headline._line("m (cuda)", ms, 22.78)
    assert list(line) == KEYS
    assert line["value"] == round(ms, 3) and line["unit"] == "ms"
    assert line["vs_baseline"] == round(22.78 / ms, 4)


def test_cpu_small_workload_prints_the_reference_line(capsys):
    assert headline.main(["--device", "cpu"], **SMALL) == 0
    out = capsys.readouterr()
    lines = _lines(out.out)
    assert len(lines) == 1 and list(lines[0]) == KEYS
    line = lines[0]
    assert line["metric"] == ("MSDA fwd+bwd latency @10k queries fp32 "
                              "(reference)")
    assert math.isfinite(line["value"]) and line["value"] > 0
    # the ratio is taken before the value is rounded to 3 decimals, and
    # is itself rounded to 4
    ratio = 22.78 / line["value"]
    assert abs(line["vs_baseline"] - ratio) <= (
        5e-5 + ratio * 0.0005 / line["value"])
    # every kernel's count, the streamed kernels' too; the CPU launches none
    launches = [json.loads(text[len("launches "):])
                for text in out.err.splitlines()
                if text.startswith("launches ")]
    assert launches == [{"msda_fwd": 0, "msda_bwd": 0, "msda_stream_bin": 0,
                         "msda_stream_fwd": 0, "msda_stream_bwd": 0}]


def test_no_card_prints_an_error_and_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the error path is not taken")
    proc = subprocess.run([sys.executable, "-m", "msda_tpu_torch.headline"],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    lines = _lines(proc.stdout)
    assert len(lines) == 1
    assert "error" in lines[0] and lines[0]["value"] is None
    assert lines[0]["metric"].endswith("(cuda)")


def _card_stub(monkeypatch, fail=None):
    """Pretend a card is visible and measure each line as a fixed time;
    the line of dtype/mode ``fail`` raises or returns ``fail[2]``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []

    def measure(dtype, mode, impl, device, iters, repeats, num_queries,
                shapes):
        calls.append((dtype, mode, impl, device.type, iters, repeats,
                      num_queries))
        if fail is not None and (dtype, mode) == fail[:2]:
            if fail[2] == "raise":
                raise RuntimeError("forced failure")
            return fail[2]
        return {"fwdbwd": 1.5, "fwd": 0.25}[mode]

    monkeypatch.setattr(headline, "measure", measure)
    return calls


def test_card_lines_in_bench_py_order(monkeypatch, capsys):
    calls = _card_stub(monkeypatch)
    assert headline.main([]) == 0
    lines = _lines(capsys.readouterr().out)
    assert [line["metric"] for line in lines] == [
        f"{name} (cuda)" for name, *_ in headline.CONFIGS]
    assert [line["value"] for line in lines] == [1.5, 1.5, 0.25]
    assert [line["vs_baseline"] for line in lines] == [
        round(22.78 / 1.5, 4), round(22.78 / 1.5, 4), round(3.78 / 0.25, 4)]
    assert all(c[2:] == ("cuda", "cuda", 150, 3, 10000) for c in calls)


@pytest.mark.parametrize("fail", [
    (torch.bfloat16, "fwdbwd", "raise"),
    (torch.float32, "fwd", float("nan")),
    (torch.float32, "fwdbwd", float("inf")),
    (torch.float32, "fwd", None),
], ids=["raises", "nan", "inf", "none"])
def test_a_failed_line_fails_the_run(monkeypatch, capsys, fail):
    _card_stub(monkeypatch, fail)
    assert headline.main([]) != 0
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 3  # the other lines are still measured
    bad = [line for line in lines if line["value"] is None]
    assert len(bad) == 1 and "error" in bad[0]
    assert bad[0]["vs_baseline"] is None


def test_cpu_failure_fails_the_run(monkeypatch, capsys):
    def measure(*args, **kwargs):
        raise RuntimeError("forced failure")

    monkeypatch.setattr(headline, "measure", measure)
    assert headline.main(["--device", "cpu"], **SMALL) == 1
    (line,) = _lines(capsys.readouterr().out)
    assert line["value"] is None and "forced failure" in line["error"]
