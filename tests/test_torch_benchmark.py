"""The op benchmark's incremental CSV and ``--resume``
(``python -m msda_tpu_torch.benchmark``, the counterpart of
``scripts/benchmark.py:212-343``) on the CPU.

Each row is flushed to ``<out>.partial`` as it is measured and the file
renamed to ``<out>`` at the end; ``--resume`` skips the (impl, dtype, N)
rows already in either file.  A cut sweep is simulated by a measurement
that raises at a given row; a row cut mid-line is written by hand.
"""

import csv
import subprocess
import sys
from pathlib import Path

import pytest

from msda_tpu_torch import benchmark

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--impls", "reference", "--no-memory",
        "--queries", "10", "100"]
JAX_FIELDS = ["impl", "dtype", "num_queries", "fwd_ms", "fwdbwd_ms",
              "peak_mem_mb"]


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _fake_bench(calls, cut_at=None):
    """A measurement that records its N and raises at N == cut_at."""
    def bench(impl, dtype, n, pyramid, device, memory=True):
        if n == cut_at:
            raise KeyboardInterrupt("sweep cut")
        calls.append(n)
        return dict(impl=impl, dtype=str(dtype).removeprefix("torch."),
                    num_queries=n, fwd_ms=0.5 + n, fwdbwd_ms=1.5 + n,
                    peak_mem_mb=float("nan"))
    return bench


def test_cli_second_run_measures_nothing_new(tmp_path):
    out = tmp_path / "sweep.csv"

    def run(*extra):
        proc = subprocess.run(
            [sys.executable, "-m", "msda_tpu_torch.benchmark", *ARGS,
             "--out", str(out), *extra],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    first = run()
    assert first.count("(measured)") == 2
    rows = _read(out)
    assert not (tmp_path / "sweep.csv.partial").exists()
    second = run("--resume")
    assert "resume: 2 rows already measured" in second
    assert second.count("(resumed)") == 2 and "(measured)" not in second
    assert _read(out) == rows


def test_a_cut_sweep_leaves_a_partial_csv_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "sweep.csv"
    calls = []
    monkeypatch.setattr(benchmark, "bench", _fake_bench(calls, cut_at=100))
    with pytest.raises(KeyboardInterrupt):
        benchmark.main(ARGS + ["--out", str(out)])
    assert not out.exists()
    partial = _read(str(out) + ".partial")
    assert list(partial[0]) == benchmark.FIELDS
    assert [r["num_queries"] for r in partial] == ["10"]

    calls.clear()
    monkeypatch.setattr(benchmark, "bench", _fake_bench(calls))
    rows = benchmark.main(ARGS + ["--out", str(out), "--resume"])
    assert calls == [100]  # only the missing row
    assert [r["num_queries"] for r in rows] == [10, 100]
    assert [r["num_queries"] for r in _read(out)] == ["10", "100"]
    assert _read(out)[0] == partial[0]
    assert not (tmp_path / "sweep.csv.partial").exists()


def test_a_row_cut_mid_line_is_measured_again(tmp_path, monkeypatch):
    out = tmp_path / "sweep.csv"
    partial = tmp_path / "sweep.csv.partial"
    partial.write_text(
        ",".join(benchmark.FIELDS) + "\n"
        "reference,float32,10,0.25,0.75,nan,cpu,\n"
        "reference,float32,100,0.3")  # the second row cut mid-line
    calls = []
    monkeypatch.setattr(benchmark, "bench", _fake_bench(calls))
    rows = benchmark.main(ARGS + ["--out", str(out), "--resume"])
    assert calls == [100]
    assert rows[0]["fwd_ms"] == 0.25 and rows[0]["fwdbwd_ms"] == 0.75
    written = _read(out)
    assert [r["num_queries"] for r in written] == ["10", "100"]
    assert written[1]["fwd_ms"] == "100.5"


def test_resume_reads_a_csv_without_the_device_columns(tmp_path,
                                                       monkeypatch):
    out = tmp_path / "sweep.csv"
    out.write_text(",".join(JAX_FIELDS) + "\n"
                   "reference,float32,100,2.0,3.0,nan\n")
    calls = []
    monkeypatch.setattr(benchmark, "bench", _fake_bench(calls))
    benchmark.main(ARGS + ["--out", str(out), "--resume"])
    assert calls == [10]
    written = _read(out)
    assert list(written[0]) == benchmark.FIELDS
    assert written[1]["fwd_ms"] == "2.0" and written[1]["device"] == ""
    assert written[0]["device"] == "cpu"


def test_without_resume_every_row_is_measured(tmp_path, monkeypatch):
    out = tmp_path / "sweep.csv"
    out.write_text(",".join(benchmark.FIELDS) + "\n"
                   "reference,float32,10,0.25,0.75,nan,cpu,\n")
    calls = []
    monkeypatch.setattr(benchmark, "bench", _fake_bench(calls))
    benchmark.main(ARGS + ["--out", str(out)])
    assert calls == [10, 100]


@pytest.mark.parametrize("stdout,returncode,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", 0,
     ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("", 9, ("", "")),
])
def test_card_identity_reads_one_nvidia_smi_line(monkeypatch, stdout,
                                                 returncode, want):
    from msda_tpu_torch.utils import bench

    seen = []

    def run(cmd, **kwargs):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, returncode, stdout, "")

    monkeypatch.setattr(bench.subprocess, "run", run)
    assert bench.card_identity("cuda:0") == want
    assert seen == [["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader", "--id=0"]]
