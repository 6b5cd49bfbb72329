"""Profiler capture (``msda_tpu_torch.utils.profile``) and the trace entry
point (``python -m msda_tpu_torch.capture_trace``), on the CPU.

The counterparts of ``tests/test_profile.py``: the context manager's logic
(directory first, start before the body, the drain of every CUDA device
that has a context between the body and the stop, the stop on an
exception) against a recording fake profiler; a real capture on the CPU
whose Chrome trace holds an ``annotate`` span; the reading of a trace
(device busy time as the union of the device intervals, kernel times,
spans) on a synthetic one; and a run of the entry point on the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from msda_tpu_torch import capture_trace
from msda_tpu_torch.utils import annotate, profile, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeProfiler:
    def __init__(self, events, activities):
        self.events, self.activities = events, activities

    def start(self):
        self.events.append(("start",))

    def stop(self):
        self.events.append(("stop",))

    def export_chrome_trace(self, path):
        self.events.append(("export", path))


@pytest.fixture
def recorded(monkeypatch):
    """A recording fake profiler, and two CUDA devices of which device 1
    has a context."""
    events = []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: _FakeProfiler(events, activities))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch._C, "_cuda_hasPrimaryContext",
                        lambda i: i == 1, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda i=None: events.append(("drain", i)))
    return events


def test_trace_logic_with_fake_profiler(tmp_path, recorded):
    d = tmp_path / "trace"
    with trace(d) as t:
        assert os.path.isdir(d)  # created before the start
        assert recorded == [("start",)]
        recorded.append(("body",))
    path = str(d / profile.TRACE_FILE)
    assert recorded == [("start",), ("body",), ("drain", 1), ("stop",),
                        ("export", path)]
    assert t.log_dir == str(d) and t.path == path and t.window_ms > 0


def test_trace_stops_on_an_exception(tmp_path, recorded):
    with pytest.raises(RuntimeError, match="boom"):
        with trace(tmp_path / "trace"):
            raise RuntimeError("boom")
    assert [e[0] for e in recorded] == ["start", "drain", "stop", "export"]


def test_trace_without_block_does_not_drain(tmp_path, recorded):
    with trace(tmp_path / "trace", block=False):
        pass
    assert [e[0] for e in recorded] == ["start", "stop", "export"]


def test_trace_capture_on_cpu(tmp_path):
    """A real capture: the Chrome trace holds the annotated span, and the
    CPU run shows no device work."""
    d = tmp_path / "trace"
    with trace(d) as t:
        with annotate("matmul"):
            x = torch.ones(64, 64)
            (x @ x).sum().item()
    with open(t.path) as f:
        assert "matmul" in f.read()
    assert "matmul" in t.span_ms() and t.span_ms()["matmul"] > 0
    assert t.kernel_ms() == {} and t.busy_ms() == 0.0
    assert t.idle_share() == 1.0


def test_trace_reading_on_a_synthetic_trace(tmp_path):
    """Busy time is the union of the device intervals (overlaps counted
    once); kernel times sum by name, largest first; spans by name."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 500, "dur": 1000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 3000,
         "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 3200, "dur": 1800},
        {"ph": "X", "cat": "user_annotation", "name": "forward", "ts": 0,
         "dur": 2000},
        {"ph": "X", "cat": "user_annotation", "name": "backward",
         "ts": 2500, "dur": 3000},
        {"ph": "X", "cat": "user_annotation", "name": "forward", "ts": 6000,
         "dur": 1000},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "forward",
         "ts": 100, "dur": 1400},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 9000},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]
    t = profile.Trace(str(tmp_path))
    with open(t.path, "w") as f:
        json.dump({"traceEvents": events}, f)
    t.window_ms = 10.0
    assert t.busy_ms() == pytest.approx(1.5 + 2.0)
    assert t.idle_share() == pytest.approx(0.65)
    assert t.kernel_ms() == {"k2": 2.8, "k1": 1.0, "copy": 0.5}
    assert list(t.kernel_ms()) == ["k2", "k1", "copy"]
    assert t.span_ms() == {"forward": 3.0, "backward": 3.0}
    assert t.span_ms(device=True) == {"forward": 1.4}


def test_trace_counts_device_launches_by_name(tmp_path):
    """Launches count each device event once by name, most first; host
    events and instants are not launches."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 60, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "k1", "ts": 0, "dur": 90},
        {"ph": "i", "cat": "kernel", "name": "k1", "ts": 0},
    ]
    t = profile.Trace(str(tmp_path))
    with open(t.path, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert t.kernel_counts() == {"k2": 2, "k1": 1, "set": 1}
    assert list(t.kernel_counts())[0] == "k2"


def test_idle_share_needs_a_finished_capture(tmp_path):
    with pytest.raises(ValueError, match="not ended"):
        profile.Trace(str(tmp_path)).idle_share()


@pytest.mark.parametrize("mode", ["fwd", "bwd", "fwdbwd"])
def test_capture_trace_in_process_on_cpu(mode, tmp_path):
    result = capture_trace.main([
        "--device", "cpu", "--impl", "reference", "--mode", mode,
        "--queries", "10", "--iters", "2", "--out", str(tmp_path / mode)])
    assert os.path.isfile(result["out"])
    assert result["span_ms"][mode] > 0 and result["window_ms"] > 0
    assert result["kernel_ms"] == {} and result["busy_ms"] == 0.0


def test_capture_trace_entry_point_on_cpu(tmp_path):
    out = tmp_path / "trace"
    run = subprocess.run(
        [sys.executable, "-m", "msda_tpu_torch.capture_trace", "--device",
         "cpu", "--impl", "reference", "--queries", "10", "--iters", "2",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "trace written to" in run.stdout
    with open(out / profile.TRACE_FILE) as f:
        assert '"fwd"' in f.read()


@pytest.mark.parametrize("argv,match", [
    (["--device", "cpu", "--impl", "cuda"], "needs a CUDA device"),
    (["--device", "cuda"], "no CUDA device"),
])
def test_capture_trace_refuses_what_it_cannot_run(argv, match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        capture_trace.main(argv + ["--queries", "10", "--iters", "1"])
