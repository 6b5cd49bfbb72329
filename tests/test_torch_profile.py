"""Profiler capture (``msda_tpu_torch.utils.profile``) and the trace entry
point (``python -m msda_tpu_torch.capture_trace``), on the CPU.

The counterparts of ``tests/test_profile.py``: the context manager's logic
(directory first, start before the body, the drain of every CUDA device
that has a context between the body and the stop, the stop on an
exception) against a recording fake profiler; a real capture on the CPU
whose Chrome trace holds an ``annotate`` span; the reading of a trace
(device busy time as the union of the device intervals, kernel times,
spans) on a synthetic one, device spans between marker kernels among
them; what ``annotate`` enters with and without a profiler, and the
markers it launches under a (stubbed) CUDA stream capture; and a run of
the entry point on the CPU.
"""

import json
import os
import subprocess
import sys
import types

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


def _marker(name, edge, ts):
    return {"ph": "X", "cat": "kernel", "ts": ts, "dur": 2,
            "name": f"void msda_span<{name}, {edge}>()"}


def test_device_spans_read_the_markers_in_a_synthetic_trace(tmp_path):
    """A device span is the union of the device work between a begin
    marker and the next end marker of its name, the markers left out,
    summed by name in the order the spans began; work outside every pair
    and a begin without its end count nowhere; ``gpu_user_annotation``
    ranges are added as before."""
    events = [
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy in", "ts": 0,
         "dur": 50},
        _marker("encoder", "begin", 100),
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 105, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 150, "dur": 100},
        _marker("encoder", "end", 300),
        _marker("decoder", "begin", 310),
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 315, "dur": 50},
        {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 370,
         "dur": 20},
        _marker("decoder", "end", 400),
        _marker("encoder", "begin", 1000),
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1002, "dur": 255},
        _marker("encoder", "end", 1300),
        _marker("postprocess", "begin", 1310),  # cut off: no end
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1320, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "loss",
         "ts": 2000, "dur": 700},
    ]
    t = profile.Trace(str(tmp_path))
    with open(t.path, "w") as f:
        json.dump({"traceEvents": events}, f)
    spans = t.span_ms(device=True)
    assert spans == pytest.approx({"encoder": (145 + 255) / 1e3,
                                   "decoder": 70 / 1e3, "loss": 0.7})
    assert list(spans) == ["encoder", "decoder", "loss"]
    assert t.span_ms() == {}


def test_device_spans_pair_markers_of_one_launch(tmp_path):
    """Markers pair within one graph replay (the profiler's launch
    correlation): a replay whose end marker was dropped, and the next one
    whose begin was, give no span between them."""
    def replay(t0, launch, work):
        events = [_marker("decoder", "begin", t0),
                  {"ph": "X", "cat": "kernel", "name": "k", "ts": t0 + 5,
                   "dur": work},
                  _marker("decoder", "end", t0 + 100)]
        for e in events:
            e["args"] = {"correlation": launch}
        return events

    events = [*replay(0, 7, 40), *replay(200, 8, 30)[:2],
              *replay(400, 9, 20)[1:], *replay(600, 10, 10)]
    t = profile.Trace(str(tmp_path))
    with open(t.path, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert t.span_ms(device=True) == pytest.approx({"decoder": 0.05})


class _Markers:
    """The marker library's stand-in: records each launch."""

    def __init__(self):
        self.launched = []

    def msda_span_launch(self, index, edge, stream):
        self.launched.append((profile.DEVICE_SPANS[index], edge, stream))
        return 0


@pytest.fixture
def capturing(monkeypatch):
    """A CUDA stream capture on device 0, its stream's handle 7, with the
    markers ready there."""
    class Stream:
        cuda_stream = 7

    lib = _Markers()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setitem(profile._MARKERS, 0, lib)
    return lib


def _refuse_record_function(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refused)


def test_annotate_enters_nothing_without_a_profiler(monkeypatch):
    """No profiler and no capture: no ``record_function``, for a layer's
    name as for any other."""
    _refuse_record_function(monkeypatch)
    for name in ("encoder", "graphed.call", "msda.fwd"):
        with annotate(name):
            pass


def test_annotate_records_a_host_span_under_a_profiler(tmp_path):
    """Under a CPU profiler, a layer's span and any other are host spans
    (no capture, so no marker)."""
    with trace(tmp_path / "trace") as t:
        with annotate("encoder"):
            with annotate("msda.fwd"):
                torch.ones(8, 8).sum()
    host = t.span_ms()
    assert set(host) == {"encoder", "msda.fwd"}
    assert host["encoder"] >= host["msda.fwd"] > 0
    assert t.span_ms(device=True) == {}


def test_annotate_launches_markers_under_a_capture(capturing, monkeypatch):
    """Under a capture, a layer's span launches its begin and end markers
    on the capturing stream; a name outside ``DEVICE_SPANS`` launches
    none; with no profiler, neither enters a ``record_function``."""
    _refuse_record_function(monkeypatch)
    with annotate("decoder"):
        with annotate("msda.fwd"):
            assert capturing.launched == [("decoder", 0, 7)]
    with annotate("graphed.replay"):
        pass
    assert capturing.launched == [("decoder", 0, 7), ("decoder", 1, 7)]


def test_every_layer_name_has_its_marker(capturing):
    for name in profile.DEVICE_SPANS:
        with annotate(name):
            pass
    assert capturing.launched == [(name, edge, 7)
                                  for name in profile.DEVICE_SPANS
                                  for edge in (0, 1)]


def test_a_failed_block_launches_no_end_marker(capturing):
    with pytest.raises(RuntimeError, match="capture failed"):
        with annotate("loss"):
            raise RuntimeError("capture failed")
    assert capturing.launched == [("loss", 0, 7)]


def test_a_capture_without_the_markers_ready_launches_none(capturing,
                                                           monkeypatch):
    """On a device where ``prepare_markers`` has not loaded them, a capture
    records the host span alone: nothing is loaded under a capture."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    _refuse_record_function(monkeypatch)
    with annotate("encoder"):
        pass
    assert capturing.launched == []


def test_no_marker_while_compiling(capturing, monkeypatch):
    """``torch.export`` / ``torch.compile`` tracing launches no marker."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with annotate("encoder"):
        pass
    assert capturing.launched == []


def test_prepare_markers_without_a_cuda_build(monkeypatch, recwarn):
    """A CPU build has no markers to load: False, and no warning, even
    where ``torch.cuda.is_available`` is stubbed true."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.version, "cuda", None)
    assert profile.prepare_markers() is False
    assert not recwarn.list


def _library(names):
    """The marker library as ``ctypes`` loads it, its table ``names``."""
    return types.SimpleNamespace(
        msda_span_launch=lambda span, edge, stream: 0,
        msda_span_prepare=lambda: 0,
        msda_span_count=lambda: len(names),
        msda_span_name=lambda span: names[span].encode())


@pytest.fixture
def loading(monkeypatch):
    """A CUDA build with device 0, no marker library loaded yet, and
    ``ops._build.load_library`` handing out the library that the test
    sets in ``loading.names``."""
    from msda_tpu_torch.ops import _build

    state = types.SimpleNamespace(names=profile.DEVICE_SPANS, loaded=[])

    def load_library(name):
        state.loaded.append(name)
        return _library(state.names)

    monkeypatch.setattr(torch.version, "cuda", "12.4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(profile, "_MARKERS", {})
    monkeypatch.setattr(_build, "load_library", load_library)
    return state


def test_prepare_markers_loads_a_library_of_device_spans(loading):
    """A library whose table is ``DEVICE_SPANS`` is loaded once a device."""
    assert profile.prepare_markers() is True
    assert profile.prepare_markers() is True
    assert loading.loaded == ["msda_span"]
    assert profile._MARKERS[0] is not None


@pytest.mark.parametrize("names", [
    ("encoder", "decoder", "postprocess", "backward", "loss", "optimizer"),
    ("encoder", "decoder", "postprocess", "loss", "backward"),
    ("encoder", "decoder", "postprocess", "loss", "backward", "optimizer",
     "matcher"),
], ids=["swapped", "short", "long"])
def test_prepare_markers_refuses_another_table(loading, names):
    """A library whose spans are not ``DEVICE_SPANS`` in order would give
    a layer another layer's markers: refused, and nothing kept for the
    device."""
    loading.names = names
    with pytest.raises(RuntimeError, match="not DEVICE_SPANS"):
        profile.prepare_markers()
    assert profile._MARKERS == {}


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
