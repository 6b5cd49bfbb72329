"""The readers of the program's own spans (``perfbench/spans.py`` and the
metrics that name it) on a synthetic Chrome trace of two traced units:
marker kernels around each layer's device work, ``graphed``'s host spans
and the op's, with CUDA API calls among them; each metric against its
value worked out by hand, and None where the slice does not hold one span
a unit."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from perfbench import harness, spans
from perfbench.tracefile import TraceFile


def _kernel(ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def _marker(name, edge, ts):
    return _kernel(ts, 2, f"void msda_span<{name}, {edge}>()")


def _host(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _layer(name, ts, work):
    """A marked span from ``ts``: its begin, the ``(offset, dur)`` device
    work after it, its end 190 us after ``ts``."""
    return [_marker(name, "begin", ts),
            *(_kernel(ts + o, d) for o, d in work),
            _marker(name, "end", ts + 190)]


# The device: before each unit a copy in (outside every span); unit 0's
# encoder has two overlapping kernels (union 145 us), its decoder a kernel
# and a memset (70), its postprocess 10; unit 1's 55, 30 and 20.  The train
# step's loss, backward and optimizer: 40 / 60 / 5 in unit 0, 20 / 90 /
# 15 in unit 1.
DEVICE = [
    _kernel(900, 50, "copy", "gpu_memcpy"),
    *_layer("encoder", 1000, [(5, 100), (50, 100)]),
    *_layer("decoder", 1200, [(5, 50)]),
    _kernel(1260, 20, "set", "gpu_memset"),
    *_layer("postprocess", 1400, [(5, 10)]),
    *_layer("loss", 1600, [(5, 40)]),
    *_layer("backward", 1800, [(5, 60)]),
    *_layer("optimizer", 2000, [(5, 5)]),
    _kernel(2900, 50, "copy", "gpu_memcpy"),
    *_layer("encoder", 3000, [(2, 55)]),
    *_layer("decoder", 3200, [(10, 30)]),
    *_layer("postprocess", 3400, [(40, 20)]),
    *_layer("loss", 3600, [(5, 20)]),
    *_layer("backward", 3800, [(5, 90)]),
    *_layer("optimizer", 4000, [(5, 15)]),
]
# The host: unit 0's call reads the options (50 us) and replays (300) in
# 1000; unit 1's reads them (100), captures (400) and replays (100) in
# 800.  A span of another thread inside a call is not its child.  The op's
# spans: msda.fwd 100 with a 30 us launch inside, msda.bwd on autograd's
# thread 200 with two overlapping API calls (union 80); then 60 with none,
# and 90 with an API call that runs 40 us past its end.
HOST = [
    _host("perfbench.unit", 0, 1100),
    _host("graphed.call", 0, 1000),
    _host("graphed.options", 100, 50),
    _host("graphed.replay", 600, 300),
    _host("cudaGraphLaunch", 650, 200, cat="cuda_runtime"),
    _host("graphed.warmup", 200, 10, tid=9),
    _host("perfbench.unit", 2000, 1000),
    _host("graphed.call", 2000, 800),
    _host("graphed.options", 2050, 100),
    _host("graphed.capture", 2200, 400),
    _host("graphed.replay", 2650, 100),
    _host("msda.fwd", 5000, 100),
    _host("cudaLaunchKernel", 5040, 30, cat="cuda_runtime"),
    _host("msda.bwd", 5200, 200, tid=2),
    _host("cudaLaunchKernel", 5250, 50, tid=2, cat="cuda_runtime"),
    _host("cudaMemsetAsync", 5280, 50, tid=2, cat="cuda_runtime"),
    _host("msda.fwd", 6000, 60),
    _host("msda.bwd", 6100, 90, tid=2),
    _host("cudaLaunchKernel", 6150, 80, tid=2, cat="cuda_driver"),
]
# metric -> its value worked out by hand, ms (or %)
EXPECTED = {
    "encoder_device_ms.serve": (145 + 55) / 2 / 1e3,
    "decoder_device_ms.serve": (70 + 30) / 2 / 1e3,
    "postprocess_device_ms.serve": (10 + 20) / 2 / 1e3,
    "encoder_device_ms.train": (145 + 55) / 2 / 1e3,
    "decoder_device_ms.train": (70 + 30) / 2 / 1e3,
    "loss_device_ms.train": (40 + 20) / 2 / 1e3,
    "backward_device_ms.train": (60 + 90) / 2 / 1e3,
    "optimizer_device_ms.train": (5 + 15) / 2 / 1e3,
    "graph_self_host_ms.serve": ((1000 - 350) + (800 - 600)) / 2 / 1e3,
    "graph_self_host_ms.train": ((1000 - 350) + (800 - 600)) / 2 / 1e3,
    "options_host_ms.train": (50 + 100) / 2 / 1e3,
    "graph_miss_pct.serve": 50.0,
    "graph_miss_pct.train": 50.0,
    "op_self_host_ms.op": (70 + 120 + 60 + 50) / 2 / 1e3,
}


def _run(tmp_path, events, units=2):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(trace=TraceFile(str(path)), traced=range(units))


def _reader(metric):
    return harness.reader(harness.ROOT / "perfbench", metric)


def test_every_new_metric_has_its_entry():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in EXPECTED:
        assert entries[metric]["source"] == "device_trace"
        assert entries[metric]["workloads"]


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_metric_reads_its_hand_worked_value(tmp_path, metric):
    run = _run(tmp_path, DEVICE + HOST)
    assert _reader(metric).read(run) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("units", [1, 4])
def test_a_slice_with_another_count_of_spans_reads_none(tmp_path, metric,
                                                        units):
    """Two spans of each name against one traced unit, or against four
    (two fewer than the units): None."""
    run = _run(tmp_path, DEVICE + HOST, units=units)
    assert _reader(metric).read(run) is None


DEVICE_METRICS = sorted(m for m in EXPECTED if "_device_ms." in m)


@pytest.mark.parametrize("metric", DEVICE_METRICS)
def test_a_last_span_cut_off_reads_the_complete_ones(tmp_path, metric):
    """Three traced units whose last lost its device events at the
    slice's end (its begin marker at most): the mean of the two complete
    spans.  The host spans, which the profiler keeps, are still held to
    one a unit."""
    name = metric.split("_device_ms")[0]
    cut = DEVICE + [_marker(name, "begin", 9000), _kernel(9005, 40)]
    run = _run(tmp_path, cut + HOST, units=3)
    assert _reader(metric).read(run) == pytest.approx(EXPECTED[metric])
    run = _run(tmp_path, DEVICE + HOST, units=3)
    assert _reader(metric).read(run) == pytest.approx(EXPECTED[metric])
    host = _run(tmp_path, DEVICE + HOST, units=3)
    assert _reader("options_host_ms.train").read(host) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_program_without_the_spans_reads_none(tmp_path, metric):
    """A trace with the device work but no marker and no span of the
    program (one from before they were added): None, and nothing raised;
    an untraced run too."""
    plain = [e for e in DEVICE if "msda_span" not in e["name"]]
    plain += [e for e in HOST if e["name"] == "perfbench.unit"
              or e["cat"] != "user_annotation"]
    assert _reader(metric).read(_run(tmp_path, plain)) is None
    untraced = SimpleNamespace(trace=None, traced=range(0))
    assert _reader(metric).read(untraced) is None


def test_an_unpaired_marker_is_left_out(tmp_path):
    """A begin cut off by the slice's end, or an end whose begin came
    before the slice, pairs with nothing."""
    events = [_marker("encoder", "end", 0), _kernel(5, 10),
              *_layer("encoder", 100, [(5, 20)]),
              _marker("encoder", "begin", 300), _kernel(305, 10)]
    assert spans.marked_spans(events) == {"encoder": [20]}


def _replay(t0, launch, work=40):
    """One replay's encoder span, its markers and kernel carrying the
    replay's launch correlation."""
    events = _layer("encoder", t0, [(5, work)])
    for e in events:
        e["args"] = {"correlation": launch}
    return events


def test_markers_pair_within_one_replay(tmp_path):
    """A begin pairs with an end of the same launch: where the profiler
    dropped one replay's end and the next one's begin, neither replay's
    span is read (and no span runs from one replay into the next)."""
    events = [*_replay(0, 1), *_replay(1000, 2, work=30),
              *_replay(2000, 3, work=20), *_replay(3000, 4, work=10)]
    events = [e for e in events
              if not (e["args"]["correlation"] == 2 and "end" in e["name"])
              and not (e["args"]["correlation"] == 3
                       and "begin" in e["name"])]
    assert spans.marked_spans(events) == {"encoder": [40, 10]}


@pytest.mark.parametrize("kept, reads", [(20, True), (18, True),
                                         (17, False), (21, False)])
def test_up_to_a_tenth_of_the_spans_may_be_lost(tmp_path, kept, reads):
    """Twenty traced units: the mean of the complete spans where up to two
    are lost; None where three are, or where there are more spans than
    units."""
    events = [e for k in range(kept) for e in _replay(1000 * k, k,
                                                      work=10 + k)]
    run = _run(tmp_path, events, units=20)
    value = _reader("encoder_device_ms.serve").read(run)
    if reads:
        assert value == pytest.approx((10 + (kept - 1) / 2) / 1e3)
    else:
        assert value is None


def test_the_frozen_names_are_the_programs():
    from msda_tpu_torch.utils import profile

    assert spans.DEVICE_SPANS == profile.DEVICE_SPANS
    device = sorted(DEVICE, key=lambda e: e["ts"])
    ours = spans.marked_spans(device)
    theirs = {}
    for _, name, ms in profile.marked_spans(device):
        theirs.setdefault(name, []).append(ms * 1e3)
    assert ours == pytest.approx(theirs)


def test_marker_windows_run_between_the_markers():
    """A window runs from its begin marker's end to its end marker's
    start (the markers are 2 us long), in the order the spans ended."""
    events = [*_layer("encoder", 100, [(5, 20)]),
              *_layer("decoder", 400, [(5, 20)])]
    assert spans.marker_windows(events) == [("encoder", 102, 290),
                                            ("decoder", 402, 590)]
