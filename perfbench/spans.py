"""Reading the program's own spans in a traced run's slice: the device
spans that marker kernels delimit inside CUDA graph replays, and the host
spans of ``graphed`` and of the op.

A frozen copy of the program's marker names and of their pairing
(``msda_tpu_torch.utils.profile``: ``DEVICE_SPANS``, ``marked_spans``),
which the benchmark reads without importing the program.  A layer span
``<name>`` entered under a CUDA stream capture launches the kernel
``msda_span<<name>, begin>`` there, and ``msda_span<<name>, end>`` when it
is left, so that every replay runs them; a begin pairs with the next end
of its name.  A span's device time is the union of the device intervals
between its two markers, the markers left out.

Every reader returns None where the slice does not hold one span of the
name a traced unit (a program without the span, such as one from before
it was added, holds none), as ``arith.roofline.op_roofline_pct`` does,
with an allowance for device spans: the profiler drops device records.
It can leave out the slice's last ones (seen: the last train step's
optimizer end marker), and now and then a run of them in the middle (seen:
every marker of 11 requests among 270), so a span may lack a marker.  A
device span therefore reads the mean over its complete pairs where they
number the traced units or up to a tenth fewer (at least one fewer), and
a pair lost is a reading lost, not a zero.  Times in the trace are
microseconds; these return milliseconds.
"""

from __future__ import annotations

import bisect
import collections
import re

#: the span names that carry device markers (the program's DEVICE_SPANS)
DEVICE_SPANS = ("encoder", "decoder", "postprocess", "loss", "backward",
                "optimizer")
MARKER = re.compile(r"msda_span<\s*(\w+)\s*,\s*(begin|end)\s*>")
#: ``graphed``'s spans: a call, and inside it its child spans
CALL = "graphed.call"
CHILDREN = ("graphed.options", "graphed.warmup", "graphed.capture",
            "graphed.replay")
MISSES = ("graphed.warmup", "graphed.capture")


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a, b) for a, b in merged]


def _overlap(union, start: float, stop: float) -> float:
    i = max(0, bisect.bisect_right(union, (start, float("inf"))) - 1)
    inside = 0.0
    while i < len(union) and union[i][0] < stop:
        inside += max(0.0, min(stop, union[i][1]) - max(start, union[i][0]))
        i += 1
    return inside


def marker_windows(device_events) -> list[tuple[str, float, float]]:
    """``(name, start, stop)`` for each marked span among ``device_events``:
    a begin marker paired with the next end marker of its name launched by
    the same call (the trace's ``correlation``: a graph replay's launch),
    from the begin's end to the end's start, in the order the spans ended.
    A begin without an end, or an end without a begin, is left out."""
    marks = []
    for e in device_events:
        m = MARKER.search(e["name"])
        if m:
            launch = (e.get("args") or {}).get("correlation")
            marks.append((e["ts"], m[2] == "end", (m[1], launch),
                          e["ts"] + e["dur"]))
    open_at: dict[tuple, float] = {}
    out = []
    for ts, ends, key, stop in sorted(marks, key=lambda m: m[:2]):
        if not ends:
            open_at[key] = stop
        elif key in open_at:
            out.append((key[0], open_at.pop(key), ts))
    return out


def marked_spans(device_events) -> dict[str, list[float]]:
    """Device microseconds of each marked span among ``device_events``, by
    name, in the order the spans ended: the union of the other device
    intervals inside its ``marker_windows`` window."""
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device_events
                  if not MARKER.search(e["name"]))
    out: dict[str, list[float]] = collections.defaultdict(list)
    for name, start, stop in marker_windows(device_events):
        out[name].append(_overlap(busy, start, stop))
    return dict(out)


def _marked(trace) -> dict[str, list[float]]:
    """``marked_spans`` of the trace's device events, worked out once."""
    if getattr(trace, "_marked_spans", None) is None:
        trace._marked_spans = marked_spans(trace.device)
    return trace._marked_spans


def device_ms(run, name: str):
    """Mean device ms of the span ``name`` over its complete pairs, one a
    traced unit (up to a tenth of them lost), or None."""
    units = len(run.traced)
    if run.trace is None or not units:
        return None
    spans = _marked(run.trace).get(name, [])
    if not spans or not units - max(1, units // 10) <= len(spans) <= units:
        return None
    return sum(spans) / len(spans) / 1e3


def host_spans(run, name: str) -> list[dict]:
    """The host spans ``name`` of the slice (every thread)."""
    return [e for e in run.trace.events
            if e.get("cat") == "user_annotation" and e["name"] == name]


def _per_unit(run, name: str):
    """The spans ``name``, if the slice holds one a traced unit."""
    if run.trace is None or not run.traced:
        return None
    spans = host_spans(run, name)
    return spans if len(spans) == len(run.traced) else None


def host_ms(run, name: str):
    """Mean host ms of the span ``name``, one a traced unit, or None."""
    spans = _per_unit(run, name)
    if spans is None:
        return None
    return sum(e["dur"] for e in spans) / len(spans) / 1e3


def _children(run, calls) -> list[list[dict]]:
    """For each of ``calls``, the ``CHILDREN`` spans inside it, on its
    thread."""
    by_tid = collections.defaultdict(list)
    for e in run.trace.events:
        if e.get("cat") == "user_annotation" and e["name"] in CHILDREN:
            by_tid[e.get("tid")].append(e)
    starts = {}
    for tid, spans in by_tid.items():
        spans.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in spans]
    out = []
    for call in calls:
        tid = call.get("tid")
        spans = by_tid.get(tid, [])
        stop = call["ts"] + call["dur"]
        i = bisect.bisect_left(starts.get(tid, []), call["ts"])
        inside = []
        while i < len(spans) and spans[i]["ts"] < stop:
            if spans[i]["ts"] + spans[i]["dur"] <= stop:
                inside.append(spans[i])
            i += 1
        out.append(inside)
    return out


def graph_self_host_ms(run):
    """Mean host ms of ``graphed.call`` outside its child spans (the
    signature, the copies in, the clones out), one a traced unit, or
    None."""
    calls = _per_unit(run, CALL)
    if calls is None:
        return None
    own = [call["dur"] - sum(c["dur"] for c in inside)
           for call, inside in zip(calls, _children(run, calls))]
    return sum(own) / len(own) / 1e3


def graph_miss_pct(run):
    """The share of the slice's ``graphed.call`` spans (one a traced unit)
    that hold a warm-up or a capture, or None."""
    calls = _per_unit(run, CALL)
    if calls is None:
        return None
    missed = sum(any(c["name"] in MISSES for c in inside)
                 for inside in _children(run, calls))
    return 100.0 * missed / len(calls)


def op_self_host_ms(run):
    """Host ms a traced call inside the op's spans ``msda.fwd`` and
    ``msda.bwd``, outside the CUDA API calls (any thread) made in them,
    or None unless the slice holds one of each a call."""
    if _per_unit(run, "msda.fwd") is None or _per_unit(run,
                                                       "msda.bwd") is None:
        return None
    host = (run.trace.host_outside_api_s("msda.fwd")
            + run.trace.host_outside_api_s("msda.bwd"))
    return sum(host) / len(run.traced) * 1e3
