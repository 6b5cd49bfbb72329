"""Profiling helpers: the counterpart of ``msda_tpu/utils/profile.py``, on
``torch.profiler``.

:func:`trace` records the enclosed region with ``torch.profiler`` (the
CPU, and the CUDA devices when there are any) and writes a Chrome trace
(``chrome://tracing``, Perfetto) into its directory; :func:`annotate` names
a span inside it.  The object that :func:`trace` yields reads the trace
back: each device kernel's time, the device's busy time and idle share over
the region, and each span's time on the host and on the device.

    with trace("build/traces/step") as t:
        with annotate("forward"):
            out = model(pyramid, shapes)
    print(t.busy_ms(), t.idle_share(), t.kernel_ms(), t.span_ms())

What a span records:

- **A host span** (``torch.profiler.record_function``, category
  ``user_annotation``) when a profiler is running: the enclosed host code,
  on the thread that ran it.  Eager calls only: a CUDA graph replay runs
  no host code of the function it captured.
- **A device span** when the span's name is in :data:`DEVICE_SPANS` and
  the current CUDA stream is capturing a graph: a begin marker kernel
  launched on the capturing stream when the span is entered, and an end
  marker when it is left (``csrc/msda_span.cu``; the kernels
  ``msda_span<encoder, begin>`` and ``msda_span<encoder, end>``, say).
  The markers are nodes of the graph, so every replay runs them at the
  device's own time, traced or not (about a microsecond of device time
  each).  ``Trace.span_ms(device=True)`` reads the device work between a
  begin and its end.  The markers need their library loaded into the
  device's context before the capture (:func:`prepare_markers`;
  ``utils.graphs.graphed`` does it in a signature's warm-up): a capture
  on a device where it is not loaded records the host span alone.
- **Nothing** otherwise: with no profiler running and no capture,
  :func:`annotate` enters no ``record_function`` and costs a flag test.
  ``torch.export`` and ``torch.compile`` trace no span and launch no
  marker (they capture no stream).

The names that carry markers are the model's layers: ``encoder`` and
``decoder`` (``models/detr.py``), ``postprocess`` (``models.postprocess``),
``loss``, ``backward`` and ``optimizer`` (``parallel/train.py``), and
spans nested in them: the two-stage detectors' proposal stage,
``proposals`` (inside ``decoder``), the published form's proposal matching
and loss, ``proposal_loss`` (inside ``loss``), the DINO form's denoising
queries, ``dn_queries`` (inside ``decoder``), and their loss, ``dn_loss``
(inside ``loss``).  Every
other name (``graphed.*`` in ``utils/graphs.py``, ``msda.fwd`` and
``msda.bwd`` in ``ops/library.py``) is a host span only: the op runs 24
times a request, and markers there would cost a request 48 graph nodes.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import json
import os
import re
import time
import warnings

import torch
from torch.profiler import ProfilerActivity

__all__ = ["trace", "annotate", "prepare_markers", "Trace", "TRACE_FILE",
           "DEVICE_SPANS"]

#: the Chrome trace's name in the trace directory
TRACE_FILE = "trace.json"
#: the span names that carry device markers, in ``csrc/msda_span.cu``'s
#: order (a name's index is its marker's; :func:`prepare_markers` holds the
#: library's table to it)
DEVICE_SPANS = ("encoder", "decoder", "postprocess", "loss", "backward",
                "optimizer", "proposals", "proposal_loss", "dn_queries",
                "dn_loss")
_SPAN_INDEX = {name: i for i, name in enumerate(DEVICE_SPANS)}
# a marker kernel's name in a trace: its span's name and edge
_MARKER = re.compile(r"msda_span<\s*(\w+)\s*,\s*(begin|end)\s*>")
_MARKER_KERNEL = "msda_span"
# device activity in a Chrome trace of torch.profiler (Kineto's categories)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_NOTHING = contextlib.nullcontext()
# device index -> the marker library, loaded into that device's context, or
# None where it could not be
_MARKERS: dict[int, ctypes.CDLL | None] = {}


class Trace:
    """A finished (or running) :func:`trace` capture.

    ``log_dir`` is the directory, ``path`` the Chrome trace (written when
    the ``with`` block ends), ``window_ms`` the region's host wall time,
    device work drained (None while it runs).
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, TRACE_FILE)
        self.window_ms: float | None = None
        self._events = None

    def events(self) -> list[dict]:
        """The trace's complete events (``"ph": "X"``), read once."""
        if self._events is None:
            with open(self.path) as f:
                data = json.load(f)
            self._events = [e for e in data.get("traceEvents", [])
                            if e.get("ph") == "X"]
        return self._events

    def _device_events(self) -> list[dict]:
        """Kernels, copies and memsets on the devices."""
        return [e for e in self.events()
                if e.get("cat") in _DEVICE_CATEGORIES]

    def kernel_ms(self) -> dict[str, float]:
        """Device milliseconds by kernel (or copy) name, largest first."""
        total = collections.Counter()
        for e in self._device_events():
            total[e["name"]] += e["dur"] / 1e3
        return dict(total.most_common())

    def kernel_counts(self) -> dict[str, int]:
        """Device launches by kernel (or copy) name, most first."""
        return dict(collections.Counter(
            e["name"] for e in self._device_events()).most_common())

    def busy_ms(self) -> float:
        """Milliseconds in which some device work ran: the union of the
        device events' intervals."""
        return sum(b - a for a, b in _union(
            (e["ts"], e["ts"] + e["dur"])
            for e in self._device_events())) / 1e3

    def idle_share(self) -> float:
        """The share of the window in which no device work ran."""
        if not self.window_ms:
            raise ValueError("the capture has not ended")
        return 1.0 - self.busy_ms() / self.window_ms

    def span_ms(self, device: bool = False) -> dict[str, float]:
        """Milliseconds of each :func:`annotate` span, summed by name, in
        the order the spans began: on the host's clock, or with ``device``
        on the device's: the device work between each begin marker and its
        end marker in one CUDA graph replay (the union of the device
        intervals there, the markers left out; ``marked_spans``), and the
        profiler's ``gpu_user_annotation`` ranges (eager calls: from a
        span's first device work to its last)."""
        category = "gpu_user_annotation" if device else "user_annotation"
        spans = [(e["ts"], e["name"], e["dur"] / 1e3) for e in self.events()
                 if e.get("cat") == category]
        if device:
            spans += marked_spans(self._device_events())
        total: dict[str, float] = {}
        for _, name, ms in sorted(spans, key=lambda s: s[0]):
            total[name] = total.get(name, 0.0) + ms
        return total


def _union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, stop)`` intervals, as disjoint sorted ones."""
    merged: list[list[float]] = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return [(a, b) for a, b in merged]


def _overlap(union, start: float, stop: float) -> float:
    """The length of ``union`` (``_union``'s) inside ``[start, stop]``."""
    i = max(0, bisect.bisect_right(union, (start, float("inf"))) - 1)
    inside = 0.0
    while i < len(union) and union[i][0] < stop:
        inside += max(0.0, min(stop, union[i][1]) - max(start, union[i][0]))
        i += 1
    return inside


def marked_spans(device_events) -> list[tuple[float, str, float]]:
    """The device spans that markers delimit among ``device_events`` (a
    trace's kernels, copies and memsets): ``(begin's ts, name, ms)`` for
    each begin marker paired with the next end marker of its name launched
    by the same call (the profiler's ``correlation``: a graph replay's
    launch), ``ms`` the union of the other device intervals between them.
    A begin without an end, or an end without a begin (a marker the
    profiler dropped), is left out."""
    marks, others = [], []
    for e in device_events:
        m = _MARKER.search(e["name"])
        if m:
            launch = (e.get("args") or {}).get("correlation")
            marks.append((e["ts"], m[2] == "end", (m[1], launch),
                          e["ts"] + e["dur"]))
        else:
            others.append((e["ts"], e["ts"] + e["dur"]))
    busy = _union(others)
    open_at: dict[tuple, tuple[float, float]] = {}
    out = []
    for ts, ends, key, stop in sorted(marks, key=lambda m: m[:2]):
        if not ends:
            open_at[key] = (ts, stop)
        elif key in open_at:
            began, start = open_at.pop(key)
            out.append((began, key[0], _overlap(busy, start, ts) / 1e3))
    return out


def _drain() -> None:
    """Wait for the work queued on every CUDA device that has a context."""
    if not torch.cuda.is_initialized():
        return
    for index in range(torch.cuda.device_count()):
        if torch._C._cuda_hasPrimaryContext(index):
            torch.cuda.synchronize(index)


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike, *, block: bool = True):
    """Record the enclosed region with ``torch.profiler``.

    Creates ``log_dir``, starts the profiler (CPU, and CUDA when a card is
    visible), yields a :class:`Trace`, and when the block ends, also by an
    exception: waits for every initialized CUDA device (``block=True``,
    the default, so that queued kernels are in the trace), stops the
    profiler and writes the Chrome trace ``log_dir/trace.json``.
    """
    log_dir = os.fspath(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    capture = Trace(log_dir)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    t0 = time.perf_counter()
    try:
        yield capture
    finally:
        if block:
            _drain()
        capture.window_ms = (time.perf_counter() - t0) * 1e3
        profiler.stop()
        profiler.export_chrome_trace(capture.path)


def annotate(name: str):
    """A named span (the module docstring): a context manager.

        with trace(d):
            with annotate("forward"):
                out = fwd(x)

    Under a CUDA stream capture, a name of :data:`DEVICE_SPANS` launches
    its begin and end markers on the capturing stream (once
    :func:`prepare_markers` has loaded them on the current device), and is
    a host span too if a profiler runs; otherwise the span is a
    ``torch.profiler.record_function`` range when a profiler runs, and
    nothing when none does.
    """
    if torch.compiler.is_compiling():
        return _NOTHING
    index = _SPAN_INDEX.get(name)
    if (index is not None and torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        lib = _MARKERS.get(torch.cuda.current_device())
        if lib is not None:
            return _DeviceSpan(lib, index, name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOTHING


class _DeviceSpan:
    """A span under stream capture: its markers, launched on the current
    stream, around a host span when a profiler runs."""

    def __init__(self, lib, index: int, name: str):
        self.lib, self.index = lib, index
        self.host = (torch.profiler.record_function(name)
                     if torch.autograd._profiler_enabled() else None)

    def _mark(self, edge: int) -> None:
        err = self.lib.msda_span_launch(
            self.index, edge, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"msda_span_launch failed: CUDA error {err}")

    def __enter__(self):
        if self.host is not None:
            self.host.__enter__()
        self._mark(0)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:  # a failed capture takes no more launches
            self._mark(1)
        if self.host is not None:
            self.host.__exit__(*exc)
        return False


def prepare_markers() -> bool:
    """Load the span markers' library (``csrc/msda_span.cu``, built by
    ``ops._build`` at its first use) and every marker into the current CUDA
    device's context, so that a later capture on that device launches them
    and loads nothing.  Returns whether the markers are ready there: False
    without CUDA, and, with a warning, when the library cannot be built or
    loaded.  Raises a ``RuntimeError`` for a library whose table of spans
    is not :data:`DEVICE_SPANS`, in order (its markers would carry other
    names).  Call it outside any capture; once a device is enough."""
    if torch.version.cuda is None or not torch.cuda.is_available():
        return False
    device = torch.cuda.current_device()
    if device not in _MARKERS:
        from ..ops import _build

        try:
            lib = _build.load_library(_MARKER_KERNEL)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.msda_span_launch.argtypes = [ci, ci, vp]
            lib.msda_span_launch.restype = ci
            lib.msda_span_prepare.restype = ci
            lib.msda_span_count.restype = ci
            lib.msda_span_name.argtypes = [ci]
            lib.msda_span_name.restype = ctypes.c_char_p
            err = lib.msda_span_prepare()
            if err != 0:
                raise RuntimeError(f"msda_span_prepare failed: CUDA error "
                                   f"{err}")
        except (RuntimeError, OSError) as e:
            warnings.warn(f"no device spans in CUDA graphs on device "
                          f"{device}: {e}", stacklevel=2)
            lib = None
        if lib is not None:
            table = tuple(lib.msda_span_name(i).decode()
                          for i in range(lib.msda_span_count()))
            if table != DEVICE_SPANS:
                raise RuntimeError(f"the marker library's spans {table} are "
                                   f"not DEVICE_SPANS {DEVICE_SPANS}")
        _MARKERS[device] = lib
    return _MARKERS[device] is not None
