"""Profiling helpers: the counterpart of ``msda_tpu/utils/profile.py``, on
``torch.profiler``.

:func:`trace` records the enclosed region with ``torch.profiler`` (the
CPU, and the CUDA devices when there are any) and writes a Chrome trace
(``chrome://tracing``, Perfetto) into its directory; :func:`annotate` names
a span inside it (``torch.profiler.record_function``).  The object that
:func:`trace` yields reads the trace back: each device kernel's time, the
device's busy time and idle share over the region, and each span's time.

    with trace("build/traces/step") as t:
        with annotate("forward"):
            out = model(pyramid, shapes)
    print(t.busy_ms(), t.idle_share(), t.kernel_ms(), t.span_ms())
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity

__all__ = ["trace", "annotate", "Trace", "TRACE_FILE"]

#: the Chrome trace's name in the trace directory
TRACE_FILE = "trace.json"
# device activity in a Chrome trace of torch.profiler (Kineto's categories)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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
        spans = sorted((e["ts"], e["ts"] + e["dur"])
                       for e in self._device_events())
        busy, end = 0.0, float("-inf")
        for start, stop in spans:
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy / 1e3

    def idle_share(self) -> float:
        """The share of the window in which no device work ran."""
        if not self.window_ms:
            raise ValueError("the capture has not ended")
        return 1.0 - self.busy_ms() / self.window_ms

    def span_ms(self, device: bool = False) -> dict[str, float]:
        """Milliseconds of each :func:`annotate` span, summed by name, in
        the order the spans began: on the host's clock, or with ``device``
        from the span's first device work to its last (the profiler's
        ``gpu_user_annotation`` ranges)."""
        category = "gpu_user_annotation" if device else "user_annotation"
        total: dict[str, float] = {}
        for e in sorted(self.events(), key=lambda e: e["ts"]):
            if e.get("cat") == category:
                total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] / 1e3
        return total


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
    """A named span inside a :func:`trace` capture:
    ``torch.profiler.record_function``.

    with trace(d):
        with annotate("forward"):
            out = fwd(x)
    """
    return torch.profiler.record_function(name)
