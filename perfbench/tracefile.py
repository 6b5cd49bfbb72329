"""Reading a ``torch.profiler`` Chrome trace: a frozen copy of the
arithmetic of ``msda_tpu_torch.utils.profile.Trace`` (device busy time as
the union of device intervals, device time by name), and what the
benchmark adds: device time attributed to the harness's own spans through
the profiler's launch correlation, host time outside the CUDA API, and
the longest idle gaps labelled by what the host was doing.

Times in the trace are microseconds; this module returns seconds.
"""

from __future__ import annotations

import bisect
import collections
import json

# device activity in a Chrome trace of torch.profiler (Kineto's categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls into CUDA, which carry the correlation id of what they launch
API_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   *API_CATEGORIES)


class TraceFile:
    """The complete events (``"ph": "X"``) of one Chrome trace."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        self.events = [e for e in data.get("traceEvents", [])
                       if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((e for e in self.events
                              if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda e: e["ts"])

    # -- device ------------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some device work ran: the union of the device
        events' intervals."""
        return sum(b - a for a, b in self._busy_intervals()) / 1e6

    def _busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for e in self.device:
            start, stop = e["ts"], e["ts"] + e["dur"]
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], stop)
            else:
                merged.append([start, stop])
        return [(a, b) for a, b in merged]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: ``[name, seconds]``,
        summed by name, largest first."""
        total = collections.Counter()
        for e in self.device:
            total[e["name"]] += e["dur"] / 1e6
        return [[name, s] for name, s in total.most_common(top)]

    # -- attribution -------------------------------------------------------
    def span_device_s(self, names) -> dict[str, float]:
        """Device seconds of the work launched inside each span of
        ``names`` (``record_function`` spans on any host thread), through
        the profiler's correlation of each device event with the host call
        that launched it.  Work whose launch lies in no such span is under
        ``None``."""
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in self.events
                       if e.get("cat") == "user_annotation"
                       and e["name"] in names)
        starts = [s[0] for s in spans]
        launch = {}
        for e in self.events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in API_CATEGORIES and corr is not None:
                launch[corr] = e["ts"]
        out: dict = collections.defaultdict(float)
        for e in self.device:
            ts = launch.get((e.get("args") or {}).get("correlation"))
            name = None
            if ts is not None:
                # the spans of ``names`` do not nest: the one that began
                # last before the launch holds it, if any does
                i = bisect.bisect_right(starts, ts) - 1
                if i >= 0 and ts <= spans[i][1]:
                    name = spans[i][2]
            out[name] += e["dur"] / 1e6
        return dict(out)

    def span_count(self, name: str) -> int:
        return sum(1 for e in self.events
                   if e.get("cat") == "user_annotation" and e["name"] == name)

    def host_outside_api_s(self, name: str) -> list[float]:
        """For each span ``name``, its host seconds outside the CUDA API
        calls made inside it on any thread (calls that block while the
        device's queue is full; an autograd backward makes them on its own
        thread while the caller waits)."""
        calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.events
                       if e.get("cat") in API_CATEGORIES)
        merged: list[list[float]] = []
        for a, b in calls:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        starts = [a for a, _ in merged]
        out = []
        for e in self.events:
            if e.get("cat") != "user_annotation" or e["name"] != name:
                continue
            start, stop = e["ts"], e["ts"] + e["dur"]
            i = max(0, bisect.bisect_right(starts, start) - 1)
            inside = 0.0
            while i < len(merged) and merged[i][0] < stop:
                inside += max(0.0, min(stop, merged[i][1])
                              - max(start, merged[i][0]))
                i += 1
            out.append((e["dur"] - inside) / 1e6)
        return out

    # -- gaps --------------------------------------------------------------
    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest stretches with no device work between the first and
        the last device event, each ``[what the host was doing, seconds]``:
        the innermost host event of the thread that ran the harness's
        spans at the gap's middle."""
        busy = self._busy_intervals()
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])
                if a1 > b0]
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        host = [e for e in self.events if e.get("cat") in HOST_CATEGORIES]
        tids = collections.Counter(e.get("tid") for e in host
                                   if e.get("cat") == "user_annotation"
                                   and e["name"].startswith("perfbench."))
        main = tids.most_common(1)[0][0] if tids else None
        host = [e for e in host if e.get("tid") == main]
        out = []
        for start, stop in gaps[:top]:
            mid = (start + stop) / 2
            inner = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            label = (min(inner, key=lambda e: e["dur"])["name"] if inner
                     else "no host event")
            out.append([label, (stop - start) / 1e6])
        return out
