#!/usr/bin/env python3
"""Where a traced benchmark run's device time goes, by the program's own
layer spans, on one NVIDIA GPU.

    python3 docs/experiments/torch_span_coverage.py \
        --workload ddetr-refine.serve-bf16-coco8 --seed 3000000001

Runs one cell of ``BENCHMARK.json`` as ``perfbench/run.py --trace 1``
does, keeps the traced slice, and prints one JSON line: the card's name and
power limit, the units traced, the device's busy ms a unit, each marked
span's device ms a unit (``perfbench/spans.py``: the union of the device
work between a span's begin and end markers), the device ms a unit outside
every span by kernel name (the copies in and out of a graph replay among
them), the spans' share of the busy time, the marker kernels' own device
us a unit and their counts (with the first markers out of order), the
device time around them against the usual gap between two kernels, the
mean host ms of ``graphed.call`` and of each of its child spans in the
slice, the serve cell's host ms a request before the slice
(``request_host_ms.serve``'s reading, with no profiler running), and the
result line's metrics.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, spans  # noqa: E402


def markers(device) -> tuple[dict, list]:
    """Each span's begin and end markers counted, and the first few
    markers that break a span's begin, end, begin, ... order, each with
    the device events around it."""
    ordered = sorted(device, key=lambda e: e["ts"])
    counts = collections.defaultdict(lambda: [0, 0])
    last, unpaired = {}, []
    t0 = ordered[0]["ts"] if ordered else 0
    for i, e in enumerate(ordered):
        m = spans.MARKER.search(e["name"])
        if not m:
            continue
        edge = m[2] == "end"
        counts[m[1]][edge] += 1
        if last.get(m[1], True) == edge and len(unpaired) < 6:
            unpaired.append({
                "span": m[1], "edge": m[2], "at_us": e["ts"] - t0,
                "around": [[o["name"][:40], o["ts"] - t0, o["dur"]]
                           for o in ordered[max(0, i - 3):i + 4]]})
        last[m[1]] = edge
    return dict(counts), unpaired


def slots(device, units) -> dict:
    """What the markers take of the device's time.  Markers launched one
    after another (an end, then the next span's begin) form a run; a run's
    slot is the time from the device event before it to the one after it.
    ``slot_us`` sums them a unit, ``runs`` counts them a unit, and
    ``gap_us`` is the median gap between two consecutive other events less
    than 50 us apart (what the slot would be without the markers), so that
    the markers cost about ``slot_us - runs * gap_us`` a unit."""
    ordered = sorted(device, key=lambda e: e["ts"])
    slot, runs, gaps, prev, in_run = 0.0, 0, [], None, False
    for e in ordered:
        if spans.MARKER.search(e["name"]):
            in_run = prev is not None
            continue
        if prev is not None:
            gap = e["ts"] - (prev["ts"] + prev["dur"])
            if in_run:
                slot += gap
                runs += 1
            elif 0 <= gap < 50:
                gaps.append(gap)
        in_run = False
        prev = e
    gaps.sort()
    return {"slot_us": slot / units, "runs": runs / units,
            "gap_us": gaps[len(gaps) // 2] if gaps else 0.0}


def breakdown(trace, traced, state) -> dict:
    units = len(traced)
    device = trace.device
    spanned = sorted((start, stop, name)
                     for name, start, stop in spans.marker_windows(device))
    starts = [w[0] for w in spanned]
    outside = collections.Counter()
    marker_us = 0.0
    for e in device:
        if spans.MARKER.search(e["name"]):
            marker_us += e["dur"]
            continue
        mid = e["ts"] + e["dur"] / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid > spanned[i][1]:
            outside[e["name"][:90]] += e["dur"]
    busy_ms = trace.busy_s() * 1e3 / units
    layer_ms = {name: sum(v) / units / 1e3
                for name, v in spans.marked_spans(device).items()}
    host = collections.defaultdict(list)
    for e in trace.events:
        if e.get("cat") == "user_annotation" and (
                e["name"].startswith("graphed.")
                or e["name"].startswith("msda.")):
            host[e["name"]].append(e["dur"] / 1e3)
    out = {
        "units": units, "busy_ms": busy_ms, "layer_ms": layer_ms,
        "layer_share_pct": 100 * sum(layer_ms.values()) / busy_ms,
        "outside_ms": {k: v / units / 1e3 for k, v in outside.most_common(8)},
        "outside_share_pct": 100 * sum(outside.values()) / units / 1e3
        / busy_ms,
        "marker_us": marker_us / units,
        "host_ms": {k: [len(v), sum(v) / len(v)] for k, v in host.items()},
    }
    out["markers"], out["unpaired"] = markers(device)
    out["marker_slots"] = slots(device, units)
    if "call_s" in state:
        calls = state["call_s"][:traced.start]
        out["request_host_ms"] = sum(calls) / len(calls) * 1e3
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    started = time.perf_counter()
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kept = {}
    measure = harness.measure

    def keep(cell, state, *rest, **kw):
        run = measure(cell, state, *rest, **kw)
        kept.update(trace=run.trace, traced=run.traced, state=state)
        return run

    harness.measure = keep
    cell = harness.find_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="coverage-") as tmpdir:
        result = harness.execute(cell, args.seed, args.seconds, True, device,
                                 started, tmpdir)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"workload": args.workload, "seed": args.seed, "card": smi,
            **breakdown(kept["trace"], kept["traced"], kept["state"]),
            "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
