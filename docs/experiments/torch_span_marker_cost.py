#!/usr/bin/env python3
"""What the span markers cost a served request, on one NVIDIA GPU: the
serve cell's detector (``BENCHMARK.json``'s ``ddetr-refine.serve-bf16-coco8``,
its configuration, sizes and weights from ``--seed``) served through two
graphed functions in one process, one captured with its layer spans'
markers and one without, in turns.

    python3 docs/experiments/torch_span_marker_cost.py --seed 3000000001

The function without markers is captured with ``profile._MARKERS`` holding
None for the device (this experiment's patch; the program has no switch),
so its ``annotate`` spans record nothing under the capture.  Then, in
``--rounds`` rounds that alternate which goes first: one request of every
size through each, each timed on the host clock up to a
``synchronize`` (latency) and by CUDA events around the call (the device's
time from the copies in to the clones out); and a closed loop of
``--loop-seconds`` through each, images a second.  Last, 16 requests of
each under the profiler: device busy ms a request, and around every run of
markers in a replay (an end and the next span's begin), the gap from the
kernel before it to the kernel after it, against the same kernels' gap in
the replay without markers.  Prints one JSON line, with the card's name
and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness, inputs, program, spans  # noqa: E402

CELL = "ddetr-refine.serve-bf16-coco8"


def build(seed, device):
    """The cell's model, one pyramid and sizes tensor a size, and the two
    graphed serving functions, warmed up and captured at every size."""
    from msda_tpu_torch.models import postprocess
    from msda_tpu_torch.utils import graphed, profile

    cell = harness.find_cell(ROOT, CELL)
    cfg, tr = cell.config, cell.traffic
    weights = inputs.detector_weights(cfg, seed, device)
    model = program.detector(cfg, weights, device,
                             program.dtype(tr["compute_dtype"])).eval()

    def serve_fn(pyramid, image_sizes):
        return postprocess(model(pyramid, program.shapes_of(pyramid)),
                           top_k=tr["top_k"], scoring=tr["scoring"],
                           image_sizes=image_sizes)

    sizes = [tuple(s) for s in tr["sizes"]]
    B = tr["batch"]
    pyramids = [inputs.pyramid(cfg, hw, B, inputs.generator(
        seed, device, "pool", hw, 0), device) for hw in sizes]
    image_sizes = [torch.tensor([hw] * B, device=device) for hw in sizes]
    marked = graphed(serve_fn)
    plain = graphed(lambda p, s: serve_fn(p, s))
    with torch.inference_mode():
        for s in range(len(sizes)):
            for _ in range(2):
                marked(pyramids[s], image_sizes[s])
        index = torch.cuda.current_device()
        lib = profile._MARKERS[index]
        profile._MARKERS[index] = None  # no markers in this capture
        try:
            for s in range(len(sizes)):
                for _ in range(2):
                    plain(pyramids[s], image_sizes[s])
        finally:
            profile._MARKERS[index] = lib
    torch.cuda.synchronize()
    return {"with": marked, "without": plain}, pyramids, image_sizes, B


def timed(fn, pyramid, sizes):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn(pyramid, sizes)
    stop.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(stop)


def loop(fn, pyramids, image_sizes, seconds):
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s = n % len(pyramids)
        fn(pyramids[s], image_sizes[s])
        torch.cuda.synchronize()
        n += 1
    return n, time.perf_counter() - t0


def traced(fn, pyramids, image_sizes, count=16):
    from msda_tpu_torch.utils import profile

    with profile.trace(tempfile.mkdtemp(prefix="marker-cost-")) as t:
        for k in range(count):
            s = k % len(pyramids)
            fn(pyramids[s], image_sizes[s])
            torch.cuda.synchronize()
    device = sorted((e for e in t.events()
                     if e.get("cat") in ("kernel", "gpu_memcpy",
                                         "gpu_memset")),
                    key=lambda e: e["ts"])
    return t.busy_ms() / count, device


def marker_gaps(device):
    """For every run of markers with a kernel on both sides in one replay
    (the same launch's correlation): the time from the kernel before to the
    kernel after, with the kernels' names; and whether every begin and end
    of a replay share its correlation."""
    out, corr = [], {}
    for i, e in enumerate(device):
        if not spans.MARKER.search(e["name"]):
            continue
        c = (e.get("args") or {}).get("correlation")
        corr.setdefault(c, []).append(e["name"])
        if i == 0 or spans.MARKER.search(device[i - 1]["name"]):
            continue
        j = i + 1
        while j < len(device) and spans.MARKER.search(device[j]["name"]):
            j += 1
        if j < len(device):
            before, after = device[i - 1], device[j]
            out.append((before["name"][:60], after["name"][:60],
                        after["ts"] - (before["ts"] + before["dur"])))
    return out, corr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--loop-seconds", type=float, default=3.0)
    ap.add_argument("--loops", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fns, pyramids, image_sizes, B = build(args.seed, device)
    lat = {k: [] for k in fns}
    dev = {k: [] for k in fns}
    rate = {k: [] for k in fns}
    order = list(fns)
    with torch.inference_mode():
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                for s in range(len(pyramids)):
                    h, d = timed(fns[name], pyramids[s], image_sizes[s])
                    lat[name].append(h * 1e3)
                    dev[name].append(d)
        for r in range(args.loops):
            for name in order if r % 2 == 0 else order[::-1]:
                n, w = loop(fns[name], pyramids, image_sizes,
                            args.loop_seconds)
                rate[name].append(n * B / w)
        busy, gaps = {}, {}
        for name in order:
            busy[name], device_events = traced(fns[name], pyramids,
                                               image_sizes)
            gaps[name] = device_events
    with_gaps, corr = marker_gaps(gaps["with"])
    # the same kernel pairs' gap in the replays without markers
    plain = gaps["without"]
    plain_gap = {}
    for a, b in zip(plain, plain[1:]):
        plain_gap.setdefault((a["name"][:60], b["name"][:60]), []).append(
            b["ts"] - (a["ts"] + a["dur"]))
    interior = [(g, statistics.median(plain_gap[(a, b)]))
                for a, b, g in with_gaps if (a, b) in plain_gap]
    pairs_share = sum(
        1 for names in corr.values()
        if sorted(n.endswith("begin>()") for n in names).count(True)
        == sorted(n.endswith("begin>()") for n in names).count(False))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {
        "card": smi, "seed": args.seed,
        "latency_ms": {k: [statistics.mean(v), statistics.median(v)]
                       for k, v in lat.items()},
        "event_ms": {k: [statistics.mean(v), statistics.median(v)]
                     for k, v in dev.items()},
        "images_per_s": rate,
        "busy_ms": busy,
        "marker_runs_with_kernels_both_sides": len(with_gaps),
        "interior_gap_us_with_vs_without": [
            statistics.mean(g for g, _ in interior) if interior else None,
            statistics.mean(p for _, p in interior) if interior else None,
            len(interior)],
        "replays_with_markers": len(corr),
        "replays_whose_markers_pair": pairs_share,
        "markers_a_replay": statistics.median(len(v) for v in corr.values())
        if corr else 0,
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
