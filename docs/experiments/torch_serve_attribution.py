#!/usr/bin/env python3
"""Where one served bf16 request's device time goes, kernel by kernel and
call by call, on one NVIDIA GPU.

    python3 docs/experiments/torch_serve_attribution.py [--hw 800 1333]

The serve cell's detector (``perfbench/configs/ddetr-refine.json``, the
weights drawn from ``--seed`` as the benchmark draws them, bf16 compute,
batch 2) at one input size, under ``inference_mode``:

- **calls**: one eager request under ``torch.profiler`` with the inputs'
  shapes recorded; each PyTorch call (``aten::div``, ``aten::copy_``,
  ``aten::_softmax``, ...) with its input shapes and dtypes, the device
  time of the kernels it launched itself, and the kernels' names, so that
  an elementwise kernel of the graphed request can be matched to the call
  and the shape that launched it;
- **kernels**: one replay of the request captured as a CUDA graph
  (``utils.graphs.graphed``, as the benchmark serves it), device time by
  kernel name and launches, and the spans ``encoder`` and ``decoder``.

Prints both tables and one JSON line with the card's name and power limit
(and writes the JSON to ``--out`` when given).  Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import inputs, program  # noqa: E402


def card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"name": torch.cuda.get_device_name(0), "smi": smi.strip()}


def calls_table(model, pyramid, shapes, rows: int) -> list[dict]:
    """One eager request's PyTorch calls by (name, input shapes, dtypes),
    with the device time of the kernels each launched directly."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(pyramid, shapes)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            model(pyramid, shapes)
            torch.cuda.synchronize()
    # the kernels each CPU op launched, through the launch's correlation
    kernels = collections.defaultdict(collections.Counter)
    for evt in prof.events():
        for child in evt.kernels:
            kernels[(evt.name, str(evt.input_shapes))][child.name[:90]] += 1
    out = []
    for avg in prof.key_averages(group_by_input_shape=True):
        device_us = avg.self_device_time_total
        if device_us <= 0:
            continue
        key = (avg.key, str(avg.input_shapes))
        out.append({"call": avg.key, "shapes": avg.input_shapes,
                    "count": avg.count, "device_ms": device_us / 1e3,
                    "kernels": dict(kernels.get(key, {}))})
    out.sort(key=lambda r: -r["device_ms"])
    return out[:rows]


def kernels_table(model, pyramid, shapes, rows: int) -> dict:
    """One graphed replay's device time by kernel name, and its spans."""
    from msda_tpu_torch.utils import graphed, trace

    serve = graphed(lambda pyr: model(pyr, shapes))
    with torch.inference_mode():
        for _ in range(3):  # the warm-up, the capture, a replay
            serve(pyramid)
        torch.cuda.synchronize()
        with trace(str(ROOT / "build" / "traces" / "serve_attribution")) as t:
            serve(pyramid)
            torch.cuda.synchronize()
    by_name = sorted(t.kernel_ms().items(), key=lambda kv: -kv[1])[:rows]
    return {"busy_ms": t.busy_ms(),
            "spans_ms": t.span_ms(device=True),
            "kernels": [{"kernel": k[:120], "ms": v} for k, v in by_name]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(800, 1333))
    ap.add_argument("--seed", type=int, default=2_000_000_011)
    ap.add_argument("--rows", type=int, default=40)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "perfbench/configs/ddetr-refine.json")
                     .read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/serve-bf16-coco8.json")
                         .read_text())
    weights = inputs.detector_weights(cfg, args.seed, dev)
    model = program.detector(cfg, weights, dev, torch.bfloat16).eval()
    pyramid = inputs.pyramid(cfg, tuple(args.hw), traffic["batch"],
                             inputs.generator(args.seed, dev, "pool"), dev)
    shapes = program.shapes_of(pyramid)

    calls = calls_table(model, pyramid, shapes, args.rows)
    print(f"{'device ms':>10} {'n':>4}  call  shapes  kernels")
    for r in calls:
        print(f"{r['device_ms']:10.4f} {r['count']:4d}  {r['call']}  "
              f"{r['shapes']}  {r['kernels']}")
    graph = kernels_table(model, pyramid, shapes, args.rows)
    print(f"graphed replay: busy {graph['busy_ms']:.4f} ms, spans "
          f"{graph['spans_ms']}")
    for r in graph["kernels"]:
        print(f"{r['ms']:10.4f}  {r['kernel']}")
    result = {"card": card(), "hw": list(args.hw), "seed": args.seed,
              "calls": calls, "graph": graph}
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
