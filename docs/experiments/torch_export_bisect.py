#!/usr/bin/env python3
"""The exported bf16 detector served from a fresh process, loaded with and
without ``utils.export.load_exported``'s frame-stack chunk, on one NVIDIA
GPU.

    python3 docs/experiments/torch_export_bisect.py [--turns N] [--out PATH]

``chip_smoke.py`` phase 8b served the exported bf16 full-width detector
from a second process 7-40x slower than the live model, while the process
that exported it served the same bytes at the live model's speed.  The
bisection between the two processes (``PERF.md`` §6, PR 8) traced it to
CPython's frame-stack chunks (``cpython_frame_chunks.py`` shows the
mechanism on a CPU), and ``load_exported`` now starts the generated
``forward`` on a chunk of its own.  This script keeps the before and
after of that repair, in one process tree:

  * the exporting process (``chip_smoke.setup()``: kernels built, TF32
    off) exports the bf16 model + postprocess to ``build/export_bisect/``
    and times the live model on ``chip_smoke.REQUEST_SEEDS`` (CUDA events,
    after one warm-up request);
  * then, ``--turns`` times (default 2), phase 8b's serving process
    (``chip_smoke._SERVE_EXPORTED``, which imports torch, numpy and
    ``msda_tpu_torch.utils.export`` only) twice: ``raw``, the artifact
    loaded as ``torch.export.load(...).module()`` gives it (the serving
    process before the repair), and ``padded``, through ``load_exported``.

Rows are printed with the card's ``nvidia-smi`` name and power limit and
written to ``--out`` (default ``build/export_bisect.log``).  Needs a CUDA
card and ``nvcc``; ~3 min.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from msda_tpu_torch.utils import export_fn, save_exported  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "export_bisect")
# phase 8b's loader line, and the loader before the repair
_LOAD = """    serve = load_exported_file(f"{spec['dir']}/{name}.pt2")"""
_RAW_LOAD = """    serve = torch.export.load(f"{spec['dir']}/{name}.pt2").module()"""


def live_ms(fn, pyramids) -> list:
    """ms of each request of ``pyramids`` after one warm-up request."""
    times = []
    with torch.inference_mode():
        fn(*pyramids[0])
        torch.cuda.synchronize()
        for pyr in pyramids:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*pyr)
            end.record()
            torch.cuda.synchronize()
            times.append(round(start.elapsed_time(end), 3))
    return times


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--turns", type=int, default=2,
                    help="raw, padded pairs of serving processes")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "export_bisect.log"))
    args = ap.parse_args(argv)
    smi = cs.setup()
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    os.makedirs(OUT_DIR, exist_ok=True)
    image_sizes = torch.tensor([cs.IMAGE_HW] * cs.BATCH, device=cs.DEVICE)
    model = cs.build_model("auto", True, torch.bfloat16)

    def live(*pyr):
        return cs.postprocess(model(list(pyr), cs.SLICE_SHAPES), top_k=100,
                              scoring="sigmoid", image_sizes=image_sizes)

    pyramids = [cs.make_pyramid(seed) for seed in cs.REQUEST_SEEDS]
    save_exported(export_fn(live, *pyramids[0]),
                  os.path.join(OUT_DIR, "bf16.pt2"))
    log(f"exporting process, live bf16: ms {live_ms(live, pyramids)} "
        f"on {smi}")
    del model, pyramids
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if _LOAD not in cs._SERVE_EXPORTED:
        raise ValueError("phase 8b's loader line was not found")
    codes = {"raw": cs._SERVE_EXPORTED.replace(_LOAD, _RAW_LOAD),
             "padded": cs._SERVE_EXPORTED}
    spec = {"dir": OUT_DIR, "models": ["bf16"], "seeds": cs.REQUEST_SEEDS,
            "batch": cs.BATCH, "shapes": cs.SLICE_SHAPES,
            "channels": cs.IN_CHANNELS}
    failed = False
    for _ in range(args.turns):
        for form, code in codes.items():
            run = subprocess.run([sys.executable, "-c", code, ROOT,
                                  json.dumps(spec)], capture_output=True,
                                 text=True, timeout=600)
            if run.returncode != 0:
                failed = True
                log(f"fresh process, {form} load: FAILED (exit "
                    f"{run.returncode})\n{run.stderr[-3000:]}")
                continue
            served = json.loads(run.stdout.strip().splitlines()[-1])
            log(f"fresh process, {form} load: bf16 ms "
                f"{[round(t, 3) for t in served['bf16']['ms']]} on {smi}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
