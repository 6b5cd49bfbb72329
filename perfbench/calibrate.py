#!/usr/bin/env python3
"""The readings that the limits of ``limits/<cell>.json`` are set from:
for each seed, a run of the cell as the benchmark makes it (set-up, a
short window, the check) gives the program's numbers, and the same
outputs are judged again with a control or a fault in the program's place.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--out chiprun_out/calibrate.jsonl]

The controls, the reference put in the program's place one precision
below the configuration's:

- serve (bf16): the reference with every bf16 rounding of the program
  made in float8 e4m3 (``reference.detr.fp8``);
- train (f32, TF32 off): the reference with TF32 products; the faults:
  each batch's first image alone (half the batch left out, the mean over
  the rest) and a step that leaves the state unchanged;
- op (f32): the program's own bf16 path (``img`` and ``out_grad`` in
  bf16).

One JSON line a seed: ``{"seed", "program", "control", "faults"}``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] != str(ROOT):
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference import detr as ref_detr  # noqa: E402


def serve_readings(cell, st) -> dict:
    program = cell.driver.check(st)
    return {"program": program,
            "control": cell.driver.check(st, rnd=ref_detr.fp8), "faults": {}}


def train_readings(cell, st) -> dict:
    d = cell.driver
    d.release(st)
    ref = d.reference(st["ctx"], st["pool"])
    unchanged = dict(st["program"], change={
        n: torch.zeros_like(t) for n, t in ref["change"].items()})
    return {"program": d.compare(st["program"], ref),
            "control": d.compare(d.reference(st["ctx"], st["pool"],
                                             tf32=True), ref),
            "faults": {
                "half_batch": d.compare(d.reference(
                    st["ctx"], st["pool"], half_batch=True), ref),
                "unchanged": d.compare(unchanged, ref)}}


def op_readings(cell, st) -> dict:
    d = cell.driver
    k, _ = st["last"]
    program = d.check(st)
    x = st["pool"][k]
    low = {n: (x[n].detach().to(torch.bfloat16).requires_grad_(n == "img")
               if n in ("img", "og") else x[n]) for n in x}
    got = d.call(st, low)
    return {"program": program, "control": d.compare(got, d.reference(st, k)),
            "faults": {}}


READINGS = {"serve": serve_readings, "train": train_readings,
            "op": op_readings}


def readings(cell, seed: int, seconds: float, device) -> dict:
    """One seed: the set-up and a window as a run makes them, then the
    program's, the control's and the faults' numbers."""
    started = time.perf_counter()
    ctx = harness.SimpleNamespace(name=cell.name, config=cell.config,
                                  traffic=cell.traffic, seed=seed,
                                  device=device, trace=False,
                                  tmpdir=tempfile.gettempdir(),
                                  mark=lambda name: None)
    st = cell.driver.setup(ctx)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    harness.measure(cell, st, seconds, False, ctx.tmpdir, sync)
    out = READINGS[cell.traffic["driver"]](cell, st)
    out["seed"] = seed
    out["seconds"] = time.perf_counter() - started
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.find_cell(ROOT, args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, args.seconds, device))
        print(line, flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
