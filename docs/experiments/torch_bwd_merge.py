#!/usr/bin/env python3
"""K2's merged adds measured on one NVIDIA GPU: img_grad's error where
every point of a (b, h) lands on one place, and the kernel's time, beside
de67cc6's K2 and variants of the checkout's.

    git archive de67cc6 msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_bwd_merge.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

Builds, one ``nvcc`` each, all started together, and swaps in behind the
checkout's ``cuda_bwd.msda_bwd`` (``_build._LOADED``):

  * ``old``: de67cc6's K2 (``--parent``): one atomic a corner a point;
  * ``merge``: the checkout's K2 as it is;
  * ``nomerge``: without its Pending sets (one atomic a corner a point);
  * ``inexact``: without its exact adds (every run's sum added with one
    plain f32 atomic);
  * ``exact2``: exact adds for every run of 2 points or more (as built,
    a run of all P points of a query's level);
  * ``lb1``: without the half types' merging kernels' launch bounds
    (three blocks an SM: at most 80 registers a thread);
  * ``lb3``: with those bounds on f32's merging kernels too;
  * ``noinline``: the exact add as a called function, not inlined.

The variants are made by text substitution; one that finds no anchor
raises: the script is tied to the sources of the commit that added it.
First, for each build, phase 2's case where every point of each (b, h)
lies at one place on every level (``chip_smoke.bwd_case_inputs(
"hot_pixel")``): img_grad's error against ``native_msda_backward`` level
by level, f32, relative to max(1, |ref|) as ``chip_smoke.py`` reads it;
then every build against the plain version on the model's points at the
encoder (f32, all three gradients).  Then each build's time at the
encoder (uniform and the model's points), the decoder (the model's
points) and the reference workload, f32 and bf16, in turns (all builds,
then in reverse): CUDA events around the wrapper, and
``torch.profiler``'s device ms a call by kernel (the elementwise kernels
are img_grad's zeroing, the sum of its two halves and the cast).
``--spread N`` first reads the hot pixel's error over N calls in each
mode for ``merge`` and ``inexact`` (``--spread-only``: only that).  Prints
one line per reading with the card's name and power limit, written to
``--out`` (default ``build/kernel_ab/bwd_merge.log``).  Needs a CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs
from torch_kernel_variants import sub
from msda_tpu_torch.ops import _build, cuda_bwd

LIB = "msda_bwd"


def variants(src: str) -> dict:
    """{tag: source text} of the checkout's msda_bwd.cu."""
    return {
        "nomerge": sub(src, "  const bool merge = C <= G * vec;",
                       "  const bool merge = false;"),
        "inexact": sub(src, "const bool exact = s.len >= exact_run;",
                       "const bool exact = false;"),
        "exact2": sub(src, "const bool exact = s.len >= exact_run;",
                      "const bool exact = s.len >= 2;"),
        "lb1": sub(src, "MERGE && !std::is_same<T, float>::value", "false"),
        "lb3": sub(src, "MERGE && !std::is_same<T, float>::value", "MERGE"),
        "noinline": sub(src, "__device__ __forceinline__ void add_exact(",
                        "__device__ __noinline__ void add_exact("),
    }


def registers(log: str) -> list:
    """(kernel instance, registers) of each entry function in a ptxas
    log."""
    out, name = [], None
    for line in log.splitlines():
        found = re.search(r"entry function '(\w+)'", line)
        if found:
            name = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            out.append((name, int(found.group(1))))
            name = None
    return out


CASES = (
    ("encoder", "encoder",
     lambda: cs.op_inputs(**cs.OP_CASES["encoder"], out_grad=True), 10),
    ("encoder_model", "encoder", lambda: ab.model_inputs(0), 10),
    ("decoder_model", "decoder", lambda: ab.model_inputs(6), 100),
    ("reference_workload", "reference_workload",
     lambda: cs.op_inputs(**cs.OP_CASES["reference_workload"],
                          out_grad=True), 10),
)


def accuracy(libs: dict, order: list, smi: str) -> None:
    """img_grad's error by level on the hot pixel; every gradient's on the
    model's points."""
    shapes, img, pts, wts, og = cs.bwd_case_inputs("hot_pixel")
    want = cs.plain_msda_bwd(img, shapes, pts, wts, og)[0]
    for tag in order:
        _build._LOADED[LIB] = libs[tag]
        got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og)[0]
        off, worst = 0, 0.0
        for lvl, (h, w) in enumerate(shapes):
            e = cs.errors(got[:, off:off + h * w], want[:, off:off + h * w])
            worst = max(worst, e[2])
            ab.log(f"hot pixel {tag:8s} f32 level {lvl} ({h}x{w}): max_abs "
                   f"{e[0]:.2e}, err {e[2]:.2e} (bar 1e-4) on {smi}")
            off += h * w
        ab.log(f"hot pixel {tag:8s} f32 worst err {worst:.2e} (bar 1e-4)")
    del img, pts, wts, og, want
    shapes, img, pts, wts, og = cs.bwd_case_inputs("encoder_model")
    want = cs.plain_msda_bwd(img, shapes, pts, wts, og)
    for tag in order:
        _build._LOADED[LIB] = libs[tag]
        got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og)
        errs = [cs.errors(g, w)[2] for g, w in zip(got, want)]
        ab.log(f"encoder_model {tag:8s} f32 err img/points/weights "
               f"{', '.join(f'{e:.2e}' for e in errs)} (bars "
               f"{cs.IMG_GRAD_TOL[torch.float32]:g}, {cs.POINT_GRAD_TOL:g})")


def hot_spread(libs: dict, tags: list, repeats: int, smi: str) -> None:
    """img_grad's error on the hot pixel over ``repeats`` calls in each
    mode (the atomics' order varies from call to call): its largest,
    median and the calls past the 1e-4 bar, f32."""
    shapes, img, pts, wts, og = cs.bwd_case_inputs("hot_pixel")
    for mode in cs.MODES:
        want = cs.plain_msda_bwd(img, shapes, pts, wts, og, *mode)[0]
        scale = want.float().abs().clamp(min=1.0)
        for tag in tags:
            _build._LOADED[LIB] = libs[tag]
            errs = torch.stack([
                ((cuda_bwd.msda_bwd(img, shapes, pts, wts, og, *mode)[0]
                  - want).abs() / scale).max() for _ in range(repeats)])
            ab.log(f"hot pixel spread {tag:8s} f32 {mode[0]:6s} "
                   f"ac={int(mode[1])}: {repeats} calls, err max "
                   f"{errs.max().item():.2e}, median "
                   f"{errs.median().item():.2e}, past 1e-4: "
                   f"{int((errs > 1e-4).sum())} on {smi}")
        del want, scale


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="de67cc6's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "bwd_merge.log"))
    ap.add_argument("--spread", type=int, default=0,
                    help="calls a mode for the hot pixel's error spread "
                    "(merge and inexact; 0: none)")
    ap.add_argument("--spread-only", action="store_true",
                    help="only the spread")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    for name, regs in registers(_build.build_log(LIB)):
        ab.log(f"registers {LIB}: {name} {regs}")
    csrc = os.path.join(ab.ROOT, "msda_tpu_torch", "csrc")
    with open(os.path.join(csrc, LIB + ".cu")) as f:
        src = f.read()
    with open(os.path.join(args.parent, LIB + ".cu")) as f:
        jobs = {(LIB, "old"): f.read()}
    include = {(LIB, "old"): args.parent}
    for tag, text in variants(src).items():
        jobs[(LIB, tag)] = text
        include[(LIB, tag)] = csrc
    libs = {tag: lib for (_, tag), lib in ab.build(jobs, include).items()}
    libs["merge"] = _build.load_library(LIB)
    order = ["old", "nomerge", "merge", "inexact", "exact2", "lb1", "lb3",
             "noinline"]
    if args.spread:
        hot_spread(libs, ["merge", "inexact"], args.spread, smi)
    if args.spread_only:
        ab.write_log(args.out)
        return
    accuracy(libs, order, smi)
    for name, op_case, make, iters in CASES:
        img32, pts, wts, og32 = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)

            def call():
                cuda_bwd.msda_bwd(img, shapes, pts, wts, og)

            runs = {tag: [] for tag in order}
            for tag in order + order[::-1]:
                _build._LOADED[LIB] = libs[tag]
                parts = {}
                ev = cs.time_ms(call, iters)
                ab.device_ms(call, iters, "msda_bwd", parts)
                runs[tag].append((ev, parts))
            for tag, ((e1, p1), (e2, p2)) in runs.items():
                split = "; ".join(
                    f"{k} {(p1.get(k, 0) + p2.get(k, 0)) / 2:.4f}"
                    for k in sorted(set(p1) | set(p2)))
                ab.log(f"merge {name:18s} {str(dtype)[6:]:8s} {tag:8s}: "
                       f"events {(e1 + e2) / 2:.4f} ms ({e1:.4f}, {e2:.4f});"
                       f" device ms a call: {split} on {smi}")
            del img, og
        del img32, pts, wts, og32
    _build._LOADED[LIB] = libs["merge"]
    ab.log(f"merge done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
