#!/usr/bin/env python3
"""Break the gather-form K2 of commit de67cc6 down by level and by its
img_grad atomics, on one NVIDIA GPU: the measurement behind K2's
redesign (the dense coarse form, ``docs/experiments/msda_bwd_coarse.cu``,
and the walk of ``msda_tpu_torch/csrc/msda_bwd.cu``).

    git archive de67cc6 msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_bwd_breakdown.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

Variants of that ``msda_bwd.cu`` are made by text substitution (a
substitution that finds no anchor raises: the script is tied to those
sources) and built side by side, one ``nvcc`` each, each with its two
masks defined at the top of its source:

  * ``BD_LEVELS``: a bit mask of the levels whose points the kernel walks
    (the others are skipped, their gradients left unwritten);
  * ``BD_NOADD``: a bit mask of the levels whose img_grad atomics are
    skipped (their dot products and point gradients still computed).

Each variant runs behind the checkout's ``cuda_bwd.msda_bwd`` (swapped in
through ``_build._LOADED``), timed with CUDA events in turns (all
variants, then the same in reverse order), at Deformable DETR's encoder and
decoder shapes and the reference workload, on uniform points
(``chip_smoke.op_inputs``) and, for the encoder and decoder, on the points
of the first encoder / decoder layer of ``chip_smoke.py``'s full-width
model (``torch_kernel_ab.model_inputs``), in f32 and bf16.  Prints one
line per timing with the card's ``nvidia-smi`` name and power limit and
writes them to ``--out`` (default ``build/kernel_ab/bwd_breakdown.log``).
Needs a CUDA card and ``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs
from torch_kernel_variants import sub
from msda_tpu_torch.ops import cuda_bwd

LIB = "msda_bwd"
ALL = 0xF


def instrumented(k2: str) -> str:
    """de67cc6's K2 with the two masks (default: every level, every add)."""
    text = sub(k2, '#include "msda_lanes.cuh"\n',
               '#include "msda_lanes.cuh"\n\n#ifndef BD_LEVELS\n'
               '#define BD_LEVELS 0xFFFF\n#endif\n#ifndef BD_NOADD\n'
               '#define BD_NOADD 0\n#endif\n')
    text = sub(text, "  for (int l = 0; l < L; ++l) {\n",
               "  for (int l = 0; l < L; ++l) {\n"
               "    if (!((BD_LEVELS >> l) & 1)) continue;\n")
    return sub(text, "        if (valid) {\n",
               "        if (valid && !((BD_NOADD >> l) & 1)) {\n")


def variants(levels: int) -> dict:
    """{tag: (BD_LEVELS, BD_NOADD)}: all levels with and without their
    adds, each level alone with and without, the coarse pair (the last
    two levels) alone with and without, and all levels with only the
    coarse pair's adds skipped."""
    out = {"all": (ALL, 0), "all_noadd": (ALL, ALL)}
    for lvl in range(levels):
        out[f"L{lvl}"] = (1 << lvl, 0)
        out[f"L{lvl}_noadd"] = (1 << lvl, 1 << lvl)
    coarse = (1 << (levels - 1)) | (1 << (levels - 2))
    out["coarse"] = (coarse, 0)
    out["coarse_noadd"] = (coarse, coarse)
    out["all_coarse_noadd"] = (ALL, coarse)
    return out


def build_variants(parent: str, tags: dict) -> dict:
    """Build every variant of the parent's K2; {tag: CDLL}."""
    with open(os.path.join(parent, LIB + ".cu")) as f:
        text = instrumented(f.read())
    jobs, include = {}, {}
    for tag, (lv, na) in tags.items():
        jobs[(LIB, tag)] = (f"#define BD_LEVELS {lv}\n#define BD_NOADD {na}\n"
                            + text)
        include[(LIB, tag)] = parent
    return {tag: lib for (_, tag), lib in ab.build(jobs, include).items()}


CASES = (
    ("encoder", "encoder",
     lambda: cs.op_inputs(**cs.OP_CASES["encoder"], out_grad=True), 20),
    ("encoder_model", "encoder", lambda: ab.model_inputs(0), 20),
    ("decoder", "decoder",
     lambda: cs.op_inputs(**cs.OP_CASES["decoder"], out_grad=True), 200),
    ("decoder_model", "decoder", lambda: ab.model_inputs(6), 200),
    ("reference_workload", "reference_workload",
     lambda: cs.op_inputs(**cs.OP_CASES["reference_workload"],
                          out_grad=True), 20),
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="de67cc6's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "bwd_breakdown.log"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    tags = variants(len(cs.SLICE_SHAPES))
    libs = build_variants(args.parent, tags)
    for case_name, op_case, make, iters in CASES:
        img32, pts, wts, og32 = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)

            def call():
                cuda_bwd.msda_bwd(img, shapes, pts, wts, og)

            fns = {tag: ab.timed(LIB, lib, call) for tag, lib in libs.items()}
            runs = {tag: [] for tag in fns}
            for tag in list(fns) + list(fns)[::-1]:
                runs[tag].append(cs.time_ms(fns[tag], iters))
            full = sum(runs["all"]) / 2
            for tag, (a, b) in runs.items():
                lv, na = tags[tag]
                ms = (a + b) / 2
                ab.log(f"breakdown {case_name:18s} {str(dtype)[6:]:8s} "
                       f"{tag:17s} levels {lv:#x} noadd {na:#x}: "
                       f"{ms:.4f} ms ({a:.4f}, {b:.4f}), "
                       f"{100 * ms / full:.1f}% of all on {smi}")
            del img, og
        del img32, pts, wts, og32
    ab.log(f"breakdown done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
