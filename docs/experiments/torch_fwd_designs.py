#!/usr/bin/env python3
"""Time the tiled K1 (``msda_tpu_torch/csrc/msda_fwd.cu``) built with other
launch constants (``csrc/msda_fwd_plan.cuh``) beside the lane-group K1 of
commit cc78811 and the tiled designs that lost, on one NVIDIA GPU: the
choice of K1's design and defaults.

    git archive cc78811 msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_fwd_designs.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

Built side by side, one ``nvcc`` each:
  * the checkout's K1 with each of ``VARIANTS``' ``-D`` flags
    (``_build.load_library(name, defines)``);
  * the parent's K1 from ``--parent`` as it is (``parent``), with 28 KB of
    dynamic shared memory a block that it does not use (``parent_smem28``:
    what the tiled design's shared memory costs the parent's L1), and with
    its task indices divided in 32 bits (``parent_i32``: what the tiled
    design's 32-bit task arithmetic would give the parent);
  * the tiled designs that lost (``DESIGNS``), each from its directory
    under ``docs/experiments/`` beside its own plan header: ``k1_warp_tiles``
    (a ring a warp, no block barrier; held to 64 registers and 2 points a
    batch, its best) and ``k1_geometry_shuffled`` (the geometry in
    registers, shuffled to the group's lanes).
All run behind the checkout's ``cuda_fwd.msda_fwd`` (swapped in through
``_build._LOADED``).  First the checkout's default K1 is held bitwise to the
parent's on ``EDGES`` (tile edges, odd rows, chunks of points, channel
passes, one channel a lane; f32, bf16 and f16, every mode).  Then every
library is held bitwise to the parent on the timed inputs and timed in
turns (all, then the same in reverse order) with CUDA events and
``torch.profiler``'s device time of the kernel alone, at the cases of
``torch_fwd_breakdown.py`` (Deformable DETR's encoder and decoder, uniform
and the model's points, and the reference workload), f32 and bf16.  Prints
each build's registers and one line per check and timing with the card's
``nvidia-smi`` name and power limit, and writes them to ``--out`` (default
``build/kernel_ab/fwd_designs.log``).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import torch

import torch_kernel_ab as ab
from torch_fwd_breakdown import CASES, LIB, SYMBOL
from torch_kernel_ab import cs
from torch_kernel_variants import sub
from msda_tpu_torch.ops import _build, cuda_fwd
from msda_tpu_torch.ops.reference import native_multiscale_deformable_attention

VARIANTS = {
    "default": {},
    "batch1": {"MSDA_FWD_BATCH": 1},
    "batch4": {"MSDA_FWD_BATCH": 4},
    "warps2_blocks16": {"MSDA_FWD_WARPS": 2, "MSDA_FWD_BLOCKS_PER_SM": 16},
    "warps8_blocks4": {"MSDA_FWD_WARPS": 8, "MSDA_FWD_BLOCKS_PER_SM": 4},
    "blocks6": {"MSDA_FWD_BLOCKS_PER_SM": 6},
    "stages2": {"MSDA_FWD_STAGES": 2},
    "stages4": {"MSDA_FWD_STAGES": 4},
    "chunk8": {"MSDA_FWD_CHUNK": 8},
}
LB4 = ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 4)")
# tag: (directory, defines, text substitution or None)
DESIGNS = {
    "warp_tiles": ("k1_warp_tiles", {"MSDA_FWD_BATCH": 2}, LB4),
    "geometry_shuffled": ("k1_geometry_shuffled", {}, None),
}
PARENT_SMEM = ("                            0, stream>>>(",
               "                            28672, stream>>>(")
PARENT_I32 = ("""  const int64_t bh = t / N;  // b * H + h
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  const int64_t task = (b * N + (t - bh * N)) * H + h;""",
              """  const int bh = (int)t / N;  // b * H + h
  const int h = bh % H;
  const int64_t b = bh / H;
  const int64_t task = (b * N + ((int)t - bh * N)) * H + h;""")
SIXTEEN = tuple((64 >> (lvl % 7), 48 >> (lvl % 6)) for lvl in range(16))
# name: (shapes, B, N, H, C, P); the tile edges at C = 32 come from the plan
EDGES = {
    "encoder": (cs.SLICE_SHAPES, 2, 22223, 8, 32, 4),
    "decoder": (cs.SLICE_SHAPES, 2, 300, 8, 32, 4),
    "h1_n1": (cs.REF_SHAPES, 1, 1, 1, 32, 4),
    "c30": (cs.REF_SHAPES, 2, 1037, 8, 30, 4),
    "c160": (cs.REF_SHAPES, 2, 517, 8, 160, 4),
    "c6_p2": (cs.REF_SHAPES, 2, 50, 8, 6, 2),
    "c4_p3": (cs.REF_SHAPES, 2, 50, 8, 4, 3),
    "c1_p3": (cs.REF_SHAPES, 2, 50, 8, 1, 3),
    "c48_p9": (cs.REF_SHAPES, 2, 37, 8, 48, 9),
    "c128_p3": (cs.REF_SHAPES, 2, 23, 8, 128, 3),
    "l1_p3": (((37, 41),), 2, 333, 8, 32, 3),
    "l2_p5": (cs.REF_SHAPES[:2], 2, 70, 8, 32, 5),
    "l16_p1": (SIXTEEN, 2, 129, 8, 32, 1),
    "l16_p4": (SIXTEEN, 2, 129, 8, 32, 4),
    "l16_p4_c160": (SIXTEEN, 1, 77, 4, 160, 4),
    "l4_p33_c30": (cs.REF_SHAPES, 1, 45, 4, 30, 33),
}


def build_all(parent: str) -> dict:
    """{tag: CDLL} of every library above."""
    jobs, include = {}, {}
    with open(os.path.join(parent, LIB + ".cu")) as f:
        jobs[(LIB, "parent")] = f.read()
    include[(LIB, "parent")] = parent
    for tag, change in (("parent_smem28", PARENT_SMEM),
                        ("parent_i32", PARENT_I32)):
        jobs[(LIB, tag)] = sub(jobs[(LIB, "parent")], *change)
        include[(LIB, tag)] = parent
    for tag, (name, defines, swap) in DESIGNS.items():
        d = os.path.join(ab.ROOT, "docs", "experiments", name)
        with open(os.path.join(d, LIB + ".cu")) as f:
            text = f.read()
        jobs[(LIB, tag)] = "".join(
            f"#define {k} {v}\n" for k, v in defines.items()) + (
            sub(text, *swap) if swap else text)
        include[(LIB, tag)] = [d, str(_build.CSRC_DIR)]
    libs = {tag: lib for (_, tag), lib in ab.build(jobs, include).items()}
    _build.build([LIB] * len(VARIANTS), list(VARIANTS.values()))
    for tag, defines in VARIANTS.items():
        libs[tag] = _build.load_library(LIB, defines)
        regs = sorted(set(re.findall(
            r"Used \d+ registers|\d+ bytes spill stores",
            _build.build_log(LIB, defines))))
        ab.log(f"build {LIB} {tag}: {', '.join(regs)}")
    return libs


def check_edges(libs: dict, smi: str) -> None:
    """The default K1 against the parent's, bitwise, and against the plain
    version within ``chip_smoke.TOL``, on ``EDGES`` and the tile edges."""
    probe = cs.op_inputs(cs.REF_SHAPES, B=1, N=1, H=8, C=32, P=4, seed=0)
    T = cuda_fwd.launch_plan(probe[0], cs.REF_SHAPES, *probe[1:])["tile"]
    edges = dict(EDGES)
    for n in (T - 1, T, T + 1, 2 * T + 1):
        edges[f"tile_n{n}"] = (cs.REF_SHAPES, 1, n, 8, 32, 4)
    same = failed = 0
    for seed, (name, (shapes, B, N, H, C, P)) in enumerate(edges.items()):
        img32, pts, wts = cs.op_inputs(shapes, B, N, H, C, P, seed=seed,
                                       oob=True)
        for dtype, tol in cs.TOL.items():
            img = img32.to(dtype)
            for mode in cs.MODES:
                outs = {}
                for tag in ("parent", "default"):
                    ab.swap(LIB, libs[tag])
                    outs[tag] = cuda_fwd.msda_fwd(img, shapes, pts, wts,
                                                  *mode)
                torch.cuda.synchronize()
                want = native_multiscale_deformable_attention(
                    img, shapes, pts, wts, *mode)
                equal = torch.equal(outs["default"], outs["parent"])
                err = cs.errors(outs["default"], want)[2]
                same += equal
                failed += not (equal and err <= tol)
                if not (equal and err <= tol) or mode == cs.MODES[0]:
                    ab.log(f"edges {name:12s} {str(dtype)[6:]:8s} {mode}: "
                           f"{'bitwise equal' if equal else 'DIFFERS'} to "
                           f"the parent; {err:.2e} against plain (tol "
                           f"{tol:g})")
    ab.swap(LIB, libs["default"])
    ab.log(f"edges: {same} of {same + failed} calls bitwise equal to the "
           f"parent and within tolerance of plain on {smi}")
    if failed:
        raise AssertionError(f"{failed} edge calls differ")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="cc78811's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "fwd_designs.log"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    libs = build_all(args.parent)
    check_edges(libs, smi)
    for case_name, op_case, make, iters in CASES:
        img32, pts, wts = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)

            def call():
                return cuda_fwd.msda_fwd(img, shapes, pts, wts)

            ab.swap(LIB, libs["parent"])
            want = call()
            for tag, lib in libs.items():
                ab.swap(LIB, lib)
                got = call()
                err = (got.float() - want.float()).abs().max().item()
                same = "bitwise equal" if torch.equal(got, want) else "DIFFER"
                ab.log(f"designs {case_name:18s} {str(dtype)[6:]:8s} {tag} "
                       f"against parent: {same}, max abs {err:.3e}")
            del want, got
            res = ab.in_turns({tag: ab.timed(LIB, lib, call)
                               for tag, lib in libs.items()}, iters, SYMBOL)
            full = res["parent"]["kernel"][0]
            for tag, r in res.items():
                ev, dev = r["events"], r["kernel"]
                ab.log(f"designs {case_name:18s} {str(dtype)[6:]:8s} "
                       f"{tag:18s}: device {dev[0]:.4f} ms ({dev[1]:.4f}, "
                       f"{dev[2]:.4f}), {100 * dev[0] / full:.1f}% of "
                       f"parent; events {ev[0]:.4f} ms ({ev[1]:.4f}, "
                       f"{ev[2]:.4f}) on {smi}")
            del img
        del img32, pts, wts
    ab.log(f"designs done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
