#!/usr/bin/env python3
"""Time the tiled K2 (``msda_tpu_torch/csrc/msda_bwd.cu``) built with other
launch constants (``csrc/msda_bwd_plan.cuh``) beside the lane-group K2 of
commit 60ed581 and the tiled designs that lost, on one NVIDIA GPU: the
choice of K2's design and defaults.

    git archive 60ed581 msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_bwd_designs.py \
        --parent build/ab_parent/msda_tpu_torch/csrc [--quick]

Built side by side, one ``nvcc`` each:
  * the checkout's K2 with each of ``VARIANTS``' ``-D`` flags
    (``_build.load_library(name, defines)``);
  * the parent's K2 from ``--parent`` as it is (``parent``);
  * text-substituted builds (``SUBSTITUTED``) of the checkout's K2: with
    launch bounds asking for 3, 4, 6 and 8 blocks an SM (at most 170,
    128, 85 and 64 registers a thread); each block on one run of
    consecutive tiles (``contiguous``) or on runs of 2 and 4 (``runs2``,
    ``runs4``); and ablations of it and of the parent (``ABLATIONS``,
    timed, not checked): without any img_grad atomic (``no_atomics``),
    every run added by one plain atomic (``inexact``), every corner load
    from one pixel (``no_loads``), the dot products or all three sums in
    f32 (``f32_dots``, ``f32``), no reduction over the group
    (``no_reduce``), and combinations;
  * the tiled designs that lost (``DESIGNS``), each from its directory
    under ``docs/experiments/`` beside the checkout's headers:
    ``k2_group_sums`` (the three sums of each point reduced by three
    ``group_sum`` butterflies, as the parent reduces them, in place of the
    batch's reduce-scatter).
All run behind the checkout's ``cuda_bwd.msda_bwd`` (swapped in through
``_build._LOADED``).  First the checkout's default K2 is held to the
parent's on ``EDGES`` (tile edges, odd rows, chunks of points, channel
steps, one channel a lane, misaligned points; f32, bf16 and f16, every
mode): the point and weight gradients bitwise or within 2 ulps (where
the f64 sums' FMA contraction rounds differently; the log says how many
elements differ and by how much), img_grad (an atomic sum in
run-dependent order) within ``chip_smoke.IMG_GRAD_TOL`` of the plain
version.  Then every library is held to the parent the same way on the
timed inputs and timed in turns (all, then the same in reverse order) with
CUDA events and ``torch.profiler``'s device time of the kernel alone, at
Deformable DETR's encoder (uniform points, the model's points at 800x1333
and 1600x2666), its decoder (the model's points), the reference workload
and the benchmark's two op cells (``perfbench/inputs.py``'s points: the
offset grid plus jitter), f32 and bf16.  ``--quick``: ``QUICK``'s builds
alone beside the default and the parent, the edges in f32,
``QUICK_CASES``.  Prints each build's registers and one
line per check and timing with the card's ``nvidia-smi`` name and power
limit, and writes them to ``--out`` (default
``build/kernel_ab/bwd_designs.log``).  Needs a CUDA card and ``nvcc``.
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
from msda_tpu_torch.ops.reference import native_msda_backward

LIB = "msda_bwd"
SYMBOL = "msda_bwd_kernel"
VARIANTS = {
    "default": {},
    "batch1": {"MSDA_BWD_BATCH": 1},
    "batch2": {"MSDA_BWD_BATCH": 2},
    "warps2_blocks16": {"MSDA_BWD_WARPS": 2, "MSDA_BWD_BLOCKS_PER_SM": 16},
    "warps8_blocks4": {"MSDA_BWD_WARPS": 8, "MSDA_BWD_BLOCKS_PER_SM": 4},
    "blocks4": {"MSDA_BWD_BLOCKS_PER_SM": 4},
    "stages2": {"MSDA_BWD_STAGES": 2},
    "stages4": {"MSDA_BWD_STAGES": 4},
    "chunk8": {"MSDA_BWD_CHUNK": 8},
}
# tag: directory under docs/experiments holding its msda_bwd.cu
DESIGNS = {"group_sums": "k2_group_sums"}
# tag: (source, text substitutions): the checkout's msda_bwd.cu ("own") with
# its launch bounds asking for 4, 6 and 8 blocks an SM (at most 128, 85 and
# 64 registers a thread); and ablations of it and of the parent, timed but
# not checked (ABLATIONS): no img_grad atomic at all, or no exact add (every
# run added with one plain atomic)
LB = "__launch_bounds__(kThreads)"
NO_ATOMICS = ("    if ((s.nz >> q) & 1u) {", "    if (false) {")
INEXACT = ("const bool exact = s.len >= exact_run;", "const bool exact = false;")
SUBSTITUTED = {
    "lb3": ("own", [(LB, "__launch_bounds__(kThreads, 3)")]),
    "lb4": ("own", [(LB, "__launch_bounds__(kThreads, 4)")]),
    "lb6": ("own", [(LB, "__launch_bounds__(kThreads, 6)")]),
    "lb8": ("own", [(LB, "__launch_bounds__(kThreads, 8)")]),
    "no_atomics": ("own", [NO_ATOMICS]),
    "inexact": ("own", [INEXACT]),
    "parent_no_atomics": ("parent", [NO_ATOMICS]),
    "parent_inexact": ("parent", [INEXACT]),
}
# the dot products summed in f32 and added once to the f64 sums: what the
# f64 corner sums cost (4 conversions a point in place of 16)
F32_DOTS = ("using msda::wait_phase;\n", """using msda::wait_phase;

template <int VEC>
__device__ __forceinline__ void corner_dots_f32(
    const float4& o, const float4& v00, const float4& v01, const float4& v10,
    const float4& v11, double (&s)[4]) {
  const float* og = &o.x;
  const float* a[4] = {&v00.x, &v01.x, &v10.x, &v11.x};
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) t[q] += og[k] * a[q][k];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] += t[q];
}
""")
SUBSTITUTED["f32_dots"] = ("own", [F32_DOTS, ("corner_dots<VEC>(o0,",
                                              "corner_dots_f32<VEC>(o0,")])
# a point's three sums from its dot products in f32 (no f64 factor)
F32_SUMS = ("    point_sums(dots, vx0, vx1, uy0, uy1, mx0, mx1, my0, my1, w, x, y);",
            """    const float s0 = (float)dots[0], s1 = (float)dots[1];
    const float s2 = (float)dots[2], s3 = (float)dots[3];
    const float top = vx0 * s0 + vx1 * s1, bottom = vx0 * s2 + vx1 * s3;
    w = uy0 * top + uy1 * bottom;
    x = uy0 * (mx1 * s1 - mx0 * s0) + uy1 * (mx1 * s3 - mx0 * s2);
    y = my1 * bottom - my0 * top;""")
# no reduction over the group (every lane writes its own share)
NO_REDUCE = [("const int first_w = group_scatter(sum_w, G, c_lane);",
              "const int first_w = 0;"),
             ("const int first_xy = group_scatter(sum_xy, G, c_lane);",
              "const int first_xy = 0;")]
F32 = [F32_DOTS, ("corner_dots<VEC>(o0,", "corner_dots_f32<VEC>(o0,"),
       F32_SUMS]
# each block walks one run of consecutive tiles (tiles * b / blocks up to
# tiles * (b + 1) / blocks) in place of every gridDim-th tile: a block's next
# tile holds the next queries, whose rows its L1 may still hold
CONTIGUOUS = [("""  const int my_units =
      ((plan.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * per_tile;""",
               """  const int tile_first =
      (int)((int64_t)plan.tiles * blockIdx.x / gridDim.x);
  const int my_units =
      ((int)((int64_t)plan.tiles * (blockIdx.x + 1) / gridDim.x) -
       tile_first) * per_tile;"""),
              ("tile_id = blockIdx.x + (q / per_tile) * gridDim.x;",
               "tile_id = tile_first + q / per_tile;")]
# every corner load from the head's first pixel (L1 hits): what the corner
# rows' trips to L2 cost
NO_LOADS = [(f"load_vec<VEC>(at + o.{c})", "load_vec<VEC>(at)")
            for c in "xyzw"]
# each block walks runs of R consecutive tiles ((k * gridDim + b) * R + r):
# a block's next tile holds the next queries, while the blocks together
# stay on a window of gridDim * R tiles


def runs_of(R: int) -> list:
    return [("""  const int my_units =
      ((plan.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * per_tile;""",
             f"""  const int span = (int)gridDim.x * {R};
  const int rounds = plan.tiles / span;
  const int rest = plan.tiles - rounds * span;
  const int my_units =
      (rounds * {R} + min(max(rest - (int)blockIdx.x * {R}, 0), {R})) *
      per_tile;"""),
            ("tile_id = blockIdx.x + (q / per_tile) * gridDim.x;",
             f"tile_id = ((q / per_tile) / {R} * (int)gridDim.x + "
             f"blockIdx.x) * {R} + (q / per_tile) % {R};")]


SUBSTITUTED.update({
    "runs2": ("own", runs_of(2)),
    "runs4": ("own", runs_of(4)),
    "no_loads": ("own", NO_LOADS),
    "no_loads_no_atomics": ("own", [NO_ATOMICS, *NO_LOADS]),
    "contiguous": ("own", CONTIGUOUS),
    "no_atomics_contiguous": ("own", [NO_ATOMICS, *CONTIGUOUS]),
    "f32": ("own", F32),
    "no_atomics_f32_dots": ("own", [NO_ATOMICS, F32_DOTS,
                                    ("corner_dots<VEC>(o0,",
                                     "corner_dots_f32<VEC>(o0,")]),
    "no_atomics_f32": ("own", [NO_ATOMICS, *F32]),
    "no_atomics_no_reduce": ("own", [NO_ATOMICS, *NO_REDUCE]),
    "no_atomics_f32_no_reduce": ("own", [NO_ATOMICS, *F32, *NO_REDUCE]),
})
ABLATIONS = ("no_atomics", "inexact", "parent_no_atomics", "parent_inexact",
             "f32_dots", "f32", "no_atomics_f32_dots", "no_atomics_f32",
             "no_atomics_no_reduce", "no_atomics_f32_no_reduce",
             "no_atomics_contiguous", "no_loads", "no_loads_no_atomics")
QUICK = ("no_atomics", "no_loads", "inexact", "runs2", "runs4")
QUICK_CASES = ("encoder_model", "encoder_model_1600", "cell_800",
               "cell_1600")
SIXTEEN = tuple((64 >> (lvl % 7), 48 >> (lvl % 6)) for lvl in range(16))
# name: (shapes, B, N, H, C, P); the tile edges at C = 32 come from the plan
EDGES = {
    "encoder": (cs.SLICE_SHAPES, 2, 22223, 8, 32, 4),
    "decoder": (cs.SLICE_SHAPES, 2, 300, 8, 32, 4),
    "h1_n1": (cs.REF_SHAPES, 1, 1, 1, 32, 4),
    "c30": (cs.REF_SHAPES, 2, 1037, 8, 30, 4),
    "c160": (cs.REF_SHAPES, 2, 517, 8, 160, 4),
    "c24": (cs.REF_SHAPES, 2, 301, 8, 24, 4),
    "c6_p2": (cs.REF_SHAPES, 2, 50, 8, 6, 2),
    "c4_p3": (cs.REF_SHAPES, 2, 50, 8, 4, 3),
    "c1_p3": (cs.REF_SHAPES, 2, 50, 8, 1, 3),
    "c48_p9": (cs.REF_SHAPES, 2, 37, 8, 48, 9),
    "c64_p5": (cs.REF_SHAPES, 2, 41, 8, 64, 5),
    "c128_p3": (cs.REF_SHAPES, 2, 23, 8, 128, 3),
    "l1_p3": (((37, 41),), 2, 333, 8, 32, 3),
    "l2_p5": (cs.REF_SHAPES[:2], 2, 70, 8, 32, 5),
    "l16_p1": (SIXTEEN, 2, 129, 8, 32, 1),
    "l16_p4": (SIXTEEN, 2, 129, 8, 32, 4),
    "l16_p4_c160": (SIXTEEN, 1, 77, 4, 160, 4),
    "l4_p33_c30": (cs.REF_SHAPES, 1, 45, 4, 30, 33),
}
# name, OP_CASES entry of the shapes (None: the inputs carry them), inputs,
# launches per timing
CASES = (
    ("encoder", "encoder",
     lambda: cs.op_inputs(**cs.OP_CASES["encoder"], out_grad=True), 10),
    ("encoder_model", "encoder", lambda: ab.model_inputs(0), 10),
    ("encoder_model_1600", None,
     lambda: ab.model_inputs(0, hw=(1600, 2666)), 5),
    ("decoder_model", "decoder", lambda: ab.model_inputs(6), 100),
    ("reference_workload", "reference_workload",
     lambda: cs.op_inputs(**cs.OP_CASES["reference_workload"],
                          out_grad=True), 10),
    ("cell_800", None, lambda: cell_inputs("enc-f32-800x1333"), 10),
    ("cell_1600", None, lambda: cell_inputs("enc-f32-1600x2666"), 5),
)


def cell_inputs(traffic: str, seed: int = 2147480011) -> list:
    """One input set of the benchmark's op cell ``msda-op-ddetr.<traffic>``
    (``perfbench/inputs.py``: every pixel a query, the official offset grid
    plus jitter), with its shapes: ``[img, pts, wts, og, shapes]``."""
    import json

    from perfbench import inputs
    root = os.path.join(ab.ROOT, "perfbench")
    with open(os.path.join(root, "configs", "msda-op-ddetr.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    x = inputs.op_inputs(cfg, tr, inputs.generator(seed, cs.DEVICE, "pool",
                                                   0), cs.DEVICE)
    return [x["img"], x["pts"], x["wts"], x["og"], x["shapes"]]


def build_all(parent: str, quick: bool) -> dict:
    """{tag: CDLL} of every library above."""
    jobs, include = {}, {}
    with open(os.path.join(parent, LIB + ".cu")) as f:
        jobs[(LIB, "parent")] = f.read()
    include[(LIB, "parent")] = parent
    with open(os.path.join(_build.CSRC_DIR, LIB + ".cu")) as f:
        texts = {"own": f.read(), "parent": jobs[(LIB, "parent")]}
    dirs = {"own": str(_build.CSRC_DIR), "parent": parent}
    for tag, (source, changes) in SUBSTITUTED.items():
        if quick and tag not in QUICK:
            continue
        text = texts[source]
        for old, new in changes:
            text = sub(text, old, new)
        jobs[(LIB, tag)] = text
        include[(LIB, tag)] = dirs[source]
    for tag, name in ({} if quick else DESIGNS).items():
        d = os.path.join(ab.ROOT, "docs", "experiments", name)
        with open(os.path.join(d, LIB + ".cu")) as f:
            jobs[(LIB, tag)] = f.read()
        include[(LIB, tag)] = [d, str(_build.CSRC_DIR)]
    libs = {tag: lib for (_, tag), lib in ab.build(jobs, include).items()}
    variants = {"default": {}} if quick else VARIANTS
    _build.build([LIB] * len(variants), list(variants.values()))
    for tag, defines in variants.items():
        libs[tag] = _build.load_library(LIB, defines)
        ab.log(f"build {LIB} {tag}: " + ", ".join(
            f"{name} {regs}" for name, regs in registers(
                _build.build_log(LIB, defines))))
    return libs


def registers(log: str) -> list:
    """(kernel instance, registers and spill bytes) of each entry function
    in a ptxas log, the instance as <T,VEC,MERGE>."""
    out, name = [], None
    for line in log.splitlines():
        found = re.search(r"entry function '_Z\w*msda_bwd_kernelI(\w+)'",
                          line)
        if found:
            t = found.group(1)
            name = ("f32" if t.startswith("f") else "bf16" if "bfloat" in t
                    else "f16") + ("v4" if "Li4E" in t else "v1") + (
                "m" if "Lb1E" in t else "")
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            out.append((name, f"spill {spill.group(1)}"))
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            out.append((name, f"{found.group(1)} regs"))
            name = None
    return out


def misaligned(t):
    """A contiguous copy of ``t`` starting one element past an allocation:
    its copies go 4 bytes at a time."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def ulps(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(elements that differ, the most f32 units in the last place between
    them) of two f32 tensors."""
    a, b = got.float().view(torch.int32), want.float().view(torch.int32)
    differ = a != b
    if not differ.any():
        return 0, 0
    # distance along the f32 line (a sign change counts through zero)
    a, b = (torch.where(t < 0, torch.iinfo(torch.int32).min - t, t).long()
            for t in (a, b))
    return int(differ.sum()), int((a - b).abs().max())


def held(got, want, plain, dtype) -> tuple[bool, str]:
    """(ok, report): the point and weight gradients against the parent's
    (``want``): bitwise, or the elements that differ and by how many ulps
    (ok up to 2: the f64 sums' FMA contraction can round differently);
    img_grad within tolerance of ``plain``'s."""
    diff = [ulps(g, w) for g, w in zip(got[1:], want[1:])]
    err = cs.errors(got[0], plain[0])[2]
    ok = all(u <= 2 for _, u in diff) and err <= cs.IMG_GRAD_TOL[dtype]
    same = ("bitwise equal" if not any(n for n, _ in diff) else
            "differ in " + ", ".join(f"{n} elements by at most {u} ulp"
                                     for n, u in diff))
    return ok, (f"points/weights {same} to the parent; img_grad {err:.2e} "
                f"against plain (tol {cs.IMG_GRAD_TOL[dtype]:g})")


def check_edges(libs: dict, smi: str, dtypes) -> None:
    """The default K2 against the parent's and the plain version on
    ``EDGES``, the tile edges and misaligned points and weights."""
    probe = cs.op_inputs(cs.REF_SHAPES, B=1, N=1, H=8, C=32, P=4, seed=0,
                         out_grad=True)
    ab.swap(LIB, libs["default"])
    T = cuda_bwd.launch_plan(probe[0], cs.REF_SHAPES, *probe[1:])["tile"]
    edges = dict(EDGES)
    for n in (T - 1, T, T + 1, 2 * T + 1):
        edges[f"tile_t{n}"] = (cs.REF_SHAPES, 1, 1, n, 32, 4)
    edges["misaligned"] = (cs.REF_SHAPES, 2, 77, 8, 32, 4)
    same = failed = 0
    for seed, (name, (shapes, B, N, H, C, P)) in enumerate(edges.items()):
        img32, pts, wts, og32 = cs.op_inputs(shapes, B, N, H, C, P,
                                             seed=seed, oob=True,
                                             out_grad=True)
        if name == "misaligned":
            pts, wts = misaligned(pts), misaligned(wts)
        for dtype in dtypes:
            img, og = img32.to(dtype), og32.to(dtype)
            for mode in cs.MODES:
                outs = {}
                for tag in ("parent", "default"):
                    ab.swap(LIB, libs[tag])
                    outs[tag] = cuda_bwd.msda_bwd(img, shapes, pts, wts, og,
                                                  *mode)
                plain = native_msda_backward(img, shapes, pts, wts, og,
                                             *mode)
                ok, report = held(outs["default"], outs["parent"], plain,
                                  dtype)
                same += ok
                failed += not ok
                if not ok or mode == cs.MODES[0]:
                    ab.log(f"edges {name:12s} {str(dtype)[6:]:8s} {mode}: "
                           f"{report}")
    ab.swap(LIB, libs["default"])
    ab.log(f"edges: {same} of {same + failed} calls held (tile {T}) on "
           f"{smi}")
    if failed:
        raise AssertionError(f"{failed} edge calls differ")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="60ed581's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "bwd_designs.log"))
    ap.add_argument("--quick", action="store_true",
                    help="the default against the parent only")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    libs = build_all(args.parent, args.quick)
    check_edges(libs, smi, (torch.float32,) if args.quick else cs.TOL)
    cases = [c for c in CASES if not args.quick or c[0] in QUICK_CASES]
    for case_name, op_case, make, iters in cases:
        img32, pts, wts, og32, *carried = make()
        shapes = (cs.OP_CASES[op_case]["shapes"] if op_case else
                  carried[0] if carried else cs.model_shapes((1600, 2666)))
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)

            def call():
                return cuda_bwd.msda_bwd(img, shapes, pts, wts, og)

            ab.swap(LIB, libs["parent"])
            want = call()
            plain = native_msda_backward(img, shapes, pts, wts, og)
            for tag, lib in libs.items():
                if tag in ABLATIONS:
                    continue
                ab.swap(LIB, lib)
                ok, report = held(call(), want, plain, dtype)
                ab.log(f"designs {case_name:18s} {str(dtype)[6:]:8s} {tag}: "
                       f"{report}{'' if ok else ' FAILED'}")
            del want, plain
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
            del img, og
        del img32, pts, wts, og32
    ab.swap(LIB, libs["default"])
    ab.log(f"designs done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
