#!/usr/bin/env python3
"""Variants of K1 / K2 made by text substitution, timed in turns against the
kernels they are made from, on one NVIDIA GPU: the experiments behind the
design of the lane-group K1 / K2 (``PERF.md``, "K2 and K1 redesigned as
lane-group kernels").

    git archive d35e2b3 msda_tpu_torch/csrc | tar -x -C build/ab_parent
    python3 docs/experiments/torch_kernel_variants.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

It is a record tied to two versions of the sources: the lane-per-channel
kernels of commit d35e2b3 (``--parent``) and the lane-group kernels of the
commit that added this script (the checkout's).  Run it on a checkout of
that commit; on other sources a substitution that finds no anchor raises.
For an A/B of the current kernels against any earlier version, use
``torch_kernel_ab.py``, whose building and timing this script uses.

The variants, at Deformable DETR's encoder shape in f32 and bf16:
  * of d35e2b3's kernels, on uniform points: K2 without its img_grad
    atomics (the values kept live in a register written once), with its f64
    sums in f32, without its three 32-lane butterflies, and with all three
    removed; K1 with every corner forced onto one pixel;
  * of the lane-group kernels, on uniform points and on the model's own:
    K2 without its img_grad atomics (the ceiling of any scheme that merges
    adds), with its f64 sums in f32, with at most 85 registers (3 blocks an
    SM), with its tasks numbered (b, h, n), so numbered with the coincident
    adds of a warp merged (``ADD_CORNER``), and with three sums a channel
    (``BWD_SUMS``) in place of the four corner dot products; K1 with every
    corner on one pixel, with its tasks numbered (b, n, h), and with its
    point loop unrolled by 2.
For each kind of points it also prints the mean number of img_grad adds per
point, before and after merging the coincident corners of 4 neighbouring
queries of a head.  Writes its lines to ``--out`` (default
``build/kernel_ab/kernel_variants.log``).
"""

from __future__ import annotations

import argparse
import os
import re
import time

import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs
from msda_tpu_torch.ops import _build
from msda_tpu_torch.ops.reference import _geometry


def sub(text: str, old: str, new: str, regex: bool = False) -> str:
    out, n = (re.subn(old, new, text) if regex
              else (text.replace(old, new), text.count(old)))
    if n == 0:
        raise ValueError(f"variant: no match for {old!r}")
    return out


def ablations_of_parent(k1: str, k2: str) -> dict:
    """The ablations of d35e2b3's lane-per-channel kernels."""
    butterfly = ("#pragma unroll\n  for (int s = 16; s > 0; s >>= 1) "
                 "v += __shfl_xor_sync(MSDA_FULL_MASK, v, s);\n")
    sink = sub(k2, "  const int lane = threadIdx.x & 31;\n",
               "  const int lane = threadIdx.x & 31;\n  float sink = 0.f;\n")
    sink = sub(sink, r"atomicAdd\(ig_bh \+ \(int64_t\)j(\d\d) \* HC \+ c, "
               r"ao \* u(\d\d)\)", r"sink += ao * u\2", regex=True)
    sink = sub(sink, "      pg[2 * k + 1] = (float)((double)a * yscale * "
               "sum_y);\n    }\n  }\n}",
               "      pg[2 * k + 1] = (float)((double)a * yscale * sum_y);"
               "\n    }\n  }\n  atomicAdd(ig_bh + lane % C, sink);\n}")
    one = sub(k1, "  const int lane = threadIdx.x & 31;\n",
              "  const int lane = threadIdx.x & 31;\n"
              "  const int keep = I == 2147483647 ? 1 : 0;  // 0 at run "
              "time\n")
    for c in ("00", "01", "10", "11"):
        one = sub(one, f"        i{c} = g.i{c};\n",
                  f"        i{c} = g.i{c} * keep;\n")
    return {
        "msda_bwd": {
            "old_no_atomics": sink,
            "old_f32_sums": k2.replace("double", "float"),
            "old_no_butterflies": sub(k2, butterfly, ""),
            "old_loads_and_broadcasts_only": sub(
                sink.replace("double", "float"), butterfly, ""),
        },
        "msda_fwd": {"old_one_pixel": one},
    }


# K1 numbers its tasks (b, h, n), K2 (b, n, h); a variant swaps them
BHN = ("  const int64_t bh = t / N;  // b * H + h\n"
       "  const int h = (int)(bh % H);\n"
       "  const int64_t b = bh / H;\n"
       "  const int64_t task = (b * N + (t - bh * N)) * H + h;  // (b, n, h) "
       "row\n")
BNH = ("  const int h = (int)(t % H);\n"
       "  const int64_t b = t / H / N;\n"
       "  const int64_t task = t;\n")
K2_BNH = ("  const int64_t task = valid ? first + group : num_tasks - 1;\n"
          "  const int h = (int)(task % H);\n"
          "  const int64_t b = task / H / N;\n")
K2_BHN = "  const int64_t t = valid ? first + group : num_tasks - 1;\n" + BHN

# Merged img_grad adds: lanes of a warp that add to the same address (found
# with a 64-bit __match_any_sync) are summed with shuffles, and the lowest
# adds once.  Every lane must reach it: valid where C = G * 4 only.
ADD_CORNER = """
__device__ __forceinline__ float4 shfl4(const float4 v, const int src) {
  return make_float4(__shfl_sync(MSDA_FULL_MASK, v.x, src),
                     __shfl_sync(MSDA_FULL_MASK, v.y, src),
                     __shfl_sync(MSDA_FULL_MASK, v.z, src),
                     __shfl_sync(MSDA_FULL_MASK, v.w, src));
}

template <int VEC>
__device__ __forceinline__ void add_corner(float* p, const float4& ao,
                                           const float w, const bool on,
                                           const int lane, const int c_lane,
                                           const int G) {
  const int per_warp = 32 / G;
  const bool adds = on && w != 0.f;
  const unsigned long long key =
      adds ? (unsigned long long)reinterpret_cast<uintptr_t>(p)
           : ~0ull - lane;
  const unsigned peers = __match_any_sync(MSDA_FULL_MASK, key);
  if (per_warp > 1 && __any_sync(MSDA_FULL_MASK, peers != 1u << lane)) {
    const float4 v = adds ? make_float4(w * ao.x, w * ao.y, w * ao.z,
                                        w * ao.w)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const int group = lane / G;
    float4 sum = v;
    for (int d = 1; d < per_warp; ++d) {
      const int from = group + d < per_warp ? group + d : group + d - per_warp;
      const int src = from * G + c_lane;
      const float4 u = shfl4(v, src);
      if ((peers >> src) & 1u) {
        sum.x += u.x; sum.y += u.y; sum.z += u.z; sum.w += u.w;
      }
    }
    if (adds && (peers & ((1u << lane) - 1u)) == 0) {
      atomicAdd(reinterpret_cast<float4*>(p), sum);
    }
    return;
  }
  if (on) add_grad<VEC>(p, ao, w);
}

"""


def merged_adds(k2: str) -> str:
    k2 = sub(k2, "// img, og: [B, I, H, C] and [B, N, H, C] in T;",
             ADD_CORNER + "// img, og: [B, I, H, C] and [B, N, H, C] in T;")
    k2 = sub(k2, "        if (valid) {\n          const float4 ao",
             "        {\n          const float4 ao")
    return sub(k2, r"add_grad<VEC>\((ig_bh \+ g\.i\d\d \* HC \+ c), ao, "
               r"(g\.uy\d \* g\.vx\d)\);",
               r"add_corner<VEC>(\1, ao, \2, valid, lane, c_lane, G);",
               regex=True)


# Three sums a channel, the two point-gradient ones with f64 terms: the
# lane-group K2's form before the four corner dot products.
BWD_SUMS = """
template <int VEC>
__device__ __forceinline__ void bwd_sums(
    const float4& o, const float4& v00, const float4& v01, const float4& v10,
    const float4& v11, const float vx0, const float vx1, const float uy0,
    const float uy1, const float mx0, const float mx1, const float my0,
    const float my1, float& sum_w, double& sum_x, double& sum_y) {
  const float* og = &o.x;
  const float* a00 = &v00.x;
  const float* a01 = &v01.x;
  const float* a10 = &v10.x;
  const float* a11 = &v11.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sum_w += og[k] * (uy0 * (vx0 * a00[k] + vx1 * a01[k]) +
                      uy1 * (vx0 * a10[k] + vx1 * a11[k]));
    const double d00 = a00[k], d01 = a01[k], d10 = a10[k], d11 = a11[k];
    sum_x += (double)og[k] * ((double)uy0 * (mx1 * d01 - mx0 * d00) +
                              (double)uy1 * (mx1 * d11 - mx0 * d10));
    sum_y += (double)og[k] * (my1 * ((double)vx0 * d10 + (double)vx1 * d11) -
                              my0 * ((double)vx0 * d00 + (double)vx1 * d01));
  }
}
"""


def pointwise_sums(k2: str) -> str:
    k2 = sub(k2, '#include "msda_lanes.cuh"\n',
             '#include "msda_lanes.cuh"\n\nnamespace msda {' + BWD_SUMS
             + "}  // namespace msda\n")
    k2 = sub(k2, "      double dots[4] = {0.0, 0.0, 0.0, 0.0};\n",
             "      float sum_w = 0.f;\n"
             "      double sum_x = 0.0, sum_y = 0.0;\n")
    k2 = sub(k2, "        corner_dots<VEC>(o, v00, v01, v10, v11, dots);\n",
             "        msda::bwd_sums<VEC>(o, v00, v01, v10, v11, g.vx0, "
             "g.vx1, g.uy0, g.uy1, g.mx0, g.mx1, g.my0, g.my1, sum_w, "
             "sum_x, sum_y);\n")
    return sub(k2, "      float sum_w;\n      double sum_x, sum_y;\n"
               "      point_sums(dots, g.vx0, g.vx1, g.uy0, g.uy1, g.mx0, "
               "g.mx1, g.my0, g.my1,\n"
               "                 sum_w, sum_x, sum_y);\n",
               "")


def variants_of_current(k1: str, k2: str, lanes: str) -> dict:
    """Variants of the lane-group kernels (``lanes``: msda_lanes.cuh)."""
    # the header inlined with its f64 sums in f32
    f32 = sub(k2, '#include "msda_lanes.cuh"\n',
              lanes.replace("#pragma once\n", "").replace("double", "float"))
    one = sub(k1, "  const int lane = threadIdx.x & 31;\n",
              "  const int lane = threadIdx.x & 31;\n"
              "  const int keep = I == 2147483647 ? 1 : 0;  // 0 at run "
              "time\n")
    one = sub(one, r"g\.i(\d\d) \* HC", r"g.i\1 * keep * HC", regex=True)
    bounds = "__launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)"
    k2_bhn = sub(k2, K2_BNH, K2_BHN)
    return {
        "msda_bwd": {
            "new_order_bhn": k2_bhn,
            "new_order_bhn_merged_adds": merged_adds(k2_bhn),
            "new_no_atomics": sub(k2, "        if (valid) {\n",
                                  "        if (valid && a == 12345.f) {\n"),
            "new_f32_sums": f32.replace("double", "float"),
            "new_min_blocks_3": sub(k2, bounds, bounds[:-1] + ", 3)"),
            "new_pointwise_sums": pointwise_sums(k2),
        },
        "msda_fwd": {
            "new_one_pixel": one,
            "new_order_bnh": sub(k1, BHN, BNH),
            "new_unroll_2": sub(k1, "#pragma unroll 4", "#pragma unroll 2"),
        },
    }


def adds_per_point(shapes, pts, wts, per_warp=4):
    """Mean img_grad adds per sampling point (corners of non-zero weight),
    and after merging the coincident corners of the ``per_warp``
    neighbouring queries of one head that a warp serves (border mode,
    align_corners=False)."""
    corners, dx, dy, _ = _geometry(shapes, pts, "border", False, pts.device)
    dx, dy = dx[..., 0], dy[..., 0]
    B, N, H, L, P = corners[0].shape
    I = sum(h * w for h, w in shapes)  # noqa: E741
    bh = (torch.arange(B, device=pts.device).view(B, 1, 1, 1, 1) * H
          + torch.arange(H, device=pts.device).view(1, 1, H, 1, 1))
    before = after = 0
    for idx, w in zip(corners, ((1 - dy) * (1 - dx), (1 - dy) * dx,
                                dy * (1 - dx), dy * dx)):
        adds = (w * wts) != 0
        key = torch.where(adds, bh * I + idx, torch.full_like(idx, -1))
        key = key.permute(0, 2, 1, 3, 4).reshape(B * H * N, L * P)
        pad = -key.shape[0] % per_warp
        key = torch.cat([key, key.new_full((pad, L * P), -1)])
        key = key.view(-1, per_warp, L * P)
        # unique negatives for the corners that add nothing
        slot = torch.arange(per_warp, device=pts.device).view(1, -1, 1)
        key = torch.where(key < 0, -2 - slot, key)
        srt = key.sort(dim=1).values
        new = torch.ones_like(srt, dtype=torch.bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        before += int(adds.sum())
        after += int((new & (srt >= 0)).sum())
    return before / pts[..., 0].numel(), after / pts[..., 0].numel()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="d35e2b3's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "kernel_variants.log"),
                    help="where to write the lines printed")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    src = {}
    for where, d in (("old", args.parent), ("new", str(_build.CSRC_DIR))):
        for lib in ("msda_fwd", "msda_bwd"):
            with open(os.path.join(d, lib + ".cu")) as f:
                src[(lib, where)] = f.read()
    with open(os.path.join(_build.CSRC_DIR, "msda_lanes.cuh")) as f:
        lanes = f.read()
    jobs, include = {}, {}
    for group, where in (
            (ablations_of_parent(src[("msda_fwd", "old")],
                                 src[("msda_bwd", "old")]), args.parent),
            (variants_of_current(src[("msda_fwd", "new")],
                                 src[("msda_bwd", "new")], lanes),
             str(_build.CSRC_DIR))):
        for lib, variants in group.items():
            for v, text in variants.items():
                jobs[(lib, v)], include[(lib, v)] = text, where
    libs = ab.build_with_parent(args.parent, jobs, include)

    enc = ab.CASES[:2]  # the encoder, uniform and the model's own points
    for case_name, op_case, make, iters in enc:
        img32, pts, wts, og32 = make()
        shapes = cs.OP_CASES[op_case]["shapes"]
        before, after = adds_per_point(shapes, pts, wts)
        ab.log(f"variants {case_name}: img_grad adds per point "
               f"{before:.4f}, {after:.4f} after merging the corners of 4 "
               f"neighbouring queries of a head")
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            for lib, call in ab.op_calls(shapes, img, pts, wts, og):
                names = ["old", "new"] + sorted(
                    v for (k, v) in libs if k == lib
                    and v not in ("old", "new")
                    and (case_name == "encoder" or v.startswith("new_")))
                res = ab.in_turns({v: ab.timed(lib, libs[(lib, v)], call)
                                   for v in names}, iters,
                                  ab.KERNEL_SYMBOL[lib])
                ab.log_turns(f"{lib} {case_name} {str(dtype)[6:]}", res, smi)
                ab.swap(lib, libs[(lib, "new")])
        del img32, pts, wts, og32
    ab.log(f"kernel variants done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
