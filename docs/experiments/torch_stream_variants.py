#!/usr/bin/env python3
"""Variants of the first streamed kernels K3' / K4'+K5' made by text
substitution, timed in turns on one NVIDIA GPU: the measurements behind
the redesign of the streamed kernels (``PERF.md``, "The streamed kernels
redesigned").

    git archive 3257f8a msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_stream_variants.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

It is a record tied to one version of the sources: the ``msda_stream.cu``
of commit 3257f8a (``--parent``), whose kernels stage a tile, wait for it,
and walk the samples with a warp-wide broadcast of each one's geometry.
They run behind that commit's own wrappers (the ``ops`` package beside
``--parent``, ``torch_kernel_ab.parent_module``).  On other sources a
substitution that finds no anchor raises.  For an A/B of the
current kernels against an earlier version, use ``torch_kernel_ab.py``,
whose building and timing this script uses.

The variants, each a whole library behind those wrappers:
  * ``group_geometry``: each group of G lanes loads its own sample's index,
    point and weight and computes its geometry (no ``__shfl_sync``
    broadcast);
  * ``no_staging``: the tile is never copied in (timing only, results
    wrong);
  * ``per_level``: one launch per level, each with that level's own tile as
    its shared memory, so that blocks of small tiles can share an SM;
  * ``no_out_red``: K3' without its ``out`` atomics (the sums kept in a
    register written once);
  * ``no_img_grad_red``: K4'+K5' without its ``img_grad`` atomics.
Each is timed against the parent as is (``old``), at the 256-base pyramid
(B=4, N=10,000, uniform points) and at encoder layer 0's call of the
full-width model at 1600x2666 (B=2, the model's own points), in f32 and
bf16: CUDA events around the wrapper (binning, zeroing and casts
included) and ``torch.profiler``'s device time of the kernel alone.
Writes its lines to ``--out`` (default
``build/kernel_ab/stream_variants.log``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs

# the sample loops of 3257f8a's kernels: from the per-warp preload to the
# last broadcast
FWD_LOOP_OLD = """\
    const Preload p = preload(bin, base + lane, count, pts, wts, t, lv, C,
                              zeros, align_corners);
    const msda::Corners& g = p.tc.g;
    const float w00 = p.a * g.uy0 * g.vx0, w01 = p.a * g.uy0 * g.vx1;
    const float w10 = p.a * g.uy1 * g.vx0, w11 = p.a * g.uy1 * g.vx1;
    const int chunk = min(32, count - base);
    for (int j0 = 0; j0 < chunk; j0 += per_step) {
      const int j = j0 + group;
      const int s = __shfl_sync(MSDA_FULL_MASK, p.s, j);
      const int q00 = __shfl_sync(MSDA_FULL_MASK, p.tc.j00, j);
      const int q01 = __shfl_sync(MSDA_FULL_MASK, p.tc.j01, j);
      const int q10 = __shfl_sync(MSDA_FULL_MASK, p.tc.j10, j);
      const int q11 = __shfl_sync(MSDA_FULL_MASK, p.tc.j11, j);
      const float u00 = __shfl_sync(MSDA_FULL_MASK, w00, j);
      const float u01 = __shfl_sync(MSDA_FULL_MASK, w01, j);
      const float u10 = __shfl_sync(MSDA_FULL_MASK, w10, j);
      const float u11 = __shfl_sync(MSDA_FULL_MASK, w11, j);
      if (j >= chunk) continue;
"""
FWD_LOOP_GROUP = """\
    const int chunk = min(32, count - base);
    for (int j0 = 0; j0 < chunk; j0 += per_step) {
      const int j = j0 + group;
      if (j >= chunk) continue;
      const Preload p = preload(bin, base + j, count, pts, wts, t, lv, C,
                                zeros, align_corners);
      const msda::Corners& g = p.tc.g;
      const int s = p.s;
      const int q00 = p.tc.j00, q01 = p.tc.j01, q10 = p.tc.j10,
                q11 = p.tc.j11;
      const float u00 = p.a * g.uy0 * g.vx0, u01 = p.a * g.uy0 * g.vx1;
      const float u10 = p.a * g.uy1 * g.vx0, u11 = p.a * g.uy1 * g.vx1;
"""
BWD_LOOP_OLD = """\
    const Preload p = preload(bin, base + lane, count, pts, wts, t, lv, C,
                              zeros, align_corners);
    const msda::Corners& pg = p.tc.g;
    // the four corner masks as bits: one shuffle shares them
    const int pm = (pg.mx0 != 0.f) | (pg.mx1 != 0.f) << 1 |
                   (pg.my0 != 0.f) << 2 | (pg.my1 != 0.f) << 3;
    const int chunk = min(32, count - base);
    for (int j0 = 0; j0 < chunk; j0 += per_step) {
      const int j = j0 + group;
      const bool valid = j < chunk;
      const int s = __shfl_sync(MSDA_FULL_MASK, p.s, j);
      const float a = __shfl_sync(MSDA_FULL_MASK, p.a, j);
      const int q00 = __shfl_sync(MSDA_FULL_MASK, p.tc.j00, j);
      const int q01 = __shfl_sync(MSDA_FULL_MASK, p.tc.j01, j);
      const int q10 = __shfl_sync(MSDA_FULL_MASK, p.tc.j10, j);
      const int q11 = __shfl_sync(MSDA_FULL_MASK, p.tc.j11, j);
      const int i00 = __shfl_sync(MSDA_FULL_MASK, pg.i00, j);
      const int i01 = __shfl_sync(MSDA_FULL_MASK, pg.i01, j);
      const int i10 = __shfl_sync(MSDA_FULL_MASK, pg.i10, j);
      const int i11 = __shfl_sync(MSDA_FULL_MASK, pg.i11, j);
      const float vx0 = __shfl_sync(MSDA_FULL_MASK, pg.vx0, j);
      const float vx1 = __shfl_sync(MSDA_FULL_MASK, pg.vx1, j);
      const float uy0 = __shfl_sync(MSDA_FULL_MASK, pg.uy0, j);
      const float uy1 = __shfl_sync(MSDA_FULL_MASK, pg.uy1, j);
      const int m = __shfl_sync(MSDA_FULL_MASK, pm, j);
      const float mx0 = (m & 1) ? 1.f : 0.f, mx1 = (m & 2) ? 1.f : 0.f;
      const float my0 = (m & 4) ? 1.f : 0.f, my1 = (m & 8) ? 1.f : 0.f;
"""
BWD_LOOP_GROUP = """\
    const int chunk = min(32, count - base);
    for (int j0 = 0; j0 < chunk; j0 += per_step) {
      const int j = j0 + group;
      const bool valid = j < chunk;
      // past the end: preload gives a zero sample and loads nothing
      const Preload p = preload(bin, base + j, count, pts, wts, t, lv, C,
                                zeros, align_corners);
      const msda::Corners& pg = p.tc.g;
      const int s = p.s;
      const float a = p.a;
      const int q00 = p.tc.j00, q01 = p.tc.j01, q10 = p.tc.j10,
                q11 = p.tc.j11;
      const int i00 = pg.i00, i01 = pg.i01, i10 = pg.i10, i11 = pg.i11;
      const float vx0 = pg.vx0, vx1 = pg.vx1, uy0 = pg.uy0, uy1 = pg.uy1;
      const float mx0 = pg.mx0, mx1 = pg.mx1, my0 = pg.my0, my1 = pg.my1;
"""
OUT_RED = """\
        if constexpr (VEC == 4) {
          atomicAdd(reinterpret_cast<float4*>(out_row + c), r);
        } else {
          atomicAdd(out_row + c, r.x);
        }
"""
IMG_GRAD_RED = """\
        add_grad<VEC>(grad_level + i00 * HC + c, ao, uy0 * vx0);
        add_grad<VEC>(grad_level + i01 * HC + c, ao, uy0 * vx1);
        add_grad<VEC>(grad_level + i10 * HC + c, ao, uy1 * vx0);
        add_grad<VEC>(grad_level + i11 * HC + c, ao, uy1 * vx1);
"""
LEVEL_SMEM = """\
// Shared memory of one level's tiles, in T.
template <typename T>
size_t level_smem(const Launch& g, const int l) {
  return (size_t)std::min(g.tt.yb[l] + 1, g.lv.h[l]) *
         std::min(g.tt.xb[l] + 1, g.lv.w[l]) * g.C * sizeof(T);
}

template <typename K>
cudaError_t allow_smem("""


def sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise ValueError(f"variant: {text.count(old)} matches for "
                         f"{old[:60]!r}, expected {count}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """{name: source} of the variants of 3257f8a's msda_stream.cu."""
    group = sub(sub(src, FWD_LOOP_OLD, FWD_LOOP_GROUP), BWD_LOOP_OLD,
                BWD_LOOP_GROUP)
    no_staging = sub(src, "  stage_tile(tile, img, t, lv, I, H, C, vec);\n",
                     "", count=2)
    # the level each launch serves: the other blocks leave at once
    per_level = sub(src, "const int G, const bool vec, const bool zeros,\n"
                    "                           const bool align_corners) {",
                    "const int G, const bool vec, const bool zeros,\n"
                    "                           const bool align_corners,\n"
                    "                           const int only_level) {",
                    count=2)
    per_level = sub(per_level,
                    "  const Tile t = block_tile(bin_id, H, L, lv, tt);\n",
                    "  const Tile t = block_tile(bin_id, H, L, lv, tt);\n"
                    "  if (t.l != only_level) return;\n", count=2)
    per_level = sub(per_level, "template <typename K>\ncudaError_t "
                    "allow_smem(", LEVEL_SMEM)
    for kernel in ("msda_stream_fwd_kernel", "msda_stream_bwd_kernel"):
        per_level = sub(per_level,
                        f"  {kernel}<T, VEC><<<g.blocks, STREAM_THREADS, "
                        "smem,",
                        "  for (int l = 0; l < g.L; ++l) {\n"
                        f"  {kernel}<T, VEC><<<g.blocks, STREAM_THREADS, "
                        "level_smem<T>(g, l),")
    per_level = sub(per_level, "g.zeros, g.align_corners);\n"
                    "  return (int)cudaGetLastError();",
                    "g.zeros, g.align_corners, l);\n"
                    "    const int e = (int)cudaGetLastError();\n"
                    "    if (e != 0) return e;\n  }\n  return 0;", count=2)
    no_out = sub(src, OUT_RED, "        sink += r.x + r.y + r.z + r.w;\n")
    no_out = sub(no_out, "  __syncthreads();\n\n  const int* bin = order",
                 "  __syncthreads();\n  float sink = 0.f;\n\n"
                 "  const int* bin = order")
    no_out = sub(no_out, "      }\n    }\n  }\n}\n\n// As the forward",
                 "      }\n    }\n  }\n  if (sink == 12345.f) out[0] = sink;"
                 "\n}\n\n// As the forward")
    no_grad = sub(src, IMG_GRAD_RED,
                  "        if (a == 12345.f) {\n" + IMG_GRAD_RED
                  + "        }\n")
    return {"group_geometry": group, "no_staging": no_staging,
            "per_level": per_level, "no_out_red": no_out,
            "no_img_grad_red": no_grad}


# the variants timed for each kernel (besides the parent as is)
TIMED = {
    "msda_stream_fwd": ("group_geometry", "no_staging", "per_level",
                        "no_out_red"),
    "msda_stream_bwd": ("group_geometry", "no_staging", "per_level",
                        "no_img_grad_red"),
}


def cases():
    """(name, shapes, inputs) of the two timed calls."""
    big = cs.stream_inputs(cs.BIG_SHAPES, B=4, N=10000, H=8, C=32, P=4,
                           seed=61)
    yield "big_pyramid", cs.BIG_SHAPES, big
    del big
    img, shapes, pts, wts = cs.model_call(cs.MODEL_SIZES[-1])
    rng = np.random.default_rng(8)
    og = torch.from_numpy(rng.standard_normal(
        (img.shape[0], pts.shape[1], img.shape[2], img.shape[3]),
        dtype=np.float32)).to(cs.DEVICE)
    yield "model_1600x2666", shapes, (img, pts, wts, og)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="3257f8a's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(ab.OUT_DIR,
                                                  "stream_variants.log"),
                    help="where to write the lines printed")
    ap.add_argument("--iters", type=int, default=10,
                    help="launches per timing")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    old = ab.parent_module(args.parent, "cuda_stream")
    with open(os.path.join(args.parent, "msda_stream.cu")) as f:
        src = f.read()
    jobs = {("msda_stream", v): text for v, text in variants(src).items()}
    libs = ab.build({("msda_stream", "old"): src, **jobs},
                    {key: args.parent for key in [("msda_stream", "old"),
                                                  *jobs]})
    for case, shapes, (img32, pts, wts, og32) in cases():
        for dtype in (torch.float32, torch.bfloat16):
            img, og = img32.to(dtype), og32.to(dtype)
            calls = {
                "msda_stream_fwd": lambda: old.msda_stream_fwd(
                    img, shapes, pts, wts),
                "msda_stream_bwd": lambda: old.msda_stream_bwd(
                    img, shapes, pts, wts, og)}
            for name, call in calls.items():
                names = ("old",) + TIMED[name]
                res = ab.in_turns(
                    {v: ab.timed("msda_stream", libs[("msda_stream", v)],
                                 call, old) for v in names},
                    args.iters, name + "_kernel")
                ab.log_turns(f"{name} {case} {str(dtype)[6:]}", res, smi)
            del img, og
        del img32, pts, wts, og32
    ab.log(f"stream variants done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
