#!/usr/bin/env python3
"""K2 with its coarse levels as tensor-core contractions
(``docs/experiments/msda_bwd_coarse.cu``) against the shipped K2 and
against de67cc6's K2, and the coarse kernel's parts ablated, on one NVIDIA
GPU: the measurements behind the negative result in
``msda_tpu_torch/csrc/msda_bwd.cu``'s note and ``PERF.md``.

    git archive de67cc6 msda_tpu_torch | tar -x -C build/ab_parent
    python3 docs/experiments/torch_bwd_coarse_ablation.py \
        --parent build/ab_parent/msda_tpu_torch/csrc

Builds, one ``nvcc`` each, all started together, and swaps in behind the
checkout's ``cuda_bwd.msda_bwd`` (``_build._LOADED``):

  * ``old``: de67cc6's K2 (``--parent``);
  * ``gather``: the checkout's K2 (``msda_tpu_torch/csrc/msda_bwd.cu``);
  * ``coarse``: ``msda_bwd_coarse.cu`` as it is (levels of at most 1,088
    pixels, with 64 adds a pixel or more, to the coarse kernel: Deformable
    DETR's levels 2 and 3; the others to its copy of de67cc6's gather
    kernel);
  * ``coarse_l3``: with ``MSDA_COARSE_PIXELS`` 300 (level 3 alone);
  * ``coarse_no_dots`` / ``_no_mma`` / ``_no_abuild``: the ``coarse``
    build without its point and weight gradients, its tensor-core
    contraction, or its A tile's entries (and so its contraction), made by
    text substitution (the results are then wrong: timing only);
  * ``gather_vec8``: ``msda_bwd_coarse.cu`` with no coarse level
    (``MSDA_COARSE_PIXELS`` 0) and the half types' gather kernel at 8
    channels a lane (one 16-byte load a corner, two 16-byte atomics), a
    kernel added by text substitution.

First the case of phase 2 where every point of each (b, h) lies at one
place on every level (``chip_smoke.bwd_case_inputs("hot_pixel")``):
img_grad's error against ``native_msda_backward`` level by level, for
``old``, ``gather`` and ``coarse``.  Then each build's time at the encoder
(uniform and the model's points), the decoder (the model's points) and the
reference workload, f32 and bf16, in turns (all builds, then in reverse):
CUDA events around the wrapper and ``torch.profiler``'s device ms a call
by kernel.  Prints one line per reading with the card's name and power
limit, written to ``--out`` (default ``build/kernel_ab/
bwd_coarse_ablation.log``).  A substitution that finds no anchor raises:
the script is tied to the sources of the commit that added it.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

import torch_kernel_ab as ab
from torch_kernel_ab import cs
from torch_kernel_variants import sub
from msda_tpu_torch.ops import _build, cuda_bwd

LIB = "msda_bwd"
COARSE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "msda_bwd_coarse.cu")

# the half types' gather kernel at 8 channels a lane
GATHER8 = r"""
__device__ __forceinline__ float4 half4(const uint32_t x, const uint32_t y,
                                        const __half*) {
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 half4(const uint32_t x, const uint32_t y,
                                        const __nv_bfloat16*) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)
    msda_bwd_gather8_kernel(const T* __restrict__ img,
                            const float* __restrict__ pts,
                            const float* __restrict__ wts,
                            const T* __restrict__ og,
                            float* __restrict__ img_grad,
                            float* __restrict__ pts_grad,
                            float* __restrict__ wts_grad,
                            const LevelTable levels, const unsigned coarse,
                            const int64_t num_tasks, const int I, const int N,
                            const int H, const int C, const int L,
                            const int P, const int G, const bool zeros,
                            const bool align_corners) {
  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  const int64_t first =
      ((int64_t)blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5)) *
      (32 / G);
  if (first >= num_tasks) return;
  const bool valid = first + group < num_tasks;
  const int64_t task = valid ? first + group : num_tasks - 1;
  const int h = (int)(task % H);
  const int64_t b = task / H / N;
  const int LP = L * P;
  const int64_t HC = (int64_t)H * C;
  const float* pt = pts + task * (int64_t)LP * 2;
  const float* wt = wts + task * (int64_t)LP;
  const T* og_row = og + task * (int64_t)C;
  const int64_t base = b * (int64_t)I * HC + (int64_t)h * C;
  const T* img_bh = img + base;
  float* ig_bh = img_grad + base;
  float* pg = pts_grad + task * (int64_t)LP * 2;
  float* wg = wts_grad + task * (int64_t)LP;
  const int c0 = c_lane * 8, step = G * 8;
  for (int l = 0; l < L; ++l) {
    if ((coarse >> l) & 1u) continue;
    const int hl = levels.h[l], wl = levels.w[l], off = levels.offset[l];
    const float xscale = (float)(align_corners ? wl - 1 : wl);
    const float yscale = (float)(align_corners ? hl - 1 : hl);
    for (int k = l * P; k < (l + 1) * P; ++k) {
      const msda::Corners g = msda::corner_geometry(
          pt[2 * k], pt[2 * k + 1], hl, wl, off, zeros, align_corners);
      const float a = wt[k];
      const int idx[4] = {g.i00, g.i01, g.i10, g.i11};
      const float lerp[4] = {g.uy0 * g.vx0, g.uy0 * g.vx1, g.uy1 * g.vx0,
                             g.uy1 * g.vx1};
      double dots[4] = {0.0, 0.0, 0.0, 0.0};
      for (int c = c0; c < C; c += step) {
        const uint4 uo = *reinterpret_cast<const uint4*>(og_row + c);
        const float4 o[2] = {half4(uo.x, uo.y, og_row), half4(uo.z, uo.w,
                                                              og_row)};
        float4 v[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 u =
              *reinterpret_cast<const uint4*>(img_bh + idx[q] * HC + c);
          v[q][0] = half4(u.x, u.y, img_bh);
          v[q][1] = half4(u.z, u.w, img_bh);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          corner_dots<4>(o[j], v[0][j], v[1][j], v[2][j], v[3][j], dots);
          if (valid) {
            const float4 ao = make_float4(a * o[j].x, a * o[j].y,
                                          a * o[j].z, a * o[j].w);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              add_grad<4>(ig_bh + idx[q] * HC + c + 4 * j, ao, lerp[q]);
            }
          }
        }
      }
      float sum_w;
      double sum_x, sum_y;
      point_sums(dots, g.vx0, g.vx1, g.uy0, g.uy1, g.mx0, g.mx1, g.my0, g.my1,
                 sum_w, sum_x, sum_y);
      sum_w = group_sum(sum_w, G);
      sum_x = group_sum(sum_x, G);
      sum_y = group_sum(sum_y, G);
      if (valid && c_lane == 0) {
        wg[k] = sum_w;
        pg[2 * k] = (float)((double)a * xscale * sum_x);
        pg[2 * k + 1] = (float)((double)a * yscale * sum_y);
      }
    }
  }
}

"""

GATHER8_LAUNCH = r"""  if (coarse != (1u << L) - 1u) {
    if constexpr (!std::is_same<T, float>::value) {
      if (C % 8 == 0 && msda::vec16<T>(img, C) && msda::vec16<T>(og, C)) {
        const int G8 = msda::group_lanes(C, 8);
        const int64_t per = (int64_t)MSDA_WARPS_PER_BLOCK * (32 / G8);
        msda_bwd_gather8_kernel<T>
            <<<(unsigned)((num_tasks + per - 1) / per),
               MSDA_WARPS_PER_BLOCK * 32, 0, stream>>>(
                static_cast<const T*>(img), static_cast<const float*>(pts),
                static_cast<const float*>(wts), static_cast<const T*>(og),
                static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
                static_cast<float*>(wts_grad), levels, coarse, num_tasks, I,
                N, H, C, L, P, G8, zeros, align_corners);
        err = (int)cudaGetLastError();
        if (err != (int)cudaSuccess || plan.count == 0) return err;
      }
    }
  }
  if (coarse != (1u << L) - 1u && err == (int)cudaSuccess) {
"""


def variants(src: str) -> dict:
    """{tag: source text} of msda_bwd_coarse.cu."""
    coarse = src
    no_dots = sub(coarse, "    for (int e = group; e < listed; e += groups)",
                  "    for (int e = group; e < 0; e += groups)")
    no_mma = sub(coarse, "          if (mt >= mt1) break;  // the whole warp",
                 "          if (true) break;  // the whole warp")
    no_abuild = sub(coarse, "          if (w[c] != 0.f && k >= 0 && "
                    "k < pixels) {\n            atomicAdd",
                    "          if (false) {\n            atomicAdd")
    gather8 = sub("#define MSDA_COARSE_PIXELS 0\n" + src, "// The host side.",
                  GATHER8 + "// The host side.")
    gather8 = sub(gather8, "  int err = (int)cudaSuccess;\n"
                  "  if (coarse != (1u << L) - 1u) {\n",
                  "  int err = (int)cudaSuccess;\n" + GATHER8_LAUNCH)
    # the 8-channel kernel ran: the 4-channel one must not run again
    gather8 = sub(gather8, "  if (coarse != (1u << L) - 1u && err == "
                  "(int)cudaSuccess) {\n    err = v4",
                  "  if (coarse != (1u << L) - 1u && err == "
                  "(int)cudaSuccess &&\n      !(!std::is_same<T, float>::"
                  "value && C % 8 == 0 &&\n        msda::vec16<T>(img, C) && "
                  "msda::vec16<T>(og, C))) {\n    err = v4")
    return {"coarse": coarse, "coarse_l3": "#define MSDA_COARSE_PIXELS 300\n"
            + src, "coarse_no_dots": no_dots, "coarse_no_mma": no_mma,
            "coarse_no_abuild": no_abuild, "gather_vec8": gather8}


CASES = (
    ("encoder", "encoder",
     lambda: cs.op_inputs(**cs.OP_CASES["encoder"], out_grad=True), 10),
    ("encoder_model", "encoder", lambda: ab.model_inputs(0), 10),
    ("decoder_model", "decoder", lambda: ab.model_inputs(6), 100),
    ("reference_workload", "reference_workload",
     lambda: cs.op_inputs(**cs.OP_CASES["reference_workload"],
                          out_grad=True), 10),
)


def hot_pixel(libs: dict, smi: str) -> None:
    """img_grad's error level by level, every point of each (b, h) at one
    place on every level."""
    shapes, img, pts, wts, og = cs.bwd_case_inputs("hot_pixel")
    want = cs.plain_msda_bwd(img, shapes, pts, wts, og)[0]
    for tag in ("old", "gather", "coarse"):
        _build._LOADED[LIB] = libs[tag]
        got = cuda_bwd.msda_bwd(img, shapes, pts, wts, og)[0]
        off = 0
        for lvl, (h, w) in enumerate(shapes):
            e = cs.errors(got[:, off:off + h * w], want[:, off:off + h * w])
            ab.log(f"hot pixel {tag:7s} f32 level {lvl} ({h}x{w}): max_abs "
                   f"{e[0]:.2e}, err {e[2]:.2e} (bar 1e-4) on {smi}")
            off += h * w


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="de67cc6's msda_tpu_torch/csrc")
    ap.add_argument("--out", default=os.path.join(
        ab.OUT_DIR, "bwd_coarse_ablation.log"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.setup()
    csrc = os.path.join(ab.ROOT, "msda_tpu_torch", "csrc")
    with open(COARSE_SOURCE) as f:
        src = f.read()
    with open(os.path.join(args.parent, LIB + ".cu")) as f:
        jobs = {(LIB, "old"): f.read()}
    include = {(LIB, "old"): args.parent}
    for tag, text in variants(src).items():
        jobs[(LIB, tag)] = text
        include[(LIB, tag)] = csrc
    libs = {tag: lib for (_, tag), lib in ab.build(jobs, include).items()}
    libs["gather"] = _build.load_library(LIB)
    hot_pixel(libs, smi)
    order = ["old", "gather", "coarse", "coarse_l3", "coarse_no_dots",
             "coarse_no_mma", "coarse_no_abuild", "gather_vec8"]
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
                ab.log(f"coarse ablation {name:18s} {str(dtype)[6:]:8s} "
                       f"{tag:16s}: events {(e1 + e2) / 2:.4f} ms ({e1:.4f},"
                       f" {e2:.4f}); device ms a call: {split} on {smi}")
            del img, og
        del img32, pts, wts, og32
    _build._LOADED[LIB] = libs["gather"]
    ab.log(f"coarse ablation done in {time.perf_counter() - t0:.1f} s")
    ab.write_log(args.out)


if __name__ == "__main__":
    main()
