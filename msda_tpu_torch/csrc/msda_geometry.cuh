// Shared pieces of the MSDA kernels (msda_fwd.cu, msda_bwd.cu): the level
// table, the f32 <-> storage-type conversions and the bilinear geometry of one
// sampling point.
//
// Both kernels must place a point on exactly the same pixels: a point whose
// coordinate differs by one ulp lands on another pixel at a floor boundary,
// and the backward would then differentiate a different function than the
// forward computed.  So the geometry lives here, once, and follows
// grid_sample (point_geometry in msda_tpu/ops/pallas_fwd.py):
//   * unnormalize by align_corners, rounding the product and the -0.5 shift
//     separately (__fmul_rn / __fsub_rn: no FMA contraction), as the plain
//     version does;
//   * floor with floorf (coordinates can be negative);
//   * take the zeros-mode corner masks on the *unclamped* corner indices and
//     clamp the indices afterwards (border semantics = clamping).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 16
// warps a block of K1 and K2; a build may set it (-D, msda_tpu_torch.autotune)
#ifndef MSDA_WARPS_PER_BLOCK
#define MSDA_WARPS_PER_BLOCK 8
#endif
#define MSDA_FULL_MASK 0xffffffffu

namespace msda {

struct LevelTable {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int offset[MSDA_MAX_LEVELS];
};

// Fills the table from a host array [L, 2] of (height, width); returns the
// number of pixels of the pyramid.
inline int64_t fill_levels(LevelTable& levels, const int* hw, int L) {
  int64_t pixels = 0;
  for (int l = 0; l < L; ++l) {
    levels.h[l] = hw[2 * l];
    levels.w[l] = hw[2 * l + 1];
    levels.offset[l] = (int)pixels;
    pixels += (int64_t)hw[2 * l] * hw[2 * l + 1];
  }
  return pixels;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The four corners of one sampling point on its level.
struct Corners {
  int i00, i01, i10, i11;  // flat pyramid indices (row-major y, x), clamped
  int x0c, x1c, y0c, y1c;  // the clamped columns and rows of the corners
  float dx, dy;            // the point's offsets from its top-left corner
  float vx0, vx1;          // masked x lerp factors: (1 - dx, dx)
  float uy0, uy1;          // masked y lerp factors: (1 - dy, dy)
  float mx0, mx1;          // corner masks as 0/1 (all 1 in border mode)
  float my0, my1;
};

// (x, y): normalized coordinates, (0, 0) the top-left corner of the level.
__device__ __forceinline__ Corners corner_geometry(
    const float x, const float y, const int hl, const int wl, const int off,
    const bool zeros, const bool align_corners) {
  // round the product and the shift separately, as the plain version does,
  // so that floor() sees the same value (no FMA contraction)
  float xp, yp;
  if (align_corners) {
    xp = __fmul_rn(x, (float)(wl - 1));
    yp = __fmul_rn(y, (float)(hl - 1));
  } else {
    xp = __fsub_rn(__fmul_rn(x, (float)wl), 0.5f);
    yp = __fsub_rn(__fmul_rn(y, (float)hl), 0.5f);
  }
  const float x0f = floorf(xp);
  const float y0f = floorf(yp);
  const float dx = xp - x0f;
  const float dy = yp - y0f;
  // bound the floats before the integer conversion; [-2, extent + 1]
  // keeps every corner's validity as it was
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)wl + 1.f);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)hl + 1.f);
  bool bx0 = true, bx1 = true, by0 = true, by1 = true;
  if (zeros) {
    bx0 = x0 >= 0 && x0 < wl;
    bx1 = x0 + 1 >= 0 && x0 + 1 < wl;
    by0 = y0 >= 0 && y0 < hl;
    by1 = y0 + 1 >= 0 && y0 + 1 < hl;
  }
  Corners g;
  g.dx = dx;
  g.dy = dy;
  g.vx0 = bx0 ? 1.f - dx : 0.f;
  g.vx1 = bx1 ? dx : 0.f;
  g.uy0 = by0 ? 1.f - dy : 0.f;
  g.uy1 = by1 ? dy : 0.f;
  g.mx0 = bx0 ? 1.f : 0.f;
  g.mx1 = bx1 ? 1.f : 0.f;
  g.my0 = by0 ? 1.f : 0.f;
  g.my1 = by1 ? 1.f : 0.f;
  const int x0c = min(max(x0, 0), wl - 1);
  const int x1c = min(max(x0 + 1, 0), wl - 1);
  const int y0c = min(max(y0, 0), hl - 1);
  const int y1c = min(max(y0 + 1, 0), hl - 1);
  g.x0c = x0c;
  g.x1c = x1c;
  g.y0c = y0c;
  g.y1c = y1c;
  g.i00 = off + y0c * wl + x0c;
  g.i01 = off + y0c * wl + x1c;
  g.i10 = off + y1c * wl + x0c;
  g.i11 = off + y1c * wl + x1c;
  return g;
}

}  // namespace msda
