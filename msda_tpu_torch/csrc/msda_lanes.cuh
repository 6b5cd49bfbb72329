// The lane-group pieces that every MSDA kernel shares (msda_fwd.cu,
// msda_bwd.cu, msda_stream.cu).
//
// A sampling task's C channels are served by a group of G lanes, VEC = 4
// adjacent channels per lane (or 1 where C or the alignment does not allow
// 4), so a warp serves 32 / G tasks at once: G = 8 and four tasks per warp
// at Deformable DETR's C = 32.  A lane loads its channels of a pixel row
// with one 16-byte load (8 bytes for the half types), adds them into an f32
// buffer with one 16-byte vector atomic (sm_90's atomicAdd(float4*)), and a
// sum over the task's channels takes log2(G) butterfly steps inside the
// group.

#pragma once

#include <cstdint>

#include "msda_geometry.cuh"

namespace msda {

// Four channels as floats (p 16-byte aligned for float, 8-byte for the half
// types).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four channels rounded once to T (alignment as load4).
__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__half* p, const float4 v) {
  const __half2 a = __floats2half2_rn(v.x, v.y);
  const __half2 b = __floats2half2_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a),
                 *reinterpret_cast<const unsigned*>(&b));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a),
                 *reinterpret_cast<const unsigned*>(&b));
}

// One lane's share of a pixel row: VEC = 4 adjacent channels or 1 (in .x).
template <int VEC, typename T>
__device__ __forceinline__ float4 load_vec(const T* p) {
  if constexpr (VEC == 4) {
    return load4(p);
  } else {
    return make_float4(to_float(*p), 0.f, 0.f, 0.f);
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const float4 v) {
  if constexpr (VEC == 4) {
    store4(p, v);
  } else {
    *p = from_float<T>(v.x);
  }
}

// Sum over the G lanes of a group (G a power of two; every lane of the warp
// calls it).
template <typename F>
__device__ __forceinline__ F group_sum(F v, const int G) {
  for (int s = G >> 1; s > 0; s >>= 1) {
    v += __shfl_xor_sync(MSDA_FULL_MASK, v, s);
  }
  return v;
}

// The backward's four corner dot products over one lane's VEC channels,
// s[ij] += o . v_ij with o = out_grad, in f64 (each product of two f32
// values is exact in f64, so the sums are exact but for their last bits).
// The three channel sums of a point, o . sample and o . dsample/ddx, ddy
// (msda_bwd.cu has the formulas), are linear in them (point_sums), so a
// point costs 4 multiply-adds a channel.
template <int VEC>
__device__ __forceinline__ void corner_dots(const float4& o,
                                            const float4& v00,
                                            const float4& v01,
                                            const float4& v10,
                                            const float4& v11,
                                            double (&s)[4]) {
  const float* og = &o.x;
  const float* a00 = &v00.x;
  const float* a01 = &v01.x;
  const float* a10 = &v10.x;
  const float* a11 = &v11.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const double ok = og[k];
    s[0] += ok * a00[k];
    s[1] += ok * a01[k];
    s[2] += ok * a10[k];
    s[3] += ok * a11[k];
  }
}

// The three sums of a point from its corner dot products (summed over the
// point's channels): with top = vx0 s00 + vx1 s01 and
// bottom = vx0 s10 + vx1 s11,
//   sum_w = uy0 top + uy1 bottom,
//   sum_x = uy0 (mx1 s01 - mx0 s00) + uy1 (mx1 s11 - mx0 s10),
//   sum_y = my1 bottom - my0 top,
// in f64 on the f32 geometry, where the cancellation between corners that
// an f32 sum could not hold (msda_bwd.cu "Precision") is exact.
__device__ __forceinline__ void point_sums(
    const double (&s)[4], const double vx0, const double vx1,
    const double uy0, const double uy1, const double mx0, const double mx1,
    const double my0, const double my1, float& sum_w, double& sum_x,
    double& sum_y) {
  const double top = vx0 * s[0] + vx1 * s[1];
  const double bottom = vx0 * s[2] + vx1 * s[3];
  sum_w = (float)(uy0 * top + uy1 * bottom);
  sum_x = uy0 * (mx1 * s[1] - mx0 * s[0]) + uy1 * (mx1 * s[3] - mx0 * s[2]);
  sum_y = my1 * bottom - my0 * top;
}

// Adds w * ao to VEC channels of an f32 buffer (one 16-byte vector atomic
// for 4).
template <int VEC>
__device__ __forceinline__ void add_grad(float* p, const float4& ao,
                                         const float w) {
  if (w == 0.f) return;  // a corner masked in zeros mode adds nothing
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(w * ao.x, w * ao.y, w * ao.z, w * ao.w));
  } else {
    atomicAdd(p, w * ao.x);
  }
}

// Lanes per task: the task's C / vec steps rounded up to a power of two, at
// most a warp.
inline int group_lanes(int C, int vec) {
  int g = 1;
  while (g * vec < C && g < 32) g <<= 1;
  return g;
}

// Four channels a lane where C allows it and p's pixel rows are aligned for
// load4 (16 bytes in f32, 8 in the half types).
template <typename T>
inline bool vec4(int C, const void* p) {
  return C % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// 16-byte copies of whole pixel rows (the streamed kernels' staging): a
// pixel's channels are whole 16-byte pieces and img is 16-byte aligned.
template <typename T>
inline bool vec16(const void* img, int C) {
  return (C * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(img) % 16 == 0;
}

}  // namespace msda
