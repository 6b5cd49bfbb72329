// Multiscale deformable attention backward (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel msda_tpu/ops/pallas_bwd.py:_bwd_kernel (pallas_call
// in _pallas_bwd).  It rematerializes the forward's sampling (nothing but the
// inputs is saved) and computes the three input gradients of
//
//   out[b,n,h,:] = sum_{l,p} a[b,n,h,l,p] * sample_{l,p}[:],
//   sample[c]    = uy0 (vx0 v00[c] + vx1 v01[c]) + uy1 (vx0 v10[c] + vx1 v11[c])
//
// for each point, with g = out_grad[b,n,h,:]:
//   * weights_grad = sum_c g[c] sample[c];
//   * points_grad  = a * (xscale * sum_c g[c] dsample/ddx[c],
//                         yscale * sum_c g[c] dsample/ddy[c]), where
//     dsample/ddx = uy0 (-mx0 v00 + mx1 v01) + uy1 (-mx0 v10 + mx1 v11),
//     dsample/ddy = -my0 (vx0 v00 + vx1 v01) + my1 (vx0 v10 + vx1 v11),
//     the m's are the zeros-mode corner masks (all 1 in border mode) and
//     xscale is w - 1 with align_corners, w without (pallas_bwd.py:180-208).
//     In border mode clamped corners coincide outside the level, so the
//     derivative there is 0 with no special case;
//   * img_grad[b, corner, h, c] += a * (corner's lerp weight) * g[c].
// The geometry is msda::corner_geometry (msda_geometry.cuh), the forward
// kernel's own, so both kernels put every point on the same pixels.
//
// Design.  The Pallas kernel contracts G = E . out_grad^T on the MXU, reduces
// it with 2-sparse row factors, and accumulates img_grad in VMEM across
// sequential query blocks, because a TPU has neither gathers nor atomics.
// None of that is carried over.  This is the gather form, with K1's layout:
//   * one warp per (b, n, h), b slowest; lane = channel, in strides of 32;
//   * lane k computes the geometry of point k of each chunk of 32 points and
//     owns that point's three sums; the warp walks the chunk's points,
//     sharing each point's corners with __shfl_sync;
//   * per point, the warp loads the four corners' C channels (coalesced),
//     reduces the three channel sums with a butterfly of __shfl_xor_sync
//     (the two point-gradient sums in f64, below), and scatters its
//     img_grad contribution with atomicAdd into an f32 buffer [B, I, H, C]
//     that the wrapper zeroes first (and casts to img's type afterwards, for
//     bf16 and f16).  A corner whose weight is 0 (masked in zeros mode)
//     adds nothing and is skipped.
// The ragged end of the query axis is a bound check on the warp index.
// The order of the atomic adds changes from run to run, so img_grad differs
// in its last bits between runs.
//
// Precision.  The point gradients are sums over channels of terms as large
// as (level width) * |out_grad * img|, which cancel: at the encoder's widths
// an f32 sum keeps only about 5e-5 of the result, whatever its order.  So
// their terms and sums are computed in f64 (each product of two f32 values
// is exact in f64) and rounded once.  An H100 runs f64 at half the f32
// rate, and arithmetic does not bound this kernel; the f64 sums cost 10
// more shuffles per point.  The geometry (dx, dy) stays the f32 geometry of
// the forward, so the result is the gradient of the function K1 computes.
//
// What bounds it (planning arithmetic from the shapes, not a measurement):
// at the Deformable DETR encoder shape (B=2, N=I=22,223, H=8, C=32, L=4,
// P=4) the kernel gathers what K1 gathers (~2.9 GB of corner loads, mostly L2
// hits) and issues as many f32 atomic adds as it loads corner values
// (355,568 warps x 16 points x 4 corners x 32 lanes ~ 728 M, 22.8 M warp-wide
// reductions of 128 contiguous bytes).  Those L2 atomics and the 35 shuffles
// per point (10 to share its geometry, 25 to reduce its sums) are expected
// to bound it, not device memory.
//
// Interface: a plain C entry point (msda_bwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_bwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include "msda_geometry.cuh"

namespace {

using msda::LevelTable;
using msda::to_float;

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(MSDA_FULL_MASK, v, s);
  return v;
}

// img, og: [B, I, H, C] and [B, N, H, C] in T; pts [B, N, H, L, P, 2] and
// wts [B, N, H, L, P] in f32; img_grad [B, I, H, C] f32 (zeroed), pts_grad
// and wts_grad f32 like pts and wts.  All contiguous.
template <typename T>
__global__ void __launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)
    msda_bwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, const T* __restrict__ og,
                    float* __restrict__ img_grad,
                    float* __restrict__ pts_grad,
                    float* __restrict__ wts_grad, const LevelTable levels,
                    const int64_t num_tasks, const int I, const int N,
                    const int H, const int C, const int L, const int P,
                    const bool zeros, const bool align_corners) {
  const int lane = threadIdx.x & 31;
  // task = (b * N + n) * H + h, so b varies slowest over the grid
  const int64_t task =
      (int64_t)blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (task >= num_tasks) return;  // whole warps leave together

  const int h = (int)(task % H);
  const int64_t b = task / H / N;
  const int LP = L * P;
  const int64_t HC = (int64_t)H * C;
  const float* pt = pts + task * (int64_t)LP * 2;
  const float* wt = wts + task * (int64_t)LP;
  const T* og_row = og + task * (int64_t)C;
  const int64_t bh = b * (int64_t)I * HC + (int64_t)h * C;
  const T* img_bh = img + bh;
  float* ig_bh = img_grad + bh;
  float* pg = pts_grad + task * (int64_t)LP * 2;
  float* wg = wts_grad + task * (int64_t)LP;

  for (int k0 = 0; k0 < LP; k0 += 32) {
    // lane k computes the geometry of point k0 + k and owns its sums
    const int k = k0 + lane;
    msda::Corners g = {};
    int masks = 0;
    float a = 0.f, xscale = 0.f, yscale = 0.f;
    if (k < LP) {
      const int l = k / P;
      const int hl = levels.h[l];
      const int wl = levels.w[l];
      g = msda::corner_geometry(pt[2 * k], pt[2 * k + 1], hl, wl,
                                levels.offset[l], zeros, align_corners);
      // the four corner masks as bits: one shuffle shares them
      masks = (g.mx0 != 0.f) | (g.mx1 != 0.f) << 1 | (g.my0 != 0.f) << 2 |
              (g.my1 != 0.f) << 3;
      a = wt[k];
      xscale = (float)(align_corners ? wl - 1 : wl);
      yscale = (float)(align_corners ? hl - 1 : hl);
    }
    float sum_w = 0.f;
    double sum_x = 0.0, sum_y = 0.0;
    const int count = min(32, LP - k0);
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const bool c_ok = c < C;
      const float o = c_ok ? to_float(og_row[c]) : 0.f;
#pragma unroll 2
      for (int j = 0; j < count; ++j) {
        const int j00 = __shfl_sync(MSDA_FULL_MASK, g.i00, j);
        const int j01 = __shfl_sync(MSDA_FULL_MASK, g.i01, j);
        const int j10 = __shfl_sync(MSDA_FULL_MASK, g.i10, j);
        const int j11 = __shfl_sync(MSDA_FULL_MASK, g.i11, j);
        const float vx0 = __shfl_sync(MSDA_FULL_MASK, g.vx0, j);
        const float vx1 = __shfl_sync(MSDA_FULL_MASK, g.vx1, j);
        const float uy0 = __shfl_sync(MSDA_FULL_MASK, g.uy0, j);
        const float uy1 = __shfl_sync(MSDA_FULL_MASK, g.uy1, j);
        const int m = __shfl_sync(MSDA_FULL_MASK, masks, j);
        const float aj = __shfl_sync(MSDA_FULL_MASK, a, j);
        const float mx0 = (m & 1) ? 1.f : 0.f;
        const float mx1 = (m & 2) ? 1.f : 0.f;
        const float my0 = (m & 4) ? 1.f : 0.f;
        const float my1 = (m & 8) ? 1.f : 0.f;

        float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
        if (c_ok) {
          v00 = to_float(img_bh[(int64_t)j00 * HC + c]);
          v01 = to_float(img_bh[(int64_t)j01 * HC + c]);
          v10 = to_float(img_bh[(int64_t)j10 * HC + c]);
          v11 = to_float(img_bh[(int64_t)j11 * HC + c]);
        }
        const float top = vx0 * v00 + vx1 * v01;
        const float bottom = vx0 * v10 + vx1 * v11;
        const float sample = uy0 * top + uy1 * bottom;
        const float rw = warp_sum(o * sample);
        // the point gradients in f64: see the note at the top
        const double d00 = v00, d01 = v01, d10 = v10, d11 = v11;
        const double ddx = (double)uy0 * (mx1 * d01 - mx0 * d00) +
                           (double)uy1 * (mx1 * d11 - mx0 * d10);
        const double ddy = my1 * ((double)vx0 * d10 + (double)vx1 * d11) -
                           my0 * ((double)vx0 * d00 + (double)vx1 * d01);
        const double rx = warp_sum((double)o * ddx);
        const double ry = warp_sum((double)o * ddy);
        if (lane == j) {
          sum_w += rw;
          sum_x += rx;
          sum_y += ry;
        }

        if (c_ok) {
          const float ao = aj * o;
          const float u00 = uy0 * vx0, u01 = uy0 * vx1;
          const float u10 = uy1 * vx0, u11 = uy1 * vx1;
          // the weights are the same in every lane: no divergence
          if (u00 != 0.f) atomicAdd(ig_bh + (int64_t)j00 * HC + c, ao * u00);
          if (u01 != 0.f) atomicAdd(ig_bh + (int64_t)j01 * HC + c, ao * u01);
          if (u10 != 0.f) atomicAdd(ig_bh + (int64_t)j10 * HC + c, ao * u10);
          if (u11 != 0.f) atomicAdd(ig_bh + (int64_t)j11 * HC + c, ao * u11);
        }
      }
    }
    if (k < LP) {
      wg[k] = sum_w;
      pg[2 * k] = (float)((double)a * xscale * sum_x);
      pg[2 * k + 1] = (float)((double)a * yscale * sum_y);
    }
  }
}

template <typename T>
void launch(const void* img, const void* pts, const void* wts, const void* og,
            void* img_grad, void* pts_grad, void* wts_grad,
            const LevelTable& levels, int64_t num_tasks, int64_t blocks,
            int I, int N, int H, int C, int L, int P, bool zeros,
            bool align_corners, cudaStream_t stream) {
  msda_bwd_kernel<T><<<(unsigned int)blocks, MSDA_WARPS_PER_BLOCK * 32, 0,
                       stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<const T*>(og),
      static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
      static_cast<float*>(wts_grad), levels, num_tasks, I, N, H, C, L, P,
      zeros, align_corners);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (img and out_grad).
// level_hw: host array [L, 2] of (height, width) per level.
// img_grad must hold zeros: the kernel adds into it.
// Returns a cudaError_t: cudaSuccess (0) when the launch was accepted.
int msda_bwd_launch(int dtype, const void* img, const void* pts,
                    const void* wts, const void* og, void* img_grad,
                    void* pts_grad, void* wts_grad, const void* level_hw,
                    int B, int I, int N, int H, int C, int L, int P,
                    int zeros, int align_corners, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  LevelTable levels;
  const int64_t pixels =
      msda::fill_levels(levels, static_cast<const int*>(level_hw), L);
  if (pixels != I) return (int)cudaErrorInvalidValue;
  const int64_t num_tasks = (int64_t)B * N * H;
  if (num_tasks == 0) return (int)cudaSuccess;
  const int64_t blocks =
      (num_tasks + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool z = zeros != 0;
  const bool ac = align_corners != 0;
  switch (dtype) {
    case 0:
      launch<float>(img, pts, wts, og, img_grad, pts_grad, wts_grad, levels,
                    num_tasks, blocks, I, N, H, C, L, P, z, ac, s);
      break;
    case 1:
      launch<__half>(img, pts, wts, og, img_grad, pts_grad, wts_grad, levels,
                     num_tasks, blocks, I, N, H, C, L, P, z, ac, s);
      break;
    case 2:
      launch<__nv_bfloat16>(img, pts, wts, og, img_grad, pts_grad, wts_grad,
                            levels, num_tasks, blocks, I, N, H, C, L, P, z,
                            ac, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
