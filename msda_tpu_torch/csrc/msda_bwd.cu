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
// None of that is carried over.  This is the gather form, on lane groups
// (msda_lanes.cuh):
//   * a task is one (b, n, h); a group of G lanes owns it, VEC = 4 adjacent
//     channels per lane (G = 8 at C = 32, four tasks per warp).  Tasks are
//     numbered (b, n, h), so a warp holds heads of one query, whose
//     img_grad adds go to different rows.  (Numbered (b, h, n), as K1's
//     are, the warps in flight hold neighbouring queries of one head, whose
//     adds pile onto the same rows wherever the points cluster, as a
//     detector's do);
//   * the group loads its out_grad slice once, then walks the task's L*P
//     points; every lane computes the point's geometry itself, so nothing
//     is broadcast across lanes;
//   * per point each lane loads its channels of the four corners (one
//     16-byte load each, 8 bytes in the half types), takes the dot
//     products of out_grad with each corner over its channels (corner_dots:
//     the three sums of a point are linear in them), and adds its img_grad
//     terms with
//     one 16-byte vector atomic per corner into an f32 buffer [B, I, H, C]
//     that the wrapper zeroes first (and casts to img's type afterwards, for
//     bf16 and f16).  A corner whose weight is 0 (masked in zeros mode) adds
//     nothing and is skipped;
//   * the lane turns its four dot products into its share of the three
//     sums (point_sums), which are reduced over the group's G lanes in
//     log2 G butterfly steps, one warp instruction for all the warp's
//     tasks.
// Where C is not a multiple of 4 or img / out_grad are not aligned for the
// vector loads, the same template runs with VEC = 1 (one channel a lane).
// A channel count past G * VEC loops.  Groups past the ragged end of the
// task axis compute on the last task and write nothing, so that every lane
// takes part in the butterflies.  The order of the atomic adds changes from
// run to run, so img_grad differs in its last bits between runs.
//
// Precision.  The point gradients are sums over channels of terms as large
// as (level width) * |out_grad * img|, which cancel: at the encoder's widths
// an f32 sum keeps only about 5e-5 of the result, whatever its order.  So
// the dot products are summed in f64 (each product of two f32 values is
// exact in f64), combined in f64 and rounded once.  The geometry (dx, dy)
// stays the f32 geometry of the forward, so the result is the gradient of
// the function K1 computes.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// docs/experiments/torch_kernel_ab.py, _variants.py): at the encoder shape
// the call must move 273.1 MB in f32 and 204.8 MB in bf16, 81.5 and 61.1 us
// at 3.35 TB/s (utils.bench.msda_bound).  The kernel takes 1.34 ms in f32
// and 1.27 ms in bf16, 6% and 5% of its bounds, where the lane-per-channel
// kernel it replaces took 1.78 ms (35 shuffles per point and 4-byte
// atomics).  Without its img_grad atomics it would take 0.84 ms in f32: the
// 2.9 GB of 16-byte adds are 38% of its time (in bf16 2-12%: what else
// bounds it there is not measured).  Its f64 sums cost 1% (1.32 ms in
// f32); capping its 95-97 registers at 85 spills and costs 7%.  Merging
// the adds of a warp's coincident corners with
// __match_any_sync cost more than it saved (3.34 against 1.19 ms in the
// (b, h, n) order it needs).  On the model's own points, the order (b, n,
// h) takes 1.31 ms and (b, h, n) 1.47.
//
// Interface: a plain C entry point (msda_bwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_bwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

namespace {

using msda::add_grad;
using msda::corner_dots;
using msda::group_sum;
using msda::LevelTable;
using msda::load_vec;
using msda::point_sums;

// img, og: [B, I, H, C] and [B, N, H, C] in T; pts [B, N, H, L, P, 2] and
// wts [B, N, H, L, P] in f32; img_grad [B, I, H, C] f32 (zeroed), pts_grad
// and wts_grad f32 like pts and wts.  All contiguous.
template <typename T, int VEC>
__global__ void __launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)
    msda_bwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, const T* __restrict__ og,
                    float* __restrict__ img_grad,
                    float* __restrict__ pts_grad,
                    float* __restrict__ wts_grad, const LevelTable levels,
                    const int64_t num_tasks, const int I, const int N,
                    const int H, const int C, const int L, const int P,
                    const int G, const bool zeros, const bool align_corners) {
  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  // the warp's first task = (b * N + n) * H + h
  const int64_t first =
      ((int64_t)blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5)) *
      (32 / G);
  if (first >= num_tasks) return;  // whole warps leave together
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

  const int c0 = c_lane * VEC, step = G * VEC;
  const float4 o0 =
      c0 < C ? load_vec<VEC>(og_row + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < L; ++l) {
    const int hl = levels.h[l], wl = levels.w[l], off = levels.offset[l];
    const float xscale = (float)(align_corners ? wl - 1 : wl);
    const float yscale = (float)(align_corners ? hl - 1 : hl);
    for (int k = l * P; k < (l + 1) * P; ++k) {
      const msda::Corners g = msda::corner_geometry(
          pt[2 * k], pt[2 * k + 1], hl, wl, off, zeros, align_corners);
      const float a = wt[k];
      const T* r00 = img_bh + g.i00 * HC;
      const T* r01 = img_bh + g.i01 * HC;
      const T* r10 = img_bh + g.i10 * HC;
      const T* r11 = img_bh + g.i11 * HC;
      double dots[4] = {0.0, 0.0, 0.0, 0.0};
      for (int c = c0; c < C; c += step) {
        const float4 o = c == c0 ? o0 : load_vec<VEC>(og_row + c);
        const float4 v00 = load_vec<VEC>(r00 + c);
        const float4 v01 = load_vec<VEC>(r01 + c);
        const float4 v10 = load_vec<VEC>(r10 + c);
        const float4 v11 = load_vec<VEC>(r11 + c);
        corner_dots<VEC>(o, v00, v01, v10, v11, dots);
        if (valid) {
          const float4 ao = make_float4(a * o.x, a * o.y, a * o.z, a * o.w);
          add_grad<VEC>(ig_bh + g.i00 * HC + c, ao, g.uy0 * g.vx0);
          add_grad<VEC>(ig_bh + g.i01 * HC + c, ao, g.uy0 * g.vx1);
          add_grad<VEC>(ig_bh + g.i10 * HC + c, ao, g.uy1 * g.vx0);
          add_grad<VEC>(ig_bh + g.i11 * HC + c, ao, g.uy1 * g.vx1);
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

template <typename T, int VEC>
void launch(const void* img, const void* pts, const void* wts, const void* og,
            void* img_grad, void* pts_grad, void* wts_grad,
            const LevelTable& levels, int64_t num_tasks, int64_t blocks,
            int I, int N, int H, int C, int L, int P, int G, bool zeros,
            bool align_corners, cudaStream_t stream) {
  msda_bwd_kernel<T, VEC><<<(unsigned int)blocks, MSDA_WARPS_PER_BLOCK * 32,
                            0, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<const T*>(og),
      static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
      static_cast<float*>(wts_grad), levels, num_tasks, I, N, H, C, L, P, G,
      zeros, align_corners);
}

// VEC = 4 where C and the alignment of img and out_grad allow it.
template <typename T>
int dispatch(const void* img, const void* pts, const void* wts,
             const void* og, void* img_grad, void* pts_grad, void* wts_grad,
             const LevelTable& levels, int64_t num_tasks, int I, int N, int H,
             int C, int L, int P, bool zeros, bool align_corners,
             cudaStream_t stream) {
  const bool v4 = msda::vec4<T>(C, img) && msda::vec4<T>(C, og);
  const int G = msda::group_lanes(C, v4 ? 4 : 1);
  const int64_t per_block = (int64_t)MSDA_WARPS_PER_BLOCK * (32 / G);
  const int64_t blocks = (num_tasks + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (v4) {
    launch<T, 4>(img, pts, wts, og, img_grad, pts_grad, wts_grad, levels,
                 num_tasks, blocks, I, N, H, C, L, P, G, zeros,
                 align_corners, stream);
  } else {
    launch<T, 1>(img, pts, wts, og, img_grad, pts_grad, wts_grad, levels,
                 num_tasks, blocks, I, N, H, C, L, P, G, zeros,
                 align_corners, stream);
  }
  return (int)cudaGetLastError();
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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool z = zeros != 0;
  const bool ac = align_corners != 0;
  switch (dtype) {
    case 0:
      return dispatch<float>(img, pts, wts, og, img_grad, pts_grad, wts_grad,
                             levels, num_tasks, I, N, H, C, L, P, z, ac, s);
    case 1:
      return dispatch<__half>(img, pts, wts, og, img_grad, pts_grad,
                              wts_grad, levels, num_tasks, I, N, H, C, L, P,
                              z, ac, s);
    case 2:
      return dispatch<__nv_bfloat16>(img, pts, wts, og, img_grad, pts_grad,
                                     wts_grad, levels, num_tasks, I, N, H, C,
                                     L, P, z, ac, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
