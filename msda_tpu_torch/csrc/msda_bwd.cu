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
// This is the gather form, on lane groups (msda_lanes.cuh):
//   * a task is one (b, n, h); a group of G lanes owns it, VEC = 4 adjacent
//     channels per lane (G = 8 at C = 32, four tasks per warp).  Tasks are
//     numbered (b, n, h), so a warp holds heads of one query, whose
//     img_grad adds go to different rows.  (Numbered (b, h, n), as K1's
//     are, the warps in flight hold neighbouring queries of one head, whose
//     adds pile onto the same rows wherever the points cluster, as a
//     detector's do);
//   * the group loads its out_grad slice once, then walks the task's L*P
//     points level by level; every lane computes the point's geometry
//     itself, so nothing is broadcast across lanes;
//   * per point each lane loads its channels of the four corners (one
//     16-byte load each, 8 bytes in the half types) and takes the dot
//     products of out_grad with each corner over its channels (corner_dots:
//     the three sums of a point are linear in them);
//   * the img_grad terms a * (corner's lerp weight) * out_grad of a level's
//     consecutive points on the same four pixels are summed in registers
//     (a Pending set), and each such run is added once a corner with a
//     16-byte vector atomic into an f32 buffer [2, B, I, H, C] that the
//     wrapper zeroes first.  Where all P points of a query's level fall on
//     the same pixels, their run is added exactly: the atomic returns the
//     value it added to, so the rounding error of the sum it stored is
//     known (two-sum) and goes, with a second atomic, into the buffer's
//     second half; the wrapper adds the halves (and casts the sum to img's
//     type).  A corner whose weight is 0 (masked in zeros mode) adds
//     nothing;
//   * the lane turns its four dot products into its share of the three
//     sums (point_sums), which are reduced over the group's G lanes in
//     log2 G butterfly steps, one warp instruction for all the warp's
//     tasks.
// Where C is not a multiple of 4 or img / out_grad are not aligned for the
// vector loads, the same template runs with VEC = 1 (one channel a lane).
// A channel count past G * VEC loops over channel steps, and then every
// point adds its own terms (MERGE false: a Pending set a step would cost
// registers for a case no model here has).  Groups past the ragged end of
// the task axis compute on the last task and write nothing, so that every
// lane takes part in the butterflies.  The order of the atomic adds changes
// from run to run, so img_grad differs in its last bits between runs.
//
// Precision.  The point gradients are sums over channels of terms as large
// as (level width) * |out_grad * img|, which cancel: at the encoder's widths
// an f32 sum keeps only about 5e-5 of the result, whatever its order.  So
// the dot products are summed in f64 (each product of two f32 values is
// exact in f64), combined in f64 and rounded once.  The geometry (dx, dy)
// stays the f32 geometry of the forward, so the result is the gradient of
// the function K1 computes.  img_grad: where many points share a pixel,
// one f32 atomic a point drifts.  With every point of a (b, h) at one
// place (the encoder's 22,223 queries of 4 points a level: 88,892 adds a
// corner), de67cc6's kernel read 2.4e-4 to 3.4e-4 of max(1, |ref|) in
// f32, past the 1e-4 bar, and merging alone (each query's run in one
// plain atomic) up to 2.5e-4; with the exact adds it reads 2.1e-6 to
// 2.7e-6 by mode, the same in every call (docs/experiments/
// torch_bwd_merge.py --spread, 100 calls a mode).
//
// How it got here (NVIDIA H100 80GB HBM3, 700.00 W, CUDA events and the
// profiler's device time; docs/experiments/).  de67cc6's kernel at the
// encoder shape (levels 100x167, 50x84, 25x42, 13x21, batch 2, 8 heads)
// on the model's own points took 1.2966 ms in f32, 0.7720 without any
// img_grad atomic, 0.8819 without those of levels 2-3 alone (6% of the
// pixels, about 1,300 and 340 adds a pixel row); each of those levels
// alone took 0.5184 and 0.3932 with its adds, 0.2281 and 0.2290 without
// (torch_bwd_breakdown.py).  The TPU kernel's dense form for those levels
// (a coarse kernel: staged rows, A^T . out_grad on the tensor cores with
// mma.sync, no per-point atomics) measured slower at every shape: 3.3332
// against 1.3521 ms a call in f32 at the encoder, 2.3059 against 1.3169
// on the model's points; its source is docs/experiments/msda_bwd_coarse.cu
// (torch_bwd_coarse_ablation.py, with its parts ablated).  So the gather
// form stays, and merging attacks the adds where they pile up: on the
// model's points, consecutive points of a query share a level's cell
// often on the small levels.  Walking several queries of a head per group
// (merging across them) was slower on uniform points and not clearly
// faster on the model's; 16-byte half-type loads (8 channels a lane) were
// slower too.
//
// What bounds it (same card; torch_kernel_ab.py --parent, the device time
// of the kernel, and torch_bwd_merge.py, chip_smoke.py phase 6): at the
// encoder shape the call must move 273.1 MB in f32 and 204.8 MB in bf16,
// 81.5 and 61.1 us at 3.35 TB/s (utils.bench.msda_bound).  On the model's
// points the kernel takes 1.2034 ms in f32 and 1.1129 in bf16 (de67cc6's
// 1.2693 and 1.2742), on uniform points 1.3271 and 1.1902 (1.3142 and
// 1.2087): on uniform points 6% of the bound.  Zeroing both halves and
// adding them take 0.0655 ms of device time a call in f32 (phase 6), about
// 0.05 more than one half's zeroing.  The half types' merging instances
// are held to three blocks an SM (80 registers, no spills; without the
// bound bf16 took 1.2059 on the model's points), f32's is not (108
// registers; held to 80 it spilled and took 1.2139 and 1.3749); the others
// take 64 to 120 registers, no spills.  The f64 sums cost 1%; the atomics
// are still the largest part, and every point still reads its four corner
// rows from L2.
//
// Interface: a plain C entry point (msda_bwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_bwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <type_traits>

#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

namespace {

using msda::corner_dots;
using msda::group_sum;
using msda::LevelTable;
using msda::load_vec;
using msda::point_sums;

// Warps an SM that the half types' merging kernels ask for in their launch
// bounds (three blocks of 8 warps: at most 80 registers a thread; f32's
// spilled there and ran slower).
constexpr int kMergeWarpsPerSM = 24;

// The img_grad terms of a corner set that the task has not added yet,
// summed in registers while consecutive points of a level fall on the same
// four pixels: idx[0] and idx[3] (the top-left and bottom-right corners) fix
// the set, nz marks the corners with a nonzero lerp weight, len counts the
// run's points.  A run of all P points of a query's level is added with
// its rounding error kept (add_exact): there every point shares the pixels.
struct Pending {
  int idx[4] = {-1, -1, -1, -1};
  float4 acc[4] = {};
  unsigned nz = 0;
  int len = 0;
};

// a + b - fl(a + b), exactly (Knuth's two-sum).
__device__ __forceinline__ float add_error(const float a, const float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// *p += v as one atomic, and the add's rounding error atomically into
// p[lo]: the atomic returns the value it added to, so the error of the
// f32 sum it stored is known exactly.
template <int VEC>
__device__ __forceinline__ void add_exact(float* p, const int64_t lo,
                                          const float4& v) {
  if constexpr (VEC == 4) {
    const float4 old = atomicAdd(reinterpret_cast<float4*>(p), v);
    const float4 e =
        make_float4(add_error(old.x, v.x), add_error(old.y, v.y),
                    add_error(old.z, v.z), add_error(old.w, v.w));
    if (e.x != 0.f || e.y != 0.f || e.z != 0.f || e.w != 0.f) {
      atomicAdd(reinterpret_cast<float4*>(p + lo), e);
    }
  } else {
    const float e = add_error(atomicAdd(p, v.x), v.x);
    if (e != 0.f) atomicAdd(p + lo, e);
  }
}

// Adds the pending terms of this lane's channels (c) to img_grad, one
// vector atomic a corner (a run of exact_run points with its error kept),
// and empties the set.
template <int VEC>
__device__ __forceinline__ void flush(Pending& s, float* ig_bh,
                                      const int64_t lo, const int64_t HC,
                                      const int c, const int exact_run) {
  const bool exact = s.len >= exact_run;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if ((s.nz >> q) & 1u) {
      float* p = ig_bh + s.idx[q] * HC + c;
      if (exact) {
        add_exact<VEC>(p, lo, s.acc[q]);
      } else if constexpr (VEC == 4) {
        atomicAdd(reinterpret_cast<float4*>(p), s.acc[q]);
      } else {
        atomicAdd(p, s.acc[q].x);
      }
    }
    s.acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  s.nz = 0;
  s.len = 0;
}

// img, og: [B, I, H, C] and [B, N, H, C] in T; pts [B, N, H, L, P, 2] and
// wts [B, N, H, L, P] in f32; img_grad [2, B, I, H, C] f32 (zeroed: the
// sums, then at img_grad + lo the rounding errors of the exact adds),
// pts_grad and wts_grad f32 like pts and wts.  All contiguous.  With MERGE
// (the task's channels in one step of the group's lanes) the img_grad
// terms of a level's points go through a Pending set.
template <typename T, int VEC, bool MERGE>
__global__ void __launch_bounds__(
    MSDA_WARPS_PER_BLOCK * 32,
    MERGE && !std::is_same<T, float>::value
        ? kMergeWarpsPerSM / MSDA_WARPS_PER_BLOCK
        : 1)
    msda_bwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, const T* __restrict__ og,
                    float* __restrict__ img_grad,
                    float* __restrict__ pts_grad,
                    float* __restrict__ wts_grad, const LevelTable levels,
                    const int64_t lo, const int64_t num_tasks, const int I,
                    const int N, const int H, const int C, const int L,
                    const int P, const int G, const bool zeros,
                    const bool align_corners) {
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
    Pending pend;
    for (int k = l * P; k < (l + 1) * P; ++k) {
      const msda::Corners g = msda::corner_geometry(
          pt[2 * k], pt[2 * k + 1], hl, wl, off, zeros, align_corners);
      const float a = wt[k];
      const int idx[4] = {g.i00, g.i01, g.i10, g.i11};
      const float lerp[4] = {g.uy0 * g.vx0, g.uy0 * g.vx1, g.uy1 * g.vx0,
                             g.uy1 * g.vx1};
      double dots[4] = {0.0, 0.0, 0.0, 0.0};
      if constexpr (MERGE) {  // one channel step: c0 < C or nothing
        if (c0 < C) {
          corner_dots<VEC>(o0, load_vec<VEC>(img_bh + idx[0] * HC + c0),
                           load_vec<VEC>(img_bh + idx[1] * HC + c0),
                           load_vec<VEC>(img_bh + idx[2] * HC + c0),
                           load_vec<VEC>(img_bh + idx[3] * HC + c0), dots);
          if (valid) {
            if (idx[0] != pend.idx[0] || idx[3] != pend.idx[3]) {
              flush<VEC>(pend, ig_bh, lo, HC, c0, P);
#pragma unroll
              for (int q = 0; q < 4; ++q) pend.idx[q] = idx[q];
            }
            ++pend.len;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // a corner masked in zeros mode adds nothing
              const float w = a * lerp[q];
              pend.nz |= (w != 0.f ? 1u : 0u) << q;
              pend.acc[q].x += w * o0.x;
              pend.acc[q].y += w * o0.y;
              pend.acc[q].z += w * o0.z;
              pend.acc[q].w += w * o0.w;
            }
          }
        }
      } else {
        for (int c = c0; c < C; c += step) {
          const float4 o = c == c0 ? o0 : load_vec<VEC>(og_row + c);
          corner_dots<VEC>(o, load_vec<VEC>(img_bh + idx[0] * HC + c),
                           load_vec<VEC>(img_bh + idx[1] * HC + c),
                           load_vec<VEC>(img_bh + idx[2] * HC + c),
                           load_vec<VEC>(img_bh + idx[3] * HC + c), dots);
          if (valid) {
            const float4 ao = make_float4(a * o.x, a * o.y, a * o.z, a * o.w);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              msda::add_grad<VEC>(ig_bh + idx[q] * HC + c, ao, lerp[q]);
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
    if constexpr (MERGE) {
      if (c0 < C) flush<VEC>(pend, ig_bh, lo, HC, c0, P);
    }
  }
}

template <typename T, int VEC, bool MERGE>
void launch(const void* img, const void* pts, const void* wts, const void* og,
            void* img_grad, void* pts_grad, void* wts_grad,
            const LevelTable& levels, int64_t lo, int64_t num_tasks,
            int64_t blocks, int I, int N, int H, int C, int L, int P, int G,
            bool zeros, bool align_corners, cudaStream_t stream) {
  msda_bwd_kernel<T, VEC, MERGE>
      <<<(unsigned int)blocks, MSDA_WARPS_PER_BLOCK * 32, 0, stream>>>(
          static_cast<const T*>(img), static_cast<const float*>(pts),
          static_cast<const float*>(wts), static_cast<const T*>(og),
          static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
          static_cast<float*>(wts_grad), levels, lo, num_tasks, I, N, H, C,
          L, P, G, zeros, align_corners);
}

// VEC = 4 where C and the alignment of img and out_grad allow it; MERGE
// where a task's channels take one step of its lanes.
template <typename T>
int dispatch(const void* img, const void* pts, const void* wts,
             const void* og, void* img_grad, void* pts_grad, void* wts_grad,
             const LevelTable& levels, int B, int I, int N, int H, int C,
             int L, int P, bool zeros, bool align_corners,
             cudaStream_t stream) {
  const bool v4 = msda::vec4<T>(C, img) && msda::vec4<T>(C, og);
  const int vec = v4 ? 4 : 1;
  const int G = msda::group_lanes(C, vec);
  const bool merge = C <= G * vec;
  const int64_t num_tasks = (int64_t)B * N * H;
  const int64_t per_block = (int64_t)MSDA_WARPS_PER_BLOCK * (32 / G);
  const int64_t blocks = (num_tasks + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  auto run = v4 ? (merge ? launch<T, 4, true> : launch<T, 4, false>)
                : (merge ? launch<T, 1, true> : launch<T, 1, false>);
  // the rounding errors' half of img_grad
  const int64_t lo = (int64_t)B * I * H * C;
  run(img, pts, wts, og, img_grad, pts_grad, wts_grad, levels, lo,
      num_tasks, blocks, I, N, H, C, L, P, G, zeros, align_corners, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (img and out_grad).
// level_hw: host array [L, 2] of (height, width) per level.
// img_grad: [2, B, I, H, C] f32 of zeros; the kernel adds the gradient
// into the first half and the rounding errors of its exact adds into the
// second, whose sum is the gradient.
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
  if ((int64_t)B * N * H == 0) return (int)cudaSuccess;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool z = zeros != 0;
  const bool ac = align_corners != 0;
  switch (dtype) {
    case 0:
      return dispatch<float>(img, pts, wts, og, img_grad, pts_grad, wts_grad,
                             levels, B, I, N, H, C, L, P, z, ac, s);
    case 1:
      return dispatch<__half>(img, pts, wts, og, img_grad, pts_grad,
                              wts_grad, levels, B, I, N, H, C, L, P, z, ac,
                              s);
    case 2:
      return dispatch<__nv_bfloat16>(img, pts, wts, og, img_grad, pts_grad,
                                     wts_grad, levels, B, I, N, H, C, L, P,
                                     z, ac, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
