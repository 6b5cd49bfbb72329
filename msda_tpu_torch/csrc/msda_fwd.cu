// Multiscale deformable attention forward (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel msda_tpu/ops/pallas_fwd.py:_fwd_kernel (pallas_call
// in _pallas_fwd).  It computes the same function:
//
//   out[b,n,h,:] = sum_{l,p} w[b,n,h,l,p] *
//                  bilerp(img[b, off_l : off_l + h_l*w_l, h, :], pt[b,n,h,l,p])
//
// with grid_sample semantics (point_geometry in pallas_fwd.py): coordinates
// are unnormalized by align_corners, floored with floorf (they can be
// negative), the zeros-mode corner masks are taken on the *unclamped* corner
// indices, and the indices are clamped afterwards.  That geometry is
// msda::corner_geometry in msda_geometry.cuh, shared with the backward (K2,
// msda_bwd.cu).  The sum accumulates in f32 and is rounded once to the output
// type, which is img's type.
//
// Design.  The Pallas kernel folds the bilinear weights into dense matrices
// and contracts them on the MXU because a TPU has no gather; none of that is
// carried over.  This is the gather form, on lane groups (msda_lanes.cuh):
//   * a task is one (b, n, h); a group of G lanes owns it, VEC = 4 adjacent
//     channels per lane (G = 8 at C = 32, four tasks per warp);
//   * tasks are numbered (b, h, n): the groups of a warp and the warps of a
//     block take neighbouring queries of one head, so a block's loads of
//     that head's coarse levels hit L1, and the blocks in flight work on
//     one image's pyramid, which stays in the 50 MB L2;
//   * every lane computes each point's geometry itself (no broadcast), loads
//     its channels of the four corners with one 16-byte load each (8 bytes
//     in the half types) and accumulates in f32; the output is one vector
//     store per lane.
// Where C is not a multiple of 4 or img is not aligned for the vector loads,
// the same template runs with VEC = 1 (one channel a lane).  A channel count
// past G * VEC loops.  The ragged end of the task axis is a bound check on
// the group's task.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// docs/experiments/torch_kernel_ab.py, _variants.py): at Deformable DETR's
// encoder shape (B=2, N=I=22,223, H=8, C=32, L=4, P=4) the call must move
// 159.3 MB in f32 (img, points, weights, out), 47.6 us at 3.35 TB/s
// (utils.bench.msda_bound).
// The kernel takes 0.29 ms in f32 and 0.27 ms in bf16: 16% and 13% of that
// bound.  Its ~2.9 GB of corner loads are mostly L1 and L2 hits, and forcing
// every corner onto one pixel saves at most 12%, so L2 bandwidth does not
// bound it; what is left is the latency of two dependent loads per point
// (its coordinates, then its corners) at 32 warps an SM (64 registers).
// The lane-per-channel kernel it replaces took 0.48 ms: 8 shuffles per
// point to broadcast the geometry, and 4-byte loads.
//
// Interface: a plain C entry point (msda_fwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_fwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

namespace {

using msda::LevelTable;
using msda::load_vec;
using msda::store_vec;

// pts: [B, N, H, L, P, 2] f32, wts: [B, N, H, L, P] f32,
// img: [B, I, H, C] T, out: [B, N, H, C] T; all contiguous.
template <typename T, int VEC>
__global__ void __launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)
    msda_fwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, T* __restrict__ out,
                    const LevelTable levels, const int64_t num_tasks,
                    const int I, const int N, const int H, const int C,
                    const int L, const int P, const int G, const bool zeros,
                    const bool align_corners) {
  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  // the group's task, in (b, h, n) order
  const int64_t t =
      ((int64_t)blockIdx.x * MSDA_WARPS_PER_BLOCK + (threadIdx.x >> 5)) *
          (32 / G) + group;
  if (t >= num_tasks) return;
  const int64_t bh = t / N;  // b * H + h
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  const int64_t task = (b * N + (t - bh * N)) * H + h;  // (b, n, h) row

  const int LP = L * P;
  const int64_t HC = (int64_t)H * C;
  const float* pt = pts + task * (int64_t)LP * 2;
  const float* wt = wts + task * (int64_t)LP;
  const T* img_bh = img + b * (int64_t)I * HC + (int64_t)h * C;
  T* out_row = out + task * (int64_t)C;

  for (int c = c_lane * VEC; c < C; c += G * VEC) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      const int hl = levels.h[l], wl = levels.w[l], off = levels.offset[l];
#pragma unroll 4
      for (int k = l * P; k < (l + 1) * P; ++k) {
        const msda::Corners g = msda::corner_geometry(
            pt[2 * k], pt[2 * k + 1], hl, wl, off, zeros, align_corners);
        const float a = wt[k];
        const float w00 = a * g.uy0 * g.vx0, w01 = a * g.uy0 * g.vx1;
        const float w10 = a * g.uy1 * g.vx0, w11 = a * g.uy1 * g.vx1;
        const float4 v00 = load_vec<VEC>(img_bh + g.i00 * HC + c);
        const float4 v01 = load_vec<VEC>(img_bh + g.i01 * HC + c);
        const float4 v10 = load_vec<VEC>(img_bh + g.i10 * HC + c);
        const float4 v11 = load_vec<VEC>(img_bh + g.i11 * HC + c);
        acc.x += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
        acc.y += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
        acc.z += w00 * v00.z + w01 * v01.z + w10 * v10.z + w11 * v11.z;
        acc.w += w00 * v00.w + w01 * v01.w + w10 * v10.w + w11 * v11.w;
      }
    }
    store_vec<VEC>(out_row + c, acc);
  }
}

template <typename T, int VEC>
void launch(const void* img, const void* pts, const void* wts, void* out,
            const LevelTable& levels, int64_t num_tasks, int64_t blocks,
            int I, int N, int H, int C, int L, int P, int G, bool zeros,
            bool align_corners, cudaStream_t stream) {
  msda_fwd_kernel<T, VEC><<<(unsigned int)blocks, MSDA_WARPS_PER_BLOCK * 32,
                            0, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<T*>(out), levels, num_tasks,
      I, N, H, C, L, P, G, zeros, align_corners);
}

// VEC = 4 where C and img's alignment allow it (out is the wrapper's own).
template <typename T>
int dispatch(const void* img, const void* pts, const void* wts, void* out,
             const LevelTable& levels, int64_t num_tasks, int I, int N,
             int H, int C, int L, int P, bool zeros, bool align_corners,
             cudaStream_t stream) {
  const bool v4 = msda::vec4<T>(C, img);
  const int G = msda::group_lanes(C, v4 ? 4 : 1);
  const int64_t per_block = (int64_t)MSDA_WARPS_PER_BLOCK * (32 / G);
  const int64_t blocks = (num_tasks + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (v4) {
    launch<T, 4>(img, pts, wts, out, levels, num_tasks, blocks, I, N, H, C,
                 L, P, G, zeros, align_corners, stream);
  } else {
    launch<T, 1>(img, pts, wts, out, levels, num_tasks, blocks, I, N, H, C,
                 L, P, G, zeros, align_corners, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (img and out).
// level_hw: host array [L, 2] of (height, width) per level.
// Returns a cudaError_t: cudaSuccess (0) when the launch was accepted.
int msda_fwd_launch(int dtype, const void* img, const void* pts,
                    const void* wts, void* out, const void* level_hw, int B,
                    int I, int N, int H, int C, int L, int P, int zeros,
                    int align_corners, void* stream) {
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
      return dispatch<float>(img, pts, wts, out, levels, num_tasks, I, N, H,
                             C, L, P, z, ac, s);
    case 1:
      return dispatch<__half>(img, pts, wts, out, levels, num_tasks, I, N, H,
                              C, L, P, z, ac, s);
    case 2:
      return dispatch<__nv_bfloat16>(img, pts, wts, out, levels, num_tasks,
                                     I, N, H, C, L, P, z, ac, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
