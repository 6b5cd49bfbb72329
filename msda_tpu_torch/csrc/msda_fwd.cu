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
// carried over.  This is the gather form:
//   * one warp per (b, n, h); lane = channel, looping over channels in
//     strides of 32 so that any C works (C = 32 at Deformable DETR's width);
//   * the lanes load the warp's L*P points and weights cooperatively (lane k
//     takes point k), compute each point's four corner indices and weights,
//     and share them with __shfl_sync;
//   * each point then costs four coalesced loads of C contiguous elements;
//   * warps are numbered with b slowest, so that the blocks in flight work on
//     one image's pyramid, which stays in the 50 MB L2.
// The ragged end of the query axis is a bound check on the warp index.
//
// What bounds it (planning arithmetic from the shapes, not a measurement):
// at the Deformable DETR encoder shape (B=2, N=I=22,223, H=8, C=32, L=4,
// P=4) in f32 the compulsory device-memory traffic is about 160 MB (img
// 45.5, points 45.5, weights 22.8, out 45.5 MB), about 50 us at 3.35 TB/s.
// The gathered corner traffic is 355,568 warps x 16 points x 4 corners x
// 128 B ~ 2.9 GB, mostly L2 hits.  So the kernel is bound by L2 bandwidth
// and load latency rather than by device memory.
//
// Interface: a plain C entry point (msda_fwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_fwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include "msda_geometry.cuh"

namespace {

using msda::LevelTable;
using msda::from_float;
using msda::to_float;

// pts: [B, N, H, L, P, 2] f32, wts: [B, N, H, L, P] f32,
// img: [B, I, H, C] T, out: [B, N, H, C] T; all contiguous.
template <typename T>
__global__ void __launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)
    msda_fwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, T* __restrict__ out,
                    const LevelTable levels, const int64_t num_tasks,
                    const int I, const int N, const int H, const int C,
                    const int L, const int P, const bool zeros,
                    const bool align_corners) {
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
  const T* img_bh = img + b * (int64_t)I * HC + (int64_t)h * C;
  T* out_row = out + task * (int64_t)C;

  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool c_ok = c < C;
    float acc = 0.f;
    for (int k0 = 0; k0 < LP; k0 += 32) {
      // lane k computes the geometry of point k0 + k
      const int k = k0 + lane;
      int i00 = 0, i01 = 0, i10 = 0, i11 = 0;
      float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
      if (k < LP) {
        const int l = k / P;
        const msda::Corners g = msda::corner_geometry(
            pt[2 * k], pt[2 * k + 1], levels.h[l], levels.w[l],
            levels.offset[l], zeros, align_corners);
        const float a = wt[k];
        i00 = g.i00;
        i01 = g.i01;
        i10 = g.i10;
        i11 = g.i11;
        w00 = a * g.uy0 * g.vx0;
        w01 = a * g.uy0 * g.vx1;
        w10 = a * g.uy1 * g.vx0;
        w11 = a * g.uy1 * g.vx1;
      }
      const int count = min(32, LP - k0);
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const int j00 = __shfl_sync(MSDA_FULL_MASK, i00, j);
        const int j01 = __shfl_sync(MSDA_FULL_MASK, i01, j);
        const int j10 = __shfl_sync(MSDA_FULL_MASK, i10, j);
        const int j11 = __shfl_sync(MSDA_FULL_MASK, i11, j);
        const float u00 = __shfl_sync(MSDA_FULL_MASK, w00, j);
        const float u01 = __shfl_sync(MSDA_FULL_MASK, w01, j);
        const float u10 = __shfl_sync(MSDA_FULL_MASK, w10, j);
        const float u11 = __shfl_sync(MSDA_FULL_MASK, w11, j);
        if (c_ok) {
          const float v00 = to_float(img_bh[(int64_t)j00 * HC + c]);
          const float v01 = to_float(img_bh[(int64_t)j01 * HC + c]);
          const float v10 = to_float(img_bh[(int64_t)j10 * HC + c]);
          const float v11 = to_float(img_bh[(int64_t)j11 * HC + c]);
          acc += u00 * v00 + u01 * v01 + u10 * v10 + u11 * v11;
        }
      }
    }
    if (c_ok) out_row[c] = from_float<T>(acc);
  }
}

template <typename T>
void launch(const void* img, const void* pts, const void* wts, void* out,
            const LevelTable& levels, int64_t num_tasks, int64_t blocks,
            int I, int N, int H, int C, int L, int P, bool zeros,
            bool align_corners, cudaStream_t stream) {
  msda_fwd_kernel<T><<<(unsigned int)blocks, MSDA_WARPS_PER_BLOCK * 32, 0,
                       stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<T*>(out), levels, num_tasks,
      I, N, H, C, L, P, zeros, align_corners);
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
  const int64_t blocks =
      (num_tasks + MSDA_WARPS_PER_BLOCK - 1) / MSDA_WARPS_PER_BLOCK;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool z = zeros != 0;
  const bool ac = align_corners != 0;
  switch (dtype) {
    case 0:
      launch<float>(img, pts, wts, out, levels, num_tasks, blocks, I, N, H, C,
                    L, P, z, ac, s);
      break;
    case 1:
      launch<__half>(img, pts, wts, out, levels, num_tasks, blocks, I, N, H,
                     C, L, P, z, ac, s);
      break;
    case 2:
      launch<__nv_bfloat16>(img, pts, wts, out, levels, num_tasks, blocks, I,
                            N, H, C, L, P, z, ac, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
