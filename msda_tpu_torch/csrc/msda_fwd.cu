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
// indices, and the indices are clamped afterwards.  The sum accumulates in
// f32 and is rounded once to the output type, which is img's type.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 16
#define MSDA_WARPS_PER_BLOCK 8
#define MSDA_FULL_MASK 0xffffffffu

namespace {

struct LevelTable {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int offset[MSDA_MAX_LEVELS];
};

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
        const int hl = levels.h[l];
        const int wl = levels.w[l];
        const float x = pt[2 * k];
        const float y = pt[2 * k + 1];
        const float a = wt[k];
        // round the product and the shift separately, as the plain version
        // does, so that floor() sees the same value (no FMA contraction)
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
        bool mx0 = true, mx1 = true, my0 = true, my1 = true;
        if (zeros) {
          mx0 = x0 >= 0 && x0 < wl;
          mx1 = x0 + 1 >= 0 && x0 + 1 < wl;
          my0 = y0 >= 0 && y0 < hl;
          my1 = y0 + 1 >= 0 && y0 + 1 < hl;
        }
        const float vx0 = mx0 ? 1.f - dx : 0.f;
        const float vx1 = mx1 ? dx : 0.f;
        const float uy0 = my0 ? 1.f - dy : 0.f;
        const float uy1 = my1 ? dy : 0.f;
        const int x0c = min(max(x0, 0), wl - 1);
        const int x1c = min(max(x0 + 1, 0), wl - 1);
        const int y0c = min(max(y0, 0), hl - 1);
        const int y1c = min(max(y0 + 1, 0), hl - 1);
        const int off = levels.offset[l];
        i00 = off + y0c * wl + x0c;
        i01 = off + y0c * wl + x1c;
        i10 = off + y1c * wl + x0c;
        i11 = off + y1c * wl + x1c;
        w00 = a * uy0 * vx0;
        w01 = a * uy0 * vx1;
        w10 = a * uy1 * vx0;
        w11 = a * uy1 * vx1;
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
  const int* hw = static_cast<const int*>(level_hw);
  LevelTable levels;
  int64_t pixels = 0;
  for (int l = 0; l < L; ++l) {
    levels.h[l] = hw[2 * l];
    levels.w[l] = hw[2 * l + 1];
    levels.offset[l] = (int)pixels;
    pixels += (int64_t)hw[2 * l] * hw[2 * l + 1];
  }
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
