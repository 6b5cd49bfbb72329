// EXPERIMENT, not shipped: K1 with each warp on its own tiles (its own ring
// of cp.async stages and mbarriers, its own geometry entries, __syncwarp
// in place of the block barriers).  Built beside its own
// msda_fwd_plan.cuh by docs/experiments/torch_fwd_designs.py (include
// path: this directory, then msda_tpu_torch/csrc).  Measured (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md section 6) against the block-tiled
// design of the same day, both still with 64-bit task division: 80
// registers and 24 bytes of spills (24 warps an SM); held to 64
// registers and 2 points a batch it ran from 3% slower (f32, uniform
// points) to 11% faster (f32, the model's points) than cc78811's K1 at
// the encoder, where the block tiles saved 8-18% in bf16 and on the
// model's points.  The note below is the design as it was written.
//
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
// Why no tensor cores.  The Pallas kernel folds each query's bilinear
// weights into a dense interpolation matrix and contracts it on the MXU,
// because a TPU has no gather.  K1 has no atomics to save, and building that
// matrix costs what the gather does (K2's dense coarse form measured so,
// docs/experiments/msda_bwd_coarse.cu), so this is the gather form.
//
// What bounded the lane-group K1 it replaces (NVIDIA H100 80GB HBM3,
// 700 W; docs/experiments/torch_fwd_breakdown.py).  That kernel gave a
// task (b, n, h) to a group of G lanes, VEC = 4 channels a lane, and every
// lane of the group loaded the point's coordinates and weight and computed
// its whole geometry: about 60 of the ~85 instructions of a lane-point
// were that repeated work, and the corner loads waited on the point loads.
// At the encoder shape (B=2, N=I=22,223, H=8, C=32, L=4, P=4) it took 0.29
// ms in f32, 16% of the 47.6 us the call's 159.3 MB need at 3.35 TB/s
// (utils.bench.msda_bound); every corner on one pixel saved only ~11%, so
// L1/L2 bytes did not bound it.
//
// Design.
//   * Tiles.  A block serves a tile of T = MSDA_FWD_WARPS * 32 / G
//     consecutive tasks in (b, h, n) order (T = 32 at C = 32), a task a
//     group of G lanes (msda_lanes.cuh); neighbouring queries of one head
//     share its coarse levels in L1.  Blocks are persistent: the grid is
//     MSDA_FWD_BLOCKS_PER_SM blocks a multiprocessor (fewer where the
//     registers or shared memory do not fit them), each walking the tiles
//     blockIdx.x, + gridDim.x, ...
//   * Points and weights by asynchronous copies.  A tile's coordinates
//     (L*P*2 f32 a task, H*L*P*2 apart between consecutive n) and weights go
//     into shared memory by cp.async (16-byte copies where the rows and the
//     base allow it, else 8 or 4), each thread's copies arriving on the
//     stage's mbarrier (cp.async.mbarrier.arrive.noinc), in a ring of
//     MSDA_FWD_STAGES stages: the next tiles' copies are in flight while a
//     tile is gathered.  The ragged last tile copies only its tasks.
//   * Geometry once a (task, point).  The block's threads split the tile's
//     points among them; each point's four corner offsets (32-bit element
//     offsets from img_bh: the wrapper refuses tensors past 2^31 - 1
//     elements) and its four weights (the bilinear factors times the
//     attention weight, a masked corner's 0) go into shared memory.  A
//     group's lanes then read a point's entry with two broadcast 16-byte
//     shared loads and issue its four corner loads (16 bytes a lane in f32,
//     8 in the half types), the corner loads of MSDA_FWD_BATCH points (a
//     level at P = 4) before their multiply-adds.
//   * Chunks.  A task of more than MSDA_FWD_CHUNK points (or more than
//     shared memory holds for the tile) is staged in chunks; then the tile
//     is walked once a channel step, its sum kept in registers across the
//     chunks (msda_fwd_plan.cuh).
// The arithmetic is the lane-group kernel's: the same weight products and
// the same multiply-adds in the same point order, so the outputs are
// bit-identical to it.  Where C is not a multiple of 4 or img is not
// aligned for the vector loads, the same template runs with VEC = 1.
//
// Interface: a plain C entry point (msda_fwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_fwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
// msda_fwd_plan returns a launch's plan.

#include <atomic>
#include <climits>
#include <cstdint>

#include "msda_fwd_plan.cuh"
#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

namespace {

using msda::FwdPlan;
using msda::LevelTable;
using msda::load_vec;
using msda::store_vec;

constexpr int kThreads = MSDA_FWD_WARPS * 32;

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of vw = 4, 2 or 1 floats into shared memory.
__device__ __forceinline__ void copy_async(const uint32_t dst,
                                           const float* src, const int vw) {
  if (vw == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else if (vw == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void barrier_init(const uint32_t bar,
                                             const uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// The barrier's pending count falls by one when this thread's earlier
// copies have landed.
__device__ __forceinline__ void arrive_after_copies(const uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void wait_phase(const uint32_t bar,
                                           const uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The (b, n, h) row of task t, numbered (b, h, n).
__device__ __forceinline__ int64_t task_row(const int64_t t, const int N,
                                            const int H, int64_t& b,
                                            int& h) {
  const int64_t bh = t / N;  // b * H + h
  h = (int)(bh % H);
  b = bh / H;
  return (b * N + (t - bh * N)) * H + h;
}

// One point's four corners, weighted, into acc: the lane-group kernel's
// expression, so that the sums round as they did.
__device__ __forceinline__ void add_point(float4& acc, const float4& w,
                                          const float4& v00,
                                          const float4& v01,
                                          const float4& v10,
                                          const float4& v11) {
  acc.x += w.x * v00.x + w.y * v01.x + w.z * v10.x + w.w * v11.x;
  acc.y += w.x * v00.y + w.y * v01.y + w.z * v10.y + w.w * v11.y;
  acc.z += w.x * v00.z + w.y * v01.z + w.z * v10.z + w.w * v11.z;
  acc.w += w.x * v00.w + w.y * v01.w + w.z * v10.w + w.w * v11.w;
}

// pts: [B, N, H, L, P, 2] f32, wts: [B, N, H, L, P] f32,
// img: [B, I, H, C] T, out: [B, N, H, C] T; all contiguous.
// Dynamic shared memory (plan.smem bytes), a region a warp: its tile's
// corner offsets [32 / G][stride] int4 and weights [32 / G][stride] float4,
// then its stages' coordinates [S][32 / G][stride][2] and attention weights
// [S][32 / G][stride] f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    msda_fwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, T* __restrict__ out,
                    const LevelTable levels, const FwdPlan plan,
                    const int64_t num_tasks, const int I, const int N,
                    const int H, const int C, const int L, const int P,
                    const bool zeros, const bool align_corners) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MSDA_FWD_WARPS][MSDA_FWD_STAGES];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = plan.lanes, stride = plan.stride;
  const int tile = 32 / G;  // a warp's tasks at once
  const int entries = tile * stride;
  int4* const corner_off = reinterpret_cast<int4*>(
      smem + (size_t)warp * entries * msda::kFwdPointBytes);
  float4* const corner_w = reinterpret_cast<float4*>(corner_off + entries);
  float* const stage_pts = reinterpret_cast<float*>(corner_w + entries);
  float* const stage_wts = stage_pts + MSDA_FWD_STAGES * entries * 2;
  uint64_t* const bars = full[warp];

  const int slot = lane / G, c_lane = lane - slot * G;
  const int LP = L * P;
  const int HC = H * C;
  // the warp's tiles: warp tile (block tile) * MSDA_FWD_WARPS + warp, for
  // the block tiles blockIdx.x, + gridDim.x, ...
  const int64_t num_tiles = (num_tasks + tile - 1) / tile;
  const int64_t my_block_tiles =
      num_tiles > warp ? (num_tiles - warp + MSDA_FWD_WARPS - 1) /
                             MSDA_FWD_WARPS
                       : 0;
  if (my_block_tiles <= blockIdx.x) return;
  const int per_tile = plan.passes * plan.chunks;
  const int64_t my_units =
      ((my_block_tiles - 1 - blockIdx.x) / gridDim.x + 1) * per_tile;
  auto tile_of = [&](const int64_t q) {
    return (blockIdx.x + (q / per_tile) * gridDim.x) * MSDA_FWD_WARPS + warp;
  };

  if (lane == 0) {
    for (int s = 0; s < MSDA_FWD_STAGES; ++s) {
      barrier_init(smem_address(&bars[s]), 32);
    }
  }
  __syncwarp();

  // Copies the coordinates and weights of unit q (a tile's chunk, in one
  // channel pass) into stage q % S; every lane arrives on its barrier.
  auto issue = [&](const int64_t q) {
    const int64_t tile_id = tile_of(q);
    const int chunk = (int)(q % per_tile) % plan.chunks;
    const int k0 = chunk * plan.chunk;
    const int kp = min(plan.chunk, LP - k0);
    const int s = (int)(q % MSDA_FWD_STAGES);
    float* const sp = stage_pts + s * entries * 2;
    float* const sw = stage_wts + s * entries;
    const int np = 2 * kp / plan.vw_pts, nw = kp / plan.vw_wts;
    for (int e = lane; e < tile * (np + nw); e += 32) {
      const bool is_pt = e < tile * np;
      const int e2 = is_pt ? e : e - tile * np;
      const int per = is_pt ? np : nw;
      const int j = e2 / per, v = e2 - j * per;
      const int64_t t = tile_id * tile + j;
      if (t >= num_tasks) continue;
      int64_t b;
      int h;
      const int64_t row = task_row(t, N, H, b, h);
      if (is_pt) {
        copy_async(smem_address(sp + j * stride * 2 + v * plan.vw_pts),
                   pts + row * LP * 2 + k0 * 2 + v * plan.vw_pts,
                   plan.vw_pts);
      } else {
        copy_async(smem_address(sw + j * stride + v * plan.vw_wts),
                   wts + row * LP + k0 + v * plan.vw_wts, plan.vw_wts);
      }
    }
    arrive_after_copies(smem_address(&bars[s]));
  };

  for (int s = 0; s < MSDA_FWD_STAGES && s < my_units; ++s) issue(s);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t q = 0; q < my_units; ++q) {
    const int64_t tile_id = tile_of(q);
    const int sub = (int)(q % per_tile);
    const int pass = sub / plan.chunks, chunk = sub % plan.chunks;
    const int k0 = chunk * plan.chunk;
    const int kp = min(plan.chunk, LP - k0);
    const int s = (int)(q % MSDA_FWD_STAGES);
    wait_phase(smem_address(&bars[s]),
               (uint32_t)((q / MSDA_FWD_STAGES) & 1));

    // the geometry of the tile's points, once each
    const float* const sp = stage_pts + s * entries * 2;
    const float* const sw = stage_wts + s * entries;
    const int64_t left = num_tasks - tile_id * tile;
    const int live = left < tile ? (int)left : tile;
    for (int e = lane; e < live * kp; e += 32) {
      const int j = e / kp, kk = e - j * kp;
      const int l = (k0 + kk) / P;
      const int i = j * stride + kk;
      const msda::Corners g = msda::corner_geometry(
          sp[2 * i], sp[2 * i + 1], levels.h[l], levels.w[l],
          levels.offset[l], zeros, align_corners);
      const float a = sw[i];
      corner_off[i] = make_int4(g.i00 * HC, g.i01 * HC, g.i10 * HC,
                                g.i11 * HC);
      corner_w[i] = make_float4(a * g.uy0 * g.vx0, a * g.uy0 * g.vx1,
                                a * g.uy1 * g.vx0, a * g.uy1 * g.vx1);
    }
    __syncwarp();  // the entries are written; stage s is free again
    if (q + MSDA_FWD_STAGES < my_units) issue(q + MSDA_FWD_STAGES);

    // the gather: a group its task, VEC channels a lane
    if (slot < live) {
      int64_t b;
      int h;
      const int64_t row = task_row(tile_id * tile + slot, N, H, b, h);
      const T* const img_bh = img + b * (int64_t)I * HC + (int64_t)h * C;
      T* const out_row = out + row * C;
      const int4* const eo = corner_off + slot * stride;
      const float4* const ew = corner_w + slot * stride;
      const bool whole = plan.chunks == 1;
      const int c_first = (c_lane + pass * G) * VEC;
      const int c_end = whole ? C : min(C, c_first + 1);
      for (int c = c_first; c < c_end; c += G * VEC) {
        if (whole || chunk == 0) acc = make_float4(0.f, 0.f, 0.f, 0.f);
        const T* const base = img_bh + c;
        int k = 0;
        for (; k + MSDA_FWD_BATCH <= kp; k += MSDA_FWD_BATCH) {
          float4 w[MSDA_FWD_BATCH], v[MSDA_FWD_BATCH][4];
#pragma unroll
          for (int u = 0; u < MSDA_FWD_BATCH; ++u) {
            const int4 o = eo[k + u];
            w[u] = ew[k + u];
            v[u][0] = load_vec<VEC>(base + o.x);
            v[u][1] = load_vec<VEC>(base + o.y);
            v[u][2] = load_vec<VEC>(base + o.z);
            v[u][3] = load_vec<VEC>(base + o.w);
          }
#pragma unroll
          for (int u = 0; u < MSDA_FWD_BATCH; ++u) {
            add_point(acc, w[u], v[u][0], v[u][1], v[u][2], v[u][3]);
          }
        }
        for (; k < kp; ++k) {
          const int4 o = eo[k];
          add_point(acc, ew[k], load_vec<VEC>(base + o.x),
                    load_vec<VEC>(base + o.y), load_vec<VEC>(base + o.z),
                    load_vec<VEC>(base + o.w));
        }
        if (whole || chunk == plan.chunks - 1) store_vec<VEC>(out_row + c, acc);
      }
    }
    __syncwarp();  // the entries are read before the next unit's
  }
}

// Lets an instantiation use up to MSDA_FWD_SMEM_MAX bytes of dynamic shared
// memory a block, once a device.
template <typename T, int VEC>
int allow_shared() {
  static std::atomic<uint64_t> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = 1ull << (device & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(msda_fwd_kernel<T, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MSDA_FWD_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (MSDA_FWD_CARVEOUT >= 0) {
      err = cudaFuncSetAttribute(
          msda_fwd_kernel<T, VEC>,
          cudaFuncAttributePreferredSharedMemoryCarveout, MSDA_FWD_CARVEOUT);
      if (err != cudaSuccess) return (int)err;
    }
    done.fetch_or(bit);
  }
  return (int)cudaSuccess;
}

// Multiprocessors of the current device, asked once a device.
int multiprocessors() {
  static std::atomic<int> count[64];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  int n = count[device & 63].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess) {
      return 0;
    }
    count[device & 63].store(n);
  }
  return n;
}

template <typename T, int VEC>
int launch(const void* img, const void* pts, const void* wts, void* out,
           const LevelTable& levels, const FwdPlan& plan, int64_t num_tasks,
           int I, int N, int H, int C, int L, int P, bool zeros,
           bool align_corners, cudaStream_t stream) {
  auto kernel = msda_fwd_kernel<T, VEC>;
  int err = allow_shared<T, VEC>();
  if (err != (int)cudaSuccess) return err;
  int resident = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, kThreads, plan.smem);
  if (err != (int)cudaSuccess) return err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int sms = multiprocessors();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int64_t tiles = (num_tasks + plan.tile - 1) / plan.tile;
  const int per_sm =
      resident < MSDA_FWD_BLOCKS_PER_SM ? resident : MSDA_FWD_BLOCKS_PER_SM;
  const int64_t most = (int64_t)per_sm * sms;
  const int64_t blocks = tiles < most ? tiles : most;
  kernel<<<(unsigned int)blocks, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<T*>(out), levels, plan,
      num_tasks, I, N, H, C, L, P, zeros, align_corners);
  return (int)cudaGetLastError();
}

// VEC = 4 where C and img's alignment allow it (out is the wrapper's own).
template <typename T>
FwdPlan plan_for(const void* img, const void* pts, const void* wts, int C,
                 int L, int P) {
  const bool v4 = msda::vec4<T>(C, img);
  const int vec = v4 ? 4 : 1;
  return msda::fwd_plan(
      L, P, C, msda::group_lanes(C, vec), vec,
      msda::fwd_alignment(reinterpret_cast<uintptr_t>(pts)),
      msda::fwd_alignment(reinterpret_cast<uintptr_t>(wts)));
}

template <typename T>
int dispatch(const void* img, const void* pts, const void* wts, void* out,
             const LevelTable& levels, int64_t num_tasks, int I, int N,
             int H, int C, int L, int P, bool zeros, bool align_corners,
             cudaStream_t stream) {
  const FwdPlan plan = plan_for<T>(img, pts, wts, C, L, P);
  if (plan.smem == 0) return (int)cudaErrorInvalidConfiguration;
  if (plan.vec == 4) {
    return launch<T, 4>(img, pts, wts, out, levels, plan, num_tasks, I, N, H,
                        C, L, P, zeros, align_corners, stream);
  }
  return launch<T, 1>(img, pts, wts, out, levels, plan, num_tasks, I, N, H,
                      C, L, P, zeros, align_corners, stream);
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

// The plan of a launch on these arguments (msda_fwd_plan.cuh), written into
// plan[10] in FwdPlan's order.  Returns cudaErrorInvalidValue for a dtype
// or shape msda_fwd_launch refuses.
int msda_fwd_plan(int dtype, const void* img, const void* pts,
                  const void* wts, int C, int L, int P, int* plan) {
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FwdPlan p;
  switch (dtype) {
    case 0: p = plan_for<float>(img, pts, wts, C, L, P); break;
    case 1: p = plan_for<__half>(img, pts, wts, C, L, P); break;
    case 2: p = plan_for<__nv_bfloat16>(img, pts, wts, C, L, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int fields[10] = {p.lanes,  p.vec,    p.tile,   p.chunk,  p.stride,
                          p.chunks, p.passes, p.vw_pts, p.vw_wts, p.smem};
  for (int i = 0; i < 10; ++i) plan[i] = fields[i];
  return (int)cudaSuccess;
}

}  // extern "C"
