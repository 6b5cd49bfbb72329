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
// What bounded the lane-group K1 it replaces (cc78811; NVIDIA H100 80GB
// HBM3, 700 W; docs/experiments/torch_fwd_breakdown.py, PERF.md section 6).
// That kernel gave a task (b, n, h) to a group of G lanes, VEC = 4 channels
// a lane; every lane loaded each point's coordinates and weight, computed
// its whole geometry, and found its task's indices with 64-bit divisions.
// At the encoder shape (B=2, N=I=22,223, H=8, C=32, L=4, P=4) it took 0.29
// ms in f32, 16% of the 47.6 us the call's 159.3 MB need at 3.35 TB/s
// (utils.bench.msda_bound).  Each level alone took 30-41% of that: a level
// of 4 points cost ~0.017 ms whatever its size, and every corner on one
// pixel saved at most 6%, so neither L1 nor L2 bytes bound it; the
// geometry done once a group saved 1-3% on uniform points (14% on the
// model's), the point loads made in registers 6% (f32; bf16 none).
//
// Design.
//   * Tiles.  A block serves a tile of T = MSDA_FWD_WARPS * 32 / G
//     consecutive tasks in (b, h, n) order (T = 16 at C = 32), a task a
//     group of G lanes (msda_lanes.cuh); neighbouring queries of one head
//     share its coarse levels in L1.  Blocks are persistent: the grid is
//     MSDA_FWD_BLOCKS_PER_SM blocks a multiprocessor (fewer where the
//     registers or shared memory do not fit them), each walking the tiles
//     blockIdx.x, + gridDim.x, ...  A task's indices are 32-bit (the
//     wrapper refuses outputs past 2^31 - 1 elements) and divided by a
//     multiply and a shift (msda::FastDiv): with 64-bit divisions, three a
//     copy and three a task, the same design was 7% slower than the
//     lane-group kernel at the encoder (f32, uniform points).
//   * Points and weights by asynchronous copies.  A tile's coordinates
//     (L*P*2 f32 a task, H*L*P*2 apart between consecutive n) and weights go
//     into shared memory by cp.async (16-byte copies where the rows and the
//     base allow it, else 8 or 4), each thread's copies arriving on the
//     stage's mbarrier (cp.async.mbarrier.arrive.noinc), in a ring of
//     MSDA_FWD_STAGES stages: the next tiles' copies are in flight while a
//     tile is gathered, so no corner load waits on a point load.  The
//     ragged last tile copies only its tasks.
//   * Geometry once a (task, point).  The block's threads split the tile's
//     points among them; each point's four corner offsets (32-bit element
//     offsets from img_bh) and its four weights (the bilinear factors times
//     the attention weight, a masked corner's 0) go into shared memory, a
//     power of two of entries a task.  A group's lanes then read a point's
//     entry with two broadcast 16-byte shared loads and issue its four
//     corner loads (16 bytes a lane in f32, 8 in the half types), the loads
//     of MSDA_FWD_BATCH points before their multiply-adds.
//   * No level is staged in shared memory: a level of 4 points cost the
//     lane-group kernel the same whatever the level's size, so the coarse
//     levels' loads (mostly L1 hits) cost no more than the fine ones'.
//   * Chunks.  A task of more than MSDA_FWD_CHUNK points (or more than
//     shared memory holds for the tile) is staged in chunks; then the tile
//     is walked once a channel step, its sum kept in registers across the
//     chunks (msda_fwd_plan.cuh).
// The defaults (4 warps, 8 blocks an SM, 3 stages, 2 points a batch) won
// docs/experiments/torch_fwd_designs.py's sweep at every shape; the
// designs that lost are kept beside it (k1_warp_tiles: a ring a warp, no
// block barrier; k1_geometry_shuffled: the geometry in registers and
// shuffled to the group's lanes, 128 registers).  What the shared memory
// costs: the lane-group kernel with 28 KB a block that it does not use is
// 4% slower at the encoder in f32 (less L1 for the coarse levels).
// The arithmetic is the lane-group kernel's: the same weight products and
// the same multiply-adds in the same point order, so the outputs are
// bit-identical to it.  Where C is not a multiple of 4 or img is not
// aligned for the vector loads, the same template runs with VEC = 1.
//
// The prologue variant (msda_fwd_queries_kernel, entry
// msda_fwd_queries_launch).  The attention module
// (msda_tpu_torch/models/attention.py) turns the query projection's output
// q [B, N, H, L, P, 3] into K1's inputs by a chain of PyTorch calls: q
// up-cast to f32, the logits gathered and softmaxed over L * P, the
// offsets divided by the level's size (or scaled by the box) and added to
// the reference point.  Under bf16 inference those five kernels write f32
// intermediates to device memory and read them back: 1.22 ms of a batch-2
// 800x1333 request's device time over the encoder's 6 calls (NVIDIA H100
// 80GB HBM3, 700 W), where K1's own bound is some 0.03 ms a call.  The
// variant stages each task's row of q in place of its points and weights
// (3 values a point in q's dtype, by cp.async copies of 4 to 16 bytes on
// the same ring) and its reference point (whose batch stride may be 0),
// and computes what the chain computed: each task's softmax as
// torch.softmax forms it (the max, exp(x - max) with the accurate expf,
// the lanes' sums in its order, one IEEE division a weight), in registers,
// a point a lane, and each point's location in the chain's f32 operations
// and order (IEEE division, no contraction); from there it is K1: the same
// geometry, entries and gather.  It takes 3 to 32 points a head (a task's
// points are its softmax's lanes) and rows of q that 4-byte copies divide
// (msda::fwd_queries_plan); the module runs the chain and K1 on any other
// shape.  K1's kernel and its instantiations are not changed by it: the
// variant is a kernel of its own, with its own copy of K1's gather.
//
// Interface: plain C entry points (msda_fwd_launch, msda_fwd_queries_launch),
// loaded with ctypes by msda_tpu_torch/ops/cuda_fwd.py and
// cuda_fwd_queries.py.  They launch on the given stream, do not
// synchronise, allocate nothing, and return cudaGetLastError().
// msda_fwd_plan and msda_fwd_queries_plan return a launch's plan.

#include <atomic>
#include <climits>
#include <cstdint>

#include "msda_async.cuh"
#include "msda_fwd_plan.cuh"
#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

namespace {

using msda::arrive_after_copies;
using msda::barrier_init;
using msda::copy_async;
using msda::divide;
using msda::fast_div;
using msda::FastDiv;
using msda::FwdPlan;
using msda::FwdQueriesPlan;
using msda::LevelTable;
using msda::load_vec;
using msda::multiprocessors;
using msda::smem_address;
using msda::store_vec;
using msda::to_float;
using msda::wait_phase;

constexpr int kThreads = MSDA_FWD_WARPS * 32;

// The divisors a task's indices need, as multiplies and shifts.
struct Divisors {
  FastDiv n, h, p;  // by N, by H, by P
};

// Task t (numbered (b, h, n); t < 2^31: the wrapper refuses outputs past
// 2^31 - 1 elements): its (b, n, h) row of pts, wts and out, and the offset
// of its head's first pixel in img.
struct Task {
  int row;
  int64_t img_offset;
};

__device__ __forceinline__ Task task_of(const int t, const Divisors& d,
                                        const int N, const int H, const int C,
                                        const int I) {
  const int bh = divide(t, d.n);  // b * H + h
  const int b = divide(bh, d.h), h = bh - b * H;
  return {(b * N + (t - bh * N)) * H + h,
          ((int64_t)b * I * H + h) * C};
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
// Dynamic shared memory (plan.smem bytes): the tile's entries, corner
// offsets [T][stride] int4 and weights [T][stride] float4, then the stages'
// coordinates [S][T][stride][2] and attention weights [S][T][stride] f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    msda_fwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, T* __restrict__ out,
                    const LevelTable levels, const FwdPlan plan,
                    const Divisors div, const int num_tasks, const int I,
                    const int N, const int H, const int C, const int L,
                    const int P, const bool zeros, const bool align_corners) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MSDA_FWD_STAGES];

  const int tile = plan.tile, G = plan.lanes;
  const int shift = __ffs(plan.stride) - 1;  // stride = 1 << shift
  const int entries = tile << shift;
  int4* const corner_off = reinterpret_cast<int4*>(smem);
  float4* const corner_w = reinterpret_cast<float4*>(corner_off + entries);
  float* const stage_pts = reinterpret_cast<float*>(corner_w + entries);
  float* const stage_wts = stage_pts + MSDA_FWD_STAGES * entries * 2;

  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  const int slot = (threadIdx.x >> 5) * (32 / G) + group;  // task in a tile
  const int LP = L * P;
  const int HC = H * C;
  const int num_tiles = (num_tasks + tile - 1) / tile;
  const int per_tile = plan.passes * plan.chunks;
  const int my_units =
      ((num_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * per_tile;
  // a row of a stage: the coordinates' copies (2 << shift floats) and the
  // weights' (1 << shift), each a power of two of them
  const int pt_shift = shift + 1 - (plan.vw_pts >> 1);
  const int wt_shift = shift - (plan.vw_wts >> 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < MSDA_FWD_STAGES; ++s) {
      barrier_init(smem_address(&full[s]), kThreads);
    }
  }
  __syncthreads();

  // Copies the coordinates and weights of unit q (a tile's chunk, in one
  // channel pass) into stage q % S; every thread arrives on its barrier.
  auto issue = [&](const int q) {
    const int tile_id = blockIdx.x + (q / per_tile) * gridDim.x;
    const int chunk = q % per_tile % plan.chunks;
    const int k0 = chunk * plan.chunk;
    const int kp = min(plan.chunk, LP - k0);
    const int s = q % MSDA_FWD_STAGES;
    float* const sp = stage_pts + s * entries * 2;
    float* const sw = stage_wts + s * entries;
    const int pts_end = tile << pt_shift;
    for (int e = threadIdx.x; e < pts_end + (tile << wt_shift);
         e += kThreads) {
      const bool is_pt = e < pts_end;
      const int e2 = is_pt ? e : e - pts_end;
      const int j = e2 >> (is_pt ? pt_shift : wt_shift);
      const int v = e2 - (j << (is_pt ? pt_shift : wt_shift));
      const int t = tile_id * tile + j;
      const int vw = is_pt ? plan.vw_pts : plan.vw_wts;
      if (t >= num_tasks || v * vw >= (is_pt ? 2 * kp : kp)) continue;
      const int64_t row = task_of(t, div, N, H, C, I).row;
      if (is_pt) {
        copy_async(smem_address(sp + (j << (shift + 1)) + v * vw),
                   pts + (row * LP + k0) * 2 + v * vw, vw);
      } else {
        copy_async(smem_address(sw + (j << shift) + v * vw),
                   wts + row * LP + k0 + v * vw, vw);
      }
    }
    arrive_after_copies(smem_address(&full[s]));
  };

  for (int s = 0; s < MSDA_FWD_STAGES && s < my_units; ++s) issue(s);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = 0; q < my_units; ++q) {
    const int tile_id = blockIdx.x + (q / per_tile) * gridDim.x;
    const int sub = q % per_tile;
    const int pass = sub / plan.chunks, chunk = sub % plan.chunks;
    const int k0 = chunk * plan.chunk;
    const int kp = min(plan.chunk, LP - k0);
    const int s = q % MSDA_FWD_STAGES;
    wait_phase(smem_address(&full[s]), (uint32_t)((q / MSDA_FWD_STAGES) & 1));

    // the geometry of the tile's points, once each
    const float* const sp = stage_pts + s * entries * 2;
    const float* const sw = stage_wts + s * entries;
    const int live = min(tile, num_tasks - tile_id * tile);
    for (int i = threadIdx.x; i < (live << shift); i += kThreads) {
      const int kk = i & (plan.stride - 1);
      if (kk >= kp) continue;
      const int l = divide(k0 + kk, div.p);
      const msda::Corners g = msda::corner_geometry(
          sp[2 * i], sp[2 * i + 1], levels.h[l], levels.w[l],
          levels.offset[l], zeros, align_corners);
      const float a = sw[i];
      corner_off[i] = make_int4(g.i00 * HC, g.i01 * HC, g.i10 * HC,
                                g.i11 * HC);
      corner_w[i] = make_float4(a * g.uy0 * g.vx0, a * g.uy0 * g.vx1,
                                a * g.uy1 * g.vx0, a * g.uy1 * g.vx1);
    }
    __syncthreads();  // the entries are written; stage s is free again
    if (q + MSDA_FWD_STAGES < my_units) issue(q + MSDA_FWD_STAGES);

    // the gather: a group its task, VEC channels a lane
    if (slot < live) {
      const Task task = task_of(tile_id * tile + slot, div, N, H, C, I);
      const T* const img_bh = img + task.img_offset;
      T* const out_row = out + (int64_t)task.row * C;
      const int4* const eo = corner_off + (slot << shift);
      const float4* const ew = corner_w + (slot << shift);
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
        if (whole || chunk == plan.chunks - 1) {
          store_vec<VEC>(out_row + c, acc);
        }
      }
    }
    __syncthreads();  // the entries are read before the next unit's
  }
}

// The prologue variant's reference points and how a point's offsets
// scale.
struct Queries {
  const float* ref;  // [B, N, R] f32, its last axis contiguous
  int64_t ref_sb;    // its batch stride in floats (0 for points that one
                     // [N, R] array gives every image)
  int64_t ref_sn;    // its query stride in floats
  int R;             // 2: (x, y) points; 4: (cx, cy, w, h) boxes
  bool detr;         // R = 2: x offsets divided by the level's width and
                     // y by its height; else x by the height, y by the
                     // width (msda-triton's order)
  float box_scale;   // R = 4: 1 / (2P), by which offset * size is
                     // multiplied (PyTorch's CUDA division by a host scalar
                     // multiplies by its reciprocal)
};

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

__device__ __forceinline__ float max_of(const float a, const float b) {
  return a < b ? b : a;  // torch.softmax's reduction
}

// K1 on the query projection's raw output: each task's softmax over its
// L * P attention logits and each point's sampling location are computed
// here, from q's rows staged in shared memory, where the module's chain
// wrote f32 points and weights to device memory for K1 to read back.
// q: [B, N, H, L, P, 3] T, contiguous (a point's x and y offsets and its
// attention logit); the reference points as Queries says; img: [B, I, H, C]
// T, out: [B, N, H, C] T.  A task's L * P points are its softmax's lanes
// (plan.stride of them, 3 to 32 points: msda::fwd_queries_plan), a point a
// thread, so that the softmax is a butterfly in registers and a lane places
// its own point after it.  Dynamic shared memory (plan.smem bytes): the
// tile's entries, corner offsets [T][stride] int4 and weights [T][stride]
// float4, then the stages' reference points [S][T][4] f32 and rows of q
// [S][T][3 * stride] T.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) msda_fwd_queries_kernel(
    const T* __restrict__ img, const T* __restrict__ q, T* __restrict__ out,
    const Queries qs, const LevelTable levels, const FwdQueriesPlan plan,
    const Divisors div, const int num_tasks, const int I, const int N,
    const int H, const int C, const int L, const int P, const bool zeros,
    const bool align_corners) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MSDA_FWD_STAGES];

  const int tile = plan.tile, G = plan.lanes, W = plan.stride;
  const int shift = __ffs(W) - 1;  // stride = 1 << shift
  const int entries = tile << shift;
  const int pitch = 3 << shift;  // values of a task's staged row of q
  int4* const corner_off = reinterpret_cast<int4*>(smem);
  float4* const corner_w = reinterpret_cast<float4*>(corner_off + entries);
  float* const stage_ref = reinterpret_cast<float*>(corner_w + entries);
  T* const stage_q =
      reinterpret_cast<T*>(stage_ref + MSDA_FWD_STAGES * tile * 4);

  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  const int slot = (threadIdx.x >> 5) * (32 / G) + group;  // task in a tile
  const int LP = L * P;
  const int HC = H * C;
  const int num_tiles = (num_tasks + tile - 1) / tile;
  const int my_tiles = (num_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  // a staged row takes 3 << q_shift copies of q (plan.q_bytes each) at
  // most, a reference point 1 << r_shift (plan.ref_floats each)
  const int q_vals = plan.q_bytes / (int)sizeof(T);  // values a copy
  const int q_shift = __ffs((W * (int)sizeof(T)) / plan.q_bytes) - 1;
  const int r_shift = __ffs(qs.R / plan.ref_floats) - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < MSDA_FWD_STAGES; ++s) {
      barrier_init(smem_address(&full[s]), kThreads);
    }
  }
  __syncthreads();

  // Copies the u-th tile's rows of q and its tasks' reference points into
  // stage u % S; every thread arrives on its barrier.
  auto issue = [&](const int u) {
    const int tile_id = blockIdx.x + u * gridDim.x;
    const int s = u % MSDA_FWD_STAGES;
    T* const sq = stage_q + s * tile * pitch;
    float* const sr = stage_ref + s * tile * 4;
    const int q_copies = 3 << q_shift;
    for (int e = threadIdx.x; e < tile * q_copies; e += kThreads) {
      const int j = (e >> q_shift) / 3;
      const int v = e - j * q_copies;
      const int t = tile_id * tile + j;
      if (t >= num_tasks || v * q_vals >= 3 * LP) continue;
      copy_async(smem_address(sq + j * pitch + v * q_vals),
                 reinterpret_cast<const float*>(
                     q + (int64_t)task_of(t, div, N, H, C, I).row * LP * 3 +
                     v * q_vals),
                 plan.q_bytes / 4);
    }
    for (int e = threadIdx.x; e < tile << r_shift; e += kThreads) {
      const int j = e >> r_shift;
      const int v = e - (j << r_shift);
      const int t = tile_id * tile + j;
      if (t >= num_tasks) continue;
      const int bh = divide(t, div.n);  // b * H + h
      const int b = divide(bh, div.h), n = t - bh * N;
      copy_async(smem_address(sr + j * 4 + v * plan.ref_floats),
                 qs.ref + b * qs.ref_sb + n * qs.ref_sn +
                     v * plan.ref_floats,
                 plan.ref_floats);
    }
    arrive_after_copies(smem_address(&full[s]));
  };

  for (int s = 0; s < MSDA_FWD_STAGES && s < my_tiles; ++s) issue(s);

  for (int u = 0; u < my_tiles; ++u) {
    const int tile_id = blockIdx.x + u * gridDim.x;
    const int s = u % MSDA_FWD_STAGES;
    wait_phase(smem_address(&full[s]), (uint32_t)((u / MSDA_FWD_STAGES) & 1));
    const T* const sq = stage_q + s * tile * pitch;
    const float* const sr = stage_ref + s * tile * 4;
    const int live = min(tile, num_tasks - tile_id * tile);

    // A thread an entry: the attention weight of its point as torch.softmax
    // forms it over the task's L * P logits (W lanes a task, a logit a
    // lane, then butterflies over the W lanes: the max, exp(x - max) with
    // the accurate expf, their sum, and exp(x - max) / sum; a lane past the
    // tile's tasks or a task's points holds -inf and 0, as torch.softmax's
    // padding), then the point's location in the module's chain's f32
    // operations and order, then K1's geometry and entry.
    for (int i0 = 0; i0 < entries; i0 += kThreads) {
      const int i = i0 + (int)threadIdx.x;
      const int j = i >> shift, k = i & (W - 1);
      const bool valid = j < live && k < LP;
      const T* const e = sq + j * pitch + 3 * k;
      const float x = valid ? to_float(e[2]) : neg_inf();
      float m = x;
      for (int o = W >> 1; o > 0; o >>= 1) {
        m = max_of(m, __shfl_xor_sync(MSDA_FULL_MASK, m, o, W));
      }
      const float ex = valid ? expf(__fsub_rn(x, m)) : 0.f;
      float sum = ex;
      for (int o = W >> 1; o > 0; o >>= 1) {
        sum = __fadd_rn(sum, __shfl_xor_sync(MSDA_FULL_MASK, sum, o, W));
      }
      if (!valid) continue;
      const float a = __fdiv_rn(ex, sum);
      const int l = divide(k, div.p);
      const float ox = to_float(e[0]), oy = to_float(e[1]);
      const float* const r = sr + 4 * j;
      float px, py;
      if (qs.R == 2) {  // ref + offset / normalizer
        const float hl = (float)levels.h[l], wl = (float)levels.w[l];
        px = __fadd_rn(r[0], __fdiv_rn(ox, qs.detr ? wl : hl));
        py = __fadd_rn(r[1], __fdiv_rn(oy, qs.detr ? hl : wl));
      } else {  // ref.xy + offset * ref.wh / (2P)
        px = __fadd_rn(r[0], __fmul_rn(__fmul_rn(ox, r[2]), qs.box_scale));
        py = __fadd_rn(r[1], __fmul_rn(__fmul_rn(oy, r[3]), qs.box_scale));
      }
      const msda::Corners g =
          msda::corner_geometry(px, py, levels.h[l], levels.w[l],
                                levels.offset[l], zeros, align_corners);
      corner_off[i] = make_int4(g.i00 * HC, g.i01 * HC, g.i10 * HC,
                                g.i11 * HC);
      corner_w[i] = make_float4(a * g.uy0 * g.vx0, a * g.uy0 * g.vx1,
                                a * g.uy1 * g.vx0, a * g.uy1 * g.vx1);
    }
    __syncthreads();  // the entries are written; stage s is free again
    if (u + MSDA_FWD_STAGES < my_tiles) issue(u + MSDA_FWD_STAGES);

    // the gather: a group its task, VEC channels a lane, as K1's (its
    // multiply-adds in the same point order)
    if (slot < live) {
      const Task task = task_of(tile_id * tile + slot, div, N, H, C, I);
      const T* const img_bh = img + task.img_offset;
      T* const out_row = out + (int64_t)task.row * C;
      const int4* const eo = corner_off + (slot << shift);
      const float4* const ew = corner_w + (slot << shift);
      for (int c = c_lane * VEC; c < C; c += G * VEC) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        const T* const base = img_bh + c;
        int k = 0;
        for (; k + MSDA_FWD_BATCH <= LP; k += MSDA_FWD_BATCH) {
          float4 w[MSDA_FWD_BATCH], v[MSDA_FWD_BATCH][4];
#pragma unroll
          for (int b = 0; b < MSDA_FWD_BATCH; ++b) {
            const int4 o = eo[k + b];
            w[b] = ew[k + b];
            v[b][0] = load_vec<VEC>(base + o.x);
            v[b][1] = load_vec<VEC>(base + o.y);
            v[b][2] = load_vec<VEC>(base + o.z);
            v[b][3] = load_vec<VEC>(base + o.w);
          }
#pragma unroll
          for (int b = 0; b < MSDA_FWD_BATCH; ++b) {
            add_point(acc, w[b], v[b][0], v[b][1], v[b][2], v[b][3]);
          }
        }
        for (; k < LP; ++k) {
          const int4 o = eo[k];
          add_point(acc, ew[k], load_vec<VEC>(base + o.x),
                    load_vec<VEC>(base + o.y), load_vec<VEC>(base + o.z),
                    load_vec<VEC>(base + o.w));
        }
        store_vec<VEC>(out_row + c, acc);
      }
    }
    __syncthreads();  // the entries are read before the next tile's
  }
}

// Lets a kernel use up to MSDA_FWD_SMEM_MAX bytes of dynamic shared memory
// a block, once a device.
template <auto Kernel>
int allow_shared() {
  static std::atomic<uint64_t> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = 1ull << (device & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MSDA_FWD_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit);
  }
  return (int)cudaSuccess;
}

// The persistent grid of a launch of Kernel with `smem` bytes a block over
// `tiles` tiles: MSDA_FWD_BLOCKS_PER_SM blocks a multiprocessor, fewer
// where they do not fit, and never more than the tiles.  Returns a
// cudaError_t.
template <auto Kernel>
int grid_blocks(const int smem, const int tiles, int* blocks) {
  int err = allow_shared<Kernel>();
  if (err != (int)cudaSuccess) return err;
  int resident = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, Kernel, kThreads, smem);
  if (err != (int)cudaSuccess) return err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int sms = multiprocessors();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int per_sm =
      resident < MSDA_FWD_BLOCKS_PER_SM ? resident : MSDA_FWD_BLOCKS_PER_SM;
  const int most = per_sm * sms;
  *blocks = tiles < most ? tiles : most;
  return (int)cudaSuccess;
}

template <typename T, int VEC>
int launch(const void* img, const void* pts, const void* wts, void* out,
           const LevelTable& levels, const FwdPlan& plan, int num_tasks,
           int I, int N, int H, int C, int L, int P, bool zeros,
           bool align_corners, cudaStream_t stream) {
  const int tiles = (num_tasks + plan.tile - 1) / plan.tile;
  int blocks = 0;
  const int err =
      grid_blocks<msda_fwd_kernel<T, VEC>>(plan.smem, tiles, &blocks);
  if (err != (int)cudaSuccess) return err;
  const Divisors div = {fast_div(N), fast_div(H), fast_div(P)};
  msda_fwd_kernel<T, VEC><<<blocks, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<T*>(out), levels, plan,
      div, num_tasks, I, N, H, C, L, P, zeros, align_corners);
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
             const LevelTable& levels, int num_tasks, int I, int N,
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

template <typename T, int VEC>
int launch_queries(const void* img, const void* q, void* out,
                   const Queries& qs, const LevelTable& levels,
                   const FwdQueriesPlan& plan, int num_tasks, int I, int N,
                   int H, int C, int L, int P, bool zeros, bool align_corners,
                   cudaStream_t stream) {
  const int tiles = (num_tasks + plan.tile - 1) / plan.tile;
  int blocks = 0;
  const int err = grid_blocks<msda_fwd_queries_kernel<T, VEC>>(
      plan.smem, tiles, &blocks);
  if (err != (int)cudaSuccess) return err;
  const Divisors div = {fast_div(N), fast_div(H), fast_div(P)};
  msda_fwd_queries_kernel<T, VEC><<<blocks, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(q),
      static_cast<T*>(out), qs, levels, plan, div, num_tasks, I, N, H, C, L,
      P, zeros, align_corners);
  return (int)cudaGetLastError();
}

// As plan_for, with q's values of T and the reference points' base and
// strides (floats) setting the copy widths.
template <typename T>
FwdQueriesPlan queries_plan_for(const void* img, const void* q,
                                const float* ref, int64_t ref_sb,
                                int64_t ref_sn, int C, int L, int P, int R) {
  const bool v4 = msda::vec4<T>(C, img);
  const int vec = v4 ? 4 : 1;
  const uintptr_t ref_bits = reinterpret_cast<uintptr_t>(ref) |
                             (uintptr_t)(ref_sb * 4) | (uintptr_t)(ref_sn * 4);
  return msda::fwd_queries_plan(
      L, P, msda::group_lanes(C, vec), vec, (int)sizeof(T),
      msda::fwd_alignment(reinterpret_cast<uintptr_t>(q)), R,
      msda::fwd_alignment(ref_bits));
}

template <typename T>
int dispatch_queries(const void* img, const void* q, void* out,
                     const Queries& qs, const LevelTable& levels,
                     int num_tasks, int I, int N, int H, int C, int L, int P,
                     bool zeros, bool align_corners, cudaStream_t stream) {
  const FwdQueriesPlan plan = queries_plan_for<T>(
      img, q, qs.ref, qs.ref_sb, qs.ref_sn, C, L, P, qs.R);
  // the shapes the variant does not take (its plan's smem 0) run the chain
  // and K1 (models/attention.py); the wrapper refuses them first
  if (plan.smem == 0) return (int)cudaErrorInvalidConfiguration;
  if (plan.vec == 4) {
    return launch_queries<T, 4>(img, q, out, qs, levels, plan, num_tasks, I,
                                N, H, C, L, P, zeros, align_corners, stream);
  }
  return launch_queries<T, 1>(img, q, out, qs, levels, plan, num_tasks, I, N,
                              H, C, L, P, zeros, align_corners, stream);
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
  // a task a (b, n, h); past 2^31 - 1 the output would be too (C >= 1)
  const int64_t tasks = (int64_t)B * N * H;
  if (tasks == 0) return (int)cudaSuccess;
  if (tasks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int num_tasks = (int)tasks;

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

// The prologue variant: K1 on the query projection's output q [B, N, H, L,
// P, 3] (dtype as img's) and reference points ref [B, N, R] f32 (R = 2 or
// 4; ref_sb and ref_sn its batch and query strides in floats, its last
// axis contiguous).  detr: 2-coordinate offsets divided by (w, h), else by
// (h, w).  Otherwise as msda_fwd_launch.
int msda_fwd_queries_launch(int dtype, const void* img, const void* q,
                            const void* ref, void* out,
                            const void* level_hw, int B, int I, int N, int H,
                            int C, int L, int P, int R, long long ref_sb,
                            long long ref_sn, int detr, int zeros,
                            int align_corners, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || C < 1 || (R != 2 && R != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  LevelTable levels;
  const int64_t pixels =
      msda::fill_levels(levels, static_cast<const int*>(level_hw), L);
  if (pixels != I) return (int)cudaErrorInvalidValue;
  const int64_t tasks = (int64_t)B * N * H;
  if (tasks == 0) return (int)cudaSuccess;
  if (tasks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int num_tasks = (int)tasks;

  Queries qs;
  qs.ref = static_cast<const float*>(ref);
  qs.ref_sb = ref_sb;
  qs.ref_sn = ref_sn;
  qs.R = R;
  qs.detr = detr != 0;
  qs.box_scale = 1.0f / (float)(2 * P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool z = zeros != 0;
  const bool ac = align_corners != 0;
  switch (dtype) {
    case 0:
      return dispatch_queries<float>(img, q, out, qs, levels, num_tasks, I,
                                     N, H, C, L, P, z, ac, s);
    case 1:
      return dispatch_queries<__half>(img, q, out, qs, levels, num_tasks, I,
                                      N, H, C, L, P, z, ac, s);
    case 2:
      return dispatch_queries<__nv_bfloat16>(img, q, out, qs, levels,
                                             num_tasks, I, N, H, C, L, P, z,
                                             ac, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The plan of a msda_fwd_queries_launch on these arguments, written into
// plan[7] in FwdQueriesPlan's order (smem 0: a shape the variant does not
// take).  Returns cudaErrorInvalidValue for a dtype or shape that launch
// refuses.
int msda_fwd_queries_plan(int dtype, const void* img, const void* q,
                          const void* ref, long long ref_sb,
                          long long ref_sn, int C, int L, int P, int R,
                          int* plan) {
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || C < 1 || (R != 2 && R != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* r = static_cast<const float*>(ref);
  FwdQueriesPlan p;
  switch (dtype) {
    case 0:
      p = queries_plan_for<float>(img, q, r, ref_sb, ref_sn, C, L, P, R);
      break;
    case 1:
      p = queries_plan_for<__half>(img, q, r, ref_sb, ref_sn, C, L, P, R);
      break;
    case 2:
      p = queries_plan_for<__nv_bfloat16>(img, q, r, ref_sb, ref_sn, C, L, P,
                                          R);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int fields[7] = {p.lanes,   p.vec,        p.tile, p.stride,
                         p.q_bytes, p.ref_floats, p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = fields[i];
  return (int)cudaSuccess;
}

}  // extern "C"
