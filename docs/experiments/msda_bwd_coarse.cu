// EXPERIMENT, not built by the package: K2 with its coarse levels as
// tensor-core contractions beside the gather form, a variant of
// msda_tpu_torch/csrc/msda_bwd.cu that measured slower than the gather
// form at every shape (PERF.md).  It keeps the entry point's C signature
// (msda_bwd_launch), so docs/experiments/torch_bwd_coarse_ablation.py
// builds it (with -I msda_tpu_torch/csrc) and swaps it in behind
// ops/cuda_bwd.py's wrapper.  Its plan's constants are fixed below;
// MSDA_COARSE_PIXELS may be set by the ablation's variants.
//
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
// Why two forms (NVIDIA H100 80GB HBM3, 700.00 W; docs/experiments/
// torch_bwd_breakdown.py on the gather-only K2 of commit de67cc6, each
// level's points alone, CUDA events around the wrapper).  At Deformable
// DETR's encoder shape (levels 100x167, 50x84, 25x42, 13x21, batch 2, 8
// heads, 22,223 queries) on the model's own points, f32: 1.2966 ms in all,
// 0.7720 without any img_grad atomic.  Level 3 (273 pixels a (b, h), about
// 1,300 adds on each pixel row) took 0.5184 ms with its adds and 0.2281
// without; level 2 (1,050 pixels, ~340 adds) 0.3932 / 0.2290; levels 1 and
// 0 (4,200 and 16,700 pixels, ~85 and ~21 adds) 0.3480 / 0.2335 and 0.3580
// / 0.2379.  Without the adds of levels 2-3 alone: 0.8819.  So the adds of
// the levels whose pixels each take many of them are a third of the
// kernel, and those levels are small.  At the decoder (300 queries) no
// level or add moved the time (0.08-0.09 ms, host-bound).
//
// Design.  The plan (coarse_plan) is
// made from the shapes alone, so a captured step replays it: a level is
// coarse where C <= 32, it has at most MSDA_COARSE_PIXELS pixels, its
// points put MSDA_COARSE_ADDS adds or more on each pixel on average (N * P
// / pixels) and its block fits in shared memory: with MSDA_COARSE_PIXELS
// at 1088 the encoder's levels 2 and 3, none of the decoder's; with 0, no
// level.  Two kernels, launched one after the other
// on the stream by one call, each where a level of its kind exists:
//   * msda_bwd_gather_kernel, the fine levels: the gather form (the
//     shipped K2), a group of G lanes per (b, n, h) task, VEC = 4 channels a lane
//     (16-byte loads in f32, 8 in the half types), four corner dot
//     products a point summed in f64, one 16-byte vector atomic a corner
//     into an f32 img_grad buffer that the wrapper zeroes (and casts to
//     img's type afterwards for bf16 and f16);
//   * msda_bwd_coarse_kernel, the coarse levels, as the TPU kernel serves
//     every level: per (b, h), pixel tile and range of queries, img_grad of
//     the tile = A^T . out_grad, A[query, pixel] the query's bilinear x
//     attention weights on the pixel, contracted on the tensor cores
//     (mma.sync) into registers and added to img_grad once a block, with no
//     per-point atomics (see the kernel's comment for its steps).  Its
//     point and weight gradients come from the img rows it stages in
//     shared memory, as the gather form computes them (f64 corner dot
//     products, exact to the f32 bar without a precision argument): a
//     G = E . out_grad^T product on the tensor cores (the TPU kernel's)
//     would do 16 (level 2) to 4 (level 3) times the multiplies of the
//     points' own corners, and with split operands in place of f64 sums.
// Where C is not a multiple of 4 or img / out_grad are not aligned for the
// vector loads, the gather kernel runs with VEC = 1 (one channel a lane),
// and the coarse kernel reads its staged rows one channel a lane where C
// is not.  A channel count past G * VEC loops in the gather kernel.  Groups
// past the ragged end of the task axis compute on the last task and write
// nothing, so that every lane takes part in the butterflies.  The order of
// the atomic adds changes from run to run, so img_grad differs in its last
// bits between runs.
//
// Precision.  The point gradients are sums over channels of terms as large
// as (level width) * |out_grad * img|, which cancel: at the encoder's widths
// an f32 sum keeps only about 5e-5 of the result, whatever its order.  So
// both kernels sum the corner dot products in f64 (each product of two f32
// values is exact in f64), combine them in f64 and round once.  The
// geometry (dx, dy) stays the f32 geometry of the forward, so the result is
// the gradient of the function K1 computes.  img_grad in the coarse kernel:
// 3xTF32 in f32 (the bf16 "x3" split keeps 16 bits an operand, and on a
// pixel that sums a whole (b, h), 12,000 terms that cancel to about 1,
// reads 7e-5 to 1.2e-4 of the 1e-4 bar),
// the half types' two-way split of A in their own type.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 6 and
// docs/experiments/torch_bwd_coarse_ablation.py, device ms a call by
// kernel).  The coarse kernel loses to the gather form everywhere:
//   * encoder, levels 2-3 coarse: 3.3257 ms a call in f32 (coarse kernel
//     2.2828, gather kernel on levels 0-1 0.6664) against 1.3504 for the
//     default build, 2.5844 against 1.2507 in bf16; the model's own points
//     2.3069 against 1.3174 (f32) and 2.1773 against 1.3516 (bf16); level
//     3 alone 1.8475 (f32); the reference workload 1.5010 against 1.0774;
//   * what it spends (encoder, uniform points, f32, the coarse kernel's
//     2.5222 ms): without its point gradients 1.8385, without its
//     tensor-core products 1.3679, without its A entries (and so its
//     products) 1.2595.  Each part costs more than the gather form spends
//     on the same points with their atomics (its levels 2-3: about 0.6 ms):
//     a chunk of 32 queries passes three barriers with most warps idle in
//     each phase, 16 warps an SM (128 registers, a few bytes of spills,
//     about 100 KB of shared memory a block), and the dense product runs
//     every pixel of the tile for every query: 16 (b, h) x 695 chunks x 84
//     m-tiles x 48 TF32 products of 16x8x8 for levels 2-3, 91.8 GFLOP in
//     the 1.15 ms that the products cost, 16% of the card's 495 TFLOP/s;
//   * it is the more exact form where a whole (b, h) lands on one pixel:
//     img_grad's error against native_msda_backward on levels 2 and 3 of
//     the encoder, 22,223 queries of 4 points all at one place, 2.05e-5
//     and 1.37e-5 of max(1, |ref|), where the gather form's f32 atomics
//     read 1.34e-4 and 1.23e-4 (de67cc6's: 1.67e-4, 1.60e-4), past the
//     1e-4 bar.
// So the shipped K2 keeps the gather kernel alone (this variant with
// MSDA_COARSE_PIXELS 0 runs it on every level): 1.2897 ms at the encoder on the model's points
// in f32, 1.2930 in bf16 (de67cc6's K2 1.2907, 1.2938 in the same run),
// 6.0% of its bytes bound (0.0815 ms) in f32.  The gather kernel takes 64
// to 96 registers and no spills.  16-byte loads in the half types (8
// channels a lane, G = 4, two 16-byte atomics a corner) took 2.1523 ms
// against 1.1960 in bf16 at the encoder: the half types keep 4 channels a
// lane.
//
// Interface: a plain C entry point (msda_bwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_bwd.py.  It launches
// on the given stream (the gather kernel, then the coarse kernel, each
// where a level of its kind exists), does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <type_traits>

#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

// warps a block of this form's kernels (the lane-group K2's constant, which
// the shared headers no longer carry)
#ifndef MSDA_WARPS_PER_BLOCK
#define MSDA_WARPS_PER_BLOCK 8
#endif

// A level of at most this many pixels is coarse (where C <= 32) ...: 1088
// takes Deformable DETR's two smallest levels, 300 level 3 alone, 0 none.
#ifndef MSDA_COARSE_PIXELS
#define MSDA_COARSE_PIXELS 1088
#endif
// ... where its points put at least this many img_grad adds on each of its
// pixels on average (N * P / pixels: the gather form's contention)
#define MSDA_COARSE_ADDS 64
// 16-pixel row tiles of img_grad that a warp of the coarse kernel holds.
#define MSDA_COARSE_MTILES 2
// The coarse grid's size the query split aims at (8 blocks an SM of 132).
#define MSDA_COARSE_BLOCKS 1056

namespace {

using msda::add_grad;
using msda::corner_dots;
using msda::group_sum;
using msda::LevelTable;
using msda::load_vec;
using msda::point_sums;

// ---------------------------------------------------------------------------
// The gather kernel (the fine levels).

// img, og: [B, I, H, C] and [B, N, H, C] in T; pts [B, N, H, L, P, 2] and
// wts [B, N, H, L, P] in f32; img_grad [B, I, H, C] f32 (zeroed), pts_grad
// and wts_grad f32 like pts and wts.  All contiguous.  Walks the levels
// that `coarse` (a bit a level) leaves out.
template <typename T, int VEC>
__global__ void __launch_bounds__(MSDA_WARPS_PER_BLOCK * 32)
    msda_bwd_gather_kernel(const T* __restrict__ img,
                           const float* __restrict__ pts,
                           const float* __restrict__ wts,
                           const T* __restrict__ og,
                           float* __restrict__ img_grad,
                           float* __restrict__ pts_grad,
                           float* __restrict__ wts_grad,
                           const LevelTable levels, const unsigned coarse,
                           const int64_t num_tasks, const int I, const int N,
                           const int H, const int C, const int L, const int P,
                           const int G, const bool zeros,
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
    if ((coarse >> l) & 1u) continue;  // the coarse kernel's level
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

// ---------------------------------------------------------------------------
// The coarse kernel (the levels of at most MSDA_COARSE_PIXELS pixels).

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 32;           // channels a block holds: 4 n-tiles of 8
constexpr int kNTiles = kMaxC / 8;
constexpr int kQueries = 32;        // queries a chunk: 2 k-steps of 16
constexpr int kKSteps = kQueries / 16;
constexpr int kMTiles = MSDA_COARSE_MTILES;
constexpr int kTilePixels = kWarps * kMTiles * 16;  // pixels a block holds
// f32 takes TF32 products, the half types their own 16-bit ones
template <typename T>
constexpr bool kTF32 = std::is_same<T, float>::value;
// the row pitch (elements) of the A and O tiles: the TF32 fragments load
// single words (a pitch of 4 mod 32 words is free of bank conflicts), the
// 16-bit ones pairs of A's words (8 mod 32)
template <typename T>
constexpr int kPitch = kTF32<T> ? kQueries + 4 : kQueries + 8;
template <typename T>
constexpr int kATileBytes = kTilePixels * kPitch<T> * 4;
// the O tile: f32 for TF32, T otherwise
template <typename T>
constexpr int kOTileBytes = kMaxC * kPitch<T> * (kTF32<T> ? 4 : 2);
// a point's record: 4 corners, 9 factors and its query
constexpr int kRecordWords = 14;
// shared words a point of a chunk: its record, twice (this chunk's and the
// last one's, whose A entries are set back to 0 while this one's records
// are made), and a slot of the list of the points whose dot products the
// block takes
constexpr int kGeoWords = 2 * kRecordWords + 1;
constexpr int kStages = 3;  // a chunk served, two in flight
constexpr int kMinChunks = 4;  // the fewest chunks the plan gives a block

// What the host decides from the shapes: the coarse levels, the pixel tiles
// of each and the split of the queries.  Block x serves coarse level i where
// first[i] <= x < first[i + 1], numbered ((b * H + h) * tiles + tile) *
// q_split + query range.
struct CoarsePlan {
  int count;
  int level[MSDA_MAX_LEVELS];
  int tiles[MSDA_MAX_LEVELS];
  int first[MSDA_MAX_LEVELS + 1];
  int q_split;
  int chunks;  // query chunks of kQueries
};

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(smem_dst)),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_address(smem_dst)),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Sum over the G lanes of a group whose lanes are `mask` (G a power of two;
// only the group's lanes call it).
template <typename F>
__device__ __forceinline__ F masked_group_sum(F v, const int G,
                                              const unsigned mask) {
  for (int s = G >> 1; s > 0; s >>= 1) v += __shfl_xor_sync(mask, v, s);
  return v;
}

template <typename T>
__device__ __forceinline__ uint16_t bits16(const float v) {
  const T t = msda::from_float<T>(v);
  return *reinterpret_cast<const uint16_t*>(&t);
}

// The two-way split of an f32 value into TF32: big = tf32(v), small =
// tf32(v - big), rounded to nearest (ties away); big + small holds about 22
// bits of v.
__device__ __forceinline__ void split_tf32(const float v, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(v - __uint_as_float(big)));
}

// d += a (16 x 8, row-major) . b (8 x 8, column-major) in TF32, f32
// accumulators.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two-way split of two f32 values into T (bf16 or f16): hi = T(v), lo
// = T(v - hi), one register each (the lower index in the low half): about
// 16 bits of v in bf16, 22 in f16.
template <typename T>
__device__ __forceinline__ void split2(const float2 v, uint32_t& hi,
                                       uint32_t& lo) {
  const T hx = msda::from_float<T>(v.x), hy = msda::from_float<T>(v.y);
  const float rx = v.x - msda::to_float(hx), ry = v.y - msda::to_float(hy);
  hi = (uint32_t)*reinterpret_cast<const uint16_t*>(&hx) |
       ((uint32_t)*reinterpret_cast<const uint16_t*>(&hy) << 16);
  lo = (uint32_t)bits16<T>(rx) | ((uint32_t)bits16<T>(ry) << 16);
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), f32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// The shared memory of a coarse block, in bytes from its start: the A tile
// [kTilePixels][kPitch] f32, the O tile [kMaxC][kPitch] (f32, or T), the
// points' records [2][kRecordWords][kQueries * P], the list [kQueries * P]
// and two sets of two counters (the points listed, the m-tiles that A's
// entries reach), kStages input buffers (a chunk's
// points [kQueries * P][2] and weights [kQueries * P] on the level, f32,
// and out_grad rows [kQueries][C] in T) and the staged img rows
// [rows][C] in T, each part 16-byte aligned.
struct CoarseSmem {
  int o_tile, geo, input, input_bytes, e_tile, total;
};

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline CoarseSmem coarse_layout(int P, int C,
                                                    int rows) {
  CoarseSmem m;
  m.o_tile = kATileBytes<T>;
  m.geo = m.o_tile + kOTileBytes<T>;
  m.input = m.geo + align16(kGeoWords * kQueries * P * 4) + 32;
  m.input_bytes = align16(kQueries * P * 3 * 4) +
                  align16(kQueries * C * (int)sizeof(T));
  m.e_tile = m.input + kStages * m.input_bytes;
  m.total = m.e_tile + align16(rows * C * (int)sizeof(T));
  return m;
}

// Starts the copies of chunk n0's inputs on level l into a buffer and
// commits them as one group: per query its P points and weights and its
// out_grad row, by kThreads / kQueries threads a query; out_grad in
// 16-byte pieces (og_mode 2), 4-byte words (1) or, where its rows are not
// whole words, by plain loads (0).  Queries past N are left out.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    unsigned char* buf, const float* __restrict__ pts,
    const float* __restrict__ wts, const T* __restrict__ og,
    const int64_t n0, const int N, const int64_t b, const int h,
    const int H, const int L, const int P, const int l, const int C,
    const int og_mode) {
  constexpr int kPer = kThreads / kQueries;
  const int q = threadIdx.x / kPer, r = threadIdx.x % kPer;
  if (n0 + q < N) {
    const int64_t task = (b * N + n0 + q) * H + h;
    const int64_t t = task * L + l;
    float* s_pts = reinterpret_cast<float*>(buf) + q * 2 * P;
    float* s_wts = reinterpret_cast<float*>(buf) + kQueries * 2 * P + q * P;
    for (int i = r; i < 2 * P; i += kPer) {
      cp_async4(s_pts + i, pts + t * 2 * P + i);
    }
    for (int i = r; i < P; i += kPer) cp_async4(s_wts + i, wts + t * P + i);
    unsigned char* s_og = buf + align16(kQueries * P * 3 * 4) +
                          q * C * (int)sizeof(T);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(og + task * C);
    const int bytes = C * (int)sizeof(T);
    if (og_mode == 2) {
      for (int i = 16 * r; i < bytes; i += 16 * kPer) {
        cp_async16(s_og + i, src + i);
      }
    } else if (og_mode == 1) {
      for (int i = 4 * r; i < bytes; i += 4 * kPer) cp_async4(s_og + i, src + i);
    } else {
      for (int i = r; i < C; i += kPer) {
        reinterpret_cast<T*>(s_og)[i] = og[task * C + i];
      }
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One block: level l of one (b, h), the img_grad rows of one pixel tile
// [p0, p1) of it, and the queries of one range, kQueries at a time.  The
// img rows [p0, min(p1 + w + 1, S)) are staged once: the tile and every
// corner of a point whose top-left corner lies in it.  Per chunk, while the
// next two chunks' points, weights and out_grad rows are copied in:
//   1. one thread a point: its geometry (msda::corner_geometry) into a
//      record in shared memory, and the list of the points whose top-left
//      corner lies in the tile; the out_grad rows into the O tile;
//   2. one thread a point: its four lerp weights a * (corner weight) added
//      into A[pixel][query] for the corners in the tile (shared atomics:
//      the points of a query may share a pixel); and, one group of G lanes
//      a listed point, the four corner dot products from the staged rows
//      in f64 and the point and weight gradients (msda_lanes.cuh
//      corner_dots, point_sums);
//   3. each warp contracts its m-tiles of A with the O tile on the tensor
//      cores, img_grad[tile pixels, 0:32] += A . O, each operand split two
//      ways and the product of the two small parts dropped: f32 as 3xTF32
//      (big + small hold about 22 bits of each operand; the two-way bf16
//      split of msda_tpu's "x3" holds 16, which on a pixel that gathers a
//      whole (b, h) is past the 1e-4 bar), the half types as (A_hi + A_lo)
//      O in their own type (out_grad is exact).  The large parts'
//      products start from zero and are added to the block's sums in f32,
//      m-tiles that no entry of A reaches skipped;
//   and, in the next chunk's step 1, the A entries of step 2 are set back
//   to 0 (three barriers a chunk).
// At the end each warp adds its sums to img_grad, one f32 atomic pair an
// element (q_split blocks add into each element).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    msda_bwd_coarse_kernel(const T* __restrict__ img,
                           const float* __restrict__ pts,
                           const float* __restrict__ wts,
                           const T* __restrict__ og,
                           float* __restrict__ img_grad,
                           float* __restrict__ pts_grad,
                           float* __restrict__ wts_grad,
                           const LevelTable levels, const CoarsePlan plan,
                           const int I, const int N, const int H, const int C,
                           const int L, const int P, const int G,
                           const bool zeros, const bool align_corners,
                           const bool stage16, const int og_mode) {
  constexpr int kP = kPitch<T>;
  extern __shared__ __align__(16) unsigned char smem[];

  int li = 0;
  while ((int)blockIdx.x >= plan.first[li + 1]) ++li;
  int rest = (int)blockIdx.x - plan.first[li];
  const int qs = rest % plan.q_split;
  rest /= plan.q_split;
  const int tiles = plan.tiles[li];
  const int tile = rest % tiles;
  const int bh = rest / tiles;
  const int h = bh % H;
  const int64_t b = bh / H;
  const int l = plan.level[li];
  const int hl = levels.h[l], wl = levels.w[l], off = levels.offset[l];
  const int S = hl * wl;
  const int M = (S + 15) / 16;
  const int mt0 = tile * M / tiles, mt1 = (tile + 1) * M / tiles;
  const int p0 = mt0 * 16, p1 = min(mt1 * 16, S);
  const int pixels = p1 - p0;
  const int e_rows = min(p1 + wl + 1, S) - p0;
  const int64_t ch0 = (int64_t)qs * plan.chunks / plan.q_split;
  const int64_t ch1 = (int64_t)(qs + 1) * plan.chunks / plan.q_split;

  const CoarseSmem lay = coarse_layout<T>(P, C, 0);
  float* a_tile = reinterpret_cast<float*>(smem);
  unsigned char* o_tile = smem + lay.o_tile;
  const int KP = kQueries * P;  // a chunk's points
  // a record set: [0, 4 KP) the corners, [4 KP, 13 KP) the factors (as
  // floats), [13 KP, 14 KP) the point's query in the chunk
  int* const records = reinterpret_cast<int*>(smem + lay.geo);
  int* const owned = records + 2 * kRecordWords * KP;  // the points listed
  // a set a chunk, by parity: [0] the points listed, [1] a bit an m-tile of
  // the tile that A reaches
  int* const counter_sets = reinterpret_cast<int*>(smem + lay.input - 32);
  T* e_tile = reinterpret_cast<T*>(smem + lay.e_tile);

  const int64_t HC = (int64_t)H * C;
  const int64_t base = b * (int64_t)I * HC + (int64_t)h * C;

  // zero the A and O tiles; stage the img rows and the first chunk
  for (int i = threadIdx.x; i < lay.geo / 16; i += kThreads) {
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x < 4) counter_sets[threadIdx.x] = 0;
  const T* e_src = img + base + (int64_t)(off + p0) * HC;
  if (stage16) {
    constexpr int kPer = 16 / sizeof(T);
    const int pieces = C / kPer;
    for (int i = threadIdx.x; i < e_rows * pieces; i += kThreads) {
      const int r = i / pieces, k = (i - r * pieces) * kPer;
      cp_async16(e_tile + r * C + k, e_src + r * HC + k);
    }
  } else {
    for (int i = threadIdx.x; i < e_rows * C; i += kThreads) {
      const int r = i / C;
      e_tile[i] = e_src[r * HC + (i - r * C)];
    }
  }
  for (int s = 0; s < kStages - 1; ++s) {  // a group each, maybe empty
    if (ch0 + s < ch1) {
      stage_chunk<T>(smem + lay.input + s * lay.input_bytes, pts, wts, og,
                     (ch0 + s) * kQueries, N, b, h, H, L, P, l, C, og_mode);
    } else {
      cp_async_commit();
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = threadIdx.x / G, c_lane = threadIdx.x % G;
  const int groups = kThreads / G;
  const unsigned gmask =
      G == 32 ? MSDA_FULL_MASK : (((1u << G) - 1u) << (lane & ~(G - 1)));
  const int c0 = c_lane * VEC;
  const int LP = L * P;
  const float xscale = (float)(align_corners ? wl - 1 : wl);
  const float yscale = (float)(align_corners ? hl - 1 : hl);

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][nt][j] = 0.f;
    }
  }

  for (int64_t chunk = ch0; chunk < ch1; ++chunk) {
    const int64_t n0 = chunk * kQueries;
    const int valid = (int)min((int64_t)kQueries, (int64_t)N - n0);
    unsigned char* in =
        smem + lay.input + (int)((chunk - ch0) % kStages) * lay.input_bytes;
    const float* s_pts = reinterpret_cast<const float*>(in);
    const float* s_wts = s_pts + KP * 2;
    const T* s_og =
        reinterpret_cast<const T*>(in + align16(KP * 3 * 4));
    const int parity = (int)((chunk - ch0) & 1);
    int* const geo_k = records + parity * kRecordWords * KP;
    const float* const geo_f = reinterpret_cast<const float*>(geo_k + 4 * KP);
    int* const geo_q = geo_k + 13 * KP;
    int* const counters = counter_sets + 2 * parity;
    // the last chunk's records
    const int* const last_k = records + (1 - parity) * kRecordWords * KP;
    const int* const last_q = last_k + 13 * KP;
    const int last_points =
        chunk > ch0 ? (int)min((int64_t)kQueries, (int64_t)N - n0 +
                                                      kQueries) * P
                    : 0;
    cp_async_wait_one();  // this chunk's group, not the next one's
    __syncthreads();  // and the last chunk's products are in registers
    // two chunks ahead, into the buffer read before the barrier
    if (chunk + kStages - 1 < ch1) {
      stage_chunk<T>(smem + lay.input + (int)((chunk + kStages - 1 - ch0) %
                                              kStages) * lay.input_bytes,
                     pts, wts, og, n0 + (kStages - 1) * kQueries, N, b, h, H,
                     L, P, l, C, og_mode);
    } else {
      cp_async_commit();
    }

    // 1. the last chunk's A entries back to 0 and its counters; the
    // points' records, and the list of the points whose top-left corner
    // lies in the tile (whole warps, so that a warp appends its points with
    // one shared atomic); the O tile
    if (threadIdx.x < 2) counter_sets[2 * (1 - parity) + threadIdx.x] = 0;
    for (int j = threadIdx.x; j < last_points; j += kThreads) {
      const int q = last_q[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = last_k[c * KP + j];
        if (k >= 0 && k < pixels) a_tile[k * kP + q] = 0.f;
      }
    }
    for (int j0 = threadIdx.x - lane; j0 < KP; j0 += kThreads) {
      const int j = j0 + lane;
      bool mine = false;
      if (j < valid * P) {
        const msda::Corners g = msda::corner_geometry(
            s_pts[2 * j], s_pts[2 * j + 1], hl, wl, off, zeros,
            align_corners);
        const int k00 = g.i00 - off - p0;
        mine = k00 >= 0 && k00 < pixels;
        geo_q[j] = j / P;
        geo_k[j] = k00;
        geo_k[KP + j] = g.i01 - off - p0;
        geo_k[2 * KP + j] = g.i10 - off - p0;
        geo_k[3 * KP + j] = g.i11 - off - p0;
        const float f[9] = {s_wts[j], g.vx0, g.vx1, g.uy0, g.uy1,
                            g.mx0,    g.mx1, g.my0, g.my1};
        float* const rec_f = reinterpret_cast<float*>(geo_k + 4 * KP);
#pragma unroll
        for (int k = 0; k < 9; ++k) rec_f[k * KP + j] = f[k];
      } else if (j < KP) {  // past N: no corner in any tile
#pragma unroll
        for (int k = 0; k < 4; ++k) geo_k[k * KP + j] = -1;
      }
      const unsigned ballot = __ballot_sync(MSDA_FULL_MASK, mine);
      int at = 0;
      if (lane == 0 && ballot != 0u) at = atomicAdd(counters, __popc(ballot));
      at = __shfl_sync(MSDA_FULL_MASK, at, 0);
      if (mine) owned[at + __popc(ballot & ((1u << lane) - 1u))] = j;
    }
    for (int i = threadIdx.x; i < kQueries * kMaxC; i += kThreads) {
      const int q = i / kMaxC, c = i - q * kMaxC;
      const float v = q < valid && c < C ? msda::to_float(s_og[q * C + c])
                                         : 0.f;
      if constexpr (kTF32<T>) {
        reinterpret_cast<float*>(o_tile)[c * kP + q] = v;
      } else {
        reinterpret_cast<uint16_t*>(o_tile)[c * kP + q] = bits16<T>(v);
      }
    }
    __syncthreads();

    // 2. the A tile and the m-tiles it reaches (whole warps); the point and
    // weight gradients of the listed points, a group of G lanes each
    for (int j0 = threadIdx.x - lane; j0 < valid * P; j0 += kThreads) {
      const int j = j0 + lane;
      unsigned reached = 0u;
      if (j < valid * P) {
        const int q = geo_q[j];
        const float a = geo_f[j];
        const float w[4] = {a * (geo_f[3 * KP + j] * geo_f[KP + j]),
                            a * (geo_f[3 * KP + j] * geo_f[2 * KP + j]),
                            a * (geo_f[4 * KP + j] * geo_f[KP + j]),
                            a * (geo_f[4 * KP + j] * geo_f[2 * KP + j])};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = geo_k[c * KP + j];
          if (w[c] != 0.f && k >= 0 && k < pixels) {
            atomicAdd(a_tile + k * kP + q, w[c]);
            reached |= 1u << (k >> 4);
          }
        }
      }
      reached = __reduce_or_sync(MSDA_FULL_MASK, reached);
      if (lane == 0 && reached != 0u) {
        atomicOr(reinterpret_cast<unsigned*>(counters + 1), reached);
      }
    }
    const int listed = counters[0];
    for (int e = group; e < listed; e += groups) {
      const int j = owned[e];
      const int k00 = geo_k[j];
      const int q = geo_q[j];
      double dots[4] = {0.0, 0.0, 0.0, 0.0};
      if (c0 < C) {
        corner_dots<VEC>(load_vec<VEC>(s_og + q * C + c0),
                         load_vec<VEC>(e_tile + k00 * C + c0),
                         load_vec<VEC>(e_tile + geo_k[KP + j] * C + c0),
                         load_vec<VEC>(e_tile + geo_k[2 * KP + j] * C + c0),
                         load_vec<VEC>(e_tile + geo_k[3 * KP + j] * C + c0),
                         dots);
      }
      float sum_w;
      double sum_x, sum_y;
      point_sums(dots, geo_f[KP + j], geo_f[2 * KP + j], geo_f[3 * KP + j],
                 geo_f[4 * KP + j], geo_f[5 * KP + j], geo_f[6 * KP + j],
                 geo_f[7 * KP + j], geo_f[8 * KP + j], sum_w, sum_x, sum_y);
      sum_w = masked_group_sum(sum_w, G, gmask);
      sum_x = masked_group_sum(sum_x, G, gmask);
      sum_y = masked_group_sum(sum_y, G, gmask);
      if (c_lane == 0) {
        const double a = geo_f[j];
        const int64_t k =
            ((b * N + n0 + q) * H + h) * LP + l * P + (j - q * P);
        wts_grad[k] = sum_w;
        pts_grad[2 * k] = (float)(a * xscale * sum_x);
        pts_grad[2 * k + 1] = (float)(a * yscale * sum_y);
      }
    }
    __syncthreads();

    // 3. img_grad[tile] += A . O on the tensor cores; m-tiles that no entry
    // of A reaches are skipped.  Each product of the large parts starts
    // from zero and is added to acc in f32: the tensor cores' own sums are
    // not rounded to nearest, and a pixel that gathers a whole (b, h) would
    // drift in them past the f32 bar.  The small parts' products, 2^-8 to
    // 2^-11 of those, run in one chain a chunk.
    {
      const unsigned reached = (unsigned)counters[1];
      if constexpr (kTF32<T>) {
        const float* o_f = reinterpret_cast<const float*>(o_tile);
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const int mt = mt0 + warp + i * kWarps;
          if (mt >= mt1) break;  // the whole warp
          if (!((reached >> (mt - mt0)) & 1u)) continue;
          uint32_t ab[kQueries / 8][4], as[kQueries / 8][4];
#pragma unroll
          for (int ks = 0; ks < kQueries / 8; ++ks) {
            const float* ar = a_tile + ((mt - mt0) * 16 + (lane >> 2)) * kP +
                              ks * 8 + (lane & 3);
            split_tf32(ar[0], ab[ks][0], as[ks][0]);
            split_tf32(ar[8 * kP], ab[ks][1], as[ks][1]);
            split_tf32(ar[4], ab[ks][2], as[ks][2]);
            split_tf32(ar[8 * kP + 4], ab[ks][3], as[ks][3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < kQueries / 8; ++ks) {
              const float* row =
                  o_f + (nt * 8 + (lane >> 2)) * kP + ks * 8 + (lane & 3);
              uint32_t bb[2], bs[2];
              split_tf32(row[0], bb[0], bs[0]);
              split_tf32(row[4], bb[1], bs[1]);
              float big[4] = {0.f, 0.f, 0.f, 0.f};
              mma1688(big, ab[ks], bb);
              mma1688(small, as[ks], bb);
              mma1688(small, ab[ks], bs);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][nt][j] += big[j];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][nt][j] += small[j];
          }
        }
      } else {
        const uint16_t* o_h = reinterpret_cast<const uint16_t*>(o_tile);
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const int mt = mt0 + warp + i * kWarps;
          if (mt >= mt1) break;  // the whole warp
          if (!((reached >> (mt - mt0)) & 1u)) continue;
          uint32_t hi[kQueries / 16][4], lo[kQueries / 16][4];
#pragma unroll
          for (int ks = 0; ks < kQueries / 16; ++ks) {
            const float* ar = a_tile + ((mt - mt0) * 16 + (lane >> 2)) * kP +
                              ks * 16 + 2 * (lane & 3);
            split2<T>(*reinterpret_cast<const float2*>(ar), hi[ks][0],
                      lo[ks][0]);
            split2<T>(*reinterpret_cast<const float2*>(ar + 8 * kP),
                      hi[ks][1], lo[ks][1]);
            split2<T>(*reinterpret_cast<const float2*>(ar + 8), hi[ks][2],
                      lo[ks][2]);
            split2<T>(*reinterpret_cast<const float2*>(ar + 8 * kP + 8),
                      hi[ks][3], lo[ks][3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) {
            float small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < kQueries / 16; ++ks) {
              const uint16_t* row = o_h + (nt * 8 + (lane >> 2)) * kP +
                                    ks * 16 + 2 * (lane & 3);
              const uint32_t bf[2] = {
                  *reinterpret_cast<const uint32_t*>(row),
                  *reinterpret_cast<const uint32_t*>(row + 8)};
              float big[4] = {0.f, 0.f, 0.f, 0.f};
              mma16816<T>(big, hi[ks], bf);
              mma16816<T>(small, lo[ks], bf);
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][nt][j] += big[j];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][nt][j] += small[j];
          }
        }
      }
    }
  }
  cp_async_wait_all();  // a block with no chunk staged its rows only

  // img_grad[tile] += the sums, one atomic pair an element
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    const int mt = mt0 + warp + i * kWarps;
    if (mt >= mt1) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int px = mt * 16 + (lane >> 2) + half * 8;
      if (px >= S) continue;
      float* row = img_grad + base + (int64_t)(off + px) * HC;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const int c = nt * 8 + 2 * (lane & 3);
        const float v0 = acc[i][nt][2 * half], v1 = acc[i][nt][2 * half + 1];
        if (c + 1 < C) {
          if (v0 != 0.f || v1 != 0.f) {
            if ((C & 1) == 0) {
              atomicAdd(reinterpret_cast<float2*>(row + c),
                        make_float2(v0, v1));
            } else {
              atomicAdd(row + c, v0);
              atomicAdd(row + c + 1, v1);
            }
          }
        } else if (c < C && v0 != 0.f) {
          atomicAdd(row + c, v0);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The host side.

// Shared memory a block may take (227 KB on sm_90).
constexpr int kMaxSmem = 232448;

// The coarse kernel's shared memory for a level of S pixels and width w cut
// into `tiles` pixel tiles (coarse_layout), where the staged img rows are a
// tile's pixels and w + 1 more, at most the level.
template <typename T>
int coarse_smem(int S, int w, int tiles, int C, int P) {
  const int M = (S + 15) / 16;
  const int span = (M + tiles - 1) / tiles * 16;
  const int rows = span + w + 1 < S ? span + w + 1 : S;
  return coarse_layout<T>(P, C, rows).total;
}

// The plan of the coarse levels, from the shapes alone: a level is coarse where C <= 32, it has at most
// MSDA_COARSE_PIXELS pixels, its points put MSDA_COARSE_ADDS adds or more on
// each of them on average, and its block fits in shared memory.
template <typename T>
CoarsePlan coarse_plan(const LevelTable& levels, int B, int N, int H, int C,
                       int L, int P, int& smem) {
  CoarsePlan plan{};
  smem = 0;
  if (C > kMaxC) return plan;
  int64_t tile_count = 0;
  for (int l = 0; l < L; ++l) {
    const int S = levels.h[l] * levels.w[l];
    if (S > MSDA_COARSE_PIXELS) continue;
    if ((int64_t)N * P < (int64_t)MSDA_COARSE_ADDS * S) continue;
    const int M = (S + 15) / 16;
    const int tiles = (M + kWarps * kMTiles - 1) / (kWarps * kMTiles);
    const int bytes = coarse_smem<T>(S, levels.w[l], tiles, C, P);
    if (bytes > kMaxSmem) continue;
    smem = bytes > smem ? bytes : smem;
    plan.level[plan.count] = l;
    plan.tiles[plan.count] = tiles;
    tile_count += tiles;
    ++plan.count;
  }
  if (plan.count == 0) return plan;
  plan.chunks = (int)(((int64_t)N + kQueries - 1) / kQueries);
  // as many blocks as MSDA_COARSE_BLOCKS asks, each with at least
  // kMinChunks chunks where there are enough (a block stages its rows once)
  const int64_t units = (int64_t)B * H * tile_count;
  const int64_t split = (MSDA_COARSE_BLOCKS + units - 1) / units;
  const int64_t most = (plan.chunks + kMinChunks - 1) / kMinChunks;
  plan.q_split = (int)(split < most ? split : most);
  int64_t first = 0;
  for (int i = 0; i < plan.count; ++i) {
    plan.first[i] = (int)first;
    first += (int64_t)B * H * plan.tiles[i] * plan.q_split;
  }
  if (first > INT_MAX) {  // too large a grid: every level gathered
    smem = 0;
    return CoarsePlan{};
  }
  plan.first[plan.count] = (int)first;
  return plan;
}

unsigned coarse_mask(const CoarsePlan& plan) {
  unsigned mask = 0;
  for (int i = 0; i < plan.count; ++i) mask |= 1u << plan.level[i];
  return mask;
}

template <typename T, int VEC>
int launch_gather(const void* img, const void* pts, const void* wts,
                  const void* og, void* img_grad, void* pts_grad,
                  void* wts_grad, const LevelTable& levels, unsigned coarse,
                  int64_t num_tasks, int I, int N, int H, int C, int L, int P,
                  bool zeros, bool align_corners, cudaStream_t stream) {
  const int G = msda::group_lanes(C, VEC);
  const int64_t per_block = (int64_t)MSDA_WARPS_PER_BLOCK * (32 / G);
  const int64_t blocks = (num_tasks + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  msda_bwd_gather_kernel<T, VEC>
      <<<(unsigned int)blocks, MSDA_WARPS_PER_BLOCK * 32, 0, stream>>>(
          static_cast<const T*>(img), static_cast<const float*>(pts),
          static_cast<const float*>(wts), static_cast<const T*>(og),
          static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
          static_cast<float*>(wts_grad), levels, coarse, num_tasks, I, N, H,
          C, L, P, G, zeros, align_corners);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_coarse(const void* img, const void* pts, const void* wts,
                  const void* og, void* img_grad, void* pts_grad,
                  void* wts_grad, const LevelTable& levels,
                  const CoarsePlan& plan, int smem, int I, int N, int H,
                  int C, int L, int P, bool zeros, bool align_corners,
                  cudaStream_t stream) {
  auto kernel = msda_bwd_coarse_kernel<T, VEC>;
  // an attribute of the kernel on the current device, set on every launch
  // that needs more than the default (no work is enqueued: a stream capture
  // may be running)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool stage16 = msda::vec16<T>(img, C);
  const int og_mode = msda::vec16<T>(og, C) ? 2
                      : C * sizeof(T) % 4 == 0 &&
                              reinterpret_cast<uintptr_t>(og) % 4 == 0
                          ? 1
                          : 0;
  kernel<<<(unsigned int)plan.first[plan.count], kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<const T*>(og),
      static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
      static_cast<float*>(wts_grad), levels, plan, I, N, H, C, L, P,
      msda::group_lanes(C, VEC), zeros, align_corners, stage16, og_mode);
  return (int)cudaGetLastError();
}

// The gather kernel takes 4 channels a lane (16-byte loads in f32, 8 in the
// half types) where C and the alignment of img and out_grad allow it, else
// 1; the coarse kernel reads its staged rows 4 channels a lane where C
// allows it.
template <typename T>
int dispatch(const void* img, const void* pts, const void* wts,
             const void* og, void* img_grad, void* pts_grad, void* wts_grad,
             const LevelTable& levels, int B, int I, int N, int H, int C,
             int L, int P, bool zeros, bool align_corners,
             cudaStream_t stream) {
  int smem = 0;
  const CoarsePlan plan = coarse_plan<T>(levels, B, N, H, C, L, P, smem);
  const unsigned coarse = coarse_mask(plan);
  const bool v4 = msda::vec4<T>(C, img) && msda::vec4<T>(C, og);
  const int64_t num_tasks = (int64_t)B * N * H;
  int err = (int)cudaSuccess;
  if (coarse != (1u << L) - 1u) {
    err = v4 ? launch_gather<T, 4>(img, pts, wts, og, img_grad, pts_grad,
                                   wts_grad, levels, coarse, num_tasks, I, N,
                                   H, C, L, P, zeros, align_corners, stream)
             : launch_gather<T, 1>(img, pts, wts, og, img_grad, pts_grad,
                                   wts_grad, levels, coarse, num_tasks, I, N,
                                   H, C, L, P, zeros, align_corners, stream);
  }
  if (err != (int)cudaSuccess || plan.count == 0) return err;
  if (C % 4 == 0) {
    return launch_coarse<T, 4>(img, pts, wts, og, img_grad, pts_grad,
                               wts_grad, levels, plan, smem, I, N, H, C, L,
                               P, zeros, align_corners, stream);
  }
  return launch_coarse<T, 1>(img, pts, wts, og, img_grad, pts_grad, wts_grad,
                             levels, plan, smem, I, N, H, C, L, P, zeros,
                             align_corners, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (img and out_grad).
// level_hw: host array [L, 2] of (height, width) per level.
// img_grad must hold zeros: the kernels add into it.
// Returns a cudaError_t: cudaSuccess (0) when the launches were accepted.
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
