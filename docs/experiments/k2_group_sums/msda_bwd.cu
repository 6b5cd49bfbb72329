// A design of K2 that lost (docs/experiments/torch_bwd_designs.py): the
// shipped tiled K2 (msda_tpu_torch/csrc/msda_bwd.cu) with each point's three
// sums reduced over the group by three group_sum butterflies (15 shuffles a
// point at G = 8, as the lane-group K2 reduced them) in place of the batch's
// reduce-scatter (group_scatter).  Built beside the shipped headers.
//
// Interface: a plain C entry point (msda_bwd_launch), loaded with ctypes by
// msda_tpu_torch/ops/cuda_bwd.py.  It launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
// msda_bwd_plan returns a launch's plan.

#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "msda_async.cuh"
#include "msda_bwd_plan.cuh"
#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

namespace {

using msda::arrive_after_copies;
using msda::barrier_init;
using msda::BwdPlan;
using msda::copy_async;
using msda::corner_dots;
using msda::divide;
using msda::fast_div;
using msda::FastDiv;
using msda::LevelTable;
using msda::load_vec;
using msda::multiprocessors;
using msda::point_sums;
using msda::smem_address;
using msda::wait_phase;

constexpr int kThreads = MSDA_BWD_WARPS * 32;
static_assert(MSDA_BWD_BATCH >= 1 &&
                  (MSDA_BWD_BATCH & (MSDA_BWD_BATCH - 1)) == 0,
              "MSDA_BWD_BATCH must be a power of two");

// The img_grad terms of a corner set that the task has not added yet,
// summed in registers while consecutive points of a level fall on the same
// four pixels: off[0] and off[3] (the top-left and bottom-right corners'
// offsets) fix the set, nz marks the corners with a nonzero lerp weight,
// len counts the run's points.  A run of all P points of a query's level is
// added with its rounding error kept (add_exact): there every point shares
// the pixels.
struct Pending {
  int off[4] = {-1, -1, -1, -1};
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

// Adds the pending terms of this lane's channels to img_grad (ig: the
// head's first pixel at the lane's channels), one vector atomic a corner (a
// run of exact_run points with its error kept), and empties the set.
template <int VEC>
__device__ __forceinline__ void flush(Pending& s, float* ig,
                                      const int64_t lo, const int exact_run) {
  const bool exact = s.len >= exact_run;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if ((s.nz >> q) & 1u) {
      float* p = ig + s.off[q];
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

// A point's lerp factors, corner masks and attention weight, rebuilt from
// its entry (dx, dy, weight, mask bits) with corner_geometry's own
// expressions.
struct Factors {
  float vx0, vx1, uy0, uy1, mx0, mx1, my0, my1, a;

  __device__ __forceinline__ explicit Factors(const float4 e) {
    const int bits = __float_as_int(e.w);
    vx0 = (bits & 1) ? 1.f - e.x : 0.f;
    vx1 = (bits & 2) ? e.x : 0.f;
    uy0 = (bits & 4) ? 1.f - e.y : 0.f;
    uy1 = (bits & 8) ? e.y : 0.f;
    mx0 = (bits & 1) ? 1.f : 0.f;
    mx1 = (bits & 2) ? 1.f : 0.f;
    my0 = (bits & 4) ? 1.f : 0.f;
    my1 = (bits & 8) ? 1.f : 0.f;
    a = e.z;
  }

  // this lane's share of the point's three sums (point_sums)
  __device__ __forceinline__ void sums(const double (&dots)[4], float& w,
                                       double& x, double& y) const {
    point_sums(dots, vx0, vx1, uy0, uy1, mx0, mx1, my0, my1, w, x, y);
  }
};

// The divisors a task's indices need, as multiplies and shifts.
struct Divisors {
  FastDiv h, nh, p;  // by H, by N * H, by P
};

// img, og: [B, I, H, C] and [B, N, H, C] in T; pts [B, N, H, L, P, 2] and
// wts [B, N, H, L, P] in f32; img_grad [2, B, I, H, C] f32 (zeroed: the
// sums, then at img_grad + lo the rounding errors of the exact adds),
// pts_grad and wts_grad f32 like pts and wts.  All contiguous.  With MERGE
// (plan.steps == 1: the task's channels in one step of the group's lanes)
// the img_grad terms go through a Pending set.
// Dynamic shared memory (plan.smem bytes): the tile's entries, corner
// offsets [T][stride] int4 and geometry [T][stride] float4, then the
// stages' coordinates [S][T][stride][2] and weights [S][T][stride] f32.
template <typename T, int VEC, bool MERGE>
__global__ void __launch_bounds__(kThreads)
    msda_bwd_kernel(const T* __restrict__ img, const float* __restrict__ pts,
                    const float* __restrict__ wts, const T* __restrict__ og,
                    float* __restrict__ img_grad,
                    float* __restrict__ pts_grad,
                    float* __restrict__ wts_grad, const LevelTable levels,
                    const BwdPlan plan, const Divisors div, const int64_t lo,
                    const int num_tasks, const int I, const int H,
                    const int C, const int L, const int P, const bool zeros,
                    const bool align_corners) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MSDA_BWD_STAGES];

  // channel steps keep every point's dot products across them: one point
  // a batch there
  constexpr int kBatch = MERGE ? MSDA_BWD_BATCH : 1;
  const int tile = plan.tile, G = plan.lanes;
  const int shift = __ffs(plan.stride) - 1;  // stride = 1 << shift
  const int entries = tile << shift;
  int4* const corner_off = reinterpret_cast<int4*>(smem);
  float4* const corner_geo = reinterpret_cast<float4*>(corner_off + entries);
  float* const stage_pts = reinterpret_cast<float*>(corner_geo + entries);
  float* const stage_wts = stage_pts + MSDA_BWD_STAGES * entries * 2;

  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  const int warp_first = (threadIdx.x >> 5) * (32 / G);  // its first slot
  const int slot = warp_first + group;                    // task in a tile
  const int LP = L * P;
  const int HC = H * C;
  const int per_tile = plan.chunks;
  const int my_units =
      ((plan.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * per_tile;
  // a row of a stage: the coordinates' copies (2 << shift floats) and the
  // weights' (1 << shift), each a power of two of them
  const int pt_shift = shift + 1 - (plan.vw_pts >> 1);
  const int wt_shift = shift - (plan.vw_wts >> 1);
  const int c0 = c_lane * VEC, step = G * VEC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < MSDA_BWD_STAGES; ++s) {
      barrier_init(smem_address(&full[s]), kThreads);
    }
  }
  __syncthreads();

  // Copies the coordinates and weights of unit q (a tile's chunk) into
  // stage q % S; every thread arrives on its barrier.  A task's rows are
  // its index t: the tasks are numbered as pts is laid out.
  auto issue = [&](const int q) {
    const int tile_id = blockIdx.x + (q / per_tile) * gridDim.x;
    const int k0 = q % per_tile * plan.chunk;
    const int kp = min(plan.chunk, LP - k0);
    const int s = q % MSDA_BWD_STAGES;
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
      const int64_t row = (int64_t)t * LP + k0;
      if (is_pt) {
        copy_async(smem_address(sp + (j << (shift + 1)) + v * vw),
                   pts + row * 2 + v * vw, vw);
      } else {
        copy_async(smem_address(sw + (j << shift) + v * vw),
                   wts + row + v * vw, vw);
      }
    }
    arrive_after_copies(smem_address(&full[s]));
  };

  for (int s = 0; s < MSDA_BWD_STAGES && s < my_units; ++s) issue(s);

  // a task's state across its chunks: its out_grad channels and its
  // pending img_grad terms
  float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f);
  Pending pend;
  for (int q = 0; q < my_units; ++q) {
    const int tile_id = blockIdx.x + (q / per_tile) * gridDim.x;
    const int chunk = q % per_tile;
    const int k0 = chunk * plan.chunk;
    const int kp = min(plan.chunk, LP - k0);
    const int s = q % MSDA_BWD_STAGES;
    wait_phase(smem_address(&full[s]), (uint32_t)((q / MSDA_BWD_STAGES) & 1));

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
      corner_off[i] = make_int4(g.i00 * HC, g.i01 * HC, g.i10 * HC,
                                g.i11 * HC);
      const int bits = (g.mx0 != 0.f ? 1 : 0) | (g.mx1 != 0.f ? 2 : 0) |
                       (g.my0 != 0.f ? 4 : 0) | (g.my1 != 0.f ? 8 : 0);
      corner_geo[i] = make_float4(g.dx, g.dy, sw[i], __int_as_float(bits));
    }
    __syncthreads();  // the entries are written; stage s is free again
    if (q + MSDA_BWD_STAGES < my_units) issue(q + MSDA_BWD_STAGES);

    // the gather: a group its task, VEC channels a lane; a group past the
    // tile's ragged end computes on its last task and writes nothing
    if (warp_first < live) {
      const bool valid = slot < live;
      const int t = tile_id * tile + (valid ? slot : live - 1);
      const int h = t - divide(t, div.h) * H;
      const int b = divide(t, div.nh);
      const int64_t base = ((int64_t)b * I * H + h) * C;
      const T* const img_bh = img + base;
      float* const ig_bh = img_grad + base;
      const T* const og_row = og + (int64_t)t * C;
      float* const pg = pts_grad + ((int64_t)t * LP + k0) * 2;
      float* const wg = wts_grad + (int64_t)t * LP + k0;
      const int entry0 = (valid ? slot : live - 1) << shift;
      const int4* const eo = corner_off + entry0;
      const float4* const eg = corner_geo + entry0;
      if (chunk == 0) {
        o0 = c0 < C ? load_vec<VEC>(og_row + c0)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        pend = Pending();
      }

      // Points kb .. kb + NB - 1 of the chunk: their corner loads, then
      // each point's dot products, img_grad terms and sums, then the sums
      // reduced over the group and written by the lanes left holding them.
      auto gather = [&](auto batch, const int kb) {
        constexpr int NB = decltype(batch)::value;
        float sum_w[NB];
        double sum_xy[2 * NB];
        if constexpr (MERGE) {  // one channel step: c0 < C or nothing
          if (c0 < C) {
            const T* const at = img_bh + c0;
            float4 v[NB][4];
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              const int4 o = eo[kb + u];
              v[u][0] = load_vec<VEC>(at + o.x);
              v[u][1] = load_vec<VEC>(at + o.y);
              v[u][2] = load_vec<VEC>(at + o.z);
              v[u][3] = load_vec<VEC>(at + o.w);
            }
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              const Factors f(eg[kb + u]);
              double dots[4] = {0.0, 0.0, 0.0, 0.0};
              corner_dots<VEC>(o0, v[u][0], v[u][1], v[u][2], v[u][3],
                               dots);
              if (valid) {
                const int4 o = eo[kb + u];
                if (o.x != pend.off[0] || o.w != pend.off[3]) {
                  flush<VEC>(pend, ig_bh + c0, lo, P);
                  pend.off[0] = o.x;
                  pend.off[1] = o.y;
                  pend.off[2] = o.z;
                  pend.off[3] = o.w;
                }
                ++pend.len;
                const float lerp[4] = {f.uy0 * f.vx0, f.uy0 * f.vx1,
                                       f.uy1 * f.vx0, f.uy1 * f.vx1};
#pragma unroll
                for (int q4 = 0; q4 < 4; ++q4) {
                  // a corner masked in zeros mode adds nothing
                  const float w = f.a * lerp[q4];
                  pend.nz |= (w != 0.f ? 1u : 0u) << q4;
                  pend.acc[q4].x += w * o0.x;
                  pend.acc[q4].y += w * o0.y;
                  pend.acc[q4].z += w * o0.z;
                  pend.acc[q4].w += w * o0.w;
                }
              }
              f.sums(dots, sum_w[u], sum_xy[2 * u], sum_xy[2 * u + 1]);
            }
          } else {  // no channel: point_sums of zero dots
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              sum_w[u] = 0.f;
              sum_xy[2 * u] = sum_xy[2 * u + 1] = 0.0;
            }
          }
        } else {
          double dots[NB][4] = {};
          for (int c = c0; c < C; c += step) {
            const float4 oc = c == c0 ? o0 : load_vec<VEC>(og_row + c);
            const T* const at = img_bh + c;
            float4 v[NB][4];
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              const int4 o = eo[kb + u];
              v[u][0] = load_vec<VEC>(at + o.x);
              v[u][1] = load_vec<VEC>(at + o.y);
              v[u][2] = load_vec<VEC>(at + o.z);
              v[u][3] = load_vec<VEC>(at + o.w);
            }
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              corner_dots<VEC>(oc, v[u][0], v[u][1], v[u][2], v[u][3],
                               dots[u]);
              if (valid) {
                const Factors f(eg[kb + u]);
                const int4 o = eo[kb + u];
                const float4 ao = make_float4(f.a * oc.x, f.a * oc.y,
                                              f.a * oc.z, f.a * oc.w);
                float* const ig = ig_bh + c;
                msda::add_grad<VEC>(ig + o.x, ao, f.uy0 * f.vx0);
                msda::add_grad<VEC>(ig + o.y, ao, f.uy0 * f.vx1);
                msda::add_grad<VEC>(ig + o.z, ao, f.uy1 * f.vx0);
                msda::add_grad<VEC>(ig + o.w, ao, f.uy1 * f.vx1);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            Factors(eg[kb + u]).sums(dots[u], sum_w[u], sum_xy[2 * u],
                                     sum_xy[2 * u + 1]);
          }
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const float w = msda::group_sum(sum_w[u], G);
          const double x = msda::group_sum(sum_xy[2 * u], G);
          const double y = msda::group_sum(sum_xy[2 * u + 1], G);
          if (valid && c_lane == 0) {
            const int kk = kb + u;
            const int l = divide(k0 + kk, div.p);
            const float xscale =
                (float)(align_corners ? levels.w[l] - 1 : levels.w[l]);
            const float yscale =
                (float)(align_corners ? levels.h[l] - 1 : levels.h[l]);
            const double a = eg[kk].z;
            wg[kk] = w;
            pg[2 * kk] = (float)(a * xscale * x);
            pg[2 * kk + 1] = (float)(a * yscale * y);
          }
        }
      };

      int kb = 0;
      for (; kb + kBatch <= kp; kb += kBatch) {
        gather(std::integral_constant<int, kBatch>(), kb);
      }
      for (; kb < kp; ++kb) gather(std::integral_constant<int, 1>(), kb);
      if constexpr (MERGE) {
        if (valid && c0 < C && chunk == per_tile - 1) {
          flush<VEC>(pend, ig_bh + c0, lo, P);
        }
      }
    }
    __syncthreads();  // the entries are read before the next unit's
  }
}

// Lets an instantiation use up to MSDA_BWD_SMEM_MAX bytes of dynamic shared
// memory a block, once a device.
template <typename T, int VEC, bool MERGE>
int allow_shared() {
  static std::atomic<uint64_t> done{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = 1ull << (device & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(msda_bwd_kernel<T, VEC, MERGE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MSDA_BWD_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit);
  }
  return (int)cudaSuccess;
}

template <typename T, int VEC, bool MERGE>
int launch(const void* img, const void* pts, const void* wts, const void* og,
           void* img_grad, void* pts_grad, void* wts_grad,
           const LevelTable& levels, const BwdPlan& plan, int64_t lo,
           int num_tasks, int I, int N, int H, int C, int L, int P,
           bool zeros, bool align_corners, cudaStream_t stream) {
  auto kernel = msda_bwd_kernel<T, VEC, MERGE>;
  int err = allow_shared<T, VEC, MERGE>();
  if (err != (int)cudaSuccess) return err;
  int resident = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, kThreads, plan.smem);
  if (err != (int)cudaSuccess) return err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int sms = multiprocessors();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int per_sm =
      resident < MSDA_BWD_BLOCKS_PER_SM ? resident : MSDA_BWD_BLOCKS_PER_SM;
  const int most = per_sm * sms;
  const int blocks = plan.tiles < most ? plan.tiles : most;
  const Divisors div = {fast_div(H), fast_div(N * H), fast_div(P)};
  kernel<<<blocks, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<const T*>(og),
      static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
      static_cast<float*>(wts_grad), levels, plan, div, lo, num_tasks, I, H,
      C, L, P, zeros, align_corners);
  return (int)cudaGetLastError();
}

// VEC = 4 where C and the alignment of img and out_grad allow it; the task's
// channels in one step of its lanes where C <= G * VEC.
template <typename T>
BwdPlan plan_for(const void* img, const void* pts, const void* wts,
                 const void* og, int tasks, int C, int L, int P) {
  const bool v4 = msda::vec4<T>(C, img) && msda::vec4<T>(C, og);
  const int vec = v4 ? 4 : 1;
  return msda::bwd_plan(
      tasks, L, P, C, msda::group_lanes(C, vec), vec,
      msda::fwd_alignment(reinterpret_cast<uintptr_t>(pts)),
      msda::fwd_alignment(reinterpret_cast<uintptr_t>(wts)));
}

template <typename T>
int dispatch(const void* img, const void* pts, const void* wts,
             const void* og, void* img_grad, void* pts_grad, void* wts_grad,
             const LevelTable& levels, int B, int I, int N, int H, int C,
             int L, int P, bool zeros, bool align_corners,
             cudaStream_t stream) {
  const int num_tasks = B * N * H;
  const BwdPlan plan = plan_for<T>(img, pts, wts, og, num_tasks, C, L, P);
  if (plan.smem == 0) return (int)cudaErrorInvalidConfiguration;
  const bool merge = plan.steps == 1;
  auto run = plan.vec == 4
                 ? (merge ? launch<T, 4, true> : launch<T, 4, false>)
                 : (merge ? launch<T, 1, true> : launch<T, 1, false>);
  // the rounding errors' half of img_grad
  const int64_t lo = (int64_t)B * I * H * C;
  return run(img, pts, wts, og, img_grad, pts_grad, wts_grad, levels, plan,
             lo, num_tasks, I, N, H, C, L, P, zeros, align_corners, stream);
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
  // a task a (b, n, h); past 2^31 - 1 the points would be too (L * P >= 1)
  const int64_t tasks = (int64_t)B * N * H;
  if (tasks == 0) return (int)cudaSuccess;
  if (tasks > INT_MAX) return (int)cudaErrorInvalidValue;

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

// The plan of a launch on these arguments (msda_bwd_plan.cuh), written into
// plan[11] in BwdPlan's order.  Returns cudaErrorInvalidValue for a dtype
// or shape msda_bwd_launch refuses.
int msda_bwd_plan(int dtype, const void* img, const void* pts,
                  const void* wts, const void* og, int B, int N, int H,
                  int C, int L, int P, int* plan) {
  const int64_t tasks = (int64_t)B * N * H;
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || C < 1 || tasks > INT_MAX ||
      tasks < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int t = (int)tasks;
  BwdPlan p;
  switch (dtype) {
    case 0: p = plan_for<float>(img, pts, wts, og, t, C, L, P); break;
    case 1: p = plan_for<__half>(img, pts, wts, og, t, C, L, P); break;
    case 2: p = plan_for<__nv_bfloat16>(img, pts, wts, og, t, C, L, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int fields[11] = {p.lanes,  p.vec,    p.tile,   p.chunk,
                          p.stride, p.chunks, p.steps,  p.vw_pts,
                          p.vw_wts, p.smem,   p.tiles};
  for (int i = 0; i < 11; ++i) plan[i] = fields[i];
  return (int)cudaSuccess;
}

}  // extern "C"
