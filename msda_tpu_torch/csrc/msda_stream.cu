// Streamed multiscale deformable attention for large pyramids, NVIDIA Hopper
// (sm_90a): the forward (K3') and the backward (K4' + K5', one kernel), with
// the binning kernels they share.
//
// Replaces the TPU kernels msda_tpu/ops/pallas_stream.py:_stream_fwd_kernel
// (K3, pallas_call in stream_fwd), _stream_bwd_pts_kernel (K4) and
// _stream_bwd_img_kernel (K5, both pallas_calls in stream_bwd).  They compute
// K1's and K2's functions (msda_fwd.cu, msda_bwd.cu) level by level over row
// bands, because a large pyramid does not fit the TPU's VMEM.  On an H100 the
// resident gather kernels run at any size, but once one image's pyramid
// outgrows the 50 MB L2 their corner gathers (and K2's atomics) go to device
// memory.  What carries over is the band decomposition; the E/A matrices,
// bf16 splits and padded pitch of the TPU form do not.
//
// Tiles and bins.  The plan (msda_tpu_torch/ops/stream.py:band_plan) cuts
// level l into bands of yb rows and, where a row is too wide for shared
// memory, columns of xb pixels.  A sample (b, n, h, l, p) belongs to the tile
// of its clamped top-left corner (y0c, x0c) from msda::corner_geometry, the
// geometry K1 and K2 use, so binning and sampling put a point on the same
// pixels.  Its other corners lie at most one row below and one column right,
// so a tile is staged with one halo row and one halo column where the level
// goes on.  In zeros mode a corner outside the level has weight 0 and its
// clamped index is inside the tile all the same.
//   * msda_stream_count: a block takes 128 queries of one (b, h), counts its
//     samples per bin in shared memory and adds each non-zero count to the
//     global one (bins of one (b, h) are contiguous: level by level,
//     band-major);
//   * the wrapper takes the exclusive sum of the counts (torch.cumsum);
//   * msda_stream_scatter: the same blocks reserve a range of each bin with
//     one global atomic and write their sample indices into `order`.
// A bin is served in slices of at most `slice` samples, one block each, so
// that the dense small levels (all N * P samples of a 32x32 level in one
// tile) do not leave a few blocks running alone at the end; the wrapper sums
// the slices per bin (torch.cumsum) into each bin's first block.
//
// Every block stages its tile with 16-byte cp.async copies, all in flight at
// once (element by element where C does not allow it).  A warp then takes
// the slice's samples 32 at a time: lane k loads sample k's index, point and
// weight and computes its tile-local corners, and the warp walks the 32 with
// __shfl_sync, a group of G lanes per sample, 4 channels per lane (C a
// multiple of 4; G = 8 at C = 32, four samples per step).
//
// K3' (msda_stream_fwd_kernel): each group adds a * bilerp of its sample
// into an f32 out buffer [B, N, H, C] with sm_90's 16-byte vector atomics (a
// query's L*P samples fall in different tiles).  The wrapper zeroes that
// buffer and casts it once to img's type.
//
// K4' + K5' (msda_stream_bwd_kernel): per sample, with g = out_grad[b, n,
// h, :], a group computes over its channels
//   * wts_grad = sum_c g[c] sample[c] (f32);
//   * the two point-gradient sums in f64, as K2 does (msda_bwd.cu "Precision"),
//     times a and the level's scale (w or w - 1, h or h - 1);
//   * the four corners' img_grad terms a * g[c] * (lerp weight), added with
//     16-byte vector atomics into an f32 buffer [B, I, H, C] that the wrapper
//     zeroes and casts once.
// A sample lies wholly in its tile, so the first two are complete in one
// group and are stored directly.  The img_grad rows a block adds into are
// its tile's, which stay in L2 while the block runs.  Accumulating them in a
// shared-memory tile and flushing it once (the TPU kernel's form) was
// measured at 2.1x this kernel's time on the H100 (PERF.md): Hopper has no
// shared-memory f32 atomic add, and each one compiles to a compare-and-swap
// loop (ATOMS.CAST.SPIN).
//
// What bounds it (planning arithmetic from the shapes, not a measurement):
// at the 256-base pyramid (B=4, N=10,000, H=8, C=32, L=4, P=4, f32; img
// 356 MB) the blocks stage about img once plus the halos and the re-staged
// tiles of sliced bins (~0.5 GB, ~0.15 ms at 3.35 TB/s).  The forward then
// issues 8 vector atomics per sample (5.12 M samples) into the 41 MB out
// buffer, which stays in L2; the backward re-reads each query's out_grad row
// for each of its 16 samples and issues 32 vector atomics per sample into
// img_grad.  A block whose tile takes most of the 227 KB has an SM to
// itself, with 16 warps to hide the latency of its sample loop.  TMA,
// cp.async rings that overlap one tile's staging with another's samples, and
// tuning are later work.
//
// Interface: plain C entry points, loaded with ctypes by
// msda_tpu_torch/ops/cuda_stream.py.  Each launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <algorithm>
#include <climits>
#include <cstdint>

#include "msda_geometry.cuh"

#define STREAM_THREADS 512
#define STREAM_WARPS (STREAM_THREADS / 32)
#define BIN_THREADS 256
#define BIN_QUERIES 128
// bins of one (b, h) that a binning block counts in shared memory (48 KB)
#define BIN_LOCAL_MAX 12288

namespace {

using msda::LevelTable;
using msda::to_float;

// The plan's tiles: per level the band rows, tile columns, tiles per band,
// and the first bin of the level within one (b, h).
struct TileTable {
  int yb[MSDA_MAX_LEVELS];
  int xb[MSDA_MAX_LEVELS];
  int ncb[MSDA_MAX_LEVELS];
  int first[MSDA_MAX_LEVELS + 1];  // first[L]: bins per (b, h)
};

// Fills the table from a host array [L, 2] of (yb, xb); returns the bins per
// (b, h), or -1 when the plan is invalid or the count overflows.
int fill_tiles(TileTable& tt, const LevelTable& lv, const int* plan, int L) {
  int64_t bins = 0;
  for (int l = 0; l < L; ++l) {
    const int yb = plan[2 * l], xb = plan[2 * l + 1];
    if (yb < 1 || xb < 1) return -1;
    tt.yb[l] = yb;
    tt.xb[l] = xb;
    tt.ncb[l] = (lv.w[l] + xb - 1) / xb;
    tt.first[l] = (int)bins;
    bins += (int64_t)((lv.h[l] + yb - 1) / yb) * tt.ncb[l];
    if (bins > INT_MAX) return -1;
  }
  tt.first[L] = (int)bins;
  return (int)bins;
}

// Largest staged tile of the plan, in pixels.
int64_t max_tile_pixels(const TileTable& tt, const LevelTable& lv, int L) {
  int64_t most = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t rows = std::min(tt.yb[l] + 1, lv.h[l]);
    const int64_t cols = std::min(tt.xb[l] + 1, lv.w[l]);
    most = std::max(most, rows * cols);
  }
  return most;
}

// Bin of sample s, pts [B, N, H, L, P, 2] f32, among the tiles of one (b, h).
__device__ __forceinline__ int local_bin(const float* __restrict__ pts,
                                         const int64_t s, const int l,
                                         const LevelTable& lv,
                                         const TileTable& tt,
                                         const bool align_corners) {
  const int wl = lv.w[l];
  // the clamped indices do not depend on the padding mode
  const msda::Corners g = msda::corner_geometry(
      pts[2 * s], pts[2 * s + 1], lv.h[l], wl, 0, false, align_corners);
  const int y0c = g.i00 / wl, x0c = g.i00 - y0c * wl;
  return tt.first[l] + (y0c / tt.yb[l]) * tt.ncb[l] + x0c / tt.xb[l];
}

// The binning kernels: block (chunk of BIN_QUERIES queries, b * H + h).  With
// `local` set, the block counts its samples in a shared-memory histogram of
// the bins of its (b, h) and adds each non-zero count once to the global
// one; otherwise (more bins than fit) every sample adds to the global count.
__global__ void __launch_bounds__(BIN_THREADS)
    msda_stream_count_kernel(const float* __restrict__ pts,
                             int* __restrict__ counts, const LevelTable lv,
                             const TileTable tt, const int N, const int H,
                             const int L, const int P,
                             const bool align_corners, const bool local) {
  extern __shared__ int hist[];
  const int per_bh = tt.first[L], LP = L * P;
  const int bh = blockIdx.y, n0 = blockIdx.x * BIN_QUERIES;
  const int samples = min(BIN_QUERIES, N - n0) * LP;
  int* bins = counts + (int64_t)bh * per_bh;
  const int64_t task0 = ((int64_t)(bh / H) * N + n0) * H + bh % H;
  if (local) {
    for (int k = threadIdx.x; k < per_bh; k += blockDim.x) hist[k] = 0;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < samples; i += blockDim.x) {
    const int q = i / LP, k = i - q * LP;
    const int key = local_bin(pts, (task0 + (int64_t)q * H) * LP + k, k / P,
                              lv, tt, align_corners);
    if (local) {
      atomicAdd(hist + key, 1);
    } else {
      atomicAdd(bins + key, 1);
    }
  }
  if (local) {
    __syncthreads();
    for (int k = threadIdx.x; k < per_bh; k += blockDim.x) {
      if (hist[k] != 0) atomicAdd(bins + k, hist[k]);
    }
  }
}

// As the count, then each sample writes its index into its bin's segment of
// `order`: with `local`, the block first reserves a range of each bin for its
// samples (one global atomic per bin) and hands out places in shared memory.
__global__ void __launch_bounds__(BIN_THREADS)
    msda_stream_scatter_kernel(const float* __restrict__ pts,
                               int* __restrict__ cursor,
                               int* __restrict__ order, const LevelTable lv,
                               const TileTable tt, const int N, const int H,
                               const int L, const int P,
                               const bool align_corners, const bool local) {
  extern __shared__ int hist[];
  const int per_bh = tt.first[L], LP = L * P;
  const int bh = blockIdx.y, n0 = blockIdx.x * BIN_QUERIES;
  const int samples = min(BIN_QUERIES, N - n0) * LP;
  int* next = cursor + (int64_t)bh * per_bh;
  const int64_t task0 = ((int64_t)(bh / H) * N + n0) * H + bh % H;
  if (local) {
    for (int k = threadIdx.x; k < per_bh; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < samples; i += blockDim.x) {
      const int q = i / LP, k = i - q * LP;
      atomicAdd(hist + local_bin(pts, (task0 + (int64_t)q * H) * LP + k,
                                 k / P, lv, tt, align_corners),
                1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < per_bh; k += blockDim.x) {
      if (hist[k] != 0) hist[k] = atomicAdd(next + k, hist[k]);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < samples; i += blockDim.x) {
    const int q = i / LP, k = i - q * LP;
    const int64_t s = (task0 + (int64_t)q * H) * LP + k;
    const int key = local_bin(pts, s, k / P, lv, tt, align_corners);
    order[local ? atomicAdd(hist + key, 1) : atomicAdd(next + key, 1)] =
        (int)s;
  }
}

// The tile of one block: its level, origin and staged extent.
struct Tile {
  int l, y0, x0, rows, cols;
  int64_t b, h;
};

__device__ __forceinline__ Tile block_tile(const int bin, const int H,
                                           const int L, const LevelTable& lv,
                                           const TileTable& tt) {
  Tile t;
  const int bh = bin / tt.first[L];
  int k = bin - bh * tt.first[L];
  int l = 0;
  while (l + 1 < L && k >= tt.first[l + 1]) ++l;
  k -= tt.first[l];
  const int r = k / tt.ncb[l];
  t.l = l;
  t.y0 = r * tt.yb[l];
  t.x0 = (k - r * tt.ncb[l]) * tt.xb[l];
  t.rows = min(tt.yb[l] + 1, lv.h[l] - t.y0);
  t.cols = min(tt.xb[l] + 1, lv.w[l] - t.x0);
  t.b = bh / H;
  t.h = bh - t.b * H;
  return t;
}

// Global index of element e = (pixel of the tile) * C + c, in [B, I, H, C].
__device__ __forceinline__ int64_t tile_to_global(const int e, const Tile& t,
                                                  const LevelTable& lv,
                                                  const int I, const int H,
                                                  const int C) {
  const int px = e / C, c = e - px * C;
  const int y = px / t.cols, x = px - y * t.cols;
  const int64_t pixel =
      (int64_t)lv.offset[t.l] + (int64_t)(t.y0 + y) * lv.w[t.l] + t.x0 + x;
  return ((t.b * I + pixel) * H + t.h) * C + c;
}

// A sample's geometry on its tile: the four corners' offsets into the tile
// (in elements: pixel * C) and the masked lerp factors and masks.
struct TileCorners {
  int j00, j01, j10, j11;
  msda::Corners g;
};

__device__ __forceinline__ TileCorners tile_corners(const float x,
                                                    const float y,
                                                    const Tile& t,
                                                    const LevelTable& lv,
                                                    const int C,
                                                    const bool zeros,
                                                    const bool align) {
  const int wl = lv.w[t.l];
  TileCorners tc;
  tc.g = msda::corner_geometry(x, y, lv.h[t.l], wl, 0, zeros, align);
  const int y0 = tc.g.i00 / wl - t.y0, x0 = tc.g.i00 % wl - t.x0;
  const int y1 = tc.g.i10 / wl - t.y0, x1 = tc.g.i01 % wl - t.x0;
  tc.j00 = (y0 * t.cols + x0) * C;
  tc.j01 = (y0 * t.cols + x1) * C;
  tc.j10 = (y1 * t.cols + x0) * C;
  tc.j11 = (y1 * t.cols + x1) * C;
  return tc;
}

// Four channels from shared or global memory, as floats (p 16-byte aligned
// for float, 8-byte for the half types).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The work of one block: a slice of at most `slice` samples of one bin.
// slices[bin] is the bin's first block (the exclusive sum of
// ceil(count / slice) over the bins before it); the grid may hold more
// blocks than there are slices, and a block without work gets count <= 0.
__device__ __forceinline__ void block_work(const int* __restrict__ counts,
                                           const int* __restrict__ slices,
                                           const int num_bins,
                                           const int slice, int* bin,
                                           int* done, int* count) {
  const int id = blockIdx.x;
  int lo = 0, hi = num_bins;  // the last bin whose first block is <= id
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (slices[mid] <= id) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  *bin = lo;
  *done = (id - slices[lo]) * slice;
  *count = min(slice, counts[lo] - *done);
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

// Copies the tile into shared memory.  With `vec` (a pixel's C channels are
// a whole number of 16-byte pieces, and img is 16-byte aligned), every thread
// issues its 16-byte cp.async copies back to back and waits once, so many
// loads are in flight; otherwise one element at a time.
template <typename T>
__device__ __forceinline__ void stage_tile(T* __restrict__ tile,
                                           const T* __restrict__ img,
                                           const Tile& t,
                                           const LevelTable& lv, const int I,
                                           const int H, const int C,
                                           const bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int V = C / E;
    const int64_t HC = (int64_t)H * C;
    const T* level = img + (t.b * I + lv.offset[t.l]) * HC + t.h * C;
    const int n = t.rows * t.cols * V;
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const int px = v / V, k = v - px * V;
      const int y = px / t.cols, x = px - y * t.cols;
      cp_async16(tile + px * C + k * E,
                 level + ((int64_t)(t.y0 + y) * lv.w[t.l] + t.x0 + x) * HC +
                     k * E);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    const int n = t.rows * t.cols * C;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      tile[e] = img[tile_to_global(e, t, lv, I, H, C)];
    }
  }
}

// The sample loop of both kernels.  A warp takes its bin's samples 32 at a
// time: lane k loads sample k's index, point and weight and computes its
// geometry (32 independent loads in flight), then the warp walks the 32,
// one sample per group of G lanes, taking each sample's geometry from its
// lane with __shfl_sync.  Every lane runs every step (a group past the end
// of the bin gets valid = false), so the shuffles see whole warps.
struct Preload {
  int s;
  float a;
  TileCorners tc;
};

__device__ __forceinline__ Preload preload(const int* __restrict__ bin,
                                           const int k, const int count,
                                           const float* __restrict__ pts,
                                           const float* __restrict__ wts,
                                           const Tile& t,
                                           const LevelTable& lv, const int C,
                                           const bool zeros,
                                           const bool align) {
  Preload p = {};
  if (k < count) {
    p.s = bin[k];
    p.a = wts[p.s];
    p.tc = tile_corners(pts[2 * (int64_t)p.s], pts[2 * (int64_t)p.s + 1], t,
                        lv, C, zeros, align);
  }
  return p;
}

// One lane's share of a sample's channels: VEC = 4 adjacent channels per
// step (C a multiple of 4) or 1.
template <int VEC, typename T>
__device__ __forceinline__ float4 load_vec(const T* p) {
  if constexpr (VEC == 4) {
    return load4(p);
  } else {
    return make_float4(to_float(*p), 0.f, 0.f, 0.f);
  }
}

// img: [B, I, H, C] T; pts [B, N, H, L, P, 2] and wts [B, N, H, L, P] f32;
// order, starts, counts: the bins; slices: their first blocks; out
// [B, N, H, C] f32, zeroed.
template <typename T, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS)
    msda_stream_fwd_kernel(const T* __restrict__ img,
                           const float* __restrict__ pts,
                           const float* __restrict__ wts,
                           const int* __restrict__ order,
                           const int* __restrict__ starts,
                           const int* __restrict__ counts,
                           const int* __restrict__ slices,
                           float* __restrict__ out, const LevelTable lv,
                           const TileTable tt, const int num_bins,
                           const int slice, const int I, const int H,
                           const int C, const int L, const int LP,
                           const int G, const bool vec, const bool zeros,
                           const bool align_corners) {
  int bin_id, done, count;
  block_work(counts, slices, num_bins, slice, &bin_id, &done, &count);
  if (count <= 0) return;  // the whole block leaves
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Tile t = block_tile(bin_id, H, L, lv, tt);
  stage_tile(tile, img, t, lv, I, H, C, vec);
  __syncthreads();

  const int* bin = order + starts[bin_id] + done;
  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  const int per_step = 32 / G;
  for (int base = (threadIdx.x >> 5) * 32; base < count;
       base += STREAM_WARPS * 32) {
    const Preload p = preload(bin, base + lane, count, pts, wts, t, lv, C,
                              zeros, align_corners);
    const msda::Corners& g = p.tc.g;
    const float w00 = p.a * g.uy0 * g.vx0, w01 = p.a * g.uy0 * g.vx1;
    const float w10 = p.a * g.uy1 * g.vx0, w11 = p.a * g.uy1 * g.vx1;
    const int chunk = min(32, count - base);
    for (int j0 = 0; j0 < chunk; j0 += per_step) {
      const int j = j0 + group;
      const int s = __shfl_sync(MSDA_FULL_MASK, p.s, j);
      const int q00 = __shfl_sync(MSDA_FULL_MASK, p.tc.j00, j);
      const int q01 = __shfl_sync(MSDA_FULL_MASK, p.tc.j01, j);
      const int q10 = __shfl_sync(MSDA_FULL_MASK, p.tc.j10, j);
      const int q11 = __shfl_sync(MSDA_FULL_MASK, p.tc.j11, j);
      const float u00 = __shfl_sync(MSDA_FULL_MASK, w00, j);
      const float u01 = __shfl_sync(MSDA_FULL_MASK, w01, j);
      const float u10 = __shfl_sync(MSDA_FULL_MASK, w10, j);
      const float u11 = __shfl_sync(MSDA_FULL_MASK, w11, j);
      if (j >= chunk) continue;
      float* out_row = out + (int64_t)(s / LP) * C;
      for (int c = c_lane * VEC; c < C; c += G * VEC) {
        const float4 v00 = load_vec<VEC>(tile + q00 + c);
        const float4 v01 = load_vec<VEC>(tile + q01 + c);
        const float4 v10 = load_vec<VEC>(tile + q10 + c);
        const float4 v11 = load_vec<VEC>(tile + q11 + c);
        const float4 r = make_float4(
            u00 * v00.x + u01 * v01.x + u10 * v10.x + u11 * v11.x,
            u00 * v00.y + u01 * v01.y + u10 * v10.y + u11 * v11.y,
            u00 * v00.z + u01 * v01.z + u10 * v10.z + u11 * v11.z,
            u00 * v00.w + u01 * v01.w + u10 * v10.w + u11 * v11.w);
        if constexpr (VEC == 4) {
          atomicAdd(reinterpret_cast<float4*>(out_row + c), r);
        } else {
          atomicAdd(out_row + c, r.x);
        }
      }
    }
  }
}

template <typename F>
__device__ __forceinline__ F group_sum(F v, const int G) {
  for (int s = G >> 1; s > 0; s >>= 1) {
    v += __shfl_xor_sync(MSDA_FULL_MASK, v, s);
  }
  return v;
}

// The backward's three channel sums over one lane's VEC channels.
template <int VEC>
__device__ __forceinline__ void bwd_sums(
    const float4& o, const float4& v00, const float4& v01, const float4& v10,
    const float4& v11, const float vx0, const float vx1, const float uy0,
    const float uy1, const float mx0, const float mx1, const float my0,
    const float my1, float& sum_w, double& sum_x, double& sum_y) {
  const float* og = &o.x;
  const float* a00 = &v00.x;
  const float* a01 = &v01.x;
  const float* a10 = &v10.x;
  const float* a11 = &v11.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sum_w += og[k] * (uy0 * (vx0 * a00[k] + vx1 * a01[k]) +
                      uy1 * (vx0 * a10[k] + vx1 * a11[k]));
    // the point gradients in f64: see msda_bwd.cu "Precision"
    const double d00 = a00[k], d01 = a01[k], d10 = a10[k], d11 = a11[k];
    sum_x += (double)og[k] * ((double)uy0 * (mx1 * d01 - mx0 * d00) +
                              (double)uy1 * (mx1 * d11 - mx0 * d10));
    sum_y += (double)og[k] * (my1 * ((double)vx0 * d10 + (double)vx1 * d11) -
                              my0 * ((double)vx0 * d00 + (double)vx1 * d01));
  }
}

// Adds w * ao to VEC channels of img_grad (a 16-byte vector atomic for 4).
template <int VEC>
__device__ __forceinline__ void add_grad(float* p, const float4& ao,
                                         const float w) {
  if (w == 0.f) return;  // a corner masked in zeros mode adds nothing
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(w * ao.x, w * ao.y, w * ao.z, w * ao.w));
  } else {
    atomicAdd(p, w * ao.x);
  }
}

// As the forward, plus og [B, N, H, C] T; img_grad [B, I, H, C] f32 (zeroed),
// pts_grad [B, N, H, L, P, 2] and wts_grad [B, N, H, L, P] f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS)
    msda_stream_bwd_kernel(const T* __restrict__ img,
                           const float* __restrict__ pts,
                           const float* __restrict__ wts,
                           const T* __restrict__ og,
                           const int* __restrict__ order,
                           const int* __restrict__ starts,
                           const int* __restrict__ counts,
                           const int* __restrict__ slices,
                           float* __restrict__ img_grad,
                           float* __restrict__ pts_grad,
                           float* __restrict__ wts_grad, const LevelTable lv,
                           const TileTable tt, const int num_bins,
                           const int slice, const int I, const int H,
                           const int C, const int L, const int LP,
                           const int G, const bool vec, const bool zeros,
                           const bool align_corners) {
  int bin_id, done, count;
  block_work(counts, slices, num_bins, slice, &bin_id, &done, &count);
  if (count <= 0) return;  // the whole block leaves
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Tile t = block_tile(bin_id, H, L, lv, tt);
  stage_tile(tile, img, t, lv, I, H, C, vec);
  __syncthreads();

  const int hl = lv.h[t.l], wl = lv.w[t.l];
  const float xscale = (float)(align_corners ? wl - 1 : wl);
  const float yscale = (float)(align_corners ? hl - 1 : hl);
  const int64_t HC = (int64_t)H * C;
  // img_grad at pixel 0 of the tile's level, head h
  float* grad_level = img_grad + ((t.b * I + lv.offset[t.l]) * H + t.h) * C;
  const int* bin = order + starts[bin_id] + done;
  const int lane = threadIdx.x & 31;
  const int group = lane / G, c_lane = lane - group * G;
  const int per_step = 32 / G;
  for (int base = (threadIdx.x >> 5) * 32; base < count;
       base += STREAM_WARPS * 32) {
    const Preload p = preload(bin, base + lane, count, pts, wts, t, lv, C,
                              zeros, align_corners);
    const msda::Corners& pg = p.tc.g;
    // the four corner masks as bits: one shuffle shares them
    const int pm = (pg.mx0 != 0.f) | (pg.mx1 != 0.f) << 1 |
                   (pg.my0 != 0.f) << 2 | (pg.my1 != 0.f) << 3;
    const int chunk = min(32, count - base);
    for (int j0 = 0; j0 < chunk; j0 += per_step) {
      const int j = j0 + group;
      const bool valid = j < chunk;
      const int s = __shfl_sync(MSDA_FULL_MASK, p.s, j);
      const float a = __shfl_sync(MSDA_FULL_MASK, p.a, j);
      const int q00 = __shfl_sync(MSDA_FULL_MASK, p.tc.j00, j);
      const int q01 = __shfl_sync(MSDA_FULL_MASK, p.tc.j01, j);
      const int q10 = __shfl_sync(MSDA_FULL_MASK, p.tc.j10, j);
      const int q11 = __shfl_sync(MSDA_FULL_MASK, p.tc.j11, j);
      const int i00 = __shfl_sync(MSDA_FULL_MASK, pg.i00, j);
      const int i01 = __shfl_sync(MSDA_FULL_MASK, pg.i01, j);
      const int i10 = __shfl_sync(MSDA_FULL_MASK, pg.i10, j);
      const int i11 = __shfl_sync(MSDA_FULL_MASK, pg.i11, j);
      const float vx0 = __shfl_sync(MSDA_FULL_MASK, pg.vx0, j);
      const float vx1 = __shfl_sync(MSDA_FULL_MASK, pg.vx1, j);
      const float uy0 = __shfl_sync(MSDA_FULL_MASK, pg.uy0, j);
      const float uy1 = __shfl_sync(MSDA_FULL_MASK, pg.uy1, j);
      const int m = __shfl_sync(MSDA_FULL_MASK, pm, j);
      const float mx0 = (m & 1) ? 1.f : 0.f, mx1 = (m & 2) ? 1.f : 0.f;
      const float my0 = (m & 4) ? 1.f : 0.f, my1 = (m & 8) ? 1.f : 0.f;
      const T* og_row = og + (int64_t)(s / LP) * C;
      float sum_w = 0.f;
      double sum_x = 0.0, sum_y = 0.0;
      for (int c = c_lane * VEC; valid && c < C; c += G * VEC) {
        const float4 o = load_vec<VEC>(og_row + c);
        const float4 v00 = load_vec<VEC>(tile + q00 + c);
        const float4 v01 = load_vec<VEC>(tile + q01 + c);
        const float4 v10 = load_vec<VEC>(tile + q10 + c);
        const float4 v11 = load_vec<VEC>(tile + q11 + c);
        bwd_sums<VEC>(o, v00, v01, v10, v11, vx0, vx1, uy0, uy1, mx0, mx1,
                      my0, my1, sum_w, sum_x, sum_y);
        const float4 ao = make_float4(a * o.x, a * o.y, a * o.z, a * o.w);
        add_grad<VEC>(grad_level + i00 * HC + c, ao, uy0 * vx0);
        add_grad<VEC>(grad_level + i01 * HC + c, ao, uy0 * vx1);
        add_grad<VEC>(grad_level + i10 * HC + c, ao, uy1 * vx0);
        add_grad<VEC>(grad_level + i11 * HC + c, ao, uy1 * vx1);
      }
      sum_w = group_sum(sum_w, G);
      sum_x = group_sum(sum_x, G);
      sum_y = group_sum(sum_y, G);
      if (valid && c_lane == 0) {
        wts_grad[s] = sum_w;
        pts_grad[2 * (int64_t)s] = (float)((double)a * xscale * sum_x);
        pts_grad[2 * (int64_t)s + 1] = (float)((double)a * yscale * sum_y);
      }
    }
  }
}

// Lanes per sample: the sample's C / vec steps rounded up to a power of two,
// at most a warp.
int group_lanes(int C, int vec) {
  int g = 1;
  while (g * vec < C && g < 32) g <<= 1;
  return g;
}

// 16-byte copies for the staging: a pixel's channels are whole 16-byte
// pieces and img is 16-byte aligned.
template <typename T>
bool vec16(const void* img, int C) {
  return (C * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(img) % 16 == 0;
}

// What every streamed launch takes besides the tensors.
struct Launch {
  LevelTable lv;
  TileTable tt;
  int num_bins, blocks, slice, I, H, C, L, P;
  bool zeros, align_corners;
  cudaStream_t stream;
};

// Shared memory of a block: the largest img tile of the plan, in T.
template <typename T>
size_t smem_bytes(const Launch& g) {
  return (size_t)(max_tile_pixels(g.tt, g.lv, g.L) * g.C * sizeof(T));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int VEC>
int launch_fwd(const void* img, const void* pts, const void* wts,
               const void* order, const void* starts, const void* counts,
               const void* slices, void* out, const Launch& g) {
  const size_t smem = smem_bytes<T>(g);
  const cudaError_t err = allow_smem(msda_stream_fwd_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  msda_stream_fwd_kernel<T, VEC><<<g.blocks, STREAM_THREADS, smem,
                                   g.stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<const int*>(order),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const int*>(slices), static_cast<float*>(out), g.lv, g.tt,
      g.num_bins, g.slice, g.I, g.H, g.C, g.L, g.L * g.P,
      group_lanes(g.C, VEC), vec16<T>(img, g.C), g.zeros, g.align_corners);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd(const void* img, const void* pts, const void* wts,
               const void* og, const void* order, const void* starts,
               const void* counts, const void* slices, void* img_grad,
               void* pts_grad, void* wts_grad, const Launch& g) {
  const size_t smem = smem_bytes<T>(g);
  const cudaError_t err = allow_smem(msda_stream_bwd_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  msda_stream_bwd_kernel<T, VEC><<<g.blocks, STREAM_THREADS, smem,
                                   g.stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(pts),
      static_cast<const float*>(wts), static_cast<const T*>(og),
      static_cast<const int*>(order), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<const int*>(slices),
      static_cast<float*>(img_grad), static_cast<float*>(pts_grad),
      static_cast<float*>(wts_grad), g.lv, g.tt, g.num_bins, g.slice, g.I,
      g.H, g.C, g.L, g.L * g.P, group_lanes(g.C, VEC), vec16<T>(img, g.C),
      g.zeros, g.align_corners);
  return (int)cudaGetLastError();
}

// Four channels a step where C allows it and out_grad's rows are aligned
// for it (img's tile is, and out and img_grad are the wrapper's own).
bool vec4(int C, const void* og) {
  return C % 4 == 0 && reinterpret_cast<uintptr_t>(og) % 16 == 0;
}

template <typename T>
int dispatch_fwd(const void* img, const void* pts, const void* wts,
                 const void* order, const void* starts, const void* counts,
                 const void* slices, void* out, const Launch& g) {
  return g.C % 4 == 0
             ? launch_fwd<T, 4>(img, pts, wts, order, starts, counts, slices,
                                out, g)
             : launch_fwd<T, 1>(img, pts, wts, order, starts, counts, slices,
                                out, g);
}

template <typename T>
int dispatch_bwd(const void* img, const void* pts, const void* wts,
                 const void* og, const void* order, const void* starts,
                 const void* counts, const void* slices, void* img_grad,
                 void* pts_grad, void* wts_grad, const Launch& g) {
  return vec4(g.C, og)
             ? launch_bwd<T, 4>(img, pts, wts, og, order, starts, counts,
                                slices, img_grad, pts_grad, wts_grad, g)
             : launch_bwd<T, 1>(img, pts, wts, og, order, starts, counts,
                                slices, img_grad, pts_grad, wts_grad, g);
}

// Checks shared by the entry points; fills both tables.  Returns
// cudaSuccess, or cudaErrorInvalidValue when the shapes and the plan
// disagree with what the wrapper computed.
int tables(LevelTable& lv, TileTable& tt, const void* level_hw,
           const void* plan, int B, int I, int H, int L, int P,
           int num_bins) {
  if (L < 1 || L > MSDA_MAX_LEVELS || P < 1 || B < 0 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t pixels =
      msda::fill_levels(lv, static_cast<const int*>(level_hw), L);
  if (I >= 0 && pixels != I) return (int)cudaErrorInvalidValue;
  const int per_bh = fill_tiles(tt, lv, static_cast<const int*>(plan), L);
  if (per_bh < 0 || (int64_t)per_bh * B * H != num_bins) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

// The count kernel (order == nullptr) or the scatter kernel.
int launch_bins(const void* pts, void* bins, void* order,
                const void* level_hw, const void* plan, int B, int N, int H,
                int L, int P, int align_corners, int num_bins,
                void* stream) {
  LevelTable lv;
  TileTable tt;
  const int err = tables(lv, tt, level_hw, plan, B, -1, H, L, P, num_bins);
  if (err != (int)cudaSuccess) return err;
  if ((int64_t)B * N * H == 0) return (int)cudaSuccess;
  if ((int64_t)B * H > 65535) return (int)cudaErrorInvalidConfiguration;
  const int per_bh = tt.first[L];
  const bool local = per_bh <= BIN_LOCAL_MAX;
  const dim3 grid((N + BIN_QUERIES - 1) / BIN_QUERIES, B * H);
  const size_t smem = local ? per_bh * sizeof(int) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ac = align_corners != 0;
  if (order == nullptr) {
    msda_stream_count_kernel<<<grid, BIN_THREADS, smem, s>>>(
        static_cast<const float*>(pts), static_cast<int*>(bins), lv, tt, N,
        H, L, P, ac, local);
  } else {
    msda_stream_scatter_kernel<<<grid, BIN_THREADS, smem, s>>>(
        static_cast<const float*>(pts), static_cast<int*>(bins),
        static_cast<int*>(order), lv, tt, N, H, L, P, ac, local);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// level_hw: host array [L, 2] of (height, width); plan: host array [L, 2] of
// (yb, xb); num_bins = B * H * (tiles of one (b, h)), which the wrapper
// computed and sized `counts` by.  counts must hold zeros.
int msda_stream_count_launch(const void* pts, void* counts,
                             const void* level_hw, const void* plan, int B,
                             int N, int H, int L, int P, int align_corners,
                             int num_bins, void* stream) {
  return launch_bins(pts, counts, nullptr, level_hw, plan, B, N, H, L, P,
                     align_corners, num_bins, stream);
}

// cursor: the exclusive sum of the counts (advanced by the kernel); order:
// int [B * N * H * L * P], filled bin by bin.
int msda_stream_scatter_launch(const void* pts, void* cursor, void* order,
                               const void* level_hw, const void* plan, int B,
                               int N, int H, int L, int P, int align_corners,
                               int num_bins, void* stream) {
  return launch_bins(pts, cursor, order, level_hw, plan, B, N, H, L, P,
                     align_corners, num_bins, stream);
}

// Fills `g` for a kernel launch; returns a cudaError_t.
int launch_args(Launch& g, const void* level_hw, const void* plan, int B,
                int I, int N, int H, int C, int L, int P, int zeros,
                int align_corners, int num_bins, int blocks, int slice,
                void* stream) {
  if (C < 1 || slice < 1 || blocks < 0) return (int)cudaErrorInvalidValue;
  const int err =
      tables(g.lv, g.tt, level_hw, plan, B, I, H, L, P, num_bins);
  if (err != (int)cudaSuccess) return err;
  g.num_bins = num_bins;
  g.blocks = blocks;
  g.slice = slice;
  g.I = I;
  g.H = H;
  g.C = C;
  g.L = L;
  g.P = P;
  g.zeros = zeros != 0;
  g.align_corners = align_corners != 0;
  g.stream = static_cast<cudaStream_t>(stream);
  return (int)cudaSuccess;
}

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (img).  slices: int
// [num_bins], the first block of each bin's slices of `slice` samples;
// blocks: at least the number of slices.  out: f32 zeroed.
int msda_stream_fwd_launch(int dtype, const void* img, const void* pts,
                           const void* wts, const void* order,
                           const void* starts, const void* counts,
                           const void* slices, void* out,
                           const void* level_hw, const void* plan, int B,
                           int I, int N, int H, int C, int L, int P,
                           int zeros, int align_corners, int num_bins,
                           int blocks, int slice, void* stream) {
  Launch g;
  const int err = launch_args(g, level_hw, plan, B, I, N, H, C, L, P, zeros,
                              align_corners, num_bins, blocks, slice, stream);
  if (err != (int)cudaSuccess) return err;
  if (num_bins == 0 || N == 0 || blocks == 0) return (int)cudaSuccess;
  switch (dtype) {
    case 0:
      return dispatch_fwd<float>(img, pts, wts, order, starts, counts,
                                 slices, out, g);
    case 1:
      return dispatch_fwd<__half>(img, pts, wts, order, starts, counts,
                                  slices, out, g);
    case 2:
      return dispatch_fwd<__nv_bfloat16>(img, pts, wts, order, starts,
                                         counts, slices, out, g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype, slices and blocks as above (img and out_grad).  img_grad: f32
// zeroed; pts_grad and wts_grad: f32, every element written.
int msda_stream_bwd_launch(int dtype, const void* img, const void* pts,
                           const void* wts, const void* og, const void* order,
                           const void* starts, const void* counts,
                           const void* slices, void* img_grad,
                           void* pts_grad, void* wts_grad,
                           const void* level_hw, const void* plan, int B,
                           int I, int N, int H, int C, int L, int P,
                           int zeros, int align_corners, int num_bins,
                           int blocks, int slice, void* stream) {
  Launch g;
  const int err = launch_args(g, level_hw, plan, B, I, N, H, C, L, P, zeros,
                              align_corners, num_bins, blocks, slice, stream);
  if (err != (int)cudaSuccess) return err;
  if (num_bins == 0 || N == 0 || blocks == 0) return (int)cudaSuccess;
  switch (dtype) {
    case 0:
      return dispatch_bwd<float>(img, pts, wts, og, order, starts, counts,
                                 slices, img_grad, pts_grad, wts_grad, g);
    case 1:
      return dispatch_bwd<__half>(img, pts, wts, og, order, starts, counts,
                                  slices, img_grad, pts_grad, wts_grad, g);
    case 2:
      return dispatch_bwd<__nv_bfloat16>(img, pts, wts, og, order, starts,
                                         counts, slices, img_grad, pts_grad,
                                         wts_grad, g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
