// Streamed multiscale deformable attention for large pyramids, NVIDIA Hopper
// (sm_90a): the forward (K3') and the backward (K4' + K5', one kernel), with
// the binning kernels they share.
//
// Replaces the TPU kernels msda_tpu/ops/pallas_stream.py:_stream_fwd_kernel
// (:206, K3; pallas_call in stream_fwd), _stream_bwd_pts_kernel (:330, K4)
// and _stream_bwd_img_kernel (:411, K5; both pallas_calls in stream_bwd).
// They compute K1's and K2's functions (msda_fwd.cu, msda_bwd.cu) level by
// level over row bands, because a large pyramid does not fit the TPU's
// VMEM.  On an H100 the resident gather kernels run at any size, but once
// one image's pyramid outgrows the 50 MB L2 their gathers (and K2's
// atomics) go to device memory.  What carries over is the band
// decomposition; the E/A matrices, bf16 splits and padded pitch of the TPU
// form do not.  ops/stream.py routes a call here or to K1/K2.
//
// Tiles and bins.  The plan (ops/stream.py:band_plan) cuts level l into
// bands of yb rows and, where a row is too wide for a tile of
// STREAM_TILE_BYTES, columns of xb pixels.  A sample (b, n, h, l, p) belongs
// to the tile of its clamped top-left corner (y0c, x0c) from
// msda::corner_geometry, the geometry K1 and K2 use.  Its other corners lie
// at most one row below and one column right, so a tile is staged with one
// halo row and column where the level goes on.  The binning: a count
// kernel (per-(b, h) shared histograms), a one-block scan (where each bin
// starts, and the cost line below; coalesced through shared memory), and a
// scatter that writes each sample's record (x, y, weight, index) into its
// bin, laid out bin by bin in shared memory first so that each bin's run
// goes out contiguously.
//
// What bounded the first kernels (NVIDIA H100 80GB HBM3, 700 W, 256-base
// pyramid, B=4, N=10,000, f32, kernel alone; PERF.md, from
// docs/experiments/torch_stream_variants.py): one block a slice of a bin,
// a tile staged and waited for, and each sample's geometry broadcast by 9
// (K3') or 15 (K4' + K5') shuffles took 0.53 and 1.33 ms.  No single cost
// bound them: staging 0.13 / 0.15 ms, the out / img_grad atomics 0.07 /
// 0.22 ms, and computing the geometry in every lane of a group instead
// made them 1.6x / 1.3x slower.  By arithmetic: gathering each sample's
// point and weight reads a 32-byte sector of each for 12 bytes.
//
// Design.
//   * Persistent blocks, two an SM (256 threads; a ring of two tiles and
//     two slice buffers each), take chunks of a cost line (each bin's
//     samples at FWD/BWD_SAMPLE_BYTES and its staged bytes) from a counter
//     that the scan zeroes, so that a block that finishes early takes more.
//   * A slice is at most STREAM_SLICE records of one bin.  While one is
//     served, the next one's records and, where it starts another bin, its
//     tile are in flight as one cp.async group with an L2 evict-first
//     policy (they are read once), and consecutive slices of a bin keep
//     their tile.  cp.async commit groups and not TMA: one code path
//     takes ragged edge tiles and the element-wise fallback, and the
//     staging left to hide is small: K3' at the 256-base pyramid stages
//     0.41 GB (0.12 ms at 3.35 TB/s) and is 0.09 ms slower than without
//     staging (torch_stream_ablations.py), all that a tensor map could
//     save.
//   * One thread a sample computes its geometry once into shared memory;
//     each group of G lanes (VEC channels a lane, msda_lanes.cuh) reads its
//     own sample's entry there: no broadcast, and no geometry in every lane.
//   * K3' (msda_stream_fwd_kernel): a group serves a run of consecutive
//     records and sums those of one query (its points on this tile) in
//     registers, one 16-byte atomic per run into an f32 out buffer that
//     the wrapper zeroes and casts once.
//   * K4' + K5' (msda_stream_bwd_kernel): per sample, the weight gradient
//     and the two point-gradient sums from the f64 corner dot products, as
//     K2 computes them (msda_lanes.cuh corner_dots and point_sums), and the
//     img_grad terms a * out_grad * (lerp weight) of its four corners.  A
//     slice is counting-sorted in shared memory by its samples' top-left
//     pixel (native int atomics), so a group sums the terms of consecutive
//     samples on the same four pixels in registers and adds them once per
//     corner.  The point and weight gradients are stored at the record's
//     sample index.  Storing them in the bins' order for a second kernel
//     to put back made the kernel alone up to 5% faster and the whole call
//     up to 8% slower (PERF.md).  A shared-memory f32 img_grad tile (the TPU
//     form) was 2.1x slower (Hopper has no shared f32 atomic add), and
//     merging adds with __match_any_sync 2-2.5x in K2.
//
// Measured, old -> new on the same card in one call (torch_kernel_ab.py,
// device time of the kernel alone, then of the whole call with its
// binning, buffers and casts), f32 and bf16: at the 256-base pyramid K3'
// 0.542 -> 0.377 and 0.456 -> 0.336 ms (calls 0.681 -> 0.523, 0.613 ->
// 0.493), K4' + K5' 1.337 -> 1.297 and 1.321 -> 1.287 (calls 1.572 ->
// 1.540, 1.732 -> 1.697); at encoder layer 0's call of the full-width
// model at 1600x2666 K3' 1.668 -> 0.936 and 1.707 -> 1.008, K4' + K5'
// 4.917 -> 4.533 and 5.020 -> 4.879 (calls 5.450 -> 5.085, 5.641 ->
// 5.515).  The byte bounds (utils.bench.msda_bound) at the 256-base
// pyramid: 0.130 and 0.255 ms in f32.  Ablations (torch_stream_ablations.py,
// same card, kernel alone): a static split (one chunk a block) is
// 1.04-1.32x slower; at the 256-base pyramid in f32, K3' without its group
// loop would be 1.62x faster and without its out atomics 1.17x, K4' + K5'
// without its img_grad atomics 1.12x, without its group sums 1.12x and
// without storing its point and weight gradients 1.05x; the pixel sort
// gains 8% there (10% at the 1600x2666 call) and the merging of runs 3%
// (10%).
//
// Interface: plain C entry points, loaded with ctypes by
// msda_tpu_torch/ops/cuda_stream.py.  Each launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <algorithm>
#include <climits>
#include <cstdint>

#include "msda_geometry.cuh"
#include "msda_lanes.cuh"

// The launch constants below may be set by a build (-D; each is guarded
// by #ifndef), as msda_tpu_torch.autotune sweeps them; STREAM_TILE_BYTES
// may not, since ops/stream.py plans the tiles with the same number.
#ifndef STREAM_THREADS
#define STREAM_THREADS 256
#endif
#define STREAM_WARPS (STREAM_THREADS / 32)
// blocks of the streamed kernels an SM holds: two rings of two tiles
#ifndef STREAM_BLOCKS_PER_SM
#define STREAM_BLOCKS_PER_SM 2
#endif
// samples of a slice, whose records a block holds at once
#ifndef STREAM_SLICE
#define STREAM_SLICE 512
#endif
// keys of the backward's counting sort (tile pixels, shifted to fit)
#ifndef SORT_KEYS
#define SORT_KEYS 1024
#endif
static_assert(STREAM_THREADS % 32 == 0 && SORT_KEYS % STREAM_THREADS == 0,
              "STREAM_THREADS: whole warps, dividing SORT_KEYS");
// shared memory of one staged tile (ops/stream.py TILE_BYTES): two blocks
// of two tiles and the backward's slice buffers fill an SM's 228 KB
#define STREAM_TILE_BYTES 45056
// a sample's weight on the cost line that splits the work into chunks, in
// bytes of staged tile, and the chunks per block (the best of the values
// timed at the 256-base pyramid and the 1600x2666 model call, f32 and
// bf16: PERF.md)
#ifndef FWD_SAMPLE_BYTES
#define FWD_SAMPLE_BYTES 256
#endif
#ifndef BWD_SAMPLE_BYTES
#define BWD_SAMPLE_BYTES 768
#endif
#ifndef FWD_CHUNKS_PER_BLOCK
#define FWD_CHUNKS_PER_BLOCK 4
#endif
#ifndef BWD_CHUNKS_PER_BLOCK
#define BWD_CHUNKS_PER_BLOCK 8
#endif
#define BIN_THREADS 256
#define BIN_QUERIES 128
// bins of one (b, h) that a binning block counts in shared memory (48 KB)
#define BIN_LOCAL_MAX 12288
// shared memory a scatter block may take to lay its records out in order
#define BIN_ORDER_SMEM 98304
#define SCAN_THREADS 1024
// bins a scan thread takes per pass (a pass fills 32 KB of shared memory)
#define SCAN_BINS 4
// tiles of one (b, h) whose staged pixels the scan keeps in shared memory
#define SCAN_TABLE 3072

namespace {

using msda::add_grad;
using msda::corner_dots;
using msda::group_lanes;
using msda::group_sum;
using msda::LevelTable;
using msda::load_vec;
using msda::point_sums;
using msda::vec16;

// the slice buffers: two of a record (x, y, weight, sample index) per
// sample, and one of its prepared corners; the backward adds the key counts
// of its sort and a place per sample
constexpr size_t REC_BYTES =
    STREAM_SLICE * (2 * sizeof(float4) + sizeof(int2));
constexpr size_t SORT_BYTES =
    REC_BYTES + SORT_KEYS * sizeof(int) + STREAM_SLICE * sizeof(short);

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
  // the clamped corners do not depend on the padding mode
  const msda::Corners g = msda::corner_geometry(
      pts[2 * s], pts[2 * s + 1], lv.h[l], lv.w[l], 0, false, align_corners);
  return tt.first[l] + (g.y0c / tt.yb[l]) * tt.ncb[l] + g.x0c / tt.xb[l];
}

// Exclusive sum of v over the threads of the block (every thread calls it);
// `total` gets the sum.  scratch: 32 values of shared memory.
template <typename V>
__device__ __forceinline__ V block_exclusive_sum(const V v, V* scratch,
                                                 V& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  V x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const V y = __shfl_up_sync(MSDA_FULL_MASK, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    V s = lane < warps ? scratch[lane] : V(0);
    for (int d = 1; d < 32; d <<= 1) {
      const V y = __shfl_up_sync(MSDA_FULL_MASK, s, d);
      if (lane >= d) s += y;
    }
    scratch[lane] = s;  // the warps' inclusive sums
  }
  __syncthreads();
  total = scratch[warps - 1];
  const V before = warp == 0 ? V(0) : scratch[warp - 1];
  __syncthreads();  // scratch is free again
  return before + x - v;
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

// The binning's scatter: each sample's record (x, y, weight, sample index
// as float bits) goes into its bin's segment of `records`.  The streamed kernels then read a bin's records in order, 16 bytes a
// sample, where gathering each sample's point and weight would read a
// 32-byte sector of each for 12 bytes.  With `local` (the block's bins and
// records fit shared memory) the block counts its samples per bin,
// reserves a range of each bin (one global atomic per bin), lays its
// records out in shared memory bin by bin, and writes each bin's run out
// contiguously; otherwise each sample takes its place with a global atomic.
__global__ void __launch_bounds__(BIN_THREADS)
    msda_stream_scatter_kernel(const float* __restrict__ pts,
                               const float* __restrict__ wts,
                               int* __restrict__ cursor,
                               float4* __restrict__ records,
                               const LevelTable lv,
                               const TileTable tt, const int N, const int H,
                               const int L, const int P,
                               const bool align_corners, const bool local) {
  extern __shared__ __align__(16) unsigned char bin_smem[];
  const int per_bh = tt.first[L], LP = L * P;
  const int bh = blockIdx.y, n0 = blockIdx.x * BIN_QUERIES;
  const int samples = min(BIN_QUERIES, N - n0) * LP;
  int* next = cursor + (int64_t)bh * per_bh;
  const int64_t task0 = ((int64_t)(bh / H) * N + n0) * H + bh % H;
  // local: the laid-out records [BIN_QUERIES * LP], then hist and delta
  // [per_bh], then the bins of the laid-out records and of the samples
  // [BIN_QUERIES * LP] each (the first the scan's scratch until then)
  float4* laid = reinterpret_cast<float4*>(bin_smem);
  int* hist = reinterpret_cast<int*>(laid + BIN_QUERIES * LP);
  int* delta = hist + per_bh;
  unsigned short* laid_bin = reinterpret_cast<unsigned short*>(delta + per_bh);
  unsigned short* sample_bin = laid_bin + BIN_QUERIES * LP;
  if (local) {
    for (int k = threadIdx.x; k < per_bh; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < samples; i += blockDim.x) {
      const int q = i / LP, k = i - q * LP;
      const int key = local_bin(pts, (task0 + (int64_t)q * H) * LP + k,
                                k / P, lv, tt, align_corners);
      sample_bin[i] = (unsigned short)key;
      atomicAdd(hist + key, 1);
    }
    __syncthreads();
    // hist -> the block's exclusive offsets; delta: a bin's global place
    // less its block offset
    const int per = (per_bh + BIN_THREADS - 1) / BIN_THREADS;
    const int lo = min(per_bh, (int)threadIdx.x * per);
    const int hi = min(per_bh, lo + per);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += hist[k];
    int total;
    int off =
        block_exclusive_sum(sum, reinterpret_cast<int*>(laid_bin), total);
    for (int k = lo; k < hi; ++k) {
      const int c = hist[k];
      hist[k] = off;
      if (c != 0) delta[k] = atomicAdd(next + k, c) - off;
      off += c;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < samples; i += blockDim.x) {
    const int q = i / LP, k = i - q * LP;
    const int64_t s = (task0 + (int64_t)q * H) * LP + k;
    const int key = local ? sample_bin[i]
                          : local_bin(pts, s, k / P, lv, tt, align_corners);
    const float4 rec = make_float4(pts[2 * s], pts[2 * s + 1], wts[s],
                                   __int_as_float((int)s));
    if (local) {
      const int at = atomicAdd(hist + key, 1);
      laid[at] = rec;
      laid_bin[at] = (unsigned short)key;
    } else {
      records[atomicAdd(next + key, 1)] = rec;
    }
  }
  if (local) {
    __syncthreads();
    for (int i = threadIdx.x; i < samples; i += blockDim.x) {
      records[delta[laid_bin[i]] + i] = laid[i];
    }
  }
}

// The tile of a bin: its level, origin and staged extent.
struct Tile {
  int l, y0, x0, rows, cols;
  int64_t b, h;
};

__device__ __forceinline__ Tile bin_tile(const int bin, const int H,
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

// One block: starts = cursor = the exclusive sum of the counts (where each
// bin's samples begin in `records`), and staged = the exclusive sum of the
// pixels of the non-empty bins' tiles, with staged[bins] the total: the
// cost line on which the streamed kernels split their work; staged[bins + 1]
// = 0, the counter from which their blocks take chunks of that line.  The
// block takes SCAN_THREADS * SCAN_BINS bins a pass, thread t the SCAN_BINS
// consecutive ones from t * SCAN_BINS, and a carry joins the passes.  The
// counts come in and the sums go out through shared memory, so that every
// global access of a warp is coalesced (a thread's own run would put a
// warp's loads and stores 32 sectors apart); the tiles' pixels come from a
// table of the tiles of one (b, h) where it fits.
__global__ void __launch_bounds__(SCAN_THREADS)
    msda_stream_scan_kernel(const int* __restrict__ counts,
                            int* __restrict__ starts,
                            int* __restrict__ cursor,
                            int64_t* __restrict__ staged,
                            const LevelTable lv, const TileTable tt,
                            const int bins, const int L) {
  constexpr int PASS = SCAN_THREADS * SCAN_BINS;
  __shared__ int64_t scratch[32];
  __shared__ int64_t pass[PASS];
  __shared__ int table[SCAN_TABLE];
  const int per_bh = tt.first[L];
  const bool tabled = per_bh <= SCAN_TABLE;
  auto tile_pixels = [&](const int k) {
    const Tile t = bin_tile(k, 1, L, lv, tt);
    return t.rows * t.cols;
  };
  if (tabled) {
    for (int k = threadIdx.x; k < per_bh; k += SCAN_THREADS) {
      table[k] = tile_pixels(k);
    }
  }
  const int own = (int)threadIdx.x * SCAN_BINS;
  int64_t n_carry = 0, px_carry = 0;
  for (int base = 0; base < bins; base += PASS) {
    for (int k = threadIdx.x; k < PASS; k += SCAN_THREADS) {
      pass[k] = base + k < bins ? counts[base + k] : 0;
    }
    __syncthreads();
    int c[SCAN_BINS], px[SCAN_BINS];
    int64_t n = 0, p = 0;
#pragma unroll
    for (int j = 0; j < SCAN_BINS; ++j) {
      c[j] = (int)pass[own + j];
      px[j] = 0;
      if (c[j] > 0) {
        const int k = (base + own + j) % per_bh;
        px[j] = tabled ? table[k] : tile_pixels(k);
      }
      n += c[j];
      p += px[j];
    }
    int64_t n_total, px_total;
    // (the sums' barriers also order every read of pass before the writes)
    n = block_exclusive_sum(n, scratch, n_total) + n_carry;
    p = block_exclusive_sum(p, scratch, px_total) + px_carry;
#pragma unroll
    for (int j = 0; j < SCAN_BINS; ++j) {
      pass[own + j] = n;
      n += c[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < PASS && base + k < bins; k += SCAN_THREADS) {
      starts[base + k] = cursor[base + k] = (int)pass[k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SCAN_BINS; ++j) {
      pass[own + j] = p;
      p += px[j];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < PASS && base + k < bins; k += SCAN_THREADS) {
      staged[base + k] = pass[k];
    }
    n_carry += n_total;
    px_carry += px_total;
    __syncthreads();  // pass is read before the next one overwrites it
  }
  if (threadIdx.x == 0) {
    staged[bins] = px_carry;
    staged[bins + 1] = 0;  // the streamed kernels' chunk counter
  }
}

__device__ __forceinline__ int64_t min64(const int64_t a, const int64_t b) {
  return a < b ? a : b;
}

// What a streamed kernel walks: the binned samples, and the cost of a
// sample and of a staged pixel on the line that splits them among blocks.
struct Bins {
  const float4* records;
  const int* starts;
  const int* counts;
  const int64_t* staged;
  unsigned long long* chunk;  // the next chunk to take
  int num, chunks;
  int64_t samples, sample_cost, pixel_cost;
};

// The cost line up to the start of bin i: its samples and the pixels of the
// non-empty tiles before it.
__device__ __forceinline__ int64_t bin_cost(const Bins& w, const int i) {
  return (int64_t)w.starts[i] * w.sample_cost + w.staged[i] * w.pixel_cost;
}

// The first sample of chunk k: the chunks cut the cost line into equal
// parts, and a part that begins inside a bin begins at the sample its
// share of the bin's cost gives.  Monotone in k, so the chunks tile
// `records`.
__device__ int64_t split_point(const Bins& w, const int k) {
  if (k >= w.chunks) return w.samples;
  const int64_t total =
      w.samples * w.sample_cost + w.staged[w.num] * w.pixel_cost;
  const int64_t target =
      total / w.chunks * k + total % w.chunks * k / w.chunks;
  int lo = 0, hi = w.num;  // the last bin whose cost begins by target
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (bin_cost(w, mid) <= target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int64_t c0 = bin_cost(w, lo);
  const int64_t c1 =
      (int64_t)(w.starts[lo] + w.counts[lo]) * w.sample_cost +
      w.staged[lo + 1] * w.pixel_cost;
  if (c1 <= c0) return w.starts[lo];
  const int64_t into = (int64_t)((double)(target - c0) / (double)(c1 - c0) *
                                 (double)w.counts[lo]);
  return w.starts[lo] + min64(into, w.counts[lo]);
}

// The bin that holds position pos of `records` (pos < samples): the last bin
// that starts at or before it, which is never an empty one.
__device__ int bin_at(const Bins& w, const int64_t pos) {
  int lo = 0, hi = w.num;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (w.starts[mid] <= pos) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A slice of a block's share: records[p, p + n) of one bin (n = 0: none).
struct Slice {
  int bin, n;
  int64_t p;
};

__device__ __forceinline__ Slice make_slice(const Bins& w, const int bin,
                                            const int64_t p,
                                            const int64_t hi) {
  const int64_t end = min64(hi, (int64_t)w.starts[bin] + w.counts[bin]);
  return {bin, (int)min64(STREAM_SLICE, end - p), p};
}

// The slice after s in the share [.., hi): the rest of s's bin, else the
// first samples of the next non-empty bin.
__device__ __forceinline__ Slice next_slice(const Bins& w, const Slice& s,
                                            const int64_t hi) {
  const int64_t p = s.p + s.n;
  if (s.n == 0 || p >= hi) return {s.bin, 0, p};
  int bin = s.bin;
  if (p >= (int64_t)w.starts[bin] + w.counts[bin]) {
    do {
      ++bin;  // p < hi <= samples: a non-empty bin starts at p
    } while (w.counts[bin] == 0);
  }
  return make_slice(w, bin, p, hi);
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An L2 policy for data read once: its lines are the first to go, so that
// what the kernels add into (out, img_grad) and re-read (out_grad) stays.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src,
                                           const uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          smem_address(smem_dst)),
      "l"(gmem_src), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copies a tile of img [B, I, H, C] into shared memory, rows of t.cols
// pixels.  With `vec` (a pixel's C channels are whole 16-byte pieces and img
// is 16-byte aligned) as 16-byte cp.async copies that the caller commits
// and waits for; otherwise one element at a time, done on return.
template <typename T>
__device__ __forceinline__ void stage_tile(T* __restrict__ tile,
                                           const T* __restrict__ img,
                                           const Tile& t,
                                           const LevelTable& lv, const int I,
                                           const int H, const int C,
                                           const bool vec,
                                           const uint64_t policy) {
  const int64_t HC = (int64_t)H * C;
  const T* level = img + (t.b * I + lv.offset[t.l]) * HC + t.h * C;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int V = C / E;
    const int n = t.rows * t.cols * V;
    for (int v = threadIdx.x; v < n; v += STREAM_THREADS) {
      const int px = v / V, k = v - px * V;
      const int y = px / t.cols, x = px - y * t.cols;
      cp_async16(tile + px * C + k * E,
                 level + ((int64_t)(t.y0 + y) * lv.w[t.l] + t.x0 + x) * HC +
                     k * E,
                 policy);
    }
  } else {
    const int n = t.rows * t.cols * C;
    for (int e = threadIdx.x; e < n; e += STREAM_THREADS) {
      const int px = e / C, c = e - px * C;
      const int y = px / t.cols, x = px - y * t.cols;
      tile[e] = level[((int64_t)(t.y0 + y) * lv.w[t.l] + t.x0 + x) * HC + c];
    }
  }
}

// Copies the records of a slice into rec (a cp.async group the caller
// commits and waits for).
__device__ __forceinline__ void stage_records(float4* __restrict__ rec,
                                              const Bins& w, const Slice& s,
                                              const uint64_t policy) {
  for (int k = threadIdx.x; k < s.n; k += STREAM_THREADS) {
    cp_async16(rec + k, w.records + s.p + k, policy);
  }
}

// The persistent walk both kernels share.  A block takes chunks of the
// cost line in turn (w.chunk counts them out) and serves each chunk's
// part of `records` (split_point) slice by slice: a slice is at most
// STREAM_SLICE samples of one bin, served from that bin's tile.  While a
// slice is served, the next slice's records (and its tile, where it starts
// another bin) are in flight as one cp.async group; two tile buffers and
// two record buffers form the rings, and consecutive slices of one bin
// keep their tile.  serve(tile, t, rec, n) serves the n records of rec on
// tile t (and may overwrite them); every thread calls
// it, after the barrier that makes its data visible and before the next
// one, which it must not cross with reads of rec or tile.
template <typename T, typename Serve>
__device__ __forceinline__ void walk(const T* __restrict__ img,
                                     const Bins& w, T* tiles,
                                     const int tile_elems, float4* recs,
                                     const LevelTable& lv,
                                     const TileTable& tt, const int I,
                                     const int H, const int C, const int L,
                                     const bool vec, Serve&& serve) {
  const uint64_t policy = evict_first();
  int* slot = reinterpret_cast<int*>(recs);  // free between chunks
  for (;;) {
    __syncthreads();  // the last chunk is served
    if (threadIdx.x == 0) *slot = (int)atomicAdd(w.chunk, 1ull);
    __syncthreads();
    const int k = *slot;
    __syncthreads();  // read before the records overwrite it
    if (k >= w.chunks) return;  // the whole block leaves
    const int64_t lo = split_point(w, k), hi = split_point(w, k + 1);
    if (lo >= hi) continue;
    Slice cur = make_slice(w, bin_at(w, lo), lo, hi);
    stage_tile(tiles, img, bin_tile(cur.bin, H, L, lv, tt), lv, I, H, C, vec,
               policy);
    stage_records(recs, w, cur, policy);
    cp_async_commit();
    Slice next = next_slice(w, cur, hi);
    int tb = 0, rb = 0;  // the current slice's tile and record buffers
    for (;;) {
      cp_async_wait_all();
      __syncthreads();  // the slice's data is in; the last one is served
      const int ntb = next.bin == cur.bin ? tb : tb ^ 1;
      if (next.n > 0) {
        if (ntb != tb) {
          stage_tile(tiles + ntb * tile_elems, img,
                     bin_tile(next.bin, H, L, lv, tt), lv, I, H, C, vec,
                     policy);
        }
        stage_records(recs + (rb ^ 1) * STREAM_SLICE, w, next, policy);
      }
      cp_async_commit();
      serve(tiles + tb * tile_elems, bin_tile(cur.bin, H, L, lv, tt),
            recs + rb * STREAM_SLICE, cur.n);
      if (next.n == 0) break;
      cur = next;
      next = next_slice(w, next, hi);
      tb = ntb;
      rb ^= 1;
    }
  }
}

// One 16-byte vector atomic (VEC = 4) or one f32 atomic.
template <int VEC>
__device__ __forceinline__ void red(float* p, const float4& v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
  } else {
    atomicAdd(p, v.x);
  }
}

__device__ __forceinline__ void axpy4(float4& acc, const float w,
                                      const float4& v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

using msda::divide;
using msda::fast_div;
using msda::FastDiv;

// A prepared sample: what its group needs, computed once per sample by one
// thread (not by each of the group's G lanes).  `bits` holds the tile
// element offset of the top-left corner (bits 0-15; a tile has at most
// 22,528 elements), the corner steps x1c - x0c and y1c - y0c (bits 16, 17),
// and in the backward the zeros-mode masks mx0, mx1, my0, my1 (bits 18-21)
// and the sort key (bits 22-31).
__device__ __forceinline__ int pack_corners(const msda::Corners& cg,
                                            const Tile& t, const int C) {
  const int px = (cg.y0c - t.y0) * t.cols + cg.x0c - t.x0;
  return px * C | (cg.x1c - cg.x0c) << 16 | (cg.y1c - cg.y0c) << 17;
}

// The four corners' element offsets into the tile from `bits`.
struct TileOffsets {
  int q00, q01, q10, q11;
};

__device__ __forceinline__ TileOffsets tile_offsets(const int bits,
                                                    const Tile& t,
                                                    const int C) {
  const int q00 = bits & 0xffff;
  const int qx = (bits >> 16 & 1) * C, qy = (bits >> 17 & 1) * t.cols * C;
  return {q00, q00 + qx, q00 + qy, q00 + qx + qy};
}

// The lane-group layout of a block: G lanes a sample, VEC channels a lane.
struct Lanes {
  int group, groups, c0, step;
  bool merge;  // one channel step covers C: a lane's sums stay in registers
};

__device__ __forceinline__ Lanes lanes(const int G, const int C,
                                       const int vec) {
  const int lane = threadIdx.x & 31;
  Lanes g;
  g.group = (threadIdx.x >> 5) * (32 / G) + lane / G;
  g.groups = STREAM_WARPS * (32 / G);
  g.c0 = (lane % G) * vec;
  g.step = G * vec;
  g.merge = C <= g.step;
  return g;
}

// img: [B, I, H, C] T; w: the binned records; out [B, N, H, C] f32, zeroed.
template <typename T, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_BLOCKS_PER_SM)
    msda_stream_fwd_kernel(const T* __restrict__ img, const Bins w,
                           float* __restrict__ out, const LevelTable lv,
                           const TileTable tt, const int tile_elems,
                           const int I, const int H, const int C,
                           const int L, const FastDiv LP, const int G,
                           const bool vec, const bool zeros,
                           const bool align_corners) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  float4* recs =
      reinterpret_cast<float4*>(smem + 2 * (size_t)tile_elems * sizeof(T));
  int2* meta = reinterpret_cast<int2*>(recs + 2 * STREAM_SLICE);
  const Lanes g = lanes(G, C, VEC);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  walk(img, w, tiles, tile_elems, recs, lv, tt, I, H, C, L, vec,
       [&](const T* tile, const Tile& t, float4* rec, const int n) {
         // 1. one thread a sample: its four corner weights (times its
         // attention weight) in place of its record, its out row and
         // corners in meta
         const int hl = lv.h[t.l], wl = lv.w[t.l];
         for (int k = threadIdx.x; k < n; k += STREAM_THREADS) {
           const float4 r = rec[k];
           const msda::Corners cg = msda::corner_geometry(
               r.x, r.y, hl, wl, 0, zeros, align_corners);
           rec[k] = make_float4(r.z * cg.uy0 * cg.vx0, r.z * cg.uy0 * cg.vx1,
                                r.z * cg.uy1 * cg.vx0, r.z * cg.uy1 * cg.vx1);
           meta[k] = make_int2(divide(__float_as_int(r.w), LP),
                               pack_corners(cg, t, C));
         }
         __syncthreads();
         // 2. each group serves a run of consecutive samples; those of one
         // query (its points on this tile) sum in registers and add once
         const int per = (n + g.groups - 1) / g.groups;
         const int first = g.group * per, last = min(n, first + per);
         int row = -1;
         float4 acc = zero;
         for (int k = first; k < last; ++k) {
           const float4 u = rec[k];
           const int2 m = meta[k];
           const TileOffsets o = tile_offsets(m.y, t, C);
           if (g.merge && m.x != row) {
             if (row >= 0 && g.c0 < C) {
               red<VEC>(out + (int64_t)row * C + g.c0, acc);
             }
             row = m.x;
             acc = zero;
           }
           for (int c = g.c0; c < C; c += g.step) {
             const float4 v00 = load_vec<VEC>(tile + o.q00 + c);
             const float4 v01 = load_vec<VEC>(tile + o.q01 + c);
             const float4 v10 = load_vec<VEC>(tile + o.q10 + c);
             const float4 v11 = load_vec<VEC>(tile + o.q11 + c);
             const float4 v = make_float4(
                 u.x * v00.x + u.y * v01.x + u.z * v10.x + u.w * v11.x,
                 u.x * v00.y + u.y * v01.y + u.z * v10.y + u.w * v11.y,
                 u.x * v00.z + u.y * v01.z + u.z * v10.z + u.w * v11.z,
                 u.x * v00.w + u.y * v01.w + u.z * v10.w + u.w * v11.w);
             if (g.merge) {
               axpy4(acc, 1.f, v);
             } else {
               red<VEC>(out + (int64_t)m.x * C + c, v);
             }
           }
         }
         if (g.merge && row >= 0 && g.c0 < C) {
           red<VEC>(out + (int64_t)row * C + g.c0, acc);
         }
       });
}

// As the forward, plus og [B, N, H, C] T; img_grad [B, I, H, C] f32
// (zeroed); pts_grad [B, N, H, L, P] f32x2 and wts_grad [B, N, H, L, P] f32,
// written at each record's sample index; shift: the sort key is a tile
// pixel >> shift (< SORT_KEYS).
template <typename T, int VEC>
__global__ void __launch_bounds__(STREAM_THREADS, STREAM_BLOCKS_PER_SM)
    msda_stream_bwd_kernel(const T* __restrict__ img,
                           const T* __restrict__ og, const Bins w,
                           float* __restrict__ img_grad,
                           float2* __restrict__ pts_grad,
                           float* __restrict__ wts_grad, const LevelTable lv,
                           const TileTable tt, const int tile_elems,
                           const int shift, const int I, const int H,
                           const int C, const int L, const FastDiv LP,
                           const int G, const bool vec, const bool zeros,
                           const bool align_corners) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  float4* recs =
      reinterpret_cast<float4*>(smem + 2 * (size_t)tile_elems * sizeof(T));
  int2* meta = reinterpret_cast<int2*>(recs + 2 * STREAM_SLICE);
  int* hist = reinterpret_cast<int*>(meta + STREAM_SLICE);
  unsigned short* perm = reinterpret_cast<unsigned short*>(hist + SORT_KEYS);
  // the scan's scratch: perm is free until the scatter writes it
  int* scratch = reinterpret_cast<int*>(perm);
  for (int k = threadIdx.x; k < SORT_KEYS; k += STREAM_THREADS) hist[k] = 0;
  const Lanes g = lanes(G, C, VEC);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t HC = (int64_t)H * C;

  walk(img, w, tiles, tile_elems, recs, lv, tt, I, H, C, L, vec,
       [&](const T* tile, const Tile& t, float4* rec, const int n) {
         const int hl = lv.h[t.l], wl = lv.w[t.l];
         // 1. one thread a sample: (dx, dy, weight, index) in place of its
         // record, its top-left pixel, corners and masks in meta; and a
         // counting sort of the slice by the tile pixel of that corner
         for (int k = threadIdx.x; k < n; k += STREAM_THREADS) {
           const float4 r = rec[k];
           const msda::Corners cg = msda::corner_geometry(
               r.x, r.y, hl, wl, 0, zeros, align_corners);
           const int key =
               ((cg.y0c - t.y0) * t.cols + cg.x0c - t.x0) >> shift;
           rec[k] = make_float4(cg.dx, cg.dy, r.z, r.w);
           meta[k] = make_int2(
               cg.i00, pack_corners(cg, t, C) | (cg.mx0 != 0.f) << 18 |
                           (cg.mx1 != 0.f) << 19 | (cg.my0 != 0.f) << 20 |
                           (cg.my1 != 0.f) << 21 | key << 22);
           atomicAdd(hist + key, 1);
         }
         __syncthreads();
         {
           constexpr int E = SORT_KEYS / STREAM_THREADS;
           int v[E], sum = 0;
#pragma unroll
           for (int e = 0; e < E; ++e) {
             v[e] = hist[threadIdx.x * E + e];
             sum += v[e];
           }
           int total;
           int before = block_exclusive_sum(sum, scratch, total);
#pragma unroll
           for (int e = 0; e < E; ++e) {
             hist[threadIdx.x * E + e] = before;
             before += v[e];
           }
           __syncthreads();
           for (int k = threadIdx.x; k < n; k += STREAM_THREADS) {
             perm[atomicAdd(hist + ((unsigned)meta[k].y >> 22), 1)] =
                 (unsigned short)k;
           }
           __syncthreads();
           for (int k = threadIdx.x; k < SORT_KEYS; k += STREAM_THREADS) {
             hist[k] = 0;  // for the next slice
           }
         }

         // 2. each group serves a run of consecutive sorted samples; the
         // img_grad terms of consecutive samples on the same four pixels
         // sum in registers and add once per corner
         const float xscale = (float)(align_corners ? wl - 1 : wl);
         const float yscale = (float)(align_corners ? hl - 1 : hl);
         float* grad_level =
             img_grad + ((t.b * I + lv.offset[t.l]) * H + t.h) * C;
         const int per = (n + g.groups - 1) / g.groups;
         const int first = g.group * per;
         int r00 = -1, r01 = 0, r10 = 0, r11 = 0;  // the run's corners
         int nz = 0;  // the run's corners with a non-zero weight, as bits
         float4 a00 = zero, a01 = zero, a10 = zero, a11 = zero;
         auto flush = [&]() {
           if (g.c0 >= C) return;
           if (nz & 1) red<VEC>(grad_level + r00 * HC + g.c0, a00);
           if (nz & 2) red<VEC>(grad_level + r01 * HC + g.c0, a01);
           if (nz & 4) red<VEC>(grad_level + r10 * HC + g.c0, a10);
           if (nz & 8) red<VEC>(grad_level + r11 * HC + g.c0, a11);
         };
         // every lane runs every step (the group sums need whole warps); a
         // step past the group's run serves sample 0 and writes nothing
         for (int j = 0; j < per; ++j) {
           const int k = first + j;
           const bool valid = k < n;
           const int e = valid ? perm[k] : 0;
           const float4 r = rec[e];
           const int2 m = meta[e];
           const int s = __float_as_int(r.w);
           const float a = r.z;
           const float mx0 = m.y >> 18 & 1, mx1 = m.y >> 19 & 1;
           const float my0 = m.y >> 20 & 1, my1 = m.y >> 21 & 1;
           // as msda::corner_geometry computes them
           const float vx0 = mx0 != 0.f ? 1.f - r.x : 0.f;
           const float vx1 = mx1 != 0.f ? r.x : 0.f;
           const float uy0 = my0 != 0.f ? 1.f - r.y : 0.f;
           const float uy1 = my1 != 0.f ? r.y : 0.f;
           const TileOffsets o = tile_offsets(m.y, t, C);
           const int i00 = m.x, i01 = i00 + (m.y >> 16 & 1);
           const int i10 = i00 + (m.y >> 17 & 1) * wl;
           const int i11 = i10 + (m.y >> 16 & 1);
           const float w00 = uy0 * vx0, w01 = uy0 * vx1;
           const float w10 = uy1 * vx0, w11 = uy1 * vx1;
           if (g.merge && valid && (i00 != r00 || i11 != r11)) {
             flush();
             r00 = i00;
             r01 = i01;
             r10 = i10;
             r11 = i11;
             nz = 0;
             a00 = a01 = a10 = a11 = zero;
           }
           const T* og_row = og + (int64_t)divide(s, LP) * C;
           double dots[4] = {0.0, 0.0, 0.0, 0.0};
           for (int c = g.c0; c < C; c += g.step) {
             const float4 ov = load_vec<VEC>(og_row + c);
             const float4 v00 = load_vec<VEC>(tile + o.q00 + c);
             const float4 v01 = load_vec<VEC>(tile + o.q01 + c);
             const float4 v10 = load_vec<VEC>(tile + o.q10 + c);
             const float4 v11 = load_vec<VEC>(tile + o.q11 + c);
             corner_dots<VEC>(ov, v00, v01, v10, v11, dots);
             if (valid) {
               const float4 ao =
                   make_float4(a * ov.x, a * ov.y, a * ov.z, a * ov.w);
               if (g.merge) {
                 axpy4(a00, w00, ao);
                 axpy4(a01, w01, ao);
                 axpy4(a10, w10, ao);
                 axpy4(a11, w11, ao);
               } else {
                 add_grad<VEC>(grad_level + i00 * HC + c, ao, w00);
                 add_grad<VEC>(grad_level + i01 * HC + c, ao, w01);
                 add_grad<VEC>(grad_level + i10 * HC + c, ao, w10);
                 add_grad<VEC>(grad_level + i11 * HC + c, ao, w11);
               }
             }
           }
           if (valid) {
             nz |= (w00 != 0.f) | (w01 != 0.f) << 1 | (w10 != 0.f) << 2 |
                   (w11 != 0.f) << 3;
           }
           float sum_w;
           double sum_x, sum_y;
           point_sums(dots, vx0, vx1, uy0, uy1, mx0, mx1, my0, my1, sum_w,
                      sum_x, sum_y);
           sum_w = group_sum(sum_w, G);
           sum_x = group_sum(sum_x, G);
           sum_y = group_sum(sum_y, G);
           if (valid && (threadIdx.x & 31) % G == 0) {
             pts_grad[s] = make_float2((float)((double)a * xscale * sum_x),
                                       (float)((double)a * yscale * sum_y));
             wts_grad[s] = sum_w;
           }
         }
         if (g.merge) flush();
       });
}

// What every streamed launch takes besides the tensors.
struct Launch {
  LevelTable lv;
  TileTable tt;
  int num_bins, I, H, C, L, P;
  int64_t samples;
  bool zeros, align_corners;
  cudaStream_t stream;
};

// The launch shape of a streamed kernel: a persistent grid of as many
// blocks as the SMs hold, and two tile buffers of the plan's largest tile
// (rounded up to 16 bytes) before `extra` bytes of slice buffers.
struct Grid {
  int blocks, tile_elems, shift;
  size_t smem;
};

template <typename T, typename K>
int plan_grid(K kernel, const Launch& g, const size_t extra, Grid& grid) {
  const int64_t px = max_tile_pixels(g.tt, g.lv, g.L);
  const int64_t bytes = (px * g.C * (int64_t)sizeof(T) + 15) / 16 * 16;
  grid.tile_elems = (int)(bytes / sizeof(T));
  grid.smem = 2 * (size_t)bytes + extra;
  // the plan (ops/stream.py) keeps tiles within STREAM_TILE_BYTES, so that
  // two blocks fit an SM
  if (bytes > STREAM_TILE_BYTES) return (int)cudaErrorInvalidValue;
  grid.shift = 0;
  while (((px - 1) >> grid.shift) >= SORT_KEYS) ++grid.shift;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)grid.smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, STREAM_THREADS, grid.smem);
  if (err != cudaSuccess) return (int)err;
  grid.blocks = sms * std::max(per_sm, 1);
  return (int)cudaSuccess;
}

// The bins of a launch, at a sample cost of `sample_bytes` of staged tile.
template <typename T>
Bins make_bins(const void* records, const void* starts, const void* counts,
               const void* staged, const Launch& g,
               const int64_t sample_bytes) {
  // the chunk counter follows the staged pixels (the scan zeroes it)
  int64_t* line = static_cast<int64_t*>(const_cast<void*>(staged));
  return {static_cast<const float4*>(records),
          static_cast<const int*>(starts),
          static_cast<const int*>(counts),
          line,
          reinterpret_cast<unsigned long long*>(line + g.num_bins + 1),
          g.num_bins,
          0,
          g.samples,
          sample_bytes,
          (int64_t)(g.C * sizeof(T))};
}

template <typename T, int VEC>
int launch_fwd(const void* img, const Bins& bins, void* out,
               const Launch& g) {
  Grid grid;
  const int err = plan_grid<T>(msda_stream_fwd_kernel<T, VEC>, g, REC_BYTES,
                               grid);
  if (err != (int)cudaSuccess) return err;
  Bins w = bins;
  w.chunks = grid.blocks * FWD_CHUNKS_PER_BLOCK;
  msda_stream_fwd_kernel<T, VEC><<<grid.blocks, STREAM_THREADS, grid.smem,
                                   g.stream>>>(
      static_cast<const T*>(img), w, static_cast<float*>(out), g.lv, g.tt,
      grid.tile_elems, g.I, g.H, g.C, g.L, fast_div(g.L * g.P),
      group_lanes(g.C, VEC), vec16<T>(img, g.C), g.zeros, g.align_corners);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd(const void* img, const void* og, const Bins& bins,
               void* img_grad, void* pts_grad, void* wts_grad,
               const Launch& g) {
  Grid grid;
  const int err = plan_grid<T>(msda_stream_bwd_kernel<T, VEC>, g, SORT_BYTES,
                               grid);
  if (err != (int)cudaSuccess) return err;
  Bins w = bins;
  w.chunks = grid.blocks * BWD_CHUNKS_PER_BLOCK;
  msda_stream_bwd_kernel<T, VEC><<<grid.blocks, STREAM_THREADS, grid.smem,
                                   g.stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(og), w,
      static_cast<float*>(img_grad), static_cast<float2*>(pts_grad),
      static_cast<float*>(wts_grad), g.lv, g.tt, grid.tile_elems, grid.shift,
      g.I, g.H, g.C, g.L, fast_div(g.L * g.P), group_lanes(g.C, VEC),
      vec16<T>(img, g.C), g.zeros, g.align_corners);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* img, const void* records, const void* starts,
                 const void* counts, const void* staged, void* out,
                 const Launch& g) {
  const Bins w =
      make_bins<T>(records, starts, counts, staged, g, FWD_SAMPLE_BYTES);
  // out is the wrapper's own f32 buffer, and the tile's rows are aligned
  // for 4-channel loads where C % 4 == 0
  return g.C % 4 == 0 ? launch_fwd<T, 4>(img, w, out, g)
                      : launch_fwd<T, 1>(img, w, out, g);
}

template <typename T>
int dispatch_bwd(const void* img, const void* og, const void* records,
                 const void* starts, const void* counts, const void* staged,
                 void* img_grad, void* pts_grad, void* wts_grad,
                 const Launch& g) {
  const Bins w =
      make_bins<T>(records, starts, counts, staged, g, BWD_SAMPLE_BYTES);
  // four channels a step where C allows it and out_grad's rows are aligned
  // for it (img's tile is, and img_grad is the wrapper's own)
  return msda::vec4<T>(g.C, og)
             ? launch_bwd<T, 4>(img, og, w, img_grad, pts_grad, wts_grad, g)
             : launch_bwd<T, 1>(img, og, w, img_grad, pts_grad, wts_grad, g);
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

// The count kernel (records == nullptr) or the scatter kernel.
int launch_bins(const void* pts, const void* wts, void* bins, void* records,
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
  const dim3 grid((N + BIN_QUERIES - 1) / BIN_QUERIES, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ac = align_corners != 0;
  // the count's histogram, and the scatter's laid-out records and its
  // bins' offsets, in shared memory where they fit (the scatter's budget
  // keeps a record's bin under 16 bits)
  bool local = per_bh <= BIN_LOCAL_MAX;
  size_t smem = local ? per_bh * sizeof(int) : 0;
  if (records != nullptr) {
    smem = (size_t)BIN_QUERIES * L * P * (sizeof(float4) + 2 * sizeof(short)) +
           2 * per_bh * sizeof(int) + 32 * sizeof(int);
    local = smem <= BIN_ORDER_SMEM;
    if (!local) smem = 0;
    const cudaError_t err = cudaFuncSetAttribute(
        msda_stream_scatter_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (records == nullptr) {
    msda_stream_count_kernel<<<grid, BIN_THREADS, smem, s>>>(
        static_cast<const float*>(pts), static_cast<int*>(bins), lv, tt, N,
        H, L, P, ac, local);
  } else {
    msda_stream_scatter_kernel<<<grid, BIN_THREADS, smem, s>>>(
        static_cast<const float*>(pts), static_cast<const float*>(wts),
        static_cast<int*>(bins), static_cast<float4*>(records), lv, tt, N,
        H, L, P, ac, local);
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
  return launch_bins(pts, nullptr, counts, nullptr, level_hw, plan, B, N, H,
                     L, P, align_corners, num_bins, stream);
}

// starts, cursor: int [num_bins], the exclusive sum of the counts (each
// bin's first place in `records`; the scatter advances cursor); staged:
// int64 [num_bins + 2], the exclusive sum of the pixels of the non-empty
// bins' tiles, and a zero (the kernels' chunk counter).
int msda_stream_scan_launch(const void* counts, void* starts, void* cursor,
                            void* staged, const void* level_hw,
                            const void* plan, int B, int H, int L, int P,
                            int num_bins, void* stream) {
  LevelTable lv;
  TileTable tt;
  const int err = tables(lv, tt, level_hw, plan, B, -1, H, L, P, num_bins);
  if (err != (int)cudaSuccess) return err;
  msda_stream_scan_kernel<<<1, SCAN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<int*>(starts),
      static_cast<int*>(cursor), static_cast<int64_t*>(staged), lv, tt,
      num_bins, L);
  return (int)cudaGetLastError();
}

// wts: f32 [B, N, H, L, P]; cursor: the scan's (advanced by the kernel);
// records: f32 [B * N * H * L * P, 4], filled bin by bin.
int msda_stream_scatter_launch(const void* pts, const void* wts,
                               void* cursor, void* records,
                               const void* level_hw, const void* plan, int B,
                               int N, int H, int L, int P, int align_corners,
                               int num_bins, void* stream) {
  return launch_bins(pts, wts, cursor, records, level_hw, plan, B, N, H, L,
                     P, align_corners, num_bins, stream);
}

// Fills `g` for a kernel launch; returns a cudaError_t.
int launch_args(Launch& g, const void* level_hw, const void* plan, int B,
                int I, int N, int H, int C, int L, int P, int zeros,
                int align_corners, int num_bins, void* stream) {
  if (C < 1 || N < 0) return (int)cudaErrorInvalidValue;
  const int err =
      tables(g.lv, g.tt, level_hw, plan, B, I, H, L, P, num_bins);
  if (err != (int)cudaSuccess) return err;
  g.num_bins = num_bins;
  g.I = I;
  g.H = H;
  g.C = C;
  g.L = L;
  g.P = P;
  g.samples = (int64_t)B * N * H * L * P;
  if (g.samples > INT_MAX) return (int)cudaErrorInvalidValue;
  g.zeros = zeros != 0;
  g.align_corners = align_corners != 0;
  g.stream = static_cast<cudaStream_t>(stream);
  return (int)cudaSuccess;
}

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (img).  records, starts,
// counts, staged: the binning's outputs; out: f32 zeroed.
int msda_stream_fwd_launch(int dtype, const void* img, const void* records,
                           const void* starts, const void* counts,
                           const void* staged, void* out,
                           const void* level_hw, const void* plan, int B,
                           int I, int N, int H, int C, int L, int P,
                           int zeros, int align_corners, int num_bins,
                           void* stream) {
  Launch g;
  const int err = launch_args(g, level_hw, plan, B, I, N, H, C, L, P, zeros,
                              align_corners, num_bins, stream);
  if (err != (int)cudaSuccess) return err;
  if (num_bins == 0 || g.samples == 0) return (int)cudaSuccess;
  switch (dtype) {
    case 0:
      return dispatch_fwd<float>(img, records, starts, counts, staged, out,
                                 g);
    case 1:
      return dispatch_fwd<__half>(img, records, starts, counts, staged, out,
                                  g);
    case 2:
      return dispatch_fwd<__nv_bfloat16>(img, records, starts, counts,
                                         staged, out, g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype and the bins as above (img and out_grad).  img_grad: f32 zeroed;
// pts_grad and wts_grad: f32, every element written.
int msda_stream_bwd_launch(int dtype, const void* img, const void* og,
                           const void* records, const void* starts,
                           const void* counts, const void* staged,
                           void* img_grad, void* pts_grad, void* wts_grad,
                           const void* level_hw, const void* plan, int B,
                           int I, int N, int H, int C, int L, int P,
                           int zeros, int align_corners, int num_bins,
                           void* stream) {
  Launch g;
  const int err = launch_args(g, level_hw, plan, B, I, N, H, C, L, P, zeros,
                              align_corners, num_bins, stream);
  if (err != (int)cudaSuccess) return err;
  if (num_bins == 0 || g.samples == 0) return (int)cudaSuccess;
  switch (dtype) {
    case 0:
      return dispatch_bwd<float>(img, og, records, starts, counts, staged,
                                 img_grad, pts_grad, wts_grad, g);
    case 1:
      return dispatch_bwd<__half>(img, og, records, starts, counts, staged,
                                  img_grad, pts_grad, wts_grad, g);
    case 2:
      return dispatch_bwd<__nv_bfloat16>(img, og, records, starts, counts,
                                         staged, img_grad, pts_grad,
                                         wts_grad, g);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
