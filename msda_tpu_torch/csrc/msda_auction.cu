// The auction matcher (Bertsekas 1988, single phase) for NVIDIA Hopper
// (sm_90a): every bidding round of every image in one launch.
//
// There is no Pallas original.  The counterpart is the XLA while_loop of
// msda_tpu/parallel/matcher.py:71 (_auction_phase, and auction_assignment's
// argmin fallback and `converged` flag, :31-140), run per image under
// jax.vmap.  This kernel computes that function and nothing else:
//
//   profit = -cost^T [M, N]; price = 0; owner = -1 (free)
//   while a round is left and some active target owns no query:
//     every active target without a query bids: values = profit - price,
//       best and best_q (argmax, first index on ties), second = the max of
//       values with best_q's entry set to -1e30, bid = (best - second) + eps;
//     every query takes its highest bid (the lowest target on ties) and,
//       when that bid is above -5e29, adds it to its price and changes
//       owner (unseating the previous one);
//   query_idx[m] = the first query m owns, else argmin_n cost[n, m];
//   converged = every active target owns a query.
//
// The f32 arithmetic is written as JAX orders it (values = profit - price,
// bid = (best - second) + eps, price + top_bid), with no fast-math and no
// multiply to contract, so the kernel gives the plain version's indices
// exactly (parallel/matcher.py:plain_auction), not within a tolerance.
// Costs must be finite: NaN orders differently in the two.
//
// Design.  One block per image runs all of its rounds, so nothing moves
// between device and host: no round count, no convergence flag, no sync.
// A round is three steps with block barriers between them:
//   1. a warp per bidding target: each lane scans its strided queries for
//      its best (strict >, so the first index), a butterfly of shuffles
//      merges them (larger value, else smaller index), a second scan takes
//      the largest value off best_q, and lane 0 posts its bid on best_q as
//      one 64-bit shared atomicMax of (the bid's order-preserving bits,
//      ~target): the highest bid wins, the lowest target on a tie, in any
//      order of arrival;
//   2. a thread per query reads its word, updates price and owner, and
//      marks its owner in the next round's assigned flags (double-buffered
//      by round parity, so that the flags are rebuilt from the owners every
//      round);
//   3. the stop test is __syncthreads_or over the active targets that own
//      nothing, or the round budget max_rounds.
// An image that has converged stops at once; under vmap it would take
// rounds that change nothing, so the results are the vmapped loop's.  The
// cost matrix lives in dynamic shared memory, transposed to [M][N] so that
// a warp's scan reads consecutive words, when its M*N*4 bytes fit beside the
// per-query and per-target state (60 KB at N=300 queries, M=50 targets);
// otherwise the scans read it from global memory, through the L2.
//
// What bounds it (parallel/cuda_matcher.py, PERF.md): latency, not bytes.
// It reads B*N*M*4 bytes once (0.036 us at 3.35 TB/s for B=2, N=300, M=50)
// and then spends rounds x one round: a strided scan of N values twice,
// five shuffle steps twice, and three barriers.  One block per image uses
// one SM of 132, so the kernel's time is the slowest image's rounds.
//
// The large-N path (msda_auction_large_launch), for N + M past what a
// block's shared memory holds: two-stage Deformable DETR matches its
// targets over every encoder token (N = 22,223 proposals an image at
// 800x1333, 88,750 at 1600x2666), and the per-query state alone then
// outgrows shared memory.  It solves a smaller problem with the same
// answer.  Only the A active targets of an image bid; a query's price rises
// only when one of them wins it, and a target owns at most one query, so
// at most A queries are ever priced.  Let S_m be active target m's K = A +
// 2 cheapest queries (the lower index first among equal costs): at least
// two of them are unpriced, and each unpriced query in S_m is worth at
// least as much to m as any query outside S_m.  So m's best query (the
// first index on ties) and its second value lie in S_m, over every round,
// and the auction over the union U of the S_m, in the order of the query
// index, bids, prices and assigns exactly as the auction over all N; a
// target that wins nothing gets its cheapest query over all N, and
// `converged` is the same.  Four launches:
//   0. msda_auction_transpose_kernel: the cost transposed to [M][N] an
//      image (32 x 32 tiles through shared memory), so that each pass
//      below reads consecutive words, and the marks below cleared;
//   1. msda_auction_select_kernel, a block of 1,024 threads per (target,
//      image): one read of the target's N costs keeps their
//      order-preserving bits in shared memory (where N * 4 bytes fit) and
//      finds the cheapest query; for an active target, a radix select
//      over those bits (8 a pass, a 256-bin histogram, the digit found by
//      one warp's scan of it) finds the K-th
//      smallest, and a last pass marks every query below it and, in index
//      order, as many equal to it as K needs;
//   2. msda_auction_compact_kernel, a block per image: the marked queries
//      in index order (U, at most A * K <= S = M * (M + 2)), their number,
//      and their costs, transposed to [M][S];
//   3. msda_auction_kernel on the first |U| slots of the [M][S] costs,
//      mapping each target's slot back to its query.
// What bounds the path: the cost read once, B*N*M*4 bytes (8.9 MB, 2.7 us
// at 3.35 TB/s, for B=2, N=22,223, M=50), read by the transpose and
// written back for the select, which reads it once from the L2; the
// smaller auction's rounds scan |U| slots (A = 5 to 9 there: 35 to 99).
// It takes M(M + 2) + M <= 12,288 (M <= 108).
//
// Interface: plain C entry points (msda_auction_launch,
// msda_auction_large_launch), loaded with ctypes by
// msda_tpu_torch/parallel/cuda_matcher.py and cuda_auction_large.py.  They
// launch on the given stream, do not synchronise, allocate nothing, and
// return cudaGetLastError().  They raise the auction kernel's dynamic
// shared-memory limit to the device's maximum on their first call on each
// device, so that a later call (inside a CUDA graph capture too) only
// launches.

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef AUCTION_THREADS
#define AUCTION_THREADS 512
#endif
// the large-N path's blocks: a (target, image)'s selection, an image's
// compaction
#define SELECT_THREADS 1024
#define COMPACT_THREADS 1024
// the device ids whose shared-memory limit has been raised
#define AUCTION_MAX_DEVICES 64

namespace {

constexpr float kNeg = -1e30f;  // _NEG of the JAX solver
constexpr unsigned kFull = 0xffffffffu;

// f's bits as an unsigned int that orders as f does (over non-NaN floats)
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Per-query state first (8-byte words), then per-target, then the costs.
__host__ __device__ inline size_t state_bytes(int N, int M) {
  return (size_t)N * (8 + 4 + 4) + (size_t)M * 4 * 4;
}

// cost: [B, N, M] f32, or [B, M, N] with cost_mn; active: [B, M] bytes
// (nullptr: every target); query_ids: [B, N] int32, the query of each of
// the N slots (nullptr: slot n is query n); slot_counts: [B] int32, the
// slots in use, the first of each image's N (nullptr: all N); fallback:
// [B, M] int32, the query a target that wins none is given (nullptr: its
// cheapest slot's); query_idx: [B, M] int64; converged: [B] bool; rounds:
// [B] int32 or nullptr.
__global__ void __launch_bounds__(AUCTION_THREADS)
    msda_auction_kernel(const float* __restrict__ cost,
                        const uint8_t* __restrict__ active, const int N,
                        const int M, const float eps, const int max_rounds,
                        const bool cost_in_shared, const bool cost_mn,
                        const int* __restrict__ query_ids,
                        const int* __restrict__ slot_counts,
                        const int* __restrict__ fallback,
                        int64_t* __restrict__ query_idx,
                        bool* __restrict__ converged,
                        int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bid_word = reinterpret_cast<unsigned long long*>(smem);
  float* price = reinterpret_cast<float*>(bid_word + N);
  int* owner = reinterpret_cast<int*>(price + N);
  int* first = owner + N;   // [M]: the first query each target owns
  int* assigned = first + M;  // [2][M]: by round parity
  int* act = assigned + 2 * M;  // [M]
  float* shared_cost = reinterpret_cast<float*>(act + M);  // [M][N]

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const float* cost_b = cost + (int64_t)b * N * M;
  const int used = slot_counts == nullptr ? N : slot_counts[b];

  for (int n = tid; n < N; n += blockDim.x) {
    bid_word[n] = 0ull;
    price[n] = 0.f;
    owner[n] = -1;
  }
  for (int m = tid; m < M; m += blockDim.x) {
    act[m] = active == nullptr || active[(int64_t)b * M + m] != 0;
    assigned[m] = 0;
    first[m] = INT_MAX;
  }
  // the cost of (query n, target m) is c[m * sm + n * sn]
  const float* c = cost_b;
  int64_t sm = 1, sn = M;
  if (cost_in_shared) {
    for (int i = tid; i < N * M; i += blockDim.x) {  // coalesced reads
      if (cost_mn) {
        shared_cost[i] = cost_b[i];
      } else {
        const int n = i / M, m = i - n * M;
        shared_cost[(int64_t)m * N + n] = cost_b[i];
      }
    }
    c = shared_cost;
  }
  if (cost_in_shared || cost_mn) {
    sm = N;
    sn = 1;
  }
  __syncthreads();

  int r = 0;
  for (;; ++r) {
    const int* now = assigned + (r & 1) * M;
    int* next = assigned + ((r + 1) & 1) * M;
    int open = 0;
    for (int m = tid; m < M; m += blockDim.x) open |= act[m] && !now[m];
    if (!__syncthreads_or(open) || r >= max_rounds) break;

    // 1. bids, a warp per bidding target
    for (int m = tid; m < M; m += blockDim.x) next[m] = 0;
    for (int m = warp; m < M; m += warps) {
      if (!act[m] || now[m]) continue;  // warp-uniform
      const float* cm = c + m * sm;
      float best = -INFINITY;
      int best_q = INT_MAX;
      for (int n = lane; n < used; n += 32) {
        const float v = -cm[n * sn] - price[n];
        if (best_q == INT_MAX || v > best) {
          best = v;
          best_q = n;
        }
      }
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oq = __shfl_xor_sync(kFull, best_q, off);
        if (ov > best || (ov == best && oq < best_q)) {
          best = ov;
          best_q = oq;
        }
      }
      float second = kNeg;
      for (int n = lane; n < used; n += 32) {
        if (n != best_q) second = fmaxf(second, -cm[n * sn] - price[n]);
      }
      for (int off = 16; off; off >>= 1) {
        second = fmaxf(second, __shfl_xor_sync(kFull, second, off));
      }
      if (lane == 0) {
        const float bid = (best - second) + eps;
        atomicMax(&bid_word[best_q],
                  ((unsigned long long)ordered_bits(bid) << 32) |
                      (unsigned)(~m));
      }
    }
    __syncthreads();

    // 2. each query takes its highest bid; owners mark the next flags
    for (int n = tid; n < used; n += blockDim.x) {
      int o = owner[n];
      const unsigned long long word = bid_word[n];
      if (word != 0ull) {
        bid_word[n] = 0ull;
        const float top = from_ordered_bits((unsigned)(word >> 32));
        if (top > kNeg / 2) {
          price[n] = price[n] + top;
          o = (int)~(unsigned)word;
          owner[n] = o;
        }
      }
      if (o >= 0) next[o] = 1;
    }
    __syncthreads();
  }
  if (tid == 0 && rounds_out != nullptr) rounds_out[b] = r;

  // each target's first owned query, else the argmin-cost fallback
  for (int n = tid; n < used; n += blockDim.x) {
    if (owner[n] >= 0) atomicMin(&first[owner[n]], n);
  }
  __syncthreads();
  int open = 0;
  for (int m = warp; m < M; m += warps) {
    int q = first[m];
    const bool owns = q != INT_MAX;
    if (!owns && fallback == nullptr) {
      const float* cm = c + m * sm;
      float low = INFINITY;
      for (int n = lane; n < used; n += 32) {
        const float v = cm[n * sn];
        if (q == INT_MAX || v < low) {
          low = v;
          q = n;
        }
      }
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, low, off);
        const int oq = __shfl_xor_sync(kFull, q, off);
        if (ov < low || (ov == low && oq < q)) {
          low = ov;
          q = oq;
        }
      }
    }
    if (!owns) open |= act[m];
    if (lane == 0) {
      query_idx[(int64_t)b * M + m] =
          !owns && fallback != nullptr ? fallback[(int64_t)b * M + m]
          : query_ids == nullptr      ? q
                                      : query_ids[(int64_t)b * N + q];
    }
  }
  open = __syncthreads_or(open);
  if (tid == 0) converged[b] = !open;
}

// The block's exclusive sum of v in thread order (`before`) and its total;
// warp_sum: the block's warps' sums in shared memory.  Every thread of the
// block calls it.
__device__ __forceinline__ void block_sum(const int v, int* warp_sum,
                                          int* before, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;  // the warp's inclusive sum up to this lane
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int base = 0, t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = warp_sum[w];
    if (w < warp) base += c;
    t += c;
  }
  __syncthreads();  // warp_sum is written again by the next call
  *before = base + x - v;
  *total = t;
}

// cost: [B, N, M] f32 -> cost_mn: [B, M, N]; member: [B, N] bytes set to
// 0.  Blocks (M / 32, N / 32, B) of 32 x 8 threads.
__global__ void __launch_bounds__(256)
    msda_auction_transpose_kernel(const float* __restrict__ cost,
                                  const int N, const int M,
                                  float* __restrict__ cost_mn,
                                  uint8_t* __restrict__ member) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, n0 = blockIdx.y * 32, m0 = blockIdx.x * 32;
  const int x = threadIdx.x;
  const float* src = cost + (int64_t)b * N * M;
  float* dst = cost_mn + (int64_t)b * M * N;
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    if (n0 + j < N && m0 + x < M) {
      tile[j][x] = src[(int64_t)(n0 + j) * M + m0 + x];
    }
  }
  if (blockIdx.x == 0 && threadIdx.y == 0 && n0 + x < N) {
    member[(int64_t)b * N + n0 + x] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    if (m0 + j < M && n0 + x < N) {
      dst[(int64_t)(m0 + j) * N + n0 + x] = tile[x][j];
    }
  }
}

// A cost's order-preserving bits, -0 read as +0 (they are equal costs).
__device__ __forceinline__ unsigned cost_key(const float c) {
  return ordered_bits(c + 0.f);
}

// cost_mn: [B, M, N] f32; active: [B, M] bytes or nullptr (every target);
// member: [B, N] bytes, zero on entry; fallback: [B, M] int32.  Block
// (m, b) writes fallback[b][m], target m's cheapest query (the lowest
// index among equal costs), and, when m is active, sets member[b][n] = 1
// for its K = A + 2 cheapest queries in that order, A the image's active
// targets.  With `staged` the block keeps the column's keys in dynamic
// shared memory (N * 4 bytes) after reading them once.
__global__ void __launch_bounds__(SELECT_THREADS)
    msda_auction_select_kernel(const float* __restrict__ cost_mn,
                               const uint8_t* __restrict__ active,
                               const int N, const int M, const bool staged,
                               uint8_t* __restrict__ member,
                               int* __restrict__ fallback) {
  extern __shared__ unsigned keys[];  // [N] with `staged`
  __shared__ unsigned hist[256];
  __shared__ unsigned chosen[2];  // the key's digits so far, the rank left
  __shared__ int warp_count[SELECT_THREADS / 32];
  __shared__ unsigned long long cheapest;  // (key << 32) | n, the least
  const int m = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* col = cost_mn + ((int64_t)b * M + m) * N;

  for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
  if (tid == 0) cheapest = ~0ull;
  const unsigned A = active == nullptr ? M : __syncthreads_count(
      tid < M && active[(int64_t)b * M + tid] != 0);
  __syncthreads();
  const bool bids = active == nullptr || active[(int64_t)b * M + m] != 0;
  const unsigned K = A + 2u;

  // read once: the keys, the top 8 bits' histogram, the cheapest query
  unsigned long long mine = ~0ull;
  for (int n = tid; n < N; n += blockDim.x) {
    const unsigned key = cost_key(col[n]);
    if (staged) keys[n] = key;
    if (bids) atomicAdd(&hist[key >> 24], 1u);
    const unsigned long long word = ((unsigned long long)key << 32) | n;
    if (word < mine) mine = word;
  }
  for (int off = 16; off; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, mine, off);
    if (other < mine) mine = other;
  }
  if ((tid & 31) == 0) atomicMin(&cheapest, mine);
  __syncthreads();
  if (tid == 0) fallback[(int64_t)b * M + m] = (int)(cheapest & 0xffffffffu);
  if (!bids) return;  // block-uniform

  // the K-th smallest key, 8 bits a pass from the top: `prefix` holds the
  // digits found (under `high`), k the rank among the keys that match it
  unsigned prefix = 0u, high = 0u, k = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (shift < 24) {
      for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
      __syncthreads();
      for (int n = tid; n < N; n += blockDim.x) {
        const unsigned key = staged ? keys[n] : cost_key(col[n]);
        if ((key & high) == prefix) {
          atomicAdd(&hist[(key >> shift) & 255u], 1u);
        }
      }
      __syncthreads();
    }
    if (tid < 32) {  // the digit: warp 0, 8 bins a lane
      const int lane = tid;
      unsigned own = 0u;
      for (int j = 0; j < 8; ++j) own += hist[8 * lane + j];
      unsigned upto = own;  // the bins' count up to this lane's last
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, upto, off);
        if (lane >= off) upto += y;
      }
      unsigned below = upto - own;
      if (below < k && k <= upto) {  // one lane
        int d = 8 * lane;
        while (below + hist[d] < k) below += hist[d++];
        chosen[0] = prefix | ((unsigned)d << shift);
        chosen[1] = k - below;
      }
    }
    __syncthreads();
    prefix = chosen[0];
    k = chosen[1];
    high |= 255u << shift;
  }

  // every key below it, and the first k equal to it in index order
  uint8_t* member_b = member + (int64_t)b * N;
  unsigned equal_seen = 0u;
  for (int base = 0; base < N; base += blockDim.x) {
    const int n = base + tid;
    const unsigned key =
        n >= N ? 0xffffffffu : staged ? keys[n] : cost_key(col[n]);
    const bool equal = n < N && key == prefix;
    int before, total;
    block_sum(equal, warp_count, &before, &total);
    if ((n < N && key < prefix) || (equal && equal_seen + before < k)) {
      member_b[n] = 1;
    }
    equal_seen += total;
  }
}

// Block b: the queries that member[b] marks, in index order, into
// ids[b][0, count) and count into counts[b], and their costs, transposed,
// into reduced[b] [M][S] (the first count of each row).  At most S are
// marked.  A thread counts a run of consecutive queries.
__global__ void __launch_bounds__(COMPACT_THREADS)
    msda_auction_compact_kernel(const float* __restrict__ cost_mn,
                                const uint8_t* __restrict__ member,
                                const int N, const int M, const int S,
                                float* __restrict__ reduced,
                                int* __restrict__ ids,
                                int* __restrict__ counts) {
  __shared__ int warp_sum[COMPACT_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const uint8_t* member_b = member + (int64_t)b * N;
  int* ids_b = ids + (int64_t)b * S;
  const int run = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min(N, tid * run), hi = min(N, lo + run);
  int marked = 0;
  for (int n = lo; n < hi; ++n) marked += member_b[n] != 0;
  int at, count;
  block_sum(marked, warp_sum, &at, &count);
  for (int n = lo; n < hi; ++n) {
    if (member_b[n] != 0) ids_b[at++] = n;
  }
  if (tid == 0) counts[b] = count;
  __syncthreads();
  const float* cost_b = cost_mn + (int64_t)b * M * N;
  float* reduced_b = reduced + (int64_t)b * M * S;
  for (int i = tid; i < M * count; i += blockDim.x) {
    const int m = i / count, u = i - m * count;
    reduced_b[(int64_t)m * S + u] = cost_b[(int64_t)m * N + ids_b[u]];
  }
}

bool configured[AUCTION_MAX_DEVICES];
// the select kernel's shared-memory limit a block, by device (0: not read)
int select_limit[AUCTION_MAX_DEVICES];

// Where an image's N x M costs live on the current device: 1 in shared
// memory, 0 in global memory (through the L2), -1 nowhere (the per-query
// and per-target state alone does not fit); `limit` gets the device's
// shared-memory limit a block.
int cost_placement(int N, int M, int* limit) {
  int device;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  const size_t state = state_bytes(N, M);
  if (state > (size_t)*limit) return -1;
  return state + (size_t)N * M * sizeof(float) <= (size_t)*limit ? 1 : 0;
}

// Launch msda_auction_kernel over B images of N slots and M targets (the
// cost [B, N, M], or [B, M, N] with cost_mn).  Returns a cudaError_t.
int launch_auction(const void* cost, const void* active, int B, int N, int M,
                   float eps, int max_rounds, bool cost_mn,
                   const void* query_ids, const void* slot_counts,
                   const void* fallback, void* query_idx, void* converged,
                   void* rounds, cudaStream_t stream) {
  int device, limit;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= AUCTION_MAX_DEVICES) {
    return (int)cudaErrorInvalidDevice;
  }
  const int placement = cost_placement(N, M, &limit);
  if (placement < 0) return (int)cudaErrorInvalidValue;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(msda_auction_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return (int)err;
    configured[device] = true;
  }
  const bool cost_in_shared = placement == 1;
  const size_t bytes = state_bytes(N, M) +
                       (cost_in_shared ? (size_t)N * M * sizeof(float) : 0);
  msda_auction_kernel<<<B, AUCTION_THREADS, bytes, stream>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(active), N,
      M, eps, max_rounds, cost_in_shared, cost_mn,
      static_cast<const int*>(query_ids),
      static_cast<const int*>(slot_counts),
      static_cast<const int*>(fallback), static_cast<int64_t*>(query_idx),
      static_cast<bool*>(converged), static_cast<int*>(rounds));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the auction over B images of N queries and M targets (M <= N) on
// `stream`.  Returns a cudaError_t: cudaErrorInvalidValue when the
// per-query and per-target state does not fit in shared memory.
int msda_auction_launch(const void* cost, const void* active, int B, int N,
                        int M, float eps, int max_rounds, void* query_idx,
                        void* converged, void* rounds, void* stream) {
  if (B < 0 || N < 0 || M < 0 || M > N) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  return launch_auction(cost, active, B, N, M, eps, max_rounds, false,
                        nullptr, nullptr, nullptr, query_idx, converged,
                        rounds, static_cast<cudaStream_t>(stream));
}

// The large-N path (the note at the top) over B images of N queries and
// M >= 1 targets, cost [B, N, M] f32, on `stream`.  Scratch from the
// caller: cost_mn [B, M, N] f32, member [B, N] bytes, reduced [B, M, S]
// f32, ids [B, S], counts [B] and fallback [B, M] int32, S = M * (M + 2).
// Returns a cudaError_t: cudaErrorInvalidValue when N < M + 2 or the
// reduced problem's state does not fit in shared memory.
int msda_auction_large_launch(const void* cost, const void* active, int B,
                              int N, int M, float eps, int max_rounds,
                              void* cost_mn, void* member, void* reduced,
                              void* ids, void* counts, void* fallback,
                              void* query_idx, void* converged, void* rounds,
                              void* stream) {
  if (B < 0 || M < 1 || M > SELECT_THREADS || N < M + 2 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaSuccess;
  const int S = M * (M + 2);
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= AUCTION_MAX_DEVICES) {
    return (int)cudaErrorInvalidDevice;
  }
  if (select_limit[device] == 0) {
    int limit;
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    limit -= 4096;  // the kernel's static shared memory, and spare
    err = cudaFuncSetAttribute(msda_auction_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return (int)err;
    select_limit[device] = limit;
  }
  const bool staged = (size_t)N * sizeof(unsigned) <=
                      (size_t)select_limit[device];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  msda_auction_transpose_kernel<<<dim3((M + 31) / 32, (N + 31) / 32, B),
                                  dim3(32, 8), 0, s>>>(
      static_cast<const float*>(cost), N, M, static_cast<float*>(cost_mn),
      static_cast<uint8_t*>(member));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msda_auction_select_kernel<<<dim3(M, B), SELECT_THREADS,
                               staged ? (size_t)N * sizeof(unsigned) : 0,
                               s>>>(
      static_cast<const float*>(cost_mn), static_cast<const uint8_t*>(active),
      N, M, staged, static_cast<uint8_t*>(member),
      static_cast<int*>(fallback));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  msda_auction_compact_kernel<<<B, COMPACT_THREADS, 0, s>>>(
      static_cast<const float*>(cost_mn),
      static_cast<const uint8_t*>(member), N, M, S,
      static_cast<float*>(reduced), static_cast<int*>(ids),
      static_cast<int*>(counts));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_auction(reduced, active, B, S, M, eps, max_rounds, true, ids,
                        counts, fallback, query_idx, converged, rounds, s);
}

}  // extern "C"
