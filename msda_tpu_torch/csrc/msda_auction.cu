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
// Interface: a plain C entry point (msda_auction_launch), loaded with
// ctypes by msda_tpu_torch/parallel/cuda_matcher.py.  It launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  It raises the kernel's dynamic shared-memory limit
// to the device's maximum on its first call on each device, so that a
// later call (inside a CUDA graph capture too) only launches.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef AUCTION_THREADS
#define AUCTION_THREADS 512
#endif
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

// cost: [B, N, M] f32; active: [B, M] bytes (nullptr: every target);
// query_idx: [B, M] int64; converged: [B] bool; rounds: [B] int32 or
// nullptr.
__global__ void __launch_bounds__(AUCTION_THREADS)
    msda_auction_kernel(const float* __restrict__ cost,
                        const uint8_t* __restrict__ active, const int N,
                        const int M, const float eps, const int max_rounds,
                        const bool cost_in_shared,
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
      const int n = i / M, m = i - n * M;
      shared_cost[(int64_t)m * N + n] = cost_b[i];
    }
    c = shared_cost;
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
      for (int n = lane; n < N; n += 32) {
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
      for (int n = lane; n < N; n += 32) {
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
    for (int n = tid; n < N; n += blockDim.x) {
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
  for (int n = tid; n < N; n += blockDim.x) {
    if (owner[n] >= 0) atomicMin(&first[owner[n]], n);
  }
  __syncthreads();
  int open = 0;
  for (int m = warp; m < M; m += warps) {
    int q = first[m];
    if (q == INT_MAX) {
      const float* cm = c + m * sm;
      float low = INFINITY;
      for (int n = lane; n < N; n += 32) {
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
      open |= act[m];
    }
    if (lane == 0) query_idx[(int64_t)b * M + m] = q;
  }
  open = __syncthreads_or(open);
  if (tid == 0) converged[b] = !open;
}

bool configured[AUCTION_MAX_DEVICES];

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
  msda_auction_kernel<<<B, AUCTION_THREADS, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(active), N,
      M, eps, max_rounds, cost_in_shared, static_cast<int64_t*>(query_idx),
      static_cast<bool*>(converged), static_cast<int*>(rounds));
  return (int)cudaGetLastError();
}

}  // extern "C"
