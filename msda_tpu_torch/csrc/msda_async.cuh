// The asynchronous-copy pipeline pieces that K1 (msda_fwd.cu) and K2
// (msda_bwd.cu) share: cp.async copies of a tile's points and weights into
// shared memory, each thread's copies arriving on a stage's mbarrier, and
// the wait for a stage's phase; and the device's multiprocessor count for
// their persistent grids.

#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace msda {

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

// Multiprocessors of the current device, asked once a device.
inline int multiprocessors() {
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

}  // namespace msda
