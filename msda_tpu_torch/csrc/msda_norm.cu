// The detector's residual add + LayerNorm for half-type activations, for
// NVIDIA Hopper (sm_90a): one pass over the rows.
//
// There is no Pallas original.  The JAX model leaves `nn.LayerNorm()(x + y)`
// to XLA, which fuses the add, the casts and the statistics into one loop.
// The port's models/detr.py LayerNorm ran the same post-norm as four
// kernels under bf16: the add (a + b, rounded to bf16), an up-cast to f32,
// F.layer_norm in f32 and a down-cast.  This kernel computes that function
// in one kernel, per row of D:
//
//   s    = act(float(a) + float(b))          the rounding a + b does
//   mean = sum(s) / D;  var = sum((s - mean)^2) / D      (f32, biased)
//   out  = act(weight * (rsqrt(var + eps) * (s - mean)) + bias)
//
// with weight and bias the f32 master parameters, and act() a round to
// nearest even into the activations' type (bf16 or f16).  The formula is
// F.layer_norm's (its vectorized CUDA kernel's order of the product); only
// the statistics' order of summation differs (F.layer_norm runs Welford's
// update), so an output differs from the chain's in its last bit now and
// then, and never by more.
//
// What bounds it: bytes.  It reads a and b once and writes out once, 6 * D
// bytes a row: 68.3 MB at the 800x1333 encoder call (44,446 rows of 256),
// 20.4 us at 3.35 TB/s.  The four-kernel chain moves 4.3 times as much
// (the sum, the f32 copy, the f32 result and the cast each written and
// read again).  Its arithmetic is a few operations a byte.
//
// Design.  One warp a row: lane l holds the row's 8-element vectors l,
// l + 32, ... (NV = ceil(D / 256) of them; D a multiple of 8 up to 1024),
// each one 16-byte load of a and of b and one 16-byte store, consecutive
// lanes on consecutive addresses.  The sums of s and of (s - mean)^2 are two
// butterfly shuffle reductions over values held in registers, so the row is
// read from memory once.  Each warp loads its lanes' slice of weight and
// bias into registers once, then walks rows in a persistent grid-stride
// loop: the grid is as many blocks of kWarps warps as the device
// keeps resident at once (the occupancy the compiler's registers allow),
// and no more than the rows need.  Each warp's loads of the next row are
// independent of the row before, so the resident warps keep enough bytes
// in flight to cover the memory's latency.
//
// Interface: a plain C entry point (msda_add_layer_norm_launch), loaded with
// ctypes by msda_tpu_torch/ops/cuda_norm.py.  It launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  It reads the device's resident-block count on its
// first call on each device, so that a later call (inside a CUDA graph
// capture too) only launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;        // warps (rows in flight) a block
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;          // elements a 16-byte vector of a or b
constexpr int kMaxVecs = 4;      // vectors a lane: D up to 32 * 8 * 4
constexpr int kMaxDevices = 64;

template <class T>
struct alignas(16) Vec8 {
  T v[kVec];
};

struct alignas(16) Float4 {
  float v[4];
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Rows [warp, rows) in steps of the grid's warps; NV vectors a lane.
template <class T, int NV>
__global__ void __launch_bounds__(kThreads)
    msda_add_layer_norm_kernel(const T* __restrict__ a,
                               const T* __restrict__ b,
                               const float* __restrict__ weight,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int rows, int dim,
                               float eps) {
  const int lane = threadIdx.x & 31;
  const int vecs = dim / kVec;  // 8-element vectors a row
  const float inv_dim = 1.0f / static_cast<float>(dim);

  float w[NV][kVec], c[NV][kVec];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + 32 * k;
    if (v < vecs) {
      const Float4* pw = reinterpret_cast<const Float4*>(weight) + 2 * v;
      const Float4* pc = reinterpret_cast<const Float4*>(bias) + 2 * v;
      const Float4 w0 = pw[0], w1 = pw[1], c0 = pc[0], c1 = pc[1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[k][j] = w0.v[j];
        w[k][j + 4] = w1.v[j];
        c[k][j] = c0.v[j];
        c[k][j + 4] = c1.v[j];
      }
    }
  }

  const int warps = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += warps) {
    const size_t base = static_cast<size_t>(row) * vecs;
    const Vec8<T>* pa = reinterpret_cast<const Vec8<T>*>(a) + base;
    const Vec8<T>* pb = reinterpret_cast<const Vec8<T>*>(b) + base;

    float s[NV][kVec];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < vecs) {
        const Vec8<T> va = pa[v], vb = pb[v];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          // the sum as a + b rounds it, then widened again
          s[k][j] = to_float(from_float<T>(to_float(va.v[j]) +
                                           to_float(vb.v[j])));
          sum += s[k][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) s[k][j] = 0.0f;
      }
    }
    const float mean = warp_sum(sum) * inv_dim;

    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < vecs) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = s[k][j] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_dim + eps);

    Vec8<T>* po = reinterpret_cast<Vec8<T>*>(out) + base;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < vecs) {
        Vec8<T> vo;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          vo.v[j] = from_float<T>(w[k][j] * (rstd * (s[k][j] - mean)) +
                                  c[k][j]);
        }
        po[v] = vo;
      }
    }
  }
}

// Blocks of kernel `fn` resident at once on `device` (SMs x blocks an SM),
// read once a device and instance.
template <class T, int NV>
cudaError_t resident_blocks(int device, int* blocks) {
  static int cache[kMaxDevices] = {};
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, msda_add_layer_norm_kernel<T, NV>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cache[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cache[device];
  return cudaSuccess;
}

template <class T, int NV>
cudaError_t launch(const void* a, const void* b, const void* weight,
                   const void* bias, void* out, int rows, int dim, float eps,
                   cudaStream_t stream) {
  int device, resident;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  err = resident_blocks<T, NV>(device, &resident);
  if (err != cudaSuccess) return err;
  const int needed = (rows + kWarps - 1) / kWarps;
  const int grid = needed < resident ? needed : resident;
  msda_add_layer_norm_kernel<T, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<T*>(out), rows, dim, eps);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(const void* a, const void* b, const void* weight,
                     const void* bias, void* out, int rows, int dim,
                     float eps, cudaStream_t stream) {
  switch ((dim / kVec + 31) / 32) {
    case 1:
      return launch<T, 1>(a, b, weight, bias, out, rows, dim, eps, stream);
    case 2:
      return launch<T, 2>(a, b, weight, bias, out, rows, dim, eps, stream);
    case 3:
      return launch<T, 3>(a, b, weight, bias, out, rows, dim, eps, stream);
    case 4:
      return launch<T, 4>(a, b, weight, bias, out, rows, dim, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The largest D the kernel takes.
int msda_add_layer_norm_max_dim() { return 32 * kVec * kMaxVecs; }

// out = LayerNorm(a + b) over rows of `dim` (a multiple of 8, 8 to 1024):
// a, b and out [rows, dim] in `dtype` (1 f16, 2 bf16; the codes of
// ops/cuda_fwd.py), contiguous and 16-byte aligned; weight and bias [dim]
// f32, 16-byte aligned.  Launches on `stream`; returns a cudaError_t.
int msda_add_layer_norm_launch(int dtype, const void* a, const void* b,
                               const void* weight, const void* bias,
                               void* out, int rows, int dim, float eps,
                               void* stream) {
  if (rows < 0 || dim < kVec || dim % kVec != 0 ||
      dim > 32 * kVec * kMaxVecs) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = dispatch<__half>(a, b, weight, bias, out, rows, dim, eps, s);
  } else if (dtype == 2) {
    err = dispatch<__nv_bfloat16>(a, b, weight, bias, out, rows, dim, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
