// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:23
// rmsnorm_pallas:
//
//   y[n, :] = x[n, :] * rsqrt(mean(x[n, :]^2) + eps) * scale      (f32 inside)
//
// x is (N, D) float32 or bfloat16 with D whole, scale is (D,) float32,
// y has x's dtype.
//
// Bound.  Each element is read once and written once, with 4 flops
// between: every shape of the serve path is bound by device-memory bytes
// (h2o-danube-1.8b, D = 2560 bf16: 10 KB a row; the S = 8192 prefill
// moves 84 MB, about 25 us at 3.35 TB/s) or, at the 4 rows of a decode
// step, by launch latency.
//
// Design against that bound.  One block per row, so a row's sum never
// crosses a block.  Each thread reads 16-byte vectors (8 bf16 or 4 f32)
// when the row is 16-byte aligned, else single elements.  Pass 1 sums the
// squares; pass 2 reads the row again (10 KB, an L1/L2 hit) and writes y.
// The TPU kernel's (256, D) row blocks in VMEM have no counterpart: a row
// is the unit of reuse here.
//
// Numerics.  Each thread adds its elements in a fixed order, the warp
// folds with __shfl_xor_sync in a fixed pattern, and warp 0 adds the
// warps' sums in order, so repeated runs are bitwise equal.  The order
// differs from the plain PyTorch version's, so results agree within a
// tolerance, not bitwise.  y = (x * r) * scale uses __fmul_rn so that no
// multiply is contracted.
//
// Interface.  Plain extern "C" launchers, loaded with ctypes.  Each
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Sum of v over the block, the same fixed order on every run; every
// thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = warp_sums[0];
    for (int w = 1; w < warps; ++w) t = __fadd_rn(t, warp_sums[w]);
    if (lane == 0) warp_sums[0] = t;
  }
  __syncthreads();
  return warp_sums[0];
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int D, float eps, int vec) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  constexpr int N = Vec<T>::kN;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * N; i < D; i += blockDim.x * N) {
      float v[N];
      Vec<T>::load(xr + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      float v = to_f32(xr[i]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  ss = block_sum(ss, warp_sums);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(D)), eps));

  if (vec) {
    for (int i = threadIdx.x * N; i < D; i += blockDim.x * N) {
      float v[N];
      Vec<T>::load(xr + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], r), scale[i + j]);
      Vec<T>::store(yr + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      store(yr + i, __fmul_rn(__fmul_rn(to_f32(xr[i]), r), scale[i]));
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, long long N, int D,
           float eps, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = Vec<T>::kN;
  // the wrapper hands over 16-byte aligned x and y (_launch.on_cuda), so
  // every row is aligned when D is a multiple of the vector width
  const int vec = (D % V == 0) ? 1 : 0;
  const int per_thread = vec ? V : 1;
  int threads = 32;
  while (threads < kMaxThreads && threads * per_thread < D) threads *= 2;
  rmsnorm_kernel<T><<<static_cast<unsigned>(N), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), D, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rmsnorm_f32(const void* x, const void* scale, void* y, long long N, int D,
                float eps, void* stream) {
  return launch<float>(x, static_cast<const float*>(scale), y, N, D, eps,
                       stream);
}

int rmsnorm_bf16(const void* x, const void* scale, void* y, long long N,
                 int D, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, static_cast<const float*>(scale), y, N, D,
                               eps, stream);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
