// Hybrid gradient-buffer flush kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/hybrid_aggregate.py:
//
//   flush_pallas           (:35)   out[p] = sum_k w[k] * g[k, p]
//   flush_momentum_pallas  (:82)   m'     = beta * m + sum_k w[k] * g[k, :]
//   flush_adamw_pallas     (:136)  g^ = sum_k w[k] g[k, :]; m', v' moments;
//                                  p' = p - scale * ((m'/bc1) / (sqrt(v'/bc2) + eps) + wd * p)
//
// Bound.  Each flush reads the (K, P) staging rows once and does 2 flops
// per element read, far below the card's 67 TFLOP/s f32 rate: every
// kernel here is bound by device-memory bytes.  At the cnn-cifar slab
// (K = 25, P = 270,336, f32) that is 27.0 MB of rows, about 8.4 us at
// 3.35 TB/s; the staging buffer also fits in the 50 MB L2.
//
// Design against that bound.  The Pallas version keeps a (K, 8192) tile
// in VMEM per sequential grid step; here every thread owns 4 consecutive
// P elements and reads them as one 16-byte vector (8 bytes for bf16), so
// a warp reads 512 contiguous bytes per row.  A 256-thread block covers
// 1024 elements and the grid covers P / 1024 blocks (264 for cnn-cifar),
// two blocks per SM.  The K weights are loaded once per block into shared
// memory.  The K loop is unrolled so several rows' loads are in flight
// per thread.  Each output element is written exactly once: no atomics,
// no cross-block reduction.
//
// Numerics.  The K loop runs in fixed order 0 .. K-1 over EVERY row, with
// a float32 accumulator, so a run is bitwise reproducible and a row of
// weight 0 adds exactly 0 even when it holds stale finite junk.  Rows
// are never skipped for a zero weight: the reference multiplies every
// row.  Arithmetic uses the explicitly rounded intrinsics (__fmul_rn,
// __fadd_rn, ...) so nvcc cannot contract a multiply and an add into an
// FMA: the kernels then reproduce the plain PyTorch fold of
// src/repro_torch/kernels/ref.py operation for operation.  bf16 rows are
// read as bf16 and upcast in registers.
//
// Interface.  Plain extern "C" launchers, loaded with ctypes.  Each
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kBlockP = kThreads * kVec;  // P elements per block
constexpr int kMaxK = 4096;               // weights in shared memory: 16 KB

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, sizeof(lo));
    memcpy(&hi, &raw.y, sizeof(hi));
    float2 a = __bfloat1622float2(lo);
    float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    memcpy(&raw.x, &lo, sizeof(lo));
    memcpy(&raw.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float4 load_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store_f32(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Copy the K weights into shared memory once per block.
__device__ __forceinline__ void load_weights(float* sw, const float* w, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
}

// acc = w[0]*g[0,p] ; acc = acc + w[k]*g[k,p] for k = 1 .. K-1, in order.
template <typename T>
__device__ __forceinline__ float4 weighted_sum(const float* sw, const T* g,
                                               int K, int64_t P, int64_t p) {
  float4 r = Vec4<T>::load(g + p);
  float w = sw[0];
  float4 acc = make_float4(__fmul_rn(w, r.x), __fmul_rn(w, r.y),
                           __fmul_rn(w, r.z), __fmul_rn(w, r.w));
#pragma unroll 8
  for (int k = 1; k < K; ++k) {
    r = Vec4<T>::load(g + static_cast<int64_t>(k) * P + p);
    w = sw[k];
    acc.x = __fadd_rn(acc.x, __fmul_rn(w, r.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w, r.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(w, r.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(w, r.w));
  }
  return acc;
}

__device__ __forceinline__ int64_t thread_offset() {
  return (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flush_kernel(const float* __restrict__ w, const T* __restrict__ g,
                 T* __restrict__ out, int K, int64_t P) {
  extern __shared__ float sw[];
  load_weights(sw, w, K);
  const int64_t p = thread_offset();
  Vec4<T>::store(out + p, weighted_sum<T>(sw, g, K, P, p));
}

__device__ __forceinline__ float momentum_step(float beta, float m, float agg) {
  return __fadd_rn(__fmul_rn(beta, m), agg);
}

// m is updated in place: m' is both the new moment and the update.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flush_momentum_kernel(const float* __restrict__ w, const T* __restrict__ g,
                          float* __restrict__ m, int K, int64_t P, float beta) {
  extern __shared__ float sw[];
  load_weights(sw, w, K);
  const int64_t p = thread_offset();
  const float4 agg = weighted_sum<T>(sw, g, K, P, p);
  const float4 mv = load_f32(m + p);
  store_f32(m + p, make_float4(momentum_step(beta, mv.x, agg.x),
                               momentum_step(beta, mv.y, agg.y),
                               momentum_step(beta, mv.z, agg.z),
                               momentum_step(beta, mv.w, agg.w)));
}

struct AdamWConsts {
  float b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded once on the host
  float bc1, bc2, scale;
};

// One element of the AdamW step; p, m, v are updated through the references.
__device__ __forceinline__ void adamw_step(const AdamWConsts& c, float g,
                                           float& p, float& m, float& v) {
  const float m_new = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  const float v_new = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, c.bc2)), c.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fdiv_rn(m_new, c.bc1), denom),
                              __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(c.scale, upd));
  m = m_new;
  v = v_new;
}

// h = (bc1, bc2, scale) lives on the device, so a flush never waits on the host.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flush_adamw_kernel(const float* __restrict__ w, const float* __restrict__ h,
                       const T* __restrict__ g, float* __restrict__ params,
                       float* __restrict__ mu, float* __restrict__ nu, int K,
                       int64_t P, float b1, float omb1, float b2, float omb2,
                       float eps, float wd) {
  extern __shared__ float sw[];
  load_weights(sw, w, K);
  const AdamWConsts c{b1, omb1, b2, omb2, eps, wd, h[0], h[1], h[2]};
  const int64_t p = thread_offset();
  const float4 gm = weighted_sum<T>(sw, g, K, P, p);
  float4 pv = load_f32(params + p), mv = load_f32(mu + p), vv = load_f32(nu + p);
  adamw_step(c, gm.x, pv.x, mv.x, vv.x);
  adamw_step(c, gm.y, pv.y, mv.y, vv.y);
  adamw_step(c, gm.z, pv.z, mv.z, vv.z);
  adamw_step(c, gm.w, pv.w, mv.w, vv.w);
  store_f32(params + p, pv);
  store_f32(mu + p, mv);
  store_f32(nu + p, vv);
}

bool bad_shape(int K, int64_t P) {
  return K < 1 || K > kMaxK || P <= 0 || P % kBlockP != 0 ||
         P / kBlockP > 0x7fffffff;
}

dim3 grid_for(int64_t P) { return dim3(static_cast<unsigned>(P / kBlockP)); }

size_t smem_for(int K) { return static_cast<size_t>(K) * sizeof(float); }

template <typename T>
int launch_flush(const void* w, const void* g, void* out, int K, int64_t P,
                 void* stream) {
  if (bad_shape(K, P)) return static_cast<int>(cudaErrorInvalidValue);
  flush_kernel<T><<<grid_for(P), kThreads, smem_for(K),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const T*>(g),
      static_cast<T*>(out), K, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_momentum(const void* w, const void* g, void* m, int K, int64_t P,
                    float beta, void* stream) {
  if (bad_shape(K, P)) return static_cast<int>(cudaErrorInvalidValue);
  flush_momentum_kernel<T><<<grid_for(P), kThreads, smem_for(K),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const T*>(g),
      static_cast<float*>(m), K, P, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adamw(const void* w, const void* h, const void* g, void* params,
                 void* mu, void* nu, int K, int64_t P, float b1, float omb1,
                 float b2, float omb2, float eps, float wd, void* stream) {
  if (bad_shape(K, P)) return static_cast<int>(cudaErrorInvalidValue);
  flush_adamw_kernel<T><<<grid_for(P), kThreads, smem_for(K),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(h),
      static_cast<const T*>(g), static_cast<float*>(params),
      static_cast<float*>(mu), static_cast<float*>(nu), K, P, b1, omb1, b2,
      omb2, eps, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hybrid_max_k() { return kMaxK; }

int hybrid_block_p() { return kBlockP; }

const char* hybrid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int hybrid_flush_f32(const void* w, const void* g, void* out, int K,
                     long long P, void* stream) {
  return launch_flush<float>(w, g, out, K, P, stream);
}

int hybrid_flush_bf16(const void* w, const void* g, void* out, int K,
                      long long P, void* stream) {
  return launch_flush<__nv_bfloat16>(w, g, out, K, P, stream);
}

int hybrid_flush_momentum_f32(const void* w, const void* g, void* m, int K,
                              long long P, float beta, void* stream) {
  return launch_momentum<float>(w, g, m, K, P, beta, stream);
}

int hybrid_flush_momentum_bf16(const void* w, const void* g, void* m, int K,
                               long long P, float beta, void* stream) {
  return launch_momentum<__nv_bfloat16>(w, g, m, K, P, beta, stream);
}

int hybrid_flush_adamw_f32(const void* w, const void* h, const void* g,
                           void* params, void* mu, void* nu, int K,
                           long long P, float b1, float omb1, float b2,
                           float omb2, float eps, float wd, void* stream) {
  return launch_adamw<float>(w, h, g, params, mu, nu, K, P, b1, omb1, b2, omb2,
                             eps, wd, stream);
}

int hybrid_flush_adamw_bf16(const void* w, const void* h, const void* g,
                            void* params, void* mu, void* nu, int K,
                            long long P, float b1, float omb1, float b2,
                            float omb2, float eps, float wd, void* stream) {
  return launch_adamw<__nv_bfloat16>(w, h, g, params, mu, nu, K, P, b1, omb1,
                                     b2, omb2, eps, wd, stream);
}

}  // extern "C"
