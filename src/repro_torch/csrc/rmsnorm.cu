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
// Design against that bound.  A row belongs to one warp, several rows to
// a block.  Each lane loads its share of the row as 16-byte vectors (8
// bf16 or 4 f32; single elements when D is not a multiple of the vector
// width), lane-interleaved so that a warp reads 512 contiguous bytes at a
// time, issues all its loads before it uses any (one memory round trip),
// and keeps them in registers: x is read from device memory once, and the
// same registers are scaled and written after the sum.  At D = 2560 bf16
// that is ten vectors a lane.  The sum of squares folds over the warp
// with __shfl_xor_sync: no shared memory and no block barrier.  A row
// takes 2-8 warps, whose sums meet in shared memory after one
// __syncthreads, when it needs more than 16 vectors a lane from one warp
// (D > 4096 bf16, 2048 f32, 512 elements otherwise), or when the launch
// would have fewer than 2048 warps: a decode step's 4 rows then get 8
// warps each, so that each lane waits on 2 loads instead of 10 (python -m
// repro_torch.rmsnorm_ablation times each of these choices against its
// undoing).  Rows past 8 warps x 16 vectors are read twice by 32 warps
// instead of held.  scale is read as float4.  The TPU kernel's (256, D)
// row blocks in VMEM have no counterpart: a row is the unit of reuse
// here.
//
// Numerics.  Each lane adds its elements in a fixed order, the warp
// folds in a fixed pattern, and the warps of a row add their sums in
// order, so repeated runs are bitwise equal.  The order depends on the
// warps a row takes, so a row's result may differ in its last bit
// between a short and a long batch.  The order differs from the plain
// PyTorch version's, so results agree within a tolerance, not bitwise.  y = (x * r) * scale uses __fmul_rn and the sums __fadd_rn, so
// that no multiply-add is contracted.
//
// Interface.  Plain extern "C" launchers, loaded with ctypes.  Each
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVectors = 16;    // vectors a lane holds in registers
constexpr int kMaxHeldWarps = 8;   // warps a row may take when held
constexpr int kStreamWarps = 32;   // warps of a row that is streamed
constexpr int kMinThreads = 128;   // threads a block
constexpr long long kSpreadWarps = 2048;   // warps a launch should have

// W elements of T: the registers that hold them, and their conversions.
template <typename T, int W>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ void to_f32(Raw r, float* out) {
    out[0] = static_cast<float>(r);
  }
  static __device__ __forceinline__ Raw from_f32(const float* v) {
    return static_cast<T>(v[0]);
  }
  static __device__ __forceinline__ void scale(const float* s, float* out) {
    out[0] = s[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void to_f32(Raw r, float* out) {
    out[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw from_f32(const float* v) {
    return __float2bfloat16_rn(v[0]);
  }
  static __device__ __forceinline__ void scale(const float* s, float* out) {
    out[0] = s[0];
  }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void to_f32(Raw r, float* out) {
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
  static __device__ __forceinline__ Raw from_f32(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void scale(const float* s, float* out) {
    to_f32(*reinterpret_cast<const float4*>(s), out);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void to_f32(Raw r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw from_f32(const float* v) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
  static __device__ __forceinline__ void scale(const float* s, float* out) {
    Vec<float, 4>::scale(s, out);
    Vec<float, 4>::scale(s + 4, out + 4);
  }
};

template <typename T, int W>
__device__ __forceinline__ float sum_squares(typename Vec<T, W>::Raw r,
                                             float ss) {
  float f[W];
  Vec<T, W>::to_f32(r, f);
#pragma unroll
  for (int e = 0; e < W; ++e) ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
  return ss;
}

template <typename T, int W>
__device__ __forceinline__ typename Vec<T, W>::Raw normalize(
    typename Vec<T, W>::Raw r, float rs, const float* scale) {
  float f[W], s[W];
  Vec<T, W>::to_f32(r, f);
  Vec<T, W>::scale(scale, s);
#pragma unroll
  for (int e = 0; e < W; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], rs), s[e]);
  return Vec<T, W>::from_f32(f);
}

// `wpr` warps per row, blockDim.x / (32 * wpr) rows per block.  Lane
// `lane` of the row's warp `part` owns vectors part * 32 + lane + i * 32
// * wpr.  VPL > 0: at most VPL of them, held in registers; VPL == 0: any
// number, read twice.
template <typename T, int W, int VPL>
__global__ void __launch_bounds__(VPL > 0 ? 32 * kMaxHeldWarps
                                          : 32 * kStreamWarps)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, long long N, int D, float eps,
                   int wpr) {
  using V = Vec<T, W>;
  using Raw = typename V::Raw;
  __shared__ float warp_sums[kStreamWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / wpr, part = warp % wpr;
  const int rows_per_block = (blockDim.x >> 5) / wpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + slot;
  const bool live = row < N;
  const Raw* xr = reinterpret_cast<const Raw*>(x + (live ? row : 0) * D);
  Raw* yr = reinterpret_cast<Raw*>(y + (live ? row : 0) * D);
  const int nv = D / W;
  const int first = part * 32 + lane;
  const int stride = 32 * wpr;

  float ss = 0.f;
  Raw held[VPL > 0 ? VPL : 1];
  if (live) {
    if constexpr (VPL > 0) {
      // every load issued before the first is used: one round trip
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (first + i * stride < nv) held[i] = xr[first + i * stride];
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (first + i * stride < nv) ss = sum_squares<T, W>(held[i], ss);
    } else {
      for (int v = first; v < nv; v += stride) ss = sum_squares<T, W>(xr[v], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (wpr > 1) {   // the same on every warp of the block
    if (lane == 0) warp_sums[warp] = ss;
    __syncthreads();
    ss = warp_sums[slot * wpr];
    for (int k = 1; k < wpr; ++k) ss = __fadd_rn(ss, warp_sums[slot * wpr + k]);
  }
  if (!live) return;
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(D)), eps));

  if constexpr (VPL > 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = first + i * stride;
      if (v < nv) yr[v] = normalize<T, W>(held[i], rs, scale + v * W);
    }
  } else {
    for (int v = first; v < nv; v += stride)
      yr[v] = normalize<T, W>(xr[v], rs, scale + v * W);
  }
}

template <typename T, int W, int VPL>
int start(const T* x, const float* scale, T* y, long long N, int D,
          float eps, int wpr, cudaStream_t stream) {
  const int threads = max(kMinThreads, 32 * wpr);
  const long long rows_per_block = threads / (32 * wpr);
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_kernel<T, W, VPL><<<static_cast<unsigned>(blocks), threads, 0,
                              stream>>>(x, scale, y, N, D, eps, wpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_w(const T* x, const float* scale, T* y, long long N, int D,
             float eps, cudaStream_t stream) {
  const int nv = D / W;
  // more warps a row while the row needs it or the launch has few warps
  int wpr = 1;
  while (wpr < kMaxHeldWarps &&
         ((nv + 32 * wpr - 1) / (32 * wpr) > kMaxVectors ||
          N * wpr < kSpreadWarps))
    wpr *= 2;
  // registers held a lane: the vectors it owns, rounded up to an even
  // count (D = 2560 bf16: exactly 10)
  const int per_lane = (nv + 32 * wpr - 1) / (32 * wpr);
  switch (per_lane <= 2 ? per_lane : (per_lane + 1) / 2 * 2) {
    case 1: return start<T, W, 1>(x, scale, y, N, D, eps, wpr, stream);
    case 2: return start<T, W, 2>(x, scale, y, N, D, eps, wpr, stream);
    case 4: return start<T, W, 4>(x, scale, y, N, D, eps, wpr, stream);
    case 6: return start<T, W, 6>(x, scale, y, N, D, eps, wpr, stream);
    case 8: return start<T, W, 8>(x, scale, y, N, D, eps, wpr, stream);
    case 10: return start<T, W, 10>(x, scale, y, N, D, eps, wpr, stream);
    case 12: return start<T, W, 12>(x, scale, y, N, D, eps, wpr, stream);
    case 14: return start<T, W, 14>(x, scale, y, N, D, eps, wpr, stream);
    case 16: return start<T, W, 16>(x, scale, y, N, D, eps, wpr, stream);
    default:
      return start<T, W, 0>(x, scale, y, N, D, eps, kStreamWarps, stream);
  }
}

template <typename T, int W>
int launch(const void* x, const float* scale, void* y, long long N, int D,
           float eps, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  // the wrapper hands over 16-byte aligned x, scale and y
  // (_launch.on_cuda), so every row is aligned when D is a multiple of
  // the vector width
  if (D % W == 0) return launch_w<T, W>(xt, scale, yt, N, D, eps, st);
  return launch_w<T, 1>(xt, scale, yt, N, D, eps, st);
}

}  // namespace

extern "C" {

int rmsnorm_f32(const void* x, const void* scale, void* y, long long N, int D,
                float eps, void* stream) {
  return launch<float, 4>(x, static_cast<const float*>(scale), y, N, D, eps,
                          stream);
}

int rmsnorm_bf16(const void* x, const void* scale, void* y, long long N,
                 int D, float eps, void* stream) {
  return launch<__nv_bfloat16, 8>(x, static_cast<const float*>(scale), y, N,
                                  D, eps, stream);
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
