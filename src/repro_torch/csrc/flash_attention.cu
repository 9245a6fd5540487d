// Forward online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:75
// flash_attention_pallas:
//
//   o[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, h / G, :]) v[b, j, h / G, :]
//
// over the keys j that the masks allow: j <= i when causal, j > i - window
// when a window is set.  q is (B, S, H, d), k and v are (B, S, KV, d) with
// G = H / KV query heads per key head (GQA through index arithmetic, no
// copy of k or v), float32 or bfloat16; o has q's dtype.  scale = d^-0.5.
// Fully masked rows give 0.
//
// Bound.  At the serve path's long prefill (h2o-danube-1.8b, S = 8192,
// H = 32, KV = 8, d = 80, window 4096) the reachable pairs need ~258
// GFLOP a layer against ~105 MB of q, k, v and o: the work is bound by
// operations, about 0.26 ms at the card's 989 TFLOP/s bf16 tensor-core
// rate.  This first kernel does its products on the f32 CUDA cores (67
// TFLOP/s), as the reference does its dots in f32, so it cannot come near
// that bound; wgmma on bf16 tiles with f32 accumulation is the later step.
//
// Design.  One block of 256 threads per (64-query tile, batch, head).
// The q tile (scaled) sits in shared memory as f32 for the whole block;
// 64-key tiles of k and v are staged into shared memory as f32 in turn.
// Thread (r, c), r = tid / 16, c = tid % 16, owns query rows 4r..4r+3:
// it computes the scores of those rows against keys c, c+16, c+32, c+48
// of the tile, and output columns c, c+16, ... of those rows.  The 16
// threads of a row sit in one half-warp, so a row's max and sum are
// folded with __shfl_xor_sync.  Row strides of d+1 and 65 floats keep the
// shared-memory reads free of bank conflicts.  Key tiles that the causal
// or window mask leaves wholly unreachable from the query tile are
// skipped: they would add exactly nothing.
//
// Numerics, as the Pallas kernel (flash_attention.py:36-66): the running
// max m, sum l and accumulator acc are f32, p stays f32 for the PV
// product, masked scores are -1e30, alpha = exp(min(m_prev - m_new, 0))
// is 0 while m_prev is still -1e30, and o = acc / (l == 0 ? 1 : l).
// Everything runs in a fixed order with no atomics, so repeated runs are
// bitwise equal.  The tiling is fixed here (64 x 64); the reference's
// q_block / kv_block arguments have no counterpart.
//
// Interface.  Plain extern "C" launchers, loaded with ctypes.  Each
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kPS = kBK + 1;   // row stride of the p tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, int H,
                     int KV, int causal, int window, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dim: a multiple of 16, <= 128");
  constexpr int QS = D + 1;   // row stride of the q tile
  constexpr int KS = D + 1;   // row stride of the k tile
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * KS;
  float* sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * D;    // stride of s in q, o
  const int64_t kv_row = static_cast<int64_t>(KV) * D;  // stride of s in k, v
  const T* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kh) * D;
  T* ob = o + (static_cast<int64_t>(b) * S * H + h) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, j = e % D;
    const int s = q0 + i;
    sQ[i * QS + j] = s < S ? __fmul_rn(to_f32(qb[s * q_row + j]), scale) : 0.f;
  }

  // the key range any query of this tile can reach
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int i = e / D, j = e % D;
      const int s = k0 + i;
      const bool in = s < S;
      sK[i * KS + j] = in ? to_f32(kb[s * kv_row + j]) : 0.f;
      sV[i * D + j] = in ? to_f32(vb[s * kv_row + j]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * r + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(c + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * r + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c + 16 * j;
        ok[j] = kj < S && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
        if (!ok[j]) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sP[(4 * r + i) * kPS + c + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = m[i] == kNegInf ? 0.f : expf(fminf(m[i] - m_new, 0.f));
      l[i] = alpha * l[i] + psum;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // sP complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * r + i) * kPS + kk];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vv[jj] = sV[kk * D + c + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * r + i;
    if (qi >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      store(ob + qi * q_row + c + 16 * jj, acc[i][jj] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int causal, int window, float scale,
             cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int D, int causal, int window, float scale,
           void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    case 32: return launch_d<T, 32>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    case 80: return launch_d<T, 80>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    case 96: return launch_d<T, 96>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    case 128: return launch_d<T, 128>(q, k, v, o, B, S, H, KV, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// window <= 0 means no window; causal is 0 or 1.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int D, int causal,
                        int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, B, S, H, KV, D, causal, window, scale,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int D, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, window,
                               scale, stream);
}

int flash_attention_head_dims(int* out, int n) {
  const int dims[] = {16, 32, 64, 80, 96, 128};
  const int count = static_cast<int>(sizeof(dims) / sizeof(dims[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = dims[i];
  return count;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
