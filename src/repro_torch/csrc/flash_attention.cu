// Forward online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:75
// flash_attention_pallas:
//
//   o[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, h / G, :]) v[b, j, h / G, :]
//
// over the keys j that the masks allow: j <= i when causal, j > i - window
// when a window is set, j / chunk == i / chunk when a chunk is set (the
// chunked-local attention of src/repro/models/attention.py:74-75).  q is
// (B, S, H, d), k is (B, S, KV, d) and v is (B, S, KV, d_v) with G = H / KV
// query heads per key head (GQA through index arithmetic, no copy of k or
// v), float32 or bfloat16; o is (B, S, H, d_v) in q's dtype.  d_v may be
// narrower than d (MLA: q and k carry a rope part that v lacks).
// scale = d^-0.5.  Fully masked rows give 0.  Any S: keys and queries past
// S are masked.  The (d, d_v) pairs taken are FLASH_PAIRS below.
//
// Bound.  At the serve path's long prefill (h2o-danube-1.8b, S = 8192,
// H = 32, KV = 8, d = 80, window 4096) the reachable pairs need ~258
// GFLOP a layer (4 d per pair) against ~105 MB of q, k, v and o: the work
// is bound by operations, about 0.26 ms at the card's 989 TFLOP/s bf16
// tensor-core rate.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (the serving path): flash_fwd_bf16_kernel, on the tensor cores.
//   One block per (128-query tile, batch, head): two consumer warpgroups
//   of 64 query rows each and one producer warp.  One elected thread of
//   the producer warp loads the q tile once and every key tile of k and v
//   (128 keys; 64 at d = 128, where the accumulators of 128 would not fit
//   the registers) by TMA into a ring of two stages.  Each stage has a k
//   and a v mbarrier that the copy completes and an "empty" mbarrier that
//   the consumer warps arrive on when they are done with it, so the next
//   tile's copy overlaps this tile's math; both warpgroups read every
//   staged tile.  The key tile is chosen by d_v (64 keys at d_v = 128);
//   at d = 192 a stage holds a 24 KB k and a 16 KB v tile.  S = q k^T is
//   wgmma m64n{keys}k16 (bf16 q and k from shared memory, f32
//   accumulators, d/16 steps): products of bf16 values
//   are exact in f32, and the scale d^-0.5 (times log2 e, for exp2f) is
//   applied to the f32 scores, never to q.  The softmax runs on the
//   accumulator fragment in registers: a row's max folds over the four
//   threads that share it.  PV is wgmma m64n{d_v}k16 with P as the register
//   A operand.  A bf16 P alone would lose the precision the f32 reference
//   keeps (one rounding of p breaks a two-ulp tolerance on outputs near
//   zero by cancellation), so p is split into hi = bf16(p) and
//   lo = bf16(p - hi), and both are multiplied by the same v tile into the
//   same f32 accumulator.  That doubles the PV product's tensor work; the
//   bound above counts the function's work, not the kernel's.
//   Layout.  Head dims 16..128 in steps of 16 include 80, whose 160-byte
//   rows rule out the 128-byte swizzle.  Every tile is therefore stored
//   as d/16 chunks of 16 elements (32 bytes) a row, each chunk's rows
//   contiguous, with the 32-byte swizzle, one TMA box per chunk.  q and
//   k are K-major operands of S (depth d runs along the chunk); v is the
//   MN-major (transposed) B operand of PV (keys are the depth, d runs
//   along the chunk), from the same layout.  The output is divided by l,
//   rounded to bf16 once, written into the warpgroup's own q tile (d_v <=
//   d, so it fits) and stored by TMA, which writes no row past S.  The
//   masks leave each query one interval of keys (keys_of); a thread keeps
//   its two rows' intervals, and element masks (two comparisons) are
//   applied only in tiles that the causal, window or chunk boundary or S
//   crosses; tiles that no query of the block can reach are not loaded.
//   A block whose 128 queries straddle a chunk boundary loads the key
//   tiles of both chunks, and each row masks the other's keys.
//
// float32 (the JAX package's kernel tests, held at 2e-4):
//   flash_fwd_f32_kernel, on the f32 CUDA cores.  TF32 tensor cores would
//   not meet that bar.  One block of 256 threads per (64-query tile,
//   batch, head); the scaled q tile and each 64-key tile of k and v sit
//   in shared memory as f32.  Thread (r, c), r = tid / 16, c = tid % 16,
//   owns query rows 4r..4r+3: the scores of those rows against keys c,
//   c+16, c+32, c+48 of the tile, and output columns c, c+16, ... .  A
//   row's max and sum fold with __shfl_xor_sync within its half-warp.
//
// Numerics, as the Pallas kernel (flash_attention.py:36-66): the running
// max m, sum l and accumulator are f32, masked scores are -1e30,
// alpha = exp(min(m_prev - m_new, 0)) is 0 while m_prev is still -1e30,
// l sums the f32 p, and o = acc / (l == 0 ? 1 : l).  Both kernels run in
// a fixed order with no atomics, so repeated runs are bitwise equal.
// The tiling is the kernels' own; the reference's q_block / kv_block
// arguments have no counterpart.
//
// Interface.  Plain extern "C" launchers, loaded with ctypes.  Each
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns a cudaError_t as an int.  The bf16 launcher
// encodes its four TMA descriptors on the host for each call, with
// cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint, so the
// library needs no link against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ float32

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kPS = kBK + 1;   // row stride of the p tile

// The keys query qi may reach, [lo, hi): the masks leave one interval
// (kj <= qi when causal, kj > qi - window, kj / chunk == qi / chunk,
// kj < S), and both ends grow with qi, so the keys any query in
// [q_first, q_last] reaches run from q_first's lo to q_last's hi.
struct Keys {
  int lo, hi;
};

__device__ __forceinline__ Keys keys_of(int qi, int S, int causal,
                                        int window, int chunk) {
  Keys k{window > 0 ? max(0, qi - window + 1) : 0, causal ? qi + 1 : S};
  if (chunk > 0) {
    k.lo = max(k.lo, (qi / chunk) * chunk);
    k.hi = min(k.hi, (qi / chunk + 1) * chunk);
  }
  k.hi = min(k.hi, S);
  return k;
}

template <int D, int DV>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * DV + kBQ * kPS;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int H, int KV, int causal, int window,
                         int chunk, float scale) {
  static_assert(D % 16 == 0 && DV % 16 == 0 && D <= 192 && DV <= 128,
                "head dims: multiples of 16, d <= 192, d_v <= 128");
  constexpr int QS = D + 1;    // row stride of the q tile
  constexpr int KS = D + 1;    // row stride of the k tile
  constexpr int DC = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * KS;
  float* sP = sV + kBK * DV;

  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * D;     // stride of s in q
  const int64_t o_row = static_cast<int64_t>(H) * DV;    // ... in o
  const int64_t k_row = static_cast<int64_t>(KV) * D;    // ... in k
  const int64_t v_row = static_cast<int64_t>(KV) * DV;   // ... in v
  const float* qb = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * S * KV + kh) * D;
  const float* vb = v + (static_cast<int64_t>(b) * S * KV + kh) * DV;
  float* ob = o + (static_cast<int64_t>(b) * S * H + h) * DV;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, j = e % D;
    const int s = q0 + i;
    sQ[i * QS + j] = s < S ? __fmul_rn(qb[s * q_row + j], scale) : 0.f;
  }

  // the key range any query of this tile can reach, and this thread's
  // rows' own ranges
  const int k_begin = keys_of(q0, S, causal, window, chunk).lo;
  const int k_end = keys_of(min(q0 + kBQ, S) - 1, S, causal, window, chunk).hi;
  Keys row_keys[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    row_keys[i] = keys_of(q0 + 4 * r + i, S, causal, window, chunk);

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
      sK[i * KS + j] = s < S ? kb[s * k_row + j] : 0.f;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int i = e / DV, j = e % DV;
      const int s = k0 + i;
      sV[i * DV + j] = s < S ? vb[s * v_row + j] : 0.f;
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
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + c + 16 * j;
        ok[j] = kj >= row_keys[i].lo && kj < row_keys[i].hi;
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
      for (int jj = 0; jj < DC; ++jj) vv[jj] = sV[kk * DV + c + 16 * jj];
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
    for (int jj = 0; jj < DC; ++jj) ob[qi * o_row + c + 16 * jj] = acc[i][jj] / denom;
  }
}

template <int D, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int causal, int window, int chunk,
               float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, DV>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32_kernel<D, DV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal,
      window, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- bfloat16

namespace tc {

constexpr int kRows = 64;                    // query rows per consumer warpgroup
constexpr int kConsumers = 2;                // consumer warpgroups per block
constexpr int kBQ = kRows * kConsumers;      // query rows per block
// keys per staged tile: 128, or 64 at a value head dim of 128, where the
// score and output accumulators of a 128-key tile would not fit the
// registers
template <int DV>
__host__ __device__ constexpr int key_tile() { return DV > 96 ? 64 : 128; }
constexpr int kStages = 2;                   // k/v ring depth
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kChunk = 16;                   // bf16 elements per 32-byte chunk
constexpr int kRowBytes = 2 * kChunk;        // a row of one chunk
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int DV>
struct Smem {
  static constexpr int kQ = kRows * D * 2;   // one warpgroup's q (and o) tile
  static constexpr int kK = key_tile<DV>() * D * 2;    // one k tile
  static constexpr int kV = key_tile<DV>() * DV * 2;   // one v tile
  static constexpr int kBars = 1 + 3 * kStages;
  // 1024 bytes of slack to align the tiles for the swizzle
  static constexpr int kBytes = 1024 + kConsumers * kQ + kStages * (kK + kV) +
                                8 * kBars;
  static_assert(kBytes <= 227 * 1024, "more shared memory than an SM has");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed.  A phase that
// never completes (a copy that was refused) ends the kernel with an error
// after some seconds instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, "
      "%5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a tile stored as 32-byte rows with
// the 32-byte swizzle: 8-row groups 256 bytes apart (SBO); `lbo` is the
// distance between 16-element chunks along the non-depth dimension, read
// only for MN-major operands.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32 | static_cast<uint64_t>(3) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D = A * B (+ D when accumulate), A 64 x 16 and B 16 x N bf16, both
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate);
// D += A * B, A 64 x 16 bf16 in registers (4 x bf16x2 per thread), B
// 16 x N bf16 MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, int S,
                          int H, int KV, int causal, int window, int chunk,
                          float scale_log2) {
  static_assert(D % kChunk == 0 && DV % kChunk == 0 && DV <= D && DV <= 128,
                "head dims: multiples of 16, d_v <= d (o reuses the q "
                "tile), d_v <= 128");
  constexpr int kBK = key_tile<DV>();
  constexpr int NC = D / kChunk;           // chunks per q or k row
  constexpr int NCV = DV / kChunk;         // chunks per v or o row
  constexpr int kQ = Smem<D, DV>::kQ;
  constexpr int kK = Smem<D, DV>::kK;
  constexpr int kV = Smem<D, DV>::kV;
  constexpr int NS = kBK / 2;              // score accumulators per thread
  constexpr int NO = DV / 2;               // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = base;                           // [warpgroup][chunk][64][16]
  uint8_t* sK = sQ + kConsumers * kQ;           // [stage][chunk][kBK][16]
  uint8_t* sV = sK + kStages * kK;              // [stage][chunk][kBK][16]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KV);
  // the key tiles any query of this block can reach
  const int k_lo = keys_of(q0, S, causal, window, chunk).lo;
  const int k_hi = keys_of(min(q0 + kBQ, S) - 1, S, causal, window, chunk).hi;
  const int t_first = k_lo / kBK;
  const int n_tiles = (k_hi - 1) / kBK - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one elected thread keeps the ring full
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, kConsumers * kQ);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + w * kQ + c * kRows * kRowBytes, &tq, q_full,
                   c * kChunk, h, q0 + w * kRows, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) - 1) & 1);
        const int k0 = (t_first + i) * kBK;
        mbar_expect_tx(&k_full[st], kK);
        for (int c = 0; c < NC; ++c)
          tma_load(sK + st * kK + c * kBK * kRowBytes, &tk, &k_full[st],
                   c * kChunk, kh, k0, b);
        mbar_expect_tx(&v_full[st], kV);
        for (int c = 0; c < NCV; ++c)
          tma_load(sV + st * kV + c * kBK * kRowBytes, &tv, &v_full[st],
                   c * kChunk, kh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows qw .. qw + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qw = q0 + wg * kRows;
  // this thread's two rows (within the warpgroup) and first column pair
  const int row = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  // the keys this thread's two rows reach, and a key tile every row of
  // the warpgroup reaches whole: [full_lo, full_hi)
  const Keys row_keys[2] = {keys_of(qw + row, S, causal, window, chunk),
                            keys_of(qw + row + 8, S, causal, window, chunk)};
  const int full_lo = keys_of(qw + kRows - 1, S, causal, window, chunk).lo;
  const int full_hi = keys_of(qw, S, causal, window, chunk).hi;
  uint8_t* myQ = sQ + wg * kQ;
  const uint32_t q_addr = smem_u32(myQ);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of each row's sum

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_first + i) * kBK;

    // S = q k^T, f32
    float s[NS];
    mbar_wait(&k_full[st], parity);
    const uint32_t k_addr = smem_u32(sK + st * kK);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_ss<kBK>(s, desc_sw32(q_addr + c * kRows * kRowBytes, 16),
                    desc_sw32(k_addr + c * kBK * kRowBytes, 16), c > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin<NS>(s);

    // online softmax on the fragment: s[j] is row + 8 * ((j >> 1) & 1),
    // key column 8 * (j >> 2) + col + (j & 1)
    const bool edge = k0 < full_lo || k0 + kBK > full_hi;
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] *= scale_log2;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const Keys& rk = row_keys[(j >> 1) & 1];
        const int kj = k0 + 8 * (j >> 2) + col + (j & 1);
        if (kj < rk.lo || kj >= rk.hi) s[j] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m[r] == kNegInf ? 0.f : exp2f(fminf(m[r] - m_new, 0.f));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];

    // p in f32 for l; hi = bf16(p) and lo = bf16(p - hi) for PV.  The
    // accumulator fragment of columns 16t..16t+15 is the A fragment of
    // k-step t: registers 4t..4t+3 of each.
    uint32_t p_hi[NS / 2], p_lo[NS / 2];
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const int r = (j >> 1) & 1;
      float p0 = exp2f(s[j] - m[r]);
      float p1 = exp2f(s[j + 1] - m[r]);
      if (edge && m[r] == kNegInf) p0 = p1 = 0.f;   // no key in reach yet
      l[r] += p0;
      l[r] += p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[j / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[j / 2] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }

    // o += p_hi v + p_lo v, f32
    mbar_wait(&v_full[st], parity);
    const uint32_t v_addr = smem_u32(sV + st * kV);
    pin<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      const uint64_t dv = desc_sw32(v_addr + t * 16 * kRowBytes, kBK * kRowBytes);
      wgmma_rs<DV>(o, &p_hi[4 * t], dv);
      wgmma_rs<DV>(o, &p_lo[4 * t], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin<NO>(o);
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with the stage
  }

  // o / l, rounded to bf16 once, into this warpgroup's q tile (its last
  // read was the last S product), then out by TMA
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    t = t + __shfl_xor_sync(0xffffffffu, t, 2);
    den[r] = t == 0.f ? 1.f : t;
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
  for (int j = 0; j < NO; j += 2) {
    const int r = (j >> 1) & 1;
    const int c = 8 * (j >> 2) + col;
    uint32_t off = (c / kChunk) * kRows * kRowBytes + (row + 8 * r) * kRowBytes +
                   (c % kChunk) * 2;
    off ^= ((off >> 7) & 1) << 4;   // the 32-byte swizzle
    *reinterpret_cast<uint32_t*>(myQ + off) =
        pack_bf16(o[j] / den[r], o[j + 1] / den[r]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid == 0 && qw < S) {
    for (int c = 0; c < NCV; ++c)
      tma_store(&to, myQ + c * kRows * kRowBytes, c * kChunk, h, qw, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// x (B, S, heads, D) bf16 as a 4-D map, boxes of one 16-element chunk of
// `rows` consecutive positions of one head, 32-byte swizzle, zero fill
// past S.
bool tensor_map(CUtensorMap* map, const void* x, int B, int S, int heads,
                int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunk), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int causal, int window, int chunk, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, B, S, H, D, kRows) ||
      !tensor_map(&tk, k, B, S, KV, D, key_tile<DV>()) ||
      !tensor_map(&tv, v, B, S, KV, DV, key_tile<DV>()) ||
      !tensor_map(&to, o, B, S, H, DV, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Smem<D, DV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_bf16_kernel<D, DV><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, to, S, H, KV, causal, window, chunk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int check_shape(int B, int S, int H, int KV) {
  return B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B * H > 65535
             ? static_cast<int>(cudaErrorInvalidValue)
             : 0;
}

}  // namespace

// The (d, d_v) head-dim pairs instantiated: the square ones of the dense
// models, and MLA's (deepseek-v2-lite: 128 + 64 rope, 128; its smoke
// variant: 64 + 16, 64).
#define FLASH_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(80, 80) X(96, 96) X(128, 128) X(80, 64) \
  X(192, 128)

extern "C" {

// window <= 0 means no window, chunk <= 0 no chunk; causal is 0 or 1.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int D, int DV, int causal,
                        int window, int chunk, float scale, void* stream) {
  if (int err = check_shape(B, S, H, KV)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(d, dv)                                                           \
  if (D == d && DV == dv)                                                     \
    return launch_f32<d, dv>(q, k, v, o, B, S, H, KV, causal, window, chunk, \
                             scale, st);
  FLASH_PAIRS(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int D, int DV,
                         int causal, int window, int chunk, float scale,
                         void* stream) {
  if (int err = check_shape(B, S, H, KV)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASE(d, dv)                                                          \
  if (D == d && DV == dv)                                                    \
    return tc::launch<d, dv>(q, k, v, o, B, S, H, KV, causal, window, chunk, \
                             scale, st);
  FLASH_PAIRS(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The pairs taken, as d0, dv0, d1, dv1, ... into out (up to n ints);
// returns the number of pairs.
int flash_attention_head_dims(int* out, int n) {
  int count = 0;
#define PAIR(d, dv)                          \
  if (2 * count + 1 < n) {                   \
    out[2 * count] = d;                      \
    out[2 * count + 1] = dv;                 \
  }                                          \
  ++count;
  FLASH_PAIRS(PAIR)
#undef PAIR
  return count;
}

// Dynamic shared memory of the bf16 kernel at head dims (D, DV), 0 if the
// pair is not taken.
int flash_attention_bf16_smem_bytes(int D, int DV) {
#define CASE(d, dv) \
  if (D == d && DV == dv) return tc::Smem<d, dv>::kBytes;
  FLASH_PAIRS(CASE)
#undef CASE
  return 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
