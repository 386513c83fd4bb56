// The backward of the GQA flash attention (csrc/flash_attention.cu), for
// Hopper: the gradient the LM training path takes through every
// full-sequence attention, causal (a decoder's self-attention) or unmasked
// (an encoder's, and cross-attention).
//
// Replaces no TPU kernel: the Pallas kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_call
// has no VJP, and the reference trains through its XLA attention
// (repro/models/lm/attention.py, "chunked"). This computes that gradient,
// for the forward kernel the port already launches, by the explicit
// flash-attention formulas (the plain version is
// kernels/flash_attention/ref.py::flash_attention_bwd_ref), in f32:
//   P = exp(s - lse)      s = (q . k) * scale, masked as the forward masks it
//                         (kpos >= T; causal: kpos - (T - S) > qpos), lse the
//                         forward's row log-sum-exp
//   D = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the G = H / KV q-heads that read each kv-head.
// Inputs f32 or bf16 (every product exact in f32: the CUDA-core pair widens
// bf16 as it stages it, the tensor-core pair multiplies bf16 into f32), hd
// <= 128, q/o/dO [B, S, H, hd], k/v [B, T, KV, hd], lse f32 [B, H, S]; dq,
// dk, dv in q's dtype.
//
// Two kernels, launched in this order on one stream, in two variants that
// the wrapper (kernels/flash_attention/ops.py, flash_attention_bwd) picks as
// the forward's is picked (ops.flash_variant): the tensor-core pair for bf16
// with hd 64 or 128 and every base 16-byte aligned, the CUDA-core pair for
// everything else (f32: the REDUCED configs; other head dims). It never
// falls back.
//
// The CUDA-core pair:
// 1. flash_bwd_dq_kernel: one block per (q-head, batch, 64 query rows).
//    Stages Q and dO once, computes D for its rows (written to a f32
//    [B, H, S] scratch for kernel 2), then walks the key blocks of 64 that
//    its rows see, in order (K and V staged per block), recomputing P from
//    lse, and sums dQ in registers.
// 2. flash_bwd_dkdv_kernel: one block per (kv-head, batch, 64 keys). Stages
//    K and V once, then walks the G q-heads and, for each, the query blocks
//    that see a key of the block, in a fixed order, and sums dK and dV in
//    registers.
// Each output element is written once by one thread, after a sum in a
// fixed order: no atomics, so the gradient is bitwise the same from run to
// run.
//
// What bounds it on an H100: operations. At the Qwen2-1.5B training shape
// (B 4, S = T = 2048, H 12, KV 2, hd 128, causal) the five products are
// 2.5 times the forward's 51.6 GFLOP (128.9 GFLOP, 0.130 ms at the bf16
// tensor cores' 989 TFLOP/s) against ~118 MB of q, k, v, o, dO, lse and the
// three gradients (0.035 ms at 3.35 TB/s).
//
// The CUDA-core pair runs in f32 (the tiles of the forward's CUDA-core
// kernel: 256 threads, each 4 rows x 4 keys of a score tile and 4 rows x
// hd / 16 columns of an accumulator; odd row strides in shared memory so the
// 16 threads that read one column hit 16 banks); kernel 1 recomputes S and
// dP, which kernel 2 also computes, so it does 3.5 of the forward's
// products, at ~15 TFLOP/s on the CUDA cores.
//
// The tensor-core pair (flash_bwd_tc_dq_kernel, flash_bwd_tc_dkdv_kernel)
// keeps the forward's precision on wgmma, with the forward's building
// blocks (wgmma_tiles.cuh): one warpgroup per block, two blocks per SM,
// bf16 tiles staged by cp.async in wgmma's 128-byte swizzle.
// - S = Q K^T and dP = dO V^T (in the dK/dV kernel S^T = K Q^T and
//   dP^T = V dO^T: 64 keys x 64 query columns) are bf16 x bf16 products
//   into f32 accumulators, both operands read from shared memory (K-major):
//   each product is exact, only the order of the sums differs.
// - dV += P^T dO, dK += dS^T Q and dQ += dS K keep P and dS in f32: each is
//   split into hi = bf16(x) and lo = bf16(x - hi), two register A operands
//   of wgmma against the same shared-memory B tile (~2^-17 relative, where
//   one bf16 term would err by up to 2^-9). The accumulator layout of S^T
//   and dP^T is, in the same registers, the A layout of those products (the
//   forward's P.V identity), and one swizzled tile serves both roles: Q and
//   dO as K-major B operands of S^T and dP^T and MN-major ones of dK and dV,
//   K as a K-major B operand of S and an MN-major one of dQ.
// - The dQ kernel stages Q and dO once and carries K and V through a
//   two-stage ring; the dK/dV kernel stages K and V once and carries Q, dO
//   and the step's 64 lse and D values through the ring.
// - Its products: P and dS in two terms make the dQ kernel 4 of the
//   forward's single products and the dK/dV kernel 6 (at Qwen2-1.5B's
//   shape 258 GFLOP, twice the bound's count: a 0.26 ms floor for this
//   design). Registers: the dK/dV kernel at hd 128 holds 128 f32 of dK and
//   dV, 64 of S^T and dP^T and their split operands, built 16 columns at a
//   time, in 255 registers without spilling.
// - Causal load balance: a dK/dV block walks every query block that sees
//   its keys, so the first key blocks walk the longest. Where the grid has
//   few blocks for the card (ops.bwd_head_splits), `splits` blocks share each
//   (kv-head, batch, 64 keys), each over its own run of the G q-heads,
//   writing f32 partial sums that flash_bwd_tc_sum_kernel adds in split
//   order: still no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kB = 64;         // query rows or keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 columns
constexpr int kLDP = kB + 4;   // row stride of the P and dS tiles (16-byte rows)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum over the 16 threads of a half warp (they share rows).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [r0, r0 + 64) of one head of x (row stride `row`, hd columns) into
// dst [64][HD + 1] as f32; rows at or past `rows` and columns at or past hd
// are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, long row, int r0,
                                      int rows, int hd) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < kB * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int pos = r0 + r;
    dst[r * LD + d] = (pos < rows && d < hd) ? to_f32(x[pos * row + d]) : 0.f;
  }
}

// s[i][j] = a_row(ty*4+i) . b_row(tx+16j) and t[i][j] = c_row . d_row over
// HD columns: the score tile Q K^T and the tile dO V^T together.
template <int HD>
__device__ __forceinline__ void two_products(const float* a, const float* b, const float* c,
                                             const float* d, int ty, int tx, float (&s)[4][4],
                                             float (&t)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int col = 0; col < HD; ++col) {  // columns past hd are 0 in every tile
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty * 4 + i) * LD + col];
      cv[i] = c[(ty * 4 + i) * LD + col];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = b[(tx + 16 * j) * LD + col];
      dv[j] = d[(tx + 16 * j) * LD + col];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], dv[j], t[i][j]);
      }
  }
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kB * (HD + 1) + kB * kLDP) * 4;  // Q, dO, K, V; dS
}
template <int HD>
constexpr int dkdv_smem_bytes() {
  return (4 * kB * (HD + 1) + 2 * kB * kLDP) * 4;  // K, V, Q, dO; P, dS
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dvec, T* __restrict__ dq, int S, int T_, int H, int KV, int hd,
    float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [kB][LD]
  float* dos = qs + kB * LD;   // [kB][LD]
  float* ks = dos + kB * LD;   // [kB][LD]
  float* vs = ks + kB * LD;    // [kB][LD]
  float* dss = vs + kB * LD;   // [kB][kLDP]

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kB;  // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_row = static_cast<long>(H) * hd;
  const long kv_row = static_cast<long>(KV) * hd;
  const long q_off = static_cast<long>(b) * S * q_row + static_cast<long>(h) * hd;
  const long kv_off = static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * hd;
  const long row_off = (static_cast<long>(b) * H + h) * S;  // into lse and dvec
  const int shift = T_ - S;  // key kpos is visible to query qpos iff kpos - shift <= qpos

  stage<T, HD>(qs, q + q_off, q_row, q0, S, hd);
  stage<T, HD>(dos, dout + q_off, q_row, q0, S, hd);
  __syncthreads();

  // D = rowsum(dO o O) and lse of this thread's 4 rows; D also for kernel 2.
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qpos = q0 + r;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (qpos < S && col < hd) part = fmaf(dos[r * LD + col], to_f32(o[q_off + qpos * q_row + col]), part);
    }
    d_r[i] = half_warp_sum(part);
    lse_r[i] = qpos < S ? lse[row_off + qpos] : 0.f;
    if (tx == 0 && qpos < S) dvec[row_off + qpos] = d_r[i];
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // The last key any row of this block sees (causal: >= 0 since S <= T).
  const int last_key = CAUSAL ? min(T_ - 1, q0 + kB - 1 + shift) : T_ - 1;
  const int nkb = last_key / kB + 1;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous K, V and dS tiles are consumed
    stage<T, HD>(ks, k + kv_off, kv_row, k0, T_, hd);
    stage<T, HD>(vs, v + kv_off, kv_row, k0, T_, hd);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<HD>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool seen = qpos < S && kpos < T_ && (!CAUSAL || kpos - shift <= qpos);
        const float p = seen ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(ty * 4 + i) * kLDP + tx + 16 * j] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncthreads();

    const int nk = min(kB, T_ - k0);  // keys past T have dS = 0 and K = 0
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty * 4 + i) * kLDP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) dq[q_off + qpos * q_row + col] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, int S, int T_, int H, int KV, int hd, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;            // [kB][LD]
  float* vs = ks + kB * LD;    // [kB][LD]
  float* qs = vs + kB * LD;    // [kB][LD]
  float* dos = qs + kB * LD;   // [kB][LD]
  float* ps = dos + kB * LD;   // [kB][kLDP]: P, query-major
  float* dss = ps + kB * kLDP; // [kB][kLDP]: dS, query-major

  const int k0 = blockIdx.z * kB;  // causal: the first key blocks see the most queries
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_row = static_cast<long>(H) * hd;
  const long kv_row = static_cast<long>(KV) * hd;
  const long kv_off = static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * hd;
  const int shift = T_ - S;

  stage<T, HD>(ks, k + kv_off, kv_row, k0, T_, hd);
  stage<T, HD>(vs, v + kv_off, kv_row, k0, T_, hd);

  // keys ty*4 + i of the block, columns tx + 16c
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // The first query that sees key k0 (causal) lies in block q_first.
  const int q_first = CAUSAL ? max(0, k0 - shift) / kB : 0;
  const int nqb = (S + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long q_off = static_cast<long>(b) * S * q_row + static_cast<long>(h) * hd;
    const long row_off = (static_cast<long>(b) * H + h) * S;
    for (int qb = q_first; qb < nqb; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();  // the previous Q, dO, P and dS tiles are consumed
      stage<T, HD>(qs, q + q_off, q_row, q0, S, hd);
      stage<T, HD>(dos, dout + q_off, q_row, q0, S, hd);
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<HD>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        const float lse_i = qpos < S ? lse[row_off + qpos] : 0.f;
        const float d_i = qpos < S ? dvec[row_off + qpos] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool seen = qpos < S && kpos < T_ && (!CAUSAL || kpos - shift <= qpos);
          const float p = seen ? expf(s[i][j] * scale - lse_i) : 0.f;
          ps[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
          dss[(ty * 4 + i) * kLDP + tx + 16 * j] = p * (dp[i][j] - d_i);
        }
      }
      __syncthreads();

      const int nq = min(kB, S - q0);  // rows past S have P = dS = 0 and Q = dO = 0
#pragma unroll 2
      for (int r = 0; r < nq; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kLDP + ty * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(dss + r * kLDP + ty * 4);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dos[r * LD + tx + 16 * c];
          const float qv = qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pr[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dr[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= T_) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) {
        dk[kv_off + kpos * kv_row + col] = from_f32<T>(dk_acc[i][c] * scale);
        dv[kv_off + kpos * kv_row + col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  void *dq, *dk, *dv;
  int B, S, T, H, KV, hd;
  float scale;
};

template <typename T, int HD, bool CAUSAL>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.B, (a.S + kB - 1) / kB);
  flash_bwd_dq_kernel<T, HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.dvec,
      static_cast<T*>(a.dq), a.S, a.T, a.H, a.KV, a.hd, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, bool CAUSAL>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.KV, a.B, (a.T + kB - 1) / kB);
  flash_bwd_dkdv_kernel<T, HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dvec, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.S, a.T, a.H, a.KV, a.hd, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = the dQ kernel, 1 = the dK/dV kernel.
template <typename T, bool CAUSAL>
int dispatch_hd(const Args& a, int which, cudaStream_t stream) {
  if (a.hd <= 32) return which ? launch_dkdv<T, 32, CAUSAL>(a, stream) : launch_dq<T, 32, CAUSAL>(a, stream);
  if (a.hd <= 64) return which ? launch_dkdv<T, 64, CAUSAL>(a, stream) : launch_dq<T, 64, CAUSAL>(a, stream);
  return which ? launch_dkdv<T, 128, CAUSAL>(a, stream) : launch_dq<T, 128, CAUSAL>(a, stream);
}

int dispatch(const Args& a, int bf16, int causal, int which, cudaStream_t stream) {
  if (bf16) {
    return causal ? dispatch_hd<__nv_bfloat16, true>(a, which, stream)
                  : dispatch_hd<__nv_bfloat16, false>(a, which, stream);
  }
  return causal ? dispatch_hd<float, true>(a, which, stream)
                : dispatch_hd<float, false>(a, which, stream);
}

int run(int device, int which, const void* q, const void* k, const void* v, const void* o,
        const void* dout, const float* lse, float* dvec, void* dq, void* dk, void* dv, int bf16,
        int B, int S, int T, int H, int KV, int hd, int causal, float scale, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0 || T == 0 || H == 0) return 0;
  const Args a{q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, T, H, KV, hd, scale};
  return dispatch(a, bf16, causal, which, static_cast<cudaStream_t>(stream_ptr));
}


// ------------------------------------------------ tensor-core variant (bf16)
namespace tc {

constexpr int kBR = 64;  // a block's rows: query rows (dQ kernel) or keys (dK/dV): wgmma's M
constexpr int kBC = 64;  // a step's columns: keys (dQ kernel) or query rows (dK/dV): wgmma's N

// 4 bytes global -> shared, zero-filled where src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The cp.async writes that have landed are seen by wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int HD>
constexpr int dq_smem_bytes() {  // Q, dO; K and V in two stages each; D; 1024-byte alignment
  return (2 * kBR + 4 * kBC) * HD * 2 + kBR * 4 + 1024;
}
template <int HD>
constexpr int dkdv_smem_bytes() {  // K, V; Q, dO, lse and D in two stages each; alignment
  return (2 * kBR + 4 * kBC) * HD * 2 + 4 * kBC * 4 + 1024;
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_tc_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dvec, bf16* __restrict__ dq, int S, int T_, int H, int KV, float scale) {
  constexpr int KS = HD / 16;  // 16-wide k steps of Q.K^T and dO.V^T
  constexpr int NA = HD / 2;   // dQ accumulators per thread (64 rows x HD over 128 threads)
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* dos = qs + kBR * HD;                                 // [hd / 64][kBR][64]
  bf16* ks = dos + kBR * HD;                                 // [2][hd / 64][kBC][64]
  bf16* vs = ks + 2 * kBC * HD;                              // [2][hd / 64][kBC][64]
  float* dsh = reinterpret_cast<float*>(vs + 2 * kBC * HD);  // [kBR]: D of the block's rows

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBR;  // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const long q_row = static_cast<long>(H) * HD;
  const long kv_row = static_cast<long>(KV) * HD;
  const long q_off = static_cast<long>(b) * S * q_row + static_cast<long>(h) * HD;
  const long kv_off = static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * HD;
  const long row_off = (static_cast<long>(b) * H + h) * S;  // into lse and dvec
  const int shift = T_ - S;  // key kpos is visible to query qpos iff kpos - shift <= qpos
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row and column pair
  const int wq = q0 + warp * 16;          // this warp's first query row
  const int qpos0 = wq + g, qpos1 = qpos0 + 8;

  // The last key any row of this block sees (causal: >= 0 since S <= T).
  const int last_key = CAUSAL ? min(T_ - 1, q0 + kBR - 1 + shift) : T_ - 1;
  const int nkb = last_key / kBC + 1;

  load_tile<HD, kBR>(qs, q + q_off, q_row, q0, S);
  load_tile<HD, kBR>(dos, dout + q_off, q_row, q0, S);
  load_tile<HD, kBC>(ks, k + kv_off, kv_row, 0, T_);
  load_tile<HD, kBC>(vs, v + kv_off, kv_row, 0, T_);
  cp_async_commit();

  // D = rowsum(dO o O) of the block's rows in f32, while the tiles land: two
  // threads a row, HD / 2 columns each in 16-byte reads; also into dvec for
  // the dK/dV kernel.
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qpos = q0 + r;
    float part = 0.f;
    if (qpos < S) {
      const long base = q_off + qpos * q_row + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(dout + base + c);
        const uint4 w = *reinterpret_cast<const uint4*>(o + base + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(a2[j]), y = __bfloat1622float2(w2[j]);
          part = fmaf(x.x, y.x, part);
          part = fmaf(x.y, y.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      dsh[r] = part;
      if (qpos < S) dvec[row_off + qpos] = part;
    }
  }
  __syncthreads();
  const float d0 = dsh[qpos0 - q0], d1 = dsh[qpos1 - q0];
  const float l0 = qpos0 < S ? lse[row_off + qpos0] : 0.f;
  const float l1 = qpos1 < S ? lse[row_off + qpos1] : 0.f;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nkb) {  // the other stage was released by the barrier that ended kb - 1
      load_tile<HD, kBC>(ks + (st ^ 1) * kBC * HD, k + kv_off, kv_row, (kb + 1) * kBC, T_);
      load_tile<HD, kBC>(vs + (st ^ 1) * kBC * HD, v + kv_off, kv_row, (kb + 1) * kBC, T_);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued has landed
    fence_async_smem();
    __syncthreads();
    const uint32_t k_addr = smem_u32(ks + st * kBC * HD);
    const uint32_t v_addr = smem_u32(vs + st * kBC * HD);

    // S = Q K^T and dP = dO V^T, 64 rows x 64 keys each, in the forward's
    // accumulator layout: rows qpos0 (x[4j], x[4j + 1]) and qpos1 (x[4j + 2],
    // x[4j + 3]), keys 8j + 2t, + 1.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(s, smem_desc(q_addr + (kk >> 2) * kBR * 128 + (kk & 3) * 32, 16, 1024),
                   smem_desc(k_addr + (kk >> 2) * kBC * 128 + (kk & 3) * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, smem_desc(do_addr + (kk >> 2) * kBR * 128 + (kk & 3) * 32, 16, 1024),
                   smem_desc(v_addr + (kk >> 2) * kBC * 128 + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit_and_wait();
    fence_regs(s);
    fence_regs(dp);

    // dS = P o (dP - D) into s; P = 0 where the forward masked.
    const int k0 = kb * kBC;
    const bool masked = k0 + kBC > T_ || wq + 16 > S || (CAUSAL && k0 + kBC - 1 - shift > wq);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = expf(s[i] * scale - ((i & 2) ? l1 : l0));
      if (masked) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= T_ || qpos >= S || (CAUSAL && kpos - shift > qpos)) p = 0.f;
      }
      s[i] = p * (dp[i] - ((i & 2) ? d1 : d0));
    }

    // dQ += dS K, dS = hi + lo against the same K tile read MN-major. The A
    // fragment of keys 16kk.. is accumulator tiles 2kk and 2kk + 1.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
        split_bf16(s[i], s[i + 1], hi[kk][r], lo[kk][r]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys: two 8-row atoms of K
      const uint64_t bk = smem_desc(k_addr + kk * 2048, kBC * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128(acc, hi[kk], bk, 1);
        wgmma_rs_n128(acc, lo[kk], bk, 1);
      } else {
        wgmma_rs_n64(acc, hi[kk], bk, 1);
        wgmma_rs_n64(acc, lo[kk], bk, 1);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(acc);
    __syncthreads();  // this stage is free for the prefetch two blocks on
  }

  bf16* dqh = dq + q_off + 2 * t;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (qpos0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqh + qpos0 * q_row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (qpos1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqh + qpos1 * q_row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// One block per (kv-head and head split, batch, 64 keys): the q-heads
// [g_begin, g_end) of the split and, for each in turn, the query blocks that
// see a key of the block, in order. splits == 1 writes dk (scaled) and dv in
// bf16; otherwise f32 partial sums into partial [2][splits][B, T, KV, hd]
// (dK's, then dV's), which flash_bwd_tc_sum_kernel adds.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_tc_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ partial, int S, int T_,
    int H, int KV, int splits, float scale) {
  constexpr int KS = HD / 16;
  constexpr int NA = HD / 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* vs = ks + kBR * HD;                                  // [hd / 64][kBR][64]
  bf16* qs = vs + kBR * HD;                                  // [2][hd / 64][kBC][64]
  bf16* dos = qs + 2 * kBC * HD;                             // [2][hd / 64][kBC][64]
  float* lsh = reinterpret_cast<float*>(dos + 2 * kBC * HD);  // [2][kBC]: lse of the columns
  float* dsh = lsh + 2 * kBC;                                // [2][kBC]: D of the columns

  const int k0 = blockIdx.z * kBR;  // causal: the first key blocks see the most queries
  const int kvh = blockIdx.x / splits, sp = blockIdx.x % splits, b = blockIdx.y;
  const int G = H / KV;
  const int g_begin = sp * G / splits, g_end = (sp + 1) * G / splits;
  const long q_row = static_cast<long>(H) * HD;
  const long kv_row = static_cast<long>(KV) * HD;
  const long kv_off = static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * HD;
  const int shift = T_ - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk = k0 + warp * 16;  // this warp's first key
  const int kpos0 = wk + g, kpos1 = kpos0 + 8;

  // The first query that sees key k0 (causal) lies in block q_first; every
  // key block has one (S <= T).
  const int q_first = CAUSAL ? max(0, k0 - shift) / kBC : 0;
  const int per_head = (S + kBC - 1) / kBC - q_first;
  const int steps = (g_end - g_begin) * per_head;

  // Step i's Q and dO tiles, lse and D of its 64 query rows into stage st.
  auto stage = [&](int i, int st) {
    const int h = kvh * G + g_begin + i / per_head;
    const int q0 = (q_first + i % per_head) * kBC;
    const long q_off = static_cast<long>(b) * S * q_row + static_cast<long>(h) * HD;
    const long row_off = (static_cast<long>(b) * H + h) * S;
    load_tile<HD, kBC>(qs + st * kBC * HD, q + q_off, q_row, q0, S);
    load_tile<HD, kBC>(dos + st * kBC * HD, dout + q_off, q_row, q0, S);
    const int c = threadIdx.x % kBC;  // 2 * kBC threads: lse, then D
    const bool ok = q0 + c < S;
    const float* src = (threadIdx.x < kBC ? lse : dvec) + row_off + (ok ? q0 + c : 0);
    cp_async4(smem_u32((threadIdx.x < kBC ? lsh : dsh) + st * kBC + c), src, ok ? 4 : 0);
  };
  static_assert(kThreads == 2 * kBC, "one lse or D value a thread");

  load_tile<HD, kBR>(ks, k + kv_off, kv_row, k0, T_);
  load_tile<HD, kBR>(vs, v + kv_off, kv_row, k0, T_);
  stage(0, 0);
  cp_async_commit();

  float dka[NA], dva[NA];  // rows kpos0, kpos1; columns 8j + 2t, + 1
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) stage(i + 1, st ^ 1);  // released by the barrier that ended i - 1
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int q0 = (q_first + i % per_head) * kBC;
    const uint32_t q_addr = smem_u32(qs + st * kBC * HD);
    const uint32_t do_addr = smem_u32(dos + st * kBC * HD);
    const float* ls = lsh + st * kBC;
    const float* ds = dsh + st * kBC;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query columns each; a
    // thread holds keys kpos0 (x[4j], x[4j + 1]) and kpos1 (x[4j + 2],
    // x[4j + 3]), queries q0 + 8j + 2t, + 1.
    float sT[32], dpT[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sT, smem_desc(k_addr + (kk >> 2) * kBR * 128 + (kk & 3) * 32, 16, 1024),
                   smem_desc(q_addr + (kk >> 2) * kBC * 128 + (kk & 3) * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dpT, smem_desc(v_addr + (kk >> 2) * kBR * 128 + (kk & 3) * 32, 16, 1024),
                   smem_desc(do_addr + (kk >> 2) * kBC * 128 + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit_and_wait();
    fence_regs(sT);
    fence_regs(dpT);

    // P^T and dS^T = P^T o (dP^T - D), P = 0 where the forward masked, split
    // hi + lo into the A operands of dV += P^T dO and dK += dS^T Q, 16 query
    // columns at a time (the A fragment of columns 16kk.. is accumulator
    // tiles 2kk and 2kk + 1: elements 8kk + x, columns c0 + 8 (x >> 2) +
    // (x & 1)), so only one step's lse and D are live.
    const bool masked = wk + 16 > T_ || q0 + kBC > S || (CAUSAL && wk + 15 - shift > q0);
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = 16 * kk + 2 * t;
      const float2 la = *reinterpret_cast<const float2*>(ls + c0);
      const float2 lb = *reinterpret_cast<const float2*>(ls + c0 + 8);
      const float2 da = *reinterpret_cast<const float2*>(ds + c0);
      const float2 db = *reinterpret_cast<const float2*>(ds + c0 + 8);
      float pk[8], dsk[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int e = 8 * kk + x;
        const float2 lc = (x & 4) ? lb : la, dc = (x & 4) ? db : da;
        float p = expf(sT[e] * scale - ((x & 1) ? lc.y : lc.x));
        if (masked) {
          const int kpos = (x & 2) ? kpos1 : kpos0;
          const int qpos = q0 + c0 + 8 * (x >> 2) + (x & 1);
          if (kpos >= T_ || qpos >= S || (CAUSAL && kpos - shift > qpos)) p = 0.f;
        }
        pk[x] = p;
        dsk[x] = p * (dpT[e] - ((x & 1) ? dc.y : dc.x));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 4 * (r >> 1) + 2 * (r & 1);
        split_bf16(pk[x], pk[x + 1], phi[kk][r], plo[kk][r]);
        split_bf16(dsk[x], dsk[x + 1], dhi[kk][r], dlo[kk][r]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 query rows: two 8-row atoms of dO and Q
      const uint64_t bdo = smem_desc(do_addr + kk * 2048, kBC * 128, 1024);
      const uint64_t bq = smem_desc(q_addr + kk * 2048, kBC * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128(dva, phi[kk], bdo, 1);
        wgmma_rs_n128(dva, plo[kk], bdo, 1);
        wgmma_rs_n128(dka, dhi[kk], bq, 1);
        wgmma_rs_n128(dka, dlo[kk], bq, 1);
      } else {
        wgmma_rs_n64(dva, phi[kk], bdo, 1);
        wgmma_rs_n64(dva, plo[kk], bdo, 1);
        wgmma_rs_n64(dka, dhi[kk], bq, 1);
        wgmma_rs_n64(dka, dlo[kk], bq, 1);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();  // this stage is free for the prefetch two steps on
  }

  if (splits == 1) {
    bf16* dkh = dk + kv_off + 2 * t;
    bf16* dvh = dv + kv_off + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (kpos0 < T_) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + kpos0 * kv_row + 8 * j) =
            __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvh + kpos0 * kv_row + 8 * j) =
            __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
      }
      if (kpos1 < T_) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + kpos1 * kv_row + 8 * j) =
            __floats2bfloat162_rn(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvh + kpos1 * kv_row + 8 * j) =
            __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  } else {
    const long n = static_cast<long>(gridDim.y) * T_ * kv_row;  // one gradient's elements
    float* pk = partial + sp * n + kv_off + 2 * t;
    float* pv = partial + (splits + sp) * n + kv_off + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (kpos0 < T_) {
        *reinterpret_cast<float2*>(pk + kpos0 * kv_row + 8 * j) =
            make_float2(dka[4 * j], dka[4 * j + 1]);
        *reinterpret_cast<float2*>(pv + kpos0 * kv_row + 8 * j) =
            make_float2(dva[4 * j], dva[4 * j + 1]);
      }
      if (kpos1 < T_) {
        *reinterpret_cast<float2*>(pk + kpos1 * kv_row + 8 * j) =
            make_float2(dka[4 * j + 2], dka[4 * j + 3]);
        *reinterpret_cast<float2*>(pv + kpos1 * kv_row + 8 * j) =
            make_float2(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// dk = bf16(scale * sum of the splits' dK partials), dv = bf16(sum of the
// dV partials), each sum from split 0 up: a fixed order. n (one gradient's
// elements) is a multiple of 4 (hd is 64 or 128).
__global__ void flash_bwd_tc_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, long n, int splits, float scale) {
  for (long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x * 4) {
    float4 a = *reinterpret_cast<const float4*>(partial + i);
    float4 c = *reinterpret_cast<const float4*>(partial + splits * n + i);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(partial + s * n + i);
      const float4 y = *reinterpret_cast<const float4*>(partial + (splits + s) * n + i);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
    __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
    k2[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    k2[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
    v2[0] = __floats2bfloat162_rn(c.x, c.y);
    v2[1] = __floats2bfloat162_rn(c.z, c.w);
  }
}

template <int HD, bool CAUSAL>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_dq_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.B, (a.S + kBR - 1) / kBR);  // q blocks slowest: longest first
  flash_bwd_tc_dq_kernel<HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse, a.dvec,
      static_cast<bf16*>(a.dq), a.S, a.T, a.H, a.KV, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool CAUSAL>
int launch_dkdv(const Args& a, float* partial, int splits, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_tc_dkdv_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.KV * splits, a.B, (a.T + kBR - 1) / kBR);  // key blocks slowest
  flash_bwd_tc_dkdv_kernel<HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.dvec, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), partial, a.S, a.T, a.H, a.KV, splits, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long n = static_cast<long>(a.B) * a.T * a.KV * HD;
  const int threads = 256;
  const long need = (n / 4 + threads - 1) / threads;
  const long blocks = need < 132L * 16 ? need : 132L * 16;  // a grid-stride loop past that
  flash_bwd_tc_sum_kernel<<<static_cast<int>(blocks), threads, 0, stream>>>(
      partial, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n, splits, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = the dQ kernel, 1 = the dK/dV kernel (and the sum of its splits).
int run(int device, int which, const Args& a, int causal, float* partial, int splits,
        void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.B == 0 || a.S == 0 || a.T == 0 || a.H == 0) return 0;
  const int G = a.KV > 0 ? a.H / a.KV : 0;
  if ((a.hd != 64 && a.hd != 128) || (which && (splits < 1 || splits > G ||
                                                (splits > 1 && partial == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (which == 0) {
    if (a.hd == 64) return causal ? launch_dq<64, true>(a, stream) : launch_dq<64, false>(a, stream);
    return causal ? launch_dq<128, true>(a, stream) : launch_dq<128, false>(a, stream);
  }
  if (a.hd == 64)
    return causal ? launch_dkdv<64, true>(a, partial, splits, stream)
                  : launch_dkdv<64, false>(a, partial, splits, stream);
  return causal ? launch_dkdv<128, true>(a, partial, splits, stream)
                : launch_dkdv<128, false>(a, partial, splits, stream);
}

}  // namespace tc
}  // namespace

// q, o, dout, dq: [B, S, H, hd]; k, v, dk, dv: [B, T, KV, hd], contiguous,
// all of one dtype (bf16 = 1, else f32); lse and dvec f32 [B, H, S], lse
// from the forward (flash_attention.cu's lse output). causal = 1 masks the
// causal triangle, 0 nothing; scale = 1 / sqrt(hd) rounded to f32, as the
// forward's. The wrapper checks the shapes (S, T >= 1; causal: S <= T;
// H % KV == 0; hd <= 128).
//
// The dQ kernel: writes dq and D = rowsum(dout o o) into dvec.
extern "C" int ample_flash_attention_bwd_dq(int device, const void* q, const void* k,
                                            const void* v, const void* o, const void* dout,
                                            const float* lse, float* dvec, void* dq, int bf16,
                                            int B, int S, int T, int H, int KV, int hd,
                                            int causal, float scale, void* stream_ptr) {
  return run(device, 0, q, k, v, o, dout, lse, dvec, dq, nullptr, nullptr, bf16, B, S, T, H, KV,
             hd, causal, scale, stream_ptr);
}

// The dK/dV kernel: reads the dvec the dQ kernel wrote (launch it after,
// on the same stream); writes dk and dv.
extern "C" int ample_flash_attention_bwd_dkdv(int device, const void* q, const void* k,
                                              const void* v, const void* dout, const float* lse,
                                              const float* dvec, void* dk, void* dv, int bf16,
                                              int B, int S, int T, int H, int KV, int hd,
                                              int causal, float scale, void* stream_ptr) {
  return run(device, 1, q, k, v, nullptr, dout, lse, const_cast<float*>(dvec), nullptr, dk, dv,
             bf16, B, S, T, H, KV, hd, causal, scale, stream_ptr);
}


// The tensor-core variant (bf16 only; hd 64 or 128; every base 16-byte
// aligned, which the wrapper checks; cudaErrorInvalidValue for another head
// dim), same arguments and order of launch as above.
//
// Its dQ kernel: writes dq and D into dvec.
extern "C" int ample_flash_attention_bwd_tc_dq(int device, const void* q, const void* k,
                                               const void* v, const void* o, const void* dout,
                                               const float* lse, float* dvec, void* dq, int B,
                                               int S, int T, int H, int KV, int hd, int causal,
                                               float scale, void* stream_ptr) {
  const Args a{q, k, v, o, dout, lse, dvec, dq, nullptr, nullptr, B, S, T, H, KV, hd, scale};
  return tc::run(device, 0, a, causal, nullptr, 1, stream_ptr);
}

// Its dK/dV kernel: splits (1 <= splits <= H / KV) blocks share each
// (kv-head, batch, 64 keys), each over its own run of the G q-heads; with
// splits > 1 they write f32 partial sums into partial [2, splits, B, T, KV,
// hd] (the caller's scratch) and a second kernel adds them into dk and dv in
// split order.
extern "C" int ample_flash_attention_bwd_tc_dkdv(int device, const void* q, const void* k,
                                                 const void* v, const void* dout,
                                                 const float* lse, const float* dvec, void* dk,
                                                 void* dv, float* partial, int splits, int B,
                                                 int S, int T, int H, int KV, int hd, int causal,
                                                 float scale, void* stream_ptr) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<float*>(dvec), nullptr, dk, dv,
               B, S, T, H, KV, hd, scale};
  return tc::run(device, 1, a, causal, partial, splits, stream_ptr);
}
