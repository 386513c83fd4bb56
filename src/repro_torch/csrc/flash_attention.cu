// GQA flash attention for Hopper: causal (the prefill of every decoder
// self-attention layer) or unmasked (an encoder's self-attention and
// cross-attention over an encoder's output, in prefill and in decode).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_call
// (_kernel), with its wrapper repro/kernels/flash_attention/ops.py.
//
// Computes, for q [B, S, H, hd] and k, v [B, T, KV, hd] (f32 or bf16, the
// layout the model projects them in, so no transposes):
//   s = (q . k) / sqrt(hd) in f32, masked where kpos >= T and, in the causal
//   variant, where kpos - (T - S) > qpos (aligned to the ends of both
//   sequences; the TPU kernel's causal=True branch; causal=False masks only
//   the padding past T, as the TPU kernel does);
//   out = softmax(s) . v, through an online softmax with f32 m, l and
//   accumulator, written as acc / max(l, 1e-30) in q's dtype.
// q-head h reads kv-head h / (H / KV) (q's heads are grouped kv-major, as the
// model reshapes them), so K/V are never repeated in memory. Scores and the
// probabilities p stay in f32 for P.V, as in the TPU kernel: a bf16 input is
// widened to f32 when it is staged, so every product is exact and only the
// order of the sums differs from the plain version.
//
// What bounds it on an H100: operations at prefill lengths. At the Qwen3-8B
// prefill (B 4, S = T = 2048, H 32, KV 8, hd 128) the causal half is 137
// GFLOP against 168 MB of q, k, v and out, ~800 flops per byte: the bf16
// tensor cores (989 TFLOP/s) bound it, not the 3.35 TB/s of device memory.
// The unmasked calls of an enc-dec decode step (S = 1 against T = 1024
// encoder keys) are the other way round: each key is read for one query row,
// so bytes bound them.
//
// Two variants, one function. The wrapper (kernels/flash_attention/ops.py,
// flash_variant) picks one from the dtype, head dim and alignment; it never
// falls back.
//
// 1. Tensor cores (flash_tc_kernel): bf16 inputs with hd 64 or 128, the
//    served LMs. S = Q.K^T runs on wgmma (m64n64k16, bf16 in, f32
//    accumulation, both operands from shared memory): each bf16 product is
//    exact in f32, only the order of the sums changes. P.V keeps p in f32 as
//    the TPU kernel does, by splitting it into two bf16 terms, p_hi = bf16(p)
//    and p_lo = bf16(p - p_hi), each the register A operand of a wgmma
//    (m64n{hd}k16) against the same V tile: p_hi + p_lo is p within ~2^-17
//    relative, far below the 2^-9 of the bf16 output's own rounding, where a
//    single bf16 p would err by up to 2^-9. Each KV block's P.V starts from
//    zero and is folded into the output with one f32 fma (o = o * corr +
//    pv), so the tensor cores' own rounding of the sum never spans more than
//    one block. m, l and the rescaling stay f32. Design: one block of one
//    warpgroup per (64 query rows, q-head, batch), two blocks per SM
//    (S, P.V and the output accumulator in registers, in wgmma's accumulator
//    layout, which is also its register A layout, so p goes from S's
//    registers to P.V's operand without moving); Q staged once and K and V
//    tiles of 64 keys through a two-stage ring in shared memory, filled by
//    cp.async (zero past T) in wgmma's 128-byte swizzle, so the descriptors
//    read them in place (V as an MN-major operand, no transpose); a row's max
//    and sum are reduced over the quad of threads that hold it. Its wgmma,
//    cp.async and swizzle helpers are wgmma_tiles.cuh, which the backward's
//    tensor-core kernels share.
// 2. CUDA cores (flash_kernel): f32 inputs (the REDUCED configs, the ragged
//    f32 case) and bf16 with another head dim. Everything in f32 (bf16
//    widened as it is staged: every product exact); one block of 256
//    threads per (64 query rows, q-head, batch); the block walks the KV
//    blocks of 64 keys in order (the TPU's reduction grid axis becomes a
//    loop), staging Q once and K, then V, through one shared tile. Each
//    thread owns 4 query rows x 4 keys of the score tile and 4 rows x HD/16
//    output columns; a row's max and sum are reduced over the 16 threads
//    that share it with warp shuffles.
// Training: both also write, where the wrapper passes a non-null lse [B, H, S]
// f32, each row's natural-log log-sum-exp of its scaled, masked scores,
// m + log(l) from the online softmax's own f32 max and sum (expf and logf,
// natural logs throughout), for the backward (flash_attention_bwd.cu). The
// serving paths pass null and write nothing more.
//
// Both run the longest query blocks first (the last rows see the most keys),
// so the tail of the grid is short, and neither splits KV or uses atomics:
// the output is bitwise the same from run to run.
//
// Skipped KV blocks. The TPU kernel visits every KV block and masks with a
// finite -1e30. Both kernels visit only the blocks that hold a key some row
// of the query block can see (all ceil(T / 64) blocks when unmasked); every
// other block is masked for every row, and would add exp(-1e30 - m) = 0 to l
// and the accumulator without moving m, as long as m is a real score. It is:
// every query row sees key 0 (causal: the wrapper requires S <= T; unmasked:
// T >= 1), which lies in block 0, the first block visited, so m is a real
// score from the first block on. Masked entries inside a visited block (the
// causal triangle, and the padding of a ragged last block past T in both
// variants) are -inf here, so they give p = exp(-inf) = 0 exactly, as -1e30
// does. CAUSAL is a template parameter, so the causal kernels are the code
// they were before the unmasked branch existed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV block
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys / columns
constexpr int kLDP = kBK + 4;  // row stride of the p tile (conflict-free reads)

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

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Reduce over the 16 threads of a half warp (they share query rows).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows [r0, r0 + 64) of one head of x (row stride `row`, hd columns)
// into dst [64][HD + 1] as f32; rows at or past `rows` and columns at or past
// hd are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x, long row, int r0,
                                      int rows, int hd) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int pos = r0 + r;
    dst[r * LD + d] = (pos < rows && d < hd) ? to_f32(x[pos * row + d]) : 0.f;
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * (HD + 1) + kBK * (HD + 1) + kBQ * kLDP) * 4;
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int T_, int H, int KV, int hd,
    float scale) {
  constexpr int LD = HD + 1;  // odd stride: the 16 keys of a half warp hit 16 banks
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD]
  float* kvs = qs + kBQ * LD;   // [kBK][LD]: the K block, then the V block
  float* ps = kvs + kBK * LD;   // [kBQ][kLDP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_row = static_cast<long>(H) * hd;
  const long kv_row = static_cast<long>(KV) * hd;
  const T* qh = q + static_cast<long>(b) * S * q_row + static_cast<long>(h) * hd;
  const T* kh = k + static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * hd;
  const T* vh = v + static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * hd;
  const int shift = T_ - S;  // key kpos is visible to query qpos iff kpos - shift <= qpos

  stage<T, HD>(qs, qh, q_row, q0, S, hd);

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // The last key any row of this block sees (causal: >= 0 since S <= T).
  const int last_key = CAUSAL ? min(T_ - 1, q0 + kBQ - 1 + shift) : T_ - 1;
  const int nkb = last_key / kBK + 1;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous V block (and at kb = 0 nothing) is consumed
    stage<T, HD>(kvs, kh, kv_row, k0, T_, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {  // columns past hd are 0 in both tiles
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool seen = kpos < T_ && (!CAUSAL || kpos - shift <= qpos);
        s[i][j] = seen ? s[i][j] * scale : neg_inf();
        mx = fmaxf(mx, s[i][j]);
      }
      // Finite from block 0 on (every row sees key 0; see the header).
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);  // block 0: exp(-inf) = 0
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the K block is consumed, p is written
    stage<T, HD>(kvs, vh, kv_row, k0, T_, hd);
    __syncthreads();

    const int nk = min(kBK, T_ - k0);  // keys past T have p = 0 and v = 0
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = kvs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * kLDP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  if (lse != nullptr && tx == 0) {  // l and m are whole-row values in all 16 threads
    float* lh = lse + (static_cast<long>(b) * H + h) * S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      if (qpos < S) lh[qpos] = m[i] + logf(l[i]);
    }
  }
  T* oh = o + static_cast<long>(b) * S * q_row + static_cast<long>(h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) oh[qpos * q_row + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int T_, int H, int KV, int hd, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, T_, H, KV, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CAUSAL>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int T_, int H, int KV, int hd, float scale, cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32, CAUSAL>(q, k, v, o, lse, B, S, T_, H, KV, hd, scale, stream);
  if (hd <= 64) return launch<T, 64, CAUSAL>(q, k, v, o, lse, B, S, T_, H, KV, hd, scale, stream);
  return launch<T, 128, CAUSAL>(q, k, v, o, lse, B, S, T_, H, KV, hd, scale, stream);
}

template <typename T>
int dispatch_mask(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int S, int T_, int H, int KV, int hd, int causal, float scale,
                  cudaStream_t stream) {
  if (causal) return dispatch_hd<T, true>(q, k, v, o, lse, B, S, T_, H, KV, hd, scale, stream);
  return dispatch_hd<T, false>(q, k, v, o, lse, B, S, T_, H, KV, hd, scale, stream);
}


// ------------------------------------------------ tensor-core variant (bf16)
namespace tc {

constexpr int kBQ = 64;        // query rows per block: wgmma's M
constexpr int kBK = 64;        // keys per KV block

template <int HD>
constexpr int smem_bytes() {
  return (kBQ + 4 * kBK) * HD * 2 + 1024;  // Q, K and V in two stages each; 1024-byte alignment
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int S, int T_, int H, int KV, float scale) {
  constexpr int KS = HD / 16;  // 16-wide k steps of Q.K^T
  constexpr int NA = HD / 2;   // output accumulators per thread (64 rows x HD over 128 threads)
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* ks = qs + kBQ * HD;      // [2][hd / 64][kBK][64]
  bf16* vs = ks + 2 * kBK * HD;  // [2][hd / 64][kBK][64]

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const long q_row = static_cast<long>(H) * HD;
  const long kv_row = static_cast<long>(KV) * HD;
  const bf16* qh = q + static_cast<long>(b) * S * q_row + static_cast<long>(h) * HD;
  const bf16* kh = k + static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * HD;
  const bf16* vh = v + static_cast<long>(b) * T_ * kv_row + static_cast<long>(kvh) * HD;
  const int shift = T_ - S;  // key kpos is visible to query qpos iff kpos - shift <= qpos
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // accumulator row and column pair
  const int wq = q0 + warp * 16;          // this warp's first query row
  const int qpos0 = wq + g, qpos1 = qpos0 + 8;

  // The last key any row of this block sees (causal: >= 0 since S <= T).
  const int last_key = CAUSAL ? min(T_ - 1, q0 + kBQ - 1 + shift) : T_ - 1;
  const int nkb = last_key / kBK + 1;

  load_tile<HD, kBQ>(qs, qh, q_row, q0, S);
  load_tile<HD, kBK>(ks, kh, kv_row, 0, T_);
  load_tile<HD, kBK>(vs, vh, kv_row, 0, T_);
  cp_async_commit();

  float acc[NA];
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};  // rows qpos0, qpos1; l per thread
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(qs);

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nkb) {  // the other stage was released by the barrier that ended kb - 1
      load_tile<HD, kBK>(ks + (st ^ 1) * kBK * HD, kh, kv_row, (kb + 1) * kBK, T_);
      load_tile<HD, kBK>(vs + (st ^ 1) * kBK * HD, vh, kv_row, (kb + 1) * kBK, T_);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... and is seen by wgmma
    __syncthreads();
    const uint32_t k_addr = smem_u32(ks + st * kBK * HD);
    const uint32_t v_addr = smem_u32(vs + st * kBK * HD);

    // S = Q K^T: 64 rows x 64 keys; a thread holds rows qpos0
    // (s[4j], s[4j + 1]) and qpos1 (s[4j + 2], s[4j + 3]), keys 8j + 2t, + 1.
    float s[32];  // no zeroing: the first wgmma of each product overwrites (scale_d = 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)  // a 16-column step: 32 bytes into a 128-byte row
      wgmma_ss_n64(s, smem_desc(q_addr + (kk >> 2) * kBQ * 128 + (kk & 3) * 32, 16, 1024),
                   smem_desc(k_addr + (kk >> 2) * kBK * 128 + (kk & 3) * 32, 16, 1024),
                   kk > 0);
    wgmma_commit_and_wait();
    fence_regs(s);

    // Scale, mask, online softmax.
    const int k0 = kb * kBK;
    const bool masked = k0 + kBK > T_ || (CAUSAL && k0 + kBK - 1 - shift > wq);
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (masked) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= T_ || (CAUSAL && kpos - shift > qpos)) x = neg_inf();
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Finite from block 0 on (every row sees key 0; see the header).
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float corr0 = expf(m[0] - mn0), corr1 = expf(m[1] - mn1);  // block 0: exp(-inf) = 0
    m[0] = mn0;
    m[1] = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(s[i] - ((i & 2) ? mn1 : mn0));
      s[i] = p;
      if (i & 2) rs1 += p; else rs0 += p;
    }
    l[0] = l[0] * corr0 + rs0;
    l[1] = l[1] * corr1 + rs1;

    // P.V for this block from zero, p = p_hi + p_lo against the same V tile.
    // The A fragment of keys 16kk.. is accumulator tiles 2kk and 2kk + 1.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 4 * (r >> 1) + 2 * (r & 1);
        split_bf16(s[i], s[i + 1], hi[kk][r], lo[kk][r]);
      }
    }
    float pv[NA];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys: two 8-row atoms of V
      const uint64_t dv = smem_desc(v_addr + kk * 2048, kBK * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128(pv, hi[kk], dv, kk > 0);
        wgmma_rs_n128(pv, lo[kk], dv, 1);
      } else {
        wgmma_rs_n64(pv, hi[kk], dv, kk > 0);
        wgmma_rs_n64(pv, lo[kk], dv, 1);
      }
    }
    wgmma_commit_and_wait();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = fmaf(acc[i], (i & 2) ? corr1 : corr0, pv[i]);
    __syncthreads();  // this stage is free for the prefetch two blocks on
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  if (lse != nullptr && t == 0) {  // m is the row's max in all four threads of the quad
    float* lh = lse + (static_cast<long>(b) * H + h) * S;
    if (qpos0 < S) lh[qpos0] = m[0] + logf(l[0]);
    if (qpos1 < S) lh[qpos1] = m[1] + logf(l[1]);
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
  bf16* oh = o + static_cast<long>(b) * S * q_row + static_cast<long>(h) * HD + 2 * t;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (qpos0 < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + qpos0 * q_row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (qpos1 < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + qpos1 * q_row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
}

template <int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int T_, int H, int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);  // q blocks slowest: longest first over the card
  flash_tc_kernel<HD, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, T_, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// q, o: [B, S, H, hd]; k, v: [B, T, KV, hd], contiguous, all of one dtype
// (bf16 = 1, else f32); causal = 1 masks the causal triangle, 0 nothing;
// scale = 1 / sqrt(hd), rounded to f32 by the caller as the plain version
// rounds it; lse: null, or f32 [B, H, S] for the rows' log-sum-exp (training).
// The wrapper checks S, T >= 1 (causal: S <= T), H % KV == 0 and hd <= 128.
extern "C" int ample_flash_attention(int device, const void* q, const void* k,
                                     const void* v, void* o, float* lse, int bf16, int B,
                                     int S, int T, int H, int KV, int hd, int causal,
                                     float scale, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (bf16)
    return dispatch_mask<__nv_bfloat16>(q, k, v, o, lse, B, S, T, H, KV, hd, causal, scale,
                                        stream);
  return dispatch_mask<float>(q, k, v, o, lse, B, S, T, H, KV, hd, causal, scale, stream);
}


// The tensor-core variant: bf16 q, k, v, o as above, hd 64 or 128, every base
// 16-byte aligned (the wrapper checks; cudaErrorInvalidValue otherwise); lse
// as above.
extern "C" int ample_flash_attention_tc(int device, const void* q, const void* k,
                                        const void* v, void* o, float* lse, int B, int S,
                                        int T, int H, int KV, int hd, int causal, float scale,
                                        void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (hd == 64 && causal)
    return tc::launch<64, true>(q, k, v, o, lse, B, S, T, H, KV, scale, stream);
  if (hd == 64) return tc::launch<64, false>(q, k, v, o, lse, B, S, T, H, KV, scale, stream);
  if (hd == 128 && causal)
    return tc::launch<128, true>(q, k, v, o, lse, B, S, T, H, KV, scale, stream);
  if (hd == 128) return tc::launch<128, false>(q, k, v, o, lse, B, S, T, H, KV, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
