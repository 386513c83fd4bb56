// Causal GQA flash attention for Hopper (the prefill of every attention layer).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/flash_attention.py::flash_attention_call
// (_kernel), with its wrapper repro/kernels/flash_attention/ops.py.
//
// Computes, for q [B, S, H, hd] and k, v [B, T, KV, hd] (f32 or bf16, the
// layout the model projects them in, so no transposes):
//   s = (q . k) / sqrt(hd) in f32, masked where kpos - (T - S) > qpos (causal,
//   aligned to the ends of both sequences) or kpos >= T;
//   out = softmax(s) . v, through an online softmax with f32 m, l and
//   accumulator, written as acc / max(l, 1e-30) in q's dtype.
// q-head h reads kv-head h / (H / KV) (q's heads are grouped kv-major, as the
// model reshapes them), so K/V are never repeated in memory. Scores and the
// probabilities p stay in f32 for P.V, as in the TPU kernel: a bf16 input is
// widened to f32 when it is staged, so every product is exact and only the
// order of the sums differs from the plain version.
//
// What bounds it on an H100: operations. At the Qwen3-8B prefill (B 4,
// S = T = 2048, H 32, KV 8, hd 128) the causal half is 137 GFLOP against
// 168 MB of q, k, v and out, ~800 flops per byte. This first kernel keeps
// everything in f32 on the CUDA cores (67 TFLOP/s peak), not on the tensor
// cores (989 TFLOP/s bf16): P.V needs f32 p. mma/wgmma on Q.K^T (exact for
// bf16 inputs), a split of p into bf16 terms, and TMA staging are later work.
//
// Design: one block of 256 threads per (64 query rows, q-head, batch); the
// block walks the KV blocks of 64 keys in order (the TPU's reduction grid
// axis becomes a loop), staging Q once and K, then V, through one shared
// tile in f32. Each thread owns 4 query rows x 4 keys of the score tile and
// 4 rows x HD/16 output columns; a row's max and sum are reduced over the
// 16 threads that share it with warp shuffles. Query blocks run longest
// first (the last rows see the most keys), so the tail of the grid is short.
//
// Skipped KV blocks. The TPU kernel visits every KV block and masks with a
// finite -1e30. This kernel visits only the blocks that hold a key some row
// of the query block can see; every other block is masked for every row, and
// would add exp(-1e30 - m) = 0 to l and the accumulator without moving m, as
// long as m is a real score. It is: the wrapper requires S <= T, so every
// query row sees key 0, which lies in block 0, the first block visited, and
// m is a real score from the first block on. Masked entries inside a visited
// block are -inf here, so they give p = exp(-inf) = 0 exactly, as -1e30 does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int T_, int H, int KV, int hd, float scale) {
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

  // The last key any row of this block sees (>= 0 since S <= T).
  const int last_key = min(T_ - 1, q0 + kBQ - 1 + shift);
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
        const bool seen = kpos < T_ && kpos - shift <= qpos;
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_,
           int H, int KV, int hd, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_, H, KV, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int T_,
                int H, int KV, int hd, float scale, cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32>(q, k, v, o, B, S, T_, H, KV, hd, scale, stream);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, B, S, T_, H, KV, hd, scale, stream);
  return launch<T, 128>(q, k, v, o, B, S, T_, H, KV, hd, scale, stream);
}

}  // namespace

// q, o: [B, S, H, hd]; k, v: [B, T, KV, hd], contiguous, all of one dtype
// (bf16 = 1, else f32); scale = 1 / sqrt(hd), rounded to f32 by the caller as
// the plain version rounds it. The wrapper checks 1 <= S <= T, H % KV == 0
// and hd <= 128.
extern "C" int ample_flash_attention(int device, const void* q, const void* k,
                                     const void* v, void* o, int bf16, int B, int S,
                                     int T, int H, int KV, int hd, float scale,
                                     void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (bf16) return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, hd, scale, stream);
  return dispatch_hd<float>(q, k, v, o, B, S, T, H, KV, hd, scale, stream);
}
