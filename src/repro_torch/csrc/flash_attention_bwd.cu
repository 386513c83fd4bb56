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
// Inputs f32 or bf16 (widened as they are staged, so every product is exact
// in f32), hd <= 128, q/o/dO [B, S, H, hd], k/v [B, T, KV, hd], lse f32
// [B, H, S]; dq, dk, dv in q's dtype.
//
// Two kernels, launched in this order on one stream:
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
// 2.5 times the forward's 51.6 GFLOP against ~118 MB of q, k, v, o, dO, lse
// and the three gradients. This first version runs on the CUDA cores in f32 (the
// tiles of the forward's CUDA-core kernel: 256 threads, each 4 rows x 4 keys
// of a score tile and 4 rows x hd / 16 columns of an accumulator; odd row
// strides in shared memory so the 16 threads that read one column hit 16
// banks); kernel 1 recomputes S and dP, which kernel 2 also computes, so it
// does 3.5 of the forward's products. A wgmma / TMA version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
