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
// 168 MB of q, k, v and out, ~800 flops per byte: the bf16 tensor cores (989
// TFLOP/s) bound it, not the 3.35 TB/s of device memory.
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
//    and sum are reduced over the quad of threads that hold it.
// 2. CUDA cores (flash_kernel): f32 inputs (the REDUCED configs, the ragged
//    f32 case) and bf16 with another head dim. Everything in f32 (bf16
//    widened as it is staged: every product exact); one block of 256
//    threads per (64 query rows, q-head, batch); the block walks the KV
//    blocks of 64 keys in order (the TPU's reduction grid axis becomes a
//    loop), staging Q once and K, then V, through one shared tile. Each
//    thread owns 4 query rows x 4 keys of the score tile and 4 rows x HD/16
//    output columns; a row's max and sum are reduced over the 16 threads
//    that share it with warp shuffles.
// Both run the longest query blocks first (the last rows see the most keys),
// so the tail of the grid is short, and neither splits KV or uses atomics:
// the output is bitwise the same from run to run.
//
// Skipped KV blocks. The TPU kernel visits every KV block and masks with a
// finite -1e30. Both kernels visit only the blocks that hold a key some row
// of the query block can see; every other block is masked for every row, and
// would add exp(-1e30 - m) = 0 to l and the accumulator without moving m, as
// long as m is a real score. It is: the wrapper requires S <= T, so every
// query row sees key 0, which lies in block 0, the first block visited, and
// m is a real score from the first block on. Masked entries inside a visited
// block are -inf here, so they give p = exp(-inf) = 0 exactly, as -1e30 does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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


// ------------------------------------------------ tensor-core variant (bf16)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // one warpgroup; two blocks per SM run side by side
constexpr int kBQ = 64;        // query rows per block: wgmma's M
constexpr int kBK = 64;        // keys per KV block

// Tiles live in shared memory as [hd / 64][rows][64] bf16: rows of 128 bytes
// whose 16-byte chunks are XOR-swizzled by row % 8, in 1024-byte atoms of 8
// rows. That is wgmma's 128-byte swizzle, which its descriptors name; the
// 8 rows a 16-byte column spans hit 8 different bank groups.
template <int ROWS>
__device__ __forceinline__ int tile_offset(int r, int col) {
  return (col >> 6) * ROWS * 64 + r * 64 + ((((col >> 3) & 7) ^ (r & 7)) << 3);
}

template <int HD>
constexpr int smem_bytes() {
  return (kBQ + 4 * kBK) * HD * 2 + 1024;  // Q, K and V in two stages each; 1024-byte alignment
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A wgmma operand in shared memory: 128-byte swizzle, byte offsets lbo
// (between 64-column blocks of an MN-major operand) and sbo (between 8-row
// atoms).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma accumulators across
// the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64x64 f32) = or += a (64x16, K-major smem) * b (16x64, K-major smem).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64x64 f32) = or += a (64x16 bf16 registers) * b (16x64, MN-major smem).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64x128 f32) = or += a (64x16 bf16 registers) * b (16x128, MN-major smem).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Split the f32 pair (x0, x1) into bf16 pairs hi + lo (x0 in the low half).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));  // both differences exact
}

// Rows [r0, r0 + ROWS) of one head (row stride `row` elements) into a
// swizzled tile; rows at or past `rows` are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ x, long row,
                                          int r0, int rows) {
  constexpr int CH = HD / 8;
  static_assert((ROWS * CH) % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < ROWS * CH / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / CH, c = idx % CH;
    const int pos = r0 + r;
    const bool ok = pos < rows;
    cp_async16(smem_u32(dst + tile_offset<ROWS>(r, 8 * c)), x + (ok ? pos : 0) * row + c * 8,
               ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int S, int T_, int H, int KV, float scale) {
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

  // The last key any row of this block sees (>= 0 since S <= T).
  const int last_key = min(T_ - 1, q0 + kBQ - 1 + shift);
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
    const bool masked = k0 + kBK - 1 - shift > wq || k0 + kBK > T_;
    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (masked) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= T_ || kpos - shift > qpos) x = neg_inf();
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

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
           int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);  // q blocks slowest: longest first over the card
  flash_tc_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, T_, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
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


// The tensor-core variant: bf16 q, k, v, o as above, hd 64 or 128, every base
// 16-byte aligned (the wrapper checks; cudaErrorInvalidValue otherwise).
extern "C" int ample_flash_attention_tc(int device, const void* q, const void* k,
                                        const void* v, void* o, int B, int S, int T, int H,
                                        int KV, int hd, float scale, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return 0;
  if (hd == 64) return tc::launch<64>(q, k, v, o, B, S, T, H, KV, scale, stream);
  if (hd == 128) return tc::launch<128>(q, k, v, o, B, S, T, H, KV, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
