// Mamba2 SSD intra-chunk term for Hopper (the y_diag of every Mamba2 layer).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd_scan/ssd_scan.py::ssd_intra_chunk_call (_kernel),
// whose oracle is repro/kernels/ssd_scan/ref.py.
//
// Computes, per batch b, chunk c and head h,
//   Y[b,c,h] = ((C B^T) o L) @ Xdt,   L[i,j] = exp(a_i - a_j) [i >= j],
// for cc, bc f32 [B, NC, Q, N] (one B/C group shared by the heads), xdt f32
// [B, NC, H, Q, P] (dt folded in), acum f32 [B, NC, H, Q] (the cumulative
// log-decay a) and out f32 [B, NC, H, Q, P].
//
// What bounds it on an H100: device-memory bytes. At the Mamba2-370M prefill
// (B 4, NC 8, Q 256, N 128, H 32, P 64) the lower triangle needs 4.6 GFLOP
// against 143.6 MB of inputs and output; the three TF32 products below are
// 13.8 GFLOP, 0.028 ms at the dense TF32 peak, against 0.043 ms for the bytes.
//
// Numbers: the function stays f32. Each f32 operand x is split into two TF32
// terms, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and every product is
// three TF32 tensor-core products with f32 accumulation, the small terms
// first: lo*hi' + hi*lo' + hi*hi' (the dropped lo*lo' is ~2^-22 relative).
// One TF32 term alone errs by ~2^-11 and does not hold the reference's 1e-4.
// The tensor cores truncate as they accumulate, so each 8-deep step's three
// products go into a fresh sum that a rounded f32 add then adds to the
// running sum: accumulated onto the running sum itself, 96 truncations per
// output drifted past 1e-4 at the Mamba2-370M shape. The decay is one
// expf(a_i - a_j) per pair i >= j, as the plain version forms it (never
// exp(a_i) * exp(-a_j), which overflows). No atomics: the result is the
// same from run to run.
//
// Design. Rows are tiled by 64 (a block of 4 warps, warp w rows 16w..16w+15);
// 1-D grids order the work longest first.
//   1. ssd_cb_kernel: C B^T once per (chunk, row tile, key block up to the
//      diagonal), on mma.sync.m16n8k8 TF32: C and B staged by cp.async in
//      chunks of 32 state columns (double-buffered), fragments loaded from
//      shared memory by hand; the results go to a scratch array in the mma
//      accumulator layout (one float4 per lane and 8-key tile). At the
//      Mamba2-370M shape that is 8.4 MB, read back from L2.
//   2. ssd_tc_kernel, one warpgroup per (chunk, row tile, heads_per_block
//      heads), per head and key block of 64: Xdt and the block's C B^T
//      fragments staged by cp.async (the head's a with its first block);
//      Xdt split into TF32 hi and lo tiles, transposed to K-major in
//      wgmma's 128-byte swizzle; then per 8-key step the weights
//      W = C B^T o L are formed in registers and Y += W Xdt runs as three
//      asynchronous wgmma (m64nNk8, A = W from registers, B from shared
//      memory) while the next step's weights are formed. The accumulator
//      layout of C B^T (row g, keys 2t and 2t + 1) is not the TF32 A
//      layout (keys t and t + 4), so each 8-key step takes its keys in the
//      order (0, 2, 4, 6, 1, 3, 5, 7) in both operands: the weights come
//      straight from the C B^T fragments, and the Xdt tiles are written in
//      that order. Y stays in registers until the head's last key block.
// The cp.async, TF32 split and mma.sync helpers live in tf32_tiles.cuh,
// shared with the backward (ssd_scan_bwd.cu).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32;  // cp.async, the TF32 split, mma.sync and its three-term step

constexpr int kRows = 64;         // rows i per block, and keys j per key block
constexpr int kWarps = 4;         // one warp per 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kNStep = 32;        // state columns per staged chunk of C and B
constexpr int kLDN = kNStep + 4;  // chunk row stride: a fragment's 8 rows x 4 columns hit 32 banks

// Row stride (floats) of the staged Xdt block.
__host__ __device__ constexpr int x_stride(int pt) { return pt + 4; }

// Floats of one key block of C B^T for a block's 64 rows: 4 warps x 8 key
// tiles x 32 lanes x 4.
constexpr int kCbBlock = kWarps * 8 * 32 * 4;

// Block (pair, b * NC + c) of the pre-pass: C B^T for rows [i0, i0 + 64) and
// keys [j0, j0 + 64) of chunk (b, c), one (row tile, key block) pair with
// key block <= row tile, into cbg in the mma accumulator layout [b * NC +
// c][QP / 16 row tiles of 16][QP / 8 key tiles][lane][4] (key blocks above
// the diagonal are never written or read).
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(const float* __restrict__ cc,
                                                          const float* __restrict__ bc,
                                                          float* __restrict__ cbg, int Q,
                                                          int N, int QP, int pairs) {
  extern __shared__ __align__(16) float smem[];
  const int64_t bcidx = static_cast<int>(blockIdx.x) / pairs;
  int it = 0, jb = static_cast<int>(blockIdx.x) - static_cast<int>(bcidx) * pairs;
  while (jb > it) jb -= ++it;  // pair index = it (it + 1) / 2 + jb
  const int i0 = it * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const float* cch = cc + bcidx * Q * N;
  const float* bch = bc + bcidx * Q * N;
  float* out = cbg + ((bcidx * (QP / 16) + it * 4 + warp) * (QP / 8) + jb * 8) * 128 + lane * 4;

  // C and B in chunks of 32 state columns through a two-stage ring.
  const int steps = (N + kNStep - 1) / kNStep;
  auto stage = [&](int s) {
    float* cs = smem + (s & 1) * 2 * kRows * kLDN;
    stage_rows<kRows, kThreads>(cs, kLDN, cch, N, i0, Q, s * kNStep, kNStep, N);
    stage_rows<kRows, kThreads>(cs + kRows * kLDN, kLDN, bch, N, jb * kRows, Q, s * kNStep, kNStep,
                                N);
  };
  stage(0);
  cp_async_commit();
  float acc[2][4][4] = {};  // 8 key tiles of 8, in two groups
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s landed; step s - 1's buffer is free
    if (s + 1 < steps) stage(s + 1);
    cp_async_commit();
    const float* cs = smem + (s & 1) * 2 * kRows * kLDN;
    const float* bs = cs + kRows * kLDN;
#pragma unroll
    for (int k0 = 0; k0 < kNStep; k0 += 8) {
      uint32_t ah[4], al[4];
      split(cs[(r0 + g) * kLDN + k0 + t], ah[0], al[0]);
      split(cs[(r0 + g + 8) * kLDN + k0 + t], ah[1], al[1]);
      split(cs[(r0 + g) * kLDN + k0 + t + 4], ah[2], al[2]);
      split(cs[(r0 + g + 8) * kLDN + k0 + t + 4], ah[3], al[3]);
#pragma unroll
      for (int gr = 0; gr < 2; ++gr) {
        const float* b = bs + (gr * 32 + g) * kLDN + k0 + t;
        step3<4>(acc[gr], ah, al, [&](int nt, float& b0, float& b1) {
          b0 = b[nt * 8 * kLDN];
          b1 = b[nt * 8 * kLDN + 4];
        });
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    *reinterpret_cast<float4*>(out + nt * 128) =
        make_float4(acc[nt / 4][nt % 4][0], acc[nt / 4][nt % 4][1], acc[nt / 4][nt % 4][2],
                    acc[nt / 4][nt % 4][3]);
}

// ---- wgmma: asynchronous warpgroup products, A (the weights) from
// registers, B (Xdt) from shared memory, K-major in the 128-byte swizzle.

// The B tile of one key block: [2 halves of 32 keys][ROWS = P columns][128
// bytes], each row's 16-byte chunks XOR-swizzled by row % 8 (1024-byte atoms
// of 8 rows). Byte offset of the chunk `chunk` (16 bytes) of row r.
template <int ROWS>
__device__ __forceinline__ int b_offset(int r, int chunk) {
  return (chunk >> 3) * ROWS * 128 + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

// A wgmma operand in shared memory, 128-byte swizzle; sbo: bytes between
// 8-row atoms.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of wgmma registers across
// the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define AMPLE_WGMMA_TF32(N, REGS, ...)                                                        \
  __device__ __forceinline__ void wgmma_tf32_n##N(float (&d)[N / 2], const uint32_t (&a)[4], \
                                                  uint64_t desc_b, int scale_d) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #REGS ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" __VA_ARGS__ "}, "  \
                 "{%" AMPLE_A0_##N ", %" AMPLE_A1_##N ", %" AMPLE_A2_##N ", %" AMPLE_A3_##N "}, " \
                 "%" AMPLE_B_##N ", p, 1, 1;\n}\n"                                            \
                 : AMPLE_D_##N(d)                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));   \
  }
#define AMPLE_D_16(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7])
#define AMPLE_D_32(d)                                                                      \
  AMPLE_D_16(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define AMPLE_D_64(d)                                                                      \
  AMPLE_D_32(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),   \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define AMPLE_A0_16 "8"
#define AMPLE_A1_16 "9"
#define AMPLE_A2_16 "10"
#define AMPLE_A3_16 "11"
#define AMPLE_B_16 "12"
#define AMPLE_A0_32 "16"
#define AMPLE_A1_32 "17"
#define AMPLE_A2_32 "18"
#define AMPLE_A3_32 "19"
#define AMPLE_B_32 "20"
#define AMPLE_A0_64 "32"
#define AMPLE_A1_64 "33"
#define AMPLE_A2_64 "34"
#define AMPLE_A3_64 "35"
#define AMPLE_B_64 "36"
AMPLE_WGMMA_TF32(16, 13, "%0, %1, %2, %3, %4, %5, %6, %7")
AMPLE_WGMMA_TF32(32, 21,
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15")
AMPLE_WGMMA_TF32(64, 37,
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31")

// d (64 x NW f32) = or += a (64 x 8 TF32, registers) b (8 x NW, the B tile
// at byte `addr`).
template <int NW>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NW / 2], const uint32_t (&a)[4],
                                           uint32_t addr, int scale_d) {
  const uint64_t desc = smem_desc(addr, 1024);
  if constexpr (NW == 16) wgmma_tf32_n16(d, a, desc, scale_d);
  else if constexpr (NW == 32) wgmma_tf32_n32(d, a, desc, scale_d);
  else wgmma_tf32_n64(d, a, desc, scale_d);
}

// Block (it, b * NC + c, head group) of the main kernel: Y for rows
// [i0, i0 + 64) of chunk (b, c) and heads [h0, h0 + hpb). One warpgroup;
// warp w owns rows 16w..16w+15 of every product.
template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_tc_kernel(
    const float* __restrict__ cbg, const float* __restrict__ xdt,
    const float* __restrict__ acum, float* __restrict__ out, int Q, int H, int P, int QP,
    int hpb, int tiles, int groups) {
  constexpr int NW = PT < 64 ? PT : 64;  // columns of one wgmma
  constexpr int NP = PT / NW;            // wgmma per product (P 128: two)
  constexpr int LDX = x_stride(PT);
  constexpr int kBTile = 2 * PT * 128;   // bytes of one B tile (hi or lo)
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  // B tiles first, at a 1024-byte boundary (the swizzle's atom).
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ssd_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* bt = base;                                          // [hi, lo] B tiles
  float* xs = reinterpret_cast<float*>(base + 2 * kBTile);          // Xdt block [64][LDX]
  float* cs = xs + kRows * LDX;                                     // C B^T block
  float* as = cs + kCbBlock;                                        // [2][QP] a
  const uint32_t bt_addr = smem_u32(bt);

  const int per_tile = static_cast<int>(gridDim.x) / tiles;
  const int it = tiles - 1 - static_cast<int>(blockIdx.x) / per_tile;  // longest first
  const int rest = static_cast<int>(blockIdx.x) - (tiles - 1 - it) * per_tile;
  const int64_t bcidx = rest / groups;  // b * NC + c
  const int h0 = (rest - static_cast<int>(bcidx) * groups) * hpb;
  const int nh = min(hpb, H - h0);
  const int i0 = it * kRows;
  const int nkb = it + 1;  // key blocks up to the diagonal
  const int kj = nkb * kRows;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // This block's rows of C B^T: 4 row tiles of 16, each QP / 8 key tiles of 128 floats.
  const float* cbb = cbg + (bcidx * (QP / 16) + it * 4) * (QP / 8) * 128;

  // Per head and key block: Xdt rows, the block's C B^T fragments and, with
  // the head's first block, its a (into the buffer of the head's parity).
  const int steps = nh * nkb;
  auto stage = [&](int s) {
    const int hh = s / nkb, jb = s - hh * nkb;
    const int64_t bch_h = bcidx * H + h0 + hh;
    stage_rows<kRows, kThreads>(xs, LDX, xdt + bch_h * Q * P, P, jb * kRows, Q, 0, PT, P);
    for (int q = threadIdx.x; q < kCbBlock / 4; q += kThreads) {
      const int w = q / 256, rem = q - w * 256;  // 256 float4 per warp: 8 key tiles x 32 lanes
      cp_async16(cs + 4 * q, cbb + (w * (QP / 8) + jb * 8) * 128 + 4 * rem, 16);
    }
    if (jb == 0) {
      float* ah = as + (hh & 1) * QP;
      const float* src = acum + bch_h * Q;
      for (int j = threadIdx.x; j < kj; j += kThreads)
        cp_async4(ah + j, j < Q ? src + j : src, j < Q ? 4 : 0);
    }
  };
  stage(0);
  cp_async_commit();
  const int gi0 = i0 + warp * 16 + g, gi1 = gi0 + 8;
  float ai0 = 0.f, ai1 = 0.f;
  float y[NP][NW / 2];
  for (int s = 0; s < steps; ++s) {
    const int hh = s / nkb, jb = s - hh * nkb;
    cp_async_wait_all();
    __syncthreads();  // step s landed; step s - 1's B tiles are no longer read
    // Xdt into the B tiles, split in TF32 hi and lo, transposed to K-major:
    // row p holds the keys of each 8-key step in the order (0, 2, 4, 6, 1,
    // 3, 5, 7), the order of the weights' A fragments. Thread q takes column
    // p = q % PT, one step kk and half hf: keys kk * 8 + 2 i + hf, i < 4.
    for (int q = threadIdx.x; q < PT * 16; q += kThreads) {
      const int p = q % PT, kh = q / PT, kk = kh >> 1, hf = kh & 1;
      const float* x = xs + (kk * 8 + hf) * LDX + p;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x[2 * i * LDX], hi[i], lo[i]);
      const int off = b_offset<PT>(p, 2 * kk + hf);
      *reinterpret_cast<uint4*>(bt + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(bt + kBTile + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    float4 cb[8];  // this warp's C B^T fragments of the key block
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      cb[kk] = *reinterpret_cast<const float4*>(cs + ((warp * 8 + kk) * 32 + lane) * 4);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B tiles seen by wgmma
    __syncthreads();  // B tiles written; the Xdt and C B^T buffers are free
    if (s + 1 < steps) stage(s + 1);
    cp_async_commit();

    const float* ah = as + (hh & 1) * QP;
    if (jb == 0) {
      ai0 = ah[gi0];
      ai1 = ah[gi1];
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int q = 0; q < NW / 2; ++q) y[np][q] = 0.f;
    }
    // The weights W = C B^T o L of step kk for the lane's two rows and keys
    // j0, j0 + 1, in A-fragment order, split in TF32 hi and lo.
    auto weights = [&](int kk, uint32_t (&wh)[4], uint32_t (&wl)[4]) {
      const int j0 = (jb * 8 + kk) * 8 + 2 * t;
      const float2 aj = *reinterpret_cast<const float2*>(ah + j0);
      const float w[4] = {
          j0 <= gi0 && gi0 < Q ? __fmul_rn(cb[kk].x, expf(__fsub_rn(ai0, aj.x))) : 0.f,
          j0 <= gi1 && gi1 < Q ? __fmul_rn(cb[kk].z, expf(__fsub_rn(ai1, aj.x))) : 0.f,
          j0 + 1 <= gi0 && gi0 < Q ? __fmul_rn(cb[kk].y, expf(__fsub_rn(ai0, aj.y))) : 0.f,
          j0 + 1 <= gi1 && gi1 < Q ? __fmul_rn(cb[kk].w, expf(__fsub_rn(ai1, aj.y))) : 0.f,
      };
#pragma unroll
      for (int q = 0; q < 4; ++q) split(w[q], wh[q], wl[q]);
    };
    uint32_t wh[2][4], wl[2][4];
    weights(0, wh[0], wl[0]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int cur = kk & 1;
      // The step's three products into a fresh sum t (the tensor cores
      // truncate as they accumulate), the small terms first.
      float t[NP][NW / 2];
      wgmma_fence();
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const uint32_t col = np * 64 * 128;  // P 128: the second 64 columns
        const uint32_t at = bt_addr + (kk >> 2) * PT * 128 + (kk & 3) * 32 + col;
        wgmma_tf32<NW>(t[np], wl[cur], at, 0);
        wgmma_tf32<NW>(t[np], wh[cur], at + kBTile, 1);
        wgmma_tf32<NW>(t[np], wh[cur], at, 1);
      }
      wgmma_commit();
      if (kk < 7) weights(kk + 1, wh[cur ^ 1], wl[cur ^ 1]);  // while the products run
      wgmma_wait<0>();
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        fence_regs(t[np]);
#pragma unroll
        for (int q = 0; q < NW / 2; ++q) y[np][q] = __fadd_rn(y[np][q], t[np][q]);
      }
      fence_regs(wh[cur]);
      fence_regs(wl[cur]);
    }
    if (jb == nkb - 1) {  // the head's rows are complete
      float* oh = out + (bcidx * H + h0 + hh) * Q * P;
#pragma unroll
      for (int nt = 0; nt < PT / 8; ++nt) {
        const int p = nt * 8 + 2 * t;
        const float* v = &y[nt / (NW / 8)][(nt % (NW / 8)) * 4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gi = half ? gi1 : gi0;
          if (gi >= Q) continue;
          float* dst = oh + static_cast<int64_t>(gi) * P + p;
          if (p + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[2 * half], v[2 * half + 1]);
          } else {
            if (p < P) dst[0] = v[2 * half];
            if (p + 1 < P) dst[1] = v[2 * half + 1];
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

template <int PT>
int launch(const float* cc, const float* bc, const float* xdt, const float* acum, float* out,
           float* cbg, int B, int NC, int Q, int N, int H, int P, int hpb,
           cudaStream_t stream) {
  const int tiles = (Q + kRows - 1) / kRows;
  const int qp = tiles * kRows;
  const int groups = (H + hpb - 1) / hpb;
  const int pairs = tiles * (tiles + 1) / 2;  // (row tile, key block <= it)
  const int64_t cb_blocks = static_cast<int64_t>(pairs) * B * NC;
  const int64_t blocks = static_cast<int64_t>(tiles) * B * NC * groups;
  if (blocks > 0x7fffffff || cb_blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cb_bytes = 2 * 2 * kRows * kLDN * 4;
  ssd_cb_kernel<<<static_cast<int>(cb_blocks), kThreads, cb_bytes, stream>>>(cc, bc, cbg, Q, N,
                                                                            qp, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // B tiles (hi, lo), the Xdt block, the C B^T block, a; 1024 bytes of alignment
  const int bytes = 2 * 2 * PT * 128 + (kRows * x_stride(PT) + kCbBlock + 2 * qp) * 4 + 1024;
  err = cudaFuncSetAttribute(ssd_tc_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // All of the SM's unified memory as shared memory: three blocks of ~69 KB
  // (P 64) share an SM.
  err = cudaFuncSetAttribute(ssd_tc_kernel<PT>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tc_kernel<PT><<<static_cast<int>(blocks), kThreads, bytes, stream>>>(
      cbg, xdt, acum, out, Q, H, P, qp, hpb, tiles, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All arrays contiguous f32. The wrapper checks Q <= 256, P <= 128 and N > 0;
// cb is scratch of B * NC * (Q64 / 16) * (Q64 / 8) * 128 floats (Q64: Q
// rounded up to 64); a block of the main kernel takes heads_per_block > 0
// heads.
extern "C" int ample_ssd_intra_chunk(int device, const float* cc, const float* bc,
                                     const float* xdt, const float* acum, float* out,
                                     float* cb, int B, int NC, int Q, int N, int H, int P,
                                     int heads_per_block, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || NC == 0 || Q == 0 || H == 0 || P == 0) return 0;
  if (Q > 256 || P > 128 || N <= 0 || heads_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hpb = heads_per_block;
  if (P <= 16) return launch<16>(cc, bc, xdt, acum, out, cb, B, NC, Q, N, H, P, hpb, stream);
  if (P <= 32) return launch<32>(cc, bc, xdt, acum, out, cb, B, NC, Q, N, H, P, hpb, stream);
  if (P <= 64) return launch<64>(cc, bc, xdt, acum, out, cb, B, NC, Q, N, H, P, hpb, stream);
  return launch<128>(cc, bc, xdt, acum, out, cb, B, NC, Q, N, H, P, hpb, stream);
}
