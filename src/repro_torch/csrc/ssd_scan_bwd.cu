// Backward of the Mamba2 SSD intra-chunk term for Hopper (training the ssm
// and hybrid families).
//
// Pairs with the Pallas TPU kernel
//   repro/kernels/ssd_scan/ssd_scan.py::ssd_intra_chunk_call,
// which has no VJP: the reference differentiates the einsums of its layer
// (repro/models/lm/mamba.py). The plain version is
// repro_torch/kernels/ssd_scan/ref.py::ssd_intra_chunk_bwd_ref.
//
// The forward (csrc/ssd_scan.cu) computes, per batch b, chunk c and head h,
//   Y_h = W_h Xdt_h,   W_h = (C B^T) o L_h,   L_h[i,j] = exp(a_i - a_j) [i >= j].
// Given dY (f32 [B, NC, H, Q, P]) this computes
//   dXdt_h = W_h^T dY_h,
//   dW_h   = dY_h Xdt_h^T on i >= j,
//   dCB    = sum_h dW_h o L_h   (one C, B group shared by the heads),
//   dC     = dCB B,   dB = dCB^T C,
//   dacum_h[i] = sum_j G_h[i,j] - sum_k G_h[k,i],   G_h = dW_h o W_h.
// It has the shape of attention's backward with one query/key group shared
// by the heads: C plays Q, B plays K, W_h plays P, Xdt plays V, dY plays dO.
//
// What bounds it on an H100: bytes. At the Mamba2-370M training shape (B 4,
// NC 8, Q 256, N 128, H 32, P 64) the lower triangle needs 9.43 GFLOP (dXdt
// and dW 8.6, dC and dB 0.54, C B^T 0.27) against 220.2 MB of inputs and
// gradients: 0.066 ms for the bytes, 0.057 ms for the three TF32 products of
// each (28.3 GFLOP at 494.7 TFLOP/s), 0.141 ms for f32 FMAs on the CUDA
// cores.
//
// Numbers: f32 kept on the TF32 tensor cores by the forward's three-term
// products (tf32_tiles.cuh: lo*hi' + hi*lo' + hi*hi', each 8-deep step into
// a fresh sum added by a rounded f32 add), which holds the plain version's
// 1e-4. The decay is one exp(a_i - a_j) per pair i >= j (__expf: ex2.approx,
// a few ulp), formed once per (head, tile pair), never exp(a_i) * exp(-a_j),
// which overflows. No atomics: every sum is taken in a fixed order, so the
// result is the same from run to run.
//
// Design, three kernels on mma.sync.m16n8k8 (8 warps, 64 x 64 tiles), 1-D
// grids:
//   0. ssd_bwd_cb_kernel, one block per (chunk, tile pair it >= jt): C B^T's
//      tile transposed (keys j x rows i, N deep; B[jt] and C[it] through a
//      two-slot cp.async ring of 32-column chunks), written once a chunk in
//      kernel 1's mma accumulator layout, the tiles of a key tile together.
//   1. ssd_bwd_dwdx_kernel, one block per (key tile jt, chunk, run of heads),
//      longest walk (jt = 0) first, one block an SM (its shared memory).
//      Its C B^T tiles (it, jt), it >= jt, land in shared memory first. Then
//      for each head of its run and each row tile it >= jt, with dY_h[it]
//      (and, at the head's first tile, Xdt_h[jt] and a) arriving through a
//      cp.async ring of `stages` slots while the previous tile computes:
//        dW^T = Xdt_h[jt] dY_h[it]^T     (P deep; warp (wj, wi) owns keys
//                                         16 wj.. and rows 32 wi..),
//        L, W = C B^T o L in registers (L once per element; masks only on
//        the diagonal and the ragged last tile), dCB(it, jt) += dW o L in
//        shared memory (each thread its own elements, summed over the run's
//        heads in head order), G = dW o W: its sums over the keys go to
//        `rowp` (one partial per key tile), its sums over the rows stay in
//        registers over it (one partial per key row, `colp`),
//        dXdt_h[jt] += W^T dY_h[it]  (64 deep, A = W^T straight from the
//                                     registers: each 8-row step takes its
//                                     rows in the order (0, 2, 4, 6, 1, 3,
//                                     5, 7), as the forward's weights do).
//      The two warps of a key row (wi = 0, 1) sum their dXdt halves in
//      order through shared memory at the head's last tile. The block's
//      dCB tiles go to its run's [B, NC, QP, QP] partial.
//   2. ssd_bwd_dcdb_kernel, one block per (chunk, row tile, 64 state
//      columns), two an SM: dC's and dB's tiles from dCB (its runs'
//      partials summed in run order as they land) and B or C, 32 deep a
//      step through a two-slot ring; chunks * T more blocks form dacum from
//      the G partials.
// Staged tiles have row stride P + 4 floats (36 or 72 in kernels 0 and 2):
// every fragment read of a warp hits 32 different banks. The backward's
// products split their operands with split_trunc (tf32_tiles.cuh), two
// instructions a split: it does not need the forward's roundings.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32;  // cp.async, the TF32 split, mma.sync and its three-term step

constexpr int kT = 64;          // rows and columns of a tile
constexpr int kWarps = 8;       // 4 key groups of 16 x 2 row groups of 32
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kT * kT;  // floats of one tile of C B^T or dCB
constexpr int kMaxRuns = 8;     // dCB partials kernel 2 sums (its ring holds runs + 1 pieces)
constexpr int kK3 = 32;         // depth of one step of kernel 2
constexpr int kPiece = 2304;    // floats of one staged piece of kernel 2: 64 x 36 or 32 x 72
constexpr int kLD3 = 72;        // row stride of kernel 2's pieces read by columns

// Row stride (floats) of a staged [64][PT] tile.
__host__ __device__ constexpr int tile_ld(int pt) { return pt + 4; }

// Shared memory of kernel 1 (floats), in order: C B^T and dCB tiles [T][kTile]
// each; dY and Xdt slots [S][64][LD] each; a of the rows and of the keys
// [S][64] each; G's key sums [2][4][64] and row sums [2][2][64].
__host__ __device__ constexpr int dwdx_floats(int pt, int stages, int tiles) {
  return 2 * tiles * kTile + stages * 2 * kT * tile_ld(pt) + stages * 2 * kT + 8 * kT + 4 * kT;
}

// acc[n] (16 keys x 8 rows, n < 4: rows 8n..8n+7 of the warp's 32) +=
// A B^T over K columns: A's 16 rows (row stride LD) at xa, B's 32 rows at
// xb. Fragment reads: A (g, t), B (g, t) of 8-column steps; unrolled 64
// columns at a time.
template <int K, int LD>
__device__ __forceinline__ void gemm_nt(float (&acc)[4][4], const float* xa, const float* xb,
                                        int g, int t) {
  constexpr int KC = K < 64 ? K : 64;
#pragma unroll 1
  for (int kc = 0; kc < K; kc += KC) {
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      const int k0 = kc + kk;
      uint32_t ah[4], al[4];
      split_trunc(xa[g * LD + k0 + t], ah[0], al[0]);
      split_trunc(xa[(g + 8) * LD + k0 + t], ah[1], al[1]);
      split_trunc(xa[g * LD + k0 + t + 4], ah[2], al[2]);
      split_trunc(xa[(g + 8) * LD + k0 + t + 4], ah[3], al[3]);
      step3<4>(
          acc, ah, al,
          [&](int nt, float& b0, float& b1) {
            b0 = xb[(nt * 8 + g) * LD + k0 + t];
            b1 = xb[(nt * 8 + g) * LD + k0 + t + 4];
          },
          SplitTrunc());
    }
  }
}

// Tile (it, jt), it >= jt, of a chunk's C B^T tiles, numbered key tile by
// key tile: the tiles of key tile jt are contiguous.
__host__ __device__ inline int cb_tile(int it, int jt, int T) {
  return jt * T - jt * (jt - 1) / 2 + it - jt;
}

// Block (b * NC + c) * pairs + tile of the pre-pass: C B^T's tile (it, jt)
// transposed (keys j x rows i, N deep), into cbg in the mma accumulator
// layout of kernel 1's warps: [chunk][cb_tile][warp][n][lane][4]. C and B
// arrive in 32-column chunks through a two-slot cp.async ring.
__global__ void __launch_bounds__(kThreads) ssd_bwd_cb_kernel(const float* __restrict__ cc,
                                                              const float* __restrict__ bc,
                                                              float* __restrict__ cbg, int Q,
                                                              int N, int T, int pairs) {
  constexpr int LD = kK3 + 4;
  __shared__ __align__(16) float smem[2][2][kT * LD];  // [slot][B, C][64][36]
  const int64_t bcidx = blockIdx.x / pairs;
  const int tile = static_cast<int>(blockIdx.x - bcidx * pairs);
  int jt = 0, it = tile;
  while (it >= T - jt) it -= T - jt++;
  it += jt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wj = warp & 3, wi = warp >> 2;
  const int g = lane / 4, t = lane % 4;
  const float* cch = cc + bcidx * Q * N;
  const float* bch = bc + bcidx * Q * N;
  const int steps = (N + kK3 - 1) / kK3;
  auto issue = [&](int s) {
    if (s >= steps) return;
    stage_rows<kT, kThreads>(smem[s & 1][0], LD, bch, N, jt * kT, Q, s * kK3, kK3, N);
    stage_rows<kT, kThreads>(smem[s & 1][1], LD, cch, N, it * kT, Q, s * kK3, kK3, N);
  };
  issue(0);
  cp_async_commit();
  float acc[4][4] = {};
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s landed; the slot of step s - 1 is free
    issue(s + 1);
    cp_async_commit();
    gemm_nt<kK3, LD>(acc, smem[s & 1][0] + 16 * wj * LD, smem[s & 1][1] + 32 * wi * LD, g, t);
  }
  float* out = cbg + (bcidx * pairs + tile) * kTile + (warp * 4 * 32 + lane) * 4;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    *reinterpret_cast<float4*>(out + n * 128) =
        make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
}

// The weights of one step for a lane (keys kj, kj + 8; rows ri + 8n, ri +
// 8n + 1 of tile it, n < 4; gi: row ri's index in the chunk), from its dW^T
// accumulators: L = exp(a_i - a_j) where i >= j and i < Q (MASKED: the
// diagonal tile, where kd = kj, or the ragged last one, kd = -64), W = C B^T
// o L into w; dCB += dW o L in the lane's float4s of the tile; G = dW o W
// summed over the lane's two keys per row into rs and over its rows per key
// into colsum.
template <bool MASKED>
__device__ __forceinline__ void weights(const float (&acc)[4][4], float (&w)[4][4],
                                        float (&rs)[8], float (&colsum)[2], const float* ai,
                                        const float* cbt, float* dct, float aj0, float aj1,
                                        int ri, int kd, int gi, int Q) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float2 a = *reinterpret_cast<const float2*>(ai + ri + 8 * n);
    const float4 cb = *reinterpret_cast<const float4*>(cbt + n * 128);
    float4 dc = *reinterpret_cast<const float4*>(dct + n * 128);
    float l[4] = {__expf(__fsub_rn(a.x, aj0)), __expf(__fsub_rn(a.y, aj0)),
                  __expf(__fsub_rn(a.x, aj1)), __expf(__fsub_rn(a.y, aj1))};
    if (MASKED) {  // elements (kj, r), (kj, r + 1), (kj + 8, r), (kj + 8, r + 1)
      const int r = ri + 8 * n, i = gi + 8 * n;
      if (!(i < Q && r >= kd)) l[0] = 0.f;
      if (!(i + 1 < Q && r + 1 >= kd)) l[1] = 0.f;
      if (!(i < Q && r >= kd + 8)) l[2] = 0.f;
      if (!(i + 1 < Q && r + 1 >= kd + 8)) l[3] = 0.f;
    }
    w[n][0] = __fmul_rn(cb.x, l[0]);
    w[n][1] = __fmul_rn(cb.y, l[1]);
    w[n][2] = __fmul_rn(cb.z, l[2]);
    w[n][3] = __fmul_rn(cb.w, l[3]);
    dc.x = fmaf(acc[n][0], l[0], dc.x);
    dc.y = fmaf(acc[n][1], l[1], dc.y);
    dc.z = fmaf(acc[n][2], l[2], dc.z);
    dc.w = fmaf(acc[n][3], l[3], dc.w);
    *reinterpret_cast<float4*>(dct + n * 128) = dc;
    const float g0 = __fmul_rn(acc[n][0], w[n][0]), g1 = __fmul_rn(acc[n][1], w[n][1]);
    const float g2 = __fmul_rn(acc[n][2], w[n][2]), g3 = __fmul_rn(acc[n][3], w[n][3]);
    rs[2 * n] = __fadd_rn(g0, g2);
    rs[2 * n + 1] = __fadd_rn(g1, g3);
    colsum[0] = __fadd_rn(__fadd_rn(colsum[0], g0), g1);
    colsum[1] = __fadd_rn(__fadd_rn(colsum[1], g2), g3);
  }
}

// Block ((jt * chunks + b * NC + c) * runs + run) of kernel 1: keys [jt * 64,
// jt * 64 + 64) of chunk (b, c), heads [run * hpr, run * hpr + hpr).
template <int PT, int S>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dwdx_kernel(
    const float* __restrict__ cbg, const float* __restrict__ xdt, const float* __restrict__ acum,
    const float* __restrict__ dy, float* __restrict__ dxdt, float* __restrict__ dcbg,
    float* __restrict__ rowp, float* __restrict__ colp, int Q, int H, int P, int QP, int T,
    int chunks, int runs, int hpr, int64_t dy_bc, int64_t dy_h, int64_t dy_q,
    int64_t run_stride) {
  constexpr int LD = tile_ld(PT);
  constexpr int TL = kT * LD;  // floats of one slot
  constexpr int NP = PT / 8;   // 8-column tiles of dXdt
  constexpr int NG = NP < 4 ? NP : 4;
  extern __shared__ __align__(16) float smem[];
  float* cbs = smem;                  // C B^T tiles (it, jt), it = jt + tile
  float* dcbs = cbs + T * kTile;      // their dCB
  float* ys = dcbs + T * kTile;       // dY_h[it] slots
  float* xs = ys + S * TL;            // Xdt_h[jt] slots
  float* ai = xs + S * TL;            // a_h of the rows it
  float* aj = ai + S * kT;            // a_h of the keys jt
  float* red_row = aj + S * kT;       // [2][4][64]: G summed over each key group
  float* red_col = red_row + 8 * kT;  // [2][2][64]: G summed over each row group

  const int per_jt = chunks * runs;
  const int jt = static_cast<int>(blockIdx.x) / per_jt;
  const int rest = static_cast<int>(blockIdx.x) - jt * per_jt;
  const int64_t bcidx = rest / runs;
  const int h0 = (rest - static_cast<int>(bcidx) * runs) * hpr;
  const int nh = min(hpr, H - h0);
  const int walk = T - jt;  // row tiles it = jt .. T - 1
  const int steps = nh * walk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wj = warp & 3, wi = warp >> 2;
  const int g = lane / 4, t = lane % 4;

  // Each head's Xdt (and a of its keys) takes the next slot in turn: it
  // lives until the head's last tile while later steps land in the others.
  auto xslot = [&](int s) { return (s / walk) % S; };
  auto issue = [&](int s) {
    if (s >= steps) return;
    const int hh = s / walk, it = jt + s - hh * walk;
    const int64_t bch_h = bcidx * H + h0 + hh;
    stage_rows<kT, kThreads>(ys + (s % S) * TL, LD, dy + bcidx * dy_bc + (h0 + hh) * dy_h, dy_q,
                             it * kT, Q, 0, PT, P);
    const float* ah = acum + bch_h * Q;
    if (threadIdx.x < kT) {
      const int r = it * kT + threadIdx.x;
      cp_async4(ai + (s % S) * kT + threadIdx.x, r < Q ? ah + r : ah, r < Q ? 4 : 0);
    }
    if (it == jt) {
      stage_rows<kT, kThreads>(xs + xslot(s) * TL, LD, xdt + bch_h * Q * P, P, jt * kT, Q, 0, PT,
                               P);
      if (threadIdx.x >= kT && threadIdx.x < 2 * kT) {
        const int r = jt * kT + threadIdx.x - kT;
        cp_async4(aj + xslot(s) * kT + threadIdx.x - kT, r < Q ? ah + r : ah, r < Q ? 4 : 0);
      }
    }
  };
  // The previous step's sums of G across warps, after the barrier that
  // follows it: over the 4 key groups per row (rowp), and at a head's last
  // tile over the 2 row groups per key (colp).
  auto flush = [&](int s) {
    if (s < 0) return;
    const int hh = s / walk, it = jt + s - hh * walk;
    const int64_t bch_h = bcidx * H + h0 + hh;
    if (threadIdx.x < kT) {
      const float* r = red_row + (s & 1) * 4 * kT + threadIdx.x;
      const float v = __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[kT]), r[2 * kT]), r[3 * kT]);
      rowp[(bch_h * T + jt) * QP + it * kT + threadIdx.x] = v;
    } else if (it == T - 1 && threadIdx.x < 2 * kT) {
      const float* c = red_col + (hh & 1) * 2 * kT + threadIdx.x - kT;
      colp[bch_h * QP + jt * kT + threadIdx.x - kT] = __fadd_rn(c[0], c[kT]);
    }
  };

  // The block's C B^T tiles (contiguous, from the pre-pass) land first.
  const float* cbsrc = cbg + (bcidx * (T * (T + 1) / 2) + cb_tile(jt, jt, T)) * kTile;
  for (int e = threadIdx.x * 4; e < walk * kTile; e += kThreads * 4) {
    cp_async16(cbs + e, cbsrc + e, 16);
    *reinterpret_cast<float4*>(dcbs + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    issue(k);
    cp_async_commit();
  }

  float acc[4][4];           // dW^T of a step
  float dx[NP / NG][NG][4];  // this warp's half of dXdt_h[jt]: keys g, g + 8, columns 8n + 2t
  float colsum[2] = {0.f, 0.f};
  float aj0 = 0.f, aj1 = 0.f;
  const int frag = (warp * 4 * 32 + lane) * 4;  // a thread's float4 in a tile, + 128 per n
  const int kj = 16 * wj + g;                   // the lane's first key within the tile
  const int ri = 32 * wi + 2 * t;               // the lane's first row within the tile
  for (int s = 0; s < steps; ++s) {
    if constexpr (S == 1) {
      __syncthreads();  // step s - 1 no longer reads the slot
      issue(s);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<S - 2>();
    }
    __syncthreads();  // step s landed; the slot of step s - 1 is free
    flush(s - 1);
    if constexpr (S > 1) {
      issue(s + S - 1);
      cp_async_commit();
    }
    const float* y = ys + (s % S) * TL;
    const float* x = xs + xslot(s) * TL;
    const int hh = s / walk, it = jt + s - hh * walk;
    if (it == jt) {  // the head's first tile
      const float* a = aj + xslot(s) * kT + kj;
      aj0 = a[0];
      aj1 = a[8];
      colsum[0] = colsum[1] = 0.f;
#pragma unroll
      for (int gr = 0; gr < NP / NG; ++gr)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[gr][n][e] = 0.f;
    }

    // dW^T = Xdt_h[jt] dY_h[it]^T: keys kj, kj + 8, rows ri + 8n (+ 1).
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    gemm_nt<PT, LD>(acc, x + 16 * wj * LD, y + 32 * wi * LD, g, t);

    // L and W once per element; dCB += dW o L; G = dW o W and its sums.
    float w[4][4], rs[8];
    const float* cbt = cbs + (it - jt) * kTile + frag;
    float* dct = dcbs + (it - jt) * kTile + frag;
    if (it == jt || (it + 1) * kT > Q)
      weights<true>(acc, w, rs, colsum, ai + (s % S) * kT, cbt, dct, aj0, aj1, ri,
                    it == jt ? kj : -kT, it * kT + ri, Q);
    else
      weights<false>(acc, w, rs, colsum, ai + (s % S) * kT, cbt, dct, aj0, aj1, ri, kj,
                     it * kT + ri, Q);
    // Each row's sum over the warp's 16 keys: the 8 lanes g of a t hold 8
    // rows each; three halving exchanges leave lane (g, t) the sum of row
    // 8 (g >> 1) + 2t + (g & 1), in a fixed order.
    {
      const bool u2 = lane & 16, u1 = lane & 8, u0 = lane & 4;
      float v4[4], v2[2];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v4[k] = __fadd_rn(u2 ? rs[k + 4] : rs[k],
                          __shfl_xor_sync(0xffffffffu, u2 ? rs[k] : rs[k + 4], 16));
#pragma unroll
      for (int k = 0; k < 2; ++k)
        v2[k] = __fadd_rn(u1 ? v4[k + 2] : v4[k],
                          __shfl_xor_sync(0xffffffffu, u1 ? v4[k] : v4[k + 2], 8));
      const float v =
          __fadd_rn(u0 ? v2[1] : v2[0], __shfl_xor_sync(0xffffffffu, u0 ? v2[0] : v2[1], 4));
      red_row[(s & 1) * 4 * kT + wj * kT + 32 * wi + 8 * (g >> 1) + 2 * t + (g & 1)] = v;
    }

    // dXdt_h[jt] += W^T dY_h[it] over the warp's 32 rows: A = W^T from the
    // registers, rows of each 8-step in the order (0, 2, 4, 6, 1, 3, 5, 7).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      split_trunc(w[kk][0], ah[0], al[0]);
      split_trunc(w[kk][2], ah[1], al[1]);
      split_trunc(w[kk][1], ah[2], al[2]);
      split_trunc(w[kk][3], ah[3], al[3]);
      const float* yb = y + (32 * wi + 8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int gr = 0; gr < NP / NG; ++gr)
        step3<NG>(
            dx[gr], ah, al,
            [&](int nt, float& b0, float& b1) {
              const int p = (gr * NG + nt) * 8;
              b0 = yb[p];
              b1 = yb[LD + p];
            },
            SplitTrunc());
    }

    if (it == T - 1) {  // the head's last tile: G's row-group sums, dXdt
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        colsum[c] = __fadd_rn(colsum[c], __shfl_xor_sync(0xffffffffu, colsum[c], 1));
        colsum[c] = __fadd_rn(colsum[c], __shfl_xor_sync(0xffffffffu, colsum[c], 2));
      }
      if (t == 0) {
        red_col[(hh & 1) * 2 * kT + wi * kT + kj] = colsum[0];
        red_col[(hh & 1) * 2 * kT + wi * kT + kj + 8] = colsum[1];
      }
      // The two row groups' halves of dXdt summed in order through this
      // step's dY slot (refilled only after the next step's barrier).
      float* xb = ys + (s % S) * TL + (wj * NP * 32 + lane) * 4;
      __syncthreads();  // every warp is done with the slot
      if (wi == 1) {
#pragma unroll
        for (int n = 0; n < NP; ++n)
          *reinterpret_cast<float4*>(xb + n * 128) =
              make_float4(dx[n / NG][n % NG][0], dx[n / NG][n % NG][1], dx[n / NG][n % NG][2],
                          dx[n / NG][n % NG][3]);
      }
      __syncthreads();
      if (wi == 0) {
        float* out = dxdt + (bcidx * H + h0 + hh) * Q * P;
        const int j0 = jt * kT + kj;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const float4 o = *reinterpret_cast<const float4*>(xb + n * 128);
          const float v[4] = {__fadd_rn(dx[n / NG][n % NG][0], o.x),
                              __fadd_rn(dx[n / NG][n % NG][1], o.y),
                              __fadd_rn(dx[n / NG][n % NG][2], o.z),
                              __fadd_rn(dx[n / NG][n % NG][3], o.w)};
          const int p = n * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int gj = j0 + 8 * half;
            if (gj >= Q) continue;
            float* dst = out + static_cast<int64_t>(gj) * P + p;
            if ((P & 1) == 0 && p + 1 < P) {
              *reinterpret_cast<float2*>(dst) = make_float2(v[2 * half], v[2 * half + 1]);
            } else {
              if (p < P) dst[0] = v[2 * half];
              if (p + 1 < P) dst[1] = v[2 * half + 1];
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  flush(steps - 1);

  // The run's dCB tiles (it, jt), row-major [i][j] in its partial.
  float* dst = dcbg + (h0 / hpr) * run_stride + bcidx * QP * QP;
  for (int tl = 0; tl < walk; ++tl) {
    const float* dct = dcbs + tl * kTile + frag;
    const int j = jt * kT + kj;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 dc = *reinterpret_cast<const float4*>(dct + n * 128);
      const int64_t i = (jt + tl) * kT + ri + 8 * n;
      dst[i * QP + j] = dc.x;
      dst[(i + 1) * QP + j] = dc.y;
      dst[i * QP + j + 8] = dc.z;
      dst[(i + 1) * QP + j + 8] = dc.w;
    }
  }
}

// Block (b * NC + c, row tile it, state-column chunk nk) of kernel 2, two
// stages: dC[i, n] = sum_{j <= i} dCB[i, j] B[j, n] for the rows of tile it,
// then dB[j, n] = sum_{i >= j} dCB[i, j] C[i, n] for the keys of tile it,
// each 32 deep a step through the ring; warp (wr, wc) owns rows 16 wr.. and
// columns 32 wc.. of the 64 x 64 output tile. The last chunks * T blocks
// form dacum for a (chunk, row tile) each instead.
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dcdb_kernel(
    const float* __restrict__ cc, const float* __restrict__ bc, const float* __restrict__ dcbg,
    const float* __restrict__ rowp, const float* __restrict__ colp, float* __restrict__ dcc,
    float* __restrict__ dbc, float* __restrict__ dacum, int Q, int N, int H, int QP, int T,
    int chunks, int nchunks, int runs, int64_t run_stride) {
  constexpr int S = 2;
  extern __shared__ __align__(16) float smem[];
  const int64_t tiles_out = static_cast<int64_t>(chunks) * T * nchunks;
  if (blockIdx.x >= tiles_out) {
    // dacum_h[i] = sum_j G_h[i, j] - sum_k G_h[k, i]: the row partials of
    // the key tiles jt <= it, less the key row's partial.
    const int64_t bcidx = (blockIdx.x - tiles_out) / T;
    const int it = static_cast<int>(blockIdx.x - tiles_out - bcidx * T);
    for (int e = threadIdx.x; e < H * kT; e += kThreads) {
      const int h = e / kT, gi = it * kT + e - (e / kT) * kT;
      if (gi >= Q) continue;
      const int64_t bch_h = bcidx * H + h;
      float s = 0.f;
      for (int jt = 0; jt <= it; ++jt) s = __fadd_rn(s, rowp[(bch_h * T + jt) * QP + gi]);
      dacum[bch_h * Q + gi] = __fsub_rn(s, colp[bch_h * QP + gi]);
    }
    return;
  }
  const int slot_floats = (runs + 1) * kPiece;
  const int per_bc = T * nchunks;
  const int64_t bcidx = blockIdx.x / per_bc;
  const int rest = static_cast<int>(blockIdx.x - bcidx * per_bc);
  const int it = rest / nchunks, nk = rest - (rest / nchunks) * nchunks;
  const int i0 = it * kT, n0 = nk * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane / 4, t = lane % 4;
  const float* cch = cc + bcidx * Q * N;
  const float* bch = bc + bcidx * Q * N;
  const float* dcb = dcbg + bcidx * QP * QP;
  const int steps1 = 2 * (it + 1);            // dC: keys [0, i0 + 64)
  const int steps = steps1 + 2 * (T - it);    // dB: rows [i0, QP)

  auto issue = [&](int s) {
    if (s >= steps) return;
    float* sl = smem + (s % S) * slot_floats;
    if (s < steps1) {  // dCB[i0.., k0..k0 + 32) of each run, then B[k0.., n0..]
      const int k0 = s * kK3;
      for (int r = 0; r < runs; ++r)
        stage_rows<kT, kThreads>(sl + r * kPiece, kK3 + 4, dcb + r * run_stride, QP, i0, QP, k0,
                                 kK3, QP);
      stage_rows<kK3, kThreads>(sl + runs * kPiece, kLD3, bch, N, k0, Q, n0, kT, N);
    } else {  // dCB[k0..k0 + 32, i0..] of each run, then C[k0.., n0..]
      const int k0 = i0 + (s - steps1) * kK3;
      for (int r = 0; r < runs; ++r)
        stage_rows<kK3, kThreads>(sl + r * kPiece, kLD3, dcb + r * run_stride, QP, k0, QP, i0,
                                  kT, QP);
      stage_rows<kK3, kThreads>(sl + runs * kPiece, kLD3, cch, N, k0, Q, n0, kT, N);
    }
  };

  issue(0);
  cp_async_commit();
  float acc[4][4] = {};
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // step s landed; the slot of step s - 1 is free
    issue(s + S - 1);
    cp_async_commit();
    float* sl = smem + (s % S) * slot_floats;
    const bool first = s < steps1;
    // The runs' partials of dCB summed in run order into the first piece.
    for (int e = threadIdx.x; e < kT * kK3; e += kThreads) {
      const int off = first ? (e / kK3) * (kK3 + 4) + e % kK3 : (e / kT) * kLD3 + e % kT;
      float v = sl[off];
      for (int r = 1; r < runs; ++r) v = __fadd_rn(v, sl[r * kPiece + off]);
      sl[off] = v;
    }
    __syncthreads();
    const float* bm = sl + runs * kPiece + 32 * wc + g;  // B or C: [32][72]
#pragma unroll
    for (int k0 = 0; k0 < kK3; k0 += 8) {
      uint32_t ah[4], al[4];
      if (first) {  // A = dCB rows i: [64][36]
        const float* a = sl + (16 * wr + g) * (kK3 + 4) + k0 + t;
        split_trunc(a[0], ah[0], al[0]);
        split_trunc(a[8 * (kK3 + 4)], ah[1], al[1]);
        split_trunc(a[4], ah[2], al[2]);
        split_trunc(a[8 * (kK3 + 4) + 4], ah[3], al[3]);
      } else {  // A = dCB^T, keys j: [32 rows i][72]
        const float* a = sl + (k0 + t) * kLD3 + 16 * wr + g;
        split_trunc(a[0], ah[0], al[0]);
        split_trunc(a[8], ah[1], al[1]);
        split_trunc(a[4 * kLD3], ah[2], al[2]);
        split_trunc(a[4 * kLD3 + 8], ah[3], al[3]);
      }
      step3<4>(
          acc, ah, al,
          [&](int nt, float& b0, float& b1) {
            b0 = bm[(k0 + t) * kLD3 + nt * 8];
            b1 = bm[(k0 + t + 4) * kLD3 + nt * 8];
          },
          SplitTrunc());
    }
    if (s == steps1 - 1 || s == steps - 1) {
      float* out = (first ? dcc : dbc) + bcidx * Q * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 32 * wc + nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gi = i0 + 16 * wr + g + 8 * half;
          if (gi >= Q) continue;
          if (n < N) out[static_cast<int64_t>(gi) * N + n] = acc[nt][2 * half];
          if (n + 1 < N) out[static_cast<int64_t>(gi) * N + n + 1] = acc[nt][2 * half + 1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
    }
  }
  cp_async_wait_all();
}

template <int PT, int S>
cudaError_t launch_dwdx(const float* cbg, const float* xdt, const float* acum, const float* dy,
                        float* dxdt, float* dcb, float* rowp, float* colp, int Q, int H, int P,
                        int QP, int T, int chunks, int runs, int hpr, int64_t dy_bc,
                        int64_t dy_h, int64_t dy_q, int64_t run_stride, cudaStream_t stream) {
  const int bytes = dwdx_floats(PT, S, T) * 4;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_dwdx_kernel<PT, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(T) * chunks * runs;
  ssd_bwd_dwdx_kernel<PT, S><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      cbg, xdt, acum, dy, dxdt, dcb, rowp, colp, Q, H, P, QP, T, chunks, runs, hpr, dy_bc, dy_h,
      dy_q, run_stride);
  return cudaGetLastError();
}

}  // namespace

// cc, bc, dcc, dbc [B, NC, Q, N], xdt, dxdt [B, NC, H, Q, P] and acum, dacum
// [B, NC, H, Q] contiguous f32; dy [B, NC, H, Q, P] f32 with unit column
// stride, chunk (b * NC + c) stride dy_bc, head stride dy_h and row stride
// dy_q (floats). Scratch (the wrapper allocates it): cb of B * NC * T (T +
// 1) / 2 * 4096 floats, dcb of runs * B * NC * QP * QP, rowp of B * NC * H *
// T * QP and colp of B * NC * H * QP (T = QP / 64 tiles, QP = Q rounded up
// to 64, runs = ceil(H / heads_per_run)). stages: the ring's slots in kernel
// 1 (1 or 2), 0 for the deepest that fits the card's shared memory. The
// wrapper checks Q <= 256, P <= 128, N > 0 and 1 <= runs <= 8.
extern "C" int ample_ssd_intra_chunk_bwd(int device, const float* cc, const float* bc,
                                         const float* xdt, const float* acum, const float* dy,
                                         float* dcc, float* dbc, float* dxdt, float* dacum,
                                         float* cb, float* dcb, float* rowp, float* colp, int B,
                                         int NC, int Q, int N, int H, int P, int64_t dy_bc,
                                         int64_t dy_h, int64_t dy_q, int heads_per_run,
                                         int stages, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || NC == 0 || Q == 0 || H == 0 || P == 0) return 0;
  if (Q > 256 || P > 128 || N <= 0 || heads_per_run < 1 || stages < 0 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (H + heads_per_run - 1) / heads_per_run;
  if (runs > kMaxRuns) return static_cast<int>(cudaErrorInvalidValue);
  const int T = (Q + kT - 1) / kT;
  const int QP = T * kT;
  const int chunks = B * NC;
  const int pairs = T * (T + 1) / 2;
  const int nchunks = (N + kT - 1) / kT;
  const int pt = P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // P 128 keeps one slot: its two-slot instance spills (dXdt alone holds 64
  // registers a thread), and fits the shared memory only for Q <= 128.
  const int deepest = pt < 128 && dwdx_floats(pt, 2, T) * 4 <= optin ? 2 : 1;
  if (stages == 0) stages = deepest;
  const int bytes3 = 2 * (runs + 1) * kPiece * 4;
  if (stages > deepest || dwdx_floats(pt, 1, T) * 4 > optin || bytes3 > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks1 = static_cast<int64_t>(T) * chunks * runs;
  const int64_t blocks2 = static_cast<int64_t>(chunks) * T * (nchunks + 1);
  const int64_t blocks0 = static_cast<int64_t>(chunks) * pairs;
  if (blocks0 > 0x7fffffff || blocks1 > 0x7fffffff || blocks2 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_cb_kernel<<<static_cast<unsigned>(blocks0), kThreads, 0, stream>>>(cc, bc, cb, Q, N, T,
                                                                          pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t run_stride = static_cast<int64_t>(chunks) * QP * QP;
  auto dwdx = pt == 16   ? (stages == 1 ? launch_dwdx<16, 1> : launch_dwdx<16, 2>)
              : pt == 32 ? (stages == 1 ? launch_dwdx<32, 1> : launch_dwdx<32, 2>)
              : pt == 64 ? (stages == 1 ? launch_dwdx<64, 1> : launch_dwdx<64, 2>)
                         : launch_dwdx<128, 1>;
  err = dwdx(cb, xdt, acum, dy, dxdt, dcb, rowp, colp, Q, H, P, QP, T, chunks, runs,
             heads_per_run, dy_bc, dy_h, dy_q, run_stride, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_dcdb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcdb_kernel<<<static_cast<unsigned>(blocks2), kThreads, bytes3, stream>>>(
      cc, bc, dcb, rowp, colp, dcc, dbc, dacum, Q, N, H, QP, T, chunks, nchunks, runs,
      run_stride);
  return static_cast<int>(cudaGetLastError());
}
