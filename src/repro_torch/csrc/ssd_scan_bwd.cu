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
//
// What bounds it on an H100: operations. At the Mamba2-370M training shape
// (B 4, NC 8, Q 256, N 128, H 32, P 64) the lower triangle needs ~9.4 GFLOP
// (dXdt and dW 8.6, dC and dB 0.54, C B^T 0.27) against ~220 MB of inputs
// and gradients: 0.14 ms at the f32 CUDA-core peak, 0.066 ms for the bytes.
//
// Design: f32 FMAs on the CUDA cores (no TF32 split is needed to hold the
// plain version's 1e-4), 64 x 64 output tiles per block of 256 threads, each
// thread 4 consecutive rows x 4 consecutive columns (P / 16 in kernel 2),
// operands staged in shared memory in steps of 32 along the summed axis and
// read back as float4 (two loads for 16 FMAs). Three kernels, no atomics:
// every sum is taken in a fixed order, so the result is the same from run
// to run.
//   1. ssd_bwd_dcb_kernel, one block per (chunk, row tile it, key tile
//      jt <= it, run of heads): C B^T of the tile (N deep) into a scratch
//      for kernel 2, then, over its heads in order, dW_h (P deep), dCB +=
//      dW_h o L_h in registers and G_h's row sums (over the tile's keys, by
//      shuffles within 16 lanes) and column sums (over its rows, through
//      shared memory) into per-head partial arrays; its dCB tile into its
//      run's [B, NC, QP, QP] partial. The heads are split into runs (the
//      wrapper's bwd_head_splits) so that the grid fills the card: one run
//      per block left 320 blocks at the Mamba2-370M shape, two waves of 264
//      resident blocks, the second one a fifth full.
//   2. ssd_bwd_dxdt_kernel, one block per (chunk, head, key tile jt), longest
//      walk first: W_h's rows i >= jt * 64 formed in shared memory from the
//      C B^T scratch, dXdt_h[j] = sum_i W_h[i,j] dY_h[i] in registers.
//   3. ssd_bwd_dcdb_kernel, one block per (chunk, row tile, 64 state
//      columns): dC's and dB's tiles from dCB (its runs' partials summed in
//      run order as they are staged); the blocks of the first state columns
//      also sum the G partials of their rows into dacum.
// The decay is one expf(a_i - a_j) per pair i >= j, as the forward forms it
// (never exp(a_i) * exp(-a_j), which overflows).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // rows and columns of an output tile
constexpr int kK = 32;           // depth of one staged step
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLDT = kT + 4;     // stride of a transposed staged tile (16-byte rows)

// Rows [r0, r0 + 64) x columns [c0, c0 + 32) of a row-major array, read by
// get(row, column) (zero past rows and cols), transposed: dst[c * kLDT + r].
// A warp reads one row's 32 columns (coalesced).
template <typename Get>
__device__ __forceinline__ void stage_t(float* dst, int r0, int rows, int c0, int cols, Get get) {
  for (int e = threadIdx.x; e < kT * kK; e += kThreads) {
    const int r = e / kK, c = e - (e / kK) * kK;
    const int gr = r0 + r, gc = c0 + c;
    dst[c * kLDT + r] = gr < rows && gc < cols ? get(gr, gc) : 0.f;
  }
}

// Rows [r0, r0 + 32) x columns [c0, c0 + width) of a row-major array, read
// by get(row, column) (zero past rows and cols), as they are: dst[r * width + c].
template <typename Get>
__device__ __forceinline__ void stage_n(float* dst, int width, int r0, int rows, int c0, int cols,
                                        Get get) {
  for (int e = threadIdx.x; e < kK * width; e += kThreads) {
    const int r = e / width, c = e - (e / width) * width;
    const int gr = r0 + r, gc = c0 + c;
    dst[r * width + c] = gr < rows && gc < cols ? get(gr, gc) : 0.f;
  }
}

// Element (r, c) of the row-major [*, width] array src.
struct Rows {
  const float* src;
  int64_t width;
  __device__ __forceinline__ float operator()(int r, int c) const { return src[r * width + c]; }
};

// N consecutive floats at p (16-byte aligned when N >= 4) into v.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  }
}

// acc[r][c] += sum_k sa[k][4 ty + r] sb[k][NCOL tx + c] over one staged
// step: each thread owns 4 consecutive rows and NCOL consecutive columns,
// read as vectors (two shared-memory loads for 4 NCOL FMAs).
template <int NCOL>
__device__ __forceinline__ void fma_step(float (&acc)[4][NCOL], const float* sa, int lda,
                                         const float* sb, int ldb, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    float a[4], b[NCOL];
    load_vec<4>(sa + k * lda + 4 * ty, a);
    load_vec<NCOL>(sb + k * ldb + NCOL * tx, b);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Block ((b * NC + c) * pairs + pair) * splits + split of kernel 1; pair =
// it (it + 1) / 2 + jt; the block walks heads [split * hps, split * hps +
// hps) and writes its dCB tile into partial `split` of dcbs.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dcb_kernel(
    const float* __restrict__ cc, const float* __restrict__ bc, const float* __restrict__ xdt,
    const float* __restrict__ acum, const float* __restrict__ dy, float* __restrict__ cbs,
    float* __restrict__ dcbs, float* __restrict__ rowp, float* __restrict__ colp, int Q, int N,
    int H, int P, int QP, int T, int pairs, int splits, int hps, int64_t split_stride) {
  __shared__ __align__(16) float sa[kK * kLDT];
  __shared__ __align__(16) float sb[kK * kLDT];
  __shared__ __align__(16) float red[16 * kT];  // column sums of G, one row per ty
  const int split = static_cast<int>(blockIdx.x % splits);
  const int64_t block = blockIdx.x / splits;
  const int64_t bcidx = block / pairs;
  int it = 0, jt = static_cast<int>(block - bcidx * pairs);
  while (jt > it) jt -= ++it;
  const int i0 = it * kT, j0 = jt * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h_end = min(H, (split + 1) * hps);

  // C B^T of the tile, N deep.
  float cb[4][4] = {};
  const Rows cch{cc + bcidx * Q * N, N}, bch{bc + bcidx * Q * N, N};
  for (int n0 = 0; n0 < N; n0 += kK) {
    __syncthreads();
    stage_t(sa, i0, Q, n0, N, cch);
    stage_t(sb, j0, Q, n0, N, bch);
    __syncthreads();
    fma_step<4>(cb, sa, kLDT, sb, kLDT, ty, tx);
  }
  if (split == 0) {
    float* cbt = cbs + (bcidx * QP + i0 + 4 * ty) * QP + j0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(cbt + r * QP) = make_float4(cb[r][0], cb[r][1], cb[r][2], cb[r][3]);
  }

  float dcb[4][4] = {};
  for (int h = split * hps; h < h_end; ++h) {
    const int64_t bch_h = bcidx * H + h;
    const Rows dyh{dy + bch_h * Q * P, P}, xh{xdt + bch_h * Q * P, P};
    float dw[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += kK) {
      __syncthreads();
      stage_t(sa, i0, Q, p0, P, dyh);
      stage_t(sb, j0, Q, p0, P, xh);
      __syncthreads();
      fma_step<4>(dw, sa, kLDT, sb, kLDT, ty, tx);
    }
    const float* ah = acum + bch_h * Q;
    float aj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + 4 * tx + c;
      aj[c] = gj < Q ? ah[gj] : 0.f;
    }
    float rs[4], cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = i0 + 4 * ty + r;
      const float ai = gi < Q ? ah[gi] : 0.f;
      rs[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gj = j0 + 4 * tx + c;
        float g = 0.f;
        if (gi < Q && gj <= gi) {
          const float l = expf(__fsub_rn(ai, aj[c]));
          dcb[r][c] = fmaf(dw[r][c], l, dcb[r][c]);
          g = __fmul_rn(dw[r][c], __fmul_rn(cb[r][c], l));
        }
        rs[r] = __fadd_rn(rs[r], g);
        cs[c] = __fadd_rn(cs[c], g);
      }
    }
    // Row sums over the tile's 64 keys: the 16 lanes of one ty, in a fixed
    // butterfly order.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], off));
    }
    if (tx == 0) {
      *reinterpret_cast<float4*>(rowp + (bch_h * T + jt) * QP + i0 + 4 * ty) =
          make_float4(rs[0], rs[1], rs[2], rs[3]);
    }
    // Column sums over the tile's 64 rows: the 16 values of ty in order.
    *reinterpret_cast<float4*>(red + ty * kT + 4 * tx) = make_float4(cs[0], cs[1], cs[2], cs[3]);
    __syncthreads();
    if (threadIdx.x < kT) {
      float s = 0.f;
      for (int y = 0; y < 16; ++y) s = __fadd_rn(s, red[y * kT + threadIdx.x]);
      colp[(bch_h * T + it) * QP + j0 + threadIdx.x] = s;
    }
  }
  float* dcbt = dcbs + split * split_stride + (bcidx * QP + i0 + 4 * ty) * QP + j0 + 4 * tx;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(dcbt + r * QP) =
        make_float4(dcb[r][0], dcb[r][1], dcb[r][2], dcb[r][3]);
}

// Block (jt, b * NC * H + c * H + h) of kernel 2: dXdt_h for keys [jt * 64,
// jt * 64 + 64), PT columns (P rounded up to 16, 32, 64 or 128).
template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dxdt_kernel(
    const float* __restrict__ cbs, const float* __restrict__ acum, const float* __restrict__ dy,
    float* __restrict__ dxdt, int Q, int H, int P, int QP, int T, int64_t heads_total) {
  constexpr int NCOL = PT / 16;
  __shared__ __align__(16) float sw[kK * kT];  // W rows (the summed axis) x 64 keys
  __shared__ __align__(16) float sy[kK * PT];  // dY rows x PT columns
  const int jt = static_cast<int>(blockIdx.x / heads_total);  // longest walk first
  const int64_t bch_h = blockIdx.x - static_cast<int64_t>(jt) * heads_total;
  const int64_t bcidx = bch_h / H;
  const int j0 = jt * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* ah = acum + bch_h * Q;
  const Rows dyh{dy + bch_h * Q * P, P};
  const float* cbb = cbs + bcidx * QP * QP;

  float acc[4][NCOL] = {};
  for (int r0 = j0; r0 < Q; r0 += kK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kK * kT; e += kThreads) {
      const int k = e / kT, j = e - (e / kT) * kT;
      const int gi = r0 + k, gj = j0 + j;
      float w = 0.f;
      if (gi < Q && gj <= gi)
        w = __fmul_rn(cbb[static_cast<int64_t>(gi) * QP + gj], expf(__fsub_rn(ah[gi], ah[gj])));
      sw[e] = w;
    }
    stage_n(sy, PT, r0, Q, 0, P, dyh);
    __syncthreads();
    fma_step<NCOL>(acc, sw, kT, sy, PT, ty, tx);
  }
  float* out = dxdt + bch_h * Q * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gj = j0 + 4 * ty + r;
    if (gj >= Q) continue;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int p = NCOL * tx + c;
      if (p < P) out[static_cast<int64_t>(gj) * P + p] = acc[r][c];
    }
  }
}

// dCB[i, j] of chunk bcidx: its head-split partials summed in split order.
struct SplitSum {
  const float* dcbs;
  int64_t stride, width;
  int splits;
  __device__ __forceinline__ float operator()(int r, int c) const {
    float s = dcbs[r * width + c];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, dcbs[k * stride + r * width + c]);
    return s;
  }
};

// Block (b * NC + c, row tile it, state-column chunk nk) of kernel 3.
__global__ void __launch_bounds__(kThreads) ssd_bwd_dcdb_kernel(
    const float* __restrict__ cc, const float* __restrict__ bc, const float* __restrict__ dcbs,
    const float* __restrict__ rowp, const float* __restrict__ colp, float* __restrict__ dcc,
    float* __restrict__ dbc, float* __restrict__ dacum, int Q, int N, int H, int QP, int T,
    int nchunks, int splits, int64_t split_stride) {
  __shared__ __align__(16) float sa[kK * kLDT];
  __shared__ __align__(16) float sb[kK * kT];
  const int per_bc = T * nchunks;
  const int64_t bcidx = blockIdx.x / per_bc;
  const int rest = static_cast<int>(blockIdx.x - bcidx * per_bc);
  const int it = rest / nchunks, nk = rest - (rest / nchunks) * nchunks;
  const int i0 = it * kT, n0 = nk * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const Rows cch{cc + bcidx * Q * N, N}, bch{bc + bcidx * Q * N, N};
  const SplitSum dcb{dcbs + bcidx * QP * QP, split_stride, QP, splits};

  // dC[i, n] = sum_{j <= i} dCB[i, j] B[j, n], keys of the tiles jt <= it.
  float acc[4][4] = {};
  for (int k0 = 0; k0 < i0 + kT && k0 < Q; k0 += kK) {
    __syncthreads();
    stage_t(sa, i0, QP, k0, QP, dcb);
    stage_n(sb, kT, k0, Q, n0, N, bch);
    __syncthreads();
    fma_step<4>(acc, sa, kLDT, sb, kT, ty, tx);
  }
  float* out = dcc + bcidx * Q * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (gi < Q && n < N) out[static_cast<int64_t>(gi) * N + n] = acc[r][c];
      acc[r][c] = 0.f;
    }
  }
  // dB[j, n] = sum_{i >= j} dCB[i, j] C[i, n] for the keys j of tile it.
  for (int k0 = i0; k0 < Q; k0 += kK) {
    __syncthreads();
    stage_n(sa, kT, k0, QP, i0, QP, [&](int r, int c) { return dcb(r, c); });
    stage_n(sb, kT, k0, Q, n0, N, cch);
    __syncthreads();
    fma_step<4>(acc, sa, kT, sb, kT, ty, tx);
  }
  out = dbc + bcidx * Q * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gj = i0 + 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (gj < Q && n < N) out[static_cast<int64_t>(gj) * N + n] = acc[r][c];
    }
  }
  if (nk != 0) return;
  // dacum_h[i] = sum_j G_h[i, j] - sum_k G_h[k, i]: the row partials of the
  // key tiles jt <= it, less the column partials of the row tiles it' >= it.
  for (int e = threadIdx.x; e < H * kT; e += kThreads) {
    const int h = e / kT, gi = i0 + e - (e / kT) * kT;
    if (gi >= Q) continue;
    const int64_t bch_h = bcidx * H + h;
    float s = 0.f, t = 0.f;
    for (int jt = 0; jt <= it; ++jt) s = __fadd_rn(s, rowp[(bch_h * T + jt) * QP + gi]);
    for (int i2 = it; i2 < T; ++i2) t = __fadd_rn(t, colp[(bch_h * T + i2) * QP + gi]);
    dacum[bch_h * Q + gi] = __fsub_rn(s, t);
  }
}

template <int PT>
cudaError_t launch_dxdt(const float* cbs, const float* acum, const float* dy, float* dxdt,
                        int B, int NC, int Q, int H, int P, int QP, int T,
                        cudaStream_t stream) {
  const int64_t heads_total = static_cast<int64_t>(B) * NC * H;
  ssd_bwd_dxdt_kernel<PT><<<static_cast<unsigned>(heads_total * T), kThreads, 0, stream>>>(
      cbs, acum, dy, dxdt, Q, H, P, QP, T, heads_total);
  return cudaGetLastError();
}

}  // namespace

// All arrays contiguous f32: cc, bc, dcc, dbc [B, NC, Q, N]; xdt, dy, dxdt
// [B, NC, H, Q, P]; acum, dacum [B, NC, H, Q]. Scratch (the wrapper
// allocates it): cb of B * NC * QP * QP floats, dcb of splits times that,
// rowp and colp of B * NC * H * T * QP floats each (T = QP / 64 tiles, QP =
// Q rounded up to 64). Kernel 1's blocks each walk ceil(H / splits) heads.
// The wrapper checks Q <= 256, P <= 128, N > 0 and 1 <= splits <= H.
extern "C" int ample_ssd_intra_chunk_bwd(int device, const float* cc, const float* bc,
                                         const float* xdt, const float* acum, const float* dy,
                                         float* dcc, float* dbc, float* dxdt, float* dacum,
                                         float* cb, float* dcb, float* rowp, float* colp,
                                         int B, int NC, int Q, int N, int H, int P, int splits,
                                         void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || NC == 0 || Q == 0 || H == 0 || P == 0) return 0;
  if (Q > 256 || P > 128 || N <= 0 || splits < 1 || splits > H)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (Q + kT - 1) / kT;
  const int QP = T * kT;
  const int pairs = T * (T + 1) / 2;
  const int nchunks = (N + kT - 1) / kT;
  const int hps = (H + splits - 1) / splits;
  const int64_t split_stride = static_cast<int64_t>(B) * NC * QP * QP;
  const int64_t blocks1 = static_cast<int64_t>(B) * NC * pairs * splits;
  const int64_t blocks2 = static_cast<int64_t>(B) * NC * H * T;
  const int64_t blocks3 = static_cast<int64_t>(B) * NC * T * nchunks;
  if (blocks1 > 0x7fffffff || blocks2 > 0x7fffffff || blocks3 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_dcb_kernel<<<static_cast<unsigned>(blocks1), kThreads, 0, stream>>>(
      cc, bc, xdt, acum, dy, cb, dcb, rowp, colp, Q, N, H, P, QP, T, pairs, splits, hps,
      split_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P <= 16) err = launch_dxdt<16>(cb, acum, dy, dxdt, B, NC, Q, H, P, QP, T, stream);
  else if (P <= 32) err = launch_dxdt<32>(cb, acum, dy, dxdt, B, NC, Q, H, P, QP, T, stream);
  else if (P <= 64) err = launch_dxdt<64>(cb, acum, dy, dxdt, B, NC, Q, H, P, QP, T, stream);
  else err = launch_dxdt<128>(cb, acum, dy, dxdt, B, NC, Q, H, P, QP, T, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcdb_kernel<<<static_cast<unsigned>(blocks3), kThreads, 0, stream>>>(
      cc, bc, dcb, rowp, colp, dcc, dbc, dacum, Q, N, H, QP, T, nchunks, splits, split_stride);
  return static_cast<int>(cudaGetLastError());
}
