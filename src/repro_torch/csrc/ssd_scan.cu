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
// log-decay a) and out f32 [B, NC, H, Q, P]. Everything is f32 on the CUDA
// cores: TF32 tensor cores would change the numbers.
//
// What bounds it on an H100: operations. At the Mamba2-370M prefill (B 4,
// NC 8, Q 256, N 128, H 32, P 64) the lower triangle needs 4.6 GFLOP against
// 143.5 MB of inputs and output, ~32 flops per byte.
//
// Design: the TPU grid (B, NC, H) recomputes C B^T for every head. Here one
// block of 256 threads takes 64 rows i of one chunk and a group of up to
// kHeads heads: it computes its rows of C B^T once, for the keys j up to the
// tile's last row only (the rest is masked), into shared memory, N in steps
// of 32; then for each head it builds the decay-masked weights of one block
// of 64 keys at a time (one exp per (i, j)) and multiplies them with that
// block of Xdt, each thread holding 4 rows x PT/16 columns of Y in
// registers. Row tiles run longest first. No atomics: the result is the same
// from run to run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // rows i per block, and keys j per step
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 rows, tx 4 keys / columns
constexpr int kNStep = 32;     // state columns staged per step of C B^T
constexpr int kLDN = kNStep + 1;  // odd stride: 16 rows of a half warp, 16 banks
constexpr int kLDW = kRows + 4;   // weights' row stride (conflict-free writes)
constexpr int kHeads = 8;      // heads per block

__host__ __device__ constexpr int cb_stride(int qp) { return qp + 4; }

template <int PT>
__host__ __device__ constexpr int scratch_floats() {
  // phase 1: C and B steps; phase 2: the weights and one block of Xdt
  return (2 * kRows * kLDN > kRows * kLDW + kRows * PT) ? 2 * kRows * kLDN
                                                        : kRows * kLDW + kRows * PT;
}

template <int PT>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const float* __restrict__ cc, const float* __restrict__ bc,
    const float* __restrict__ xdt, const float* __restrict__ acum,
    float* __restrict__ out, int Q, int N, int H, int P, int QP) {
  constexpr int NC = PT / 16;  // output columns per thread
  extern __shared__ float smem[];
  const int ldc = cb_stride(QP);
  float* cbs = smem;                  // [kRows][ldc]: rows i0.., keys 0..
  float* as = cbs + kRows * ldc;      // [QP]: a of the current head
  float* scratch = as + QP;
  float* ct = scratch;                // phase 1: [kRows][kLDN] C rows
  float* bt = scratch + kRows * kLDN; //          [kRows][kLDN] B rows
  float* ws = scratch;                // phase 2: [kRows][kLDW] weights
  float* xs = scratch + kRows * kLDW; //          [kRows][PT] Xdt rows

  const int it = gridDim.x - 1 - blockIdx.x;  // longest row tiles first
  const int i0 = it * kRows;
  const long bcidx = blockIdx.y;  // b * NC + c
  const int h0 = blockIdx.z * kHeads;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* cch = cc + bcidx * Q * N;
  const float* bch = bc + bcidx * Q * N;

  // ---- C B^T for rows [i0, i0 + 64) and keys [0, i0 + 64)
  for (int jb = 0; jb <= it; ++jb) {
    const int j0 = jb * kRows;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNStep) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kRows * kNStep; idx += kThreads) {
        const int r = idx / kNStep, n = n0 + idx % kNStep;
        const bool nok = n < N;
        ct[r * kLDN + idx % kNStep] = (i0 + r < Q && nok) ? cch[(i0 + r) * N + n] : 0.f;
        bt[r * kLDN + idx % kNStep] = (j0 + r < Q && nok) ? bch[(j0 + r) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < kNStep; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ct[(ty * 4 + i) * kLDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bt[(tx + 16 * j) * kLDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cbs[(ty * 4 + i) * ldc + j0 + tx + 16 * j] = s[i][j];
  }

  // ---- per head: Y = (C B^T o L) @ Xdt over the key blocks up to the diagonal
  const int h_end = min(H, h0 + kHeads);
  for (int h = h0; h < h_end; ++h) {
    const long bch_h = bcidx * H + h;
    const float* ah = acum + bch_h * Q;
    const float* xh = xdt + bch_h * Q * P;
    __syncthreads();  // C B^T written; the previous head's scratch consumed
    for (int j = threadIdx.x; j < min(Q, i0 + kRows); j += kThreads) as[j] = ah[j];
    float y[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) y[i][c] = 0.f;
    for (int jb = 0; jb <= it; ++jb) {
      const int j0 = jb * kRows;
      __syncthreads();  // a staged; the previous block's weights consumed
      for (int idx = threadIdx.x; idx < kRows * PT; idx += kThreads) {
        const int r = idx / PT, p = idx % PT;
        xs[idx] = (j0 + r < Q && p < P) ? xh[(j0 + r) * P + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, gi = i0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, gj = j0 + c;
          float w = 0.f;
          if (gi < Q && gj <= gi) w = cbs[r * ldc + gj] * expf(as[gi] - as[gj]);
          ws[r * kLDW + c] = w;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kRows; ++j) {
        float xv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) xv[c] = xs[j * PT + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = ws[(ty * 4 + i) * kLDW + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) y[i][c] = fmaf(w, xv[c], y[i][c]);
        }
      }
    }
    float* oh = out + bch_h * Q * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + ty * 4 + i;
      if (gi >= Q) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int p = tx + 16 * c;
        if (p < P) oh[gi * P + p] = y[i][c];
      }
    }
  }
}

template <int PT>
int launch(const float* cc, const float* bc, const float* xdt, const float* acum,
           float* out, int B, int NC, int Q, int N, int H, int P, cudaStream_t stream) {
  const int tiles = (Q + kRows - 1) / kRows;
  const int qp = tiles * kRows;
  const int bytes = (kRows * cb_stride(qp) + qp + scratch_floats<PT>()) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, B * NC, (H + kHeads - 1) / kHeads);
  ssd_kernel<PT><<<grid, kThreads, bytes, stream>>>(cc, bc, xdt, acum, out, Q, N, H, P, qp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All arrays contiguous f32. The wrapper checks Q <= 256 and P <= 128.
extern "C" int ample_ssd_intra_chunk(int device, const float* cc, const float* bc,
                                     const float* xdt, const float* acum, float* out,
                                     int B, int NC, int Q, int N, int H, int P,
                                     void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || NC == 0 || Q == 0 || H == 0 || P == 0) return 0;
  if (P <= 16) return launch<16>(cc, bc, xdt, acum, out, B, NC, Q, N, H, P, stream);
  if (P <= 32) return launch<32>(cc, bc, xdt, acum, out, B, NC, Q, N, H, P, stream);
  if (P <= 64) return launch<64>(cc, bc, xdt, acum, out, B, NC, Q, N, H, P, stream);
  return launch<128>(cc, bc, xdt, acum, out, B, NC, Q, N, H, P, stream);
}
