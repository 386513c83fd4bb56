// int8 FTE (Feature Transformation Engine) for Hopper: int8 x int8 -> int32.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/quant_matmul/repack.py::_repacked_call (_kernel) and
//   repro/kernels/quant_matmul/quant_matmul.py::quant_matmul_kernel_call
// which compute the same product, from a tiled and from a plain weight.
//
// Computes out[M, N] = a[M, K] @ w[K, N] with exact int32 accumulation, bitwise
// equal to the reference (integer sums do not depend on order). No overflow is
// possible for K <= 131071, since K * 128 * 128 < 2^31.
//
// What bounds it on an H100: device-memory bytes at the serving shapes. For
// the Yelp int8 group (M = 695,342, K = 300, N = 256) the int32 output alone is
// 712 MB against 107 G int8 operations, about 115 operations per byte, below
// the ~590 operations per byte at which the int8 tensor cores would bound it.
//
// Design (a simple first kernel): the weight is relaid once at load time
// (repack.py) as w[N, Kp], K contiguous and zero-padded to a multiple of 16, so
// a block reads it with 16-byte loads. Each block computes a 64 x 64 output
// tile with 256 threads, 4 x 4 outputs per thread; K is staged through shared
// memory 64 bytes at a time as packed int8x4 words, and each thread multiplies
// with __dp4a into int32 registers. The ragged K edge of the activations
// (K = 300 is not a multiple of 64) is masked to 0 as it is loaded. The
// tensor cores (mma.sync / wgmma) and cp.async staging are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 64;   // K bytes per shared-memory stage
constexpr int kKW = kBK / 4;  // int8x4 words per stage
constexpr int kThreads = 256;

// kWordA: a's rows are 4-byte aligned (K % 4 == 0 and an aligned base), so
// a is read as int32 words; otherwise byte by byte.
template <bool kWordA>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ w,
    int32_t* __restrict__ out, int m, int k, int n, int kp) {
  __shared__ int32_t As[kKW][kBM + 1];
  __shared__ int32_t Bs[kKW][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A stage: 64 rows x 16 words, 4 words a thread, a row's words adjacent.
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kKW;
      const int wd = idx % kKW;
      const int64_t row = m0 + r;
      const int kk = k0 + 4 * wd;
      int32_t word = 0;
      if (row < m) {
        const int8_t* p = a + row * k + kk;
        if (kWordA) {
          if (kk < k) word = *reinterpret_cast<const int32_t*>(p);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (kk + j < k)
              word |= (static_cast<int32_t>(p[j]) & 0xff) << (8 * j);
        }
      }
      As[wd][r] = word;
    }
    // B stage: 64 columns x 64 bytes, one 16-byte load a thread.
    {
      const int c = tid / 4;
      const int q = tid % 4;
      const int64_t col = n0 + c;
      const int kk = k0 + 16 * q;
      int4 v = make_int4(0, 0, 0, 0);
      if (col < n && kk < kp)
        v = *reinterpret_cast<const int4*>(w + col * kp + kk);
      Bs[4 * q + 0][c] = v.x;
      Bs[4 * q + 1][c] = v.y;
      Bs[4 * q + 2][c] = v.z;
      Bs[4 * q + 3][c] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = n0 + tx + 16 * j;
      if (col < n) out[row * n + col] = acc[i][j];
    }
  }
}

}  // namespace

// a: int8[m, k] row-major; w: int8[n, kp] row-major (kp % 16 == 0, kp >= k,
// zeros past k, 16-byte aligned); out: int32[m, n].
extern "C" int ample_quant_matmul(int device, const int8_t* a, const int8_t* w,
                                  int32_t* out, int m, int k, int n, int kp,
                                  void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  const bool word_a = (k % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0);
  if (word_a)
    quant_matmul_kernel<true><<<grid, kThreads, 0, stream>>>(a, w, out, m, k, n, kp);
  else
    quant_matmul_kernel<false><<<grid, kThreads, 0, stream>>>(a, w, out, m, k, n, kp);
  return static_cast<int>(cudaGetLastError());
}
