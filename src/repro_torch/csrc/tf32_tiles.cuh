// The TF32 tensor-core building blocks shared by the SSD intra-chunk forward
// (ssd_scan.cu, ssd_cb_kernel and ssd_tc_kernel) and its backward
// (ssd_scan_bwd.cu): cp.async staging of row tiles of f32 arrays into shared
// memory, the split of an f32 operand into two TF32 terms, and the
// mma.sync.m16n8k8 step that keeps f32's precision with three products.
//
// Numbers: each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (cvt.rna; x - hi is exact in f32), and every product is three TF32
// products with f32 accumulation, the small terms first: lo*hi' + hi*lo' +
// hi*hi' (the dropped lo*lo' is ~2^-22 relative). The tensor cores truncate
// as they accumulate, so each 8-deep step's three products go into a fresh
// sum that a rounded f32 add then adds to the running sum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in two TF32 terms (x - hi is exact in f32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// The same split in two instructions, for kernels that need not match
// split's roundings: hi = x with its low 13 mantissa bits cleared, lo = x -
// hi (exact) handed to the tensor cores as it is (they read its TF32 bits,
// truncating). |lo| < 2^-10 |x|, so the dropped lo*lo' and lo's truncation
// stay ~2^-20 relative.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}
struct SplitRna {
  __device__ __forceinline__ void operator()(float x, uint32_t& hi, uint32_t& lo) const {
    split(x, hi, lo);
  }
};
struct SplitTrunc {
  __device__ __forceinline__ void operator()(float x, uint32_t& hi, uint32_t& lo) const {
    split_trunc(x, hi, lo);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 8-deep step of acc[nt] += A B_nt for NG 8-column tiles, A (16 x 8)
// given split, B_nt (8 x 8) fetched by load_b(nt, b0, b1) and split here
// by sp (SplitRna: split; SplitTrunc: split_trunc).
// Each tile's three products go into a fresh sum, the small terms first
// (lo*hi' + hi*lo' + hi*hi'), issued across the tiles so that consecutive
// mma are independent; the sum is then added to acc by a rounded f32 add.
// The tensor cores truncate as they accumulate: a fresh sum keeps that error
// relative to one step's products, not to the running sum.
template <int NG, typename LoadB, typename Split = SplitRna>
__device__ __forceinline__ void step3(float (&acc)[NG][4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], LoadB load_b, Split sp = Split()) {
  uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
  for (int nt = 0; nt < NG; ++nt) {
    float b0, b1;
    load_b(nt, b0, b1);
    sp(b0, bh[nt][0], bl[nt][0]);
    sp(b1, bh[nt][1], bl[nt][1]);
  }
  float t[NG][4];
#pragma unroll
  for (int nt = 0; nt < NG; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) t[nt][q] = 0.f;
    mma_tf32(t[nt], al, bh[nt][0], bh[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NG; ++nt) mma_tf32(t[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NG; ++nt) mma_tf32(t[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NG; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = __fadd_rn(acc[nt][q], t[nt][q]);
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + cols) of a row-major f32 array
// (rows_total rows of width floats, row_stride floats apart) into dst (row
// stride ld floats) by THREADS threads, zeros past rows_total and width.
// 16-byte copies when every row and column chunk is 16-byte aligned.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           int64_t row_stride, int r0, int rows_total, int c0,
                                           int cols, int width) {
  if ((width & 3) == 0 && (row_stride & 3) == 0 && (c0 & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = cols / 4;
    for (int q = threadIdx.x; q < ROWS * per_row; q += THREADS) {
      const int r = q / per_row, c = c0 + (q - r * per_row) * 4;
      const bool ok = r0 + r < rows_total && c < width;
      cp_async16(dst + r * ld + (c - c0), ok ? src + (r0 + r) * row_stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int q = threadIdx.x; q < ROWS * cols; q += THREADS) {
      const int r = q / cols, c = c0 + (q - r * cols);
      const bool ok = r0 + r < rows_total && c < width;
      cp_async4(dst + r * ld + (c - c0), ok ? src + (r0 + r) * row_stride + c : src, ok ? 4 : 0);
    }
  }
}

}  // namespace tf32
}  // namespace
