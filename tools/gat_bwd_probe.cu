// Stripped variants of the first GAT backward kernel (the warp-per-item
// design that src/repro_torch/csrc/attn_agg_bwd.cu replaced), for
// tools/gat_bwd_probe.py: the same C entry point, ample_attention_bwd, built
// with -DPROBE_STAGE=
//   0 gather: each lane's products summed into one register, no head
//     select, no butterfly, no per-edge operands; lanes < H write their sum;
//   1 select: the products added to their head's accumulator by the
//     8-way compare-select, no butterfly; lane h writes head h's partial;
//   2 dots: the butterflies too (the full dots), written as res_a, with no
//     per-edge operands (scores, coeff, lse) loaded and no expf;
//   3 full: the first design as it was.
// Its outputs are the full kernel's only at stage 3; the tool times the
// others and checks that they ran.
#ifndef PROBE_STAGE
#define PROBE_STAGE 3
#endif
#include "tile_walk.cuh"

namespace {

constexpr int kBwdWarps = 8;    // warps of a block, one destination row each
constexpr int kBwdHeads = 8;    // most heads a row may have
constexpr int kBwdElems = 16;   // most elements of a row a lane owns: rows of <= 512

// v summed over the warp in a fixed butterfly order; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kVec>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Add prod to the accumulator of head h (registers indexed at compile time).
__device__ __forceinline__ void add_head(float (&acc)[kBwdHeads], int h, float prod) {
#pragma unroll
  for (int k = 0; k < kBwdHeads; ++k)
    if (k == h) acc[k] += prod;
}

__device__ __forceinline__ float pick_head(const float (&acc)[kBwdHeads], int h) {
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < kBwdHeads; ++k)
    if (k == h) v = acc[k];
  return v;
}

// One edge's dot products with g_i, per head, summed over the warp (every
// lane gets them), for the chunks this lane owns of the source row src.
template <typename T, int kChunk, int kVec, int kPer>
__device__ __forceinline__ void edge_dots(const unsigned char* src, const float (&gv)[kPer][kVec],
                                          const int (&hd)[kPer][kVec], int lane, int chunks,
                                          int heads, float scale, float zero,
                                          float (&dot)[kBwdHeads]) {
#pragma unroll
  for (int h = 0; h < kBwdHeads; ++h) dot[h] = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      float xv[kVec];
      decode<T, kChunk, kVec>(load_raw<kChunk>(src + c * kChunk), xv, scale, zero);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
#if PROBE_STAGE == 0
        dot[0] += gv[k][j] * xv[j];
#else
        add_head(dot, hd[k][j], gv[k][j] * xv[j]);
#endif
      }
    }
  }
#if PROBE_STAGE >= 2
#pragma unroll
  for (int h = 0; h < kBwdHeads; ++h)
    if (h < heads) dot[h] = warp_sum(dot[h]);
#endif
}

// Two blocks an SM at least: without the hint ptxas spilled a few bytes in
// two of the eight instances (at 48 and 80 registers); with it none spills.
template <typename T, int kChunk, bool kAttn>
__global__ void __launch_bounds__(kBwdWarps * 32, 2) gat_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ qscale, const float* __restrict__ qzero,
    int ld, const float* __restrict__ g, const float* __restrict__ out,
    const float* __restrict__ lse, const float* __restrict__ scores,
    const float* __restrict__ coeff, const int* __restrict__ indices,
    const int* __restrict__ items, int num_items, float* __restrict__ res_a,
    float* __restrict__ res_b, int heads, int dh, float slope) {
  constexpr int kVec = kChunk / static_cast<int>(sizeof(T));  // elements of a chunk
  constexpr int kPer = kBwdElems / kVec;                      // chunks a lane owns at most
  const int item = blockIdx.x * kBwdWarps + static_cast<int>(threadIdx.x >> 5);
  if (item >= num_items) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int d = heads * dh;
  const int chunks = d / kVec;
  const int i = items[3 * item];
  const int e_lo = items[3 * item + 1];
  const int e_hi = items[3 * item + 2];
  float scale = 1.f, zero = 0.f;
  if constexpr (sizeof(T) == 1) {
    scale = *qscale;
    zero = *qzero;
  }

  // g_i in registers with each element's head, and D_i = g_i . out_i per
  // head (attention).
  float gv[kPer][kVec];
  int hd[kPer][kVec];
  float big_d[kBwdHeads];
#pragma unroll
  for (int h = 0; h < kBwdHeads; ++h) big_d[h] = 0.f;
  const float* g_row = g + static_cast<int64_t>(i) * d;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = lane + 32 * k;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      gv[k][j] = 0.f;
      hd[k][j] = (c * kVec + j) / dh;
    }
    if (c < chunks) {
      load_f32<kVec>(g_row + c * kVec, gv[k]);
      if constexpr (kAttn) {
        float ov[kVec];
        load_f32<kVec>(out + static_cast<int64_t>(i) * d + c * kVec, ov);
#pragma unroll
        for (int j = 0; j < kVec; ++j) add_head(big_d, hd[k][j], gv[k][j] * ov[j]);
      }
    }
  }
  if constexpr (kAttn) {
#pragma unroll
    for (int h = 0; h < kBwdHeads; ++h)
      if (h < heads) big_d[h] = warp_sum(big_d[h]);
  }

  // Lane h writes head h of edge e.
  auto write = [&](int e, const float (&dot)[kBwdHeads]) {
    if (lane >= heads) return;
    const int64_t at = static_cast<int64_t>(e) * heads + lane;
#if PROBE_STAGE < 3
    res_a[at] = PROBE_STAGE == 0 ? dot[0] : pick_head(dot, lane);
    return;
#endif
    const float c = coeff != nullptr ? coeff[e] : 1.f;
    const float v = pick_head(dot, lane);
    if constexpr (kAttn) {
      const float s = scores[at];
      const bool pos = s >= 0.f;
      const float p = expf((pos ? s : slope * s) - lse[static_cast<int64_t>(i) * heads + lane]);
      res_a[at] = p;
      res_b[at] = p * (c * v - pick_head(big_d, lane)) * (pos ? 1.f : slope);
    } else {
      res_a[at] = c * v;
    }
  };
  auto row_of = [&](int e) {
    return reinterpret_cast<const unsigned char*>(x + static_cast<int64_t>(indices[e]) * ld);
  };
  // Two edges at a time: both rows' loads are in flight together.
  int e = e_lo;
  for (; e + 1 < e_hi; e += 2) {
    float d0[kBwdHeads], d1[kBwdHeads];
    const unsigned char* s0 = row_of(e);
    const unsigned char* s1 = row_of(e + 1);
    edge_dots<T, kChunk, kVec, kPer>(s0, gv, hd, lane, chunks, heads, scale, zero, d0);
    edge_dots<T, kChunk, kVec, kPer>(s1, gv, hd, lane, chunks, heads, scale, zero, d1);
    write(e, d0);
    write(e + 1, d1);
  }
  if (e < e_hi) {
    float d0[kBwdHeads];
    edge_dots<T, kChunk, kVec, kPer>(row_of(e), gv, hd, lane, chunks, heads, scale, zero, d0);
    write(e, d0);
  }
}

template <typename T, int kChunk>
int launch_gat_bwd(int attn, const void* x, const float* qscale, const float* qzero, int ld,
                   const float* g, const float* out, const float* lse, const float* scores,
                   const float* coeff, const int* indices, const int* items, int num_items,
                   float* res_a, float* res_b, int heads, int dh, float slope,
                   cudaStream_t stream) {
  const int blocks = (num_items + kBwdWarps - 1) / kBwdWarps;
  const T* xt = static_cast<const T*>(x);
  if (attn)
    gat_bwd_kernel<T, kChunk, true><<<blocks, kBwdWarps * 32, 0, stream>>>(
        xt, qscale, qzero, ld, g, out, lse, scores, coeff, indices, items, num_items, res_a,
        res_b, heads, dh, slope);
  else
    gat_bwd_kernel<T, kChunk, false><<<blocks, kBwdWarps * 32, 0, stream>>>(
        xt, qscale, qzero, ld, g, out, lse, scores, coeff, indices, items, num_items, res_a,
        res_b, heads, dh, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The GAT backward over num_items work items, items [num_items, 3] of
// (destination, first edge, end edge) of the in-edge CSR whose sources are
// indices [E]. x: the forward's rows [N, heads *
// dh], f32 (elem_bytes 4) or int8 codes (elem_bytes 1, with device scalars
// qscale and qzero), ld elements apart; g (and out, attention): f32 [N, heads
// * dh] contiguous; lse f32 [N, heads]; scores raw f32 [E, heads]; coeff f32
// [E] or null (ones). attn 1: res_a = alpha, res_b = ds; attn 0: res_a = the
// coefficients' gradient (lse, scores, out and res_b unused). chunk_bytes:
// 16 (f32) or 4 (codes) when every row is 16-byte aligned (4-byte for codes)
// and heads * dh is a multiple of 4, else 4 (f32) or 1 (codes). Edges of
// other rows are not written. A call that does not fit (heads > 8, rows
// wider than 512 elements) is refused with cudaErrorInvalidValue.
extern "C" int ample_attention_bwd(int device, const void* x, int elem_bytes,
                                   const float* qscale, const float* qzero, int ld,
                                   const float* g, const float* out, const float* lse,
                                   const float* scores, const float* coeff, const int* indices,
                                   const int* items, int num_items,
                                   float* res_a, float* res_b, int heads, int dh,
                                   int chunk_bytes, int attn, float slope, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int d = heads * dh;
  const int vec = elem_bytes > 0 ? chunk_bytes / elem_bytes : 0;
  const bool ok = (vec == 4 || vec == 1) && dh > 0 && d % vec == 0 && d <= 32 * kBwdElems &&
                  heads > 0 && heads <= kBwdHeads && ld >= d &&
                  (elem_bytes == 1 ? qscale != nullptr && qzero != nullptr : elem_bytes == 4) &&
                  (!attn || (out != nullptr && lse != nullptr && scores != nullptr &&
                             res_b != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (num_items <= 0) return static_cast<int>(cudaGetLastError());
#define AMPLE_GAT_BWD(T, C)                                                                  \
  return launch_gat_bwd<T, C>(attn, x, qscale, qzero, ld, g, out, lse, scores, coeff, indices, \
                              items, num_items, res_a, res_b, heads, dh, slope, stream)
  if (elem_bytes == 4) {
    if (chunk_bytes == 16) AMPLE_GAT_BWD(float, 16);
    AMPLE_GAT_BWD(float, 4);
  }
  if (chunk_bytes == 4) AMPLE_GAT_BWD(int8_t, 4);
  AMPLE_GAT_BWD(int8_t, 1);
#undef AMPLE_GAT_BWD
}
