// The tile walk of the AGE (segment_agg.cu); attn_agg.cu shares its helpers
// and its split-node combine.
//
// Over the planner's edge tiles (gather_idx, seg_ids: [T, E]; out_node:
// [T, S]), x is [N, heads * dh] and each lane carries one weight per head,
// [T, E, heads] (the AGE is heads = 1, dh = D). The plan orders each tile's
// lanes by segment (a segment is a contiguous run, padding lanes last with
// weight 0), and a node spans several tiles only when it was split, as the
// first or last segment of a tile. The split map (computed once per plan on
// the host) gives each segment of a split node a compact partial row
// (slot_of >= 0) and -1 to every other segment.
//
//   tile_heads_kernel (one block per tile, blockIdx.y picks a column block)
//     stages the tile's indices and its [E, heads] lane weights in shared
//     memory (the TPU's scalar prefetch). Then the threads stride over the
//     columns and walk the lanes in order with a running sum per column held
//     in registers, loading the rows of kBatch lanes ahead of the sums so that
//     several row loads are in flight. A finished segment whose node lives in
//     this tile only is final; a split segment writes its partial row.
//   combine_sum_kernel (one block per split node) sums that node's partial
//     rows in tile order.
//
// No atomics: results are the same from run to run, which warm == cold
// serving relies on. Sums use __fmul_rn/__fadd_rn (no FMA contraction), the
// order of the plain PyTorch versions on the CPU. A lane is skipped for a
// column whose head weight is 0: for finite x it adds exactly +-0.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads of a block; they stride over columns
constexpr int kBatch = 8;      // lanes whose rows are loaded before being summed

__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Write one finished segment's column sums: to its partial row when its node
// is split across tiles, else to the node's output row.
template <int CPT>
__device__ __forceinline__ void flush_segment(
    int s, const float (&acc)[CPT], const int* s_node, const int* s_slot,
    float* __restrict__ part_a, float* __restrict__ out, int col0, int d,
    int num_nodes) {
  const int node = s_node[s];
  if (node >= num_nodes) return;  // sentinel: unused segment
  const int slot = s_slot[s];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = col0 + c * kThreads;
    if (col >= d) continue;
    if (slot >= 0) {
      part_a[static_cast<int64_t>(slot) * d + col] = acc[c];
    } else {
      out[static_cast<int64_t>(node) * d + col] = acc[c];
    }
  }
}

// CPT = columns per thread; a block covers kThreads * CPT columns; the lane
// weights are coeff [T, E, heads] as given.
template <int CPT>
__global__ void __launch_bounds__(kThreads) tile_heads_kernel(
    const float* __restrict__ x, const int* __restrict__ gather_idx,
    const float* __restrict__ coeff, const int* __restrict__ seg_ids,
    const int* __restrict__ out_node, const int* __restrict__ slot_of,
    float* __restrict__ part_a, float* __restrict__ out, int lanes, int segs,
    int heads, int dh, int num_nodes) {
  extern __shared__ int smem[];
  int* s_idx = smem;
  int* s_seg = s_idx + lanes;
  int* s_node = s_seg + lanes;
  int* s_slot = s_node + segs;
  float* s_w = reinterpret_cast<float*>(s_slot + segs);  // [E, H]

  const int64_t t = blockIdx.x;
  const int d = heads * dh;
  const int lh = lanes * heads;
  for (int i = threadIdx.x; i < lanes; i += kThreads) {
    s_idx[i] = gather_idx[t * lanes + i];
    s_seg[i] = seg_ids[t * lanes + i];
  }
  for (int i = threadIdx.x; i < segs; i += kThreads) {
    s_node[i] = out_node[t * segs + i];
    s_slot[i] = slot_of[t * segs + i];
  }
  for (int i = threadIdx.x; i < lh; i += kThreads) s_w[i] = coeff[t * lh + i];
  __syncthreads();

  const int col0 = blockIdx.y * (kThreads * CPT) + threadIdx.x;
  int head[CPT];
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = col0 + c * kThreads;
    head[c] = col < d ? col / dh : 0;
    acc[c] = 0.f;
  }
  int cur = s_seg[0];

  for (int e0 = 0; e0 < lanes; e0 += kBatch) {
    float v[kBatch][CPT];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b;
      const float* row = x + static_cast<int64_t>(e < lanes ? s_idx[e] : 0) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = col0 + c * kThreads;
        const bool live = e < lanes && col < d && s_w[e * heads + head[c]] != 0.f;
        v[b][c] = live ? __ldg(row + col) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b;
      if (e < lanes) {
        const int s = s_seg[e];
        if (s != cur) {
          flush_segment<CPT>(cur, acc, s_node, s_slot, part_a, out, col0, d, num_nodes);
          cur = s;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float w = s_w[e * heads + head[c]];
          if (w != 0.f) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[b][c]));
        }
      }
    }
  }
  flush_segment<CPT>(cur, acc, s_node, s_slot, part_a, out, col0, d, num_nodes);
}

__global__ void __launch_bounds__(kThreads) combine_sum_kernel(
    const float* __restrict__ part_a, const int* __restrict__ split_ptr,
    const int* __restrict__ split_node, float* __restrict__ out, int d) {
  const int i = blockIdx.x;
  const int lo = split_ptr[i];
  const int hi = split_ptr[i + 1];
  float* dst = out + static_cast<int64_t>(split_node[i]) * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float acc = 0.f;
    for (int k = lo; k < hi; ++k)
      acc = __fadd_rn(acc, part_a[static_cast<int64_t>(k) * d + col]);
    dst[col] = acc;
  }
}

// Launch tile_heads_kernel over num_tiles tiles with as many columns per
// thread as heads * dh needs (at most 4; more columns take more blocks).
// Shared memory: (2 * lanes + 2 * segs + lanes * heads) * 4 bytes.
inline int launch_tiles(cudaStream_t stream, const float* x, const int* gather_idx,
                        const float* coeff, const int* seg_ids, const int* out_node,
                        const int* slot_of, float* part_a, float* out, int num_tiles,
                        int lanes, int segs, int heads, int dh, int num_nodes) {
  const int d = heads * dh;
  const int cpt = d <= kThreads ? 1 : d <= 2 * kThreads ? 2
                : d <= 3 * kThreads ? 3 : 4;
  const int per_block = kThreads * cpt;
  const dim3 grid(num_tiles, (d + per_block - 1) / per_block);
  const size_t smem = static_cast<size_t>(2 * lanes + 2 * segs + lanes * heads) * 4;
#define AMPLE_LAUNCH(C)                                                        \
  tile_heads_kernel<C><<<grid, kThreads, smem, stream>>>(                      \
      x, gather_idx, coeff, seg_ids, out_node, slot_of, part_a, out, lanes,    \
      segs, heads, dh, num_nodes)
  switch (cpt) {
    case 1: AMPLE_LAUNCH(1); break;
    case 2: AMPLE_LAUNCH(2); break;
    case 3: AMPLE_LAUNCH(3); break;
    default: AMPLE_LAUNCH(4);
  }
#undef AMPLE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
