// Multi-head GAT aggregation for Hopper: the fused attention layer and the
// per-head weighted AGE.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/segment_agg/attn_kernel.py::fused_attention_tiles (_fused_kernel)
//   repro/kernels/segment_agg/attn_kernel.py::gather_weighted_tiles_mh (_mh_kernel)
// together with their cross-tile combines in
//   repro/kernels/segment_agg/attn_ops.py (combine_attention, and the
//   scatter-add of aggregate_tiles_mh).
//
// x is head-packed, [N, H * dh] as the FTE wrote it (no padding of dh: the
// TPU padded each head to 128 lanes for its vector unit). Over the planner's
// edge tiles (gather_idx, seg_ids: [T, E]; out_node: [T, S]):
//   attention: per destination segment and head, softmax over the segment's
//     lanes of LeakyReLU(scores[t, e, h]) (padding lanes are -inf), times the
//     static lane coeff, applied to x[gather_idx, h, :];
//   mh:        per destination segment, sum of coeff[t, e, h] * x[idx, h, :].
//
// What bounds them on an H100: device-memory bytes, as for the AGE
// (segment_agg.cu): each live lane gathers one row of H * dh floats and does
// about 2 flops per float, plus H exps per lane for attention.
//
// Design. The TPU kernel writes per-tile partials (m, l, a) of shape
// [T, S, H * dhp]: 30 GB per layer call at Yelp scale, nearly all of it
// unused segments. Here both kernels are the tile walk of tile_walk.cuh (one
// block per tile; the split map sends a node that lives in one tile straight
// to its row and a split node's segments to compact partial rows): mh with
// the lane weights as given, attention with the tile-local softmax of the
// scores (kAttn). One block per split node then combines its partial rows in
// tile order: the sum for mh; for attention the log-sum-exp rescale
// M = max m (0 if no row is finite), L = sum l * exp(m - M),
// A = sum a * exp(m - M), out = A / L.
#include "tile_walk.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) combine_attention_kernel(
    const float* __restrict__ part_a, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int* __restrict__ split_ptr,
    const int* __restrict__ split_node, float* __restrict__ out, int heads,
    int dh) {
  const int i = blockIdx.x;
  const int lo = split_ptr[i];
  const int hi = split_ptr[i + 1];
  const int d = heads * dh;
  float* dst = out + static_cast<int64_t>(split_node[i]) * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    const int h = col / dh;
    float big_m = neg_inf();
    for (int k = lo; k < hi; ++k)
      big_m = fmaxf(big_m, part_m[static_cast<int64_t>(k) * heads + h]);
    if (!finite(big_m)) big_m = 0.f;
    float big_l = 0.f, big_a = 0.f;
    for (int k = lo; k < hi; ++k) {
      // a row with m = -inf (an empty segment) gets scale 0 and vanishes
      const float scale = expf(part_m[static_cast<int64_t>(k) * heads + h] - big_m);
      big_l = __fadd_rn(big_l, __fmul_rn(part_l[static_cast<int64_t>(k) * heads + h], scale));
      big_a = __fadd_rn(big_a, __fmul_rn(part_a[static_cast<int64_t>(k) * d + col], scale));
    }
    dst[col] = __fdiv_rn(big_a, big_l > 0.f ? big_l : 1.f);
  }
}

}  // namespace

// out must be zero-filled by the caller (rows no segment maps to stay 0);
// part_a holds split_ptr[n_split] rows of heads * dh floats, part_m and
// part_l as many rows of heads floats. The wrapper checks that
// (2 * lanes + 2 * segs + lanes * heads + segs * heads) * 4 bytes fit the
// 48 KB of shared memory a block gets without opting in.
extern "C" int ample_attention(int device, const float* x,
                               const int* gather_idx, const float* scores,
                               const float* coeff, const int* seg_ids,
                               const int* out_node, const int* slot_of,
                               const int* split_ptr, const int* split_node,
                               float* part_a, float* part_m, float* part_l,
                               float* out, int num_tiles, int lanes, int segs,
                               int heads, int dh, int n_split, int num_nodes,
                               float slope, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (num_tiles > 0 && heads * dh > 0) {
    const int status = launch_tiles<true>(
        stream, x, gather_idx, scores, coeff, seg_ids, out_node, slot_of,
        part_a, part_m, part_l, out, num_tiles, lanes, segs, heads, dh,
        num_nodes, slope);
    if (status != 0) return status;
  }
  if (n_split > 0 && heads * dh > 0) {
    combine_attention_kernel<<<n_split, kThreads, 0, stream>>>(
        part_a, part_m, part_l, split_ptr, split_node, out, heads, dh);
  }
  return static_cast<int>(cudaGetLastError());
}

// As ample_attention, with coeff [T, E, heads] and no scores, m or l; the
// shared memory is (2 * lanes + 2 * segs + lanes * heads) * 4 bytes.
extern "C" int ample_segment_agg_mh(int device, const float* x,
                                    const int* gather_idx, const float* coeff,
                                    const int* seg_ids, const int* out_node,
                                    const int* slot_of, const int* split_ptr,
                                    const int* split_node, float* part_a,
                                    float* out, int num_tiles, int lanes,
                                    int segs, int heads, int dh, int n_split,
                                    int num_nodes, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (num_tiles > 0 && heads * dh > 0) {
    const int status = launch_tiles<false>(
        stream, x, gather_idx, nullptr, coeff, seg_ids, out_node, slot_of,
        part_a, nullptr, nullptr, out, num_tiles, lanes, segs, heads, dh,
        num_nodes, 0.f);
    if (status != 0) return status;
  }
  if (n_split > 0 && heads * dh > 0) {
    combine_sum_kernel<<<n_split, kThreads, 0, stream>>>(part_a, split_ptr,
                                                         split_node, out,
                                                         heads * dh);
  }
  return static_cast<int>(cudaGetLastError());
}
