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
// Both run the tile walk of tile_walk.cuh (heads_walk_kernel, its design
// note is there) over head-packed rows [N, H * dh] (no padding of dh: the
// TPU padded each head to 128 lanes for its vector unit), f32 or int8 codes
// dequantized in registers, with per-edge operands [E_graph, H] read through
// the plan's edge ids:
//   attention (mode kAttn): per destination segment and head, softmax over
//     the segment's lanes of LeakyReLU(scores[edge_ids[t, e], h]) (padding
//     lanes are -inf), times the static lane coeff, applied to
//     x[gather_idx, h, :]; split nodes combined by the log-sum-exp rescale
//     below, M = max m (0 if no row is finite), L = sum l * exp(m - M),
//     A = sum a * exp(m - M), out = A / L;
//   mh (mode kValues): per destination segment, sum of coeff[t, e] *
//     values[edge_ids, h] * x[gather_idx, h, :] (coeff null: ones); split
//     nodes summed in tile order.
//
// What bounds them on an H100: device-memory bytes. Each live lane gathers
// one row of H * dh elements (4 bytes each as f32, 1 as int8 codes) and does
// about 2 flops per element, plus H exps per lane for attention.
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

// Fused GAT attention. x: [N, heads * dh] f32 (elem_bytes 4) or int8 codes
// (elem_bytes 1, with device scalars qscale and qzero), rows ld elements
// apart; scores: raw f32 [E_graph, heads]; gather_idx, edge_ids, seg_ids and
// coeff: [T, lanes]; out_node and slot_of: [T, segs]. The walk writes the
// rows of this plan's nodes into out and no other row; part_a holds
// split_ptr[n_split] rows of heads * dh floats, part_m and part_l as many
// rows of heads floats. The walk's geometry (chunk_bytes, groups,
// per_group, lanes_per_stage, threads, smem_bytes) comes from
// attn_ops.walk_geometry; a geometry that does not fit the call is refused
// with cudaErrorInvalidValue.
extern "C" int ample_attention(int device, const void* x, int elem_bytes, const float* qscale,
                               const float* qzero, int ld, const int* gather_idx,
                               const int* edge_ids,
                               const float* scores, const float* coeff, const int* seg_ids,
                               const int* out_node, const int* slot_of, const int* split_ptr,
                               const int* split_node, float* part_a, float* part_m,
                               float* part_l, float* out, int num_tiles, int lanes, int segs,
                               int heads, int dh, int n_split, int num_nodes, int chunk_bytes,
                               int groups, int per_group, int lanes_per_stage,
                               int threads, int smem_bytes, float slope, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (num_tiles > 0 && heads * dh > 0) {
    Walk w{num_tiles, lanes, segs, heads, dh, 0, num_nodes, ld, 0, 0, groups, per_group,
           lanes_per_stage, 0, 0, slope};
    const int status = run_walk<kAttn>(device, x, elem_bytes, chunk_bytes, qscale, qzero,
                                      gather_idx, edge_ids, scores, coeff, seg_ids, out_node,
                                      slot_of, part_a, part_m, part_l, out, w, threads,
                                      smem_bytes, stream);
    if (status != 0) return status;
  }
  if (n_split > 0 && heads * dh > 0) {
    combine_attention_kernel<<<n_split, kThreads, 0, stream>>>(
        part_a, part_m, part_l, split_ptr, split_node, out, heads, dh);
  }
  return static_cast<int>(cudaGetLastError());
}

// Multi-head AGE: as ample_attention, with per-edge coefficients
// values [E_graph, heads] in place of scores, coeff [T, lanes] or null
// (ones), and no m or l.
extern "C" int ample_segment_agg_mh(int device, const void* x, int elem_bytes,
                                    const float* qscale, const float* qzero, int ld,
                                    const int* gather_idx, const int* edge_ids,
                                    const float* values, const float* coeff,
                                    const int* seg_ids, const int* out_node,
                                    const int* slot_of, const int* split_ptr,
                                    const int* split_node, float* part_a, float* out,
                                    int num_tiles, int lanes, int segs, int heads, int dh,
                                    int n_split, int num_nodes, int chunk_bytes, int groups,
                                    int per_group, int lanes_per_stage,
                                    int threads, int smem_bytes, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (num_tiles > 0 && heads * dh > 0) {
    Walk w{num_tiles, lanes, segs, heads, dh, 0, num_nodes, ld, 0, 0, groups, per_group,
           lanes_per_stage, 0, 0, 0.f};
    const int status = run_walk<kValues>(device, x, elem_bytes, chunk_bytes, qscale, qzero,
                                       gather_idx, edge_ids, values, coeff, seg_ids, out_node,
                                       slot_of, part_a, nullptr, nullptr, out, w, threads,
                                       smem_bytes, stream);
    if (status != 0) return status;
  }
  if (n_split > 0 && heads * dh > 0) {
    combine_sum_kernel<<<n_split, kThreads, 0, stream>>>(part_a, split_ptr, split_node, out,
                                                         heads * dh);
  }
  return static_cast<int>(cudaGetLastError());
}
