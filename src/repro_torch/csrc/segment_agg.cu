// AGE (Aggregation Engine) for Hopper: event-driven gather + segment reduce.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/segment_agg/segment_agg.py::gather_segment_tiles (_kernel)
// together with the scatter-add combine of
//   repro/kernels/segment_agg/ops.py::aggregate_tiles.
//
// Computes out[n, :] = sum over the lanes of every segment mapped to node n of
// coeff * x[gather_idx, :], over the planner's edge tiles (gather_idx, coeff,
// seg_ids: [T, E]; out_node: [T, S]), x f32 rows or int8 codes dequantized
// in registers (the paper's int8 stream: a quarter of the gathered bytes).
//
// What bounds it on an H100: device-memory bytes. Each real lane gathers one
// feature row (D elements) and does 2*D flops. The TPU kernel wrote per-tile
// partials f32[T, S, D] and combined them with a scatter; at Yelp scale that
// buffer is 13 GB, nearly all of it unused segments, so it is not carried
// over, nor is the one-hot matmul (it exists for the TPU's matrix unit).
//
// This file is the entry point only: the AGE is the tile walk of
// tile_walk.cuh (heads_walk_kernel, design note there) in its static mode,
// with one head (heads = 1, dh = D), the plan's coeff as lane weights and
// lane groups aligned to segments (each segment summed in lane order by one
// group: bitwise the plain version), then the split nodes' partial rows
// summed in tile order.
#include "tile_walk.cuh"

// x: [N, d] f32 (elem_bytes 4) or int8 codes (elem_bytes 1, with device
// scalars qscale and qzero), rows ld elements apart; gather_idx, coeff and
// seg_ids: [T, lanes], seg_ids not decreasing along a tile; out_node and
// slot_of: [T, segs]. The walk writes the
// rows of this plan's nodes into out ([num_nodes, d]) and no other row;
// partial holds split_ptr[n_split] rows of d floats. The geometry
// (chunk_bytes .. smem_bytes) comes from ops.walk_geometry with one head;
// a geometry that does not fit the call is refused with
// cudaErrorInvalidValue.
extern "C" int ample_segment_agg(int device, const void* x, int elem_bytes, const float* qscale,
                                 const float* qzero, int ld, const int* gather_idx,
                                 const float* coeff, const int* seg_ids, const int* out_node,
                                 const int* slot_of, const int* split_ptr,
                                 const int* split_node, float* partial, float* out,
                                 int num_tiles, int lanes, int segs, int d, int n_split,
                                 int num_nodes, int chunk_bytes, int groups, int per_group,
                                 int lanes_per_stage, int threads, int smem_bytes,
                                 void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (num_tiles > 0 && d > 0) {
    Walk w{num_tiles, lanes, segs, 1, d, 0, num_nodes, ld, 0, 0, groups, per_group,
           lanes_per_stage, 0, 0.f};
    const int status = run_walk<kStatic>(device, x, elem_bytes, chunk_bytes, qscale, qzero,
                                         gather_idx, nullptr, nullptr, coeff, seg_ids,
                                         out_node, slot_of, partial, nullptr, nullptr, nullptr,
                                         out, w,
                                         threads, smem_bytes, stream);
    if (status != 0) return status;
  }
  if (n_split > 0 && d > 0) {
    combine_sum_kernel<<<n_split, kThreads, 0, stream>>>(partial, split_ptr, split_node, out,
                                                         d);
  }
  return static_cast<int>(cudaGetLastError());
}
