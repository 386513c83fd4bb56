// AGE (Aggregation Engine) for Hopper: event-driven gather + segment reduce.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/segment_agg/segment_agg.py::gather_segment_tiles (_kernel)
// together with the scatter-add combine of
//   repro/kernels/segment_agg/ops.py::aggregate_tiles.
//
// Computes out[n, :] = sum over the lanes of every segment mapped to node n of
// coeff * x[gather_idx, :], over the planner's edge tiles (gather_idx, coeff,
// seg_ids: [T, E]; out_node: [T, S]).
//
// What bounds it on an H100: device-memory bytes. Each real lane gathers one
// feature row (D floats) and does 2*D flops, about 0.5 flop per byte, far
// below the card's ~20 fp32 flops per byte. The TPU kernel wrote per-tile
// partials f32[T, S, D] and combined them with a scatter; at Yelp scale that
// buffer is 13 GB, nearly all of it unused segments, so it is not carried
// over, nor is the one-hot matmul (it exists for the TPU's matrix unit).
//
// Design: the tile walk of tile_walk.cuh with one head (heads = 1, dh = D,
// coeff [T, E] read as [T, E, 1]): one block per tile walks the lanes in
// order with a running sum per column, writes a node that lives in this tile
// only straight to out[node] and a split node's segment to a compact partial
// row; one block per split node then sums its partial rows in tile order.
#include "tile_walk.cuh"

// out must be zero-filled by the caller (rows no segment maps to stay 0);
// partial holds split_ptr[n_split] rows of d floats. The wrapper checks that
// (3 * lanes + 2 * segs) * 4 bytes fit the 48 KB of static shared memory.
extern "C" int ample_segment_agg(int device, const float* x,
                                 const int* gather_idx, const float* coeff,
                                 const int* seg_ids, const int* out_node,
                                 const int* slot_of, const int* split_ptr,
                                 const int* split_node, float* partial,
                                 float* out, int num_tiles, int lanes,
                                 int segs, int n_split, int d, int num_nodes,
                                 void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (num_tiles > 0 && d > 0) {
    const int status = launch_tiles(stream, x, gather_idx, coeff, seg_ids, out_node,
                                    slot_of, partial, out, num_tiles, lanes, segs, 1, d,
                                    num_nodes);
    if (status != 0) return status;
  }
  if (n_split > 0 && d > 0) {
    combine_sum_kernel<<<n_split, kThreads, 0, stream>>>(partial, split_ptr,
                                                         split_node, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}
