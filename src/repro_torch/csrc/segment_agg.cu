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
// Design: the plan already orders each tile's lanes by segment (a segment is a
// contiguous run, padding lanes last with coeff 0), and a node spans several
// tiles only when it was split, as the first or last segment of a tile. So
//   kernel 1 (one block per tile) stages the tile's indices in shared memory
//     (the TPU's scalar prefetch), walks the lanes in order with a running sum
//     per column held in registers, loading the rows of kBatch lanes ahead of
//     the sums so that several row loads are in flight, and writes each
//     finished segment either straight to out[node] (slot_of == -1: the node
//     lives in this tile only) or to a compact partial[slot] row;
//   kernel 2 (one block per split node) sums that node's partial rows in tile
//     order into out[node].
// No atomics: the result is the same from run to run, which warm == cold
// serving relies on. Sums use __fmul_rn/__fadd_rn (no FMA contraction), the
// order of the plain PyTorch version on the CPU. Lanes with coeff 0 are
// skipped; for finite x they add exactly +-0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads of a block; they stride over columns
constexpr int kBatch = 8;      // lanes whose rows are loaded before being summed

template <int CPT>
__device__ __forceinline__ void flush_segment(
    int s, const float (&acc)[CPT], const int* s_node, const int* s_slot,
    float* __restrict__ partial, float* __restrict__ out, int col0, int d,
    int num_nodes) {
  const int node = s_node[s];
  if (node >= num_nodes) return;  // sentinel: unused segment
  const int slot = s_slot[s];
  float* dst = slot < 0 ? out + static_cast<int64_t>(node) * d
                        : partial + static_cast<int64_t>(slot) * d;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = col0 + c * kThreads;
    if (col < d) dst[col] = acc[c];
  }
}

// CPT = columns per thread; a block covers kThreads * CPT columns and
// blockIdx.y selects which.
template <int CPT>
__global__ void __launch_bounds__(kThreads) tile_segments_kernel(
    const float* __restrict__ x, const int* __restrict__ gather_idx,
    const float* __restrict__ coeff, const int* __restrict__ seg_ids,
    const int* __restrict__ out_node, const int* __restrict__ slot_of,
    float* __restrict__ partial, float* __restrict__ out, int lanes, int segs,
    int d, int num_nodes) {
  extern __shared__ int smem[];
  int* s_idx = smem;
  float* s_coeff = reinterpret_cast<float*>(smem + lanes);
  int* s_seg = smem + 2 * lanes;
  int* s_node = smem + 3 * lanes;
  int* s_slot = s_node + segs;

  const int64_t t = blockIdx.x;
  for (int i = threadIdx.x; i < lanes; i += kThreads) {
    s_idx[i] = gather_idx[t * lanes + i];
    s_coeff[i] = coeff[t * lanes + i];
    s_seg[i] = seg_ids[t * lanes + i];
  }
  for (int i = threadIdx.x; i < segs; i += kThreads) {
    s_node[i] = out_node[t * segs + i];
    s_slot[i] = slot_of[t * segs + i];
  }
  __syncthreads();

  const int col0 = blockIdx.y * (kThreads * CPT) + threadIdx.x;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  int cur = s_seg[0];

  for (int e0 = 0; e0 < lanes; e0 += kBatch) {
    float v[kBatch][CPT];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b;
      const bool live = e < lanes && s_coeff[e] != 0.f;
      const float* row = x + static_cast<int64_t>(live ? s_idx[e] : 0) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = col0 + c * kThreads;
        v[b][c] = (live && col < d) ? __ldg(row + col) : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b;
      if (e < lanes) {
        const int s = s_seg[e];
        if (s != cur) {
          flush_segment<CPT>(cur, acc, s_node, s_slot, partial, out, col0, d,
                             num_nodes);
          cur = s;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
        }
        const float cf = s_coeff[e];
        if (cf != 0.f) {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            acc[c] = __fadd_rn(acc[c], __fmul_rn(cf, v[b][c]));
        }
      }
    }
  }
  flush_segment<CPT>(cur, acc, s_node, s_slot, partial, out, col0, d,
                     num_nodes);
}

__global__ void __launch_bounds__(kThreads) combine_split_kernel(
    const float* __restrict__ partial, const int* __restrict__ split_ptr,
    const int* __restrict__ split_node, float* __restrict__ out, int d) {
  const int i = blockIdx.x;
  const int lo = split_ptr[i];
  const int hi = split_ptr[i + 1];
  float* dst = out + static_cast<int64_t>(split_node[i]) * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float acc = 0.f;
    for (int k = lo; k < hi; ++k)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(k) * d + col]);
    dst[col] = acc;
  }
}

template <int CPT>
void launch_tiles(dim3 grid, size_t smem, cudaStream_t stream, const float* x,
                  const int* gather_idx, const float* coeff, const int* seg_ids,
                  const int* out_node, const int* slot_of, float* partial,
                  float* out, int lanes, int segs, int d, int num_nodes) {
  tile_segments_kernel<CPT><<<grid, kThreads, smem, stream>>>(
      x, gather_idx, coeff, seg_ids, out_node, slot_of, partial, out, lanes,
      segs, d, num_nodes);
}

}  // namespace

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
    const int cpt = d <= kThreads ? 1 : d <= 2 * kThreads ? 2
                  : d <= 3 * kThreads ? 3 : 4;
    const int per_block = kThreads * cpt;
    const dim3 grid(num_tiles, (d + per_block - 1) / per_block);
    const size_t smem = static_cast<size_t>(3 * lanes + 2 * segs) * sizeof(int);
    switch (cpt) {
      case 1:
        launch_tiles<1>(grid, smem, stream, x, gather_idx, coeff, seg_ids,
                        out_node, slot_of, partial, out, lanes, segs, d,
                        num_nodes);
        break;
      case 2:
        launch_tiles<2>(grid, smem, stream, x, gather_idx, coeff, seg_ids,
                        out_node, slot_of, partial, out, lanes, segs, d,
                        num_nodes);
        break;
      case 3:
        launch_tiles<3>(grid, smem, stream, x, gather_idx, coeff, seg_ids,
                        out_node, slot_of, partial, out, lanes, segs, d,
                        num_nodes);
        break;
      default:
        launch_tiles<4>(grid, smem, stream, x, gather_idx, coeff, seg_ids,
                        out_node, slot_of, partial, out, lanes, segs, d,
                        num_nodes);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_split > 0 && d > 0) {
    combine_split_kernel<<<n_split, kThreads, 0, stream>>>(partial, split_ptr,
                                                           split_node, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}
