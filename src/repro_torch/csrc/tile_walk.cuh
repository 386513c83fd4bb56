// The tile walk shared by the AGE (segment_agg.cu) and the GAT kernels
// (attn_agg.cu): heads_walk_kernel, and the split-node sum combine_sum_kernel.
//
// Over the planner's edge tiles (gather_idx, seg_ids: [T, E]; out_node:
// [T, S]) the walk sums weighted rows of x per destination segment. x is
// head-packed, [N, heads * dh] (the AGE is heads = 1, dh = D), rows ld
// elements apart, as f32 rows or as int8 codes that the walk dequantizes in
// registers, (float(q) - zp) * scale with the two roundings of
// core/quantization.py::dequantize (scale and zero point read from device
// memory), so each product is bitwise the one the plain version forms. The
// plan orders each tile's lanes by segment (a segment is a contiguous run,
// padding lanes last with weight 0), and a node spans several tiles only when
// it was split, as the first or last segment of a tile; the split map
// (computed once per plan on the host) gives each segment of a split node a
// compact partial row (slot_of >= 0) and -1 to every other segment.
//
// Lane weights, by mode:
//   kStatic (the AGE): the plan's coeff[t, e]; no per-edge operand, and the
//     plan's edge ids are not read. A lane of weight 0 is not even copied.
//   kValues (the multi-head AGE): coeff[t, e] * values[edge_ids[t, e], h]
//     (coeff null: ones), the per-edge operand [E_graph, H] read through the
//     edge ids (-1 on padding lanes, which are not copied);
//   kAttn (the fused GAT layer): per segment and head, softmax over the
//     segment's lanes of LeakyReLU(scores[edge_ids[t, e], h]) times coeff.
//
// What bounds it on an H100: device-memory bytes. Each live lane gathers one
// row (4 bytes an element as f32, 1 as int8 codes) and does about 2 flops per
// element.
//
// Design (heads_walk_kernel):
// - Column map. A block is `groups` lane groups of `chunks` threads; thread
//   (g, c) owns the c-th 16-byte chunk of the row (float4, or 16 int8 codes;
//   4- or 1-byte chunks when the rows are not 16-byte aligned) for the lanes
//   of group g, a contiguous run of the tile. The host picks the group count
//   so that the block is a whole number of warps of at least 256 threads
//   with >= 90% of them owning a chunk (d = 400 f32: 3 groups of 100 in 320
//   threads; d = 300: 4 of 75; d = 256: 4 of 64; int8 codes: 16 of 16 at
//   d = 256). Codes whose row stride is a multiple of 16 bytes may take
//   16-byte chunks even when d is not (d = 300 at a stride of 304): the last
//   chunk then reads the row's padding, and columns >= d are never written.
// - Staging. Rows reach shared memory through a two-stage ring of `k` lanes
//   per group and stage, by cp.async copies: step J + 1 is copied while step
//   J is summed. Each thread copies exactly the chunks it sums and waits for
//   its own copies: the ring needs no barrier. `k` is as large as lets two
//   blocks share an SM. A block is persistent over tiles blockIdx.x + i *
//   gridDim.x: tile i + 2's metadata and tile i + 1's per-edge values (read
//   through its edge ids) are staged by cp.async into a ring of three
//   metadata buffers while tile i sums, and the row ring runs on across tile
//   boundaries. Three barriers a tile.
// - Segment softmax (kAttn). One warp per head scans the tile's lanes in
//   windows of 32, twice: a segmented inclusive max, then sum of exps, by
//   shuffles within the window (each lane's run start found by a ballot),
//   carried from window to window; the last lane of each run holds the run's
//   max m and exp-sum l. expf, no fast math.
// - Sums. Each thread keeps one running sum per element of its chunk over its
//   group's lanes in order. A segment inside one group is final there (a / l
//   for attention; its compact partial row when its node is split across
//   tiles). A segment that crosses groups is kept in registers by the group
//   where it starts, which adds the later groups' partials (one shared row
//   per group) in group order: the sum of a long segment is taken in group
//   order, not lane order, and moves within the AGE's 1e-4 of the plain
//   version.
// - Output. The walk writes the rows of its plan's nodes into the caller's
//   out and leaves every other row as it is, so the two precision groups of
//   one aggregation share one zero-filled out.
// Split nodes are then combined in tile order (combine_sum_kernel here; the
// log-sum-exp rescale in attn_agg.cu). No atomics: the result is the same
// from run to run, which warm == cold serving relies on. Sums use
// __fmul_rn/__fadd_rn (no FMA contraction). A lane is skipped for an element
// whose weight is 0: for finite x it adds exactly +-0.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads of the split-node combines
constexpr int kMaxThreads = 512;  // block size limit of the walk (the host checks)
constexpr int kStages = 2;  // ring depth: step J + 1 is copied while step J is summed

enum Mode { kStatic = 0, kValues = 1, kAttn = 2 };

__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Geometry of one walk; the host computes it (segment_agg/ops.py::walk_geometry).
struct Walk {
  int num_tiles, lanes, segs, heads, dh, d, num_nodes;
  int ld;         // elements between consecutive rows of x
  int chunks;     // chunks of a row, one thread each
  int dp;         // columns the chunks cover (>= d; > d only when the last reads padding)
  int groups;     // lane groups of a block
  int per_group;  // lanes of a group: group g owns [g * per_group, +per_group)
  int k;          // lanes of a group per ring stage
  int steps;      // ring steps per tile: ceil(per_group / k)
  int row_bytes;  // ring row stride
  float slope;    // LeakyReLU slope (attention)
};

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory, in this order: the ring; three metadata buffers (idx, seg,
// eid, cf [E]; node, slot [S]; w [E, H]: raw per-edge values, then the lane
// weights); m and l [S, H]; one partial row per group [dp] floats.
struct Layout {
  int ring, meta, meta_bytes, lane4, seg4, m, l, part, total;
};

__host__ __device__ __forceinline__ Layout layout(const Walk& w) {
  Layout o;
  o.lane4 = align16(4 * w.lanes);
  o.seg4 = align16(4 * w.segs);
  o.ring = 0;
  o.meta = kStages * w.groups * w.k * w.row_bytes;
  o.meta_bytes = 4 * o.lane4 + 2 * o.seg4 + align16(4 * w.lanes * w.heads);
  o.m = o.meta + 3 * o.meta_bytes;
  o.l = o.m + align16(4 * w.segs * w.heads);
  o.part = o.l + align16(4 * w.segs * w.heads);
  o.total = o.part + w.groups * w.dp * 4;
  return o;
}

struct Meta {
  int* idx;
  int* seg;
  int* eid;
  float* cf;
  int* node;
  int* slot;
  float* w;
};

__device__ __forceinline__ Meta meta_at(unsigned char* smem, const Layout& o, int b) {
  unsigned char* p = smem + o.meta + b * o.meta_bytes;
  Meta m;
  m.idx = reinterpret_cast<int*>(p);
  m.seg = reinterpret_cast<int*>(p + o.lane4);
  m.eid = reinterpret_cast<int*>(p + 2 * o.lane4);
  m.cf = reinterpret_cast<float*>(p + 3 * o.lane4);
  m.node = reinterpret_cast<int*>(p + 4 * o.lane4);
  m.slot = reinterpret_cast<int*>(p + 4 * o.lane4 + o.seg4);
  m.w = reinterpret_cast<float*>(p + 4 * o.lane4 + 2 * o.seg4);
  return m;
}

// n 4-byte words from global to shared by cp.async (16-byte copies when the
// source allows them).
__device__ __forceinline__ void stage_words(void* dst, const void* src, int n) {
  const uint32_t d = smem_u32(dst);
  const char* s = static_cast<const char*>(src);
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) cp_async16(d + 16 * i, s + 16 * i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(d + 4 * i, s + 4 * i);
  }
}

template <int kChunk>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src) {
  if constexpr (kChunk == 16) {
    cp_async16(smem_u32(dst), src);
  } else if constexpr (kChunk == 4) {
    cp_async4(smem_u32(dst), src);
  } else {
    *dst = __ldg(src);  // byte rows: a plain copy, made visible by the same barrier
  }
}

// One staged chunk as raw bits: 16, 4 or 1 bytes.
template <int kChunk>
struct Raw {
  uint32_t u[kChunk >= 4 ? kChunk / 4 : 1];
};

template <int kChunk>
__device__ __forceinline__ Raw<kChunk> load_raw(const unsigned char* p) {
  Raw<kChunk> r;
  if constexpr (kChunk == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r.u[0] = q.x;
    r.u[1] = q.y;
    r.u[2] = q.z;
    r.u[3] = q.w;
  } else if constexpr (kChunk == 4) {
    r.u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    r.u[0] = *p;
  }
  return r;
}

// The chunk as floats: f32 bits as they are, int8 codes dequantized as
// core/quantization.py does, (float(q) - zero) * scale.
template <typename T, int kChunk, int kVec>
__device__ __forceinline__ void decode(const Raw<kChunk>& r, float (&v)[kVec], float scale,
                                       float zero) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if constexpr (sizeof(T) == 4) {
      v[j] = __uint_as_float(r.u[j]);
    } else {
      const int q = static_cast<int8_t>((r.u[j / 4] >> (8 * (j % 4))) & 0xff);
      v[j] = __fmul_rn(__fsub_rn(static_cast<float>(q), zero), scale);
    }
  }
}

// The chunk's first n columns (all kVec when n >= kVec); float4 stores when
// the whole chunk is written.
template <int kVec>
__device__ __forceinline__ void store_chunk(float* dst, const float (&v)[kVec], int n) {
  if constexpr (kVec % 4 == 0) {
    if (n >= kVec) {
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < n) dst[j] = v[j];
}

// A finished segment's chunk: to its compact partial row when its node is
// split across tiles, else to the node's output row (attention divides by
// the segment's exp-sum l there, as the combine would with one row). Only
// columns < d are written (a last chunk may cover the row's padding).
template <int kVec, int kMode>
__device__ __forceinline__ void write_segment(int s, const float (&acc)[kVec],
                                              const int (&hd)[kVec], const Meta& M,
                                              const float* s_l, float* __restrict__ part_a,
                                              float* __restrict__ out, int col, const Walk& w) {
  const int node = M.node[s];
  if (node >= w.num_nodes) return;  // sentinel: unused segment
  const int slot = M.slot[s];
  float v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    v[j] = acc[j];
    if constexpr (kMode == kAttn) {
      if (slot < 0) {
        const float l = s_l[s * w.heads + hd[j]];
        v[j] = __fdiv_rn(acc[j], l > 0.f ? l : 1.f);
      }
    }
  }
  float* dst = slot >= 0 ? part_a + static_cast<int64_t>(slot) * w.d
                         : out + static_cast<int64_t>(node) * w.d;
  store_chunk<kVec>(dst + col, v, w.d - col);
}

template <typename T, int kChunk, int kMode>
__global__ void __launch_bounds__(kMaxThreads, 1) heads_walk_kernel(
    const T* __restrict__ x, const float* __restrict__ qscale, const float* __restrict__ qzero,
    const int* __restrict__ gather_idx, const int* __restrict__ edge_ids,
    const float* __restrict__ values, const float* __restrict__ coeff,
    const int* __restrict__ seg_ids, const int* __restrict__ out_node,
    const int* __restrict__ slot_of, float* __restrict__ part_a, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ out, const Walk w) {
  constexpr int kVec = kChunk / static_cast<int>(sizeof(T));
  constexpr bool kStaticW = kMode == kStatic;
  extern __shared__ __align__(16) unsigned char walk_smem[];
  unsigned char* smem = walk_smem;
  const Layout lay = layout(w);
  float* s_m = reinterpret_cast<float*>(smem + lay.m);
  float* s_l = reinterpret_cast<float*>(smem + lay.l);
  float* s_part = reinterpret_cast<float*>(smem + lay.part);
  unsigned char* ring = smem + lay.ring;

  const int ntiles = static_cast<int>(blockIdx.x) < w.num_tiles
                         ? (w.num_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                         : 0;
  if (ntiles == 0) return;
  const int E = w.lanes, S = w.segs, H = w.heads;
  const int rows = w.groups * w.k;  // rows of a ring stage
  const bool has_coeff = coeff != nullptr;
  float scale = 1.f, zero = 0.f;
  if constexpr (sizeof(T) == 1) {
    scale = *qscale;
    zero = *qzero;
  }

  // This thread's place in the column map.
  const int g = threadIdx.x / w.chunks;
  const int c = threadIdx.x - g * w.chunks;
  const bool worker = g < w.groups;
  const int col = c * kVec;
  const int a_g = g * w.per_group;
  const int end_g = min(E, a_g + w.per_group);
  int hd[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) hd[j] = min((col + j) / w.dh, H - 1);
  const bool one_head = hd[0] == hd[kVec - 1];

  auto tile_of = [&](int i) -> int64_t {
    return static_cast<int64_t>(blockIdx.x) + static_cast<int64_t>(i) * gridDim.x;
  };
  auto stage_meta = [&](int i) {
    const Meta M = meta_at(smem, lay, i % 3);
    const int64_t t = tile_of(i);
    stage_words(M.idx, gather_idx + t * E, E);
    stage_words(M.seg, seg_ids + t * E, E);
    if constexpr (!kStaticW) stage_words(M.eid, edge_ids + t * E, E);
    if (has_coeff) stage_words(M.cf, coeff + t * E, E);
    stage_words(M.node, out_node + t * S, S);
    stage_words(M.slot, slot_of + t * S, S);
  };
  // The tile's per-edge values through its edge ids (needs its eid visible).
  auto stage_values = [&](int i) {
    if constexpr (!kStaticW) {
      const Meta M = meta_at(smem, lay, i % 3);
      for (int q = threadIdx.x; q < E * H; q += blockDim.x) {
        const int e = q / H;
        const int eid = M.eid[e];
        if (eid >= 0)
          cp_async4(smem_u32(M.w + q), values + static_cast<int64_t>(eid) * H + (q - e * H));
        else
          M.w[q] = kMode == kAttn ? neg_inf() : 0.f;
      }
    }
  };
  // This thread's chunk of its group's rows for global step J (step J %
  // steps of the block's tile J / steps), into ring stage J % kStages: every
  // thread copies exactly what it will sum, so the ring needs no barrier,
  // only each thread's own cp.async.wait_group.
  const int total = ntiles * w.steps;
  auto issue_rows = [&](int J) {
    if (!worker || J >= total) return;
    const int i = J / w.steps;
    const int k = J - i * w.steps;
    const Meta M = meta_at(smem, lay, i % 3);
    unsigned char* row =
        ring + ((J % kStages) * rows + g * w.k) * w.row_bytes + c * kChunk;
    for (int r = 0; r < w.k; ++r) {
      const int le = k * w.k + r;
      const int e = a_g + le;
      if (le >= w.per_group || e >= E) break;
      const bool live = kStaticW ? M.cf[e] != 0.f : M.eid[e] >= 0;
      if (live)
        copy_chunk<kChunk>(row + r * w.row_bytes,
                           reinterpret_cast<const unsigned char*>(
                               x + static_cast<int64_t>(M.idx[e]) * w.ld) + c * kChunk);
    }
  };

  // Prologue: tile 0's metadata, then its values (through its edge ids) and
  // tile 1's metadata, then the ring's first step. From here on the
  // metadata runs two tiles ahead of the sums and the values one: both land
  // (and a barrier makes them visible) before the tile that needs them, and
  // the ring, whose copies read the indices of this tile or the next, runs
  // on across tile boundaries.
  stage_meta(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  stage_values(0);
  if (ntiles > 1) stage_meta(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  issue_rows(0);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = 0; i < ntiles; ++i) {
    const Meta M = meta_at(smem, lay, i % 3);
    // Committed with this tile's first ring group; landed by its last step.
    if (i + 1 < ntiles) stage_values(i + 1);
    if (i + 2 < ntiles) stage_meta(i + 2);

    // A run's max (pass 0), or its exp-sum and, for a split node's
    // segment, the (m, l) of its partial row (pass 1).
    auto finish_run = [&](int pass, int s, int h, float v) {
      if (pass == 0) {
        s_m[s * H + h] = v;
        return;
      }
      s_l[s * H + h] = v;
      const int slot = M.slot[s];
      if (slot >= 0) {
        part_m[static_cast<int64_t>(slot) * H + h] = s_m[s * H + h];
        part_l[static_cast<int64_t>(slot) * H + h] = v;
      }
    };
    // Lane weights.
    if constexpr (kMode == kAttn) {
      for (int h = warp; h < H; h += nwarps) {
        for (int pass = 0; pass < 2; ++pass) {  // the max, then the exp-sum
          float carry = pass == 0 ? neg_inf() : 0.f;
          int carry_s = -1;
          for (int e0 = 0; e0 < E; e0 += 32) {
            const int e = e0 + lane;
            const bool valid = e < E;
            const int s = valid ? M.seg[e] : -2 - lane;  // invalid lanes match nothing
            const bool starts = !valid || lane == 0 || M.seg[e - 1] != s;
            const unsigned runs =
                __ballot_sync(0xffffffffu, starts) & (0xffffffffu >> (31 - lane));
            const int start = 31 - __clz(runs);  // first lane of this lane's run in the window
            float v;
            if (pass == 0) {  // segment max of the activated scores
              v = valid ? M.w[e * H + h] : neg_inf();
              v = v >= 0.f ? v : __fmul_rn(w.slope, v);  // LeakyReLU; -inf stays -inf
              if (valid) M.w[e * H + h] = v;
#pragma unroll
              for (int off = 1; off < 32; off <<= 1) {
                const float o = __shfl_up_sync(0xffffffffu, v, off);
                if (lane - off >= start) v = fmaxf(v, o);
              }
              if (s == carry_s) v = fmaxf(v, carry);
            } else {  // exp-sum l, and the lane weights exp(sc - m) * coeff
              v = 0.f;
              if (valid) {
                const float m = s_m[s * H + h];
                v = expf(M.w[e * H + h] - (finite(m) ? m : 0.f));
                M.w[e * H + h] = has_coeff ? __fmul_rn(v, M.cf[e]) : v;
              }
#pragma unroll
              for (int off = 1; off < 32; off <<= 1) {
                const float o = __shfl_up_sync(0xffffffffu, v, off);
                if (lane - off >= start) v = __fadd_rn(o, v);
              }
              if (s == carry_s) v = __fadd_rn(carry, v);
            }
            carry = __shfl_sync(0xffffffffu, v, 31);
            carry_s = __shfl_sync(0xffffffffu, s, 31);
            if (valid && (e == E - 1 || M.seg[e + 1] != s)) finish_run(pass, s, h, v);
          }
          __syncwarp();
        }
      }
    } else if constexpr (kMode == kValues) {
      if (has_coeff) {
        for (int q = threadIdx.x; q < E * H; q += blockDim.x)
          M.w[q] = __fmul_rn(M.cf[q / H], M.w[q]);
      }
    }
    __syncthreads();

    // This group's runs: the first and last segment of its lanes. A run
    // that continues from the group before leaves its partial in the
    // group's shared row; a run that starts here and continues into the
    // next group stays in this thread's registers until the combine.
    int sf = 0, sl = 0;
    bool cont = false, beyond = false;
    if (worker) {
      sf = M.seg[a_g];
      sl = M.seg[end_g - 1];
      cont = a_g > 0 && M.seg[a_g - 1] == sf;
      beyond = end_g < E && M.seg[end_g] == sl;
    }
    int cur = sf;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    float* my_part = s_part + g * w.dp + col;
    auto flush = [&](int s) {
      if (s == sf && cont)
        store_chunk<kVec>(my_part, acc, kVec);
      else
        write_segment<kVec, kMode>(s, acc, hd, M, s_l, part_a, out, col, w);
    };

    for (int k = 0; k < w.steps; ++k) {
      const int J = i * w.steps + k;
      cp_async_wait<0>();  // step J has landed
      issue_rows(J + 1);
      cp_async_commit();

      if (worker) {
        const unsigned char* stage = ring + ((J % kStages) * rows + g * w.k) * w.row_bytes +
                                     c * kChunk;
        const int r_end = min(w.k, end_g - a_g - k * w.k);
        for (int r = 0; r < r_end; ++r) {
          const int e = a_g + k * w.k + r;
          // This lane's segment, chunk and weights, read before any flush.
          const int s = M.seg[e];
          const Raw<kChunk> raw = load_raw<kChunk>(stage + r * w.row_bytes);
          const float* wr = kStaticW ? M.cf + e : M.w + e * H;
          const float w0 = wr[hd[0]];
          if (s != cur) {
            flush(cur);
            cur = s;
#pragma unroll
            for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
          }
          float xv[kVec];
          decode<T, kChunk, kVec>(raw, xv, scale, zero);
          if (one_head) {
            if (w0 != 0.f) {
#pragma unroll
              for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(w0, xv[j]));
            }
          } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float wv = wr[hd[j]];
              if (wv != 0.f) acc[j] = __fadd_rn(acc[j], __fmul_rn(wv, xv[j]));
            }
          }
        }
      }
    }
    // The last run: continued from before (shared row), continuing past this
    // group (kept in acc, this group adds the rest), or final here.
    if (worker && !beyond) flush(cur);
    else if (worker && cur == sf && cont) store_chunk<kVec>(my_part, acc, kVec);
    if (w.steps < 2) cp_async_wait<0>();  // a one-step tile: the next values
    __syncthreads();  // shared rows; the next tile's values, metadata after it

    // Runs that cross groups: the group where one starts adds the later
    // groups' shared rows in group order.
    if (worker && beyond && !(sf == sl && cont)) {
      for (int g2 = g + 1; g2 < w.groups && M.seg[g2 * w.per_group] == sl; ++g2) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[j] = __fadd_rn(acc[j], s_part[g2 * w.dp + col + j]);
      }
      write_segment<kVec, kMode>(sl, acc, hd, M, s_l, part_a, out, col, w);
    }
    __syncthreads();  // shared rows and l are free for the next tile
  }
  cp_async_wait<0>();
}

// One block per split node: its partial rows summed in tile order.
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

// Launch heads_walk_kernel as a persistent grid (as many blocks as fit on
// the card at once, at most one per tile).
template <typename T, int kChunk, int kMode>
int launch_walk(int device, const void* x, const float* qscale, const float* qzero,
                const int* gather_idx, const int* edge_ids, const float* values,
                const float* coeff, const int* seg_ids, const int* out_node,
                const int* slot_of, float* part_a, float* part_m, float* part_l, float* out,
                const Walk& w, int threads, int smem_bytes, cudaStream_t stream) {
  auto kernel = heads_walk_kernel<T, kChunk, kMode>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // All of the SM's unified memory as shared memory, so that as many blocks
  // fit as the occupancy count says.
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fit = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(w.num_tiles < fit ? w.num_tiles : fit);
  kernel<<<blocks, threads, smem_bytes, stream>>>(
      static_cast<const T*>(x), qscale, qzero, gather_idx, edge_ids, values, coeff, seg_ids,
      out_node, slot_of, part_a, part_m, part_l, out, w);
  return static_cast<int>(cudaGetLastError());
}

// The walk for x's element type (1 = int8 codes, 4 = f32) and chunk bytes;
// the host picks the chunk so that it divides the row stride and the base,
// and the chunks of a row stay inside its stride. Fills the derived fields
// of w and refuses (cudaErrorInvalidValue) a geometry that does not fit.
template <int kMode>
int run_walk(int device, const void* x, int elem_bytes, int chunk_bytes, const float* qscale,
             const float* qzero, const int* gather_idx, const int* edge_ids,
             const float* values, const float* coeff, const int* seg_ids, const int* out_node,
             const int* slot_of, float* part_a, float* part_m, float* part_l, float* out,
             Walk w, int threads, int smem_bytes, cudaStream_t stream) {
  const int vec = chunk_bytes / elem_bytes;
  w.d = w.heads * w.dh;
  w.chunks = vec > 0 ? (w.d + vec - 1) / vec : 0;
  w.dp = w.chunks * vec;
  w.steps = w.k > 0 ? (w.per_group + w.k - 1) / w.k : 0;
  w.row_bytes = align16(w.chunks * chunk_bytes);
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const bool ok = vec > 0 && w.ld >= w.dp && (static_cast<int64_t>(w.ld) * elem_bytes) %
                  chunk_bytes == 0 && base % chunk_bytes == 0 && (w.dp == w.d || w.d % 4 == 0) &&
                  w.groups > 0 && w.k > 0 &&
                  (w.groups - 1) * w.per_group < w.lanes && w.groups * w.per_group >= w.lanes &&
                  threads % 32 == 0 && threads >= w.groups * w.chunks &&
                  threads <= kMaxThreads && layout(w).total == smem_bytes &&
                  (elem_bytes == 1 ? qscale != nullptr && qzero != nullptr : elem_bytes == 4) &&
                  (kMode != kStatic || (w.heads == 1 && coeff != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
#define AMPLE_WALK(T, C)                                                                    \
  return launch_walk<T, C, kMode>(device, x, qscale, qzero, gather_idx, edge_ids, values,   \
                                  coeff, seg_ids, out_node, slot_of, part_a, part_m, part_l, \
                                  out, w, threads, smem_bytes, stream)
  if (elem_bytes == 4) {
    if (chunk_bytes == 16) AMPLE_WALK(float, 16);
    if (chunk_bytes == 4) AMPLE_WALK(float, 4);
  } else {
    if (chunk_bytes == 16) AMPLE_WALK(int8_t, 16);
    if (chunk_bytes == 4) AMPLE_WALK(int8_t, 4);
    if (chunk_bytes == 1) AMPLE_WALK(int8_t, 1);
  }
#undef AMPLE_WALK
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
