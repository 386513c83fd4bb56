// The GAT backward's per-edge terms for Hopper: one kernel in two modes.
//
// Replaces no Pallas kernel: the reference takes the gradient of its GAT
// layer with jax.grad of the jnp path (repro/core/message_passing.py:
// attention_aggregate with use_kernel off = edge_softmax, then aggregate with
// edge_coeff = alpha). The fused forward (attn_agg.cu) keeps no alpha, so this
// kernel forms the per-edge terms from what the forward saved (out, and the
// log-sum-exp it writes beside it), as flash attention's backward does:
//   attention (mode 1), per edge j -> i of the rows walked and head h:
//     D_i,h   = g_i,h . out_i,h
//     alpha   = exp(leaky(s_ij,h) - lse_i,h)          -> res_a [E, H]
//     ds      = alpha * (c_ij * (g_i,h . z_j,h) - D_i,h) * leaky'(s_ij,h)
//                                                      -> res_b [E, H]
//     (leaky'(s) = 1 at s >= 0 and the slope below, as jax.nn.leaky_relu's
//     gradient; c_ij the plan's static coefficient, null: ones);
//   coefficient (mode 0), the gradient of aggregate_tiles_mh's per-edge
//     coefficients: c_ij * (g_i,h . x_j,h)             -> res_a [E, H].
// The rest of the backward is the tile walk again, on the transposed plan
// (attn_ops.py): dz = sum_i c alpha g_i over each source's out-edges, and the
// score sums.
//
// What bounds it on an H100: device-memory bytes. Each edge gathers one row
// of H * dh elements (4 bytes an element as f32, 1 as codes), 2 flops an
// element, and reads and writes a few floats per head. Gathering every
// edge's row once, with no reuse, is the row floor: at FULL ample-gat's
// layer 0 on Yelp (14.7 M edges, d 256) 4.49 ms on f32 rows, 1.12 on codes.
//
// What held the first design (a warp per work item, each lane owning
// the chunks lane, lane + 32, ... of the row with a runtime head index per
// element, two in-edges at a time), as tools/gat_bwd_probe.py measured its
// stripped variants on an H100 (700 W) at layer 0 on f32 rows: not bytes.
// Gathering the rows alone took 5.2 ms of its 21.3; adding each product
// into its head's accumulator by an 8-way compare-select took 3.3 more, one
// full-warp butterfly per head and edge (20 dependent shuffles at H 4) 3.7
// more, and the per-edge operands, loaded one edge at a time after the dot
// (scores, coeff, lse, then expf and a 4-lane store), 9.1 more. On codes
// (a quarter of the bytes) the same steps took 4.0, 3.5, 4.2 and 9.2 ms.
//
// This design:
// - Head-aligned lanes. The warp is cut into lane groups of 32 / P lanes, P
//   the power of two >= H: group h owns head h, and its lane j the chunks
//   j, j + L, j + 2L, ... of that head (L lanes a group; a chunk is 4
//   elements, a float4 or 4 int8 codes, when dh % 4 == 0 and the rows are
//   aligned, else 1 element). A lane's products all belong to one head: it
//   sums them in registers, with no per-element select.
// - Dots of several in-edges reduced at once. A lane loads its chunks of
//   kEdges in-edges before it uses any (kEdges * its chunks fill a budget of
//   32-bit registers: 2 f32 edges at d 256, 1 at d 400, 2 and 1 on codes;
//   more made ptxas spill at the 80 registers that three blocks an SM
//   allow, and no more was faster), and their kEdges dots are summed over
//   the group by one reduce-scatter butterfly (scatter_sum), the same tree
//   of adds as a butterfly an edge. Codes run four blocks an SM, f32 rows
//   three.
// - Persistent warps: each warp walks items warp, warp + all warps, ..., with
//   the next item's (destination, first, end) loaded while this one runs.
// - Per-run operands in one coalesced pass. At the start of a run of at
//   most kRun in-edges of an item, each lane loads two of its sources (the
//   others get them by shuffle), and cp.async stages its scores [run, H],
//   coeff and lse_i in shared memory. The dots land in shared memory too,
//   and an epilogue forms alpha and ds at contiguous positions of the run's
//   [run * H] block: each load is issued before the gathers, no load waits
//   on a dot, and every store is coalesced.
// - g_i in registers for the whole item (one pass over a head's chunks at
//   the shapes of the main path; rows whose head needs more chunks a lane
//   than kPer take several passes, rounds, each adding its butterflied sum
//   in shared memory in round order).
// Each edge's dot is taken by the same lanes in the same order whatever its
// item and its position in it, so the outputs do not depend on how the host
// cuts rows into items (attn_ops.row_items). No atomics: each output element
// is written once, by one lane, so two runs give the same bits.
#include "tile_walk.cuh"

namespace {

constexpr int kBwdWarps = 8;   // warps of a block
constexpr int kBwdHeads = 8;   // most heads a row may have
constexpr int kBwdWidth = 512; // most elements a row may have
constexpr int kRun = 64;       // in-edges staged at once (an item may hold several runs)
// 32-bit registers a lane gives to the rows in flight (kEdges * kPer chunks),
// and the blocks an SM the register cap is set for (80 registers a thread at
// three, 64 at four), f32 rows and int8 codes. tools/gat_bwd_probe.py times
// other values: more registers for rows, or four blocks on f32 rows, spill.
constexpr int kRawWords = 16;
constexpr int kCodeWords = 4;
constexpr int kMinBlocks = 3;
constexpr int kCodeMinBlocks = 4;

struct BwdGeo {
  int heads, dh, d, ld;
  int lanes;   // lanes of a head group: 32 / P, P the power of two >= heads
  int chunks;  // chunks of a head: dh / kVec
  int rounds;  // passes over a head's chunks, kPer chunks a lane each
  float slope;
};

// One warp's staging: a run's scores, dots and coefficients, its row's D and lse.
struct BwdStage {
  float score[kRun * kBwdHeads];
  float dot[kRun * kBwdHeads];
  float coeff[kRun];
  float big_d[kBwdHeads];
  float lse[kBwdHeads];
};

// A chunk of a row in device memory, read through the non-coherent cache.
template <int kChunk>
__device__ __forceinline__ Raw<kChunk> load_global(const unsigned char* p) {
  Raw<kChunk> r;
  if constexpr (kChunk == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r.u[0] = q.x;
    r.u[1] = q.y;
    r.u[2] = q.z;
    r.u[3] = q.w;
  } else if constexpr (kChunk == 4) {
    r.u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.u[0] = __ldg(p);
  }
  return r;
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

// v summed over the lane's head group of `lanes` lanes (a power of two, the
// groups aligned), in a fixed butterfly order; every lane of the group gets it.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kM partial sums (of kM in-edges) summed over head groups of 2 * kO lanes
// at once: each butterfly step keeps half of the values and sends the other
// half (a reduce-scatter), until one value is left, then plain steps. Each
// edge's sum is the same tree of adds as group_sum's, so the same bits; see
// scatter_base for which edges a lane ends with.
template <int kO, int kM, int kU>
__device__ __forceinline__ void scatter_sum(float (&v)[kU], int lane) {
  if constexpr (kO >= 1) {
    if constexpr (kM > 1) {
      const bool hi = (lane & kO) != 0;
#pragma unroll
      for (int t = 0; t < kM / 2; ++t) {
        const float send = hi ? v[t] : v[t + kM / 2];
        const float keep = hi ? v[t + kM / 2] : v[t];
        v[t] = keep + __shfl_xor_sync(0xffffffffu, send, kO);
      }
      scatter_sum<kO / 2, kM / 2, kU>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], kO);
      scatter_sum<kO / 2, 1, kU>(v, lane);
    }
  }
}

// The first of the edges whose sums lane j of a group of kLanes holds after
// scatter_sum of kU values: max(1, kU / kLanes) consecutive ones.
template <int kLanes, int kU>
__device__ __forceinline__ int scatter_base(int j) {
  int u0 = 0;
#pragma unroll
  for (int o = kLanes / 2, m = kU; o >= 1 && m > 1; o >>= 1, m >>= 1)
    if (j & o) u0 += m / 2;
  return u0;
}

// The lane's kPer chunks of round r of head h of the f32 row p (zeros where
// the head has no such chunk).
template <int kVec, int kPer>
__device__ __forceinline__ void load_row_f32(const float* p, int lanes, int chunks, bool on,
                                             int j, int r, float (&v)[kPer][kVec]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = j + lanes * (r * kPer + k);
#pragma unroll
    for (int q = 0; q < kVec; ++q) v[k][q] = 0.f;
    if (on && c < chunks) load_f32<kVec>(p + c * kVec, v[k]);
  }
}

// kLanes: the head group's lanes at compile time (the dots of kEdges in-edges
// summed by scatter_sum), or 0: geo.lanes, one group_sum an edge.
template <typename T, int kChunk, bool kAttn, int kPer, int kLanes>
__global__ void __launch_bounds__(kBwdWarps * 32, sizeof(T) == 1 ? kCodeMinBlocks : kMinBlocks)
    gat_bwd_kernel(const T* __restrict__ x, const float* __restrict__ qscale,
                   const float* __restrict__ qzero, const float* __restrict__ g,
                   const float* __restrict__ out, const float* __restrict__ lse,
                   const float* __restrict__ scores, const float* __restrict__ coeff,
                   const int* __restrict__ indices, const int* __restrict__ items,
                   int num_items, float* __restrict__ res_a, float* __restrict__ res_b,
                   BwdGeo geo) {
  constexpr int kVec = kChunk / static_cast<int>(sizeof(T));  // elements of a chunk
  constexpr int kWords = kChunk >= 4 ? kChunk / 4 : 1;        // registers of a chunk
  constexpr int kBudget = sizeof(T) == 4 ? kRawWords : kCodeWords;
  constexpr int kEdges = kBudget / (kPer * kWords) > 0 ? kBudget / (kPer * kWords) : 1;
  static_assert((kEdges & (kEdges - 1)) == 0, "edges in flight: a power of two");
  // The sums a lane holds after the reduction: each lane of a group one or
  // more of the kEdges (scatter_sum), or lane 0 of the group all of them.
  constexpr int kHeld = kLanes == 0 ? kEdges : kEdges > kLanes ? kEdges / kLanes : 1;
  __shared__ BwdStage stages[kBwdWarps];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  BwdStage& st = stages[warp];
  const int heads = geo.heads;
  const int lanes = kLanes > 0 ? kLanes : geo.lanes;
  const int h = lane / lanes;  // this lane's head
  const int j = lane - h * lanes;
  const bool on = h < heads;   // lanes past the last head load nothing
  const int head_elem = h * geo.dh;
  // The edges of a group of kEdges whose dots this lane writes.
  int u0 = 0;
  bool writes = j == 0;
  if constexpr (kLanes > 0) {
    u0 = scatter_base<kLanes, kEdges>(j);
    writes = kEdges >= kLanes || j % (kLanes / kEdges) == 0;
  }
  writes = writes && on;
  float scale = 1.f, zero = 0.f;
  if constexpr (sizeof(T) == 1) {
    scale = *qscale;
    zero = *qzero;
  }
  const int stride = gridDim.x * kBwdWarps;
  int item = blockIdx.x * kBwdWarps + warp;
  int meta[3] = {0, 0, 0};
  if (item < num_items) {
#pragma unroll
    for (int q = 0; q < 3; ++q) meta[q] = items[3 * item + q];
  }
  for (; item < num_items; item += stride) {
    const int i = meta[0], e_lo = meta[1], e_hi = meta[2];
    if (item + stride < num_items) {  // the next item's, in flight while this one runs
#pragma unroll
      for (int q = 0; q < 3; ++q) meta[q] = items[3 * (item + stride) + q];
    }
    __syncwarp();  // the last item's epilogue has read the stage

    // Stage the run [lo, lo + run): cp.async of its scores, coeff (and lse_i
    // once an item), two of its sources a lane in registers.
    int src0 = 0, src1 = 0;
    auto stage = [&](int lo, int run, bool first) {
      if constexpr (kAttn) {
        for (int p = lane; p < run * heads; p += 32)
          cp_async4(smem_u32(&st.score[p]), scores + static_cast<int64_t>(lo) * heads + p);
        if (first && lane < heads)
          cp_async4(smem_u32(&st.lse[lane]), lse + static_cast<int64_t>(i) * heads + lane);
      }
      if (coeff != nullptr)
        for (int k = lane; k < run; k += 32) cp_async4(smem_u32(&st.coeff[k]), coeff + lo + k);
      cp_async_commit();
      src0 = lane < run ? __ldg(indices + lo + lane) : 0;
      src1 = lane + 32 < run ? __ldg(indices + lo + 32 + lane) : 0;
    };
    stage(e_lo, min(kRun, e_hi - e_lo), true);

    // g_i (round 0) in registers; D_i,h = g_i,h . out_i,h over every round.
    const float* g_row = g + static_cast<int64_t>(i) * geo.d + head_elem;
    float gv[kPer][kVec];
    load_row_f32<kVec, kPer>(g_row, lanes, geo.chunks, on, j, 0, gv);
    if constexpr (kAttn) {
      // One chunk of g and out at a time beyond g's registers.
      const float* o_row = out + static_cast<int64_t>(i) * geo.d + head_elem;
      float part = 0.f;
      for (int r = 0; r < geo.rounds; ++r) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int c = j + lanes * (r * kPer + k);
          if (!on || c >= geo.chunks) continue;
          float gr[kVec], ov[kVec];
          load_f32<kVec>(o_row + c * kVec, ov);
          if (r == 0) {
#pragma unroll
            for (int q = 0; q < kVec; ++q) gr[q] = gv[k][q];
          } else {
            load_f32<kVec>(g_row + c * kVec, gr);
          }
#pragma unroll
          for (int q = 0; q < kVec; ++q) part += gr[q] * ov[q];
        }
      }
      part = group_sum(part, lanes);
      if (on && j == 0) st.big_d[h] = part;
    }

    for (int lo = e_lo;;) {
      const int run = min(kRun, e_hi - lo);
      for (int r = 0; r < geo.rounds; ++r) {
        if (geo.rounds > 1) load_row_f32<kVec, kPer>(g_row, lanes, geo.chunks, on, j, r, gv);
        for (int b = 0; b < run; b += kEdges) {
          // Every row of kEdges in-edges in flight before any is used.
          Raw<kChunk> raw[kEdges][kPer];
#pragma unroll
          for (int u = 0; u < kEdges; ++u) {
            const int k = b + u;
            const int src = __shfl_sync(0xffffffffu, k < 32 ? src0 : src1, k & 31);
            const unsigned char* row = reinterpret_cast<const unsigned char*>(
                x + static_cast<int64_t>(src) * geo.ld + head_elem);
#pragma unroll
            for (int c = 0; c < kPer; ++c) {
              const int chunk = j + lanes * (r * kPer + c);
#pragma unroll
              for (int w = 0; w < kWords; ++w) raw[u][c].u[w] = 0u;
              if (on && k < run && chunk < geo.chunks)
                raw[u][c] = load_global<kChunk>(row + chunk * kChunk);
            }
          }
          float acc[kEdges];
#pragma unroll
          for (int u = 0; u < kEdges; ++u) {
            acc[u] = 0.f;
#pragma unroll
            for (int c = 0; c < kPer; ++c) {
              float xv[kVec];
              decode<T, kChunk, kVec>(raw[u][c], xv, scale, zero);
#pragma unroll
              for (int q = 0; q < kVec; ++q) acc[u] += gv[c][q] * xv[q];
            }
          }
          if constexpr (kLanes > 0) {
            scatter_sum<kLanes / 2, kEdges, kEdges>(acc, lane);
          } else {
#pragma unroll
            for (int u = 0; u < kEdges; ++u) acc[u] = group_sum(acc[u], lanes);
          }
#pragma unroll
          for (int t = 0; t < kHeld; ++t) {
            const int k = b + u0 + t;
            if (writes && k < run) {
              float& slot = st.dot[k * heads + h];
              slot = r == 0 ? acc[t] : slot + acc[t];
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncwarp();
      // Epilogue over the run's [run * H] block, contiguous in res_a/res_b.
      const int64_t base = static_cast<int64_t>(lo) * heads;
      for (int p = lane; p < run * heads; p += 32) {
        const int k = p / heads;
        const int hh = p - k * heads;
        const float c = coeff != nullptr ? st.coeff[k] : 1.f;
        const float v = st.dot[p];
        if constexpr (kAttn) {
          const float s = st.score[p];
          const bool pos = s >= 0.f;
          const float a = expf((pos ? s : geo.slope * s) - st.lse[hh]);
          res_a[base + p] = a;
          res_b[base + p] = a * (c * v - st.big_d[hh]) * (pos ? 1.f : geo.slope);
        } else {
          res_a[base + p] = c * v;
        }
      }
      lo += run;
      if (lo >= e_hi) break;
      __syncwarp();  // the epilogue has read the stage
      stage(lo, min(kRun, e_hi - lo), false);
    }
  }
}

template <typename T, int kChunk, bool kAttn, int kPer, int kLanes>
int launch_one(int device, const void* x, const float* qscale, const float* qzero,
               const float* g, const float* out, const float* lse, const float* scores,
               const float* coeff, const int* indices, const int* items, int num_items,
               float* res_a, float* res_b, const BwdGeo& geo, cudaStream_t stream) {
  auto kernel = gat_bwd_kernel<T, kChunk, kAttn, kPer, kLanes>;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdWarps * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int need = (num_items + kBwdWarps - 1) / kBwdWarps;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const int blocks = need < resident ? need : resident;
  kernel<<<blocks, kBwdWarps * 32, 0, stream>>>(static_cast<const T*>(x), qscale, qzero, g, out,
                                                lse, scores, coeff, indices, items, num_items,
                                                res_a, res_b, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kChunk, int kPer, int kLanes>
int launch_mode(int attn, int device, const void* x, const float* qscale, const float* qzero,
                const float* g, const float* out, const float* lse, const float* scores,
                const float* coeff, const int* indices, const int* items, int num_items,
                float* res_a, float* res_b, const BwdGeo& geo, cudaStream_t stream) {
  if (attn)
    return launch_one<T, kChunk, true, kPer, kLanes>(device, x, qscale, qzero, g, out, lse,
                                                     scores, coeff, indices, items, num_items,
                                                     res_a, res_b, geo, stream);
  return launch_one<T, kChunk, false, kPer, kLanes>(device, x, qscale, qzero, g, out, lse,
                                                    scores, coeff, indices, items, num_items,
                                                    res_a, res_b, geo, stream);
}

// 4-element chunks: the head group's lanes and the chunks a lane takes a
// round at compile time.
template <typename T, int kChunk>
int launch_vec4(int attn, int k_per, int device, const void* x, const float* qscale,
                const float* qzero, const float* g, const float* out, const float* lse,
                const float* scores, const float* coeff, const int* indices, const int* items,
                int num_items, float* res_a, float* res_b, const BwdGeo& geo,
                cudaStream_t stream) {
#define AMPLE_GAT_BWD(P, L)                                                                   \
  if (k_per == P && geo.lanes == L)                                                           \
    return launch_mode<T, kChunk, P, L>(attn, device, x, qscale, qzero, g, out, lse, scores, \
                                        coeff, indices, items, num_items, res_a, res_b, geo, \
                                        stream)
  AMPLE_GAT_BWD(2, 4);
  AMPLE_GAT_BWD(2, 8);
  AMPLE_GAT_BWD(2, 16);
  AMPLE_GAT_BWD(2, 32);
  AMPLE_GAT_BWD(4, 4);
  AMPLE_GAT_BWD(4, 8);
  AMPLE_GAT_BWD(4, 16);
  AMPLE_GAT_BWD(4, 32);
#undef AMPLE_GAT_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The GAT backward over num_items work items, items [num_items, 3] of
// (destination, first edge, end edge) of the in-edge CSR whose sources are
// indices [E] (an item may hold any number of edges). x: the forward's rows
// [N, heads * dh], f32 (elem_bytes 4) or int8 codes (elem_bytes 1, with
// device scalars qscale and qzero), ld elements apart; g (and out,
// attention): f32 [N, heads * dh] contiguous; lse f32 [N, heads]; scores raw
// f32 [E, heads]; coeff f32 [E] or null (ones). attn 1: res_a = alpha, res_b
// = ds; attn 0: res_a = the coefficients' gradient (lse, scores, out and
// res_b unused). chunk_bytes: 16 (f32) or 4 (codes) when every row is
// 16-byte aligned (4-byte for codes) and heads * dh is a multiple of 4, else
// 4 (f32) or 1 (codes); 4-element chunks are taken only when dh is a
// multiple of 4 too. Edges of other rows are not written. A call that does
// not fit (heads > 8, rows wider than 512 elements) is refused with
// cudaErrorInvalidValue.
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
  int vec = elem_bytes > 0 ? chunk_bytes / elem_bytes : 0;
  const bool ok = (vec == 4 || vec == 1) && dh > 0 && d % vec == 0 && d <= kBwdWidth &&
                  heads > 0 && heads <= kBwdHeads && ld >= d &&
                  (elem_bytes == 1 ? qscale != nullptr && qzero != nullptr : elem_bytes == 4) &&
                  (!attn || (out != nullptr && lse != nullptr && scores != nullptr &&
                             res_b != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (num_items <= 0) return static_cast<int>(cudaGetLastError());
  if (dh % vec != 0) vec = 1;  // a 4-element chunk would straddle two heads
  int groups = 1;
  while (groups < heads) groups <<= 1;
  BwdGeo geo;
  geo.heads = heads;
  geo.dh = dh;
  geo.d = d;
  geo.ld = ld;
  geo.lanes = 32 / groups;
  geo.chunks = dh / vec;
  geo.slope = slope;
  const int per = (geo.chunks + geo.lanes - 1) / geo.lanes;  // chunks a lane, all rounds
  const int k_per = vec == 4 && per <= 2 ? 2 : 4;
  geo.rounds = (per + k_per - 1) / k_per;
#define AMPLE_GAT_BWD_ARGS                                                                  \
  device, x, qscale, qzero, g, out, lse, scores, coeff, indices, items, num_items, res_a, res_b, \
      geo, stream
  if (elem_bytes == 4) {
    if (vec == 4) return launch_vec4<float, 16>(attn, k_per, AMPLE_GAT_BWD_ARGS);
    return launch_mode<float, 4, 4, 0>(attn, AMPLE_GAT_BWD_ARGS);
  }
  if (vec == 4) return launch_vec4<int8_t, 4>(attn, k_per, AMPLE_GAT_BWD_ARGS);
  return launch_mode<int8_t, 1, 4, 0>(attn, AMPLE_GAT_BWD_ARGS);
#undef AMPLE_GAT_BWD_ARGS
}
