// int8 FTE (Feature Transformation Engine) for Hopper: int8 x int8 -> int32.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/quant_matmul/repack.py::_repacked_call (_kernel) and
//   repro/kernels/quant_matmul/quant_matmul.py::quant_matmul_kernel_call
// which compute the same product, from a tiled and from a plain weight.
//
// Computes out[M, N] = a[M, K] @ w[K, N] with exact int32 accumulation, bitwise
// equal to the reference (integer sums do not depend on order). No overflow is
// possible for K <= 131071, since K * 128 * 128 < 2^31.
//
// What bounds it on an H100: device-memory bytes at the serving shapes. For
// the Yelp int8 group (M = 695,342, K = 300, N = 256) the int32 output alone is
// 712 MB against 107 G int8 operations, about 115 operations per byte, below
// the ~590 operations per byte at which the int8 tensor cores would bound it.
// So the design streams: each byte of a is read from device memory once, each
// output written once with full 16-byte stores, and the weight stays on chip.
//
// Design. The weight is relaid once at load time (repack.py) as w[N, Kp], K
// contiguous and zero-padded to a multiple of 16. The grid is persistent (as
// many blocks as fit: two per SM at the served shapes): a block owns one
// 128-column group of the output and walks 64-row tiles of a (tile first +
// i * step), so the column groups of one row tile run side by side and all
// but the first read a from L2. The block's weight columns stay
// resident in shared memory for the whole walk; a weight too large for that
// streams through the same loop in K chunks of 256 bytes beside each a chunk.
// a's tiles come in through a three-stage cp.async ring (16-byte copies when
// a's rows are 16-byte aligned, 4-byte when 4-byte aligned); rows at any
// other alignment (an odd K, a base off a word boundary) are still taken,
// staged by plain loads of aligned words shifted into place. Shared
// rows have a stride of an odd number of 16-byte chunks, so ldmatrix reads
// them without bank conflicts. The products run on the int8 tensor cores
// (mma.sync.m16n8k32 s8 x s8 -> s32): 8 warps, each 32 rows x 32 columns.
// K is walked in 32-byte steps up to Kp rounded to 32; the weight's zeros
// past K (and the columns zero-filled up to the step) cancel whatever a's
// shared rows hold there. The epilogue pairs neighbouring threads with one
// shuffle so each writes 4 consecutive int32 (16 bytes, streaming stores).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;         // output rows per tile
constexpr int kBN = 128;        // output columns per block (one column group)
constexpr int kWarps = 8;
constexpr int kWarpsM = kBM / 32;          // warps along M, 32 rows each
constexpr int kNT = kBN / (kWarps / kWarpsM) / 8;  // 8-column mma tiles per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;      // a tiles in flight
constexpr int kChunk = 256;     // K bytes per stage when the weight streams
constexpr int kSmemMax = 232448;  // 227 KB a block may use on an H100

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 bytes at p, at any alignment, from the aligned words that hold them;
// the second word is read only if it holds a byte before `end`.
__device__ __forceinline__ uint32_t load_unaligned(const int8_t* p, uintptr_t end) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo_at = addr & ~static_cast<uintptr_t>(3);
  const int shift = static_cast<int>(addr & 3) * 8;
  const uint32_t lo = *reinterpret_cast<const uint32_t*>(lo_at);
  const uint32_t hi =
      shift && lo_at + 4 < end ? *reinterpret_cast<const uint32_t*>(lo_at + 4) : 0u;
  return __funnelshift_r(lo, hi, shift);
}

struct Geometry {
  int m, k, n, kp;
  int kp32;  // K walked in 32-byte steps up to here
  int kc;    // K bytes per chunk (kp32 when the weight is resident)
  int ks;    // shared row stride in bytes: an odd number of 16-byte chunks
  int nkc;   // chunks per row tile
};

// kCopy: bytes per cp.async copy of a (16 or 4); 1 = shifted plain loads.
// kResident: the block's weight columns stay in shared memory for the walk.
template <int kCopy, bool kResident>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ w, int32_t* __restrict__ out,
    Geometry geo) {
  extern __shared__ __align__(128) int8_t smem[];
  const int m = geo.m, k = geo.k, n = geo.n, kp = geo.kp, kp32 = geo.kp32, kc = geo.kc,
            ks = geo.ks, nkc = geo.nkc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;  // rows 32 wm, columns 8 kNT wn
  const int g = lane >> 2, t = lane & 3;
  const int ng = (n + kBN - 1) / kBN;
  const int n0 = (blockIdx.x % ng) * kBN;
  const int64_t first = blockIdx.x / ng, step = gridDim.x / ng;
  const int64_t mt = (static_cast<int64_t>(m) + kBM - 1) / kBM;
  const int64_t tiles = first < mt ? (mt - 1 - first) / step + 1 : 0;
  const int64_t items = tiles * nkc;  // (tile, chunk) pairs, chunk fastest
  const uintptr_t a_end = reinterpret_cast<uintptr_t>(a + static_cast<int64_t>(m) * k);

  // Shared memory: resident [W kBN x ks][A stage x kStages]; streamed
  // [A, W] per stage.
  auto stage_a = [&](int st) -> int8_t* {
    return kResident ? smem + (kBN + st * kBM) * ks : smem + st * (kBM + kBN) * ks;
  };
  auto stage_w = [&](int st) -> int8_t* {
    return kResident ? smem : smem + st * (kBM + kBN) * ks + kBM * ks;
  };

  // Weight columns [n0, n0 + kBN) x K bytes [c0, c0 + span) into dst; bytes
  // in [kp, kp32) are zero-filled, rows past n are left alone (their outputs
  // are never stored).
  auto load_w = [&](int8_t* dst, int c0, int span) {
    const int units = span / 16;
    const uint32_t base = smem_u32(dst);
    for (int r = warp; r < kBN && n0 + r < n; r += kWarps) {
      const int8_t* src = w + static_cast<int64_t>(n0 + r) * kp + c0;
      for (int u = lane; u < units; u += 32) {
        const bool in = c0 + 16 * u < kp;
        cp_async16(base + r * ks + 16 * u, in ? src + 16 * u : w, in ? 16 : 0);
      }
    }
  };

  auto issue = [&](int64_t item, int st) {
    const int64_t tile = first + (item / nkc) * step;
    const int c0 = static_cast<int>(item % nkc) * kc;
    const int64_t m0 = tile * kBM;
    const int cols = min(kc, k - c0);  // >= 1: c0 < kp32 is a multiple of 32
    const int units = cols / kCopy;  // kCopy 16 and 4: k % kCopy == 0
    int8_t* dst = stage_a(st);
    if (kCopy > 1) {
      const uint32_t base = smem_u32(dst);
      for (int r = warp; r < kBM && m0 + r < m; r += kWarps) {
        const int8_t* src = a + (m0 + r) * k + c0;
        for (int u = lane; u < units; u += 32) {
          if (kCopy == 16)
            cp_async16(base + r * ks + 16 * u, src + 16 * u, 16);
          else
            cp_async4(base + r * ks + 4 * u, src + 4 * u);
        }
      }
    } else {
      // Rows at any byte alignment: each 4 bytes of a row from the two
      // aligned words that hold them, shifted into place, with the loads of
      // kBatch words in flight before their stores. Bytes past the row's end
      // land past K in shared memory, where the weight is zero.
      constexpr int kBatch = 8;
      const int words = (cols + 3) / 4;
      const int slots = kBM * words;
      for (int s0 = threadIdx.x; s0 < slots; s0 += kBatch * kThreads) {
        uint32_t val[kBatch];
        int at[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int sl = s0 + i * kThreads;
          const int r = sl / words, u = sl - r * words;
          const bool ok = sl < slots && m0 + r < m;
          at[i] = ok ? r * ks + 4 * u : -1;
          val[i] = ok ? load_unaligned(a + (m0 + r) * k + c0 + 4 * u, a_end) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (at[i] >= 0) *reinterpret_cast<uint32_t*>(dst + at[i]) = val[i];
      }
    }
    if (!kResident) load_w(stage_w(st), c0, min(kc, kp32 - c0));
  };

  if (kResident) load_w(smem, 0, kp32);  // lands with item 0's group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) issue(s, s);
    cp_async_commit();
  }

  int32_t acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const bool vec_out = n % 4 == 0;

  for (int64_t it = 0; it < items; ++it) {
    cp_async_wait<kStages - 2>();  // item it has landed
    __syncthreads();               // ... for every thread; stage (it - 1) % kStages is free
    if (it + kStages - 1 < items) issue(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();

    const int st = static_cast<int>(it % kStages);
    const int c = static_cast<int>(it % nkc);
    const int steps = min(kc, kp32 - c * kc) / 32;
    const uint32_t a_base =
        smem_u32(stage_a(st)) + (32 * wm + (lane & 15)) * ks + 16 * (lane >> 4);
    const uint32_t w_base = smem_u32(stage_w(st)) +
                            (8 * kNT * wn + (lane & 7) + ((lane >> 4) << 3)) * ks +
                            16 * ((lane >> 3) & 1);
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      uint32_t af[2][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], a_base + 16 * i * ks + 32 * s);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, w_base + 16 * jp * ks + 32 * s);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    if (c != nkc - 1) continue;

    // Epilogue: thread (g, t) holds rows g and g + 8, columns 2t, 2t + 1 of
    // each 16 x 8 tile. Even t takes its odd neighbour's row-g pair, odd t
    // its even neighbour's row-(g + 8) pair: 4 consecutive columns each.
    const int64_t m0 = (first + (it / nkc) * step) * kBM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int64_t row = m0 + 32 * wm + 16 * i + g;
        const int col = n0 + 8 * kNT * wn + 8 * j + 2 * t;
        int32_t* d = acc[i][j];
        const bool odd = t & 1;
        const int32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
        const int32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
        if (vec_out) {
          const int64_t orow = odd ? row + 8 : row;
          const int ocol = odd ? col - 2 : col;
          if (orow < m && ocol < n)
            __stcs(reinterpret_cast<int4*>(out + orow * n + ocol),
                   odd ? make_int4(r0, r1, d[2], d[3]) : make_int4(d[0], d[1], r0, r1));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t orow = row + (e >= 2 ? 8 : 0);
            const int ocol = col + (e & 1);
            if (orow < m && ocol < n) out[orow * n + ocol] = d[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = 0;
      }
    }
  }
}

// Persistent grid: as many blocks as fit on the card at once, a whole number
// per column group (at least one each).
template <int kCopy, bool kResident>
int launch(const int8_t* a, const int8_t* w, int32_t* out, const Geometry& geo, int bytes,
           int sms, cudaStream_t stream) {
  auto kernel = quant_matmul_kernel<kCopy, kResident>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ng = (geo.n + kBN - 1) / kBN;
  const int64_t mt = (static_cast<int64_t>(geo.m) + kBM - 1) / kBM;
  const int64_t per_group = per_sm * sms / ng > 0 ? per_sm * sms / ng : 1;
  const int blocks = static_cast<int>(ng * (mt < per_group ? mt : per_group));
  kernel<<<blocks, kThreads, bytes, stream>>>(a, w, out, geo);
  return static_cast<int>(cudaGetLastError());
}

template <int kCopy>
int launch_copy(const int8_t* a, const int8_t* w, int32_t* out, const Geometry& geo,
                bool resident, int bytes, int sms, cudaStream_t stream) {
  return resident ? launch<kCopy, true>(a, w, out, geo, bytes, sms, stream)
                  : launch<kCopy, false>(a, w, out, geo, bytes, sms, stream);
}

}  // namespace

// a: int8[m, k] row-major; w: int8[n, kp] row-major (kp % 16 == 0, kp >= k,
// zeros past k, 16-byte aligned); out: int32[m, n], 16-byte aligned.
extern "C" int ample_quant_matmul(int device, const int8_t* a, const int8_t* w,
                                  int32_t* out, int m, int k, int n, int kp,
                                  void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  Geometry geo{m, k, n, kp, (kp + 31) / 32 * 32, 0, 0, 0};
  const int resident_ks = geo.kp32 + 16;  // kp32 / 16 is even: one more chunk makes it odd
  const bool resident = (kBN + kStages * kBM) * resident_ks <= kSmemMax;
  geo.kc = resident ? geo.kp32 : kChunk;
  geo.ks = resident ? resident_ks : kChunk + 16;
  geo.nkc = (geo.kp32 + geo.kc - 1) / geo.kc;
  const int bytes = resident ? (kBN + kStages * kBM) * geo.ks : kStages * (kBM + kBN) * geo.ks;

  const uintptr_t ap = reinterpret_cast<uintptr_t>(a);
  if (k % 16 == 0 && ap % 16 == 0)
    return launch_copy<16>(a, w, out, geo, resident, bytes, sms, stream);
  if (k % 4 == 0 && ap % 4 == 0)
    return launch_copy<4>(a, w, out, geo, resident, bytes, sms, stream);
  return launch_copy<1>(a, w, out, geo, resident, bytes, sms, stream);
}
