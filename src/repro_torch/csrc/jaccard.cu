// Packed-bitmap Jaccard distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jaccard_distance_pallas (_jaccard_kernel)
// of repro/kernels/jaccard/kernel.py.  Input: (Q, W) and (K, W) bitmaps of
// 32-bit words (carried as int32 tensors, read here as the same bits);
// output: the (Q, K) float32 distance 1 - popc(a&b) / popc(a|b), and 0
// when both sets are empty.  Two designs, chosen per call by
// kernels/jaccard/ops.py variant() from the shape alone:
//
// "row" (jaccard_kernel): one thread per output element loops over the W
// words with the hardware popcount (__popc), where the TPU kernel ran a
// SWAR popcount over (BQ, BK, W) broadcast tiles in VMEM.  Rows are read
// straight from device memory, so the 32 lanes of a warp read 32 rows of
// b, W words apart: each 4-byte load touches 32 cache lines.  That is
// cheap at the KG rounds' few words and bound by L1 wavefronts from tens
// of words up.
//
// "tile" (jaccard_tile_kernel, below): a block per output tile, both
// panels staged in shared memory with coalesced copies, and half the
// popcounts (|A| + |B| - |A&B| for the union).
//
// The division and the subtraction are written as the round-to-nearest
// intrinsics, and the library is built without --use_fast_math: the
// result must be bitwise equal to the IEEE float32 arithmetic of the
// reference, because single-linkage HAC merges, and with them the layouts,
// change with one bit of a distance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void jaccard_kernel(const uint32_t* __restrict__ a, int64_t q,
                               const uint32_t* __restrict__ b, int64_t k,
                               int64_t w, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= q * k) return;
  const uint32_t* ra = a + (t / k) * w;
  const uint32_t* rb = b + (t % k) * w;
  int inter = 0;
  int uni = 0;
  for (int64_t x = 0; x < w; ++x) {
    const uint32_t u = ra[x];
    const uint32_t v = rb[x];
    inter += __popc(u & v);
    uni += __popc(u | v);
  }
  out[t] = uni > 0
               ? __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(inter),
                                           __int2float_rn(uni)))
               : 0.0f;
}

}  // namespace

extern "C" int rt_jaccard_distance(const int32_t* a, int64_t q,
                                   const int32_t* b, int64_t k, int64_t w,
                                   float* out, void* stream) {
  const int64_t n = q * k;
  if (n > 0) {
    jaccard_kernel<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(a), q,
        reinterpret_cast<const uint32_t*>(b), k, w, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "tile": a block per output tile, panels in shared memory
//
// Each block of kTileThreads threads computes a kTileQ x kTileK tile of
// the output: rows q0 .. q0 + 7 of a against rows k0 .. k0 + 7 of b (past
// the edge the last row again, its outputs not written).  The word axis
// passes in chunks of kChunk words; both panels of a chunk are copied into
// shared memory with cp.async, 16 bytes a copy where the operand's rows
// are 16-byte aligned (an aligned pointer and W a multiple of 4), else 4
// bytes a copy, and the chunk is padded with zero words to a multiple of
// 4 (a zero word adds nothing to any count).  Two chunk buffers: chunk
// c + 1 is copied while chunk c is counted.
//
// Warp g (0..3) holds a-rows g and g + 4; lane l holds b-rows l / 8 and
// l / 8 + 4 and takes the 16-byte groups l % 8 and l % 8 + 8 of each
// chunk, so each lane counts a 2 x 2 micro-tile over an eighth of the
// words, and the eight lanes of a micro-tile add their counts with three
// xor shuffles.  The 8 lanes of one 16-byte load phase read 8 consecutive
// groups of one row, 128 contiguous bytes, so the panel rows need no
// padding against bank conflicts.
//
// Only popc(a & b) is counted per pair.  Each panel row's own count is
// taken once a block: thread t copies and counts 16-byte group t % 16 of
// rows t / 16 (of a) and t / 16 + 8 (of b), and the 16 threads of a row
// add their counts with four xor shuffles at the end.  The union is then
// |A| + (|B| - |A&B|): an identity of integers, so the counts, and the
// float result, have the same bits as the plain version's (and no sum
// exceeds 32 W < 2^31, which is why ops.distance takes W < 2^26).  Per
// pair and word this is one AND and one popcount, where the row kernel
// ran two of each; the popcount (16 a clock an SM at compute capability
// 9.0) bounds the tile kernel at large shapes.
//
// At the MoE placement shapes ((64, 64) and (128, 64) words) a block has
// one chunk and each lane 32 popcounts, so its time is a chain of
// latencies: the 8 x 8 tile spreads (64, 64) over 64 SMs and (128, 64)
// over all of them, and every loop over a chunk has a trip count known at
// compile time and is unrolled, its ragged end predicated, so that each
// phase issues all its loads at once.

namespace {

constexpr int kTileQ = 8;             // a-rows of a block's output tile
constexpr int kTileK = 8;             // b-rows of a block's output tile
constexpr int kTileThreads = 128;     // 4 warps
constexpr int kChunk = 64;            // words of a panel chunk
constexpr int kSplit = 8;             // lanes sharing a micro-tile's words
constexpr int kRows = kTileQ + kTileK;
constexpr int kGroups = kChunk / 4;   // 16-byte groups of a chunk row
constexpr int kRowStep = kTileThreads / kGroups;   // rows a copy pass
constexpr int kPasses = kRows / kRowStep;
static_assert(kRowStep == kTileQ, "copy pass 0 is a, passes 1.. are b");
static_assert(kRows % kRowStep == 0 && kGroups % kSplit == 0, "tiling");
static_assert(kTileThreads == 32 * kTileQ / 2 && kTileK / 2 * kSplit == 32,
              "warp g holds a-rows g, g + 4; its lanes b-rows by eighths");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int popc4(const uint4& u) {
  return __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w);
}

__device__ __forceinline__ int popc_and(const uint4& u, const uint4& v) {
  return __popc(u.x & v.x) + __popc(u.y & v.y) + __popc(u.z & v.z) +
         __popc(u.w & v.w);
}

__global__ void __launch_bounds__(kTileThreads)
jaccard_tile_kernel(const uint32_t* __restrict__ a, int64_t q,
                    const uint32_t* __restrict__ b, int64_t k, int64_t w,
                    unsigned int tiles_k, float* __restrict__ out) {
  __shared__ __align__(16) uint32_t panel[2][kRows][kChunk];
  __shared__ int count[kRows];        // |row| of each panel row
  const int64_t q0 = static_cast<int64_t>(blockIdx.x / tiles_k) * kTileQ;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x % tiles_k) * kTileK;
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && w % 4 == 0;
  const bool vec_b = reinterpret_cast<uintptr_t>(b) % 16 == 0 && w % 4 == 0;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int s = lane % kSplit, gk = lane / kSplit; // the micro-tile
  const int cg = t % kGroups, cr = t / kGroups;    // copies and row counts
  // panel row r: a-row q0 + r below kTileQ, else b-row k0 + r - kTileQ
  auto src_row = [&](int r) -> const uint32_t* {
    if (r < kTileQ) {
      const int64_t row = q0 + r;
      return a + (row < q ? row : q - 1) * w;
    }
    const int64_t row = k0 + r - kTileQ;
    return b + (row < k ? row : k - 1) * w;
  };
  auto words = [&](int64_t c) {       // words of chunk c
    const int64_t left = w - c * kChunk;
    return static_cast<int>(left < kChunk ? left : kChunk);
  };
  auto stage = [&](int64_t c) {       // group cg of rows cr + kRowStep i
    const int64_t x0 = c * kChunk;
    const int cw = words(c);
    if (4 * cg >= ((cw + 3) & ~3)) return;
    uint32_t (*p)[kChunk] = panel[c & 1];
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = cr + kRowStep * i;
      uint32_t* dst = &p[r][4 * cg];
      const uint32_t* src = src_row(r) + x0 + 4 * cg;
      if (i == 0 ? vec_a : vec_b) {
        cp_async16(dst, src);            // 16 bytes a copy
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {    // 4 bytes a copy, zeros past cw
          if (4 * cg + e < cw) {
            cp_async4(dst + e, src + e);
          } else {
            dst[e] = 0u;
          }
        }
      }
    }
  };
  const int64_t n_chunks = (w + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(0);
  cp_async_commit();
  int rc[kPasses] = {};               // counts of rows cr + kRowStep i
  int i00 = 0, i01 = 0, i10 = 0, i11 = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage(c + 1);
    cp_async_commit();                // possibly empty: the wait below
    cp_async_wait_one();              // leaves only chunk c + 1 in flight
    __syncthreads();
    const int n4 = (words(c) + 3) >> 2;
    uint32_t (*p)[kChunk] = panel[c & 1];
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      if (cg < n4) {
        rc[i] += popc4(*reinterpret_cast<const uint4*>(
            &p[cr + kRowStep * i][4 * cg]));
      }
    }
    const uint4* a0 = reinterpret_cast<const uint4*>(p[warp]);
    const uint4* a1 = reinterpret_cast<const uint4*>(p[warp + 4]);
    const uint4* b0 = reinterpret_cast<const uint4*>(p[kTileQ + gk]);
    const uint4* b1 = reinterpret_cast<const uint4*>(p[kTileQ + 4 + gk]);
#pragma unroll
    for (int it = 0; it < kGroups / kSplit; ++it) {
      const int g = s + kSplit * it;
      if (g < n4) {
        const uint4 u0 = a0[g], u1 = a1[g], v0 = b0[g], v1 = b1[g];
        i00 += popc_and(u0, v0);
        i01 += popc_and(u0, v1);
        i10 += popc_and(u1, v0);
        i11 += popc_and(u1, v1);
      }
    }
    if (c + 2 < n_chunks) __syncthreads();   // stage(c + 2) reuses p
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {  // the 16 threads of a row
#pragma unroll
    for (int m = 1; m < kGroups; m <<= 1) {
      rc[i] += __shfl_xor_sync(0xffffffffu, rc[i], m);
    }
    if (cg == 0) count[cr + kRowStep * i] = rc[i];
  }
#pragma unroll
  for (int m = 1; m < kSplit; m <<= 1) {   // the lanes of a micro-tile
    i00 += __shfl_xor_sync(0xffffffffu, i00, m);
    i01 += __shfl_xor_sync(0xffffffffu, i01, m);
    i10 += __shfl_xor_sync(0xffffffffu, i10, m);
    i11 += __shfl_xor_sync(0xffffffffu, i11, m);
  }
  __syncthreads();
  // lane s < 4 writes output (i, j) = (s / 2, s % 2) of its micro-tile:
  // a-row warp + 4 i against b-row gk + 4 j
  const int i = s >> 1, j = s & 1;
  const int inter = i ? (j ? i11 : i10) : (j ? i01 : i00);
  const int rq = warp + 4 * i, rk = gk + 4 * j;
  const int64_t row = q0 + rq, col = k0 + rk;
  if (s < 4 && row < q && col < k) {
    const int uni = count[rq] + (count[kTileQ + rk] - inter);
    out[row * k + col] =
        uni > 0 ? __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(inter),
                                            __int2float_rn(uni)))
                : 0.0f;
  }
}

}  // namespace

extern "C" int rt_jaccard_tile(const int32_t* a, int64_t q, const int32_t* b,
                               int64_t k, int64_t w, float* out,
                               void* stream) {
  const int64_t tiles_q = (q + kTileQ - 1) / kTileQ;
  const int64_t tiles_k = (k + kTileK - 1) / kTileK;
  const int64_t blocks = tiles_q * tiles_k;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    jaccard_tile_kernel<<<static_cast<unsigned int>(blocks), kTileThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(a), q,
        reinterpret_cast<const uint32_t*>(b), k, w,
        static_cast<unsigned int>(tiles_k), out);
  }
  return static_cast<int>(cudaGetLastError());
}
