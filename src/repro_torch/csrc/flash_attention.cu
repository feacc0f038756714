// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_fwd (_flash_kernel) of
// repro/kernels/flash_attention/kernel.py.  Inputs: q (B, S, H, D) and
// k, v (B, T, K, D), H % K == 0, all float32, all bfloat16 or (the scalar
// and dec kernels) all float16, contiguous;
// output o (B, S, H, D) in q's dtype.  Scores are q.k * (1/sqrt(D)) in
// float32, set to -1e30 where q_offset + i < kpos (causal) or
// kpos >= kv_valid_len; the softmax runs online in float32 (row max m, row
// sum l); o = acc / max(l, 1e-30).  Three kernels compute it; ops.py picks
// one by the call's dtype and shape alone (variant()):
//
// * flash_tc_kernel ("tc": bfloat16, D % 16 == 0, D <= 128, S * H/K >= 64,
//   the prefill) runs both products on the tensor cores (wgmma).  Q, K and
//   V enter exact (they are bfloat16 already) and every sum is float32.  P
//   is carried as P_hi + P_lo, two bfloat16 terms (P_hi = bf16(P),
//   P_lo = bf16(P - P_hi)), each multiplied with V into the same float32
//   accumulator: P keeps about 16 significant bits, a relative error of at
//   most about 2^-16 per element.  Why two terms: P rounded once to
//   bfloat16 (2^-9 relative, as FlashAttention-2/3 do) moves the bf16
//   output past one bf16 step of the float32 function on random inputs,
//   which the card tests and chip_smoke.py hold it to; the two-term
//   product stays inside it (tests/test_torch_flash.py emulates both).
// * flash_decode_kernel ("dec": any of the three dtypes, S * H/K <= 16,
//   the decode steps) and flash_fwd_kernel ("scalar": the rest, float32
//   and float16 calls of more than 16 rows a kv head, bfloat16 ones of 17
//   to 63 rows or with a D the tc kernel does not take) upcast every
//   element to float32 as they read it and accumulate P.V in float32 with
//   P never rounded.
//
// What bounds it on this card: the matrix products.  Prefill attention at
// (B, S, H, K, D) = (4, 2048, 16, 8, 128), causal, is about 6.9e10
// operations (4*B*H*D per valid query-key pair) against about 100 MB of
// q, k, v and o, so its bound is the tensor cores' 989 TFLOP/s (about
// 70 us; the second P term adds half the tensor work again, about 104 us),
// not the 3.35 TB/s of device memory (about 30 us).  A decode step
// (S = 1) against a cache of about 2,080 valid slots reads about 34 MB of
// K/V per layer for 1.7e8 operations: there the bytes bound it.
//
// All three kernels keep the TPU kernel's one saving that matters on both
// machines: no tile past the causal horizon of a block's last row or past
// kv_valid_len is read, so causal prefill does half the work and a decode
// step reads only the valid part of the cache.  q_offset and kv_valid_len
// are runtime arguments, so decode does not specialise.
//
// The tc kernel.  A block owns one (b, query head) pair and 128 query rows,
// two consumer warpgroups of 64; the g query heads of a kv group are
// neighbouring blocks, so their repeated K/V reads come from L2 (all of K
// and V at qwen3-0.6b's prefill shape is 33.5 MB, under the 50 MB L2).
// Row tiles run longest first: the grid's slowest axis walks them from
// the last one.  A producer warp loads the Q tile once and the K and V
// tiles of 64 keys into a ring of kTcStages stages by TMA, each stage with
// a "full" mbarrier (TMA bytes) and an "empty" one (one arrival per
// consumer warp).  Tensor maps are 4-D, (D, heads, positions, B), with
// 128-byte swizzle: a box row is 64 bf16, so a row of D > 64 is two boxes
// and the columns past D (D = 80, 112), the rows past S and the keys past
// T arrive as zeros from TMA's out-of-bounds fill; nothing is padded in
// device memory.  Per tile and warpgroup: S = Q.K^T by D/16 wgmma
// m64n64k16 (Q and K from shared memory, K-major); the online softmax on
// the accumulator fragment in registers, in the reference's order (mask,
// row max, exp(s - m_new), alpha = exp(m_prev - m_new), l and acc scaled
// by alpha), masks only on tiles that cross the causal diagonal or
// kv_valid_len, expf (no fast math, see kernels/_build.py); then
// O += P_hi.V + P_lo.V by wgmma m64nNk16 with P in registers as the A
// operand (the accumulator fragment of S is the A fragment of P.V) and V
// from shared memory as B.  V is stored (key, d), d contiguous: for P.V
// that is MN-major, so B takes the transpose bit; N is D rounded up to 64.
// The epilogue divides by max(l, 1e-30), rounds to bf16 and stores only
// rows < S and columns < D.  The consumers need at most about 170
// registers (two accumulators, both P terms), within the 224 that one
// block of 288 threads per SM may hold, so no setmaxnreg.
//
// The scalar kernel.  A block takes one (b, kv head) pair and kRows
// consecutive (query position, head of the group) rows, so the g query
// heads that share a kv head read each K/V tile once.  The block stages its
// q rows, then walks the keys in tiles of 32 staged in shared memory as
// float32.  Each warp carries kRowsPerWarp rows; for the scores lane j
// takes key j of the tile (K rows padded by 4 floats, so the 16-byte reads
// of 8 neighbouring lanes hit distinct banks), and for P.V lane j owns the
// output dims j, j + 32, ... and takes p of each key by a warp shuffle.
// Each lane keeps a partial row sum l, reduced once at the end; the row max
// is reduced per tile.  Where the TPU padded S and T to its block sizes,
// the ragged edges are masked here: rows past S*g are computed but not
// stored, and keys past the block's range are zero in shared memory and
// masked.
//
// A decode step has one row block per (sequence, kv head): 32 blocks at
// B = 4, K = 8, a quarter of the card's 132 SMs, each walking the whole
// cache one tile at a time.  Where the grid is smaller than one wave the
// caller splits the keys (kv_splits, chosen in ops.py): each block walks
// one contiguous range of whole tiles and writes its row max, row sum and
// unnormalised acc to a float32 scratch, and a second kernel merges the
// splits per output element.
//
// The dec kernel (a decode step).  What bounds it: the bytes of K and V
// (qwen3-0.6b's step reads 34 MB per layer for 1.7e8 operations, 10 us at
// 3.35 TB/s).  What held the scalar kernel back there: its block of 32
// rows computed 30 or 31 padding rows, each of its 8 warps read every K and
// V row of a tile from shared memory, K and V were widened to float32 as
// they were staged, and one synchronous stage left no load in flight while
// it computed (13% of the bytes bound).  The dec kernel instead:
// * takes one (b, kv head, key split) a block, with all S * g <= 16 rows of
//   the group, so each K/V byte is read once per split and no warp
//   computes a padding row (1 and 2 rows are compiled exactly; above, the
//   row count is a bound of 4, 8 or 16 and rows past S * g are skipped);
// * gives each of its 4 warps a slice of 32 / LPK keys of every tile and
//   a ring of kDecStages slices of its own: 16-byte cp.async.cg copies of
//   K and V in their own dtype (keys past the split arrive as zeros without
//   a read), waited for by the warp alone, so no block barrier paces the
//   loop; with 55 KB of ring a block (bf16, D 128) four blocks fit an SM,
//   about 150 KB of an SM's slices in flight.  Each element is widened to
//   float32 as the products read it;
// * for the scores LPK = 4, 8 or 16 lanes share a key (each at most
//   kDecChunks 16-byte chunks of its K row, the row padded so one load phase
//   hits 8 bank groups) and meet by shuffles; for P.V each lane owns 4 (or
//   8) output dims and takes each key's p by a shuffle.  Each warp keeps m,
//   l and acc of every row; a masked key weighs exactly 0, so a warp or
//   split that saw no valid key keeps m = -1e30, l = 0, acc = 0.  The loops
//   are free of row and chunk branches (a chunk past the row reads zeros),
//   so the rows' shuffle and exp chains interleave;
// * merges its warps' states in shared memory, weights e^(m_w - M) once
//   per row, and writes the result, or (kv_splits > 1) its state, which
//   flash_dec_merge_kernel merges across the splits by the same rule.
// ops.py chooses the splits from (B, K, the key count, the SM count): whole
// multiples of 64 keys, aiming at 4 blocks an SM.

#include <cstdint>
#include <cuda.h>           // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

// kernels/flash_attention/ops.py mirrors kRows and kTile (ROWS_PER_BLOCK,
// KEY_TILE) to choose kv_splits
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // (query, head) rows a block
constexpr int kTile = 32;                      // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t s, t, h, kh, d;
  int64_t q_offset;
  int64_t kv_lim;     // min(T, kv_valid_len)
  int64_t splits;     // blocks along the keys per (row block, kv head, b)
  int64_t chunk;      // keys per split, a multiple of kTile
  float* part;        // splits > 1: partial acc, m and l per split
  int causal;
  float scale;
};

__device__ inline void load8(const float* src, float* dst) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = s4[0];
  d4[1] = s4[1];
}

__device__ inline void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]),
                      __bfloat162float(e[2]), __bfloat162float(e[3]));
  d4[1] = make_float4(__bfloat162float(e[4]), __bfloat162float(e[5]),
                      __bfloat162float(e[6]), __bfloat162float(e[7]));
}

__device__ inline void load8(const __half* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __half* e = reinterpret_cast<const __half*>(&u);
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(__half2float(e[0]), __half2float(e[1]),
                      __half2float(e[2]), __half2float(e[3]));
  d4[1] = make_float4(__half2float(e[4]), __half2float(e[5]),
                      __half2float(e[6]), __half2float(e[7]));
}

__device__ inline void zero8(float* dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  d4[1] = d4[0];
}

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ inline void store(__half* p, float x) { *p = __float2half_rn(x); }

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// NC = ceil(D / 32): output dims a lane owns
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = static_cast<int>(a.d);
  const int ldk = d + 4;
  float* qs = smem;                    // kRows x d
  float* ks = qs + kRows * d;          // kTile x ldk
  float* vs = ks + kTile * ldk;        // kTile x d

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int64_t b = blockIdx.z / a.splits;
  const int64_t split = blockIdx.z % a.splits;
  const int64_t kh = blockIdx.y;
  const int64_t g = a.h / a.kh;
  const int64_t n_rows = a.s * g;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = d / 8;            // 8-element chunks per row

  for (int c = threadIdx.x; c < kRows * chunks; c += kThreads) {
    const int r = c / chunks;
    const int dd = (c % chunks) * 8;
    const int64_t row = row0 + r;
    if (row < n_rows) {
      const int64_t i = row / g;
      const int64_t head = kh * g + row % g;
      load8(q + ((b * a.s + i) * a.h + head) * d + dd, qs + r * d + dd);
    } else {
      zero8(qs + r * d + dd);
    }
  }

  const int64_t last_row = min(row0 + kRows, n_rows) - 1;
  int64_t n_keys = a.kv_lim;
  if (a.causal) n_keys = min(n_keys, a.q_offset + last_row / g + 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
  int64_t qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    qpos[r] = a.q_offset + (row0 + warp * kRowsPerWarp + r) / g;
  }

  const int64_t k_begin = split * a.chunk;
  const int64_t k_end = min(k_begin + a.chunk, n_keys);
  for (int64_t t0 = k_begin; t0 < k_end; t0 += kTile) {
    __syncthreads();                   // q staged / previous tile consumed
    for (int c = threadIdx.x; c < kTile * chunks; c += kThreads) {
      const int j = c / chunks;
      const int dd = (c % chunks) * 8;
      const int64_t t = t0 + j;
      if (t < k_end) {
        const int64_t off = ((b * a.t + t) * a.kh + kh) * d + dd;
        load8(k + off, ks + j * ldk + dd);
        load8(v + off, vs + j * d + dd);
      } else {
        zero8(ks + j * ldk + dd);
        zero8(vs + j * d + dd);
      }
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * ldk;
    const float* qw = qs + warp * kRowsPerWarp * d;
    for (int dd = 0; dd < d; dd += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + dd);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * d + dd);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int64_t t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = t < k_end && (!a.causal || t <= qpos[r]);
      const float sr = ok ? s[r] * a.scale : kNegInf;
      const float mn = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - mn);
      const float alpha = expf(m[r] - mn);
      l[r] = fmaf(l[r], alpha, p);
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* vr = vs + j * d;
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = lane + 32 * c;
        vv[c] = dd < d ? vr[dd] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float lsum = warp_sum(l[r]);
    const int64_t row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    if (a.splits > 1) {                // partial state, combined later
      const int64_t parts = gridDim.z * a.kh * n_rows;
      const int64_t p = ((b * a.kh + kh) * a.splits + split) * n_rows + row;
      float* acc_p = a.part + p * d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = lane + 32 * c;
        if (dd < d) acc_p[dd] = acc[r][c];
      }
      if (lane == 0) {
        a.part[parts * d + p] = m[r];
        a.part[parts * d + parts + p] = lsum;
      }
      continue;
    }
    const float denom = fmaxf(lsum, 1e-30f);
    const int64_t i = row / g;
    const int64_t head = kh * g + row % g;
    T* dst = o + ((b * a.s + i) * a.h + head) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) store(dst + dd, acc[r][c] / denom);
    }
  }
}

// splits > 1: one thread per output element merges the splits' partial
// states, o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
// with M the largest m_s; a split that saw no valid key of the row has
// m_s = -1e30 and weighs 0.
template <typename T>
__global__ void __launch_bounds__(256)
flash_combine_kernel(Args a, int64_t batch) {
  const int64_t g = a.h / a.kh;
  const int64_t n_rows = a.s * g;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= batch * a.kh * n_rows * a.d) return;
  const int64_t dd = idx % a.d;
  const int64_t row = idx / a.d % n_rows;
  const int64_t bk = idx / a.d / n_rows;          // b * kh_count + kh
  const int64_t parts = batch * a.splits * a.kh * n_rows;
  const float* ms = a.part + parts * a.d;
  const float* ls = ms + parts;
  float mx = kNegInf;
  for (int64_t sp = 0; sp < a.splits; ++sp) {
    mx = fmaxf(mx, ms[(bk * a.splits + sp) * n_rows + row]);
  }
  float lsum = 0.f;
  float acc = 0.f;
  for (int64_t sp = 0; sp < a.splits; ++sp) {
    const int64_t p = (bk * a.splits + sp) * n_rows + row;
    const float w = expf(ms[p] - mx);
    lsum = fmaf(ls[p], w, lsum);
    acc = fmaf(a.part[p * a.d + dd], w, acc);
  }
  const int64_t b = bk / a.kh;
  const int64_t head = (bk % a.kh) * g + row % g;
  store(static_cast<T*>(a.o) + ((b * a.s + row / g) * a.h + head) * a.d + dd,
        acc / fmaxf(lsum, 1e-30f));
}

template <typename T, int NC>
cudaError_t launch(const Args& a, int64_t batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * a.d +
                       static_cast<size_t>(kTile) * (a.d + 4) +
                       static_cast<size_t>(kTile) * a.d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t n_rows = a.s * (a.h / a.kh);
  const int64_t row_blocks = (n_rows + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(a.kh),
                  static_cast<unsigned>(batch * a.splits));
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem, stream>>>(a);
  if (a.splits > 1) {
    const int64_t n = batch * a.kh * n_rows * a.d;
    flash_combine_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256,
                              0, stream>>>(a, batch);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int64_t batch, cudaStream_t stream) {
  switch ((a.d + 31) / 32) {
    case 1: return launch<T, 1>(a, batch, stream);
    case 2: return launch<T, 2>(a, batch, stream);
    case 3: return launch<T, 3>(a, batch, stream);
    case 4: return launch<T, 4>(a, batch, stream);
    case 5: return launch<T, 5>(a, batch, stream);
    case 6: return launch<T, 6>(a, batch, stream);
    case 7: return launch<T, 7>(a, batch, stream);
    case 8: return launch<T, 8>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ----------------------------------------------------------------------------
// The tensor-core kernel (bfloat16 prefill)
// ----------------------------------------------------------------------------

constexpr int kTcRows = 128;              // query rows a block: 2 warpgroups
constexpr int kTcKeys = 64;               // keys per K/V tile
constexpr int kTcStages = 3;              // K/V ring depth
constexpr int kTcConsumerWarps = 8;
constexpr int kTcThreads = kTcConsumerWarps * 32 + 32;   // + producer warp
constexpr int kSwizzleRow = 128;          // bytes of one swizzled box row
constexpr int kBoxCols = kSwizzleRow / 2; // bf16 columns of one box row

struct TcArgs {
  __nv_bfloat16* o;
  int s, h, kh, d;
  int q_offset;
  int kv_lim;         // min(T, kv_valid_len)
  int causal;
  int row_tiles;      // ceil(S / kTcRows)
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile starting at
// shared address `addr` (the tile 1024-byte aligned, so base offset 0):
// lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define TC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_D16(i) TC_D4(i), TC_D4(i + 4), TC_D4(i + 8), TC_D4(i + 12)

// d (64 x 64, float32) = [d +] A.B^T: A (64 x 16) and B (64 x 16) bf16 in
// shared memory, both K-major
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : TC_D16(0), TC_D16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A.B: A (64 x 16) bf16 in registers, B (16 x 64) bf16 in
// shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : TC_D16(0), TC_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A.B, as wgmma_64x64_rs with N = 128
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : TC_D16(0), TC_D16(16), TC_D16(32), TC_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NC>
__device__ __forceinline__ void wgmma_pv(float (&d)[32 * NC],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (NC == 1) {
    wgmma_64x64_rs(d, a, db);
  } else {
    wgmma_64x128_rs(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// KS = D / 16 k-steps of Q.K^T; NC = ceil(D / 64) column chunks of a row
template <int KS>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, TcArgs a) {
  constexpr int NC = (KS + 3) / 4;
  constexpr int kQChunk = kTcRows * kSwizzleRow;     // bytes
  constexpr int kKVChunk = kTcKeys * kSwizzleRow;
  constexpr int kStage = 2 * NC * kKVChunk;          // K chunks, V chunks
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries (the launch adds 1 KB)
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* kvs = qs + NC * kQChunk;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + kTcStages * kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTcStages;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int m0 = (a.row_tiles - 1 - static_cast<int>(blockIdx.z)) * kTcRows;
  const int kvh = head / (a.h / a.kh);
  // tiles the block walks: up to the causal horizon of its last row
  int n_keys = a.kv_lim;
  if (a.causal) n_keys = min(n_keys, a.q_offset + min(m0 + kTcRows, a.s));
  const int n_tiles = (n_keys + kTcKeys - 1) / kTcKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kTcStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kTcConsumerWarps) {                  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, NC * kQChunk);
      for (int c = 0; c < NC; ++c) {
        tma_load(qs + c * kQChunk, &tq, q_full, c * kBoxCols, head, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTcStages;
        if (j >= kTcStages) mbar_wait(&empty[st], (j / kTcStages - 1) & 1);
        uint8_t* ks = kvs + st * kStage;
        uint8_t* vs = ks + NC * kKVChunk;
        mbar_expect_tx(&full[st], kStage);
        for (int c = 0; c < NC; ++c) {
          tma_load(ks + c * kKVChunk, &tk, &full[st], c * kBoxCols, kvh,
                   j * kTcKeys, b);
          tma_load(vs + c * kKVChunk, &tv, &full[st], c * kBoxCols, kvh,
                   j * kTcKeys, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows m0 + 64 wg ..; this thread holds
  // rows r0 and r0 + 8 of them, keys (columns) 8 n + 2 (lane % 4) + {0, 1}
  // of each n-block of 8, the wgmma accumulator layout
  const int wg = warp / 4;
  const int wg_row0 = m0 + 64 * wg;
  const int r0 = wg_row0 + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  int my_tiles = 0;                                // 0: no row below S
  if (wg_row0 < a.s) {
    int nk = a.kv_lim;
    if (a.causal) nk = min(nk, a.q_offset + min(wg_row0 + 64, a.s));
    my_tiles = (nk + kTcKeys - 1) / kTcKeys;
  }
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kSwizzleRow;

  float o[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                       // this thread's share
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kTcStages;
    mbar_wait(&full[st], (j / kTcStages) & 1);
    if (j < my_tiles) {
      const uint32_t k_addr = smem_u32(kvs + st * kStage);
      const uint32_t v_addr = k_addr + NC * kKVChunk;

      // S = Q.K^T: k-step ks reads 16 columns, 32 bytes into a 128-byte
      // swizzled row of chunk ks / 4; 8-row groups 1024 bytes apart
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_64x64_ss(
            s, sw128_desc(q_addr + (ks / 4) * kQChunk + off, 16, 1024),
            sw128_desc(k_addr + (ks / 4) * kKVChunk + off, 16, 1024),
            ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax, row by row of this thread's two
      const int t0 = j * kTcKeys;
      const bool masked = t0 + kTcKeys > a.kv_lim ||
                          (a.causal && t0 + kTcKeys - 1 > a.q_offset + wg_row0);
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i / 2) % 2;              // row r0 or r0 + 8
        float x = s[i] * a.scale;
        if (masked) {
          const int key = t0 + 8 * (i / 4) + col + i % 2;
          if (key >= a.kv_lim ||
              (a.causal && key > a.q_offset + r0 + 8 * half)) {
            x = kNegInf;
          }
        }
        s[i] = x;
        mx[half] = fmaxf(mx[half], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        alpha[r] = expf(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= alpha[r];
      }
      // P split into two bf16 terms, packed as the A fragments of P.V:
      // k-step kk takes s[8 kk .. 8 kk + 7]
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int half = i % 2;
        const float p0 = expf(s[2 * i] - mx[half]);
        const float p1 = expf(s[2 * i + 1] - mx[half]);
        l_r[half] += p0;
        l_r[half] += p1;
        const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
        p_hi[i] = pack_bf16(h0, h1);
        p_lo[i] = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                            __float2bfloat16_rn(p1 - __bfloat162float(h1)));
      }
#pragma unroll
      for (int i = 0; i < 32 * NC; ++i) o[i] *= alpha[(i / 2) % 2];

      // O += P_hi.V + P_lo.V: k-step kk reads keys 16 kk .., two 8-key
      // groups of 1024 bytes; column chunks of V 8 KB apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<NC>(o, p_hi + 4 * kk,
                     sw128_desc(v_addr + kk * 2048, kKVChunk, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<NC>(o, p_lo + 4 * kk,
                     sw128_desc(v_addr + kk * 2048, kKVChunk, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);        // this warp is done
  }

  if (my_tiles == 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
    l_r[r] = fmaxf(l_r[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.s) continue;
    __nv_bfloat16* dst =
        a.o + ((static_cast<int64_t>(b) * a.s + row) * a.h + head) * a.d;
#pragma unroll
    for (int n = 0; n < 8 * NC; ++n) {
      const int c = 8 * n + col;
      if (c < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
            o[4 * n + 2 * r] / l_r[r], o[4 * n + 2 * r + 1] / l_r[r]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library needs no libcuda link
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// the 4-D map (D, heads, positions, batch) of a contiguous bf16 tensor
// (B, len, heads, D), in boxes of (64, 1, rows, 1) with 128-byte swizzle;
// out-of-bounds elements read as zero
bool encode_map(CUtensorMap* map, const void* ptr, int64_t batch,
                int64_t len, int64_t heads, int64_t d, uint32_t rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * d),
                                 static_cast<cuuint64_t>(2 * d * heads),
                                 static_cast<cuuint64_t>(2 * d * heads * len)};
  const cuuint32_t box[4] = {kBoxCols, 1, rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS>
cudaError_t launch_tc(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const TcArgs& a, int64_t batch,
                      cudaStream_t stream) {
  constexpr int NC = (KS + 3) / 4;
  constexpr int smem = 1024 + NC * kTcRows * kSwizzleRow +
                       kTcStages * 2 * NC * kTcKeys * kSwizzleRow +
                       (1 + 2 * kTcStages) * 8;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.h), static_cast<unsigned>(batch),
                  static_cast<unsigned>(a.row_tiles));
  flash_tc_kernel<KS><<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}


// ----------------------------------------------------------------------------
// The decode kernel (every dtype, at most kDecMaxRows rows per kv head)
// ----------------------------------------------------------------------------

// ops.py mirrors kDecMaxRows and kDecGranule (DEC_MAX_ROWS,
// DEC_KEY_GRANULE) to route calls and choose the splits;
// tests/test_torch_flash_dec.py mirrors kDecWarps and dec_lanes_per_key to
// emulate the order of work
constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecStages = 3;             // slices in a warp's K/V ring
constexpr int kDecMaxRows = 16;           // (query, head) rows of a block
constexpr int kDecGranule = 64;           // a split is a multiple of this
constexpr int kDecChunks = 4;             // K chunks a lane reads per key
constexpr int kMergeThreads = 128;

struct DecArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;        // splits > 1: partial acc, m and l per split
  int64_t s, t, h, kh, d;
  int64_t q_offset;
  int64_t n_keys;     // min(T, kv_valid_len, the last row's causal horizon)
  int64_t splits;     // blocks along the keys per (b, kv head)
  int64_t chunk;      // keys per split, a multiple of kDecGranule
  int causal;
  float scale;
};

// lanes that share one key's K row for the scores, each reading at most
// kDecChunks of its 16-byte chunks: 4, 8 or 16, so a tile of
// kDecWarps * 32 / LPK keys is 32, 16 or 8 keys (each divides kDecGranule)
__host__ __device__ constexpr int dec_lanes_per_key(int row_bytes) {
  return row_bytes <= 256 ? 4 : row_bytes <= 512 ? 8 : 16;
}

// bytes between two K rows in shared memory: the row padded so that the 8
// lanes of one 16-byte load phase (two keys of 4 lanes, or 8 lanes of one
// key, each lane on the next chunk) hit 8 distinct bank groups
__host__ __device__ constexpr int dec_kstride(int row_bytes, int lpk) {
  return row_bytes + ((16 * lpk - row_bytes) % 128 + 128) % 128;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one 16-byte chunk (4 float32 or 8 16-bit elements) widened to float32
__device__ __forceinline__ void widen16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen16(const uint4& u, float* f,
                                        __nv_bfloat16) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(e[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void widen16(const uint4& u, float* f, __half) {
  const __half2* e = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(e[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// four neighbouring elements widened to float32
__device__ __forceinline__ void widen4(const float* src, float* f) {
  widen16(*reinterpret_cast<const uint4*>(src), f, 0.f);
}

__device__ __forceinline__ void widen4(const __nv_bfloat16* src, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 x = __bfloat1622float2(e[0]), y = __bfloat1622float2(e[1]);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = y.x;
  f[3] = y.y;
}

__device__ __forceinline__ void widen4(const __half* src, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const __half2* e = reinterpret_cast<const __half2*>(&u);
  const float2 x = __half22float2(e[0]), y = __half22float2(e[1]);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = y.x;
  f[3] = y.y;
}

// max over the KW keys of a warp (the lanes of one key hold the same value)
template <int LPK>
__device__ __forceinline__ float keys_max(float x) {
#pragma unroll
  for (int o = 16; o >= LPK; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  }
  return x;
}

// LPK lanes per key for the scores (dec_lanes_per_key), NC groups of 4
// output dims per lane for P.V (ceil(D / 128)), RMAX >= the block's rows;
// at RMAX <= 2 the block has exactly RMAX rows (no row is skipped, so the
// rows' chains interleave), above it rows past S * g are skipped
template <typename T, int LPK, int NC, int RMAX>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(DecArgs a) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // elements a chunk
  constexpr int KW = 32 / LPK;                          // keys a warp a tile
  constexpr int TK = kDecWarps * KW;                    // keys a tile
  constexpr bool kExact = RMAX <= 2;
  constexpr bool kQInRegs = RMAX == 1;      // else q is read from smem
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int d = static_cast<int>(a.d);
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int chunks = row_bytes / 16;
  const int kstride = dec_kstride(row_bytes, LPK);
  const int slice_bytes = KW * (kstride + row_bytes);  // a warp's stage
  const int64_t g = a.h / a.kh;
  const int rows = kExact ? RMAX : static_cast<int>(a.s * g);
  float* qs = reinterpret_cast<float*>(smem);           // rows x d
  unsigned char* ring = smem + sizeof(float) * rows * d;

  const int64_t split = blockIdx.x;
  const int64_t kh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int part = lane % LPK;                // chunk phase within the key
  const int kk = lane / LPK;                  // this lane's key in a slice
  const int64_t k_begin = split * a.chunk;
  const int64_t k_end = min(k_begin + a.chunk, a.n_keys);
  const int n_keys = k_end > k_begin ? static_cast<int>(k_end - k_begin) : 0;
  // this warp's slices: keys [tile * TK + warp * KW, + KW) of each tile
  // that starts before n_keys
  const int first = warp * KW;
  const int n_slices = n_keys > first ? (n_keys - first + TK - 1) / TK : 0;

  // each warp stages its own slices in its own ring of kDecStages: lane
  // copies the 16-byte chunks lane, lane + 32, ... of a slice's K and V
  // rows (at most 4 each; keys past the split arrive as zeros and are never
  // read from device memory)
  const int64_t key_step = a.kh * d;          // elements from key t to t + 1
  const T* kbase = static_cast<const T*>(a.k) +
                   ((b * a.t + k_begin) * a.kh + kh) * d;
  const int64_t v_minus_k =         // elements from a K chunk to its V
      (reinterpret_cast<intptr_t>(a.v) - reinterpret_cast<intptr_t>(a.k)) /
      static_cast<int64_t>(sizeof(T));
  unsigned char* wring = ring + warp * kDecStages * slice_bytes;
  int cp_key[4], cp_k[4], cp_v[4];
  const T* cp_src[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int c = lane + 32 * x;
    const int jj = c / chunks;
    const int cc = c % chunks;
    cp_key[x] = c < KW * chunks ? first + jj : -1;  // -1: no chunk
    cp_k[x] = jj * kstride + cc * 16;
    cp_v[x] = KW * kstride + jj * row_bytes + cc * 16;
    cp_src[x] = kbase + (first + jj) * key_step + cc * E;
  }
  const int64_t tile_step = TK * key_step;
  auto issue = [&](int sl) {
    if (sl < n_slices) {
      const uint32_t st = smem_u32(wring + (sl % kDecStages) * slice_bytes);
      const int64_t off = sl * tile_step;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (cp_key[x] < 0) continue;
        const bool ok = sl * TK + cp_key[x] < n_keys;
        const T* src = ok ? cp_src[x] + off : kbase;
        cp_async16(st + cp_k[x], src, ok);
        cp_async16(st + cp_v[x], src + v_minus_k, ok);
      }
    }
    cp_async_commit();                  // an empty group keeps the count
  };
  // q's rows (at most 16 x 256 elements: at most 4 chunks of 8 a thread)
  // loaded while the first slices are asked for, then widened into smem
  const T* q = static_cast<const T*>(a.q);
  const int gi = static_cast<int>(g);
  const int q_chunks = rows * (d / 8);
  uint4 qraw[4][sizeof(T) == 4 ? 2 : 1];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int c = threadIdx.x + kDecThreads * x;
    if (c < q_chunks) {
      const int r = c / (d / 8);
      const int dd = (c % (d / 8)) * 8;
      const uint4* src = reinterpret_cast<const uint4*>(
          q + ((b * a.s + r / gi) * a.h + kh * g + r % gi) * d + dd);
#pragma unroll
      for (int y = 0; y < (sizeof(T) == 4 ? 2 : 1); ++y) qraw[x][y] = src[y];
    }
  }
#pragma unroll
  for (int st = 0; st < kDecStages - 1; ++st) issue(st);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int c = threadIdx.x + kDecThreads * x;
    if (c < q_chunks) {
      float* dst = qs + (c / (d / 8)) * d + (c % (d / 8)) * 8;
#pragma unroll
      for (int y = 0; y < (sizeof(T) == 4 ? 2 : 1); ++y) {
        widen16(qraw[x][y], dst + y * E, T());
      }
    }
  }

  // per row: the last key of the split it may see, counted from k_begin
  // (-1: none; the causal horizon q_offset + i of its query i)
  int last[RMAX];
  float m[RMAX], l[RMAX], acc[RMAX][NC][4];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    int64_t hz = n_keys - 1;
    if (a.causal) hz = min(hz, a.q_offset + r / gi - k_begin);
    last[r] = static_cast<int>(hz < -1 ? -1 : hz);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
    }
  }
  __syncthreads();                      // q staged
  // one row: this lane's chunks of q in registers (zeros past the row)
  float qreg[kQInRegs ? kDecChunks : 1][E];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int i = 0; i < kDecChunks; ++i) {
      const int c = part + i * LPK;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qreg[i][e] = c < chunks ? qs[c * E + e] : 0.f;
      }
    }
  }

  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait<kDecStages - 2>();    // this lane's copies of the slice
    __syncwarp();                       // every lane's, and the last read
    issue(sl + kDecStages - 1);
    const unsigned char* st = wring + (sl % kDecStages) * slice_bytes;
    const int jt = sl * TK + first + kk;  // this lane's key, from k_begin

    // scores: the LPK lanes of a key take every LPK-th chunk of its row
    // (at most kDecChunks; a chunk past the row reads as zeros), summed in
    // two partial sums, the lanes' sums then met by shuffles
    const T* krow = reinterpret_cast<const T*>(st + kk * kstride);
    float s[RMAX][2];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
    for (int i = 0; i < kDecChunks; ++i) {
      const int c = part + i * LPK;
      const bool in = c < chunks;
      const uint4 raw = in ? *reinterpret_cast<const uint4*>(krow + c * E)
                           : make_uint4(0u, 0u, 0u, 0u);
      float kf[E];
      widen16(raw, kf, T());
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= rows) break;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          float qq[4];
          if constexpr (kQInRegs) {
#pragma unroll
            for (int u = 0; u < 4; ++u) qq[u] = qreg[i][e + u];
          } else {
            const float4 q4 =
                in ? *reinterpret_cast<const float4*>(qs + r * d + c * E + e)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
            qq[0] = q4.x;
            qq[1] = q4.y;
            qq[2] = q4.z;
            qq[3] = q4.w;
          }
          float& acc_s = s[r][(i + e / 4) % 2];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc_s = fmaf(qq[u], kf[e + u], acc_s);
        }
      }
    }

    // this warp's online softmax over its KW keys of the slice; a masked
    // key weighs exactly 0, so a state that saw no valid key keeps
    // m = -1e30, l = 0 and acc = 0
    float p[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      p[r] = 0.f;
      if (r >= rows) break;
      float sr = s[r][0] + s[r][1];
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(kFull, sr, o);
      }
      const bool ok = jt <= last[r];
      sr = ok ? sr * a.scale : kNegInf;
      const float mn = fmaxf(m[r], keys_max<LPK>(sr));
      p[r] = ok ? expf(sr - mn) : 0.f;
      const float alpha = expf(m[r] - mn);
      l[r] = fmaf(l[r], alpha, part == 0 ? p[r] : 0.f);   // once per key
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha;
      }
    }

    // P.V: lane owns output dims 4 (lane + 32 c) .. + 3 (zeros past D) and
    // takes p of each key of its slice from that key's first lane
    const T* vt = reinterpret_cast<const T*>(st + KW * kstride);
#pragma unroll
    for (int jj = 0; jj < KW; ++jj) {
      const T* vr = vt + jj * d;
      float vv[NC][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = (lane + 32 * c) * 4;
        widen4(vr + (dd < d ? dd : 0), vv[c]);
        if (dd >= d) {
#pragma unroll
          for (int e = 0; e < 4; ++e) vv[c][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= rows) break;
        const float pj = __shfl_sync(kFull, p[r], jj * LPK);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][c][e] = fmaf(pj, vv[c][e], acc[r][c][e]);
          }
        }
      }
    }
  }

  // the warps' states into the (now idle) ring; each row's weights
  // e^(m_w - M), M = max_w m_w, and its sum of l once; then the merged
  // state per element
  cp_async_wait<0>();
  __syncthreads();
  float* accs = reinterpret_cast<float*>(ring);         // [warp][row][d]
  float* ms = accs + kDecWarps * rows * d;              // [warp][row]
  float* ls = ms + kDecWarps * rows;                    // [warp][row]
  float* mx = ls + kDecWarps * rows;                    // [row]
  float* lt = mx + rows;                                // [row]
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= rows) break;
    const float lsum = warp_sum(l[r]);
    if (lane == 0) {
      ms[warp * rows + r] = m[r];
      ls[warp * rows + r] = lsum;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dd = (lane + 32 * c) * 4;
      if (dd < d) {
        *reinterpret_cast<float4*>(accs + (warp * rows + r) * d + dd) =
            make_float4(acc[r][c][0], acc[r][c][1], acc[r][c][2],
                        acc[r][c][3]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float big = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) big = fmaxf(big, ms[w * rows + r]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = expf(ms[w * rows + r] - big);
      ms[w * rows + r] = wt;            // m_w -> its weight
      lsum = fmaf(ls[w * rows + r], wt, lsum);
    }
    mx[r] = big;
    lt[r] = lsum;
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  const int64_t parts = gridDim.z * a.kh * a.splits * rows;
  for (int e = threadIdx.x; e < rows * d; e += kDecThreads) {
    const int r = e / d;
    const int dd = e % d;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      sum = fmaf(accs[(w * rows + r) * d + dd], ms[w * rows + r], sum);
    }
    if (a.splits > 1) {                 // the block's state, merged later
      const int64_t p = ((b * a.kh + kh) * a.splits + split) * rows + r;
      a.part[p * d + dd] = sum;
      if (dd == 0) {
        a.part[parts * d + p] = mx[r];
        a.part[parts * d + parts + p] = lt[r];
      }
    } else {
      const int64_t head = kh * g + r % g;
      store(o + ((b * a.s + r / g) * a.h + head) * d + dd,
            sum / fmaxf(lt[r], 1e-30f));
    }
  }
}

// kv_splits > 1: one block per (b, kv head, row) merges the splits' states
// by the combine kernel's rule, o = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30) with M the largest m_s, each weight
// computed once into shared memory; a split that saw no valid key of the
// row has m_s = -1e30 and weighs 0
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_dec_merge_kernel(DecArgs a) {
  extern __shared__ float wts[];                        // [split]
  __shared__ float red[kMergeThreads / 32];
  __shared__ float total;
  const int64_t g = a.h / a.kh;
  const int64_t rows = a.s * g;
  const int64_t r = blockIdx.x % rows;
  const int64_t bk = blockIdx.x / rows;                 // b * K + kv head
  const int64_t parts = gridDim.x * a.splits;           // B * K * S*g * splits
  const float* ms = a.part + parts * a.d;
  const float* ls = ms + parts;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = static_cast<int>(a.splits);
  auto idx = [&](int sp) { return (bk * a.splits + sp) * rows + r; };

  float mx = kNegInf;
  for (int sp = threadIdx.x; sp < n; sp += kMergeThreads) {
    mx = fmaxf(mx, ms[idx(sp)]);
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();                      // red is reused below
  float lsum = 0.f;
  for (int sp = threadIdx.x; sp < n; sp += kMergeThreads) {
    const float w = expf(ms[idx(sp)] - mx);
    wts[sp] = w;
    lsum = fmaf(ls[idx(sp)], w, lsum);
  }
  lsum = warp_sum(lsum);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeThreads / 32; ++w) sum += red[w];
    total = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const int64_t b = bk / a.kh;
  const int64_t head = (bk % a.kh) * g + r % g;
  T* o = static_cast<T*>(a.o) + ((b * a.s + r / g) * a.h + head) * a.d;
  for (int dd = threadIdx.x; dd < a.d; dd += kMergeThreads) {
    float sum = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n; ++sp) {
      sum = fmaf(a.part[idx(sp) * a.d + dd], wts[sp], sum);
    }
    store(o + dd, sum / total);
  }
}

template <typename T, int LPK, int NC, int RMAX>
cudaError_t launch_dec(const DecArgs& a, int64_t batch, cudaStream_t stream) {
  constexpr int TK = kDecWarps * 32 / LPK;
  const int d = static_cast<int>(a.d);
  const int rows = static_cast<int>(a.s * (a.h / a.kh));
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const size_t ring = static_cast<size_t>(kDecStages) * TK *
                      (dec_kstride(row_bytes, LPK) + row_bytes);
  const size_t merge =
      sizeof(float) * (kDecWarps * static_cast<size_t>(rows) * (d + 2) +
                       2 * static_cast<size_t>(rows));
  const size_t smem = sizeof(float) * static_cast<size_t>(rows) * d +
                      (ring > merge ? ring : merge);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, LPK, NC, RMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(a.splits),
                  static_cast<unsigned>(a.kh), static_cast<unsigned>(batch));
  flash_decode_kernel<T, LPK, NC, RMAX>
      <<<grid, kDecThreads, smem, stream>>>(a);
  if (a.splits > 1) {
    const size_t wts = sizeof(float) * static_cast<size_t>(a.splits);
    if (wts > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_dec_merge_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(wts));
      if (err != cudaSuccess) return err;
    }
    flash_dec_merge_kernel<T>
        <<<static_cast<unsigned>(batch * a.kh * rows), kMergeThreads, wts,
           stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, int LPK, int NC>
cudaError_t dec_rows(const DecArgs& a, int64_t batch, cudaStream_t stream) {
  const int64_t rows = a.s * (a.h / a.kh);
  if (rows == 1) return launch_dec<T, LPK, NC, 1>(a, batch, stream);
  if (rows == 2) return launch_dec<T, LPK, NC, 2>(a, batch, stream);
  if (rows <= 4) return launch_dec<T, LPK, NC, 4>(a, batch, stream);
  if (rows <= 8) return launch_dec<T, LPK, NC, 8>(a, batch, stream);
  return launch_dec<T, LPK, NC, kDecMaxRows>(a, batch, stream);
}

// the (LPK, NC) pairs each element size meets for D a multiple of 8 up to
// 256: 16-bit (4, 1) up to D 128, (8, 2) above; float32 (4, 1) up to 64,
// (8, 1) up to 128, (16, 2) above
template <typename T>
cudaError_t dec_dispatch(const DecArgs& a, int64_t batch,
                         cudaStream_t stream) {
  const int lpk = dec_lanes_per_key(static_cast<int>(a.d * sizeof(T)));
  if (lpk == 4) return dec_rows<T, 4, 1>(a, batch, stream);
  if constexpr (sizeof(T) == 2) {
    return dec_rows<T, 8, 2>(a, batch, stream);
  } else {
    if (lpk == 8) return dec_rows<T, 8, 1>(a, batch, stream);
    return dec_rows<T, 16, 2>(a, batch, stream);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16; kv_valid_len -1 for none;
// kv_splits >= 1
// blocks along the keys, and for kv_splits > 1 a float32 scratch of
// B * K * kv_splits * S * (H / K) * (D + 2) elements
extern "C" int rt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int64_t b,
                                      int64_t s, int64_t t, int64_t h,
                                      int64_t kh, int64_t d, int64_t causal,
                                      int64_t q_offset, int64_t kv_valid_len,
                                      int64_t dtype, int64_t kv_splits,
                                      void* scratch, void* stream) {
  if (d <= 0 || d > 256 || d % 8 || kh <= 0 || h % kh || q_offset < 0 ||
      kv_valid_len == 0 || kv_valid_len < -1 || kv_splits < 1 ||
      (kv_splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || s == 0 || t == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.s = s;
  a.t = t;
  a.h = h;
  a.kh = kh;
  a.d = d;
  a.q_offset = q_offset;
  a.kv_lim = kv_valid_len < 0 ? t : (kv_valid_len < t ? kv_valid_len : t);
  a.splits = kv_splits;
  a.chunk = ((a.kv_lim + kv_splits - 1) / kv_splits + kTile - 1) / kTile *
            kTile;
  a.part = static_cast<float*>(scratch);
  a.causal = causal != 0;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(a, b, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(a, b, st);
  } else if (dtype == 2) {
    err = dispatch<__half>(a, b, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// bfloat16 only, D % 16 == 0 and D <= 128; kv_valid_len -1 for none.
// Returns cudaErrorNotSupported when a tensor map cannot be encoded.
extern "C" int rt_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* o, int64_t b,
                                     int64_t s, int64_t t, int64_t h,
                                     int64_t kh, int64_t d, int64_t causal,
                                     int64_t q_offset, int64_t kv_valid_len,
                                     void* stream) {
  constexpr int64_t kMax = 0x7fffffff;
  if (d <= 0 || d > 128 || d % 16 || kh <= 0 || h % kh || q_offset < 0 ||
      kv_valid_len == 0 || kv_valid_len < -1 || b > 65535 || h > kMax ||
      t > kMax || s + q_offset > kMax ||
      (s + kTcRows - 1) / kTcRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || s == 0 || t == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, b, s, h, d, kTcRows) ||
      !encode_map(&tk, k, b, t, kh, d, kTcKeys) ||
      !encode_map(&tv, v, b, t, kh, d, kTcKeys)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  TcArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.s = static_cast<int>(s);
  a.h = static_cast<int>(h);
  a.kh = static_cast<int>(kh);
  a.d = static_cast<int>(d);
  a.q_offset = static_cast<int>(q_offset);
  a.kv_lim = static_cast<int>(kv_valid_len < 0 || kv_valid_len > t
                                  ? t : kv_valid_len);
  a.causal = causal != 0;
  a.row_tiles = static_cast<int>((s + kTcRows - 1) / kTcRows);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d / 16) {
    case 1: err = launch_tc<1>(tq, tk, tv, a, b, st); break;
    case 2: err = launch_tc<2>(tq, tk, tv, a, b, st); break;
    case 3: err = launch_tc<3>(tq, tk, tv, a, b, st); break;
    case 4: err = launch_tc<4>(tq, tk, tv, a, b, st); break;
    case 5: err = launch_tc<5>(tq, tk, tv, a, b, st); break;
    case 6: err = launch_tc<6>(tq, tk, tv, a, b, st); break;
    case 7: err = launch_tc<7>(tq, tk, tv, a, b, st); break;
    default: err = launch_tc<8>(tq, tk, tv, a, b, st); break;
  }
  return static_cast<int>(err);
}

// At most 16 (query, head) rows per kv head (S * H / K <= 16), T below
// 2^31 (keys within a split are counted in 32 bits); dtype: 0
// float32, 1 bfloat16, 2 float16; kv_valid_len -1 for none; kv_splits
// blocks along the keys of each (b, kv head), `chunk` keys each (a
// multiple of 64, kv_splits * chunk covering the keys), and for
// kv_splits > 1 a float32 scratch of B * K * kv_splits * S * (H / K) *
// (D + 2) elements
extern "C" int rt_flash_attention_dec(const void* q, const void* k,
                                      const void* v, void* o, int64_t b,
                                      int64_t s, int64_t t, int64_t h,
                                      int64_t kh, int64_t d, int64_t causal,
                                      int64_t q_offset, int64_t kv_valid_len,
                                      int64_t dtype, int64_t kv_splits,
                                      int64_t chunk, void* scratch,
                                      void* stream) {
  if (d <= 0 || d > 256 || d % 8 || kh <= 0 || h % kh || s < 0 ||
      s * (h / kh) > kDecMaxRows || q_offset < 0 || kv_valid_len == 0 ||
      kv_valid_len < -1 || kv_splits < 1 || kv_splits > 0x7fffffff ||
      chunk <= 0 || chunk % kDecGranule || t > 0x7fffffff || b > 65535 ||
      kh > 65535 ||
      (kv_splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || s == 0 || t == 0 || h == 0) {
    return static_cast<int>(cudaSuccess);
  }
  DecArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.part = static_cast<float*>(scratch);
  a.s = s;
  a.t = t;
  a.h = h;
  a.kh = kh;
  a.d = d;
  a.q_offset = q_offset;
  a.n_keys = kv_valid_len < 0 || kv_valid_len > t ? t : kv_valid_len;
  if (causal && q_offset + s < a.n_keys) a.n_keys = q_offset + s;
  if (kv_splits * chunk < a.n_keys) {   // a key no split covers
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.splits = kv_splits;
  a.chunk = chunk;
  a.causal = causal != 0;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dec_dispatch<float>(a, b, st);
  } else if (dtype == 1) {
    err = dec_dispatch<__nv_bfloat16>(a, b, st);
  } else if (dtype == 2) {
    err = dec_dispatch<__half>(a, b, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
