// Grouped-query flash attention, backward, for Hopper (sm_90a).
//
// Replaces the gradient of the Pallas TPU kernel flash_attention_fwd: the
// reference's custom VJP `_bwd` of repro/kernels/flash_attention/ops.py,
// which recomputes the softmax in float32 chunks of 128 queries.  Inputs:
// q, o, dO (B, S, H, D) and k, v (B, T, K, D), H % K == 0, all float32,
// all bfloat16 or all float16, contiguous; outputs dq (B, S, H, D) and
// dk, dv (B, T, K, D) in the inputs' dtype.  With scores
// s = q.k * (1/sqrt(D)) in float32, masked (causal: q_offset + i < kpos;
// kpos >= kv_valid_len), m the row max and l the row sum of exp(s - m)
// over the valid keys:
//
//     P  = exp(s - m) / max(l, 1e-30)          (0 at a masked key)
//     D  = rowsum(dO o O)
//     dS = P o (dO.V^T - D)
//     dQ = dS.K * scale,  dK = dS^T.Q * scale,  dV = P^T.dO
//
// dK and dV sum over the g = H / K query heads of a kv head.  Every sum is
// float32; only the outputs are rounded to the inputs' dtype.
//
// Two routes, each of three kernels, chosen in ops.py by the call's dtype
// and shape alone (bwd_variant(), the forward's rule for its tc kernel):
//
// * "tc" (bfloat16, D % 16 == 0, D <= 128, S * H/K >= 64: the training
//   path) runs every product on the tensor cores (wgmma m64nNk16, bf16
//   operands, float32 accumulators), as the forward's flash_tc_kernel does,
//   with its helpers (hopper_bf16.cuh): a producer warp loads tiles by TMA
//   (4-D tensor maps, 128-byte swizzle, so D = 80 and 112 and the ragged S
//   and T edges arrive as zeros and nothing is padded in device memory)
//   into a ring of stages with full and empty mbarriers; two
//   consumer warpgroups of 64 rows each compute.  Q, K, V, O and dO are
//   bf16 already, so S = Q.K^T and dP = dO.V^T are one exact-operand
//   product each.  The three products whose A operand is a float32 matrix
//   (P^T.dO, dS^T.Q, dS.K) carry it as two bf16 terms, X_hi = bf16(X) and
//   X_lo = bf16(X - X_hi), each multiplied into the same float32
//   accumulator: X keeps about 16 significant bits, so every output stays
//   within a small part of one bf16 step of the float32 function (one term,
//   2^-9 relative, moves outputs past that step:
//   tests/test_torch_flash_bwd.py emulates both).  The accumulator fragment
//   of S or dP is the A fragment of the next product in registers.
//   - flash_bwd_tc_pre_kernel: a block per (128 query rows, query head, b)
//     forms S tile by tile (64 keys), keeps the online m and l, and writes
//     m, l and D = rowsum(dO o O) to the scratch the scalar pre writes.
//   - flash_bwd_tc_dq_kernel: the same blocks; per key tile S and dP, then
//     P = exp(s - m) / l and dS = P o (dP - D) from the scratch, and
//     dQ += dS.K (K as the MN-major B operand), in registers, scaled and
//     rounded once at the end.
//   - flash_bwd_tc_dkv_kernel: a block per (128 keys, kv head, b), a
//     warpgroup per 64 keys; it walks every 64-row tile of the g query
//     heads that can see its keys and computes S^T = K.Q^T and
//     dP^T = V.dO^T with the keys as the M side, so P^T and dS^T are A
//     fragments in registers, then dV += P^T.dO and dK += dS^T.Q (dO and
//     Q MN-major).  Its producer is a warpgroup whose one loading warp
//     also stores each tile's rows' (m, 1/l, D) beside it, and which hands
//     its registers to the consumers (setmaxnreg: dK and dV alone take 128
//     of the 168 a thread three warpgroups may hold).  K as the A operand
//     may sum the 16 products of a k-step in another order than pre's
//     Q.K^T, so a score here can exceed pre's m by a rounding and P
//     exceed exp(0)/l by one: harmless against the check, and no
//     transpose through shared memory is paid.
//   Work: 2 D operations a valid (query, head, key) pair in pre, 8 D in dq
//   (S, dP, two terms of dS.K), 12 D in dkv (S^T, dP^T, two terms each of
//   P^T.dO and dS^T.Q): 22 D, where the function is 10 D.  What bounds it:
//   the tensor cores (989 TFLOP/s bf16); at qwen3-0.6b's training shape
//   (4, 4096, 16/8, 128), causal, 1.5e12 operations, 1.53 ms, against
//   0.4 GB of q, k, v, o, dO and gradients (0.12 ms at 3.35 TB/s).  A
//   warpgroup overlaps one product of a tile with its elementwise work
//   (pre: the next tile's S with this tile's softmax; dq: dP with P; dkv:
//   dP^T with P^T, dV's product with dS^T) and waits for the rest before
//   the next tile; with two consumer warpgroups an SM, those waits hold
//   it at about a third of the tensor cores' rate.
//
// * "scalar" (float32, float16, and bf16 calls the tc kernels do not take)
//   upcasts every element to float32 as it reads it and runs every product
//   on the CUDA cores; P and dS are never rounded.  Its three kernels are
//   written like the forward's scalar kernel (flash_attention.cu,
//   flash_fwd_kernel): a block of 8 warps, 32 "rows" of 4 a warp, tiles of
//   32 "columns" staged in shared memory as float32 (rows padded by 4
//   floats so the 16-byte reads of 8 neighbouring lanes hit distinct
//   banks), lane j taking column j of the tile for the dot products and
//   output dims j, j + 32, ... for the accumulations, the column's value
//   taken by a warp shuffle.
//   - flash_bwd_pre_kernel: a block per (32 (query, head) rows of a kv
//     group, kv head, b).  It walks the keys the rows can see, as the
//     forward does, keeping the online row max m and row sum l, and writes
//     m, l and D = sum(dO o O) for each row into a float32 scratch.
//   - flash_bwd_dq_kernel: the same blocks.  It walks the same keys,
//     recomputes s and dO.v for each (row, key), forms P and dS from the
//     scratch and accumulates dQ = dS.K in registers; scaled and rounded
//     once at the end.
//   - flash_bwd_dkv_kernel: a block per (32 keys, kv head, b).  Its rows
//     are keys: it walks the (query, head) rows of the group that can see
//     any of its keys, in tiles of 32, recomputes s and v.dO, and
//     accumulates dV = P^T.dO and dK = dS^T.Q in registers.
//   The scores are computed in one order in all three (a chain of fmaf over
//   d ascending), so the m of the first kernel is the max of the very
//   scores the other two exponentiate.  What bounds it: the products, 16 D
//   operations a pair with the recomputes (2 D in pre, 6 D in dq, 8 D in
//   dkv) on the CUDA cores in float32 (67 TFLOP/s).
//
// On both routes each output element is written by exactly one thread,
// once: no atomics, so results are the same from run to run.  No tile past
// the causal horizon or kv_valid_len is read, masks apply only on tiles
// that cross them, and keys at or past kv_valid_len get zero dK and dV.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper_bf16.cuh"   // mbarriers, TMA, wgmma (shared with the forward)

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows a block
constexpr int kTile = 32;                      // columns a tile, one a lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* stats;       // m, l, D: three arrays of B * K * S * g floats
  void* dq;
  void* dk;
  void* dv;
  int64_t b, s, t, h, kh, d;
  int64_t q_offset;
  int64_t kv_lim;     // min(T, kv_valid_len)
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

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(__half x) { return __half2float(x); }

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

// the dot product of two staged float32 rows of d elements, d % 4 == 0,
// as a chain of fmaf over d ascending (the one order of every score)
__device__ inline float dot_row(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int dd = 0; dd < d; dd += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + dd);
    const float4 y = *reinterpret_cast<const float4*>(b + dd);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// Stage kRows (query, head) rows of the group from a (B, S, H, D) tensor
// into dst (kRows x ld floats), zeros past the last row.
template <typename T>
__device__ inline void stage_rows(const T* src, float* dst, int ld,
                                  const Args& a, int64_t b, int64_t kh,
                                  int64_t row0, int64_t n_rows) {
  const int d = static_cast<int>(a.d);
  const int chunks = d / 8;
  const int64_t g = a.h / a.kh;
  for (int c = threadIdx.x; c < kRows * chunks; c += kThreads) {
    const int r = c / chunks;
    const int dd = (c % chunks) * 8;
    const int64_t row = row0 + r;
    if (row < n_rows) {
      const int64_t i = row / g;
      const int64_t head = kh * g + row % g;
      load8(src + ((b * a.s + i) * a.h + head) * d + dd, dst + r * ld + dd);
    } else {
      zero8(dst + r * ld + dd);
    }
  }
}

// Stage kTile keys [t0, t0 + kTile) of a (B, T, K, D) tensor into dst
// (kTile x ld floats), zeros at and past `end`.
template <typename T>
__device__ inline void stage_keys(const T* src, float* dst, int ld,
                                  const Args& a, int64_t b, int64_t kh,
                                  int64_t t0, int64_t end) {
  const int d = static_cast<int>(a.d);
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < kTile * chunks; c += kThreads) {
    const int j = c / chunks;
    const int dd = (c % chunks) * 8;
    const int64_t t = t0 + j;
    if (t < end) {
      load8(src + ((b * a.t + t) * a.kh + kh) * d + dd, dst + j * ld + dd);
    } else {
      zero8(dst + j * ld + dd);
    }
  }
}

// the keys rows [row0, row0 + kRows) of a group can see: a causal row i
// sees keys up to q_offset + i
__device__ inline int64_t keys_seen(const Args& a, int64_t row0,
                                    int64_t n_rows) {
  const int64_t g = a.h / a.kh;
  const int64_t last_row = min(row0 + kRows, n_rows) - 1;
  int64_t n_keys = a.kv_lim;
  if (a.causal) n_keys = min(n_keys, a.q_offset + last_row / g + 1);
  return n_keys;
}

// ---------------------------------------------------------------------------
// pre: the row max m, the row sum l and D = sum(dO o O) of every row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_pre_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = static_cast<int>(a.d);
  const int ldk = d + 4;
  float* qs = smem;                    // kRows x d
  float* ks = qs + kRows * d;          // kTile x ldk

  const int64_t b = blockIdx.z;
  const int64_t kh = blockIdx.y;
  const int64_t g = a.h / a.kh;
  const int64_t n_rows = a.s * g;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_rows(static_cast<const T*>(a.q), qs, d, a, b, kh, row0, n_rows);
  const int64_t n_keys = keys_seen(a, row0, n_rows);

  float m[kRowsPerWarp], l[kRowsPerWarp];
  int64_t qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    qpos[r] = a.q_offset + (row0 + warp * kRowsPerWarp + r) / g;
  }

  for (int64_t t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();                   // q staged / previous tile consumed
    stage_keys(static_cast<const T*>(a.k), ks, ldk, a, b, kh, t0, n_keys);
    __syncthreads();
    const int64_t t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = dot_row(qs + (warp * kRowsPerWarp + r) * d,
                               ks + lane * ldk, d);
      const bool ok = t < n_keys && (!a.causal || t <= qpos[r]);
      const float sc = ok ? sr * a.scale : kNegInf;
      const float mn = fmaxf(m[r], warp_max(sc));
      l[r] = fmaf(l[r], expf(m[r] - mn), expf(sc - mn));
      m[r] = mn;
    }
  }

  const int64_t base = (b * a.kh + kh) * n_rows;
  const int64_t n_all = a.b * a.kh * n_rows;
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float lsum = warp_sum(l[r]);
    const int64_t row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;       // warp-uniform
    const int64_t i = row / g;
    const int64_t head = kh * g + row % g;
    const int64_t off = ((b * a.s + i) * a.h + head) * d;
    float dsum = 0.f;
    for (int dd = lane; dd < d; dd += 32) {
      dsum = fmaf(to_f32(dout[off + dd]), to_f32(o[off + dd]), dsum);
    }
    dsum = warp_sum(dsum);
    if (lane == 0) {
      a.stats[base + row] = m[r];
      a.stats[n_all + base + row] = lsum;
      a.stats[2 * n_all + base + row] = dsum;
    }
  }
}

// ---------------------------------------------------------------------------
// dq: dQ = scale * sum_keys dS K
// ---------------------------------------------------------------------------

// NC = ceil(D / 32): output dims a lane owns
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = static_cast<int>(a.d);
  const int ldk = d + 4;
  float* qs = smem;                    // kRows x d
  float* dos = qs + kRows * d;         // kRows x d
  float* ks = dos + kRows * d;         // kTile x ldk
  float* vs = ks + kTile * ldk;        // kTile x ldk

  const int64_t b = blockIdx.z;
  const int64_t kh = blockIdx.y;
  const int64_t g = a.h / a.kh;
  const int64_t n_rows = a.s * g;
  // the last row blocks see the most keys: they start first
  const int64_t row0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  stage_rows(static_cast<const T*>(a.q), qs, d, a, b, kh, row0, n_rows);
  stage_rows(static_cast<const T*>(a.dout), dos, d, a, b, kh, row0, n_rows);
  const int64_t n_keys = keys_seen(a, row0, n_rows);

  const int64_t base = (b * a.kh + kh) * n_rows;
  const int64_t n_all = a.b * a.kh * n_rows;
  float m[kRowsPerWarp], inv_l[kRowsPerWarp], drow[kRowsPerWarp];
  float acc[kRowsPerWarp][NC];
  int64_t qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = row0 + warp * kRowsPerWarp + r;
    const bool live = row < n_rows;
    m[r] = live ? a.stats[base + row] : 0.f;
    inv_l[r] = live ? 1.f / fmaxf(a.stats[n_all + base + row], 1e-30f) : 0.f;
    drow[r] = live ? a.stats[2 * n_all + base + row] : 0.f;
    qpos[r] = a.q_offset + row / g;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int64_t t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();
    stage_keys(static_cast<const T*>(a.k), ks, ldk, a, b, kh, t0, n_keys);
    stage_keys(static_cast<const T*>(a.v), vs, ldk, a, b, kh, t0, n_keys);
    __syncthreads();
    const int64_t t = t0 + lane;
    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp * kRowsPerWarp + r;
      const float sr = dot_row(qs + rr * d, ks + lane * ldk, d);
      const float dp = dot_row(dos + rr * d, vs + lane * ldk, d);
      const bool ok = t < n_keys && (!a.causal || t <= qpos[r]);
      const float p = ok ? expf(sr * a.scale - m[r]) * inv_l[r] : 0.f;
      ds[r] = p * (dp - drow[r]);
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* kr = ks + j * ldk;
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = lane + 32 * c;
        kv[c] = dd < d ? kr[dd] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(dsj, kv[c], acc[r][c]);
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const int64_t i = row / g;
    const int64_t head = kh * g + row % g;
    T* dst = dq + ((b * a.s + i) * a.h + head) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) store(dst + dd, acc[r][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dkv: dV = sum_rows P dO, dK = scale * sum_rows dS Q, rows = (query, head)
// of the group
// ---------------------------------------------------------------------------

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = static_cast<int>(a.d);
  const int ldk = d + 4;
  float* ks = smem;                    // kRows keys x d
  float* vs = ks + kRows * d;          // kRows keys x d
  float* qs = vs + kRows * d;          // kTile rows x ldk
  float* dos = qs + kTile * ldk;       // kTile rows x ldk

  const int64_t b = blockIdx.z;
  const int64_t kh = blockIdx.y;
  const int64_t g = a.h / a.kh;
  const int64_t n_rows = a.s * g;
  const int64_t key0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the block's keys, zeros at and past kv_lim
  stage_keys(static_cast<const T*>(a.k), ks, d, a, b, kh, key0, a.kv_lim);
  stage_keys(static_cast<const T*>(a.v), vs, d, a, b, kh, key0, a.kv_lim);

  // rows that see a key of the block: a causal row i sees key t when
  // t <= q_offset + i; none when every key is at or past kv_lim
  int64_t row_begin = 0;
  if (a.causal && key0 > a.q_offset) row_begin = (key0 - a.q_offset) * g;
  const int64_t row_end = key0 < a.kv_lim ? n_rows : 0;

  const int64_t base = (b * a.kh + kh) * n_rows;
  const int64_t n_all = a.b * a.kh * n_rows;
  float dk[kRowsPerWarp][NC], dv[kRowsPerWarp][NC];
  int64_t tpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    tpos[r] = key0 + warp * kRowsPerWarp + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[r][c] = 0.f;
      dv[r][c] = 0.f;
    }
  }

  for (int64_t r0 = row_begin; r0 < row_end; r0 += kTile) {
    __syncthreads();                   // keys staged / previous tile used
    stage_rows(static_cast<const T*>(a.q), qs, ldk, a, b, kh, r0, n_rows);
    stage_rows(static_cast<const T*>(a.dout), dos, ldk, a, b, kh, r0,
               n_rows);
    __syncthreads();
    const int64_t row = r0 + lane;     // this lane's (query, head) row
    const bool live = row < n_rows;
    const float m = live ? a.stats[base + row] : 0.f;
    const float inv_l =
        live ? 1.f / fmaxf(a.stats[n_all + base + row], 1e-30f) : 0.f;
    const float drow = live ? a.stats[2 * n_all + base + row] : 0.f;
    const int64_t qpos = a.q_offset + row / g;
    float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rr = warp * kRowsPerWarp + r;
      const float sr = dot_row(qs + lane * ldk, ks + rr * d, d);
      const float dp = dot_row(dos + lane * ldk, vs + rr * d, d);
      const bool ok = live && tpos[r] < a.kv_lim &&
                      (!a.causal || tpos[r] <= qpos);
      p[r] = ok ? expf(sr * a.scale - m) * inv_l : 0.f;
      ds[r] = p[r] * (dp - drow);
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* qr = qs + j * ldk;
      const float* dr = dos + j * ldk;
      float qv[NC], dov[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = lane + 32 * c;
        qv[c] = dd < d ? qr[dd] : 0.f;
        dov[c] = dd < d ? dr[dd] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[r][c] = fmaf(pj, dov[c], dv[r][c]);
          dk[r][c] = fmaf(dsj, qv[c], dk[r][c]);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (tpos[r] >= a.t) continue;
    const int64_t off = ((b * a.t + tpos[r]) * a.kh + kh) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) {
        store(dk_out + off + dd, dk[r][c] * a.scale);
        store(dv_out + off + dd, dv[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// the shared memory of each kernel: staged rows (d floats each) and tiles
// (d + 4 floats a row)
size_t smem_bytes(int64_t d, int staged, int tiles) {
  return sizeof(float) * (static_cast<size_t>(staged) * kRows * d +
                          static_cast<size_t>(tiles) * kTile * (d + 4));
}

dim3 row_grid(const Args& a) {
  const int64_t n_rows = a.s * (a.h / a.kh);
  return dim3(static_cast<unsigned>((n_rows + kRows - 1) / kRows),
              static_cast<unsigned>(a.kh), static_cast<unsigned>(a.b));
}

template <typename T>
cudaError_t launch_pre(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d, 1, 1);
  cudaError_t err = set_smem(flash_bwd_pre_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_pre_kernel<T><<<row_grid(a), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d, 2, 2);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T, NC>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, NC><<<row_grid(a), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d, 2, 2);
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, NC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.t + kRows - 1) / kRows),
                  static_cast<unsigned>(a.kh), static_cast<unsigned>(a.b));
  flash_bwd_dkv_kernel<T, NC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

enum Which { kPre = 0, kDq = 1, kDkv = 2 };

template <typename T, int NC>
cudaError_t launch_which(const Args& a, int which, cudaStream_t stream) {
  if (which == kDq) return launch_dq<T, NC>(a, stream);
  return launch_dkv<T, NC>(a, stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, int which, cudaStream_t stream) {
  if (which == kPre) return launch_pre<T>(a, stream);
  switch ((a.d + 31) / 32) {
    case 1: return launch_which<T, 1>(a, which, stream);
    case 2: return launch_which<T, 2>(a, which, stream);
    case 3: return launch_which<T, 3>(a, which, stream);
    case 4: return launch_which<T, 4>(a, which, stream);
    case 5: return launch_which<T, 5>(a, which, stream);
    case 6: return launch_which<T, 6>(a, which, stream);
    case 7: return launch_which<T, 7>(a, which, stream);
    case 8: return launch_which<T, 8>(a, which, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Args& a, int64_t causal, int64_t q_offset, int64_t kv_valid_len,
        int64_t dtype, int which, void* stream) {
  if (a.d <= 0 || a.d > 256 || a.d % 8 || a.kh <= 0 || a.h % a.kh ||
      q_offset < 0 || kv_valid_len == 0 || kv_valid_len < -1 ||
      a.b > 65535 || a.kh > 65535 || a.stats == nullptr ||
      (a.s * (a.h / a.kh) + kRows - 1) / kRows > 0x7fffffff ||
      (a.t + kRows - 1) / kRows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.b == 0 || a.s == 0 || a.t == 0 || a.h == 0) {
    return static_cast<int>(cudaSuccess);
  }
  a.q_offset = q_offset;
  a.kv_lim = kv_valid_len < 0 || kv_valid_len > a.t ? a.t : kv_valid_len;
  a.causal = causal != 0;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.d)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(a, which, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(a, which, st);
  } else if (dtype == 2) {
    err = dispatch<__half>(a, which, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* stats, void* dq, void* dk, void* dv,
               int64_t b, int64_t s, int64_t t, int64_t h, int64_t kh,
               int64_t d) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.stats = static_cast<float*>(stats);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.b = b;
  a.s = s;
  a.t = t;
  a.h = h;
  a.kh = kh;
  a.d = d;
  return a;
}

// ---------------------------------------------------------------------------
// The tensor-core route (bfloat16, D % 16 == 0, D <= 128)
// ---------------------------------------------------------------------------

constexpr int kTbRows = 128;         // rows of a pre or dq block: 2 warpgroups
constexpr int kTbKeys = 64;          // keys of a pre or dq K/V tile
constexpr int kTbKeyBlock = 128;     // keys of a dkv block: 2 warpgroups
constexpr int kTbRowTile = 64;       // rows of a dkv Q/dO tile
constexpr int kTbStages = 3;         // ring depth
constexpr int kTbConsumerWarps = 8;
constexpr int kTbThreads = kTbConsumerWarps * 32 + 32;   // + producer warp
constexpr int kStatBytes = 16;       // a dkv row's (m, 1/l, D, 0) in a stage
// dkv's accumulators (dK and dV, 128 registers at D = 128) do not fit the
// 168 registers a thread that three warpgroups may hold: its producer is a
// warpgroup that hands registers to the two consumer warpgroups
// (setmaxnreg: 128 x (168 - 40) = 256 x (232 - 168))
constexpr int kTbDkvThreads = kTbConsumerWarps * 32 + 128;
constexpr int kTbProducerRegs = 40;
constexpr int kTbConsumerRegs = 232;

struct TbArgs {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  float* stats;       // m, l, D: three arrays of B * S * H floats
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int s, t, h, kh, d;
  int q_offset;
  int kv_lim;         // min(T, kv_valid_len)
  int causal;
  int tiles;          // row tiles (pre, dq) or key blocks (dkv) a (b, head)
  float scale;
  int64_t n_all;      // B * S * H
};

// the scratch index of row i of query head `head` in sequence b: the
// scalar kernels' (B, K, S, g) layout
__device__ __forceinline__ int64_t stat_idx(const TbArgs& a, int b, int head,
                                            int i) {
  const int g = a.h / a.kh;
  return ((static_cast<int64_t>(b) * a.kh + head / g) * a.s + i) * g +
         head % g;
}

// 64-key tiles that rows [0, row_end) of a (b, head) can see
__device__ __forceinline__ int tb_key_tiles(const TbArgs& a, int row_end) {
  int n_keys = a.kv_lim;
  if (a.causal) n_keys = min(n_keys, a.q_offset + row_end);
  return (n_keys + kTbKeys - 1) / kTbKeys;
}

// s (64 x 64, float32) = A.B^T over KS k-steps, A's and B's 64 rows in
// shared memory, both K-major (chunks of 64 columns a_chunk and b_chunk
// bytes apart); issued, not waited for
template <int KS>
__device__ __forceinline__ void tile_product(float (&s)[32], uint32_t a_addr,
                                             int a_chunk, uint32_t b_addr,
                                             int b_chunk) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    wgmma_64x64_ss(s, sw128_desc(a_addr + (ks / 4) * a_chunk + off, 16, 1024),
                   sw128_desc(b_addr + (ks / 4) * b_chunk + off, 16, 1024),
                   ks > 0);
  }
}

// d (64 x 64 NC) += A.B over 64 contraction rows: A bf16 in registers (the
// packed accumulator fragment of a 64 x 64 tile, 4 words a k-step), B's 64
// rows in shared memory, MN-major (chunks b_chunk bytes apart); issued
template <int NC>
__device__ __forceinline__ void acc_product(float (&d)[32 * NC],
                                            const uint32_t (&a)[16],
                                            uint32_t b_addr, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_pv<NC>(d, a + 4 * kk, sw128_desc(b_addr + kk * 2048, b_chunk, 1024));
  }
}

// x as two bf16 terms, x_hi = bf16(x), x_lo = bf16(x - x_hi), packed two
// neighbouring columns a word
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// the block's barriers: `once` (the tiles loaded once, one TMA arrival)
// and the ring's full (n_full arrivals and the TMA bytes) and empty (one
// arrival per consumer warp)
__device__ __forceinline__ void init_ring(uint64_t* once, uint64_t* full,
                                          uint32_t n_full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int i = 0; i < kTbStages; ++i) {
      mbar_init(&full[i], n_full);
      mbar_init(&empty[i], kTbConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- tc pre: S on the tensor cores, the online m and l, and D ----------

// the online row max m_r and this thread's share l_r of the row sum over
// one 64-key tile of scores s (from key t0), rows r0 and r0 + 8 of a
// warpgroup from wg_row0
__device__ __forceinline__ void online_tile(const float (&s)[32],
                                            const TbArgs& a, int t0,
                                            int wg_row0, int r0, int col,
                                            float (&m_r)[2],
                                            float (&l_r)[2]) {
  const bool masked = t0 + kTbKeys > a.kv_lim ||
                      (a.causal && t0 + kTbKeys - 1 > a.q_offset + wg_row0);
  float x[32];
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int half = (i / 2) % 2;                  // row r0 or r0 + 8
    x[i] = s[i] * a.scale;
    if (masked) {
      const int key = t0 + 8 * (i / 4) + col + i % 2;
      if (key >= a.kv_lim ||
          (a.causal && key > a.q_offset + r0 + 8 * half)) {
        x[i] = kNegInf;
      }
    }
    mx[half] = fmaxf(mx[half], x[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    l_r[r] *= expf(m_r[r] - mx[r]);
    m_r[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    l_r[(i / 2) % 2] += expf(x[i] - m_r[(i / 2) % 2]);
  }
}

// waits for key tile j in pre's ring and issues s = Q.K^T on it
template <int KS>
__device__ __forceinline__ void issue_scores(float (&s)[32], int j,
                                             uint64_t* full, uint8_t* ring,
                                             int stage_bytes,
                                             uint32_t q_addr) {
  mbar_wait(&full[j % kTbStages], (j / kTbStages) & 1);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
  tile_product<KS>(s, q_addr, kTbRows * kSwizzleRow,
                   smem_u32(ring + (j % kTbStages) * stage_bytes),
                   kTbKeys * kSwizzleRow);
  wgmma_commit();
}

// this warp is done with stage j % kTbStages of its ring
__device__ __forceinline__ void release(uint64_t* empty, int j, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[j % kTbStages]);
}

template <int KS>
__global__ void __launch_bounds__(kTbThreads, 1)
flash_bwd_tc_pre_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk, TbArgs a) {
  constexpr int NC = (KS + 3) / 4;
  constexpr int kQChunk = kTbRows * kSwizzleRow;
  constexpr int kKChunk = kTbKeys * kSwizzleRow;
  constexpr int kStage = NC * kKChunk;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* ring = qs + NC * kQChunk;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kTbStages * kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTbStages;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int m0 = (a.tiles - 1 - static_cast<int>(blockIdx.z)) * kTbRows;
  const int kvh = head / (a.h / a.kh);
  const int n_tiles = tb_key_tiles(a, min(m0 + kTbRows, a.s));
  init_ring(q_full, full, 1, empty);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kTbConsumerWarps) {                  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, NC * kQChunk);
      for (int c = 0; c < NC; ++c) {
        tma_load(qs + c * kQChunk, &tq, q_full, c * kBoxCols, head, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTbStages;
        if (j >= kTbStages) mbar_wait(&empty[st], (j / kTbStages - 1) & 1);
        uint8_t* ks = ring + st * kStage;
        mbar_expect_tx(&full[st], kStage);
        for (int c = 0; c < NC; ++c) {
          tma_load(ks + c * kKChunk, &tk, &full[st], c * kBoxCols, kvh,
                   j * kTbKeys, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows m0 + 64 wg ..; this thread holds
  // rows r0 and r0 + 8, keys 8 n + col + {0, 1} of each n-block of 8
  const int wg = warp / 4;
  const int wg_row0 = m0 + 64 * wg;
  const int r0 = wg_row0 + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int my_tiles =
      wg_row0 < a.s ? tb_key_tiles(a, min(wg_row0 + 64, a.s)) : 0;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kSwizzleRow;

  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};                       // this thread's share
  mbar_wait(q_full, 0);
  // the scores of tile j + 1 are issued before tile j's softmax, so the
  // tensor cores work while the warpgroup exponentiates: two buffers,
  // tiles in pairs
  float sa[32], sb[32];
  if (my_tiles > 0) issue_scores<KS>(sa, 0, full, ring, kStage, q_addr);
  for (int j = 0; j < my_tiles; j += 2) {
    if (j + 1 < my_tiles) {
      issue_scores<KS>(sb, j + 1, full, ring, kStage, q_addr);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sa);
    online_tile(sa, a, j * kTbKeys, wg_row0, r0, col, m_r, l_r);
    release(empty, j, lane);
    if (j + 1 == my_tiles) break;
    if (j + 2 < my_tiles) {
      issue_scores<KS>(sa, j + 2, full, ring, kStage, q_addr);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sb);
    online_tile(sb, a, (j + 1) * kTbKeys, wg_row0, r0, col, m_r, l_r);
    release(empty, j + 1, lane);
  }
  for (int j = my_tiles; j < n_tiles; ++j) {     // past this warpgroup's rows
    mbar_wait(&full[j % kTbStages], (j / kTbStages) & 1);
    release(empty, j, lane);
  }
  if (my_tiles == 0) return;

  // D = rowsum(dO o O): the quad's four lanes take 8 columns in turn
  float dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
    const int row = r0 + 8 * r;
    float acc = 0.f;
    if (row < a.s) {
      const int64_t off =
          ((static_cast<int64_t>(b) * a.s + row) * a.h + head) * a.d;
      for (int c8 = 8 * (lane % 4); c8 < a.d; c8 += 32) {
        const uint4 uo = *reinterpret_cast<const uint4*>(a.o + off + c8);
        const uint4 ud = *reinterpret_cast<const uint4*>(a.dout + off + c8);
        const __nv_bfloat16* eo = reinterpret_cast<const __nv_bfloat16*>(&uo);
        const __nv_bfloat16* ed = reinterpret_cast<const __nv_bfloat16*>(&ud);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc = fmaf(__bfloat162float(ed[e]), __bfloat162float(eo[e]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    dsum[r] = acc;
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= a.s) continue;
      const int64_t idx = stat_idx(a, b, head, row);
      a.stats[idx] = m_r[r];
      a.stats[a.n_all + idx] = l_r[r];
      a.stats[2 * a.n_all + idx] = dsum[r];
    }
  }
}

// ---- tc dq: S and dP on the tensor cores, dQ += dS.K ---------------------

template <int KS>
__global__ void __launch_bounds__(kTbThreads, 1)
flash_bwd_tc_dq_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, TbArgs a) {
  constexpr int NC = (KS + 3) / 4;
  constexpr int kQChunk = kTbRows * kSwizzleRow;
  constexpr int kKVChunk = kTbKeys * kSwizzleRow;
  constexpr int kStage = 2 * NC * kKVChunk;        // K chunks, V chunks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint8_t* dos = qs + NC * kQChunk;
  uint8_t* ring = dos + NC * kQChunk;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kTbStages * kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTbStages;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  // the last row tiles see the most keys: they start first
  const int m0 = (a.tiles - 1 - static_cast<int>(blockIdx.z)) * kTbRows;
  const int kvh = head / (a.h / a.kh);
  const int n_tiles = tb_key_tiles(a, min(m0 + kTbRows, a.s));
  init_ring(q_full, full, 1, empty);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kTbConsumerWarps) {                  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * NC * kQChunk);
      for (int c = 0; c < NC; ++c) {
        tma_load(qs + c * kQChunk, &tq, q_full, c * kBoxCols, head, m0, b);
        tma_load(dos + c * kQChunk, &tdo, q_full, c * kBoxCols, head, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTbStages;
        if (j >= kTbStages) mbar_wait(&empty[st], (j / kTbStages - 1) & 1);
        uint8_t* ks = ring + st * kStage;
        uint8_t* vs = ks + NC * kKVChunk;
        mbar_expect_tx(&full[st], kStage);
        for (int c = 0; c < NC; ++c) {
          tma_load(ks + c * kKVChunk, &tk, &full[st], c * kBoxCols, kvh,
                   j * kTbKeys, b);
          tma_load(vs + c * kKVChunk, &tv, &full[st], c * kBoxCols, kvh,
                   j * kTbKeys, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int wg_row0 = m0 + 64 * wg;
  const int r0 = wg_row0 + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int my_tiles =
      wg_row0 < a.s ? tb_key_tiles(a, min(wg_row0 + 64, a.s)) : 0;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kSwizzleRow;
  const uint32_t do_addr = smem_u32(dos) + wg * 64 * kSwizzleRow;

  // this thread's rows' statistics; rows past S weigh 0 (1/l = 0)
  float m[2], inv_l[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    m[r] = inv_l[r] = drow[r] = 0.f;
    if (row < a.s) {
      const int64_t idx = stat_idx(a, b, head, row);
      m[r] = a.stats[idx];
      inv_l[r] = 1.f / fmaxf(a.stats[a.n_all + idx], 1e-30f);
      drow[r] = a.stats[2 * a.n_all + idx];
    }
  }

  float acc[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kTbStages;
    mbar_wait(&full[st], (j / kTbStages) & 1);
    if (j < my_tiles) {
      const uint32_t k_addr = smem_u32(ring + st * kStage);
      const uint32_t v_addr = k_addr + NC * kKVChunk;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      tile_product<KS>(s, q_addr, kQChunk, k_addr, kKVChunk);
      wgmma_commit();
      tile_product<KS>(dp, do_addr, kQChunk, v_addr, kKVChunk);
      wgmma_commit();

      // P from the scratch while dP is on the tensor cores
      wgmma_wait<1>();
      fence_regs(s);
      const int t0 = j * kTbKeys;
      const bool masked = t0 + kTbKeys > a.kv_lim ||
                          (a.causal && t0 + kTbKeys - 1 > a.q_offset + wg_row0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i / 2) % 2;
        const int key = t0 + 8 * (i / 4) + col + i % 2;
        const bool ok = !masked ||
                        (key < a.kv_lim &&
                         (!a.causal || key <= a.q_offset + r0 + 8 * half));
        s[i] = ok ? expf(s[i] * a.scale - m[half]) * inv_l[half] : 0.f;
      }
      // dS = P o (dP - D), as two bf16 terms packed as the A fragments of
      // dS.K
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int half = i % 2;
        split2(s[2 * i] * (dp[2 * i] - drow[half]),
               s[2 * i + 1] * (dp[2 * i + 1] - drow[half]), ds_hi[i],
               ds_lo[i]);
      }
      wgmma_fence();
      acc_product<NC>(acc, ds_hi, k_addr, kKVChunk);
      acc_product<NC>(acc, ds_lo, k_addr, kKVChunk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    release(empty, j, lane);
  }

  if (my_tiles == 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.s) continue;
    __nv_bfloat16* dst =
        a.dq + ((static_cast<int64_t>(b) * a.s + row) * a.h + head) * a.d;
#pragma unroll
    for (int n = 0; n < 8 * NC; ++n) {
      const int c = 8 * n + col;
      if (c < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
            acc[4 * n + 2 * r] * a.scale, acc[4 * n + 2 * r + 1] * a.scale);
      }
    }
  }
}

// ---- tc dkv: S^T and dP^T on the tensor cores, dV += P^T.dO, dK += dS^T.Q

template <int KS>
__global__ void __launch_bounds__(kTbDkvThreads, 1)
flash_bwd_tc_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, TbArgs a) {
  constexpr int NC = (KS + 3) / 4;
  constexpr int kKChunk = kTbKeyBlock * kSwizzleRow;
  constexpr int kRChunk = kTbRowTile * kSwizzleRow;
  // Q chunks, dO chunks, the rows' statistics
  constexpr int kStage = 2 * NC * kRChunk + kTbRowTile * kStatBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = base;
  uint8_t* vs = ks + NC * kKChunk;
  uint8_t* ring = vs + NC * kKChunk;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + kTbStages * kStage);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kTbStages;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  // the first key blocks are seen by the most rows: they start first
  const int key0 = static_cast<int>(blockIdx.z) * kTbKeyBlock;
  const int g = a.h / a.kh;
  // the rows of each head that see a key of the block: a causal row i
  // sees key t when t <= q_offset + i
  const int i_begin = a.causal ? max(0, key0 - a.q_offset) : 0;
  const int per_head = key0 < a.kv_lim && i_begin < a.s
                           ? (a.s - i_begin + kTbRowTile - 1) / kTbRowTile
                           : 0;
  const int n_tiles = g * per_head;
  // every producer lane arrives on `full` once its statistics are stored
  init_ring(kv_full, full, 32, empty);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= kTbConsumerWarps) {                  // the producer warpgroup
    // registers go to the consumers; one warp loads, the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kTbProducerRegs));
    if (warp > kTbConsumerWarps) return;
    if (n_tiles > 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * NC * kKChunk);
      for (int c = 0; c < NC; ++c) {
        tma_load(ks + c * kKChunk, &tk, kv_full, c * kBoxCols, kvh, key0, b);
        tma_load(vs + c * kKChunk, &tv, kv_full, c * kBoxCols, kvh, key0, b);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kTbStages;
      if (j >= kTbStages) mbar_wait(&empty[st], (j / kTbStages - 1) & 1);
      const int head = kvh * g + j / per_head;
      const int i0 = i_begin + (j % per_head) * kTbRowTile;
      uint8_t* qt = ring + st * kStage;
      float4* sts = reinterpret_cast<float4*>(qt + 2 * NC * kRChunk);
      for (int r = lane; r < kTbRowTile; r += 32) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // rows past S weigh 0
        if (i0 + r < a.s) {
          const int64_t idx = stat_idx(a, b, head, i0 + r);
          v = make_float4(a.stats[idx],
                          1.f / fmaxf(a.stats[a.n_all + idx], 1e-30f),
                          a.stats[2 * a.n_all + idx], 0.f);
        }
        sts[r] = v;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * NC * kRChunk);
        for (int c = 0; c < NC; ++c) {
          tma_load(qt + c * kRChunk, &tq, &full[st], c * kBoxCols, head, i0,
                   b);
          tma_load(qt + (NC + c) * kRChunk, &tdo, &full[st], c * kBoxCols,
                   head, i0, b);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kTbConsumerRegs));

  // consumers: warpgroup wg takes keys kw0 = key0 + 64 wg ..; this thread
  // holds keys r0 and r0 + 8, rows 8 n + col + {0, 1} of each n-block of 8
  const int wg = warp / 4;
  const int kw0 = key0 + 64 * wg;
  const int r0 = kw0 + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const bool active =
      kw0 < a.kv_lim && (!a.causal || kw0 <= a.q_offset + a.s - 1);
  const uint32_t k_addr = smem_u32(ks) + wg * 64 * kSwizzleRow;
  const uint32_t v_addr = smem_u32(vs) + wg * 64 * kSwizzleRow;

  float dk[32 * NC], dv[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) dk[i] = dv[i] = 0.f;
  if (n_tiles > 0) mbar_wait(kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kTbStages;
    mbar_wait(&full[st], (j / kTbStages) & 1);
    const int i0 = i_begin + (j % per_head) * kTbRowTile;
    if (active && (!a.causal ||
                   kw0 <= a.q_offset + min(i0 + kTbRowTile, a.s) - 1)) {
      const uint32_t q_addr = smem_u32(ring + st * kStage);
      const uint32_t do_addr = q_addr + NC * kRChunk;
      const float4* sts = reinterpret_cast<const float4*>(
          ring + st * kStage + 2 * NC * kRChunk);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      tile_product<KS>(s, k_addr, kKChunk, q_addr, kRChunk);
      wgmma_commit();
      tile_product<KS>(dp, v_addr, kKChunk, do_addr, kRChunk);
      wgmma_commit();

      // P^T from each row's (m, 1/l) while dP^T is on the tensor cores, as
      // two bf16 terms packed as the A fragments of P^T.dO
      wgmma_wait<1>();
      fence_regs(s);
      const bool masked = kw0 + 63 >= a.kv_lim ||
                          (a.causal && kw0 + 63 > a.q_offset + i0);
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 sv = sts[8 * n + col + e];
          const int row = i0 + 8 * n + col + e;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int key = r0 + 8 * half;
            const bool ok = !masked ||
                            (key < a.kv_lim &&
                             (!a.causal || key <= a.q_offset + row));
            float& x = s[4 * n + 2 * half + e];
            x = ok ? expf(x * a.scale - sv.x) * sv.y : 0.f;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) split2(s[2 * i], s[2 * i + 1], p_hi[i],
                                          p_lo[i]);
      // dV += P^T.dO on the tensor cores while dS^T = P^T o (dP^T - D) is
      // formed, as two bf16 terms packed as the A fragments of dS^T.Q
      wgmma_fence();
      acc_product<NC>(dv, p_hi, do_addr, kRChunk);
      acc_product<NC>(dv, p_lo, do_addr, kRChunk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);
      uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float d0 = sts[8 * n + col].z;
        const float d1 = sts[8 * n + col + 1].z;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * n + 2 * half;
          split2(s[i] * (dp[i] - d0), s[i + 1] * (dp[i + 1] - d1),
                 ds_hi[2 * n + half], ds_lo[2 * n + half]);
        }
      }
      wgmma_fence();
      acc_product<NC>(dk, ds_hi, q_addr, kRChunk);
      acc_product<NC>(dk, ds_lo, q_addr, kRChunk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
    }
    release(empty, j, lane);
  }

  // every key below T is written: zeros where no row sees it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    if (key >= a.t) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * a.t + key) * a.kh + kvh) * a.d;
#pragma unroll
    for (int n = 0; n < 8 * NC; ++n) {
      const int c = 8 * n + col;
      if (c < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + off + c) =
            __floats2bfloat162_rn(dk[4 * n + 2 * r] * a.scale,
                                  dk[4 * n + 2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + off + c) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int KS>
cudaError_t launch_tc(int which, const CUtensorMap* maps, const TbArgs& a,
                      int64_t batch, cudaStream_t stream) {
  constexpr int NC = (KS + 3) / 4;
  constexpr int kBars = (1 + 2 * kTbStages) * 8;
  const dim3 grid(static_cast<unsigned>(which == kDkv ? a.kh : a.h),
                  static_cast<unsigned>(batch),
                  static_cast<unsigned>(a.tiles));
  cudaError_t err;
  if (which == kPre) {
    constexpr int smem = 1024 + NC * kTbRows * kSwizzleRow +
                         kTbStages * NC * kTbKeys * kSwizzleRow + kBars;
    err = cudaFuncSetAttribute(flash_bwd_tc_pre_kernel<KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_tc_pre_kernel<KS><<<grid, kTbThreads, smem, stream>>>(
        maps[0], maps[2], a);
  } else if (which == kDq) {
    constexpr int smem = 1024 + 2 * NC * kTbRows * kSwizzleRow +
                         kTbStages * 2 * NC * kTbKeys * kSwizzleRow + kBars;
    err = cudaFuncSetAttribute(flash_bwd_tc_dq_kernel<KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_tc_dq_kernel<KS><<<grid, kTbThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a);
  } else {
    constexpr int smem = 1024 + 2 * NC * kTbKeyBlock * kSwizzleRow +
                         kTbStages * (2 * NC * kTbRowTile * kSwizzleRow +
                                      kTbRowTile * kStatBytes) + kBars;
    err = cudaFuncSetAttribute(flash_bwd_tc_dkv_kernel<KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_tc_dkv_kernel<KS><<<grid, kTbDkvThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a);
  }
  return cudaGetLastError();
}

int run_tc(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* stats, void* dq, void* dk, void* dv,
           int64_t b, int64_t s, int64_t t, int64_t h, int64_t kh, int64_t d,
           int64_t causal, int64_t q_offset, int64_t kv_valid_len,
           int64_t dtype, int which, void* stream) {
  constexpr int64_t kMax = 0x7fffffff;
  if (dtype != 1 || d <= 0 || d > 128 || d % 16 || kh <= 0 || h % kh ||
      q_offset < 0 || kv_valid_len == 0 || kv_valid_len < -1 ||
      b > 65535 || h > kMax || t > kMax || s + q_offset > kMax ||
      stats == nullptr || (s + kTbRows - 1) / kTbRows > 65535 ||
      (t + kTbKeyBlock - 1) / kTbKeyBlock > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || s == 0 || t == 0 || h == 0) {
    return static_cast<int>(cudaSuccess);
  }
  // maps: Q, dO (rows of one query head), K, V (keys of one kv head); a
  // pre or dq block reads kTbRows rows and kTbKeys keys a box, a dkv
  // block kTbRowTile rows and kTbKeyBlock keys
  const uint32_t rows = which == kDkv ? kTbRowTile : kTbRows;
  const uint32_t keys = which == kDkv ? kTbKeyBlock : kTbKeys;
  CUtensorMap maps[4];
  if (!encode_map(&maps[0], q, b, s, h, d, rows) ||
      (which != kPre && !encode_map(&maps[1], dout, b, s, h, d, rows)) ||
      !encode_map(&maps[2], k, b, t, kh, d, keys) ||
      (which != kPre && !encode_map(&maps[3], v, b, t, kh, d, keys))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  TbArgs a;
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.stats = static_cast<float*>(stats);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.s = static_cast<int>(s);
  a.t = static_cast<int>(t);
  a.h = static_cast<int>(h);
  a.kh = static_cast<int>(kh);
  a.d = static_cast<int>(d);
  a.q_offset = static_cast<int>(q_offset);
  a.kv_lim = static_cast<int>(kv_valid_len < 0 || kv_valid_len > t
                                  ? t : kv_valid_len);
  a.causal = causal != 0;
  a.tiles = static_cast<int>(which == kDkv
                                 ? (t + kTbKeyBlock - 1) / kTbKeyBlock
                                 : (s + kTbRows - 1) / kTbRows);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  a.n_all = b * s * h;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d / 16) {
    case 1: err = launch_tc<1>(which, maps, a, b, st); break;
    case 2: err = launch_tc<2>(which, maps, a, b, st); break;
    case 3: err = launch_tc<3>(which, maps, a, b, st); break;
    case 4: err = launch_tc<4>(which, maps, a, b, st); break;
    case 5: err = launch_tc<5>(which, maps, a, b, st); break;
    case 6: err = launch_tc<6>(which, maps, a, b, st); break;
    case 7: err = launch_tc<7>(which, maps, a, b, st); break;
    default: err = launch_tc<8>(which, maps, a, b, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// All three: dtype 0 float32, 1 bfloat16, 2 float16; D a multiple of 8 up
// to 256; kv_valid_len -1 for none; stats a float32 scratch of
// 3 * B * S * H elements (m, l, D in that order, each (B, K, S * H / K)),
// written by rt_flash_attention_bwd_pre and read by the other two.

extern "C" int rt_flash_attention_bwd_pre(
    const void* q, const void* k, const void* o, const void* dout,
    void* stats, int64_t b, int64_t s, int64_t t, int64_t h, int64_t kh,
    int64_t d, int64_t causal, int64_t q_offset, int64_t kv_valid_len,
    int64_t dtype, void* stream) {
  Args a = make_args(q, k, nullptr, o, dout, stats, nullptr, nullptr,
                     nullptr, b, s, t, h, kh, d);
  return run(a, causal, q_offset, kv_valid_len, dtype, kPre, stream);
}

extern "C" int rt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, void* dq, int64_t b, int64_t s, int64_t t, int64_t h,
    int64_t kh, int64_t d, int64_t causal, int64_t q_offset,
    int64_t kv_valid_len, int64_t dtype, void* stream) {
  Args a = make_args(q, k, v, nullptr, dout, const_cast<void*>(stats), dq,
                     nullptr, nullptr, b, s, t, h, kh, d);
  return run(a, causal, q_offset, kv_valid_len, dtype, kDq, stream);
}

extern "C" int rt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, void* dk, void* dv, int64_t b, int64_t s, int64_t t,
    int64_t h, int64_t kh, int64_t d, int64_t causal, int64_t q_offset,
    int64_t kv_valid_len, int64_t dtype, void* stream) {
  Args a = make_args(q, k, v, nullptr, dout, const_cast<void*>(stats),
                     nullptr, dk, dv, b, s, t, h, kh, d);
  return run(a, causal, q_offset, kv_valid_len, dtype, kDkv, stream);
}

// The tc route: the same arguments, bfloat16 only (dtype 1), D % 16 == 0
// and D <= 128, the same scratch.  Returns cudaErrorNotSupported when a
// tensor map cannot be encoded.

extern "C" int rt_flash_attention_bwd_tc_pre(
    const void* q, const void* k, const void* o, const void* dout,
    void* stats, int64_t b, int64_t s, int64_t t, int64_t h, int64_t kh,
    int64_t d, int64_t causal, int64_t q_offset, int64_t kv_valid_len,
    int64_t dtype, void* stream) {
  return run_tc(q, k, nullptr, o, dout, stats, nullptr, nullptr, nullptr, b,
                s, t, h, kh, d, causal, q_offset, kv_valid_len, dtype, kPre,
                stream);
}

extern "C" int rt_flash_attention_bwd_tc_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, void* dq, int64_t b, int64_t s, int64_t t, int64_t h,
    int64_t kh, int64_t d, int64_t causal, int64_t q_offset,
    int64_t kv_valid_len, int64_t dtype, void* stream) {
  return run_tc(q, k, v, nullptr, dout, const_cast<void*>(stats), dq,
                nullptr, nullptr, b, s, t, h, kh, d, causal, q_offset,
                kv_valid_len, dtype, kDq, stream);
}

extern "C" int rt_flash_attention_bwd_tc_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* stats, void* dk, void* dv, int64_t b, int64_t s, int64_t t,
    int64_t h, int64_t kh, int64_t d, int64_t causal, int64_t q_offset,
    int64_t kv_valid_len, int64_t dtype, void* stream) {
  return run_tc(q, k, v, nullptr, dout, const_cast<void*>(stats), nullptr,
                dk, dv, b, s, t, h, kh, d, causal, q_offset, kv_valid_len,
                dtype, kDkv, stream);
}
