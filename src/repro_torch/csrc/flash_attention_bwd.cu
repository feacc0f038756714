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
// dK and dV sum over the g = H / K query heads of a kv head.  Every element
// is upcast to float32 as it is read and every sum is float32; only the
// outputs are rounded to the inputs' dtype.
//
// Three kernels, each written like the forward's scalar kernel
// (flash_attention.cu, flash_fwd_kernel): a block of 8 warps, 32 "rows"
// of 4 a warp, tiles of 32 "columns" staged in shared memory as float32
// (rows padded by 4 floats so the 16-byte reads of 8 neighbouring lanes
// hit distinct banks), lane j taking column j of the tile for the dot
// products and output dims j, j + 32, ... for the accumulations, the
// column's value taken by a warp shuffle.
//
// * flash_bwd_pre_kernel: a block per (32 (query, head) rows of a kv
//   group, kv head, b).  It walks the keys the rows can see, as the
//   forward does, keeping the online row max m and row sum l, and writes
//   m, l and D = sum(dO o O) for each row into a float32 scratch.
// * flash_bwd_dq_kernel: the same blocks.  It walks the same keys,
//   recomputes s and dO.v for each (row, key), forms P and dS from the
//   scratch and accumulates dQ = dS.K in registers; scaled and rounded
//   once at the end.
// * flash_bwd_dkv_kernel: a block per (32 keys, kv head, b).  Its rows are
//   keys: it walks the (query, head) rows of the group that can see any of
//   its keys, in tiles of 32, recomputes s and v.dO, and accumulates
//   dV = P^T.dO and dK = dS^T.Q in registers.
//
// Each output element is written by exactly one thread, once: no atomics,
// so results are the same from run to run.  No tile past the causal
// horizon or kv_valid_len is read; keys at or past kv_valid_len get zero
// dK and dV.  The scores are computed in one order in all three kernels
// (a chain of fmaf over d ascending), so the m of the first kernel is the
// max of the very scores the other two exponentiate.
//
// What bounds it on this card: the products.  Four matrix products of
// 2*D operations each per valid (query, head, key) pair, plus the P
// recompute, 10*D operations a pair as the reference counts them; at
// qwen3-0.6b's training shape (4, 4096, 16/8, 128), causal, 6.9e11
// operations a call.  These kernels run them on the CUDA cores in float32
// (16*D a pair with the recomputes: 2*D in pre, 6*D in dq, 8*D in dkv);
// the tensor cores are later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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
