// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_fwd (_flash_kernel) of
// repro/kernels/flash_attention/kernel.py.  Inputs: q (B, S, H, D) and
// k, v (B, T, K, D), H % K == 0, all float32 or all bfloat16, contiguous;
// output o (B, S, H, D) in q's dtype.  Every element is upcast to float32;
// scores are q.k * (1/sqrt(D)) in float32, set to -1e30 where
// q_offset + i < kpos (causal) or kpos >= kv_valid_len; the softmax runs
// online in float32 (row max m, row sum l) and P.V accumulates in float32
// with P never rounded; o = acc / max(l, 1e-30).
//
// What bounds it on this card: the matrix products.  Prefill attention at
// (B, S, H, K, D) = (4, 2048, 16, 8, 128), causal, is about 6.9e10
// operations (4*B*H*D per valid query-key pair) against about 100 MB of
// q, k, v and o, so its bound is the tensor cores' 989 TFLOP/s (about
// 70 us), not the 3.35 TB/s of device memory (about 30 us).  A decode step
// (S = 1) against a cache of about 2,080 valid slots reads about 34 MB of
// K/V per layer for 1.7e8 operations: there the bytes bound it.
//
// What the design does about it, and what it leaves for later: this first
// kernel is scalar float32 (no mma/wgmma), so prefill sits well above its
// tensor-core bound.  It keeps the TPU kernel's one saving that matters on
// both machines: no tile past the causal horizon of a block's last row or
// past kv_valid_len is read, so causal prefill does half the work and a
// decode step reads only the valid part of the cache.  q_offset and
// kv_valid_len are runtime arguments, so decode does not specialise.
//
// Layout of the work.  A block takes one (b, kv head) pair and kRows
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

#include <cstdint>
#include <cuda_bf16.h>
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

__device__ inline void zero8(float* dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  d4[1] = d4[0];
}

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

}  // namespace

// dtype: 0 float32, 1 bfloat16; kv_valid_len -1 for none; kv_splits >= 1
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
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
