// RWKV6 WKV recurrence with data-dependent decay, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel wkv_pallas (_wkv_kernel) of
// repro/kernels/rwkv6_wkv/kernel.py.  Inputs: r, k, v, w (B, S, H, hd),
// u (H, hd) and s0 (B, H, hd, hd), all float32, contiguous and 16-byte
// aligned; outputs y (B, S, H, hd) and the final state (B, H, hd, hd),
// float32.  For each (b, h) and t = 0 .. S-1, with S the (hd, hd) state:
//
//   y_t[j]  = sum_i r_t[i] (S[i][j] + (u[i] k_t[i]) v_t[j])
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// the reference's y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}) and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T, in float32 multiply-adds.  The TPU
// kernel closes each chunk of 64 steps into matrix products over exp(+-L)
// of cumulative log-decays, which forces a chunk limit against float32
// overflow and a floor on w (log of 1e-30).  This kernel runs the
// recurrence itself, step by step: no exp or log, no chunk limit, w = 0
// exact, any S >= 0 (ragged S included), and the arithmetic of the
// sequential reference.
//
// What bounds it on this card.  At the rwkv6-3b prefill shape
// (B, S, H, hd) = (4, 2048, 40, 64) it reads r, k, v, w and writes y, 84 MB
// each, plus s0 and the final state, 2.6 MB each: about 425 MB, 0.127 ms at
// 3.35 TB/s.  The fewest operations the function needs, a multiply-add
// counted as two, are 5 hd^2 + 5 hd per (b, t, h): per state element one
// multiply-add for sum_i r_i S_ij and a multiply and a multiply-add for
// the state, per row and column the bonus v_j sum_i r_i u_i k_i.  That is
// 6.8e9, 0.102 ms at the 67 TFLOP/s of scalar float32, so the bytes bound
// it.  (This kernel adds u_i k_i v_j to every state element before the
// sum, 7 hd^2 per step: two more operations per element than needed.)  A
// decode step (S = 1) is the two state tensors: about 1.6 us.
//
// Layout of the work.  One block takes one (b, h), or one tile of state
// columns of it when B * H blocks would not fill the card (a decode step
// of few sequences): the caller picks the tile (col_tiles in ops.py).
// Eight neighbouring lanes share state column j, each holding the rows
// i = g, g + 8, g + 16, ... (g = lane % 8) in registers, so a block runs
// 8 hd threads and each thread carries hd / 8 state values; the eight
// partial sums of y_t[j] meet by three warp shuffles.  The block walks t
// inside the kernel: the state never leaves registers between steps.  It
// stages a chunk of steps at a time in shared memory, read from the
// (B, S, H, hd) layout in place with 16-byte coalesced loads (row t of
// head h at offset ((b S + t) H + h) hd): r, w, k and u k interleaved as
// one float4 per (t, i), so a thread fetches its four coefficients in one
// 16-byte read, and v beside them.  y is gathered in shared memory and
// written out row by row after the chunk: two barriers per chunk, none per
// step.
//
// Left for later: the chunked form on the tensor cores (the TPU design's
// matrix products, which need its overflow handling back), and overlapping
// a chunk's loads with the previous chunk's steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 8;          // lanes that share one state column
constexpr int kStageFloats = 1536;  // steps of a staged chunk times hd

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  int64_t s;      // steps
  int64_t h;      // heads
  int tile;       // state columns per block
};

template <int HD>
__global__ void __launch_bounds__(HD * kGroups) wkv_kernel(Args a) {
  constexpr int kChunk = kStageFloats / HD;   // steps staged at a time
  constexpr int kRows = HD / kGroups;         // state rows per thread
  constexpr int kQuads = HD / 4;              // float4s per row of r, k, ...
  __shared__ float4 c_s[kChunk][HD];          // (r, w, k, u k)
  __shared__ __align__(16) float v_s[kChunk][HD];
  __shared__ float y_s[kChunk][HD];

  const int tid = static_cast<int>(threadIdx.x);
  const int nthreads = static_cast<int>(blockDim.x);
  const int g = tid % kGroups;
  const int col0 = static_cast<int>(blockIdx.y) * a.tile;
  const int j = col0 + tid / kGroups;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.h;
  const int64_t head = bh % a.h;

  const float* s0 = a.s0 + bh * HD * HD;
  float st[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    st[m] = s0[static_cast<int64_t>(g + kGroups * m) * HD + j];
  }

  const float4* u4 = reinterpret_cast<const float4*>(a.u + head * HD);
  const int64_t row = a.h * HD;               // floats from step t to t + 1
  const int64_t base = (b * a.s * a.h + head) * HD;
  for (int64_t t0 = 0; t0 < a.s; t0 += kChunk) {
    const int n = static_cast<int>(a.s - t0 < kChunk ? a.s - t0 : kChunk);
    // the previous chunk's barriers ordered every read of c_s and v_s
    // before these writes
#pragma unroll 2
    for (int e = tid; e < n * kQuads; e += nthreads) {
      const int tt = e / kQuads;
      const int i = 4 * (e % kQuads);
      const int64_t off = base + (t0 + tt) * row + i;
      const float4 r4 = *reinterpret_cast<const float4*>(a.r + off);
      const float4 w4 = *reinterpret_cast<const float4*>(a.w + off);
      const float4 k4 = *reinterpret_cast<const float4*>(a.k + off);
      const float4 v4 = *reinterpret_cast<const float4*>(a.v + off);
      const float4 uu = u4[i / 4];
      c_s[tt][i] = make_float4(r4.x, w4.x, k4.x, uu.x * k4.x);
      c_s[tt][i + 1] = make_float4(r4.y, w4.y, k4.y, uu.y * k4.y);
      c_s[tt][i + 2] = make_float4(r4.z, w4.z, k4.z, uu.z * k4.z);
      c_s[tt][i + 3] = make_float4(r4.w, w4.w, k4.w, uu.w * k4.w);
      *reinterpret_cast<float4*>(&v_s[tt][i]) = v4;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const float4 c = c_s[tt][g + kGroups * m];
        acc = fmaf(c.x, fmaf(c.w, vj, st[m]), acc);
        st[m] = fmaf(c.y, st[m], c.z * vj);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (g == 0) y_s[tt][j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < n * a.tile; e += nthreads) {
      const int tt = e / a.tile;
      const int jj = col0 + e % a.tile;
      a.y[base + (t0 + tt) * row + jj] = y_s[tt][jj];
    }
  }

  float* so = a.s_out + bh * HD * HD;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    so[static_cast<int64_t>(g + kGroups * m) * HD + j] = st[m];
  }
}

template <int HD>
cudaError_t launch(const Args& a, int64_t bh, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>(HD / a.tile));
  wkv_kernel<HD><<<grid, a.tile * kGroups, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// hd one of 16, 32, 64, 128; tile (state columns per block) a power of two
// from 8 to hd; s >= 0 (s = 0 copies s0 to s_out)
extern "C" int rt_wkv_fwd(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int64_t b, int64_t s,
                          int64_t h, int64_t hd, int64_t tile, void* stream) {
  if (b < 0 || s < 0 || h < 0 || tile < 8 || tile > hd ||
      (tile & (tile - 1)) != 0 || b * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = static_cast<float*>(y);
  a.s_out = static_cast<float*>(s_out);
  a.s = s;
  a.h = h;
  a.tile = static_cast<int>(tile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch<16>(a, b * h, st); break;
    case 32: err = launch<32>(a, b * h, st); break;
    case 64: err = launch<64>(a, b * h, st); break;
    case 128: err = launch<128>(a, b * h, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
