// RWKV6 WKV recurrence with data-dependent decay, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel wkv_pallas (_wkv_kernel) of
// repro/kernels/rwkv6_wkv/kernel.py:79.  Inputs: r, k, v, w (B, S, H, hd),
// u (H, hd) and s0 (B, H, hd, hd), all float32, contiguous and 16-byte
// aligned; outputs y (B, S, H, hd) and the final state (B, H, hd, hd),
// float32.  For each (b, h) and t = 0 .. S-1, with S the (hd, hd) state:
//
//   y_t[j]  = sum_i r_t[i] (S[i][j] + (u[i] k_t[i]) v_t[j])
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// the reference's y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}) and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T.  Three kernels compute it; ops.py
// picks one by S alone (variant()):
//
// * wkv_tc_kernel ("tc": S >= 64, the prefill) closes each chunk of 64
//   steps into matrix products on the tensor cores, each product as three
//   TF32 products, with every decay a product of w's: no exp or log;
// * wkv_dec_kernel ("dec": S == 1, every decode step) takes the one step
//   with one warp per 16 state columns of a head, the state in 16-byte
//   groups, no shared memory and no barrier;
// * wkv_kernel ("rec": S = 0 and 2 to 63, short calls) runs the
//   recurrence step by step in float32 multiply-adds.
//
// What bounds it on this card.  At the rwkv6-3b prefill shape
// (B, S, H, hd) = (4, 2048, 40, 64) it reads r, k, v, w and writes y, 84 MB
// each, plus s0 and the final state, 2.6 MB each: about 425 MB, 0.127 ms at
// 3.35 TB/s.  The recurrence needs 5 hd^2 + 5 hd operations per (b, t, h),
// a multiply-add counted as two: 6.8e9, 0.102 ms at the 67 TFLOP/s of
// scalar float32, so the bytes bound it.  The chunked form's matrix
// products are about 4 hd^2 + 1.5 C hd per (b, t, h) (C = 64: the state
// read and updated once per chunk, A V, and A's blocks across
// sub-chunks), three TF32 passes of it 2.3e10, 0.047 ms at 495 TFLOP/s,
// and A's diagonal 16 x 16 blocks 3.8e8 scalar operations, 0.006 ms at
// 67 TFLOP/s: the bytes bound it too.  A decode step (S = 1) is the two
// state tensors: about 1.6 us.
//
// The tc kernel.  The TPU kernel forms exp(+-L) of cumulative log-decays,
// which needs w >= 1e-30 (the log) and a (C, C, hd) segment exponential
// against float32 overflow.  Here every decay factor is a product of w's
// over a run of steps, so w = 0 stays exact, nothing overflows for w in
// [0, 1], and no cumulative sum of logs loses digits.  Per (b, h) and
// chunk of C = 64 steps, split into four sub-chunks of 16 (prefix P_K[t] =
// prod of w over sub-chunk K's steps before t, suffix Q_K[j] = over its
// steps after j, F_K = over all of it):
//
//   A[t][j] = sum_i r_t[i] k_j[i] prod_{j<s<t} w_s[i]          (j < t)
//           = (r_T o P_T o W_JT) . (k_J o Q_J)   for t in T, j in J < T,
//             W_JT = prod_{J<K<T} F_K
//   A[t][t] = sum_i r_t[i] u[i] k_t[i]                          (the bonus)
//   y       = (r o P_ex) S_in + A V,      P_ex[t] = P_T[t] prod_{K<T} F_K
//   S_out   = diag(P_last) S_in + (k o Q)^T V,
//             Q[j] = Q_J[j] prod_{K>J} F_K, P_last = prod_K F_K
//
// the reference kernel's algebra (kernel.py:2-11) without exp(+-L): no
// factor is ever divided.  A's 16 x 16 blocks on the diagonal (j, t in
// one sub-chunk) are running products from j, in float32 FMAs: one thread
// takes a pair of rows j and 15 - j (17 steps in all) over 8 of the hd
// columns, and hd / 8 neighbouring lanes sum their parts by shuffles.
//
// Precision: one TF32 product (10-bit mantissas) leaves y and the state
// 3e-4 to 6e-4 off the float32 recurrence, 30-60 times the 1e-5 every
// card check holds the kernel to, so every product runs as hi.hi + hi.lo +
// lo.hi with hi = tf32(v), lo = tf32(v - hi) (round to nearest, ties away:
// add 0x1000 to the bits and clear the low 13), into float32 accumulators:
// within 1e-6 of the recurrence (tests/test_torch_wkv.py emulates both).
// Each chunk's update of the state is summed from zero and added to the
// state in float32 with round to nearest, as the tensor cores' own float32
// accumulation does not round to nearest (the lesson of the SSD tc kernel,
// mamba2_ssd.cu): over 2048 steps of w within 1e-6 of 1 the kernel stays
// within about 2e-6 of a float64 recurrence, where the float32 recurrence
// drifts to about 8e-6 (chip_smoke.py phase 9).  Summing each k8 step's
// part of the update apart as well brought the state nearer float64 there
// but not y (the tensor cores' sum over i), and was slower: not kept.
//
// Layout of the tc work.  One block per (b, h), 4 hd threads: hd / 16
// "y warps" and as many "u warps", each pair owning 16 state columns j.
// The products run transposed with mma.sync m16n8k8 TF32 (y^T = S^T
// (r o P_ex)^T + V^T A^T, S^T' = P_last S^T + V^T (k o Q)): a y warp
// keeps its rows of S^T in registers for the whole sequence, as its own A
// operand (an accumulator of one n8 tile is the A fragment of one k8 step
// once k is read as 2 q, 2 q + 1), and writes y from its accumulators; its
// u warp sums the chunk's update V^T (k o Q) from zero and hands it over
// through shared memory.  Before the products, every thread takes one
// (sub-chunk, column i) of the decays (the chains of 16 multiplies), the
// diagonal blocks of A are summed as above, r and k become r o P and
// k o Q in place, the 12 16 x 8 tiles of the off-diagonal blocks run on
// the tensor cores, then r and k become r o P_ex and k o Q over the
// chunk in place.  A is split once into TF32 hi and lo as it is written,
// so its B fragments need no split.  r, k, w and v of a chunk are copied
// in with cp.async; w of the next chunk flies while the chunk's products
// run, and rows past S are r = k = v = 0, w = 1, so a ragged last chunk
// adds nothing.  105 KB of shared memory at hd 64 (128 registers, 8 bytes
// spilled): two blocks per SM, so the 160 blocks of the prefill shape all
// run at once, 28 SMs holding two.
//
// What bounds the tc kernel, from chip runs that took one part out at a
// time (their scripts are not kept, so their readings are not recorded):
// shared-memory traffic and the latency of its phases more than the
// tensor cores.  A's diagonal blocks (each thread reads 17 rows of r and
// w) and its 12 off-diagonal tiles (latency: two tiles a warp while the
// others wait at the barrier) took the largest share, the products the
// next, the staging whose latency the block does not hide the least.
// Tried and not kept, each no faster: the loop over a diagonal row
// unrolled (spills), one block per SM without the register cap, the
// off-diagonal tiles moved to the u warps with A's last products after a
// barrier, part of V^T A^T moved to the u warps, a warp taking both tiles
// of an off-diagonal block with one A fragment, and four diagonal rows a
// thread (half the shared-memory reads, more instructions: slower).
//
// The rec kernel.  One block takes one (b, h), or one tile of state
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
// step.  It adds u_i k_i v_j to every state element before the sum, 7 hd^2
// operations per step: two more per element than needed.
//
// The dec kernel.  A decode step reads and writes the (hd, hd) state of
// every (b, h) once and little else: at rwkv6-3b's decode shape (4, 1, 40,
// 64) 2.6 MB each way, 1.6 us at 3.35 TB/s, so the bytes bound it, and
// what keeps it from the bound is how many of them are in flight at once.
// The rec kernel at S = 1 stages four vectors through shared memory
// behind two barriers and reads the state in 4-byte words, eight lanes to
// a column, so each warp request covers half of its 32-byte sectors.  Here
// one warp takes one (b, h) and 16 state columns; lane = (row group
// g = lane / 4, column quad q = lane % 4) holds the R = hd / 8 rows
// i = g R, g R + 1, ..., g R + R - 1 of columns 16 t + 4 q .. + 3 as
// float4s: each load instruction of the warp reads eight whole 64-byte row
// segments.  A lane reads r, w, k and u of its R rows as float4s (float2s
// at hd 16; the four lanes of a row group load the same words: one
// broadcast) and v of its four columns as one float4, every load issued
// before the first use, so the warp's whole tile of the state is in flight
// at once.  (Rows g, g + 8, ... instead, with r, w, k, u as 4-byte words,
// were slower L2-cold at the decode shape on the H100, PERF.md: the
// scattered coefficient loads cost a second round trip.)
// Its partial y over its rows, in the rec kernel's multiply-adds, meets
// the other row groups' by three xor shuffles over lane bits 2 to 4, and
// lanes 0..3 write y as float4s; the new state goes out as float4s.  No
// shared memory, no barrier.  The caller picks the warps per block
// (ops.dec_warps) so the B H hd / 16 warps spread evenly over the SMs.
// r, k, v, w, u, s0, y and s_out must be 16-byte aligned (the wrapper
// refuses a misaligned s0), and s_out is never s0.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

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


// ---------------------------------------------------------------------------
// The dec kernel: one step, one warp per 16 state columns of a head

constexpr int kDecCols = 16;      // state columns of one warp
constexpr int kDecMaxWarps = 8;   // warps of a block, at most (ops.py)

// n contiguous floats from p into d, as float4s (float2s when n is 2);
// p 16-byte aligned (8-byte when n is 2)
template <int N>
__device__ __forceinline__ void load_row(float (&d)[N],
                                         const float* __restrict__ p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      d[c] = x.x;
      d[c + 1] = x.y;
      d[c + 2] = x.z;
      d[c + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "rows a lane: 2 or a multiple of 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x;
    d[1] = x.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(kDecMaxWarps * 32)
    wkv_dec_kernel(Args a, int64_t warps) {
  constexpr int kTiles = HD / kDecCols;       // warps of one (b, h)
  constexpr int kRows = HD / kGroups;         // state rows of a lane
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t wid = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (wid >= warps) return;                   // a whole warp leaves
  const int64_t bh = wid / kTiles;
  const int64_t head = bh % a.h;
  const int i0 = (lane >> 2) * kRows;         // the lane's first row, g R
  const int j = static_cast<int>(wid % kTiles) * kDecCols + 4 * (lane & 3);

  // every load first: the state tile, then the row coefficients and v
  const float* s0 = a.s0 + (bh * HD + i0) * HD + j;
  float4 st[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    st[m] = *reinterpret_cast<const float4*>(s0 + m * HD);
  }
  float rr[kRows], ww[kRows], kk[kRows], uu[kRows];
  load_row(rr, a.r + bh * HD + i0);           // S = 1: row (b, 0, h)
  load_row(ww, a.w + bh * HD + i0);
  load_row(kk, a.k + bh * HD + i0);
  load_row(uu, a.u + head * HD + i0);
  const float4 v4 = *reinterpret_cast<const float4*>(a.v + bh * HD + j);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const float uk = uu[m] * kk[m];
    acc.x = fmaf(rr[m], fmaf(uk, v4.x, st[m].x), acc.x);
    acc.y = fmaf(rr[m], fmaf(uk, v4.y, st[m].y), acc.y);
    acc.z = fmaf(rr[m], fmaf(uk, v4.z, st[m].z), acc.z);
    acc.w = fmaf(rr[m], fmaf(uk, v4.w, st[m].w), acc.w);
    st[m].x = fmaf(ww[m], st[m].x, kk[m] * v4.x);
    st[m].y = fmaf(ww[m], st[m].y, kk[m] * v4.y);
    st[m].z = fmaf(ww[m], st[m].z, kk[m] * v4.z);
    st[m].w = fmaf(ww[m], st[m].w, kk[m] * v4.w);
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {    // over g: lane bits 2..4
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  if (i0 == 0) *reinterpret_cast<float4*>(a.y + bh * HD + j) = acc;
  float* so = a.s_out + (bh * HD + i0) * HD + j;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    *reinterpret_cast<float4*>(so + m * HD) = st[m];
  }
}

template <int HD>
cudaError_t launch_dec(const Args& a, int64_t bh, int64_t warps_per_block,
                       cudaStream_t stream) {
  const int64_t warps = bh * (HD / kDecCols);
  const int64_t blocks = (warps + warps_per_block - 1) / warps_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv_dec_kernel<HD><<<static_cast<unsigned>(blocks),
                       static_cast<unsigned>(32 * warps_per_block), 0,
                       stream>>>(a, warps);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The tc kernel: the chunked form on the tensor cores

constexpr int kC = 64;             // steps per chunk
constexpr int kSub = 16;           // steps per sub-chunk
constexpr int kNSub = kC / kSub;
constexpr int kTri = 36;           // 8x8 blocks on and under A's diagonal
constexpr int kOffTiles = 12;      // 16x8 tiles of A's off-diagonal blocks

// Shared memory of the tc kernel, in floats.  Row strides: r (r o P, then
// r o P_ex) HD + 8, so the float2 fragment loads of rows g (and k pairs
// 2 q, 2 q + 1) cover 32 banks; k (k o Q within the sub-chunk, then over
// the chunk), w and v HD + 4, so the loads of rows 2 q, 2 q + 1 at column
// g do.
template <int HD>
struct TcLayout {
  static constexpr int SR = HD + 8;
  static constexpr int SK = HD + 4;
  static constexpr int kR = 0;
  static constexpr int kK = kR + kC * SR;
  static constexpr int kW = kK + kC * SK;
  static constexpr int kV = kW + kC * SK;
  static constexpr int kA = kV + kC * SK;       // A as hi, lo: kTri blocks
  static constexpr int kF = kA + kTri * 128;    // F_K, [kNSub][HD]
  static constexpr int kP = kF + kNSub * HD;    // P_last, [HD]
  static constexpr int kU = kP + HD;            // u of the head, [HD]
  static constexpr int kUpd = kU + HD;          // the u warps' updates
  static constexpr int kFloats = kUpd + HD * HD;
};

// A in 8x8 blocks (bt, bj) of its lower triangle, each element split
// once into TF32 hi and lo: the pair (r, 2 p), (r, 2 p + 1) of a block as
// one float4 (hi, hi, lo, lo), rows of 16 floats, so a B fragment is one
// 16-byte load and a quarter-warp's loads at (g, 2 q) cover 32 banks.
__device__ __forceinline__ int tri(int bt, int bj, int r, int col) {
  return (bt * (bt + 1) / 2 + bj) * 128 + r * 16 + 2 * col;
}

// element (t, j) of A, j <= t, split into the hi, lo planes of tri()
__device__ __forceinline__ void put_a(float* as, int t, int j, float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  float* p = as + tri(t >> 3, j >> 3, t & 7, j & ~1 & 7) + (j & 1);
  p[0] = __uint_as_float(hi);
  p[2] = __uint_as_float(lo);
}

// the pair (c0, c1) of A at tri(bt, bj, r, col), col even
__device__ __forceinline__ void put_a2(float* as, int bt, int bj, int r,
                                       int col, float c0, float c1) {
  uint32_t h0, l0, h1, l1;
  split(c0, h0, l0);
  split(c1, h1, l1);
  *reinterpret_cast<float4*>(as + tri(bt, bj, r, col)) =
      make_float4(__uint_as_float(h0), __uint_as_float(h1),
                  __uint_as_float(l0), __uint_as_float(l1));
}

// a B fragment of A, already split
__device__ __forceinline__ void frag_b_split(FragB& f, const float* p) {
  const float4 m = *reinterpret_cast<const float4*>(p);
  f.hi[0] = __float_as_uint(m.x);
  f.hi[1] = __float_as_uint(m.y);
  f.lo[0] = __float_as_uint(m.z);
  f.lo[1] = __float_as_uint(m.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Fragments of mma.sync m16n8k8 (g = lane / 4, q = lane % 4): A holds
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B holds (k q, n g) and
// (k q + 4, n g); the accumulator (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).  Every k step reads k = q as 2 q and k = q + 4 as
// 2 q + 1 of its eight, on both operands.
template <int HD>
__global__ void __launch_bounds__(4 * HD, HD <= 64 ? 2 : 1)
wkv_tc_kernel(Args a) {
  using Lay = TcLayout<HD>;
  constexpr int kThreads = 4 * HD;
  constexpr int kWarps = kThreads / 32;
  constexpr int kJG = HD / 16;    // column groups: y warps, and u warps
  constexpr int kKI = HD / 8;     // k8 steps (n8 tiles) over i
  constexpr int kTN = kC / 8;     // n8 tiles (k8 steps) over the chunk's t
  constexpr int kGI = HD / 8;     // lanes that share a row of A's diagonal
  constexpr int SR = Lay::SR;
  constexpr int SK = Lay::SK;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem + Lay::kR;
  float* ks = smem + Lay::kK;
  float* ws = smem + Lay::kW;
  float* vs = smem + Lay::kV;
  float* as = smem + Lay::kA;
  float* fs = smem + Lay::kF;
  float* ps = smem + Lay::kP;
  float* us = smem + Lay::kU;
  float* upd = smem + Lay::kUpd;

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const bool ywarp = warp < kJG;
  const int jg = ywarp ? warp : warp - kJG;
  const int j0 = 16 * jg + g;               // columns j0, j0 + 8 of S, y
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.h;
  const int64_t head = bh % a.h;
  const int64_t row = a.h * HD;             // floats from step t to t + 1
  const int64_t base = (b * a.s * a.h + head) * HD;

  for (int e = tid; e < kTri * 128; e += kThreads) as[e] = 0.f;
  for (int e = tid; e < HD; e += kThreads) us[e] = a.u[head * HD + e];

  // rows t0 .. t0 + n - 1 of src into dst (row stride st) as this thread's
  // asynchronous copies; rows n .. kC - 1 set to fill
  auto stage = [&](float* dst, int st, const float* src, int64_t t0, int n,
                   float fill) {
    for (int e = tid; e < n * (HD / 4); e += kThreads) {
      const int t = e / (HD / 4), col = 4 * (e % (HD / 4));
      __pipeline_memcpy_async(dst + t * st + col,
                              src + base + (t0 + t) * row + col, 16);
    }
    for (int e = n * HD + tid; e < kC * HD; e += kThreads) {
      dst[(e / HD) * st + e % HD] = fill;
    }
  };

  // S^T, rows j0 and j0 + 8, columns i = 8 nn + 2 q and + 1 (y warps)
  float sacc[kKI][4];
  const float* s0 = a.s0 + bh * HD * HD;
#pragma unroll
  for (int nn = 0; nn < kKI; ++nn) {
    const int i = 8 * nn + 2 * q;
    sacc[nn][0] = ywarp ? s0[i * HD + j0] : 0.f;
    sacc[nn][1] = ywarp ? s0[(i + 1) * HD + j0] : 0.f;
    sacc[nn][2] = ywarp ? s0[i * HD + j0 + 8] : 0.f;
    sacc[nn][3] = ywarp ? s0[(i + 1) * HD + j0 + 8] : 0.f;
  }

  const int64_t chunks = (a.s + kC - 1) / kC;
  auto rows_at = [&](int64_t ci) {
    return static_cast<int>(a.s - ci * kC < kC ? a.s - ci * kC : kC);
  };
  stage(ws, SK, a.w, 0, rows_at(0), 1.f);
  stage(rs, SR, a.r, 0, rows_at(0), 0.f);
  stage(ks, SK, a.k, 0, rows_at(0), 0.f);
  stage(vs, SK, a.v, 0, rows_at(0), 0.f);
  __pipeline_commit();

  // the decays: thread (ck, cc) owns column cc of sub-chunk ck
  const int ck = tid / HD;
  const int cc = tid % HD;
  for (int64_t ci = 0; ci < chunks; ++ci) {
    const int n = rows_at(ci);
    const int64_t t0 = ci * kC;
    __pipeline_wait_prior(0);
    // (1) every copy and fill of this chunk is visible; the last chunk's
    // reads of every buffer are done
    __syncthreads();

    // F_K, the product of the sub-chunk's w (in the order the prefix
    // below takes them)
    {
      float f = 1.f;
#pragma unroll
      for (int s = 0; s < kSub; ++s) f *= ws[(kSub * ck + s) * SK + cc];
      fs[ck * HD + cc] = f;
    }
    // A's diagonal 16x16 blocks: rows j = jp and 15 - jp of sub-chunk K,
    // columns i = 4 ig .. + 3 and HD / 2 + 4 ig .. + 3, 17 steps: at t = j
    // the bonus sum_i r_j u k_j, after it sum_i r_t (k_j prod_{j<s<t} w_s)
    {
      const int ig = tid % kGI;
      const int task = tid / kGI;
      const int o = kSub * (task / 8);
      const int jp = task % 8;
      const int i0 = 4 * ig, i1 = HD / 2 + 4 * ig;
      const float4 u0 = ld4(us + i0), u1 = ld4(us + i1);
      float4 c0 = make_float4(0.f, 0.f, 0.f, 0.f), c1 = c0;
      int j = jp, t = jp;
#pragma unroll 1
      for (int step = 0; step <= kSub; ++step, ++t) {
        if (step == kSub - jp) t = j = kSub - 1 - jp;
        const float* rr = rs + (o + t) * SR;
        float x;
        if (t == j) {
          c0 = ld4(ks + (o + j) * SK + i0);
          c1 = ld4(ks + (o + j) * SK + i1);
          x = dot4(ld4(rr + i0), mul4(c0, u0), 0.f) +
              dot4(ld4(rr + i1), mul4(c1, u1), 0.f);
        } else {
          x = dot4(ld4(rr + i0), c0, 0.f) + dot4(ld4(rr + i1), c1, 0.f);
          c0 = mul4(c0, ld4(ws + (o + t) * SK + i0));
          c1 = mul4(c1, ld4(ws + (o + t) * SK + i1));
        }
#pragma unroll
        for (int off = kGI / 2; off > 0; off >>= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, off);
        }
        if (ig == 0) put_a(as, o + t, o + j, x);
      }
    }
    __syncthreads();                        // (2) raw r, k, w read

    // r o P and k o Q in place: P the prefix within the sub-chunk
    // (exclusive), Q the suffix (exclusive)
    {
      float p = 1.f;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const int t = kSub * ck + s;
        rs[t * SR + cc] *= p;
        p *= ws[t * SK + cc];
      }
      float qv = 1.f;
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const int t = kSub * ck + s;
        ks[t * SK + cc] *= qv;
        qv *= ws[t * SK + cc];
      }
    }
    __syncthreads();                        // (3) w read
    // the next chunk's w flies from here to the next chunk's (1)
    if (ci + 1 < chunks) stage(ws, SK, a.w, t0 + kC, rows_at(ci + 1), 1.f);

    // A's off-diagonal blocks (T, J), J < T, as 12 16x8 tiles:
    // (r_T o P_T o W_JT) (k_J o Q_J)^T, W_JT = prod_{J<K<T} F_K, each tile's
    // three TF32 products in three accumulators
    for (int tile = warp; tile < kOffTiles; tile += kWarps) {
      const int pr = tile >> 1, nt = tile & 1;
      const int tb = 1 + (pr >= 1) + (pr >= 3);
      const int jb = pr - tb * (tb - 1) / 2;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float acc_hl[4] = {0.f, 0.f, 0.f, 0.f};
      float acc_lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < kKI; ++kk) {
        const int i = 8 * kk + 2 * q;
        float2 wf = make_float2(1.f, 1.f);
        for (int kb = jb + 1; kb < tb; ++kb) {
          const float2 f = ld2(fs + kb * HD + i);
          wf.x *= f.x;
          wf.y *= f.y;
        }
        const float2 lt = ld2(rs + (kSub * tb + g) * SR + i);
        const float2 lb = ld2(rs + (kSub * tb + g + 8) * SR + i);
        const float2 rj = ld2(ks + (kSub * jb + 8 * nt + g) * SK + i);
        FragA fa;
        frag_a(fa, lt.x * wf.x, lb.x * wf.x, lt.y * wf.y, lb.y * wf.y);
        FragB fb;
        frag_b(fb, rj.x, rj.y);
        mma_tf32(acc_lh, fa.lo, fb.hi);
        mma_tf32(acc_hl, fa.hi, fb.lo);
        mma_tf32(acc, fa.hi, fb.hi);
      }
      const int bj = 2 * jb + nt;
      put_a2(as, 2 * tb, bj, g, 2 * q, acc[0] + (acc_lh[0] + acc_hl[0]),
             acc[1] + (acc_lh[1] + acc_hl[1]));
      put_a2(as, 2 * tb + 1, bj, g, 2 * q, acc[2] + (acc_lh[2] + acc_hl[2]),
             acc[3] + (acc_lh[3] + acc_hl[3]));
    }
    __syncthreads();                        // (4) r o P, k o Q read

    // r o P_ex and k o Q in place: P_ex = P prod_{K<ck} F_K, Q = Q
    // prod_{K>ck} F_K; P_last = prod_K F_K
    {
      float gk = 1.f, hk = 1.f;
      for (int kb = 0; kb < ck; ++kb) gk *= fs[kb * HD + cc];
      for (int kb = kNSub - 1; kb > ck; --kb) hk *= fs[kb * HD + cc];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const int t = kSub * ck + s;
        rs[t * SR + cc] *= gk;
        ks[t * SK + cc] *= hk;
      }
      if (ck == kNSub - 1) ps[cc] = gk * fs[(kNSub - 1) * HD + cc];
    }
    __syncthreads();                        // (5) the chunk's operands

    if (ywarp) {
      // y^T = S^T (r o P_ex)^T + V^T A^T (A with the bonus on its
      // diagonal), then y rows t < n
      float yacc[kTN][4];
#pragma unroll
      for (int nt = 0; nt < kTN; ++nt) {
        yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKI; ++kk) {
        FragA fa;
        frag_a(fa, sacc[kk][0], sacc[kk][2], sacc[kk][1], sacc[kk][3]);
#pragma unroll
        for (int nt = 0; nt < kTN; ++nt) {
          const float2 rv = ld2(rs + (8 * nt + g) * SR + 8 * kk + 2 * q);
          FragB fb;
          frag_b(fb, rv.x, rv.y);
          mma3(yacc[nt], fa, fb);
        }
      }
#pragma unroll
      for (int kt = 0; kt < kTN; ++kt) {
        const int t = 8 * kt + 2 * q;
        FragA fv;
        frag_a(fv, vs[t * SK + j0], vs[t * SK + j0 + 8],
               vs[(t + 1) * SK + j0], vs[(t + 1) * SK + j0 + 8]);
#pragma unroll
        for (int nt = kt; nt < kTN; ++nt) {
          FragB fm;
          frag_b_split(fm, as + tri(nt, kt, g, 2 * q));
          mma3(yacc[nt], fv, fm);
        }
      }
      float* y = a.y + base + t0 * row;
#pragma unroll
      for (int nt = 0; nt < kTN; ++nt) {
        const int t = 8 * nt + 2 * q;
        if (t < n) {
          y[t * row + j0] = yacc[nt][0];
          y[t * row + j0 + 8] = yacc[nt][2];
        }
        if (t + 1 < n) {
          y[(t + 1) * row + j0] = yacc[nt][1];
          y[(t + 1) * row + j0 + 8] = yacc[nt][3];
        }
      }
    } else {
      // the chunk's update V^T (k o Q), summed from zero over the chunk
      // (the tensor cores' accumulation) and added to the state in float32
      // after (6); at hd 128 in two halves of the columns i, so its
      // accumulators stay at 32 registers
      constexpr int kHalves = kKI > 8 ? 2 : 1;
      constexpr int kNH = kKI / kHalves;
      float* mine = upd + jg * (kKI * 4 * 32) + lane;
#pragma unroll 1
      for (int half = 0; half < kHalves; ++half) {
        float uacc[kNH][4];
#pragma unroll
        for (int nn = 0; nn < kNH; ++nn) {
          uacc[nn][0] = uacc[nn][1] = uacc[nn][2] = uacc[nn][3] = 0.f;
        }
#pragma unroll
        for (int kt = 0; kt < kTN; ++kt) {
          const int t = 8 * kt + 2 * q;
          FragA fv;
          frag_a(fv, vs[t * SK + j0], vs[t * SK + j0 + 8],
                 vs[(t + 1) * SK + j0], vs[(t + 1) * SK + j0 + 8]);
#pragma unroll
          for (int nn = 0; nn < kNH; ++nn) {
            const int i = 8 * (half * kNH + nn) + g;
            FragB fb;
            frag_b(fb, ks[t * SK + i], ks[(t + 1) * SK + i]);
            mma3(uacc[nn], fv, fb);
          }
        }
#pragma unroll
        for (int nn = 0; nn < kNH; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[((half * kNH + nn) * 4 + e) * 32] = uacc[nn][e];
          }
        }
      }
    }
    __syncthreads();                        // (6) r, k, v, A read; update
    if (ci + 1 < chunks) {
      stage(rs, SR, a.r, t0 + kC, rows_at(ci + 1), 0.f);
      stage(ks, SK, a.k, t0 + kC, rows_at(ci + 1), 0.f);
      stage(vs, SK, a.v, t0 + kC, rows_at(ci + 1), 0.f);
    }
    __pipeline_commit();
    if (ywarp) {
      // S^T' = P_last S^T + update, in float32 with round to nearest
      const float* theirs = upd + jg * (kKI * 4 * 32) + lane;
#pragma unroll
      for (int nn = 0; nn < kKI; ++nn) {
        const float2 pl = ld2(ps + 8 * nn + 2 * q);
        sacc[nn][0] = fmaf(pl.x, sacc[nn][0], theirs[(nn * 4 + 0) * 32]);
        sacc[nn][1] = fmaf(pl.y, sacc[nn][1], theirs[(nn * 4 + 1) * 32]);
        sacc[nn][2] = fmaf(pl.x, sacc[nn][2], theirs[(nn * 4 + 2) * 32]);
        sacc[nn][3] = fmaf(pl.y, sacc[nn][3], theirs[(nn * 4 + 3) * 32]);
      }
    }
  }

  if (ywarp) {
    float* so = a.s_out + bh * HD * HD;
#pragma unroll
    for (int nn = 0; nn < kKI; ++nn) {
      const int i = 8 * nn + 2 * q;
      so[i * HD + j0] = sacc[nn][0];
      so[(i + 1) * HD + j0] = sacc[nn][1];
      so[i * HD + j0 + 8] = sacc[nn][2];
      so[(i + 1) * HD + j0 + 8] = sacc[nn][3];
    }
  }
}

template <int HD>
cudaError_t launch_tc(const Args& a, int64_t bh, cudaStream_t stream) {
  constexpr int smem = TcLayout<HD>::kFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_tc_kernel<HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  wkv_tc_kernel<HD><<<static_cast<unsigned>(bh), 4 * HD, smem, stream>>>(a);
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

// hd one of 16, 32, 64, 128; s >= 1
extern "C" int rt_wkv_tc(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* s_out, int64_t b, int64_t s,
                         int64_t h, int64_t hd, void* stream) {
  if (b < 0 || s < 1 || h < 0 || b * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  Args a{};
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_tc<16>(a, b * h, st); break;
    case 32: err = launch_tc<32>(a, b * h, st); break;
    case 64: err = launch_tc<64>(a, b * h, st); break;
    case 128: err = launch_tc<128>(a, b * h, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// One decode step (S = 1).  hd one of 16, 32, 64, 128; warps_per_block
// from 1 to 8; every pointer 16-byte aligned, s_out not s0
extern "C" int rt_wkv_dec(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int64_t b, int64_t h,
                          int64_t hd, int64_t warps_per_block, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (b < 0 || h < 0 || b * h > 0x7fffffffLL || warps_per_block < 1 ||
      warps_per_block > kDecMaxWarps || !aligned(r) || !aligned(k) ||
      !aligned(v) || !aligned(w) || !aligned(u) || !aligned(s0) ||
      !aligned(y) || !aligned(s_out) || s0 == s_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || h == 0) return static_cast<int>(cudaSuccess);
  Args a{};
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = static_cast<float*>(y);
  a.s_out = static_cast<float*>(s_out);
  a.s = 1;
  a.h = h;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_dec<16>(a, b * h, warps_per_block, st); break;
    case 32: err = launch_dec<32>(a, b * h, warps_per_block, st); break;
    case 64: err = launch_dec<64>(a, b * h, warps_per_block, st); break;
    case 128: err = launch_dec<128>(a, b * h, warps_per_block, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
