// Mamba2 SSD (state-space dual) scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_pallas (_ssd_kernel) of
// repro/kernels/mamba2_ssd/kernel.py.  Inputs, all float32: x (B, S, H, hd);
// b and c (B, S, N), one group shared by every head; dt (B, S, H),
// post-softplus; a and d (H,), a < 0; s0 (B, H, N, hd).  Outputs y
// (B, S, H, hd) and the final state (B, H, N, hd), float32.  For each
// (b, h) and t = 0 .. S-1, with S the (N, hd) state:
//
//   S[n][p] = exp(dt_t a) S[n][p] + b_t[n] (dt_t x_t[p])
//   y_t[p]  = sum_n c_t[n] S[n][p] + d x_t[p]
//
// the reference's S_t = e^{dt a} S_{t-1} + dt b_t x_t^T, y_t = c_t . S_t +
// d x_t.  Two kernels compute it; ops.py picks one by S alone (variant()):
//
// * ssd_tc_kernel ("tc": S >= 64, the prefill) closes each chunk of 64
//   steps into matrix products on the tensor cores, as the TPU kernel does
//   on its matrix unit, each product as three TF32 products;
// * ssd_kernel ("rec": S < 64, decode steps) runs the per-step recurrence
//   in float32 multiply-adds.
//
// What bounds it on this card.  At the zamba2-7b prefill shape (B, S, H,
// hd, N) = (4, 2048, 112, 64, 64) it reads x and writes y, 235 MB each,
// and reads b, c (4 MB each), dt (3.7 MB), s0 (7.3 MB) and writes the
// state (7.3 MB): about 492 MB, 0.147 ms at 3.35 TB/s.  The recurrence
// needs 5 N hd + 3 hd operations per (b, t, h), a multiply-add counted as
// two: 1.90e10, 0.283 ms at the 67 TFLOP/s of scalar float32, a floor no
// scalar design can pass.  The chunked form needs about (C + 1) hd +
// 4 N hd per (b, t, h) in matrix products (C = 64, M X over j <= t only;
// C b^T, shared by the heads, adds little), three TF32 passes of it
// 5.7e10, 0.114 ms at 495 TFLOP/s: under the bytes, so the tc kernel's
// bound is the 0.147 ms of device memory.  A decode step (S = 1) is the
// two state tensors, about 15 MB: 4.5 us.
//
// The tc kernel.  Per (b, h) and chunk of C = 64 steps, with the
// cumulative sum cum = cumsum(dt a) restarted at each chunk, so that every
// exponent below is <= 0 (the reference's chunk algebra, kernel.py:35-68):
//
//   G   = C_chunk B_chunk^T                                   (C x C)
//   M   = G o tril(e^{cum_t - cum_j}) o dt_j
//   y   = M X + e^{cum_t} (C_chunk S_in) + d X
//   S'  = e^{cum_last} S_in + B_chunk^T (w o X),  w_j = e^{cum_last - cum_j} dt_j
//
// Precision: one TF32 product (10-bit mantissas) leaves y and the state
// some 3e-4 off the float32 recurrence, 30-60 times the 1e-5 every card
// check holds the kernel to, so every product runs as hi.hi + hi.lo +
// lo.hi with hi = tf32(v), lo = tf32(v - hi) (round to nearest, ties away:
// add 0x1000 to the bits and clear the low 13), the small terms first,
// into float32 accumulators: within about 1e-6 of the recurrence, and
// nearer a float64 recurrence than the float32 one over long sequences
// (tests/test_torch_ssd.py emulates both).  The exponentials and masks are
// float32 expf outside the tensor cores.
//
// Layout of the tc work.  One block per (b, h), hd / 16 warps; warp w owns
// rows p = 16 w .. 16 w + 15 of S^T and y^T, so the products run transposed
// (y^T = S^T C^T + X^T M^T, S^T' = e^{cum_last} S^T + (w o X)^T B) with
// mma.sync m16n8k8 TF32: S^T stays in registers for the whole sequence and
// is its own A operand (the accumulator of one n8 tile is the A fragment
// of one k8 step once k is read as n = 2 q, 2 q + 1), so the state never
// goes through shared memory.  Each chunk's update of the state is summed
// from zero and added to it in float32 with round to nearest: the tensor
// cores' own float32 accumulation does not round to nearest, and the state
// carried as an accumulator through 32 chunks drifted to 9.8e-6 of a
// float64 recurrence (S = 2048, dt ~ 1e-6; 1.0e-6 this way).  G is the
// same for every head of a sequence, so ssd_gram_kernel, launched first,
// computes it once per (b, chunk) (its 20 16x8 tiles on and under the
// diagonal, the three TF32 products of a tile in three accumulators) into
// a scratch of 9 KB per chunk that stays in L2 (1.2 MB at the prefill
// shape); each block copies its chunk's G into shared memory with the
// staging and makes M of it in place, where every warp reads the 36 8x8
// blocks of M's lower triangle as B operands.
// Chunks of x, b, c and dt are copied in with cp.async (16 bytes where
// aligned) into two buffers, the next chunk's copies flying while this
// chunk's products run; rows past S are zero and their dt = 0 gives them
// no weight, so a ragged last chunk needs no padding in memory.  Staged
// rows are padded to a stride of 4 mod 32 banks, which with k read as
// steps 2 q, 2 q + 1 keeps the hot fragment loads conflict-free and their
// addresses a base plus a constant; with M a block takes 112 KB of shared
// memory, two blocks per SM, and the 448 blocks of the prefill run in two
// waves: 3 or 4 blocks per SM in all.
//
// Why this layout: against an XOR swizzle the padding leaves every
// fragment address a base plus a constant; y written out through shared
// memory as 16-byte rows, a warp's G tiles all in flight at once, the TF32
// rounding by cvt.rna (the same bits in more instructions) and less
// unrolling were each no faster on the H100.  What bounds it is
// instruction issue more than the tensor cores: most instructions are the
// hi/lo splits of operands (c, b, M) that every warp splits again.
//
// The rec kernel.  One block walks all S steps of its (b, h) with the
// state in registers: one exp per step and head, no chunk length, any
// S >= 0 (S = 0 copies s0 to the output state) and dt = 0 exactly.  One
// block per (b, h), 128 threads at hd 64: each thread holds two state
// columns p, p + 1 and the rows n = g, g + 4, g + 8, ... of them (g =
// lane % 4) in registers, N / 2 values, so each b and c value it reads
// from shared memory serves two columns; the four partial sums of y_t[p]
// meet by two warp shuffles.  The block stages chunks of steps in shared
// memory: x, b, c and dt copied in place from their strided layouts (row t
// of head h of x at b * x_sb + t * x_st + h * hd; b and c are read by
// every head of a sequence, and so mostly from L2) with asynchronous
// copies into two buffers, so that the next chunk's loads fly while this
// chunk's steps run.  b and c are staged so that a lane reads its rows as
// float4s without bank conflicts, and e^{dt a} once per step for the
// block.  y is gathered in shared memory and written out row by row after
// the chunk.
//
// What the first rec designs taught (chip_smoke.py phase 11 on the H100,
// PERF.md): eight lanes per column with scalar shared loads and every
// thread taking its own exp ran 1.89 ms at the prefill shape; four lanes
// with float4 loads and one exp per step 1.45 ms; two columns per thread
// alone did not help (1.51 ms); the staging loads were the wait (each
// thread's loads of a chunk issued one loop turn after another, none
// overlapped with the steps), and asynchronous double-buffered copies took
// it to about 1.0 ms, 3.8 times the scalar floor.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kGroups = 4;   // lanes that share a thread's state columns
constexpr int kCols = 2;     // state columns per thread

struct Args {
  const float* x;
  const float* b;
  const float* c;
  const float* dt;
  const float* a;
  const float* d;
  const float* s0;
  float* y;
  float* s_out;
  int64_t s;                 // steps
  int64_t h;                 // heads
  int64_t x_sb, x_st;        // strides of x over batch and time
  int64_t b_sb, b_st;        // of b
  int64_t c_sb, c_st;        // of c
  int64_t dt_sb, dt_st;      // of dt
  int vec;                   // x, b, c rows 16-byte aligned (tc staging)
  float* gram;               // tc: G of every (b, chunk), see ssd_gram_kernel
};

// Where row n of a staged b or c row lives: lane g = n % kGroups holds the
// rows n = g + kGroups m, and reads them as float4s, m = 4 q .. 4 q + 3
// from the quad at (q kGroups + g): the kGroups lanes of a column read
// neighbouring quads, and the columns of a warp the same ones (a
// broadcast), so the loads meet no bank conflict.
__device__ __forceinline__ int staged(int n) {
  const int g = n % kGroups;
  const int m = n / kGroups;
  return ((m / 4) * kGroups + g) * 4 + m % 4;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

template <int N, int HD>
__global__ void __launch_bounds__(HD / kCols * kGroups) ssd_kernel(Args a) {
  constexpr int kChunk = 2048 / (N + HD);     // steps staged at a time
  constexpr int kRows = N / kGroups;          // state rows per thread
  constexpr int kQuads = kRows / 4;
  static_assert(kRows % 4 == 0, "rows per lane come in float4s");
  // two buffers of staged steps: the next chunk's copies fly while this
  // chunk's steps run
  __shared__ __align__(16) float x_s[2][kChunk][HD];
  __shared__ __align__(16) float b_s[2][kChunk][N];
  __shared__ __align__(16) float c_s[2][kChunk][N];
  __shared__ float dt_s[2][kChunk];
  __shared__ float decay_s[kChunk];
  __shared__ float y_s[kChunk][HD];

  const int tid = static_cast<int>(threadIdx.x);
  const int nthreads = static_cast<int>(blockDim.x);
  const int g = tid % kGroups;
  const int p0 = kCols * (tid / kGroups);     // this thread's columns
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h;
  const int64_t head = bh % a.h;
  const float a_h = a.a[head];
  const float d_h = a.d[head];

  const float* x = a.x + bi * a.x_sb + head * HD;
  const float* bm = a.b + bi * a.b_sb;
  const float* cm = a.c + bi * a.c_sb;
  const float* dt = a.dt + bi * a.dt_sb + head;
  // issue the copies of steps t0 .. t0 + n - 1 into buffer buf, as one
  // group of this thread's asynchronous copies (empty groups included, so
  // every thread counts the same groups)
  auto stage = [&](int64_t t0, int n, int buf) {
    for (int e = tid; e < n * HD; e += nthreads) {
      copy_async(&x_s[buf][e / HD][e % HD],
                 x + (t0 + e / HD) * a.x_st + e % HD);
    }
    for (int e = tid; e < n * N; e += nthreads) {
      const int64_t t = t0 + e / N;
      const int r = staged(e % N);
      copy_async(&b_s[buf][e / N][r], bm + t * a.b_st + e % N);
      copy_async(&c_s[buf][e / N][r], cm + t * a.c_st + e % N);
    }
    for (int e = tid; e < n; e += nthreads) {
      copy_async(&dt_s[buf][e], dt + (t0 + e) * a.dt_st);
    }
    __pipeline_commit();
  };

  const float* s0 = a.s0 + bh * N * HD;
  float st[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      st[m][j] = s0[static_cast<int64_t>(g + kGroups * m) * HD + p0 + j];
    }
  }

  float* y = a.y + (bi * a.s * a.h + head) * HD;
  const int64_t y_st = a.h * HD;
  auto steps_at = [&](int64_t t0) {
    return static_cast<int>(a.s - t0 < kChunk ? a.s - t0 : kChunk);
  };
  if (a.s > 0) stage(0, steps_at(0), 0);
  for (int64_t t0 = 0, c = 0; t0 < a.s; t0 += kChunk, ++c) {
    const int buf = static_cast<int>(c & 1);
    const int n = steps_at(t0);
    // the previous chunk's last barrier ordered every read of the other
    // buffer before these copies overwrite it
    if (t0 + kChunk < a.s) {
      stage(t0 + kChunk, steps_at(t0 + kChunk), buf ^ 1);
      __pipeline_wait_prior(1);                 // this chunk's group is in
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    for (int e = tid; e < n; e += nthreads) {
      decay_s[e] = expf(dt_s[buf][e] * a_h);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float decay = decay_s[tt];
      const float dtv = dt_s[buf][tt];
      const float2 xp =
          *reinterpret_cast<const float2*>(&x_s[buf][tt][p0]);
      const float dx0 = dtv * xp.x;
      const float dx1 = dtv * xp.y;
      const float4* b4 = reinterpret_cast<const float4*>(b_s[buf][tt]) + g;
      const float4* c4 = reinterpret_cast<const float4*>(c_s[buf][tt]) + g;
      // two partial sums per column halve the chain of multiply-adds
      float acc0[2] = {0.f, 0.f};
      float acc1[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 bq = b4[q * kGroups];
        const float4 cq = c4[q * kGroups];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = 4 * q + i;
          st[m][0] = fmaf(decay, st[m][0], bv[i] * dx0);
          st[m][1] = fmaf(decay, st[m][1], bv[i] * dx1);
          acc0[i % 2] = fmaf(cv[i], st[m][0], acc0[i % 2]);
          acc1[i % 2] = fmaf(cv[i], st[m][1], acc1[i % 2]);
        }
      }
      float y0 = acc0[0] + acc0[1];
      float y1 = acc1[0] + acc1[1];
      y0 += __shfl_xor_sync(0xffffffffu, y0, 1);
      y1 += __shfl_xor_sync(0xffffffffu, y1, 1);
      y0 += __shfl_xor_sync(0xffffffffu, y0, 2);
      y1 += __shfl_xor_sync(0xffffffffu, y1, 2);
      if (g == 0) {
        y_s[tt][p0] = fmaf(d_h, xp.x, y0);
        y_s[tt][p0 + 1] = fmaf(d_h, xp.y, y1);
      }
    }
    __syncthreads();
    for (int e = tid; e < n * HD; e += nthreads) {
      const int tt = e / HD;
      y[(t0 + tt) * y_st + e % HD] = y_s[tt][e % HD];
    }
  }

  float* so = a.s_out + bh * N * HD;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      so[static_cast<int64_t>(g + kGroups * m) * HD + p0 + j] = st[m][j];
    }
  }
}

template <int N, int HD>
cudaError_t launch(const Args& a, int64_t bh, cudaStream_t stream) {
  ssd_kernel<N, HD><<<static_cast<unsigned>(bh), HD / kCols * kGroups, 0,
                      stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_hd(const Args& a, int64_t bh, int64_t hd,
                      cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<N, 16>(a, bh, stream);
    case 32: return launch<N, 32>(a, bh, stream);
    case 64: return launch<N, 64>(a, bh, stream);
    case 128: return launch<N, 128>(a, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tc kernel: the chunked form on the tensor cores

constexpr int kC = 64;            // steps per chunk
constexpr int kMTiles = 20;       // 16x8 tiles of G on and under the diagonal
constexpr int kTriBlocks = 36;    // 8x8 blocks of M's lower triangle

// Staged rows are padded by 4 floats: a row stride of 4 mod 32 banks puts
// the fragment loads of rows 2q and 2q + 1 (k steps below) on 32 distinct
// banks, keeps rows 16-byte aligned for cp.async, and leaves every
// fragment address a per-thread base plus a constant.
constexpr int kPad = 4;

template <int N, int HD>
constexpr int tc_smem_bytes() {
  // x, b, c in two buffers; M; dt in two buffers; cum, e^{cum}, w, e^{last}
  return 4 * (2 * kC * (HD + kPad) + 4 * kC * (N + kPad) + kTriBlocks * 64 +
              2 * kC + 3 * kC + 4);
}

// Element (r, col) of the 8x8 block (bt, bj), bj <= bt, of M, blocks
// row-major: the float2 stores and B-fragment loads at (g, 2 q) of a
// half-warp cover 32 banks.
__device__ __forceinline__ int tri(int bt, int bj, int r, int col) {
  return (bt * (bt + 1) / 2 + bj) * 64 + r * 8 + col;
}

// G = C B^T of every (b, chunk), the same for every head: the 36 8x8
// blocks on and under the diagonal of each, in tri() order, float32 (the
// mask and decays are per head and come later).  One block per (b, chunk),
// 4 warps over the 20 16x8 tiles, each tile's three TF32 products in three
// accumulators (three chains of N / 8 dependent products).
template <int N>
__global__ void __launch_bounds__(128) ssd_gram_kernel(Args a,
                                                       int64_t chunks) {
  constexpr int SN = N + kPad;
  constexpr int kSN = N / 8;
  extern __shared__ __align__(16) float smem[];
  float* bsm = smem;                        // [kC][SN]
  float* csm = smem + kC * SN;              // [kC][SN]
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int64_t ci = blockIdx.x % chunks;
  const int64_t bi = blockIdx.x / chunks;
  const int64_t t0 = ci * kC;
  const int n = static_cast<int>(a.s - t0 < kC ? a.s - t0 : kC);
  const float* bm = a.b + bi * a.b_sb + t0 * a.b_st;
  const float* cm = a.c + bi * a.c_sb + t0 * a.c_st;
  for (int e = tid; e < kC * N; e += 128) {
    const int t = e / N, col = e % N;
    bsm[t * SN + col] = t < n ? bm[t * a.b_st + col] : 0.f;
    csm[t * SN + col] = t < n ? cm[t * a.c_st + col] : 0.f;
  }
  __syncthreads();
  float* out = a.gram + (bi * chunks + ci) * (kTriBlocks * 64);
  // tile (mt, nt) covers t = 16 mt .. + 15 and j = 8 nt .. + 7,
  // nt <= 2 mt + 1
  for (int tile = warp; tile < kMTiles; tile += 4) {
    const int mt = (tile >= 2) + (tile >= 6) + (tile >= 12);
    const int nt = tile - mt * (mt + 1);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float acc_hl[4] = {0.f, 0.f, 0.f, 0.f};
    float acc_lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kSN; ++kk) {
      const int k0 = 8 * kk + 2 * q;
      const float2 u =
          *reinterpret_cast<const float2*>(csm + (16 * mt + g) * SN + k0);
      const float2 v =
          *reinterpret_cast<const float2*>(csm + (16 * mt + g + 8) * SN + k0);
      const float2 w =
          *reinterpret_cast<const float2*>(bsm + (8 * nt + g) * SN + k0);
      FragA fa;
      frag_a(fa, u.x, v.x, u.y, v.y);
      FragB fb;
      frag_b(fb, w.x, w.y);
      mma_tf32(acc_lh, fa.lo, fb.hi);
      mma_tf32(acc_hl, fa.hi, fb.lo);
      mma_tf32(acc, fa.hi, fb.hi);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int bt = 2 * mt + half;
      if (nt > bt) continue;                // all above the diagonal
      *reinterpret_cast<float2*>(out + tri(bt, nt, g, 2 * q)) = make_float2(
          acc[2 * half] + (acc_lh[2 * half] + acc_hl[2 * half]),
          acc[2 * half + 1] + (acc_lh[2 * half + 1] + acc_hl[2 * half + 1]));
    }
  }
}

// Fragments of mma.sync m16n8k8 (g = lane / 4, q = lane % 4): A holds
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B holds (k q, n g) and
// (k q + 4, n g); the accumulator (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).
template <int N, int HD>
__global__ void __launch_bounds__(2 * HD) ssd_tc_kernel(Args a) {
  constexpr int kWarps = HD / 16;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kTN = kC / 8;     // n8 tiles (k8 steps) over the chunk's t
  constexpr int kSN = N / 8;      // n8 tiles (k8 steps) over the state's n
  constexpr int SX = HD + kPad;   // row strides of the staged x, b, c
  constexpr int SN = N + kPad;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // [2][kC][SX]
  float* bs = xs + 2 * kC * SX;             // [2][kC][SN]
  float* cs = bs + 2 * kC * SN;             // [2][kC][SN]
  float* ms = cs + 2 * kC * SN;             // M, [kTriBlocks][8][8]
  float* dts = ms + kTriBlocks * 64;        // [2][kC]
  float* cum = dts + 2 * kC;                // [kC]
  float* et = cum + kC;                     // e^{cum_t}
  float* wt = et + kC;                      // e^{cum_last - cum_t} dt_t
  float* elast = wt + kC;                   // e^{cum_last}

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int p0 = 16 * warp + g;             // rows p0, p0 + 8 of S^T, y^T
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h;
  const int64_t head = bh % a.h;
  const float a_h = a.a[head];
  const float d_h = a.d[head];

  const float* x = a.x + bi * a.x_sb + head * HD;
  const float* bm = a.b + bi * a.b_sb;
  const float* cm = a.c + bi * a.c_sb;
  const float* dt = a.dt + bi * a.dt_sb + head;
  // copy steps t0 .. t0 + n - 1 into buffer buf as one group of this
  // thread's asynchronous copies; rows n .. kC - 1 are set to zero
  auto stage = [&](int64_t t0, int n, int buf) {
    float* xd = xs + buf * kC * SX;
    float* bd = bs + buf * kC * SN;
    float* cd = cs + buf * kC * SN;
    float* dd = dts + buf * kC;
    if (a.vec) {
      for (int e = tid; e < n * (HD / 4); e += kThreads) {
        const int t = e / (HD / 4), col = 4 * (e % (HD / 4));
        __pipeline_memcpy_async(xd + t * SX + col,
                                x + (t0 + t) * a.x_st + col, 16);
      }
      for (int e = tid; e < n * (N / 4); e += kThreads) {
        const int t = e / (N / 4), col = 4 * (e % (N / 4));
        __pipeline_memcpy_async(bd + t * SN + col,
                                bm + (t0 + t) * a.b_st + col, 16);
        __pipeline_memcpy_async(cd + t * SN + col,
                                cm + (t0 + t) * a.c_st + col, 16);
      }
    } else {
      for (int e = tid; e < n * HD; e += kThreads) {
        const int t = e / HD, col = e % HD;
        copy_async(xd + t * SX + col, x + (t0 + t) * a.x_st + col);
      }
      for (int e = tid; e < n * N; e += kThreads) {
        const int t = e / N, col = e % N;
        copy_async(bd + t * SN + col, bm + (t0 + t) * a.b_st + col);
        copy_async(cd + t * SN + col, cm + (t0 + t) * a.c_st + col);
      }
    }
    for (int e = tid; e < n; e += kThreads) {
      copy_async(dd + e, dt + (t0 + e) * a.dt_st);
    }
    for (int e = n * HD + tid; e < kC * HD; e += kThreads) {
      xd[(e / HD) * SX + e % HD] = 0.f;
    }
    for (int e = n * N + tid; e < kC * N; e += kThreads) {
      bd[(e / N) * SN + e % N] = 0.f;
      cd[(e / N) * SN + e % N] = 0.f;
    }
    for (int e = n + tid; e < kC; e += kThreads) dd[e] = 0.f;
    __pipeline_commit();
  };

  // S^T, rows p0 and p0 + 8, columns n = 8 nn + 2 q and + 1
  float sacc[kSN][4];
  const float* s0 = a.s0 + bh * N * HD;
#pragma unroll
  for (int nn = 0; nn < kSN; ++nn) {
    const int n = 8 * nn + 2 * q;
    sacc[nn][0] = s0[n * HD + p0];
    sacc[nn][1] = s0[(n + 1) * HD + p0];
    sacc[nn][2] = s0[n * HD + p0 + 8];
    sacc[nn][3] = s0[(n + 1) * HD + p0 + 8];
  }

  const int64_t chunks = (a.s + kC - 1) / kC;
  auto rows_at = [&](int64_t ci) {
    return static_cast<int>(a.s - ci * kC < kC ? a.s - ci * kC : kC);
  };
  const int64_t y_st = a.h * HD;
  stage(0, rows_at(0), 0);
  for (int64_t ci = 0; ci < chunks; ++ci) {
    const int buf = static_cast<int>(ci & 1);
    const int n = rows_at(ci);
    __pipeline_wait_prior(0);               // this chunk's copies are in
    // (1) every thread's copies are visible, and every read of the other
    // buffer, of M and of the per-step arrays by the last chunk is done
    __syncthreads();
    // this chunk's G into M's place (its own group of copies), then the
    // next chunk's staging (an empty group after the last chunk)
    const float* gsrc = a.gram + (bi * chunks + ci) * (kTriBlocks * 64);
    for (int e = tid; e < kTriBlocks * 16; e += kThreads) {
      __pipeline_memcpy_async(ms + 4 * e, gsrc + 4 * e, 16);
    }
    __pipeline_commit();
    if (ci + 1 < chunks) {
      stage((ci + 1) * kC, rows_at(ci + 1), buf ^ 1);
    } else {
      __pipeline_commit();
    }
    const float* xb = xs + buf * kC * SX;
    const float* bb = bs + buf * kC * SN;
    const float* cb = cs + buf * kC * SN;
    const float* db = dts + buf * kC;

    // warp 0: the chunk's cumulative decay, two steps a lane (steps past
    // S have dt = 0 and add nothing)
    if (warp == 0) {
      const float d0 = db[2 * lane] * a_h;
      const float pair = d0 + db[2 * lane + 1] * a_h;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + d0;
      // cum at the chunk's last step (row n - 1) as cum holds it: the
      // scan's total may round differently past it, and w_t = e^{last -
      // cum_t} dt_t must see the same value
      const float last = __shfl_sync(0xffffffffu, (n - 1) & 1 ? incl : c0,
                                     (n - 1) >> 1);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = incl;
      et[2 * lane] = expf(c0);
      et[2 * lane + 1] = expf(incl);
      wt[2 * lane] = expf(last - c0) * db[2 * lane];
      wt[2 * lane + 1] = expf(last - incl) * db[2 * lane + 1];
      if (lane == 0) *elast = expf(last);
    }

    // y^T = S^T C^T: A is S^T from its accumulator (k step kk reads
    // columns n = 8 kk + 2 q for k = q and n + 1 for k = q + 4), B the
    // staged c rows, the same n pair as one float2
    float yacc[kTN][4];
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt) {
      yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSN; ++kk) {
      FragA fa;
      frag_a(fa, sacc[kk][0], sacc[kk][2], sacc[kk][1], sacc[kk][3]);
#pragma unroll
      for (int nt = 0; nt < kTN; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(
            cb + (8 * nt + g) * SN + 8 * kk + 2 * q);
        FragB fb;
        frag_b(fb, v.x, v.y);
        mma3(yacc[nt], fa, fb);
      }
    }
    __pipeline_wait_prior(1);               // this chunk's G is in
    __syncthreads();                        // (2) G, cum, et, wt, elast

    // M = G o e^{cum_t - cum_j} dt_j (j <= t), in place, block by block of
    // its lower triangle
    for (int blk = warp; blk < kTriBlocks; blk += kWarps) {
      int bt = 0;
      while ((bt + 1) * (bt + 2) / 2 <= blk) ++bt;
      const int bj = blk - bt * (bt + 1) / 2;
      const int t = 8 * bt + g;
      const int j = 8 * bj + 2 * q;
      float2* mp = reinterpret_cast<float2*>(ms + tri(bt, bj, g, 2 * q));
      const float2 gv = *mp;
      const float m0 = j <= t ? gv.x * expf(cum[t] - cum[j]) * db[j] : 0.f;
      const float m1 =
          j + 1 <= t ? gv.y * expf(cum[t] - cum[j + 1]) * db[j + 1] : 0.f;
      *mp = make_float2(m0, m1);
    }
    __syncthreads();                        // (3) M

    // y^T = e^{cum_t} (S^T C^T) + X^T M^T, and S^T' = e^{cum_last} S^T +
    // (w o X)^T B: both read the same X^T fragment of k step ks, whose k
    // = q and q + 4 are the steps t = 8 ks + 2 q and t + 1
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt) {
      const float e0 = et[8 * nt + 2 * q], e1 = et[8 * nt + 2 * q + 1];
      yacc[nt][0] *= e0;
      yacc[nt][1] *= e1;
      yacc[nt][2] *= e0;
      yacc[nt][3] *= e1;
    }
    const float el = *elast;
#pragma unroll
    for (int nn = 0; nn < kSN; ++nn) {
      sacc[nn][0] *= el;
      sacc[nn][1] *= el;
      sacc[nn][2] *= el;
      sacc[nn][3] *= el;
    }
#pragma unroll
    for (int ks = 0; ks < kTN; ++ks) {
      const int t = 8 * ks + 2 * q;
      const float x0 = xb[t * SX + p0];
      const float x1 = xb[t * SX + p0 + 8];
      const float x2 = xb[(t + 1) * SX + p0];
      const float x3 = xb[(t + 1) * SX + p0 + 8];
      FragA fx;
      frag_a(fx, x0, x1, x2, x3);
#pragma unroll
      for (int nt = ks; nt < kTN; ++nt) {
        const float2 m = *reinterpret_cast<const float2*>(
            ms + tri(nt, ks, g, 2 * q));
        FragB fm;
        frag_b(fm, m.x, m.y);
        mma3(yacc[nt], fx, fm);
      }
      const float w0 = wt[t], w1 = wt[t + 1];
      FragA fw;
      frag_a(fw, x0 * w0, x1 * w0, x2 * w1, x3 * w1);
#pragma unroll
      for (int nn = 0; nn < kSN; ++nn) {
        FragB fb;
        frag_b(fb, bb[t * SN + 8 * nn + g], bb[(t + 1) * SN + 8 * nn + g]);
        // each k step's part of the update from zero, then added to the
        // state in float32 with round to nearest: the tensor cores' own
        // float32 accumulation does not round to nearest, and carried
        // through the state over 32 chunks it drifted to 1e-5 of a
        // float64 recurrence at S = 2048, dt ~ 1e-6
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(part, fw, fb);
        sacc[nn][0] += part[0];
        sacc[nn][1] += part[1];
        sacc[nn][2] += part[2];
        sacc[nn][3] += part[3];
      }
    }

    // y = y^T + d x, rows t < n of the chunk
    float* y = a.y + (bi * a.s + ci * kC) * y_st + head * HD;
#pragma unroll
    for (int nt = 0; nt < kTN; ++nt) {
      const int t = 8 * nt + 2 * q;
      if (t < n) {
        y[t * y_st + p0] = fmaf(d_h, xb[t * SX + p0], yacc[nt][0]);
        y[t * y_st + p0 + 8] = fmaf(d_h, xb[t * SX + p0 + 8], yacc[nt][2]);
      }
      if (t + 1 < n) {
        y[(t + 1) * y_st + p0] =
            fmaf(d_h, xb[(t + 1) * SX + p0], yacc[nt][1]);
        y[(t + 1) * y_st + p0 + 8] =
            fmaf(d_h, xb[(t + 1) * SX + p0 + 8], yacc[nt][3]);
      }
    }
  }

  float* so = a.s_out + bh * N * HD;
#pragma unroll
  for (int nn = 0; nn < kSN; ++nn) {
    const int n = 8 * nn + 2 * q;
    so[n * HD + p0] = sacc[nn][0];
    so[(n + 1) * HD + p0] = sacc[nn][1];
    so[n * HD + p0 + 8] = sacc[nn][2];
    so[(n + 1) * HD + p0 + 8] = sacc[nn][3];
  }
}

template <int N>
cudaError_t launch_gram(const Args& a, int64_t bb, cudaStream_t stream) {
  constexpr int smem = 2 * kC * (N + kPad) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_gram_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t chunks = (a.s + kC - 1) / kC;
  ssd_gram_kernel<N><<<static_cast<unsigned>(bb * chunks), 128, smem,
                       stream>>>(a, chunks);
  return cudaGetLastError();
}

template <int N, int HD>
cudaError_t launch_tc(const Args& a, int64_t bh, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<N, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_kernel<N, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory, so that two blocks of the
  // prefill shape fit on an SM
  err = cudaFuncSetAttribute(ssd_tc_kernel<N, HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ssd_tc_kernel<N, HD><<<static_cast<unsigned>(bh), 2 * HD, smem,
                         stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_tc_hd(const Args& a, int64_t bh, int64_t hd,
                         cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_tc<N, 16>(a, bh, stream);
    case 32: return launch_tc<N, 32>(a, bh, stream);
    case 64: return launch_tc<N, 64>(a, bh, stream);
    case 128: return launch_tc<N, 128>(a, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Entry points.  hd and n each one of 16, 32, 64, 128; s_out may be s0
// itself (each thread reads its part of the state before it writes it).
// rt_ssd_fwd (the rec kernel) takes any s >= 0 (s = 0 copies s0 to
// s_out); rt_ssd_tc (ssd_gram_kernel, then the tc kernel) any s >= 1,
// with gram a float32 scratch of bb * ceil(s / 64) * 2304 elements,
// 16-byte aligned.
namespace {

template <int N>
cudaError_t launch_n(bool tc, const Args& a, int64_t bb, int64_t h,
                     int64_t hd, cudaStream_t stream) {
  if (!tc) return launch_hd<N>(a, bb * h, hd, stream);
  const cudaError_t err = launch_gram<N>(a, bb, stream);
  if (err != cudaSuccess) return err;
  return launch_tc_hd<N>(a, bb * h, hd, stream);
}

int ssd_entry(bool tc, const void* x, const void* b, const void* c,
              const void* dt, const void* a, const void* d, const void* s0,
              void* y, void* s_out, int64_t bb, int64_t s, int64_t h,
              int64_t hd, int64_t n, int64_t x_sb, int64_t x_st,
              int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st,
              int64_t dt_sb, int64_t dt_st, void* gram, void* stream) {
  if (bb < 0 || s < (tc ? 1 : 0) || h < 0 || bb * h > 0x7fffffffLL ||
      (tc && (bb * ((s + kC - 1) / kC) > 0x7fffffffLL ||
              reinterpret_cast<uintptr_t>(gram) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bb == 0 || h == 0) return static_cast<int>(cudaSuccess);
  Args args;
  args.x = static_cast<const float*>(x);
  args.b = static_cast<const float*>(b);
  args.c = static_cast<const float*>(c);
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.d = static_cast<const float*>(d);
  args.s0 = static_cast<const float*>(s0);
  args.y = static_cast<float*>(y);
  args.s_out = static_cast<float*>(s_out);
  args.s = s;
  args.h = h;
  args.x_sb = x_sb;
  args.x_st = x_st;
  args.b_sb = b_sb;
  args.b_st = b_st;
  args.c_sb = c_sb;
  args.c_st = c_st;
  args.dt_sb = dt_sb;
  args.dt_st = dt_st;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  args.vec = ptrs % 16 == 0 &&
             (x_sb | x_st | b_sb | b_st | c_sb | c_st) % 4 == 0;
  args.gram = static_cast<float*>(gram);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 16: err = launch_n<16>(tc, args, bb, h, hd, st); break;
    case 32: err = launch_n<32>(tc, args, bb, h, hd, st); break;
    case 64: err = launch_n<64>(tc, args, bb, h, hd, st); break;
    case 128: err = launch_n<128>(tc, args, bb, h, hd, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int rt_ssd_fwd(const void* x, const void* b, const void* c,
                          const void* dt, const void* a, const void* d,
                          const void* s0, void* y, void* s_out, int64_t bb,
                          int64_t s, int64_t h, int64_t hd, int64_t n,
                          int64_t x_sb, int64_t x_st, int64_t b_sb,
                          int64_t b_st, int64_t c_sb, int64_t c_st,
                          int64_t dt_sb, int64_t dt_st, void* stream) {
  return ssd_entry(false, x, b, c, dt, a, d, s0, y, s_out, bb, s, h, hd, n,
                   x_sb, x_st, b_sb, b_st, c_sb, c_st, dt_sb, dt_st,
                   nullptr, stream);
}

extern "C" int rt_ssd_tc(const void* x, const void* b, const void* c,
                         const void* dt, const void* a, const void* d,
                         const void* s0, void* y, void* s_out, int64_t bb,
                         int64_t s, int64_t h, int64_t hd, int64_t n,
                         int64_t x_sb, int64_t x_st, int64_t b_sb,
                         int64_t b_st, int64_t c_sb, int64_t c_st,
                         int64_t dt_sb, int64_t dt_st, void* gram,
                         void* stream) {
  return ssd_entry(true, x, b, c, dt, a, d, s0, y, s_out, bb, s, h, hd, n,
                   x_sb, x_st, b_sb, b_st, c_sb, c_st, dt_sb, dt_st, gram,
                   stream);
}
