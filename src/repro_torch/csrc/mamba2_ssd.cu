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
// d x_t, in float32 multiply-adds.
//
// Which form, and why.  The TPU kernel closes each chunk of C steps into
// matrix products (c b^T masked by e^{cum_t - cum_j}, then times x) so
// that its matrix unit does the work, and carries the state across a
// sequential grid axis in VMEM.  Here no grid axis is sequential, so one
// block walks all S steps of its (b, h) with the state in registers, and
// the form is the per-step recurrence: it needs one exp per step and
// head, no exp of differences of cumulative sums, no chunk length that
// must divide S, and takes any S >= 0 (S = 0 copies s0 to the output
// state) and dt = 0 exactly.  A decode step is S = 1.
//
// What bounds it on this card.  At the zamba2-7b prefill shape (B, S, H,
// hd, N) = (4, 2048, 112, 64, 64) it reads x and writes y, 235 MB each,
// and reads b, c (4 MB each), dt (3.7 MB), s0 (7.3 MB) and writes the
// state (7.3 MB): about 492 MB, 0.147 ms at 3.35 TB/s.  The operations,
// a multiply-add counted as two, are 5 N hd + 3 hd per (b, t, h): per
// state element a multiply and a multiply-add for the update and a
// multiply-add for y, per column dt x and d x added to the sum.  That is
// 1.90e10, 0.283 ms at the 67 TFLOP/s of scalar float32, so the
// operations bound it.  A decode step (S = 1) is the two state
// tensors, about 15 MB: 4.5 us.
//
// Layout of the work.  One block per (b, h): 448 blocks at B 4, H 112,
// all resident at once (128 threads each at hd 64).  Each thread holds two
// state columns p, p + 1 and the rows n = g, g + 4, g + 8, ... of them
// (g = lane % 4) in registers, N / 2 values, so each b and c value it
// reads from shared memory serves two columns; the four partial sums of
// y_t[p] meet by two warp shuffles.  The block stages chunks of steps in
// shared memory: x, b, c and dt copied in place from their strided layouts
// (row t of head h of x at b * x_sb + t * x_st + h * hd; b and c are read
// by every head of a sequence, and so mostly from L2) with asynchronous
// copies into two buffers, so that the next chunk's loads fly while this
// chunk's steps run.  b and c are staged so that a lane reads its rows as
// float4s without bank conflicts, and e^{dt a} once per step for the
// block.  y is gathered in shared memory and written out row by row after
// the chunk.
//
// What the first designs taught (chip_smoke.py phase 11 on the H100,
// PERF.md): eight lanes per column with scalar shared loads and every
// thread taking its own exp ran 1.89 ms at the prefill shape; four lanes
// with float4 loads and one exp per step 1.45 ms; two columns per thread
// alone did not help (1.51 ms); the staging loads were the wait (each
// thread's loads of a chunk issued one loop turn after another, none
// overlapped with the steps), and asynchronous double-buffered copies took
// it to about 1.0 ms.
//
// Left for later: the chunked form on the tensor cores.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

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

}  // namespace

// hd and n each one of 16, 32, 64, 128; s >= 0 (s = 0 copies s0 to s_out);
// s_out may be s0 itself (each thread reads its state before it writes it)
extern "C" int rt_ssd_fwd(const void* x, const void* b, const void* c,
                          const void* dt, const void* a, const void* d,
                          const void* s0, void* y, void* s_out, int64_t bb,
                          int64_t s, int64_t h, int64_t hd, int64_t n,
                          int64_t x_sb, int64_t x_st, int64_t b_sb,
                          int64_t b_st, int64_t c_sb, int64_t c_st,
                          int64_t dt_sb, int64_t dt_st, void* stream) {
  if (bb < 0 || s < 0 || h < 0 || bb * h > 0x7fffffffLL) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = bb * h;
  cudaError_t err;
  switch (n) {
    case 16: err = launch_hd<16>(args, bh, hd, st); break;
    case 32: err = launch_hd<32>(args, bh, hd, st); break;
    case 64: err = launch_hd<64>(args, bh, hd, st); break;
    case 128: err = launch_hd<128>(args, bh, hd, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
