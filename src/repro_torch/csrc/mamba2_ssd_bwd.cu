// Mamba2 SSD (state-space dual) scan, backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its chunked
// form in jnp (repro/models/ssm.py:82-156) with XLA, and its Pallas
// forward ssd_pallas (repro/kernels/mamba2_ssd/kernel.py:72) has no
// backward.  This is the gradient of the forward kernels of
// mamba2_ssd.cu, so that the port trains Mamba2 (zamba2) on the card.
// Inputs, all float32: x (B, S, H, hd); b and c (B, S, N), one group
// shared by every head; dt (B, S, H); a and d (H,); s0 (B, H, N, hd); dy
// (B, S, H, hd) and ds (B, H, N, hd), the gradients of y and of the final
// state.  x, b, c and dt are read through their batch and time strides
// (the model's views of its conv output), each (b, t) row contiguous.
// With G the gradient of the state after step t (ds after the last),
// alpha_t = e^{dt_t a}, S_{t-1} the state before step t and S_t after it,
// backwards over t:
//
//   G        += c_t dy_t^T
//   dc_t[n]  += sum_p S_t[n][p] dy_t[p]                 (summed over heads)
//   db_t[n]  += dt_t sum_p G[n][p] x_t[p]               (summed over heads)
//   dx_t[p]   = d dy_t[p] + dt_t sum_n G[n][p] b_t[n]
//   ddt_t     = sum_n b_t[n] sum_p G[n][p] x_t[p] + a alpha_t <S_{t-1}, G>
//   da       += dt_t alpha_t <S_{t-1}, G>,  dd += x_t . dy_t
//   G         = alpha_t G                                (then ds0 = G)
//
// the reverse of S_t = alpha_t S_{t-1} + b_t (dt_t x_t)^T and
// y_t = c_t . S_t + d x_t.  ops.ssd_bwd_plain repeats it in torch ops.
//
// Recomputing the states.  alpha_t underflows to 0 for large dt, so the
// recurrence cannot be run backwards: as in rwkv6_wkv_bwd.cu a forward
// sweep from s0 writes the state before every kChunk = 16 steps to a
// scratch the wrapper allocates (marks), and each chunk of 16 steps, from
// the last, recomputes its states from its mark into a second scratch
// (hist) and walks them backwards; S_t is formed again from S_{t-1} in the
// step.  Each thread reads back only the elements it wrote.
//
// Layout.  One block per (b, h), 8 N threads: row n of S and G is owned
// by eight neighbouring lanes, lane g the columns p = g + 8 m, with G in
// registers for the whole sequence.  dc, db (before dt) and the row's part
// of <S_{t-1}, G> are sums along a row: three xor shuffles.  sum_n G b is
// a sum down the columns: two xor shuffles over the warp's four rows, then
// each warp's part through shared memory, summed by hd threads after the
// step's barrier (two buffers by the parity of t) into dx.  ddt and da's
// part of a step are sums over n of the rows' values, formed after the
// chunk, a warp a step.  Sums across blocks go through per-block parts and
// a second kernel, ssd_bwd_sum_kernel: db and dc over the H heads of
// their (b, t) (each block writes its head's part, (B, S, H, N)), da and
// dd over b.  No float atomics: every sum has a fixed order, and two calls
// give equal bits.
//
// What bounds it on this card.  At zamba2-7b's training shape (B, S, H,
// hd, N) = (4, 4096, 112, 64, 64) it reads x and dy and writes dx, 470 MB
// each, plus b, c, dt, db, dc, ddt (under 10 MB each): about 1.45 GB,
// 0.43 ms at 3.35 TB/s.  Each step needs about 7 multiply-adds per state
// element (S_t, dc, db, sum G b, <S, G>, G += c dy, G *= alpha) and the
// two forward sweeps one each, about 18 operations per element and step:
// 1.4e11, 2.0 ms at the 67 TFLOP/s of scalar float32, so the operations
// bound it.  The heads' parts of db and dc (470 MB each, written and read
// once more) and the scratch are this simple design's own traffic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;     // lanes that own one state row
constexpr int kChunk = 16;    // steps between marks (ops.BWD_CHUNK)

struct Args {
  const float* x;
  const float* b;
  const float* c;
  const float* dt;
  const float* a;
  const float* d;
  const float* s0;
  const float* dy;
  const float* ds;
  float* dx;
  float* ddt;
  float* ds0;
  float* db_part;   // (B, S, H, N): each head's part of db
  float* dc_part;   // (B, S, H, N): of dc
  float* scal_part; // (2, B, H): each (b, h)'s part of da, then of dd
  float* marks;     // (B H, chunks, N hd): the state before each chunk
  float* hist;      // (B H, kChunk, N hd): the states of one chunk
  int64_t bb;       // batch
  int64_t s;        // steps
  int64_t h;        // heads
  int64_t x_sb, x_st;
  int64_t b_sb, b_st;
  int64_t c_sb, c_st;
  int64_t dt_sb, dt_st;
};

template <int N, int HD>
struct Shape {
  static constexpr int kThreads = N * kLanes;
  static constexpr int kCols = HD / kLanes;     // state columns a thread
  static constexpr int kWarps = kThreads / 32;
  // staged x, dy, b, c, dt; alpha and x.dy a step; gathered dx, dc, q
  // (sum_p G x), sg (the row's <S, G>); the warps' parts of sum_n G b in
  // two buffers; ddt and da's part a step
  static constexpr int kSmemFloats = 3 * kChunk * HD + 5 * kChunk * N +
                                     2 * kWarps * HD + 5 * kChunk;
};

template <int N, int HD>
__global__ void __launch_bounds__(N * kLanes, 1024 / (N * kLanes))
    ssd_bwd_kernel(Args a) {
  using Sh = Shape<N, HD>;
  constexpr int kCols = Sh::kCols;
  constexpr int kWarps = Sh::kWarps;
  constexpr int kThreads = Sh::kThreads;
  extern __shared__ float smem[];
  float* x_s = smem;                            // [kChunk][HD]
  float* dy_s = x_s + kChunk * HD;
  float* dx_s = dy_s + kChunk * HD;
  float* b_s = dx_s + kChunk * HD;              // [kChunk][N]
  float* c_s = b_s + kChunk * N;
  float* dc_s = c_s + kChunk * N;
  float* q_s = dc_s + kChunk * N;
  float* sg_s = q_s + kChunk * N;
  float* part_s = sg_s + kChunk * N;            // [2][kWarps][HD]
  float* dt_s = part_s + 2 * kWarps * HD;       // [kChunk]
  float* alpha_s = dt_s + kChunk;
  float* xdy_s = alpha_s + kChunk;
  float* ddt_s = xdy_s + kChunk;
  float* da_s = ddt_s + kChunk;

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_row = tid / kLanes;               // this thread's state row
  const int g = tid % kLanes;                   // columns g + kLanes m
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h;
  const int64_t head = bh % a.h;
  const float a_h = a.a[head];
  const float d_h = a.d[head];
  const float* x = a.x + bi * a.x_sb + head * HD;
  const float* bm = a.b + bi * a.b_sb;
  const float* cm = a.c + bi * a.c_sb;
  const float* dt = a.dt + bi * a.dt_sb + head;
  const int64_t out0 = bi * a.s * a.h + head;   // row (b, 0, h) of dx, ddt
  const int64_t chunks = (a.s + kChunk - 1) / kChunk;
  const int64_t sq = bh * N * HD + static_cast<int64_t>(n_row) * HD + g;
  float* marks = a.marks + bh * chunks * kCols * kThreads + tid;
  float* hist = a.hist + bh * kChunk * kCols * kThreads + tid;

  auto steps_at = [&](int64_t c) {
    const int64_t left = a.s - c * kChunk;
    return static_cast<int>(left < kChunk ? left : kChunk);
  };
  // stage steps t0 .. t0 + n - 1 of x, b and dt (and, for the reverse
  // sweep, c and dy), and alpha of each step
  auto stage = [&](int64_t t0, int n, bool reverse) {
    for (int e = tid; e < n * HD; e += kThreads) {
      const int64_t t = t0 + e / HD;
      x_s[e] = x[t * a.x_st + e % HD];
      if (reverse) dy_s[e] = a.dy[(out0 + t * a.h) * HD + e % HD];
    }
    for (int e = tid; e < n * N; e += kThreads) {
      const int64_t t = t0 + e / N;
      b_s[e] = bm[t * a.b_st + e % N];
      if (reverse) c_s[e] = cm[t * a.c_st + e % N];
    }
    for (int e = tid; e < n; e += kThreads) {
      const float dtv = dt[(t0 + e) * a.dt_st];
      dt_s[e] = dtv;
      alpha_s[e] = expf(dtv * a_h);
    }
  };
  // S <- alpha S + b_n (dt x_p), the forward's recurrence
  auto advance = [&](float* st, int tt) {
    const float alpha = alpha_s[tt];
    const float bn = b_s[tt * N + n_row];
    const float dtv = dt_s[tt];
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      st[m] = fmaf(alpha, st[m], bn * (dtv * x_s[tt * HD + g + kLanes * m]));
    }
  };

  // the forward sweep: the state before each chunk into marks
  float st[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) st[m] = a.s0[sq + kLanes * m];
  for (int64_t c = 0; c < chunks; ++c) {
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      marks[(c * kCols + m) * kThreads] = st[m];
    }
    if (c == chunks - 1) break;           // the last chunk's steps: not needed
    const int n = steps_at(c);
    __syncthreads();
    stage(c * kChunk, n, false);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) advance(st, tt);
  }

  // the reverse sweep, a chunk at a time from the last
  float gr[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) gr[m] = a.ds[sq + kLanes * m];
  float da_acc = 0.f, dd_acc = 0.f;       // thread 0's
  for (int64_t c = chunks - 1; c >= 0; --c) {
    const int n = steps_at(c);
    const int64_t t0 = c * kChunk;
    __syncthreads();        // the last chunk's write-out is done
    stage(t0, n, true);
    __syncthreads();
    // per step: x . dy, a warp a step
    for (int tt = warp; tt < n; tt += kWarps) {
      float p = 0.f;
      for (int e = lane; e < HD; e += 32) {
        p = fmaf(x_s[tt * HD + e], dy_s[tt * HD + e], p);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (lane == 0) xdy_s[tt] = p;
    }
    // the chunk's states S_{t-1}, recomputed from its mark into hist
#pragma unroll
    for (int m = 0; m < kCols; ++m) st[m] = marks[(c * kCols + m) * kThreads];
    for (int tt = 0; tt < n; ++tt) {
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        hist[(tt * kCols + m) * kThreads] = st[m];
      }
      advance(st, tt);
    }
    for (int tt = n - 1; tt >= 0; --tt) {
      float* part = part_s + (tt & 1) * kWarps * HD;
      const float alpha = alpha_s[tt];
      const float dtv = dt_s[tt];
      const float bn = b_s[tt * N + n_row];
      const float cn = c_s[tt * N + n_row];
      float pdc = 0.f, pq = 0.f, psg = 0.f;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int p = g + kLanes * m;
        const float xp = x_s[tt * HD + p];
        const float dyp = dy_s[tt * HD + p];
        const float sp = hist[(tt * kCols + m) * kThreads];
        const float sn = fmaf(alpha, sp, bn * (dtv * xp));     // S_t
        gr[m] = fmaf(cn, dyp, gr[m]);
        pdc = fmaf(sn, dyp, pdc);
        pq = fmaf(gr[m], xp, pq);
        psg = fmaf(sp, gr[m], psg);
        float gb = gr[m] * bn;              // down the warp's four rows
        gb += __shfl_xor_sync(0xffffffffu, gb, 8);
        gb += __shfl_xor_sync(0xffffffffu, gb, 16);
        if (lane < kLanes) part[warp * HD + p] = gb;
        gr[m] *= alpha;
      }
#pragma unroll
      for (int off = 1; off < kLanes; off *= 2) {
        pdc += __shfl_xor_sync(0xffffffffu, pdc, off);
        pq += __shfl_xor_sync(0xffffffffu, pq, off);
        psg += __shfl_xor_sync(0xffffffffu, psg, off);
      }
      if (g == 0) {
        dc_s[tt * N + n_row] = pdc;
        q_s[tt * N + n_row] = pq;
        sg_s[tt * N + n_row] = psg;
      }
      __syncthreads();      // every warp's part of step tt is in
      for (int p = tid; p < HD; p += kThreads) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += part[w * HD + p];
        dx_s[tt * HD + p] = fmaf(dtv, sum, d_h * dy_s[tt * HD + p]);
      }
    }
    __syncthreads();        // q_s and sg_s of every step are in
    // per step: ddt and da's part, sums over the rows, a warp a step
    for (int tt = warp; tt < n; tt += kWarps) {
      float pbq = 0.f, psg = 0.f;
      for (int e = lane; e < N; e += 32) {
        pbq = fmaf(b_s[tt * N + e], q_s[tt * N + e], pbq);
        psg += sg_s[tt * N + e];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        pbq += __shfl_xor_sync(0xffffffffu, pbq, off);
        psg += __shfl_xor_sync(0xffffffffu, psg, off);
      }
      if (lane == 0) {
        const float asg = alpha_s[tt] * psg;
        ddt_s[tt] = fmaf(a_h, asg, pbq);
        da_s[tt] = dt_s[tt] * asg;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int tt = n - 1; tt >= 0; --tt) {
        da_acc += da_s[tt];
        dd_acc += xdy_s[tt];
      }
    }
    for (int e = tid; e < n * HD; e += kThreads) {
      a.dx[(out0 + (t0 + e / HD) * a.h) * HD + e % HD] = dx_s[e];
    }
    for (int e = tid; e < n * N; e += kThreads) {
      const int tt = e / N;
      const int64_t o = (out0 + (t0 + tt) * a.h) * N + e % N;
      a.db_part[o] = dt_s[tt] * q_s[e];
      a.dc_part[o] = dc_s[e];
    }
    for (int tt = tid; tt < n; tt += kThreads) {
      a.ddt[out0 + (t0 + tt) * a.h] = ddt_s[tt];
    }
  }
#pragma unroll
  for (int m = 0; m < kCols; ++m) a.ds0[sq + kLanes * m] = gr[m];
  if (tid == 0) {
    a.scal_part[bh] = da_acc;
    a.scal_part[a.bb * a.h + bh] = dd_acc;
  }
}

// e < B S N: db and dc of row (b, t) = e / N, n = e % N, summed over the
// H heads in order; then e = B S N + h: da and dd of head h, summed over b
__global__ void __launch_bounds__(256)
    ssd_bwd_sum_kernel(const float* db_part, const float* dc_part,
                       const float* scal_part, float* db, float* dc,
                       float* da, float* dd, int64_t bb, int64_t s,
                       int64_t h, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t rows = bb * s * n;
  if (e < rows) {
    const int64_t base = (e / n) * h * n + e % n;
    float sb = 0.f, sc = 0.f;
    for (int64_t hh = 0; hh < h; ++hh) {
      sb += db_part[base + hh * n];
      sc += dc_part[base + hh * n];
    }
    db[e] = sb;
    dc[e] = sc;
  } else if (e < rows + h) {
    const int64_t hh = e - rows;
    float sa = 0.f, sd = 0.f;
    for (int64_t bi = 0; bi < bb; ++bi) {
      sa += scal_part[bi * h + hh];
      sd += scal_part[(bb + bi) * h + hh];
    }
    da[hh] = sa;
    dd[hh] = sd;
  }
}

template <int N, int HD>
cudaError_t launch_bwd(const Args& a, int64_t bh, cudaStream_t stream) {
  constexpr int smem = Shape<N, HD>::kSmemFloats * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<N, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<N, HD><<<static_cast<unsigned>(bh), Shape<N, HD>::kThreads,
                          smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_hd(const Args& a, int64_t bh, int64_t hd,
                      cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bwd<N, 16>(a, bh, stream);
    case 32: return launch_bwd<N, 32>(a, bh, stream);
    case 64: return launch_bwd<N, 64>(a, bh, stream);
    case 128: return launch_bwd<N, 128>(a, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// hd and n each one of 16, 32, 64, 128; s >= 0 (s = 0: ds0 = ds, the
// parts of da and dd 0); marks holds B H max(1, ceil(s / 16)) n hd floats,
// hist B H 16 n hd
extern "C" int rt_ssd_bwd(const void* x, const void* b, const void* c,
                          const void* dt, const void* a, const void* d,
                          const void* s0, const void* dy, const void* ds,
                          void* dx, void* ddt, void* ds0, void* db_part,
                          void* dc_part, void* scal_part, void* marks,
                          void* hist, int64_t bb, int64_t s, int64_t h,
                          int64_t hd, int64_t n, int64_t x_sb, int64_t x_st,
                          int64_t b_sb, int64_t b_st, int64_t c_sb,
                          int64_t c_st, int64_t dt_sb, int64_t dt_st,
                          void* stream) {
  if (bb < 1 || s < 0 || h < 1 || bb * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args;
  args.x = static_cast<const float*>(x);
  args.b = static_cast<const float*>(b);
  args.c = static_cast<const float*>(c);
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.d = static_cast<const float*>(d);
  args.s0 = static_cast<const float*>(s0);
  args.dy = static_cast<const float*>(dy);
  args.ds = static_cast<const float*>(ds);
  args.dx = static_cast<float*>(dx);
  args.ddt = static_cast<float*>(ddt);
  args.ds0 = static_cast<float*>(ds0);
  args.db_part = static_cast<float*>(db_part);
  args.dc_part = static_cast<float*>(dc_part);
  args.scal_part = static_cast<float*>(scal_part);
  args.marks = static_cast<float*>(marks);
  args.hist = static_cast<float*>(hist);
  args.bb = bb;
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
  cudaError_t err;
  switch (n) {
    case 16: err = launch_hd<16>(args, bb * h, hd, st); break;
    case 32: err = launch_hd<32>(args, bb * h, hd, st); break;
    case 64: err = launch_hd<64>(args, bb * h, hd, st); break;
    case 128: err = launch_hd<128>(args, bb * h, hd, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// db, dc (B, S, N) = the sums over heads of db_part, dc_part (B, S, H, N);
// da, dd (H,) = the sums over b of scal_part (2, B, H)
extern "C" int rt_ssd_bwd_sum(const void* db_part, const void* dc_part,
                              const void* scal_part, void* db, void* dc,
                              void* da, void* dd, int64_t bb, int64_t s,
                              int64_t h, int64_t n, void* stream) {
  if (bb < 0 || s < 0 || h < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = bb * s * n + h;
  if ((total + 255) / 256 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  ssd_bwd_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(db_part), static_cast<const float*>(dc_part),
      static_cast<const float*>(scal_part), static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(da),
      static_cast<float*>(dd), bb, s, h, n);
  return static_cast<int>(cudaGetLastError());
}
