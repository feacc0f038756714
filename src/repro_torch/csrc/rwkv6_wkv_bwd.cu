// RWKV6 WKV recurrence, backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its jnp scan
// (repro/models/rwkv.py:96-113) with XLA, and its Pallas forward
// wkv_pallas (repro/kernels/rwkv6_wkv/kernel.py:79) has no backward.  This
// is the gradient of the forward kernels of rwkv6_wkv.cu, so that the
// port trains RWKV6 on the card.  Inputs r, k, v, w (B, S, H, hd), u
// (H, hd), s0 (B, H, hd, hd), dy (B, S, H, hd) and ds (B, H, hd, hd), the
// gradients of y and of the final state, all float32 and contiguous;
// outputs dr, dk, dv, dw (B, S, H, hd), ds0 (B, H, hd, hd) and du (H, hd).
// With G the gradient of the state after step t (ds after the last),
// S_{t-1} the state before step t and vdy = v_t . dy_t, backwards over t:
//
//   dr_t[i] = u_i k_t[i] vdy + sum_j S_{t-1}[i][j] dy_t[j]
//   dk_t[i] = u_i r_t[i] vdy + sum_j G[i][j] v_t[j]
//   dv_t[j] = (sum_i u_i r_t[i] k_t[i]) dy_t[j] + sum_i G[i][j] k_t[i]
//   dw_t[i] = sum_j G[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] vdy
//   G[i][j] = w_t[i] G[i][j] + r_t[i] dy_t[j]           (then ds0 = G)
//
// the reverse of S_t = diag(w_t) S_{t-1} + k_t v_t^T and
// y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}).  ops.wkv_bwd_plain repeats
// it in torch ops.
//
// Recomputing the states.  The reverse sweep needs S_{t-1} at every t, and
// the recurrence cannot be run backwards (w = 0 exactly is allowed), so
// the states are recomputed: a forward sweep from s0 writes the state
// before every kChunk = 16 steps to a scratch the wrapper allocates
// (marks); then, for each chunk of 16 steps from the last, the block
// recomputes the chunk's 16 states from its mark into a second scratch
// (hist, 16 states per (b, h)) and walks the chunk backwards reading them.
// Saving every state instead would take S hd^2 floats per (b, h): 10.7 GB
// at rwkv6-3b's training shape (4, 4096, 40, 64), against 671 MB of marks
// and 42 MB of hist here.  Each thread reads back only the state elements
// it wrote itself, so hist needs no barrier, and its 256 KB per block
// (hd 64) mostly stay in L2 between the write and the read.  The forward
// may have run the chunked tc kernel (within about 1e-6 of the
// recurrence); the backward recomputes by the plain recurrence in float32
// multiply-adds, as the plain version does.
//
// Layout.  One block per (b, h), 8 hd threads: the rows of S and G are
// independent (row i depends on w_t[i], k_t[i] and r_t[i] alone), so eight
// neighbouring lanes own state row i, lane g the columns j = g + 8 m, and
// hold its G in registers for the whole sequence.  dr, dk and dw are sums
// along a row: three xor shuffles within the eight lanes.  dv is a sum
// down the columns: two xor shuffles over the four rows of a warp, then
// each warp's part through shared memory, summed by hd threads after the
// step's barrier (the parts in two buffers by the parity of t, so one
// barrier a step suffices).  vdy and sum_i u_i r_i k_i are formed once a
// step for the block.  du sums over b and t: each block writes its (b, h)
// part, and wkv_bwd_sum_kernel, launched next, sums the parts over b.  No
// float atomics anywhere: every sum has a fixed order, so two calls give
// equal bits.  The steps of a chunk (r, k, w, v, dy) are staged in shared
// memory, and the chunk's dr, dk, dw and dv gathered there and written out
// row by row.
//
// What bounds it on this card.  At rwkv6-3b's training shape (B, S, H, hd)
// = (4, 4096, 40, 64) it reads r, k, v, w, dy (168 MB each) and writes
// dr, dk, dv, dw (168 MB each), plus the small s0, ds, ds0: about 1.5 GB,
// 0.45 ms at 3.35 TB/s.  The reverse step needs 5 multiply-adds per state
// element (G, dr, dk, dv, dw) and the two forward sweeps one each, 14
// operations per element and step: 3.8e10, 0.56 ms at the 67 TFLOP/s of
// scalar float32, so the operations bound it.  This first design is
// simple and scalar; the scratch traffic (marks written and read once,
// hist twice), the shuffles and a barrier every step keep it from that
// bound (PERF.md has its time).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;     // lanes that own one state row
constexpr int kChunk = 16;    // steps between marks (ops.BWD_CHUNK)

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  const float* dy;
  const float* ds;
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* ds0;
  float* du_part;   // (B, H, hd): each block's part of du
  float* marks;     // (B H, chunks, hd^2): the state before each chunk
  float* hist;      // (B H, kChunk, hd^2): the states of one chunk
  int64_t s;        // steps
  int64_t h;        // heads
};

template <int HD>
struct Shape {
  static constexpr int kThreads = HD * kLanes;
  static constexpr int kCols = HD / kLanes;     // state columns a thread
  static constexpr int kWarps = kThreads / 32;
  // staged r, k, w, v, dy; gathered dr, dk, dw, dv; the warps' dv parts in
  // two buffers; vdy and sum u r k a step; u
  static constexpr int kSmemFloats =
      9 * kChunk * HD + 2 * kWarps * HD + 2 * kChunk + HD;
};

template <int HD>
__global__ void __launch_bounds__(HD * kLanes, 1024 / (HD * kLanes))
    wkv_bwd_kernel(Args a) {
  using Sh = Shape<HD>;
  constexpr int kCols = Sh::kCols;
  constexpr int kWarps = Sh::kWarps;
  constexpr int kThreads = Sh::kThreads;
  constexpr int kRow = kChunk * HD;             // floats of a staged array
  extern __shared__ float smem[];
  float* r_s = smem;
  float* k_s = r_s + kRow;
  float* w_s = k_s + kRow;
  float* v_s = w_s + kRow;
  float* dy_s = v_s + kRow;
  float* dr_s = dy_s + kRow;
  float* dk_s = dr_s + kRow;
  float* dw_s = dk_s + kRow;
  float* dv_s = dw_s + kRow;
  float* part_s = dv_s + kRow;                  // [2][kWarps][HD]
  float* vdy_s = part_s + 2 * kWarps * HD;      // [kChunk]
  float* urk_s = vdy_s + kChunk;                // [kChunk]
  float* u_s = urk_s + kChunk;                  // [HD]

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i = tid / kLanes;                   // this thread's state row
  const int g = tid % kLanes;                   // columns g + kLanes m
  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h;
  const int64_t head = bh % a.h;
  const int64_t row0 = (bi * a.s * a.h + head) * HD;   // (b, 0, h) row
  const int64_t step = a.h * HD;                       // from t to t + 1
  const int64_t chunks = (a.s + kChunk - 1) / kChunk;
  const int64_t sq = bh * HD * HD + static_cast<int64_t>(i) * HD + g;
  float* marks = a.marks + bh * chunks * kCols * kThreads + tid;
  float* hist = a.hist + bh * kChunk * kCols * kThreads + tid;

  for (int e = tid; e < HD; e += kThreads) u_s[e] = a.u[head * HD + e];
  // copy rows t0 .. t0 + n - 1 of the named (B, S, H, hd) inputs in
  auto stage = [&](const float* src, float* dst, int64_t t0, int n) {
    for (int e = tid; e < n * HD; e += kThreads) {
      dst[e] = src[row0 + (t0 + e / HD) * step + e % HD];
    }
  };
  auto steps_at = [&](int64_t c) {
    const int64_t left = a.s - c * kChunk;
    return static_cast<int>(left < kChunk ? left : kChunk);
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
    stage(a.k, k_s, c * kChunk, n);
    stage(a.w, w_s, c * kChunk, n);
    stage(a.v, v_s, c * kChunk, n);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float ki = k_s[tt * HD + i];
      const float wi = w_s[tt * HD + i];
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        st[m] = fmaf(wi, st[m], ki * v_s[tt * HD + g + kLanes * m]);
      }
    }
  }

  // the reverse sweep, a chunk at a time from the last
  float gr[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) gr[m] = a.ds[sq + kLanes * m];
  float du_acc = 0.f;
  for (int64_t c = chunks - 1; c >= 0; --c) {
    const int n = steps_at(c);
    const int64_t t0 = c * kChunk;
    __syncthreads();        // the last chunk's write-out has read dr_s ...
    stage(a.r, r_s, t0, n);
    stage(a.k, k_s, t0, n);
    stage(a.w, w_s, t0, n);
    stage(a.v, v_s, t0, n);
    stage(a.dy, dy_s, t0, n);
    __syncthreads();
    // per step: vdy and sum_i u_i r_i k_i, a warp a step
    for (int tt = warp; tt < n; tt += kWarps) {
      float pv = 0.f, pu = 0.f;
      for (int e = lane; e < HD; e += 32) {
        pv = fmaf(v_s[tt * HD + e], dy_s[tt * HD + e], pv);
        pu = fmaf(u_s[e] * r_s[tt * HD + e], k_s[tt * HD + e], pu);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        pv += __shfl_xor_sync(0xffffffffu, pv, off);
        pu += __shfl_xor_sync(0xffffffffu, pu, off);
      }
      if (lane == 0) {
        vdy_s[tt] = pv;
        urk_s[tt] = pu;
      }
    }
    // the chunk's states S_{t-1}, recomputed from its mark into hist
#pragma unroll
    for (int m = 0; m < kCols; ++m) st[m] = marks[(c * kCols + m) * kThreads];
    for (int tt = 0; tt < n; ++tt) {
      const float ki = k_s[tt * HD + i];
      const float wi = w_s[tt * HD + i];
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        hist[(tt * kCols + m) * kThreads] = st[m];
        st[m] = fmaf(wi, st[m], ki * v_s[tt * HD + g + kLanes * m]);
      }
    }
    __syncthreads();        // vdy_s and urk_s are in
    const float ui = u_s[i];
    for (int tt = n - 1; tt >= 0; --tt) {
      float* part = part_s + (tt & 1) * kWarps * HD;
      const float ri = r_s[tt * HD + i];
      const float ki = k_s[tt * HD + i];
      const float wi = w_s[tt * HD + i];
      const float vdy = vdy_s[tt];
      float pdr = 0.f, pdk = 0.f, pdw = 0.f;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int j = g + kLanes * m;
        const float sp = hist[(tt * kCols + m) * kThreads];
        const float vj = v_s[tt * HD + j];
        const float dyj = dy_s[tt * HD + j];
        pdr = fmaf(sp, dyj, pdr);
        pdk = fmaf(gr[m], vj, pdk);
        pdw = fmaf(gr[m], sp, pdw);
        float dvp = gr[m] * ki;             // down the warp's four rows
        dvp += __shfl_xor_sync(0xffffffffu, dvp, 8);
        dvp += __shfl_xor_sync(0xffffffffu, dvp, 16);
        if (lane < kLanes) part[warp * HD + j] = dvp;
        gr[m] = fmaf(wi, gr[m], ri * dyj);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off *= 2) {
        pdr += __shfl_xor_sync(0xffffffffu, pdr, off);
        pdk += __shfl_xor_sync(0xffffffffu, pdk, off);
        pdw += __shfl_xor_sync(0xffffffffu, pdw, off);
      }
      if (g == 0) {
        dr_s[tt * HD + i] = fmaf(ui * ki, vdy, pdr);
        dk_s[tt * HD + i] = fmaf(ui * ri, vdy, pdk);
        dw_s[tt * HD + i] = pdw;
        du_acc = fmaf(ri * ki, vdy, du_acc);
      }
      __syncthreads();      // every warp's dv part of step tt is in
      for (int j = tid; j < HD; j += kThreads) {
        float sum = urk_s[tt] * dy_s[tt * HD + j];
        for (int p = 0; p < kWarps; ++p) sum += part[p * HD + j];
        dv_s[tt * HD + j] = sum;
      }
    }
    __syncthreads();
    for (int e = tid; e < n * HD; e += kThreads) {
      const int64_t o = row0 + (t0 + e / HD) * step + e % HD;
      a.dr[o] = dr_s[e];
      a.dk[o] = dk_s[e];
      a.dw[o] = dw_s[e];
      a.dv[o] = dv_s[e];
    }
  }
#pragma unroll
  for (int m = 0; m < kCols; ++m) a.ds0[sq + kLanes * m] = gr[m];
  if (g == 0) a.du_part[bh * HD + i] = du_acc;
}

// du[e] = sum over b of du_part[b][e], b in order: e < n = H hd
__global__ void __launch_bounds__(256)
    wkv_bwd_sum_kernel(const float* part, float* du, int64_t b, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int64_t bi = 0; bi < b; ++bi) sum += part[bi * n + e];
  du[e] = sum;
}

template <int HD>
cudaError_t launch_bwd(const Args& a, int64_t bh, cudaStream_t stream) {
  constexpr int smem = Shape<HD>::kSmemFloats * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<HD><<<static_cast<unsigned>(bh), Shape<HD>::kThreads, smem,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// hd one of 16, 32, 64, 128; s >= 0 (s = 0: ds0 = ds, du's parts 0);
// marks holds B H max(1, ceil(s / 16)) hd^2 floats, hist B H 16 hd^2
extern "C" int rt_wkv_bwd(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          const void* dy, const void* ds, void* dr, void* dk,
                          void* dv, void* dw, void* ds0, void* du_part,
                          void* marks, void* hist, int64_t b, int64_t s,
                          int64_t h, int64_t hd, void* stream) {
  if (b < 1 || s < 0 || h < 1 || b * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dy = static_cast<const float*>(dy);
  a.ds = static_cast<const float*>(ds);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dw = static_cast<float*>(dw);
  a.ds0 = static_cast<float*>(ds0);
  a.du_part = static_cast<float*>(du_part);
  a.marks = static_cast<float*>(marks);
  a.hist = static_cast<float*>(hist);
  a.s = s;
  a.h = h;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_bwd<16>(a, b * h, st); break;
    case 32: err = launch_bwd<32>(a, b * h, st); break;
    case 64: err = launch_bwd<64>(a, b * h, st); break;
    case 128: err = launch_bwd<128>(a, b * h, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// du (n = H hd floats) = the sum over b of du_part (b, n)
extern "C" int rt_wkv_bwd_sum(const void* du_part, void* du, int64_t b,
                              int64_t n, void* stream) {
  if (b < 0 || n < 1 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  wkv_bwd_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), b, n);
  return static_cast<int>(cudaGetLastError());
}
