// RWKV6 WKV recurrence, backward, on Hopper's tensor cores (sm_90a): the
// "tc" route of ops.wkv_bwd (S >= 64).
//
// Replaces no Pallas kernel: the reference differentiates its jnp scan
// (repro/models/rwkv.py:96-113) with XLA, and its Pallas forward
// wkv_pallas (repro/kernels/rwkv6_wkv/kernel.py:79) has no backward.  It
// computes what rwkv6_wkv_bwd.cu's rec route computes -- dr, dk, dv, dw,
// du and ds0 from dy and ds, with the same inputs and outputs -- as the
// gradient of the chunked form.  Per (b, h) and chunk of C steps (64; 32
// at hd 128), with S_in the state before the chunk, G_out the gradient of
// the state after it, P-_t and P+_t the products of w over the chunk's
// steps before and after t (t itself left out), a(s, t) the product over
// the steps strictly between s and t, D = dY V^T and A[s][t] = sum_i
// r_s[i] a_i(t, s) k_t[i] (s > t; A[t][t] = sum_i u_i r_t[i] k_t[i]):
//
//   dr_t = u o k_t (v_t . dy_t) + P-_t o (S_in dy_t) + sum_{s<t} a(s,t) o k_s D[t][s]
//   dk_t = u o r_t (v_t . dy_t) + P+_t o (G_out v_t) + sum_{s>t} a(t,s) o r_s D[s][t]
//   dv   = (k o P+) G_out + A^T dY
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du   = sum_t r_t o k_t (v_t . dy_t)
//   S_in(c+1) = diag(F) S_in(c) + (k o P+)^T V,  G_out(c-1) = diag(F) G_out(c) + (r o P-)^T dY
//
// F the product of the chunk's w, ds0 the gradient before chunk 0.  dw is
// taken per sub-chunk T of 16 steps, from the state S_T at its start and
// the gradient G_T at its end (P, Q, F_T now over the sub-chunk):
//
//   dw_t = P_t Q_t sigma_T + Q_t sum_{s<t} a(s,t) k_s X[s] + P_t sum_{s>t} a(t,s) r_s Y[s]
//        + sum_{s<t<s'} a(s,t) a(t,s') k_s r_s' D[s'][s]
//
// with X = V G_T^T, Y = dY S_T^T and sigma_T[i] = <S_T[i], G_T[i]>, the
// sums over s, s' inside T.  Neither S_T nor G_T is formed: X, Y and
// sigma come from S_in, G_out and the chunk's other sub-chunks through D,
// the product across sub-chunks factored through their boundaries (a(s,
// t) = Q_J(s) W_JT P_T(t), W_JT the product of the whole sub-chunks
// between J and T), as wkv_tc_kernel (rwkv6_wkv.cu) forms A.  The last
// term, the pairs s < t < s' of one sub-chunk, is 560 pairs a row; it is
// taken as running products (E[s'][t] = sum_{s<t} a(s,t) k_s D[s'][s],
// then a Horner sum over s' from the last step down), 240 multiply-adds
// a row and sub-chunk, as are the inner sums of dr and dk.
//
// Every decay is a product of w's: no log, no exp, and no division by w
// or by a partial product, so w = 0 exactly stays exact (the identity w_t
// dw_t = <G_t, S_t> - k_t o (G_t v_t) gives only w dw).
//
// Four kernels, launched in turn (each counted by ops.py):
//
// (a) wkv_bwd_tc_states_kernel, a block per (b, chunk, h): the chunk's
//     own (k o P+)^T V and (r o P-)^T dY into the scratches s_in and g_out,
//     and F;
// (b) wkv_bwd_tc_pass_kernel, elementwise over (b, h, i, j): the chunk
//     boundaries in order from s0 and in reverse from ds, each chunk's
//     S_in and G_out written over its own part; ds0 the last;
// (c) wkv_bwd_tc_kernel, a block per (b, chunk, h), 8 warps: D, dY S_in^T,
//     V G_out^T and (k o P+) G_out; the products across sub-chunks (Y, X,
//     A's blocks off the diagonal), A's diagonal blocks in float32
//     running products; dv; then a thread per (sub-chunk, i) the running
//     products of dr, dk, dw and du's part;
// (d) wkv_bwd_tc_sum_kernel: du over (b, chunk), in order.
//
// No float atomics: every sum has a fixed order, and two calls give equal
// bits.
//
// Precision.  Every product runs on mma.sync as three TF32 products (hi.hi
// + hi.lo + lo.hi, tf32_mma.cuh), each k step of 8 summed from zero and
// added to the float32 accumulator with round to nearest (the tensor
// cores' own accumulation rounds toward zero: mamba2_ssd_bwd_tc.cu).  One
// TF32 product leaves the gradients past 1e-5 of their largest
// (tests/test_torch_wkv_bwd_tc.py emulates the whole order of work).
//
// Layout.  Staged rows (r, k, v, w, dy, P, Q, Y, X: C x hd) and the C x C
// matrices D and A are padded to a row stride of 4 mod 32 banks, so a
// fragment read along a row (rows g, columns 2q and 2q + 1, as float2) and
// one down a column (rows 2q and 2q + 1, column g) each meet 32 distinct
// banks; the k index of a fragment is read as 2q, 2q + 1.  S_in and G_out
// are read into fragments straight from device memory (through L1).  Rows
// past S are zero with w = 1, so a ragged last chunk adds nothing.  At
// hd 128 a chunk of 64 staged rows would take 304 KB, so the chunk is 32
// steps there (168 KB; 200 KB at hd 64: one block an SM).
//
// What bounds it on this card.  At rwkv6-3b's training shape (B, S, H, hd)
// = (4, 4096, 40, 64) the function reads r, k, v, w, dy and writes dr, dk,
// dv, dw, 168 MB each: about 1.5 GB, 0.45 ms at 3.35 TB/s.  The scratch of
// (a) and (b), two (B, H, chunks, hd, hd) tensors of 168 MB written, read
// and written again by the pass and read by (c), is this design's own
// traffic: about 1.3 GB more.  The products are some 3 C hd^2 + 8 C^2 hd
// multiply-adds a chunk in (c) and 2 C hd^2 in (a), three TF32 products
// each, and the running products about 120 operations a row and step:
// 0.32 ms at 495 and 67 TFLOP/s (chip_smoke.py's _wkv_bwd_tc_cost).  So
// the bytes bound it, where the recurrence's 12 scalar operations an
// element and step (0.48 ms) bound the rec route, and every step of it
// waits for the last.  This first chunked design is not at its bound:
// the gradient kernel runs one block an SM through five phases and three
// barriers (PERF.md has its time).

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kSub = 16;          // steps per sub-chunk (ops.BWD_TC_SUB)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Cfg {
  // steps per chunk (ops.BWD_TC_CHUNK)
  static constexpr int kC = HD <= 64 ? 64 : 32;
  static constexpr int kNS = kC / kSub;     // sub-chunks a chunk
  static constexpr int SW = HD + kPad;      // row stride of staged rows
  static constexpr int SC = kC + kPad;      // row stride of D and A
};

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
  float* s_in;      // (B, H, chunks, hd, hd): each chunk's own part, then S_in
  float* g_out;     // (B, H, chunks, hd, hd): its part, then G_out
  float* decay;     // (B, H, chunks, hd): F
  float* du_part;   // (B, chunks, H, hd): each block's part of du
  float* du;
  int64_t b, s, h, chunks;
  int vec;          // r, k, v, w, dy 16-byte aligned: staged as float4s
};

// (b, chunk, h) of a block of (a) and (c), the head fastest
struct Block {
  int64_t bi, ci, head, t0, slab;
  int n;            // rows of the chunk, <= kC
};

template <int HD>
__device__ __forceinline__ Block block_of(const Args& a) {
  constexpr int kC = Cfg<HD>::kC;
  Block k;
  const int64_t id = blockIdx.x;
  k.head = id % a.h;
  k.ci = (id / a.h) % a.chunks;
  k.bi = id / (a.h * a.chunks);
  k.t0 = k.ci * kC;
  k.n = static_cast<int>(a.s - k.t0 < kC ? a.s - k.t0 : kC);
  k.slab = (k.bi * a.h + k.head) * a.chunks + k.ci;
  return k;
}

// rows t < n of the block's (b, t0 + t, h) of the (B, S, H, hd) input x
// into dst (row stride SW); rows n .. kC - 1 set to fill; four floats a
// load where vec
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* x,
                                      const Args& a, const Block& k,
                                      float fill) {
  constexpr int kC = Cfg<HD>::kC, SW = Cfg<HD>::SW;
  const float* src = x + ((k.bi * a.s + k.t0) * a.h + k.head) * HD;
  const int64_t st = a.h * HD;
  if (a.vec) {
    for (int e = threadIdx.x; e < kC * HD / 4; e += kThreads) {
      const int t = e / (HD / 4), col = 4 * (e % (HD / 4));
      *reinterpret_cast<float4*>(dst + t * SW + col) =
          t < k.n ? *reinterpret_cast<const float4*>(src + t * st + col)
                  : make_float4(fill, fill, fill, fill);
    }
    return;
  }
  for (int e = threadIdx.x; e < kC * HD; e += kThreads) {
    const int t = e / HD, col = e % HD;
    dst[t * SW + col] = t < k.n ? src[t * st + col] : fill;
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// the sum over the eight lanes of a fragment column (lane bits 2..4)
__device__ __forceinline__ float down_rows(float x) {
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

// the product of the sub-chunks' decays F[lo .. hi - 1] of column i
template <int HD>
__device__ __forceinline__ float span(const float* fs, int lo, int hi,
                                      int i) {
  float p = 1.f;
  for (int m = lo; m < hi; ++m) p *= fs[m * HD + i];
  return p;
}

// ---------------------------------------------------------------------------
// (a) each chunk's own parts of S and G, and its decay F

template <int HD>
constexpr int states_smem_bytes() {
  return 4 * 5 * Cfg<HD>::kC * Cfg<HD>::SW;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    wkv_bwd_tc_states_kernel(Args a) {
  using Cf = Cfg<HD>;
  constexpr int kC = Cf::kC, SW = Cf::SW;
  // a task: a row tile of 16 i and kGroup column tiles of 8 j, each k
  // step's A fragment split once for them
  constexpr int kGroup = HD / 8 < 4 ? HD / 8 : 4;
  constexpr int kRowT = HD / 16;
  constexpr int kTasks = 2 * kRowT * (HD / 8 / kGroup);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // k, then k o P+
  float* vs = ks + kC * SW;
  float* rs = vs + kC * SW;         // r, then r o P-
  float* dys = rs + kC * SW;
  float* ws = dys + kC * SW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const Block k = block_of<HD>(a);
  stage<HD>(ks, a.k, a, k, 0.f);
  stage<HD>(vs, a.v, a, k, 0.f);
  stage<HD>(rs, a.r, a, k, 0.f);
  stage<HD>(dys, a.dy, a, k, 0.f);
  stage<HD>(ws, a.w, a, k, 1.f);
  __syncthreads();
  // thread i: P- and P+ of column i, r and k scaled in place, and F
  for (int i = threadIdx.x; i < HD; i += kThreads) {
    float p = 1.f;
    for (int t = 0; t < kC; ++t) {
      rs[t * SW + i] *= p;
      p *= ws[t * SW + i];
    }
    a.decay[k.slab * HD + i] = p;
    p = 1.f;
    for (int t = kC - 1; t >= 0; --t) {
      ks[t * SW + i] *= p;
      p *= ws[t * SW + i];
    }
  }
  __syncthreads();
  // (k o P+)^T V into s_in, (r o P-)^T dY into g_out: rows i, columns j
  for (int task = warp; task < kTasks; task += kWarps) {
    const int which = task & 1;
    const int rt = (task >> 1) % kRowT;
    const int cg = (task >> 1) / kRowT;
    const float* am = which ? rs : ks;
    const float* bm = which ? dys : vs;
    float acc[kGroup][4];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) zero(acc[c]);
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 8) {
      FragA fa;
      frag_cols(fa, am, SW, 16 * rt, k0, g, q);
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        FragB fb;
        frag_kmajor(fb, bm, SW, k0, 8 * (cg * kGroup + c), g, q);
        mma3_rn(acc[c], fa, fb);
      }
    }
    float* out = (which ? a.g_out : a.s_in) + k.slab * HD * HD;
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const int o = (16 * rt + g) * HD + 8 * (cg * kGroup + c) + 2 * q;
      *reinterpret_cast<float2*>(out + o) = make_float2(acc[c][0],
                                                        acc[c][1]);
      *reinterpret_cast<float2*>(out + o + 8 * HD) =
          make_float2(acc[c][2], acc[c][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the passes over the chunk boundaries: blockIdx.y 0 forward over s_in
// from s0, 1 in reverse over g_out from ds; thread e the four floats 4 e ..
// (one row i) of every (b, h) slab of hd^2

constexpr int kPassBatch = 8;     // chunks whose loads fly together

__global__ void __launch_bounds__(256)
    wkv_bwd_tc_pass_kernel(Args a, int64_t hd) {
  const int64_t nhd = hd * hd, quads = nhd / 4;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= a.b * a.h * quads) return;
  const int64_t bh = e / quads;
  const int64_t off = (e % quads) * 4;
  const bool fwd = blockIdx.y == 0;
  float* buf = (fwd ? a.s_in : a.g_out) + bh * a.chunks * nhd + off;
  const float* dec = a.decay + bh * a.chunks * hd + off / hd;
  // s0, ds and ds0 as four floats: the caller's may sit off 16 bytes
  const float* src = (fwd ? a.s0 : a.ds) + bh * nhd + off;
  float4 st = make_float4(src[0], src[1], src[2], src[3]);
  for (int64_t k0 = 0; k0 < a.chunks; k0 += kPassBatch) {
    float4 part[kPassBatch];
    float f[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      const int64_t k = fwd ? k0 + i : a.chunks - 1 - (k0 + i);
      if (k0 + i < a.chunks) {
        part[i] = *reinterpret_cast<const float4*>(buf + k * nhd);
        f[i] = dec[k * hd];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (k0 + i >= a.chunks) break;
      const int64_t k = fwd ? k0 + i : a.chunks - 1 - (k0 + i);
      *reinterpret_cast<float4*>(buf + k * nhd) = st;
      st.x = fmaf(f[i], st.x, part[i].x);
      st.y = fmaf(f[i], st.y, part[i].y);
      st.z = fmaf(f[i], st.z, part[i].z);
      st.w = fmaf(f[i], st.w, part[i].w);
    }
  }
  if (!fwd) {
    float* o = a.ds0 + bh * nhd + off;
    o[0] = st.x;
    o[1] = st.y;
    o[2] = st.z;
    o[3] = st.w;
  }
}

// ---------------------------------------------------------------------------
// (c) the gradients

// Shared memory of the gradient kernel, in floats
template <int HD>
struct GradLayout {
  using Cf = Cfg<HD>;
  static constexpr int kNS = Cf::kNS;
  static constexpr int kRow = Cf::kC * Cf::SW;   // a staged C x hd array
  static constexpr int kMat = Cf::kC * Cf::SC;   // a C x C matrix
  static constexpr int kR = 0;
  static constexpr int kK = kR + kRow;
  static constexpr int kV = kK + kRow;
  static constexpr int kW = kV + kRow;
  static constexpr int kDY = kW + kRow;
  static constexpr int kP = kDY + kRow;          // P, the sub-chunk's prefix
  static constexpr int kQ = kP + kRow;           // Q, its suffix
  static constexpr int kY = kQ + kRow;           // dY S_in^T, then Y
  static constexpr int kX = kY + kRow;           // V G_out^T, then X
  static constexpr int kD = kX + kRow;           // D = dY V^T
  static constexpr int kA = kD + kMat;
  static constexpr int kF = kA + kMat;           // [kNS][HD]
  static constexpr int kC2 = kF + kNS * HD;      // sigma's terms
  static constexpr int kC3 = kC2 + kNS * HD;
  static constexpr int kC4 = kC3 + kNS * HD;     // [kNS][kNS][HD]
  static constexpr int kSig = kC4 + kNS * kNS * HD;
  static constexpr int kU = kSig + HD;
  static constexpr int kDU = kU + HD;            // [kNS][HD]
  static constexpr int kFloats = kDU + kNS * HD;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) wkv_bwd_tc_kernel(Args a) {
  using Cf = Cfg<HD>;
  using Lay = GradLayout<HD>;
  constexpr int kC = Cf::kC, kNS = Cf::kNS, SW = Cf::SW, SC = Cf::SC;
  constexpr int kIT = HD / 8;                      // n8 tiles over i or j
  constexpr int kJT = (kIT + kWarps - 1) / kWarps; // dv column tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* rs = smem + Lay::kR;
  float* ks = smem + Lay::kK;
  float* vs = smem + Lay::kV;
  float* ws = smem + Lay::kW;
  float* dys = smem + Lay::kDY;
  float* ps = smem + Lay::kP;
  float* qs = smem + Lay::kQ;
  float* ys = smem + Lay::kY;
  float* xs = smem + Lay::kX;
  float* dm = smem + Lay::kD;
  float* am = smem + Lay::kA;
  float* fs = smem + Lay::kF;
  float* c2s = smem + Lay::kC2;
  float* c3s = smem + Lay::kC3;
  float* c4s = smem + Lay::kC4;
  float* sig0 = smem + Lay::kSig;
  float* us = smem + Lay::kU;
  float* dus = smem + Lay::kDU;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const Block k = block_of<HD>(a);
  const float* sin_g = a.s_in + k.slab * HD * HD;
  const float* gout_g = a.g_out + k.slab * HD * HD;
  stage<HD>(rs, a.r, a, k, 0.f);
  stage<HD>(ks, a.k, a, k, 0.f);
  stage<HD>(vs, a.v, a, k, 0.f);
  stage<HD>(ws, a.w, a, k, 1.f);
  stage<HD>(dys, a.dy, a, k, 0.f);
  for (int i = tid; i < HD; i += kThreads) us[i] = a.u[k.head * HD + i];
  __syncthreads();

  // (1) a thread per (sub-chunk T, column i): P, Q and F_T; a warp per row
  // i: sigma_0 = <S_in[i], G_out[i]>
  for (int task = tid; task < kNS * HD; task += kThreads) {
    const int r0 = kSub * (task / HD), i = task % HD;
    float p = 1.f;
    for (int t = 0; t < kSub; ++t) {
      ps[(r0 + t) * SW + i] = p;
      p *= ws[(r0 + t) * SW + i];
    }
    fs[task] = p;
    p = 1.f;
    for (int t = kSub - 1; t >= 0; --t) {
      qs[(r0 + t) * SW + i] = p;
      p *= ws[(r0 + t) * SW + i];
    }
  }
  for (int i = warp; i < HD; i += kWarps) {
    float part = 0.f;
    for (int j = lane; j < HD; j += 32) {
      part = fmaf(sin_g[i * HD + j], gout_g[i * HD + j], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(kFull, part, off);
    }
    if (lane == 0) sig0[i] = part;
  }
  __syncthreads();

  // (2) D's blocks on and under the diagonal, rows t, columns s
  {
    int task = 0;
    for (int T = 0; T < kNS; ++T) {
      for (int J = 0; J <= T; ++J) {
        for (int nt = 0; nt < 2; ++nt, ++task) {
          if (task % kWarps != warp) continue;
          float acc[4];
          zero(acc);
#pragma unroll 4
          for (int k0 = 0; k0 < HD; k0 += 8) {
            FragA fa;
            frag_rows(fa, dys, SW, kSub * T, k0, g, q);
            FragB fb;
            frag_nmajor(fb, vs, SW, k0, kSub * J + 8 * nt, g, q);
            mma3_rn(acc, fa, fb);
          }
          const int t = kSub * T + g, s = kSub * J + 8 * nt + 2 * q;
          *reinterpret_cast<float2*>(dm + t * SC + s) =
              make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(dm + (t + 8) * SC + s) =
              make_float2(acc[2], acc[3]);
        }
      }
    }
  }
  // dY S_in^T into Y with c3_T = sum_{t in T} P r (dY S_in^T), and V
  // G_out^T into X with c2_T = sum_{t in T} Q k (V G_out^T): a task an n8
  // tile of i down the chunk, its B fragment read once a k step
  for (int task = warp; task < 2 * kIT; task += kWarps) {
    const bool vg = task & 1;
    const int i = 8 * (task >> 1) + 2 * q;
    const float* op = vg ? vs : dys;
    const float* bg = vg ? gout_g : sin_g;
    float acc[kNS][4];
#pragma unroll
    for (int T = 0; T < kNS; ++T) zero(acc[T]);
#pragma unroll 2
    for (int k0 = 0; k0 < HD; k0 += 8) {
      FragB fb;
      frag_nmajor(fb, bg, HD, k0, 8 * (task >> 1), g, q);
#pragma unroll
      for (int T = 0; T < kNS; ++T) {
        FragA fa;
        frag_rows(fa, op, SW, kSub * T, k0, g, q);
        mma3_rn(acc[T], fa, fb);
      }
    }
    const float* cx = vg ? ks : rs;
    const float* cd = vg ? qs : ps;
    float* out = vg ? xs : ys;
    float* csum = vg ? c2s : c3s;
#pragma unroll
    for (int T = 0; T < kNS; ++T) {
      float c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = kSub * T + g + 8 * half;
        const float2 x = ld2(cx + t * SW + i), d = ld2(cd + t * SW + i);
        c0 = fmaf(x.x * d.x, acc[T][2 * half], c0);
        c1 = fmaf(x.y * d.y, acc[T][2 * half + 1], c1);
        *reinterpret_cast<float2*>(out + t * SW + i) =
            make_float2(acc[T][2 * half], acc[T][2 * half + 1]);
      }
      c0 = down_rows(c0);
      c1 = down_rows(c1);
      if (g == 0) {
        csum[T * HD + i] = c0;
        csum[T * HD + i + 1] = c1;
      }
    }
  }
  // dv's first term (k o P+) G_out, P+ = Q_T Fa_T: kept in registers until
  // A^T dY joins it
  float dvacc[kJT][kNS][4];
#pragma unroll
  for (int jj = 0; jj < kJT; ++jj) {
#pragma unroll
    for (int T = 0; T < kNS; ++T) zero(dvacc[jj][T]);
  }
#pragma unroll
  for (int jj = 0; jj < kJT; ++jj) {
    const int jt = warp + kWarps * jj;
    if (jt >= kIT) break;
#pragma unroll 2
    for (int k0 = 0; k0 < HD; k0 += 8) {
      FragB fb;
      frag_kmajor(fb, gout_g, HD, k0, 8 * jt, g, q);
      const int i = k0 + 2 * q;
#pragma unroll
      for (int T = 0; T < kNS; ++T) {
        const float f0 = span<HD>(fs, T + 1, kNS, i);
        const float f1 = span<HD>(fs, T + 1, kNS, i + 1);
        const int t = kSub * T + g;
        const float2 k0v = ld2(ks + t * SW + i), q0v = ld2(qs + t * SW + i);
        const float2 k1v = ld2(ks + (t + 8) * SW + i);
        const float2 q1v = ld2(qs + (t + 8) * SW + i);
        FragA fa;
        frag_a(fa, k0v.x * q0v.x * f0, k1v.x * q1v.x * f0,
               k0v.y * q0v.y * f1, k1v.y * q1v.y * f1);
        mma3_rn(dvacc[jj][T], fa, fb);
      }
    }
  }
  __syncthreads();      // D, Y, X, c2, c3

  // (3) the products across sub-chunks: Y_T = Fb_T (dY S_in^T) + sum_{J<T}
  // W_JT D_TJ (Q_J o K_J) (with c4 of the pairs J <= T - 2), X_T = Fa_T
  // (V G_out^T) + sum_{J>T} W_TJ D_JT^T (P_J o R_J); A's blocks J > T
  {
    constexpr int kYT = (kNS - 1) * kIT;           // Y tasks, then X's
    constexpr int kAT = kNS * (kNS - 1);           // A's 16 x 8 tiles
    for (int task = warp; task < 2 * kYT + kAT; task += kWarps) {
      if (task < 2 * kYT) {
        const bool isx = task >= kYT;
        const int tt = isx ? task - kYT : task;
        const int T = isx ? tt / kIT : 1 + tt / kIT;
        const int it = tt % kIT;
        const int i = 8 * it + 2 * q;
        float* buf = isx ? xs : ys;
        float acc[4];
        {
          const float f0 = isx ? span<HD>(fs, T + 1, kNS, i)
                               : span<HD>(fs, 0, T, i);
          const float f1 = isx ? span<HD>(fs, T + 1, kNS, i + 1)
                               : span<HD>(fs, 0, T, i + 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 y = ld2(buf + (kSub * T + g + 8 * half) * SW + i);
            acc[2 * half] = f0 * y.x;
            acc[2 * half + 1] = f1 * y.y;
          }
        }
        const int j0 = isx ? T + 1 : 0, j1 = isx ? kNS : T;
        for (int J = j0; J < j1; ++J) {
          float part[4];
          zero(part);
#pragma unroll
          for (int k0 = 0; k0 < kSub; k0 += 8) {
            FragA fa;
            if (isx) {
              frag_cols(fa, dm, SC, kSub * T, kSub * J + k0, g, q);
            } else {
              frag_rows(fa, dm, SC, kSub * T, kSub * J + k0, g, q);
            }
            // B(k = s, n = i): r o P (X) or k o Q (Y)
            const int s = kSub * J + k0 + 2 * q, ib = 8 * it + g;
            const float* bx = isx ? rs : ks;
            const float* bd = isx ? ps : qs;
            FragB fb;
            frag_b(fb, bx[s * SW + ib] * bd[s * SW + ib],
                   bx[(s + 1) * SW + ib] * bd[(s + 1) * SW + ib]);
            mma3_rn(part, fa, fb);
          }
          if (!isx && J <= T - 2) {
            float c0 = 0.f, c1 = 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = kSub * T + g + 8 * half;
              const float2 r = ld2(rs + t * SW + i), p = ld2(ps + t * SW + i);
              c0 = fmaf(r.x * p.x, part[2 * half], c0);
              c1 = fmaf(r.y * p.y, part[2 * half + 1], c1);
            }
            c0 = down_rows(c0);
            c1 = down_rows(c1);
            if (g == 0) {
              c4s[(T * kNS + J) * HD + i] = c0;
              c4s[(T * kNS + J) * HD + i + 1] = c1;
            }
          }
          const float w0 = isx ? span<HD>(fs, T + 1, J, i)
                               : span<HD>(fs, J + 1, T, i);
          const float w1 = isx ? span<HD>(fs, T + 1, J, i + 1)
                               : span<HD>(fs, J + 1, T, i + 1);
          acc[0] = fmaf(w0, part[0], acc[0]);
          acc[1] = fmaf(w1, part[1], acc[1]);
          acc[2] = fmaf(w0, part[2], acc[2]);
          acc[3] = fmaf(w1, part[3], acc[3]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(buf + (kSub * T + g + 8 * half) * SW +
                                     i) =
              make_float2(acc[2 * half], acc[2 * half + 1]);
        }
      } else {
        // A[s][t], s in J > T: (R_J o P_J o W_TJ) (K_T o Q_T)^T, tile nt
        // of T's columns
        int rest = task - 2 * kYT, T = 0, J = 1;
        const int nt = rest & 1;
        rest >>= 1;
        for (int T2 = 0; T2 < kNS; ++T2) {
          for (int J2 = T2 + 1; J2 < kNS; ++J2) {
            if (rest-- == 0) {
              T = T2;
              J = J2;
            }
          }
        }
        float acc[4];
        zero(acc);
        const int s0 = kSub * J + g, tb = kSub * T + 8 * nt + g;
#pragma unroll 2
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const int i = k0 + 2 * q;
          const float w0 = span<HD>(fs, T + 1, J, i);
          const float w1 = span<HD>(fs, T + 1, J, i + 1);
          const float2 ra = ld2(rs + s0 * SW + i), pa = ld2(ps + s0 * SW + i);
          const float2 rb = ld2(rs + (s0 + 8) * SW + i);
          const float2 pb = ld2(ps + (s0 + 8) * SW + i);
          FragA fa;
          frag_a(fa, ra.x * pa.x * w0, rb.x * pb.x * w0, ra.y * pa.y * w1,
                 rb.y * pb.y * w1);
          const float2 kv = ld2(ks + tb * SW + i), qv = ld2(qs + tb * SW + i);
          FragB fb;
          frag_b(fb, kv.x * qv.x, kv.y * qv.y);
          mma3_rn(acc, fa, fb);
        }
        const int t = kSub * T + 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(am + s0 * SC + t) =
            make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(am + (s0 + 8) * SC + t) =
            make_float2(acc[2], acc[3]);
      }
    }
  }
  // A's diagonal blocks in float32: lanes (T, t pair, part) take steps t
  // and 15 - t over HD / kParts columns each, summed over the parts by
  // shuffles; A[t][t] the bonus, zero above the diagonal
  {
    constexpr int kParts = kThreads / (kNS * 8);
    constexpr int kPer = HD / kParts;
    const int part = tid % kParts;
    const int pair = tid / kParts;
    const int r0 = kSub * (pair / 8), tp = pair % 8;
    const int i0 = part * kPer;
    for (int e = tid; e < kNS * kSub * kSub; e += kThreads) {
      const int b0 = kSub * (e / (kSub * kSub));
      const int s = (e / kSub) % kSub, t = e % kSub;
      if (s < t) am[(b0 + s) * SC + b0 + t] = 0.f;
    }
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int t = side ? kSub - 1 - tp : tp;
      float kt[kPer], run[kPer];
      float bonus = 0.f;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        kt[m] = ks[(r0 + t) * SW + i0 + m];
        run[m] = 1.f;
        bonus = fmaf(rs[(r0 + t) * SW + i0 + m] * us[i0 + m], kt[m], bonus);
      }
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1) {
        bonus += __shfl_xor_sync(kFull, bonus, off);
      }
      if (part == 0) am[(r0 + t) * SC + r0 + t] = bonus;
#pragma unroll 1
      for (int s = 1; s < kSub; ++s) {
        float acc = 0.f;
        if (s > t) {
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            acc = fmaf(rs[(r0 + s) * SW + i0 + m] * run[m], kt[m], acc);
            run[m] *= ws[(r0 + s) * SW + i0 + m];
          }
        }
#pragma unroll
        for (int off = 1; off < kParts; off <<= 1) {
          acc += __shfl_xor_sync(kFull, acc, off);
        }
        if (part == 0 && s > t) am[(r0 + s) * SC + r0 + t] = acc;
      }
    }
  }
  __syncthreads();      // Y, X, A, c4

  // (4) dv = (k o P+) G_out + A^T dY, rows t < n
#pragma unroll
  for (int jj = 0; jj < kJT; ++jj) {
    const int jt = warp + kWarps * jj;
    if (jt >= kIT) break;
#pragma unroll
    for (int T = 0; T < kNS; ++T) {
      for (int k0 = kSub * T; k0 < kC; k0 += 8) {
        FragA fa;
        frag_cols(fa, am, SC, kSub * T, k0, g, q);
        FragB fb;
        frag_kmajor(fb, dys, SW, k0, 8 * jt, g, q);
        mma3_rn(dvacc[jj][T], fa, fb);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = kSub * T + g + 8 * half;
        if (t < k.n) {
          float* o = a.dv + ((k.bi * a.s + k.t0 + t) * a.h + k.head) * HD +
                     8 * jt + 2 * q;
          *reinterpret_cast<float2*>(o) = make_float2(
              dvacc[jj][T][2 * half], dvacc[jj][T][2 * half + 1]);
        }
      }
    }
  }

  // (5) a thread per (sub-chunk T, column i): sigma_T, the pairs inside T,
  // then dr, dk, dw and du's part, rows t < n
  for (int task = tid; task < kNS * HD; task += kThreads) {
    const int T = task / HD, i = task % HD, r0 = kSub * T;
    float rr[kSub], kk[kSub], ww[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      rr[t] = rs[(r0 + t) * SW + i];
      kk[t] = ks[(r0 + t) * SW + i];
      ww[t] = ws[(r0 + t) * SW + i];
    }
    const float fb = span<HD>(fs, 0, T, i), fa = span<HD>(fs, T + 1, kNS, i);
    float sig = fb * fa * sig0[i];
    for (int J = T + 1; J < kNS; ++J) {
      sig += fb * span<HD>(fs, T + 1, J, i) * c3s[J * HD + i];
    }
    for (int J = 0; J < T; ++J) {
      sig += fa * span<HD>(fs, J + 1, T, i) * c2s[J * HD + i];
    }
    for (int J = 0; J < T; ++J) {
      for (int J2 = T + 1; J2 < kNS; ++J2) {
        sig += span<HD>(fs, J + 1, T, i) * span<HD>(fs, T + 1, J2, i) *
               c4s[(J2 * kNS + J) * HD + i];
      }
    }
    // E[s'][t] = sum_{s<t} a(s,t) k_s D[s'][s] as a running product over
    // t; H[t] = sum_{s'>t} a(t,s') r_s' E[s'][t] (dw's pairs) and dkI[t] =
    // sum_{s'>t} a(t,s') r_s' D[s'][t] by Horner over s' from the last;
    // drI[s'] = E[s'][s']
    float hh[kSub], dki[kSub], dri[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) hh[t] = dki[t] = dri[t] = 0.f;
#pragma unroll
    for (int sp = kSub - 1; sp >= 1; --sp) {
      const float* drow = dm + (r0 + sp) * SC + r0;
      float e = 0.f;
#pragma unroll
      for (int t = 0; t < sp; ++t) {
        const float d = drow[t];
        hh[t] = fmaf(ww[sp], hh[t], rr[sp] * e);
        dki[t] = fmaf(ww[sp], dki[t], rr[sp] * d);
        e = fmaf(ww[t], e, kk[t] * d);
      }
      dri[sp] = e;
    }
    // g_t = sum_{s>t} a(t,s) r_s Y[s], from the last step down
    float gs[kSub];
    float gacc = 0.f;
#pragma unroll
    for (int t = kSub - 1; t >= 0; --t) {
      gs[t] = gacc;
      gacc = fmaf(ww[t], gacc, rr[t] * ys[(r0 + t) * SW + i]);
    }
    const float ui = us[i];
    float f = 0.f, du = 0.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      const int row = r0 + t;
      const float p = ps[row * SW + i], qv = qs[row * SW + i];
      const float y = ys[row * SW + i], x = xs[row * SW + i];
      const float vdy = dm[row * SC + row];
      const float dr = (ui * kk[t] * vdy + p * y) + dri[t];
      const float dk = (ui * rr[t] * vdy + qv * x) + dki[t];
      const float dw = ((p * qv * sig + qv * f) + p * gs[t]) + hh[t];
      du = fmaf(rr[t] * kk[t], vdy, du);
      f = fmaf(ww[t], f, kk[t] * x);
      if (row < k.n) {
        const int64_t o =
            ((k.bi * a.s + k.t0 + row) * a.h + k.head) * HD + i;
        a.dr[o] = dr;
        a.dk[o] = dk;
        a.dw[o] = dw;
      }
    }
    dus[task] = du;
  }
  __syncthreads();
  for (int i = tid; i < HD; i += kThreads) {
    float sum = dus[i];
    for (int T = 1; T < kNS; ++T) sum += dus[T * HD + i];
    a.du_part[((k.bi * a.chunks + k.ci) * a.h + k.head) * HD + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// (d) e < n = H hd: du[e] = the sum of its parts over b, then the chunks,
// in order

__global__ void __launch_bounds__(256)
    wkv_bwd_tc_sum_kernel(Args a, int64_t n) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int64_t i = 0; i < a.b * a.chunks; ++i) sum += a.du_part[i * n + e];
  a.du[e] = sum;
}

// ---------------------------------------------------------------------------
// launches

template <int HD>
cudaError_t launch_states(const Args& a, cudaStream_t stream) {
  constexpr int smem = states_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_tc_states_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wkv_bwd_tc_states_kernel<HD>
      <<<static_cast<unsigned>(a.b * a.chunks * a.h), kThreads, smem,
         stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_grad(const Args& a, cudaStream_t stream) {
  constexpr int smem = GradLayout<HD>::kFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_bwd_tc_kernel<HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  wkv_bwd_tc_kernel<HD>
      <<<static_cast<unsigned>(a.b * a.chunks * a.h), kThreads, smem,
         stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_block(bool grad, const Args& a, cudaStream_t stream) {
  return grad ? launch_grad<HD>(a, stream) : launch_states<HD>(a, stream);
}

}  // namespace

// One entry point for the four kernels, each call with every pointer and
// size (ops.wkv_bwd allocates the outputs and the scratch): r, k, v, w, u,
// s0, dy, ds; dr, dk, dv, dw, ds0; s_in and g_out (B H chunks hd^2 floats
// each), decay (B H chunks hd), du_part (B chunks H hd), du; B, S, H, hd;
// then which kernel: 0 states, 1 the passes, 2 the gradients, 3 the sum.
// chunks = ceil(S / C), C = 64 (32 at hd 128); S >= 1, B >= 1, H >= 1, hd
// one of 16, 32, 64, 128.
extern "C" int rt_wkv_bwd_tc(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dy, const void* ds, void* dr,
                             void* dk, void* dv, void* dw, void* ds0,
                             void* s_in, void* g_out, void* decay,
                             void* du_part, void* du, int64_t b, int64_t s,
                             int64_t h, int64_t hd, int64_t which,
                             void* stream) {
  if (b < 1 || s < 1 || h < 1 || which < 0 || which > 3 ||
      (hd != 16 && hd != 32 && hd != 64 && hd != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunk = hd == 128 ? Cfg<128>::kC : Cfg<64>::kC;
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
  a.s_in = static_cast<float*>(s_in);
  a.g_out = static_cast<float*>(g_out);
  a.decay = static_cast<float*>(decay);
  a.du_part = static_cast<float*>(du_part);
  a.du = static_cast<float*>(du);
  a.b = b;
  a.s = s;
  a.h = h;
  a.chunks = (s + chunk - 1) / chunk;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dy);
  a.vec = ptrs % 16 == 0;
  if (b * a.chunks * h > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0 || which == 2) {
    cudaError_t err;
    switch (hd) {
      case 16: err = launch_block<16>(which == 2, a, st); break;
      case 32: err = launch_block<32>(which == 2, a, st); break;
      case 64: err = launch_block<64>(which == 2, a, st); break;
      default: err = launch_block<128>(which == 2, a, st); break;
    }
    return static_cast<int>(err);
  }
  if (which == 1) {
    const int64_t threads = b * h * hd * hd / 4;
    if ((threads + 255) / 256 > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    wkv_bwd_tc_pass_kernel<<<dim3(static_cast<unsigned>((threads + 255) /
                                                        256),
                                  2),
                             256, 0, st>>>(a, hd);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t n = h * hd;
  wkv_bwd_tc_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          st>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}
