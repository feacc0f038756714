// Mamba2 SSD (state-space dual) scan, backward, on Hopper's tensor cores
// (sm_90a): the "tc" route of ops.ssd_bwd (S >= 64).
//
// Replaces no Pallas kernel: the reference differentiates its chunked
// form (repro/models/ssm.py:82-156) with XLA.  This is the gradient of that
// chunked form, the transpose of ssd_tc_kernel's algebra (mamba2_ssd.cu),
// computing what mamba2_ssd_bwd.cu's rec route computes -- dx, db, dc, ddt,
// da, dd and ds0 from dy and ds -- on the same strided views of x, b, c
// and dt (each (b, t) row contiguous).  Per (b, h) and chunk of C = 64
// steps, with cum = cumsum(dt a) restarted at the chunk, L[t][j] =
// e^{cum_t - cum_j} (j <= t), w_j = e^{cum_last - cum_j} dt_j, G = C B^T and
// M = G o L o dt_j, the forward is
//
//   Y     = M X + diag(e^{cum}) C S_in + d X
//   S_out = e^{cum_last} S_in + B^T (w o X)
//
// and its gradient, with dS_out the gradient of the state after the chunk:
//
//   dS_in = e^{cum_last} dS_out + C^T diag(e^{cum}) dY
//   dX    = M^T dY + d dY + diag(w) B dS_out
//   dM    = dY X^T (j <= t),  dG = dM o L o dt_j
//   dC    = dG B + diag(e^{cum}) dY S_in^T
//   dB    = dG^T C + diag(w) X dS_out^T
//   ddt_u = sum_t P[t][u] + u_u + a dlog_u,  P = dM o L o G,
//           u_u = e^{cum_last - cum_u} b_u . (dS_out x_u)
//   da    = sum dt_u dlog_u,  dd = sum x . dy
//
// where dlog_u, the gradient of the log decay of step u, is the sum of
// d/dcum_t over t >= u.  As a sum over rows of d/dcum_t it is a difference
// of per-row sums that cancel (sum_j Q[t][j] - sum_i Q[i][t], Q = dG o G);
// so it is formed from terms that do not cancel:
//
//   dlog_u = R_u + sum_{t >= u} r_t + sum_{t < u} v_t + e^{cum_last} <S_in, dS_out>
//
// with R_u the sum of Q over the rectangle t >= u > j, r_t = e^{cum_t}
// c_t . (S_in dy_t) and v_t = dt_t u_t.  R is one more product on the
// tensor cores: Z = Q V with V[j][u] = [j < u] (exact in TF32), summed down
// its columns over t >= u.  cum itself is summed in float64 and kept as hi
// + lo floats, every decay e^{(hi_t - hi_j) + (lo_t - lo_j)}: at dt 5 to 20
// cum reaches -10^4, where a float32 step is 10^-3.  Over 130 steps of dt
// 5 to 20 the cancelling sums left da 7e-5 off float64 and a float32 cum
// 1e-4 (tests/test_torch_ssd_bwd_tc.py emulates all of this on the CPU).
//
// Four kernels, launched in turn (each counted by ops.py):
//
// (a) ssd_bwd_tc_states_kernel, a block per (b, chunk, group of kHeads
//     heads): each head's B^T (w o X) and C^T (e^{cum} o dY), N x hd each,
//     into the two scratches s_in and ds_out, and e^{cum_last};
// (b) ssd_bwd_tc_pass_kernel, elementwise over (b, h, n, p): the chunk
//     boundaries in order from s0 (S_in(k+1) = e^{cum_last} S_in(k) +
//     local(k), each chunk's S_in written over its local part), and in
//     reverse from ds (dS_out(k-1) = e^{cum_last} dS_out(k) + its part;
//     ds0 the last), four floats a thread;
// (c) ssd_bwd_tc_kernel, a block per (b, chunk, group of kHeads heads),
//     8 warps: G once per block, then per head dM and with it M, dG and P's
//     column sums; dX and Z; dC (warps 0-3) and dB (warps 4-7), each warp a
//     row of 16x8 tiles, summed over the group's heads in registers; then
//     dlog, ddt, and the head's parts of da and dd;
// (d) ssd_bwd_tc_sum_kernel: db and dc over the head groups, da and dd
//     over (b, chunk), in order.
//
// No float atomics: every sum has a fixed order, and two calls give equal
// bits.
//
// Precision.  The products run on mma.sync into accumulators that each k
// step of 8 adds to in float32 with round to nearest (the tensor cores'
// own accumulation rounds toward zero, and 24 such roundings a product,
// all the same way, left da up to 1.5e-5 off the plain backward).  Most
// are three TF32 products (hi.hi + hi.lo + lo.hi, tf32_mma.cuh); one TF32
// product leaves the gradients past 1e-5 of their largest.  The four that
// carry the state across chunks -- B^T (w o X) and C^T (e^{cum} o dY),
// dY S_in^T and X dS_out^T, whence S_in, dS_out, r and u -- run on the
// float64 tensor cores (m8n8k4, DMMA), their float32 operands exact in
// float64: da is a sum of terms up to some 15 times its size, and with
// those four as TF32 products it lay 9.4e-6 of its largest from float64 at
// one of chip_smoke.py's (k2) edges (1, 130, 2, 128, 32), where the float32
// plain backward lies 6.9e-6 from it on the other side; in float64 0.6e-6.
// <S_in, dS_out> and x . dy are summed in float64 too.  The exponentials
// are float32 expf outside the tensor cores.
//
// Layout.  Staged rows (x, dy, b, c; float4 copies where 16-byte aligned)
// and the C x C matrices (G, M, dG) are padded to a row stride of 4 mod 32
// banks, so a fragment read along a row (rows g, columns 2q and 2q + 1, as
// float2) and one down a column (rows 2q and 2q + 1, column g) each meet
// 32 distinct banks; as in mamba2_ssd.cu the k index of a fragment is read
// as 2q, 2q + 1.  Each warp keeps several output tiles that share their A
// fragment (a row of dX, dC or dB tiles; a row of states tiles), so the
// split or load of A is done once a k step for all of them.  S_in and
// dS_out are read into fragments straight from device memory (through
// L1): staging them too does not fit 227 KB at hd = N = 128.  Rows past S
// are zero with dt = 0, so a ragged last chunk adds nothing.
//
// What bounds it on this card.  At zamba2-7b's training shape (B, S, H, hd,
// N) = (4, 4096, 112, 64, 64) the function reads x and dy and writes dx,
// 470 MB each, the rest under 10 MB each: about 1.46 GB, 0.44 ms at 3.35
// TB/s.  The float64 products are 4 C N hd multiply-adds per (b, h,
// chunk), 6.0e10 operations, 0.90 ms at the 67 TFLOP/s of the float64
// tensor cores; the TF32 ones (dM, M^T dY, dG B and dG^T C about C^2 hd / 2
// or C^2 N / 2 each, B dS_out C N hd, Z C^3 / 6, G once per block) three
// times over, 1.5e11 operations, 0.30 ms at 495 TFLOP/s: 1.19 ms of
// operations in all (chip_smoke.py's _ssd_bwd_tc_cost).  The scratch of (a)
// and (b), two (B, H, chunks, N, hd) tensors of 470 MB written, read and
// written again by the pass and read by (c), is this design's own
// traffic: about 2.8 GB more.

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kC = 64;            // steps per chunk (ops.TC_CHUNK)
constexpr int kHeads = 16;        // heads per block (ops.BWD_HEADS)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 4;
constexpr int SC = kC + kPad;     // row stride of G, M and dG
constexpr int kLowTiles = 20;     // 16x8 tiles of a C x C matrix on and
                                  // under its diagonal
constexpr unsigned kFull = 0xffffffffu;

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
  float* s_in;      // (B, H, chunks, N, hd): each chunk's own state, then S_in
  float* ds_out;    // (B, H, chunks, N, hd): its dS part, then dS_out
  float* elast;     // (B, H, chunks): e^{cum_last}
  float* db_part;   // (groups, B, S, N): each head group's part of db
  float* dc_part;   // (groups, B, S, N): of dc
  float* scal_part; // (2, B chunks, H): each (b, chunk, h)'s part of da, dd
  int64_t bb, s, h, chunks, groups;
  int64_t x_sb, x_st;
  int64_t b_sb, b_st;
  int64_t c_sb, c_st;
  int64_t dt_sb, dt_st;
  int vec;          // x, b, c, dy rows 16-byte aligned: staged as float4s
};

// (b, chunk, group) of a block of (a) and (c); the group fastest, so the
// blocks that read one chunk's b and c run together
struct Block {
  int64_t bi, ci, gi, t0;
  int n;                 // rows of the chunk, <= kC
  int64_t h0, h1;        // its heads
};

__device__ __forceinline__ Block block_of(const Args& a) {
  Block k;
  const int64_t id = blockIdx.x;
  k.gi = id % a.groups;
  k.ci = (id / a.groups) % a.chunks;
  k.bi = id / (a.groups * a.chunks);
  k.t0 = k.ci * kC;
  k.n = static_cast<int>(a.s - k.t0 < kC ? a.s - k.t0 : kC);
  k.h0 = k.gi * kHeads;
  k.h1 = k.h0 + kHeads < a.h ? k.h0 + kHeads : a.h;
  return k;
}

// rows t < n of a (W wide, row t at src + t * st) into dst, row stride W +
// kPad; rows n .. kC - 1 zero; four floats a load where vec
template <int W>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t st, int n, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kC * W / 4; e += kThreads) {
      const int t = e / (W / 4), col = 4 * (e % (W / 4));
      *reinterpret_cast<float4*>(dst + t * (W + kPad) + col) =
          t < n ? *reinterpret_cast<const float4*>(src + t * st + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < kC * W; e += kThreads) {
    const int t = e / W, col = e % W;
    dst[t * (W + kPad) + col] = t < n ? src[t * st + col] : 0.f;
  }
}

// Per head and chunk, in shared memory: dt (zero past the chunk's rows);
// cum = cumsum(dt a) as hi + lo; e^{cum} (et), e^{last - cum} (ew), w =
// ew dt; e^{last} (elast), last the cum of row n - 1
struct RowVecs {
  float* dt;
  float* hi;
  float* lo;
  float* et;
  float* ew;
  float* w;
  float* elast;
  static constexpr int kFloats = 6 * kC + 4;
  __device__ explicit RowVecs(float* p)
      : dt(p), hi(p + kC), lo(p + 2 * kC), et(p + 3 * kC), ew(p + 4 * kC),
        w(p + 5 * kC), elast(p + 6 * kC) {}
};

__device__ __forceinline__ void stage_dt(const RowVecs& rv, const float* dt,
                                         int64_t st, int n) {
  for (int t = threadIdx.x; t < kC; t += kThreads) {
    rv.dt[t] = t < n ? dt[t * st] : 0.f;
  }
}

// warp 0 (two rows a lane): the cumulative log decay in float64, split into
// hi + lo floats, and the decays of the chunk
__device__ __forceinline__ void chunk_rows(const RowVecs& rv, float a_h,
                                           int n, int lane) {
  const float l0 = rv.dt[2 * lane] * a_h;
  const float l1 = rv.dt[2 * lane + 1] * a_h;
  double incl = static_cast<double>(l0) + static_cast<double>(l1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  const double c0 = excl + static_cast<double>(l0);
  const double last =
      __shfl_sync(kFull, ((n - 1) & 1) ? incl : c0, (n - 1) >> 1);
  const float last_hi = static_cast<float>(last);
  const float last_lo = static_cast<float>(last - last_hi);
  const double cs[2] = {c0, incl};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * lane + i;
    const float hi = static_cast<float>(cs[i]);
    const float lo = static_cast<float>(cs[i] - hi);
    rv.hi[t] = hi;
    rv.lo[t] = lo;
    rv.et[t] = expf(hi);
    const float ew = expf((last_hi - hi) + (last_lo - lo));
    rv.ew[t] = ew;
    rv.w[t] = ew * rv.dt[t];
  }
  if (lane == 0) *rv.elast = expf(last_hi);
}

// e^{cum_t - cum_j}, j <= t
__device__ __forceinline__ float decay(const RowVecs& rv, int t, int j) {
  return expf((rv.hi[t] - rv.hi[j]) + (rv.lo[t] - rv.lo[j]));
}

// 16x8 tile i of the kLowTiles on and under the diagonal: rows 16 mt ..,
// columns 8 nt .., nt <= 2 mt + 1
__device__ __forceinline__ void low_tile(int i, int& mt, int& nt) {
  mt = (i >= 2) + (i >= 6) + (i >= 12);
  nt = i - mt * (mt + 1);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc += a b on the float64 tensor cores (mma.sync m8n8k4, two of them a
// row half): the float32 values a 16x8x8 step's fragments hold, (rows g,
// g + 8) x (k 2q, 2q + 1) of a and (k 2q, 2q + 1) x (column g) of b, their
// products and sums in float64; acc as the float32 accumulators are laid
// out
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void mma_f64(double (&acc)[4], float a0,
                                        float a1, float a2, float a3,
                                        float b0, float b1) {
  dmma(acc[0], acc[1], a0, b0);
  dmma(acc[0], acc[1], a2, b1);
  dmma(acc[2], acc[3], a1, b0);
  dmma(acc[2], acc[3], a3, b1);
}

// ---------------------------------------------------------------------------
// (a) each chunk's own state and dS part

template <int N, int HD>
constexpr int states_smem_bytes() {
  return 4 * (2 * kC * (N + kPad) + 2 * kC * (HD + kPad) +
              RowVecs::kFloats);
}

template <int N, int HD>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_tc_states_kernel(Args a) {
  constexpr int SN = N + kPad, SX = HD + kPad;
  // warp w: row tile w % kRowT (16 rows n), p tiles w / kRowT + kStep i;
  // at most kGroup of them at a time, each k step's A fragments of b and c
  // split once for all of them
  constexpr int kRowT = N / 16;
  constexpr int kStep = kWarps / kRowT < 1 ? 1 : kWarps / kRowT;
  constexpr int kGroup = 4;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                         // [kC][SN]
  float* cs = bs + kC * SN;
  float* xs = cs + kC * SN;                 // [kC][SX]
  float* dys = xs + kC * SX;
  const RowVecs rv(dys + kC * SX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const Block k = block_of(a);
  stage<N>(bs, a.b + k.bi * a.b_sb + k.t0 * a.b_st, a.b_st, k.n, a.vec);
  stage<N>(cs, a.c + k.bi * a.c_sb + k.t0 * a.c_st, a.c_st, k.n, a.vec);
  for (int64_t head = k.h0; head < k.h1; ++head) {
    __syncthreads();      // the last head's reads of xs, dys, rv are done
    stage<HD>(xs, a.x + k.bi * a.x_sb + k.t0 * a.x_st + head * HD, a.x_st,
              k.n, a.vec);
    stage<HD>(dys, a.dy + ((k.bi * a.s + k.t0) * a.h + head) * HD,
              a.h * HD, k.n, a.vec);
    stage_dt(rv, a.dt + k.bi * a.dt_sb + k.t0 * a.dt_st + head, a.dt_st,
             k.n);
    __syncthreads();
    if (warp == 0) chunk_rows(rv, a.a[head], k.n, lane);
    __syncthreads();
    const int64_t slab = (k.bi * a.h + head) * a.chunks + k.ci;
    float* local = a.s_in + slab * (N * HD);
    float* dlocal = a.ds_out + slab * (N * HD);
    // local = B^T (w o X), dlocal = C^T (e^{cum} o dY): rows n, columns p
    const int n0 = 16 * (warp % kRowT);
    for (int pt0 = warp / kRowT; pt0 < HD / 8; pt0 += kStep * kGroup) {
      double acc[kGroup][4], dacc[kGroup][4];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = dacc[i][e] = 0.0;
      }
#pragma unroll 2
      for (int k0 = 0; k0 < kC; k0 += 8) {
        const int j = k0 + 2 * q;
        // A(n, j) = b[j][n], c[j][n]: rows n0 + g, + 8; k = j, j + 1
        const float* pb = bs + j * SN + n0 + g;
        const float* pc = cs + j * SN + n0 + g;
        const float w0 = rv.w[j], w1 = rv.w[j + 1];
        const float e0 = rv.et[j], e1 = rv.et[j + 1];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int p = 8 * (pt0 + kStep * i) + g;
          if (p >= HD) break;
          mma_f64(acc[i], pb[0], pb[8], pb[SN], pb[SN + 8],
                  w0 * xs[j * SX + p], w1 * xs[(j + 1) * SX + p]);
          mma_f64(dacc[i], pc[0], pc[8], pc[SN], pc[SN + 8],
                  e0 * dys[j * SX + p], e1 * dys[(j + 1) * SX + p]);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int p0 = 8 * (pt0 + kStep * i);
        if (p0 >= HD) break;
        const int o = (n0 + g) * HD + p0 + 2 * q;
        *reinterpret_cast<float2*>(local + o) = make_float2(
            static_cast<float>(acc[i][0]), static_cast<float>(acc[i][1]));
        *reinterpret_cast<float2*>(local + o + 8 * HD) = make_float2(
            static_cast<float>(acc[i][2]), static_cast<float>(acc[i][3]));
        *reinterpret_cast<float2*>(dlocal + o) = make_float2(
            static_cast<float>(dacc[i][0]), static_cast<float>(dacc[i][1]));
        *reinterpret_cast<float2*>(dlocal + o + 8 * HD) = make_float2(
            static_cast<float>(dacc[i][2]), static_cast<float>(dacc[i][3]));
      }
    }
    if (threadIdx.x == 0) a.elast[slab] = *rv.elast;
  }
}

// ---------------------------------------------------------------------------
// (b) the passes over the chunk boundaries: blockIdx.y 0 forward over s_in,
// 1 in reverse over ds_out; thread e the four floats 4 e .. of every (b, h)
// slab of N hd

constexpr int kPassBatch = 8;     // chunks whose loads fly together

__global__ void __launch_bounds__(256)
    ssd_bwd_tc_pass_kernel(Args a, int64_t nhd) {
  const int64_t quads = nhd / 4;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= a.bb * a.h * quads) return;
  const int64_t bh = e / quads;
  const int64_t off = (e % quads) * 4;
  const bool fwd = blockIdx.y == 0;
  float* buf = (fwd ? a.s_in : a.ds_out) + bh * a.chunks * nhd + off;
  const float* el = a.elast + bh * a.chunks;
  float4 st = *reinterpret_cast<const float4*>(
      (fwd ? a.s0 : a.ds) + bh * nhd + off);
  for (int64_t k0 = 0; k0 < a.chunks; k0 += kPassBatch) {
    float4 part[kPassBatch];
    float dec[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      const int64_t k = fwd ? k0 + i : a.chunks - 1 - (k0 + i);
      if (k0 + i < a.chunks) {
        part[i] = *reinterpret_cast<const float4*>(buf + k * nhd);
        dec[i] = el[k];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (k0 + i >= a.chunks) break;
      const int64_t k = fwd ? k0 + i : a.chunks - 1 - (k0 + i);
      *reinterpret_cast<float4*>(buf + k * nhd) = st;
      st.x = fmaf(dec[i], st.x, part[i].x);
      st.y = fmaf(dec[i], st.y, part[i].y);
      st.z = fmaf(dec[i], st.z, part[i].z);
      st.w = fmaf(dec[i], st.w, part[i].w);
    }
  }
  if (!fwd) *reinterpret_cast<float4*>(a.ds0 + bh * nhd + off) = st;
}

// ---------------------------------------------------------------------------
// (c) the gradients

template <int N, int HD>
constexpr int grad_smem_bytes() {
  // b, c; x, dy; G, M, dG; the row vectors; r, u; the column parts of P
  // and of Z (4 row tiles each); the warps' parts of <S_in, dS_out>, x . dy
  return 4 * (2 * kC * (N + kPad) + 2 * kC * (HD + kPad) + 3 * kC * SC +
              RowVecs::kFloats + 2 * kC + 8 * kC + 2 * kWarps);
}

template <int N, int HD>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_tc_kernel(Args a) {
  constexpr int SN = N + kPad, SX = HD + kPad;
  constexpr int kXT = HD / 16;              // dX: p tiles a warp
  constexpr int kNT = N / 8;                // n8 tiles of dC and dB
  constexpr int kGroupNT = kNT < 8 ? kNT : 8;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                         // [kC][SN]
  float* cs = bs + kC * SN;
  float* xs = cs + kC * SN;                 // [kC][SX]
  float* dys = xs + kC * SX;
  float* gs = dys + kC * SX;                // G [kC][SC], zero above
  float* ms = gs + kC * SC;                 // M
  float* dgs = ms + kC * SC;                // dG
  const RowVecs rv(dgs + kC * SC);
  float* r_s = dgs + kC * SC + RowVecs::kFloats;    // [kC]
  float* u_s = r_s + kC;
  float* colp = u_s + kC;                   // [4][kC]: P down each row tile
  float* colz = colp + 4 * kC;              // [4][kC]: Z (t >= u)
  float* red = colz + 4 * kC;               // [2][kWarps]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const Block k = block_of(a);
  stage<N>(bs, a.b + k.bi * a.b_sb + k.t0 * a.b_st, a.b_st, k.n, a.vec);
  stage<N>(cs, a.c + k.bi * a.c_sb + k.t0 * a.c_st, a.c_st, k.n, a.vec);
  __syncthreads();
  // G = C B^T on and under the diagonal, zero above it inside those tiles
  for (int i = warp; i < kLowTiles; i += kWarps) {
    int mt, nt;
    low_tile(i, mt, nt);
    float acc[4];
    zero(acc);
#pragma unroll 4
    for (int k0 = 0; k0 < N; k0 += 8) {
      FragA fa;
      frag_rows(fa, cs, SN, 16 * mt, k0, g, q);
      FragB fb;
      frag_nmajor(fb, bs, SN, k0, 8 * nt, g, q);
      mma3_rn(acc, fa, fb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 16 * mt + g + 8 * (e >> 1), j = 8 * nt + 2 * q + (e & 1);
      gs[t * SC + j] = j <= t ? acc[e] : 0.f;
    }
  }
  // dC (warps 0-3) or dB (warps 4-7) of row tile mt = warp % 4, summed
  // over the group's heads
  const bool is_dc = warp < 4;
  const int mt_c = warp & 3;
  float pacc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) zero(pacc[nt]);

  for (int64_t head = k.h0; head < k.h1; ++head) {
    __syncthreads();      // the last head's reads are done
    stage<HD>(xs, a.x + k.bi * a.x_sb + k.t0 * a.x_st + head * HD, a.x_st,
              k.n, a.vec);
    stage<HD>(dys, a.dy + ((k.bi * a.s + k.t0) * a.h + head) * HD,
              a.h * HD, k.n, a.vec);
    stage_dt(rv, a.dt + k.bi * a.dt_sb + k.t0 * a.dt_st + head, a.dt_st,
             k.n);
    const float a_h = a.a[head];
    const int64_t slab = (k.bi * a.h + head) * a.chunks + k.ci;
    const float* sin_g = a.s_in + slab * (N * HD);
    const float* dso_g = a.ds_out + slab * (N * HD);
    __syncthreads();
    if (warp == 0) chunk_rows(rv, a_h, k.n, lane);
    {
      // the warps' parts of <S_in, dS_out> and of x . dy
      double pes = 0.0, pdd = 0.0;
      for (int e = tid; e < N * HD / 4; e += kThreads) {
        const float4 u = reinterpret_cast<const float4*>(sin_g)[e];
        const float4 v = reinterpret_cast<const float4*>(dso_g)[e];
        pes = fma(static_cast<double>(u.x), static_cast<double>(v.x), pes);
        pes = fma(static_cast<double>(u.y), static_cast<double>(v.y), pes);
        pes = fma(static_cast<double>(u.z), static_cast<double>(v.z), pes);
        pes = fma(static_cast<double>(u.w), static_cast<double>(v.w), pes);
      }
      for (int e = tid; e < kC * HD; e += kThreads) {
        const int t = e / HD, p = e % HD;
        pdd = fma(static_cast<double>(xs[t * SX + p]),
                  static_cast<double>(dys[t * SX + p]), pdd);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pes += __shfl_xor_sync(kFull, pes, off);
        pdd += __shfl_xor_sync(kFull, pdd, off);
      }
      if (lane == 0) {
        red[warp] = static_cast<float>(pes);
        red[kWarps + warp] = static_cast<float>(pdd);
      }
    }
    __syncthreads();      // rv, red

    // dM = dY X^T on and under the diagonal, and with it M, dG and the
    // sums of P = dM o L o G down each tile's rows
    for (int i = warp; i < kLowTiles; i += kWarps) {
      int mt, nt;
      low_tile(i, mt, nt);
      float acc[4];
      zero(acc);
#pragma unroll 4
      for (int k0 = 0; k0 < HD; k0 += 8) {
        FragA fa;
        frag_rows(fa, dys, SX, 16 * mt, k0, g, q);
        FragB fb;
        frag_nmajor(fb, xs, SX, k0, 8 * nt, g, q);
        mma3_rn(acc, fa, fb);
      }
      float colsum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + 8 * (e >> 1), j = 8 * nt + 2 * q + (e & 1);
        float m = 0.f, dg = 0.f;
        if (j <= t) {
          const float ell = decay(rv, t, j);
          const float gv = gs[t * SC + j];
          const float ed = acc[e] * ell;
          m = gv * ell * rv.dt[j];
          dg = ed * rv.dt[j];
          colsum[e & 1] += ed * gv;
        }
        ms[t * SC + j] = m;
        dgs[t * SC + j] = dg;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        colsum[0] += __shfl_xor_sync(kFull, colsum[0], off);
        colsum[1] += __shfl_xor_sync(kFull, colsum[1], off);
      }
      if (g == 0) {
        colp[mt * kC + 8 * nt + 2 * q] = colsum[0];
        colp[mt * kC + 8 * nt + 2 * q + 1] = colsum[1];
      }
    }
    __syncthreads();      // M, dG, colp

    // dX = M^T dY + diag(w) B dS_out + d dY: warp w the row tile j0 =
    // 16 (w % 4) and the p tiles w / 4 + 2 i, each k step's A fragment
    // split once for all of them
    const float d_h = a.d[head];
    {
      const int j0 = 16 * (warp & 3), pt0 = warp >> 2;
      float acc[kXT][4];
#pragma unroll
      for (int i = 0; i < kXT; ++i) zero(acc[i]);
      for (int k0 = j0; k0 < kC; k0 += 8) {
        FragA fa;
        frag_cols(fa, ms, SC, j0, k0, g, q);
#pragma unroll
        for (int i = 0; i < kXT; ++i) {
          FragB fb;
          frag_kmajor(fb, dys, SX, k0, 8 * (pt0 + 2 * i), g, q);
          mma3_rn(acc[i], fa, fb);
        }
      }
      const float w0 = rv.w[j0 + g], w1 = rv.w[j0 + g + 8];
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 8) {
        const float2 u = ld2(bs + (j0 + g) * SN + k0 + 2 * q);
        const float2 v = ld2(bs + (j0 + g + 8) * SN + k0 + 2 * q);
        FragA fa;
        frag_a(fa, w0 * u.x, w1 * v.x, w0 * u.y, w1 * v.y);
#pragma unroll
        for (int i = 0; i < kXT; ++i) {
          FragB fb;
          frag_kmajor(fb, dso_g, HD, k0, 8 * (pt0 + 2 * i), g, q);
          mma3_rn(acc[i], fa, fb);
        }
      }
      float* dx = a.dx + ((k.bi * a.s + k.t0) * a.h + head) * HD;
#pragma unroll
      for (int i = 0; i < kXT; ++i) {
        const int p = 8 * (pt0 + 2 * i) + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + g + 8 * half;
          if (j < k.n) {
            const float2 y = ld2(dys + j * SX + p);
            *reinterpret_cast<float2*>(dx + j * a.h * HD + p) =
                make_float2(fmaf(d_h, y.x, acc[i][2 * half]),
                            fmaf(d_h, y.y, acc[i][2 * half + 1]));
          }
        }
      }
    }

    // Z = Q V, Q = dG o G, V[j][u] = [j < u], summed down its columns over
    // t >= u
    for (int i = warp; i < kLowTiles; i += kWarps) {
      int mt, nt;
      low_tile(i, mt, nt);
      float acc[4];
      zero(acc);
      for (int k0 = 0; k0 <= 8 * nt; k0 += 8) {
        const float2 dg0 = ld2(dgs + (16 * mt + g) * SC + k0 + 2 * q);
        const float2 dg1 = ld2(dgs + (16 * mt + g + 8) * SC + k0 + 2 * q);
        const float2 g0 = ld2(gs + (16 * mt + g) * SC + k0 + 2 * q);
        const float2 g1 = ld2(gs + (16 * mt + g + 8) * SC + k0 + 2 * q);
        FragA fa;
        frag_a(fa, dg0.x * g0.x, dg1.x * g1.x, dg0.y * g0.y, dg1.y * g1.y);
        // V is 0 or 1, exact in TF32: its low terms are zero
        const int u = 8 * nt + g;
        uint32_t vb[2] = {k0 + 2 * q < u ? 0x3f800000u : 0u,
                          k0 + 2 * q + 1 < u ? 0x3f800000u : 0u};
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, fa.lo, vb);
        mma_tf32(part, fa.hi, vb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += part[e];
      }
      float colsum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mt + g + 8 * (e >> 1);
        const int u = 8 * nt + 2 * q + (e & 1);
        if (t >= u) colsum[e & 1] += acc[e];
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        colsum[0] += __shfl_xor_sync(kFull, colsum[0], off);
        colsum[1] += __shfl_xor_sync(kFull, colsum[1], off);
      }
      if (g == 0) {
        colz[mt * kC + 8 * nt + 2 * q] = colsum[0];
        colz[mt * kC + 8 * nt + 2 * q + 1] = colsum[1];
      }
    }

    // dC = diag(e^{cum}) dY S_in^T + dG B (warps 0-3) and dB = diag(w) X
    // dS_out^T + dG^T C (warps 4-7), row tile mt_c, kGroupNT n tiles at a
    // time (each k step's A fragment split once for them), with r's and
    // u's sums
    {
      const int r0 = 16 * mt_c;
      const float* op = is_dc ? dys : xs;         // dY or X
      const float* sg = is_dc ? sin_g : dso_g;    // S_in or dS_out
      const float* pair = is_dc ? cs : bs;        // c (for r) or b (for u)
      const float* other = is_dc ? bs : cs;       // B or C
      const float sc0 = is_dc ? rv.et[r0 + g] : rv.w[r0 + g];
      const float sc1 = is_dc ? rv.et[r0 + g + 8] : rv.w[r0 + g + 8];
      double rsum[2] = {0.0, 0.0};
#pragma unroll
      for (int ng = 0; ng < kNT; ng += kGroupNT) {
        float acc[kGroupNT][4];
        {
          // dY S_in^T or X dS_out^T on the float64 tensor cores: r and u,
          // differences of large sums in da, come out of these
          double y[kGroupNT][4];
#pragma unroll
          for (int i = 0; i < kGroupNT; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) y[i][e] = 0.0;
          }
#pragma unroll 2
          for (int k0 = 0; k0 < HD; k0 += 8) {
            const float2 u = ld2(op + (r0 + g) * SX + k0 + 2 * q);
            const float2 v = ld2(op + (r0 + g + 8) * SX + k0 + 2 * q);
#pragma unroll
            for (int i = 0; i < kGroupNT; ++i) {
              const float2 w = ld2(sg + (8 * (ng + i) + g) * HD + k0 + 2 * q);
              mma_f64(y[i], u.x, v.x, u.y, v.y, w.x, w.y);
            }
          }
#pragma unroll
          for (int i = 0; i < kGroupNT; ++i) {
            const int n = 8 * (ng + i) + 2 * q;
            const float2 p0 = ld2(pair + (r0 + g) * SN + n);
            const float2 p1 = ld2(pair + (r0 + g + 8) * SN + n);
            rsum[0] = fma(static_cast<double>(p0.x), y[i][0],
                          fma(static_cast<double>(p0.y), y[i][1], rsum[0]));
            rsum[1] = fma(static_cast<double>(p1.x), y[i][2],
                          fma(static_cast<double>(p1.y), y[i][3], rsum[1]));
            acc[i][0] = static_cast<float>(y[i][0]) * sc0;
            acc[i][1] = static_cast<float>(y[i][1]) * sc0;
            acc[i][2] = static_cast<float>(y[i][2]) * sc1;
            acc[i][3] = static_cast<float>(y[i][3]) * sc1;
          }
        }
        if (is_dc) {
          for (int k0 = 0; k0 < r0 + 16; k0 += 8) {
            FragA fa;
            frag_rows(fa, dgs, SC, r0, k0, g, q);
#pragma unroll
            for (int i = 0; i < kGroupNT; ++i) {
              FragB fb;
              frag_kmajor(fb, other, SN, k0, 8 * (ng + i), g, q);
              mma3_rn(acc[i], fa, fb);
            }
          }
        } else {
          for (int k0 = r0; k0 < kC; k0 += 8) {
            FragA fa;
            frag_cols(fa, dgs, SC, r0, k0, g, q);
#pragma unroll
            for (int i = 0; i < kGroupNT; ++i) {
              FragB fb;
              frag_kmajor(fb, other, SN, k0, 8 * (ng + i), g, q);
              mma3_rn(acc[i], fa, fb);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kGroupNT; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[ng + i][e] += acc[i][e];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rsum[0] += __shfl_xor_sync(kFull, rsum[0], off);
        rsum[1] += __shfl_xor_sync(kFull, rsum[1], off);
      }
      if (q == 0) {
        float* out = is_dc ? r_s : u_s;
        const float* f = is_dc ? rv.et : rv.ew;
        out[r0 + g] = f[r0 + g] * static_cast<float>(rsum[0]);
        out[r0 + g + 8] = f[r0 + g + 8] * static_cast<float>(rsum[1]);
      }
    }
    __syncthreads();      // colz, r, u

    // warp 0, two rows a lane: dlog_u = R_u + sum_{t >= u} r_t +
    // sum_{t < u} v_t + e^{cum_last} <S_in, dS_out>; ddt; da's and dd's parts
    if (warp == 0) {
      float es = 0.f, dd = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        es += red[w];
        dd += red[kWarps + w];
      }
      es *= *rv.elast;
      const int u0 = 2 * lane;
      float rect[2], colsum_p[2], rt[2], vt[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = u0 + i;
        float rz = 0.f, cp = 0.f;
        for (int mt = u / 16; mt < 4; ++mt) {
          rz += colz[mt * kC + u];
          cp += colp[mt * kC + u];
        }
        rect[i] = rz;
        colsum_p[i] = cp;
        rt[i] = r_s[u];
        vt[i] = rv.dt[u] * u_s[u];
      }
      // suffix sums of r over the lanes above, prefix sums of v below
      float suf = rt[0] + rt[1], pre = vt[0] + vt[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float s1 = __shfl_down_sync(kFull, suf, off);
        const float p1 = __shfl_up_sync(kFull, pre, off);
        if (lane + off < 32) suf += s1;
        if (lane >= off) pre += p1;
      }
      float suf_next = __shfl_down_sync(kFull, suf, 1);
      float pre_prev = __shfl_up_sync(kFull, pre, 1);
      if (lane == 31) suf_next = 0.f;
      if (lane == 0) pre_prev = 0.f;
      const float rsuf[2] = {rt[0] + (rt[1] + suf_next), rt[1] + suf_next};
      const float vpre[2] = {pre_prev, pre_prev + vt[0]};
      float da = 0.f;
      float* ddt = a.ddt + (k.bi * a.s + k.t0) * a.h + head;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = u0 + i;
        const float dlog = ((rect[i] + rsuf[i]) + vpre[i]) + es;
        if (u < k.n) ddt[u * a.h] = fmaf(a_h, dlog, colsum_p[i] + u_s[u]);
        da = fmaf(rv.dt[u], dlog, da);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        da += __shfl_xor_sync(kFull, da, off);
      }
      if (lane == 0) {
        const int64_t o = (k.bi * a.chunks + k.ci) * a.h + head;
        a.scal_part[o] = da;
        a.scal_part[a.bb * a.chunks * a.h + o] = dd;
      }
    }
  }
  // the group's parts of dC and dB, rows t < n
  float* part = (is_dc ? a.dc_part : a.db_part) +
                ((k.gi * a.bb + k.bi) * a.s + k.t0) * N;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 16 * mt_c + g + 8 * half;
      if (t < k.n) {
        *reinterpret_cast<float2*>(part + t * N + 8 * nt + 2 * q) =
            make_float2(pacc[nt][2 * half], pacc[nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (d) e < B S N: db and dc of row (b, t) = e / N, n = e % N, summed over the
// head groups in order; then e = B S N + h: da and dd of head h, summed
// over (b, chunk) in order

__global__ void __launch_bounds__(256)
    ssd_bwd_tc_sum_kernel(Args a, int64_t n, float* db, float* dc, float* da,
                          float* dd) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t rows = a.bb * a.s * n;
  if (e < rows) {
    float sb = 0.f, sc = 0.f;
    for (int64_t gi = 0; gi < a.groups; ++gi) {
      sb += a.db_part[gi * rows + e];
      sc += a.dc_part[gi * rows + e];
    }
    db[e] = sb;
    dc[e] = sc;
  } else if (e < rows + a.h) {
    const int64_t hh = e - rows;
    const int64_t parts = a.bb * a.chunks;
    float sa = 0.f, sd = 0.f;
    for (int64_t i = 0; i < parts; ++i) {
      sa += a.scal_part[i * a.h + hh];
      sd += a.scal_part[(parts + i) * a.h + hh];
    }
    da[hh] = sa;
    dd[hh] = sd;
  }
}

// ---------------------------------------------------------------------------
// launches

template <int N, int HD>
cudaError_t launch_states(const Args& a, cudaStream_t stream) {
  constexpr int smem = states_smem_bytes<N, HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tc_states_kernel<N, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_tc_states_kernel<N, HD>
      <<<static_cast<unsigned>(a.bb * a.chunks * a.groups), kThreads, smem,
         stream>>>(a);
  return cudaGetLastError();
}

template <int N, int HD>
cudaError_t launch_grad(const Args& a, cudaStream_t stream) {
  constexpr int smem = grad_smem_bytes<N, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tc_kernel<N, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_tc_kernel<N, HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ssd_bwd_tc_kernel<N, HD>
      <<<static_cast<unsigned>(a.bb * a.chunks * a.groups), kThreads, smem,
         stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t by_hd(bool grad, const Args& a, int64_t hd,
                  cudaStream_t stream) {
  switch (hd) {
    case 16: return grad ? launch_grad<N, 16>(a, stream)
                         : launch_states<N, 16>(a, stream);
    case 32: return grad ? launch_grad<N, 32>(a, stream)
                         : launch_states<N, 32>(a, stream);
    case 64: return grad ? launch_grad<N, 64>(a, stream)
                         : launch_states<N, 64>(a, stream);
    case 128: return grad ? launch_grad<N, 128>(a, stream)
                          : launch_states<N, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t by_size(bool grad, const Args& a, int64_t hd, int64_t n,
                    cudaStream_t stream) {
  switch (n) {
    case 16: return by_hd<16>(grad, a, hd, stream);
    case 32: return by_hd<32>(grad, a, hd, stream);
    case 64: return by_hd<64>(grad, a, hd, stream);
    case 128: return by_hd<128>(grad, a, hd, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_size(int64_t v) {
  return v == 16 || v == 32 || v == 64 || v == 128;
}

}  // namespace

// One entry point per kernel, each with every pointer and size of the call
// (ops.ssd_bwd allocates the outputs and the scratch): x, b, c, dt, a, d,
// s0, dy, ds; dx, ddt, ds0; s_in and ds_out (B H ceil(s / 64) n hd floats
// each), elast (B H ceil(s / 64)), db_part and dc_part (ceil(h / 16) B s n
// each), scal_part (2 B ceil(s / 64) h); db, dc, da, dd; B, S, H, hd, N,
// the strides of x, b, c and dt over batch and time; then which kernel: 0
// states, 1 the passes, 2 the gradients, 3 the sums.  s >= 1, B >= 1,
// H >= 1, hd and n each one of 16, 32, 64, 128.
extern "C" int rt_ssd_bwd_tc(const void* x, const void* b, const void* c,
                             const void* dt, const void* a, const void* d,
                             const void* s0, const void* dy, const void* ds,
                             void* dx, void* ddt, void* ds0, void* s_in,
                             void* ds_out, void* elast, void* db_part,
                             void* dc_part, void* scal_part, void* db,
                             void* dc, void* da, void* dd, int64_t bb,
                             int64_t s, int64_t h, int64_t hd, int64_t n,
                             int64_t x_sb, int64_t x_st, int64_t b_sb,
                             int64_t b_st, int64_t c_sb, int64_t c_st,
                             int64_t dt_sb, int64_t dt_st, int64_t which,
                             void* stream) {
  if (bb < 1 || s < 1 || h < 1 || !valid_size(hd) || !valid_size(n) ||
      which < 0 || which > 3) {
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
  args.s_in = static_cast<float*>(s_in);
  args.ds_out = static_cast<float*>(ds_out);
  args.elast = static_cast<float*>(elast);
  args.db_part = static_cast<float*>(db_part);
  args.dc_part = static_cast<float*>(dc_part);
  args.scal_part = static_cast<float*>(scal_part);
  args.bb = bb;
  args.s = s;
  args.h = h;
  args.chunks = (s + kC - 1) / kC;
  args.groups = (h + kHeads - 1) / kHeads;
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
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(dy);
  args.vec = ptrs % 16 == 0 &&
             (x_sb | x_st | b_sb | b_st | c_sb | c_st) % 4 == 0;
  if (bb * args.chunks * args.groups > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0 || which == 2) {
    return static_cast<int>(by_size(which == 2, args, hd, n, st));
  }
  if (which == 1) {
    const int64_t threads = bb * h * n * hd / 4;
    if ((threads + 255) / 256 > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ssd_bwd_tc_pass_kernel<<<dim3(static_cast<unsigned>((threads + 255) / 256),
                                  2),
                             256, 0, st>>>(args, n * hd);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t total = bb * s * n + h;
  if ((total + 255) / 256 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ssd_bwd_tc_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                          st>>>(args, n, static_cast<float*>(db),
                                static_cast<float*>(dc),
                                static_cast<float*>(da),
                                static_cast<float*>(dd));
  return static_cast<int>(cudaGetLastError());
}
