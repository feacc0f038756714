"""The Jaccard designs that were measured and not kept, beside the two kept.

    python3 scripts/jaccard_designs.py

Builds two other designs of the Jaccard distance kernel from the CUDA source
below with ``nvcc`` (into ``build/jaccard_designs/``) and holds each bitwise
against ``ops.distance_plain`` at the placement shapes (64 and 128 experts x
64 words), the KG round's shape (24 x 2 words) and two large shapes, then
times all four in turns (``chip_smoke.device_ms``, the profiler's device
time per call) beside the launch floor:

* ``row`` and ``tile``: the kernels of ``src/repro_torch/csrc/jaccard.cu``,
  through ``ops._run``;
* ``tile 8x16/4``: a tile kernel with an 8 x 16 output tile and four
  lanes a micro-tile (a quarter of the words each), 4-byte copies into one
  chunk buffer whose row stride is padded by 16 bytes against bank
  conflicts;
* ``mma``: one warp a 16 x 8 output tile on the tensor cores,
  ``mma.sync.m16n8k256 ... .b1.and.popc`` per 256 bits of the word axis,
  |A| and |B| from two more such products against an all-ones operand,
  every word read straight from device memory (no shared memory).

Needs a CUDA card; exits nonzero when a design disagrees with the plain
version.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float distance(int inter, int uni) {
  return uni > 0 ? __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(inter),
                                             __int2float_rn(uni)))
                 : 0.0f;
}

// 8 x 16 tile, 2 x 2 micro-tiles, 4 lanes a micro-tile (lane l: b-rows
// l % 8 and l % 8 + 8, 16-byte groups l / 8 + 4 i), chunks of 64 words
constexpr int kQ = 8, kK = 16, kChunk = 64, kStride = kChunk + 4;
constexpr int kRows = kQ + kK, kGroups = kChunk / 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(128)
tile_8x16(const uint32_t* __restrict__ a, int64_t q,
          const uint32_t* __restrict__ b, int64_t k, int64_t w,
          unsigned int tiles_k, float* __restrict__ out) {
  __shared__ __align__(16) uint32_t panel[kRows][kStride];
  __shared__ int count[kRows];
  const int64_t q0 = static_cast<int64_t>(blockIdx.x / tiles_k) * kQ;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x % tiles_k) * kK;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gk = lane & 7, s = lane >> 3, cg = t % kGroups, cr = t / kGroups;
  int rc[3] = {0, 0, 0}, i00 = 0, i01 = 0, i10 = 0, i11 = 0;
  for (int64_t x0 = 0; x0 < w; x0 += kChunk) {
    const int cw = static_cast<int>(w - x0 < kChunk ? w - x0 : kChunk);
    const int n4 = (cw + 3) >> 2;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 3; ++i) {     // 4-byte copies, zeros past cw
      const int r = cr + 8 * i;
      const int64_t row = r < kQ ? q0 + r : k0 + r - kQ;
      const int64_t n = r < kQ ? q : k;
      const uint32_t* src = (r < kQ ? a : b) + (row < n ? row : n - 1) * w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * cg + e;
        if (x < cw) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                       :: "r"(smem_addr(&panel[r][x])), "l"(src + x0 + x)
                       : "memory");
        } else {
          panel[r][x] = 0u;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (cg < n4) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            &panel[cr + 8 * i][4 * cg]);
        rc[i] += __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w);
      }
    }
    const uint4* a0 = reinterpret_cast<const uint4*>(panel[warp]);
    const uint4* a1 = reinterpret_cast<const uint4*>(panel[warp + 4]);
    const uint4* b0 = reinterpret_cast<const uint4*>(panel[kQ + gk]);
    const uint4* b1 = reinterpret_cast<const uint4*>(panel[kQ + 8 + gk]);
#pragma unroll
    for (int it = 0; it < kGroups / 4; ++it) {
      const int g = s + 4 * it;
      if (g < n4) {
        const uint4 u0 = a0[g], u1 = a1[g], v0 = b0[g], v1 = b1[g];
        i00 += __popc(u0.x & v0.x) + __popc(u0.y & v0.y) +
               __popc(u0.z & v0.z) + __popc(u0.w & v0.w);
        i01 += __popc(u0.x & v1.x) + __popc(u0.y & v1.y) +
               __popc(u0.z & v1.z) + __popc(u0.w & v1.w);
        i10 += __popc(u1.x & v0.x) + __popc(u1.y & v0.y) +
               __popc(u1.z & v0.z) + __popc(u1.w & v0.w);
        i11 += __popc(u1.x & v1.x) + __popc(u1.y & v1.y) +
               __popc(u1.z & v1.z) + __popc(u1.w & v1.w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int m = 1; m < kGroups; m <<= 1) {
      rc[i] += __shfl_xor_sync(0xffffffffu, rc[i], m);
    }
    if (cg == 0) count[cr + 8 * i] = rc[i];
  }
#pragma unroll
  for (int m = 8; m < 32; m <<= 1) {
    i00 += __shfl_xor_sync(0xffffffffu, i00, m);
    i01 += __shfl_xor_sync(0xffffffffu, i01, m);
    i10 += __shfl_xor_sync(0xffffffffu, i10, m);
    i11 += __shfl_xor_sync(0xffffffffu, i11, m);
  }
  __syncthreads();
  const int i = s >> 1, j = s & 1;
  const int inter = i ? (j ? i11 : i10) : (j ? i01 : i00);
  const int rq = warp + 4 * i, rk = gk + 8 * j;
  const int64_t row = q0 + rq, col = k0 + rk;
  if (row < q && col < k) {
    out[row * k + col] =
        distance(inter, count[rq] + (count[kQ + rk] - inter));
  }
}

__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one warp a 16 x 8 tile: lane (g, t) = (l / 4, l % 4) reads words t and
// 4 + t of each 8-word step of a-rows g, g + 8 and b-row g
__global__ void __launch_bounds__(32)
mma_16x8(const uint32_t* __restrict__ a, int64_t q,
         const uint32_t* __restrict__ b, int64_t k, int64_t w,
         unsigned int tiles_k, float* __restrict__ out) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / tiles_k) * 16;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % tiles_k) * 8;
  const int64_t r0 = m0 + g < q ? m0 + g : q - 1;
  const int64_t r1 = m0 + g + 8 < q ? m0 + g + 8 : q - 1;
  const int64_t c0 = n0 + g < k ? n0 + g : k - 1;
  const uint32_t *ra0 = a + r0 * w, *ra1 = a + r1 * w, *rb = b + c0 * w;
  int d[4] = {0, 0, 0, 0}, da[4] = {0, 0, 0, 0}, db[4] = {0, 0, 0, 0};
  const uint32_t ones = 0xffffffffu;
#pragma unroll 8
  for (int64_t kw = 0; kw < w; kw += 8) {
    const int64_t x0 = kw + t, x1 = kw + 4 + t;
    const uint32_t a0 = x0 < w ? __ldg(ra0 + x0) : 0u;
    const uint32_t a1 = x0 < w ? __ldg(ra1 + x0) : 0u;
    const uint32_t a2 = x1 < w ? __ldg(ra0 + x1) : 0u;
    const uint32_t a3 = x1 < w ? __ldg(ra1 + x1) : 0u;
    const uint32_t b0 = x0 < w ? __ldg(rb + x0) : 0u;
    const uint32_t b1 = x1 < w ? __ldg(rb + x1) : 0u;
    mma_and_popc(d, a0, a1, a2, a3, b0, b1);
    mma_and_popc(da, a0, a1, a2, a3, ones, ones);
    mma_and_popc(db, ones, ones, ones, ones, b0, b1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + g + 8 * (i >> 1), col = n0 + 2 * t + (i & 1);
    if (row < q && col < k) {
      out[row * k + col] = distance(d[i], da[i] + (db[i] - d[i]));
    }
  }
}

}  // namespace

extern "C" int run_design(int64_t design, const int32_t* a, int64_t q,
                          const int32_t* b, int64_t k, int64_t w, float* out,
                          void* stream) {
  const int tq = design == 0 ? 8 : 16, tk = design == 0 ? 16 : 8;
  const int64_t tiles_k = (k + tk - 1) / tk;
  const unsigned blocks = static_cast<unsigned>((q + tq - 1) / tq * tiles_k);
  auto s = static_cast<cudaStream_t>(stream);
  auto A = reinterpret_cast<const uint32_t*>(a);
  auto B = reinterpret_cast<const uint32_t*>(b);
  if (design == 0) {
    tile_8x16<<<blocks, 128, 0, s>>>(A, q, B, k, w, tiles_k, out);
  } else {
    mma_16x8<<<blocks, 32, 0, s>>>(A, q, B, k, w, tiles_k, out);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

SHAPES = ((64, 64), (128, 64), (24, 2), (512, 64), (1024, 256))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.jaccard import ops as jac

    if not torch.cuda.is_available():
        print("jaccard_designs: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "jaccard_designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "designs.cu").write_text(SOURCE)
    lib_path = out_dir / "designs.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(out_dir / "designs.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.run_design.argtypes = [i64, p, i64, p, i64, i64, p, p]
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(27)
    one = torch.empty(1, dtype=torch.int64, device="cuda")
    floor_ms = cs.device_ms(lambda: one.fill_(1))

    def other(design, a):
        q, w = a.shape
        out = torch.empty((q, q), device="cuda")
        code = lib.run_design(design, a.data_ptr(), q, a.data_ptr(), q, w,
                              out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out

    designs = {"row": lambda a: jac._run("row", a, a),
               "tile": lambda a: jac._run("tile", a, a),
               "tile 8x16/4": lambda a: other(0, a),
               "mma": lambda a: other(1, a)}
    for q, w in SHAPES:
        a = cs._bitmap_words(gen, q, w)
        want = jac.distance_plain(a, a)
        for name, fn in designs.items():
            cs._jaccard_bitwise(f"{name} at {(q, w)}", fn(a), want)
        del want
        got = {name: [] for name in designs}
        for name in list(designs) + list(designs)[::-1]:
            got[name].append(cs.device_ms(lambda: designs[name](a)))
        cs.log(f"[designs] Q={q} W={w}: device ms per call in turns "
               + "; ".join(f"{n} " + ", ".join(f"{x:.5f}" for x in v)
                           for n, v in got.items())
               + f"; launch floor {floor_ms:.5f}; {cs.card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
