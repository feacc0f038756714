// Packed-bitmap Jaccard distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel jaccard_distance_pallas (_jaccard_kernel)
// of repro/kernels/jaccard/kernel.py.  Input: (Q, W) and (K, W) bitmaps of
// 32-bit words (carried as int32 tensors, read here as the same bits);
// output: the (Q, K) float32 distance 1 - popc(a&b) / popc(a|b), and 0
// when both sets are empty.
//
// One thread per output element loops over the W words with the hardware
// popcount (__popc), where the TPU kernel ran a SWAR popcount over
// (BQ, BK, W) broadcast tiles in VMEM.  The work is tiny (the workload has
// tens of queries and a few words per bitmap), so the kernel is bound by
// its launch, not by bytes or operations; rows are read straight from
// device memory and stay in L1.
//
// The division and the subtraction are written as the round-to-nearest
// intrinsics, and the library is built without --use_fast_math: the
// result must be bitwise equal to the IEEE float32 arithmetic of the
// reference, because single-linkage HAC merges, and with them the layouts,
// change with one bit of a distance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void jaccard_kernel(const uint32_t* __restrict__ a, int64_t q,
                               const uint32_t* __restrict__ b, int64_t k,
                               int64_t w, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= q * k) return;
  const uint32_t* ra = a + (t / k) * w;
  const uint32_t* rb = b + (t % k) * w;
  int inter = 0;
  int uni = 0;
  for (int64_t x = 0; x < w; ++x) {
    const uint32_t u = ra[x];
    const uint32_t v = rb[x];
    inter += __popc(u & v);
    uni += __popc(u | v);
  }
  out[t] = uni > 0
               ? __fsub_rn(1.0f, __fdiv_rn(__int2float_rn(inter),
                                           __int2float_rn(uni)))
               : 0.0f;
}

}  // namespace

extern "C" int rt_jaccard_distance(const int32_t* a, int64_t q,
                                   const int32_t* b, int64_t k, int64_t w,
                                   float* out, void* stream) {
  const int64_t n = q * k;
  if (n > 0) {
    jaccard_kernel<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(a), q,
        reinterpret_cast<const uint32_t*>(b), k, w, out);
  }
  return static_cast<int>(cudaGetLastError());
}
