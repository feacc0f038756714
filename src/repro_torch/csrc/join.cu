// Hash-join kernels for Hopper (sm_90a): pack, probe, expand, gather.
//
// They replace the Pallas TPU kernels of repro/kernels/join/kernel.py:
//   pack    <- pack_keys_pallas    (_pack_kernel)
//   probe   <- probe_sorted_pallas (_probe_kernel)
//   expand  <- expand_pairs_pallas (_expand_kernel)
//   gather  <- gather_rows_pallas  (_gather_kernel)
//
// The TPU design was shaped by three gaps that Hopper does not have: no
// int64 (keys travelled as hi/lo 32-bit word pairs), no fast dynamic
// gather (probe and expand were O(n*m) broadcast compares over tiles) and
// a VMEM-resident gather table.  Here keys are native int64, and every
// kernel is one thread per output element: probe and expand run a binary
// search per thread (O(n log m)), gather reads the table straight from
// device memory.
//
// What bounds them on the card: all four move a few int64 words per
// element and do a handful of integer operations, so they are bound by
// memory bytes, not by operations.  Pack, gather and the writes of every
// kernel are coalesced (neighbouring threads touch neighbouring words);
// the binary searches of probe and expand read scattered words, whose
// first levels stay in L1/L2 because every thread walks the same upper
// levels of the sorted array.  Nothing more is done about it yet: this is
// the simple, exact first version.
//
// Every entry point launches on the stream it is given, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Base-2^31 positional packing of k key columns (column c at cols[c*n]):
// key = c0 * 2^31 + c1 for k == 2, exactly as the host reference computes
// it (the wrapper returns a single column as its own key, unlaunched).  Unsigned arithmetic keeps the (never reached for ids < 2^31)
// wrap-around defined, as numpy's int64 arithmetic wraps.
__global__ void pack_kernel(const int64_t* __restrict__ cols, int64_t n,
                            int k, int64_t* __restrict__ out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  uint64_t key = static_cast<uint64_t>(cols[i]);
  for (int c = 1; c < k; ++c) {
    key = key * (uint64_t(1) << 31) + static_cast<uint64_t>(cols[c * n + i]);
  }
  out[i] = static_cast<int64_t>(key);
}

// First index in [lo, m) whose value is >= key (right == false) or > key
// (right == true): numpy's searchsorted left / right.
__device__ __forceinline__ int64_t bisect(const int64_t* __restrict__ a,
                                          int64_t lo, int64_t m, int64_t key,
                                          bool right) {
  int64_t hi = m;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    const int64_t v = a[mid];
    const bool go = right ? (v <= key) : (v < key);
    if (go) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// For every probe key: lo = #build keys < key, counts = #build keys == key,
// over the ascending build side.
__global__ void probe_kernel(const int64_t* __restrict__ build, int64_t m,
                             const int64_t* __restrict__ probe, int64_t n,
                             int64_t* __restrict__ lo_out,
                             int64_t* __restrict__ counts_out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const int64_t key = probe[i];
  const int64_t lo = bisect(build, 0, m, key, false);
  const int64_t hi = bisect(build, lo, m, key, true);
  lo_out[i] = lo;
  counts_out[i] = hi - lo;
}

// Segmented ragged expansion: output slot j belongs to the last segment
// whose start is <= j (upper_bound(starts, j) - 1), which skips zero-count
// segments because they share their start with the segment after them.
__global__ void expand_kernel(const int64_t* __restrict__ starts,
                              const int64_t* __restrict__ lo, int64_t m,
                              int64_t total, int64_t* __restrict__ li,
                              int64_t* __restrict__ pos) {
  const int64_t j = thread_index();
  if (j >= total) return;
  const int64_t s = bisect(starts, 0, m, j, true) - 1;
  li[j] = s;
  pos[j] = lo[s] + (j - starts[s]);
}

// Masked gather: values[idx], and fill where idx lies outside [0, m).
__global__ void gather_kernel(const int64_t* __restrict__ values, int64_t m,
                              const int64_t* __restrict__ idx, int64_t n,
                              int64_t fill, int64_t* __restrict__ out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const int64_t t = idx[i];
  out[i] = (t >= 0 && t < m) ? values[t] : fill;
}

}  // namespace

extern "C" int rt_pack_keys(const int64_t* cols, int64_t n, int64_t k,
                            int64_t* out, void* stream) {
  if (n > 0) {
    pack_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        cols, n, static_cast<int>(k), out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_probe_sorted(const int64_t* build, int64_t m,
                               const int64_t* probe, int64_t n, int64_t* lo,
                               int64_t* counts, void* stream) {
  if (n > 0) {
    probe_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(build, m, probe, n,
                                                        lo, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_expand_pairs(const int64_t* starts, const int64_t* lo,
                               int64_t m, int64_t total, int64_t* li,
                               int64_t* pos, void* stream) {
  if (total > 0) {
    expand_kernel<<<blocks_for(total), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(starts, lo, m, total,
                                                         li, pos);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_gather_rows(const int64_t* values, int64_t m,
                              const int64_t* idx, int64_t n, int64_t fill,
                              int64_t* out, void* stream) {
  if (n > 0) {
    gather_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(values, m, idx, n,
                                                         fill, out);
  }
  return static_cast<int>(cudaGetLastError());
}
