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
// memory bytes, not by operations.  Gather and the writes of every kernel
// are coalesced (neighbouring threads touch neighbouring words); the binary
// searches of probe and expand read scattered words, whose first levels
// stay in L1/L2 because every thread walks the same upper levels of the
// sorted array.
//
// Pack is compiled for two columns, the only packing the wrapper launches
// (one column is its own key).  The data it reads was just uploaded and
// sits in L2, so what bounds it is L2 traffic and the kernel's ramp, not
// device memory: at the main path's largest key (587,583 rows, 14.1 MB)
// it runs under its device-memory bound.  Each block takes 512 keys, each
// thread four of them, 128 apart, reading c1 and c0 as 8-byte words (each
// warp load covers 256 contiguous bytes, at any alignment and any n) and
// issuing all eight loads before its first store; a full block checks no
// bound.  That is the layout of PyTorch's own elementwise kernel for such
// a call.  Pairs of keys read and written as 16-byte words over a grid
// sized from the SM count were slower on the H100 at both parities of n
// (PERF.md): from L2, the 16-byte loads lost to the 8-byte ones.
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

constexpr int kPackThreads = 128;   // threads of a pack block
constexpr int kPackKeys = 4;        // keys a pack thread takes

// Base-2^31 positional packing of two key columns: key = hi * 2^31 + lo,
// exactly as the host reference computes it.  Unsigned arithmetic keeps the
// (never reached for ids < 2^31) wrap-around defined, as numpy's int64
// arithmetic wraps.
__device__ __forceinline__ int64_t pack2(int64_t hi, int64_t lo) {
  return static_cast<int64_t>(static_cast<uint64_t>(hi) *
                                  (uint64_t(1) << 31) +
                              static_cast<uint64_t>(lo));
}

// out[e] = pack2(c0[e], c1[e]) for e < n: block b takes keys
// [512 b, 512 b + 512), thread t the keys 512 b + t + 128 u, u < 4.
__global__ void __launch_bounds__(kPackThreads)
    pack2_kernel(const int64_t* __restrict__ c0,
                 const int64_t* __restrict__ c1, int64_t n,
                 int64_t* __restrict__ out) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kPackThreads *
                        kPackKeys;
  const int64_t base = first + threadIdx.x;
  int64_t hi[kPackKeys], lo[kPackKeys];
  if (first + kPackThreads * kPackKeys <= n) {     // a full block
#pragma unroll
    for (int u = 0; u < kPackKeys; ++u) {
      lo[u] = c1[base + u * kPackThreads];
      hi[u] = c0[base + u * kPackThreads];
    }
#pragma unroll
    for (int u = 0; u < kPackKeys; ++u) {
      out[base + u * kPackThreads] = pack2(hi[u], lo[u]);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kPackKeys; ++u) {
    const int64_t e = base + u * kPackThreads;
    if (e < n) {
      lo[u] = c1[e];
      hi[u] = c0[e];
    }
  }
#pragma unroll
  for (int u = 0; u < kPackKeys; ++u) {
    const int64_t e = base + u * kPackThreads;
    if (e < n) out[e] = pack2(hi[u], lo[u]);
  }
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

// k must be 2 (the wrapper returns one column as its own key); cols holds
// the two columns back to back
extern "C" int rt_pack_keys(const int64_t* cols, int64_t n, int64_t k,
                            int64_t* out, void* stream) {
  if (k != 2 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    constexpr int64_t per_block = kPackThreads * kPackKeys;
    pack2_kernel<<<static_cast<unsigned int>((n + per_block - 1) /
                                             per_block),
                   kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cols, cols + n, n, out);
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
