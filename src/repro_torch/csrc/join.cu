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
// a VMEM-resident gather table.  Here keys are native int64, probe and
// expand search instead of comparing everything with everything, and
// gather reads the table straight from device memory.
//
// What bounds them on the card:
//   pack, gather  bytes: a few int64 words an element, coalesced, one
//                 thread per element;
//   probe         the latency of dependent round trips, not bytes, while
//                 the probe side is small: a search's loads each wait for
//                 the one before.  G lanes serve a key and search k-ary,
//                 so a round narrows by G + 1 rather than 2, and both
//                 bounds narrow in the same rounds.  A large probe side
//                 keeps the card busy: one lane a key;
//   expand        its stores, once no output searches for itself: the
//                 merge of output slots and segment starts is cut into
//                 equal tiles, one search a tile, and each thread walks its
//                 few items in order.
// The k-ary search and both kernels are described where they are defined.
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

#include <climits>
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

// ---------------------------------------------------------------------------
// The cooperative k-ary search shared by probe and expand.
//
// A group of G lanes (G a power of two up to 32, its lanes one aligned slice
// of a warp) counts, over an ascending sequence v(0), ..., v(n - 1), how many
// values lie below each of two keys: r0 = #{s : v(s) < k0} (<= k0 where le0)
// and r1 likewise for k1.  Each count's answer lies in an interval [l, l + w];
// a round loads the G splitters l + floor((g + 1) w / (G + 1)), g < G, one a
// lane, all in one round trip, and a ballot of the predicate (true on a
// prefix of the lanes, since the splitters ascend) narrows the interval to
// at most floor(w / (G + 1)): floor(log_{G+1} n) + 1 rounds in all, against
// the 2 log2 n dependent loads of two bisections.  Both counts narrow in the
// same rounds; while their intervals agree a lane's two splitters are one
// load, and where they part a lane issues both loads before either ballot.
// ---------------------------------------------------------------------------

// The cut points of an interval of width w into G + 1 parts:
// cut(c) = floor(c * w / (G + 1)) for 0 <= c <= G + 1, from one division
// of w a round (c * r is below (G + 1)^2, so its division is a 32-bit one).
// I is the position type: unsigned 32-bit where n < 2^31, whose division by
// a constant costs a fraction of a 64-bit one on the dependent chain of
// each round, else signed 64-bit.
template <int G, typename I>
struct KaryCuts {
  I q;
  unsigned r;
  __device__ __forceinline__ explicit KaryCuts(I w)
      : q(w / (G + 1)), r(static_cast<unsigned>(w - q * (G + 1))) {}
  __device__ __forceinline__ I operator()(int c) const {
    return static_cast<I>(c) * q +
           static_cast<I>(static_cast<unsigned>(c) * r / (G + 1));
  }
};

// The interval [l, l + w] after a round in which c of the G splitters met
// the predicate: (splitter c - 1, splitter c], splitter -1 standing for
// l - 1 and splitter G for l + w.
template <int G, typename I>
__device__ __forceinline__ void kary_narrow(const KaryCuts<G, I>& cut, I& l,
                                            I& w, int c) {
  const I lo = c == 0 ? l : l + cut(c) + 1;
  const I hi = l + cut(c + 1);
  l = lo;
  w = hi - lo;
}

// Two bisections of [0, n) in one loop, for a group of one lane: the
// splitter of [l, h) is (l + h) / 2, both bounds share a load while their
// splitters agree, and where they part both loads issue before either
// compare.
template <typename I, typename Seq>
__device__ __forceinline__ void bisect_bounds(const Seq& v, I n, int64_t k0,
                                              bool le0, int64_t k1, bool le1,
                                              I& r0, I& r1) {
  I l0 = 0, h0 = n, l1 = 0, h1 = n;
  while (l0 < h0 || l1 < h1) {
    const bool open0 = l0 < h0, open1 = l1 < h1;
    const I p0 = (l0 + h0) >> 1, p1 = (l1 + h1) >> 1;
    const bool load1 = open1 && !(open0 && p1 == p0);
    int64_t v0 = 0, v1 = 0;
    if (open0) v0 = v(static_cast<int64_t>(p0));
    if (load1) v1 = v(static_cast<int64_t>(p1));
    if (open1 && !load1) v1 = v0;
    if (open0) {
      if (le0 ? v0 <= k0 : v0 < k0) {
        l0 = p0 + 1;
      } else {
        h0 = p0;
      }
    }
    if (open1) {
      if (le1 ? v1 <= k1 : v1 < k1) {
        l1 = p1 + 1;
      } else {
        h1 = p1;
      }
    }
  }
  r0 = l0;
  r1 = l1;
}

// This thread's group's bits of a ballot of the whole warp, shifted down
// to bit 0 (base: the group's first lane).
template <int G>
__device__ __forceinline__ unsigned group_bits(unsigned ballot, int base) {
  if constexpr (G == 32) {
    return ballot;
  } else {
    return (ballot >> base) & ((1u << G) - 1u);
  }
}

// The rounds of G lanes, G >= 2.  Every lane of the warp runs them
// together, so the warp stays converged: each round is one pass for all of
// its groups, with the ballots and the loop test over the whole warp (a
// warp whose groups each looped and balloted on their own ran them one
// after another on the card).
template <int G, typename I, typename Seq>
__device__ __forceinline__ void kary_rounds(const Seq& v, I n, int64_t k0,
                                            bool le0, int64_t k1, bool le1,
                                            I& r0, I& r1) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int base = lane & ~(G - 1);     // the group's first lane
  const int g = lane - base;            // this lane's splitter
  I l0 = 0, w0 = n, l1 = 0, w1 = n;
  while (__any_sync(0xffffffffu, (w0 | w1) != 0)) {
    const bool open0 = w0 > 0, open1 = w1 > 0;
    const KaryCuts<G, I> cut0(w0), cut1(w1);
    const I p0 = l0 + cut0(g + 1);
    const I p1 = l1 + cut1(g + 1);
    const bool load1 = open1 && !(open0 && p1 == p0);
    int64_t v0 = 0, v1 = 0;
    if (open0) v0 = v(static_cast<int64_t>(p0));
    if (load1) v1 = v(static_cast<int64_t>(p1));
    if (open1 && !load1) v1 = v0;
    const bool t0 = open0 && (le0 ? v0 <= k0 : v0 < k0);
    const bool t1 = open1 && (le1 ? v1 <= k1 : v1 < k1);
    const int c0 = __popc(group_bits<G>(__ballot_sync(0xffffffffu, t0), base));
    const int c1 = __popc(group_bits<G>(__ballot_sync(0xffffffffu, t1), base));
    if (open0) kary_narrow<G, I>(cut0, l0, w0, c0);
    if (open1) kary_narrow<G, I>(cut1, l1, w1, c1);
  }
  r0 = l0;
  r1 = l1;
}

// The search: G lanes (one for G = 1: a plain pair of bisections) over n
// values, with 32-bit positions where n allows.  For G >= 2 every lane of
// the warp must call it; a lane that is not live (past the end of its
// kernel's work) counts nothing.
template <int G, typename Seq>
__device__ __forceinline__ void kary_counts(const Seq& v, int64_t n,
                                            int64_t k0, bool le0, int64_t k1,
                                            bool le1, bool live,
                                            int64_t& r0, int64_t& r1) {
  const int64_t w = live ? n : 0;
  if (n <= INT32_MAX) {
    uint32_t a0, a1;
    if constexpr (G == 1) {
      bisect_bounds<uint32_t>(v, static_cast<uint32_t>(w), k0, le0, k1, le1,
                              a0, a1);
    } else {
      kary_rounds<G, uint32_t>(v, static_cast<uint32_t>(w), k0, le0, k1, le1,
                               a0, a1);
    }
    r0 = a0;
    r1 = a1;
  } else if constexpr (G == 1) {
    bisect_bounds<int64_t>(v, w, k0, le0, k1, le1, r0, r1);
  } else {
    kary_rounds<G, int64_t>(v, w, k0, le0, k1, le1, r0, r1);
  }
}

// The sorted build keys.
struct Keys {
  const int64_t* __restrict__ a;
  __device__ __forceinline__ int64_t operator()(int64_t s) const {
    return a[s];
  }
};

// The merge path's diagonal of segment start s: starts[s] + s, strictly
// ascending.  #{s : starts[s] + s < d} is the number of segment starts
// among the first d items of the merge of output slots and starts.
struct Diagonals {
  const int64_t* __restrict__ starts;
  __device__ __forceinline__ int64_t operator()(int64_t s) const {
    return starts[s] + s;
  }
};

// ---------------------------------------------------------------------------
// probe: for every probe key, lo = #build keys < key and counts = #build
// keys == key, over the ascending build side.
//
// What bounds it on this card is latency, not bytes, while the probe side
// is small: at the main path's largest join (203 probe keys over 36,191
// build keys) the bytes take 17 ns, while one thread per key ran two
// bisections, 32 dependent loads, in one block.  Here G lanes serve a key
// and the two bounds narrow together: 4 rounds at that shape, each one
// round trip to L2.  G lanes load G times what one lane loads, so once the
// card is busy the search is bound by its loads and instructions instead:
// ops.probe_group gives 32 lanes while n * 32 threads leave the card
// nearly empty, fewer as n grows, and 1 (a plain pair of bisections) from
// about 17,000 keys on.
// ---------------------------------------------------------------------------

constexpr int kProbeThreads = 128;  // threads of a probe block

template <int G>
__global__ void __launch_bounds__(kProbeThreads)
    probe_kernel(const int64_t* __restrict__ build, int64_t m,
                 const int64_t* __restrict__ probe, int64_t n,
                 int64_t* __restrict__ lo_out,
                 int64_t* __restrict__ counts_out) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kProbeThreads + threadIdx.x;
  if ((t & ~int64_t{31}) / G >= n) return;     // the whole warp at once
  const int64_t i = t / G;
  const bool live = i < n;
  const int64_t key = live ? probe[i] : 0;
  int64_t lo, hi;
  kary_counts<G>(Keys{build}, m, key, false, key, true, live, lo, hi);
  if (live && (threadIdx.x & (G - 1)) == 0) {
    lo_out[i] = lo;
    counts_out[i] = hi - lo;
  }
}

// ---------------------------------------------------------------------------
// expand: segmented ragged expansion.  Output slot j belongs to the last
// segment whose start is <= j (upper_bound(starts, j) - 1), which skips
// zero-count segments because they share their start with the segment
// after them; pos[j] = lo[s] + (j - starts[s]).
//
// What bounds it on this card is its stores, 16 bytes an output, once no
// output searches for itself: a search per output puts ~10 dependent loads
// in front of each pair of stores.  Here the output slots [0, total) and the
// segment starts are two sorted lists whose merge (a start equal to j
// before j) is cut into tiles of kExpandTile items, one a block ("merge
// path", the load-balanced search): zero-count segments take up items too,
// so a run of empty segments spreads over blocks like any other work.
//
// A block first finds the tile's two ends, the number of starts before
// each, in one cooperative search.  Where there are at most kExpandThreads
// segments, the search is one round in which every segment is a splitter:
// thread x loads start x and lo[x] (staging them in shared memory in the
// same round trip) and two block-wide counts of the predicate give both
// ends.  Otherwise warp 0 searches k-ary (kary_counts, both ends in the
// same rounds) and the block then stages the tile's starts and lo - start.
// A tile holding no segment start writes its outputs at once; otherwise
// every thread finds its own kExpandItems items with a bisection in shared
// memory, walks them in order and notes each output's segment there, and
// the block then writes li and pos with neighbouring threads on
// neighbouring slots.  Small tiles suit this card: the stores of many
// blocks hide the short chain in front of each block's first store.
// ---------------------------------------------------------------------------

constexpr int kExpandThreads = 256;  // threads of an expand block
constexpr int kExpandItems = 3;      // merge items a thread walks (odd: the
                                     // walk's shared stores do not conflict)
constexpr int kExpandTile = kExpandThreads * kExpandItems;   // 768 items

__global__ void __launch_bounds__(kExpandThreads)
    expand_kernel(const int64_t* __restrict__ starts,
                  const int64_t* __restrict__ lo, int64_t m, int64_t total,
                  int64_t* __restrict__ li, int64_t* __restrict__ pos) {
  __shared__ int64_t sst[kExpandTile + 1];   // segment starts
  __shared__ int64_t soff[kExpandTile + 1];  // lo - start, a segment later
  __shared__ int32_t seg[kExpandTile];       // per output: its segment - k0 + 1
  __shared__ int64_t ends[2];
  const int64_t items = total + m;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kExpandTile;
  const int64_t d1 = d0 + kExpandTile < items ? d0 + kExpandTile : items;
  // st[x] = starts[k0 + x] for x < ns; off[x] = lo - start of segment
  // k0 - 1 + x for x <= ns
  const int64_t* st;
  const int64_t* off;
  int64_t k0;
  int ns;
  if (m <= kExpandThreads) {
    const int x = static_cast<int>(threadIdx.x);
    int64_t diagonal = INT64_MAX;
    if (x < m) {
      const int64_t a = starts[x];
      sst[x] = a;
      soff[x + 1] = static_cast<int64_t>(static_cast<uint64_t>(lo[x]) -
                                         static_cast<uint64_t>(a));
      diagonal = a + x;
    }
    k0 = __syncthreads_count(diagonal < d0);   // also publishes sst, soff
    ns = __syncthreads_count(diagonal < d1) - static_cast<int>(k0);
    st = sst + k0;
    off = soff + k0;
  } else {
    if (threadIdx.x < 32) {
      int64_t e0, e1;
      kary_counts<32>(Diagonals{starts}, m, d0, false, d1, false, true, e0,
                      e1);
      if (threadIdx.x == 0) {
        ends[0] = e0;
        ends[1] = e1;
      }
    }
    __syncthreads();
    k0 = ends[0];
    ns = static_cast<int>(ends[1] - k0);
    for (int x = threadIdx.x; x <= ns; x += kExpandThreads) {
      if (x < ns) sst[x] = starts[k0 + x];
      const int64_t s = k0 - 1 + x;
      if (s >= 0) {
        soff[x] = static_cast<int64_t>(static_cast<uint64_t>(lo[s]) -
                                       static_cast<uint64_t>(starts[s]));
      }
    }
    __syncthreads();
    st = sst;
    off = soff;
  }
  const int64_t i0 = d0 - k0;                   // the tile's first output
  const int len = static_cast<int>(d1 - d0);
  const int no = len - ns;                      // its outputs
  if (ns == 0) {                                // all of segment k0 - 1
    const uint64_t o = static_cast<uint64_t>(off[0]);
    for (int x = threadIdx.x; x < no; x += kExpandThreads) {
      li[i0 + x] = k0 - 1;
      pos[i0 + x] = static_cast<int64_t>(o + static_cast<uint64_t>(i0 + x));
    }
    return;
  }
  // this thread's items: tile items [dt, dt + kExpandItems); k starts of the
  // tile come before item dt
  const int dt = min(static_cast<int>(threadIdx.x) * kExpandItems, len);
  int a = 0, b = ns;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (st[mid] + (k0 + mid) < d0 + dt) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  int k = a;
  int64_t j = i0 + (dt - k);
  const int stop = min(dt + kExpandItems, len);
  for (int d = dt; d < stop; ++d) {
    if (k < ns && st[k] <= j) {
      ++k;                                 // segment k0 + k - 1 starts
    } else {
      seg[j - i0] = k;                     // output j, of segment k0 + k - 1
      ++j;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < no; x += kExpandThreads) {
    const int s = seg[x];
    li[i0 + x] = k0 - 1 + s;
    pos[i0 + x] = static_cast<int64_t>(static_cast<uint64_t>(off[s]) +
                                       static_cast<uint64_t>(i0 + x));
  }
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

// group: the lanes a probe key takes, a power of two up to 32
// (ops.probe_group)
extern "C" int rt_probe_sorted(const int64_t* build, int64_t m,
                               const int64_t* probe, int64_t n, int64_t group,
                               int64_t* lo, int64_t* counts, void* stream) {
  if (n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned int blocks = static_cast<unsigned int>(
        (n * group + kProbeThreads - 1) / kProbeThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (group) {
      case 1:
        probe_kernel<1><<<blocks, kProbeThreads, 0, s>>>(build, m, probe, n,
                                                         lo, counts);
        break;
      case 2:
        probe_kernel<2><<<blocks, kProbeThreads, 0, s>>>(build, m, probe, n,
                                                         lo, counts);
        break;
      case 4:
        probe_kernel<4><<<blocks, kProbeThreads, 0, s>>>(build, m, probe, n,
                                                         lo, counts);
        break;
      case 8:
        probe_kernel<8><<<blocks, kProbeThreads, 0, s>>>(build, m, probe, n,
                                                         lo, counts);
        break;
      case 16:
        probe_kernel<16><<<blocks, kProbeThreads, 0, s>>>(build, m, probe, n,
                                                          lo, counts);
        break;
      case 32:
        probe_kernel<32><<<blocks, kProbeThreads, 0, s>>>(build, m, probe, n,
                                                          lo, counts);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// m: the number of segments (at least 1 where total > 0); starts the
// exclusive cumsum of the counts; tile must be kExpandTile (ops.EXPAND_TILE)
extern "C" int rt_expand_pairs(const int64_t* starts, const int64_t* lo,
                               int64_t m, int64_t total, int64_t tile,
                               int64_t* li, int64_t* pos, void* stream) {
  if (tile != kExpandTile || total < 0 || m < 0 || (total > 0 && m == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const unsigned int blocks = static_cast<unsigned int>(
        (total + m + kExpandTile - 1) / kExpandTile);
    expand_kernel<<<blocks, kExpandThreads, 0,
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
