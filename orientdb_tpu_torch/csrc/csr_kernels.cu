// Hand-written Hopper (sm_90a) kernels for the CSR primitives of the
// compiled MATCH path, the bitmap BFS of variable-depth and NOT arms, the
// result stage of a captured replay, the page of a batch's rows group, the
// interpreter of a compiled WHERE program, the delta path (the in-place
// patch scatter and the two append-slab expansions), the tier plane's
// paged hop, cold-miss flag and paged gather, and the mesh's per-shard
// expansion totals and gather, row-sharded CSR hop, weight pass and
// row-sharded BFS hop.
// Port of the jitted functions of
// orientdb_tpu/ops/csr.py (the OPTIONAL arm's rows_with_matches among them)
// and of the level emission, level step, front-pack,
// meta, page, group-page and slab-expansion functions of
// orientdb_tpu/exec/tpu_engine.py and of DeviceGraph.apply_patches in
// orientdb_tpu/ops/device_graph.py and of paged_hop / paged_hop_miss /
// paged_expand in orientdb_tpu/storage/tiering.py and of the shard_map
// kernels of orientdb_tpu/parallel/mesh_graph.py and
// orientdb_tpu/parallel/sharded.py; the wrappers
// are in orientdb_tpu_torch/ops/csr.py and bind these functions through
// ctypes (orientdb_tpu_torch/ops/_kernels.py).
//
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libcsr_kernels.so csr_kernels.cu
//
// Interface: plain C. Every pointer and the stream arrive as void*; sizes as
// long long. Each entry point launches on the caller's stream, allocates
// nothing (the wrapper passes every output and scratch buffer) and returns
// cudaGetLastError() so that a refused launch reaches the wrapper.
//
// Every kernel here moves a few bytes per element and does one or two
// integer operations on them, so each is bound by device-memory bytes
// (3.35 TB/s on an H100 SXM), never by arithmetic. The designs are the
// simple correct ones: coalesced loads, one pass per output where the
// algorithm allows it, no atomics where the order of a float sum matters
// (K1's float32 form, which runs only while recording, adds its tile
// prefixes in the order its look-back finds them).
// int32 sums are taken in uint32 so that overflow wraps modulo 2^32 as the
// reference's int32 arithmetic does (signed overflow is undefined in C++).

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

inline unsigned blocks_for(long long n, long long per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// ---------------------------------------------------------------------------
// K1: inclusive / exclusive prefix sum (replaces csr.value_cumsum :129,
// csr.mask_cumsum :97, csr._block_scan_f32 :118, csr.exclusive_cumsum :47).
//
// Bound: n*4 bytes read + n*4 bytes written (80M int32: 640 MB, ~0.19 ms).
// Design: a single-pass scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA,
// 2016): one launch that reads every element once and writes it once,
// after one cudaMemsetAsync of the look-back state on the same stream (a
// captured graph replays it as a memset node). Each block takes its tile
// from an atomic counter in that state, so it only ever waits on a tile
// that a running or finished block holds (spinning on blockIdx.x - 1 can
// deadlock when the predecessor is not resident). A warp loads its part of
// the tile warp-striped with 16-byte loads (kScanVecs of them a thread,
// 4 elements each: a tile of 16,384, which measured fastest of 4,096,
// 8,192 and 16,384 at 80M elements, PERF.md §6: fewer tiles, a shorter
// look-back chain), scans it in registers and shuffles, and the block adds
// its warps' sums in shared memory. Thread 0 publishes the tile's aggregate, warp 0
// looks back 32 predecessor words at a time for the nearest inclusive
// prefix and publishes the tile's own; each word is 64 bits, the status in
// the high half and the value's bits in the low half, stored with release
// and loaded with acquire semantics. Forms: inclusive or exclusive; an
// optional device total written by the last tile; no output at all (the
// total alone: a sum in one read). int32 sums are taken in uint32 and wrap modulo 2^32 as the
// reference's do; a float32 tile prefix adds the predecessors in whatever
// order the look-back finds them (a tile's own sum has a fixed order). The
// TPU version's triangular matmul on 16-bit halves was a way to use the
// systolic array; int32 adds are exact here, so only its result is ported.
// ---------------------------------------------------------------------------

constexpr int kScanVecs = 16;  // K1's 16-byte loads a thread
constexpr long long kScanTile = kThreads * 4LL * kScanVecs;
constexpr int kCompactVecs = 4;  // K3's 16-byte mask loads a thread
constexpr long long kCompactTile = kThreads * 16LL * kCompactVecs;

// A look-back word's status (its high half). The entry point sets the
// state to 0xFF bytes before the launch, so an all-ones status is "not published
// yet", and the tile counter (the state's first word) starts at 0xFFFFFFFF:
// the first block to add one holds tile 0.
constexpr unsigned kLbEmpty = 0xffffffffu;
constexpr unsigned kLbAggregate = 1u;
constexpr unsigned kLbPrefix = 2u;

__device__ __forceinline__ unsigned lb_bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned lb_bits(float v) { return __float_as_uint(v); }
template <typename T>
__device__ __forceinline__ T lb_value(unsigned bits);
template <>
__device__ __forceinline__ unsigned lb_value<unsigned>(unsigned bits) { return bits; }
template <>
__device__ __forceinline__ float lb_value<float>(unsigned bits) { return __uint_as_float(bits); }

__device__ __forceinline__ void lb_publish(unsigned long long* word, unsigned status,
                                           unsigned bits) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> w(*word);
  w.store((static_cast<unsigned long long>(status) << 32) | bits, cuda::memory_order_release);
}

__device__ __forceinline__ unsigned long long lb_load(unsigned long long* word) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> w(*word);
  return w.load(cuda::memory_order_acquire);
}

// A tile's status word (K17's look-back by tile), published by one thread
// after a barrier behind the block's writes of its counts: the fence makes
// them visible device-wide first (the pattern of a grid barrier), so no
// other thread of the block pays for a fence. Loaded with acquire before
// the counts are read.
__device__ __forceinline__ void tile_publish(unsigned* word, unsigned status) {
  __threadfence();
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> w(*word);
  w.store(status, cuda::memory_order_release);
}

__device__ __forceinline__ unsigned tile_status(unsigned* word) {
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> w(*word);
  return w.load(cuda::memory_order_acquire);
}

// The block's tile, from the counter in state[0]; every thread gets it.
__device__ __forceinline__ unsigned lb_tile(unsigned long long* state, unsigned* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(reinterpret_cast<unsigned*>(state), 1u) + 1u;
  __syncthreads();
  return *slot;
}

// Run by warp 0 of the block that holds `tile` (> 0) after thread 0 has
// published the tile's aggregate: the sum of every tile before it, found by
// looking back 32 predecessor words at a time until one holds an inclusive
// prefix (tile 0's always does). Publishes the tile's inclusive prefix and
// returns the exclusive one, in every lane. (Reading 4 or 8 words a lane
// a step measured slower at 80M elements.)
template <typename T>
__device__ T lb_look_back(unsigned long long* flags, unsigned tile, T aggregate) {
  const int lane = threadIdx.x & 31;
  T run = T(0);
  long long pred = static_cast<long long>(tile) - 1 - lane;  // lane 0 the nearest
  for (;;) {
    unsigned long long w = 0;
    unsigned st = kLbPrefix;  // before tile 0: a zero prefix
    do {
      if (pred >= 0) {
        w = lb_load(flags + pred);
        st = static_cast<unsigned>(w >> 32);
      }
    } while (__any_sync(kFull, st == kLbEmpty));
    const unsigned prefixes = __ballot_sync(kFull, st == kLbPrefix);
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;  // the nearest prefix
    T v = lane <= last ? lb_value<T>(static_cast<unsigned>(w)) : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    run += __shfl_sync(kFull, v, 0);
    if (prefixes) break;
    pred -= 32;
  }
  if (lane == 0) lb_publish(flags + tile, kLbPrefix, lb_bits(run + aggregate));
  return run;
}

// A tile's warp scan. Warp w owns elements [w*32*I, (w+1)*32*I) of the tile
// (I = kVec*VECS items a thread); load v of lane l covers the kVec elements
// from (v*32 + l)*kVec there, so each load instruction of a warp reads 512
// contiguous bytes. In the tile's order (v, l, j) precedes (v', l', j')
// when it is lexicographically smaller. Returns the warp's sum; base[v] is
// the sum of the warp's elements before lane l's load v.
template <typename T, int VECS, int kVec>
__device__ __forceinline__ T warp_striped_scan(const T (&x)[VECS][kVec], T (&base)[VECS]) {
  const int lane = threadIdx.x & 31;
  T warp_run = T(0);
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    T s = T(0);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += x[v][j];
    T incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    T excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = T(0);
    base[v] = warp_run + excl;
    warp_run += __shfl_sync(kFull, incl, 31);
  }
  return warp_run;
}

// The block's part of a look-back pass, after every warp has its sum:
// the warps before this one (warp_off), and the exclusive prefix of the
// tile (from the look-back), which the last tile also adds to its own
// aggregate into `total` (when given). `s_warp` and `s_prefix` are the
// caller's shared memory.
template <typename T>
__device__ __forceinline__ T tile_prefix(unsigned long long* state, unsigned tile,
                                         long long tiles, T warp_sum, T* s_warp, T* s_prefix,
                                         T* total, T& warp_off) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = warp_sum;
  __syncthreads();
  T aggregate = T(0);
  warp_off = T(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) warp_off += s_warp[w];
    aggregate += s_warp[w];
  }
  if (warp == 0) {
    T prefix = T(0);
    if (tile == 0) {
      if (lane == 0) lb_publish(state + 1, kLbPrefix, lb_bits(aggregate));
    } else {
      if (lane == 0) lb_publish(state + 1 + tile, kLbAggregate, lb_bits(aggregate));
      prefix = lb_look_back<T>(state + 1, tile, aggregate);
    }
    if (lane == 0) {
      *s_prefix = prefix;
      if (total != nullptr && tile == tiles - 1) *total = prefix + aggregate;
    }
  }
  __syncthreads();
  return *s_prefix;
}

// Writes a warp's part of a scanned tile in warp_striped_scan's layout (4
// elements a load): `start` is the sum of every element before the warp's,
// base[v] that of the warp's elements before lane l's load v; 16-byte
// stores where the output is aligned.
template <typename T, int VECS>
__device__ __forceinline__ void store_scanned(T* __restrict__ out, long long n, long long wbase,
                                              T start, const T (&x)[VECS][4],
                                              const T (&base)[VECS], int exclusive, int vec_ok) {
  constexpr int kVec = 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const long long e0 = wbase + static_cast<long long>(v * 32 + lane) * kVec;
    T acc = start + base[v];
    T y[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (exclusive) {
        y[j] = acc;
        acc += x[v][j];
      } else {
        acc += x[v][j];
        y[j] = acc;
      }
    }
    if (vec_ok && e0 + kVec <= n) {
      *reinterpret_cast<uint4*>(out + e0) =
          make_uint4(lb_bits(y[0]), lb_bits(y[1]), lb_bits(y[2]), lb_bits(y[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (e0 + j < n) out[e0 + j] = y[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_lookback_kernel(const T* __restrict__ in, T* __restrict__ out, T* __restrict__ total,
                     long long n, unsigned long long* __restrict__ state, int exclusive,
                     int vec_ok) {
  constexpr int kVec = 4;  // elements a 16-byte load
  constexpr int VECS = kScanVecs;
  constexpr long long kTileN = kScanTile;
  __shared__ unsigned s_tile;
  __shared__ T s_warp[kWarps];
  __shared__ T s_prefix;
  {
    // the lane form: grid row y scans lane y of [lanes, n], on its own
    // look-back state (a counter and a word a tile) and into its own total
    const long long y = blockIdx.y;
    in += y * n;
    if (out != nullptr) out += y * n;
    if (total != nullptr) total += y;
    state += y * ((n + kTileN - 1) / kTileN + 1);
  }
  const unsigned tile = lb_tile(state, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase = tile * kTileN + static_cast<long long>(warp) * 32 * kVec * VECS;

  T x[VECS][kVec];
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const long long e0 = wbase + static_cast<long long>(v * 32 + lane) * kVec;
    if (vec_ok && e0 + kVec <= n) {
      union {
        uint4 raw;
        T e[kVec];
      } u;
      u.raw = __ldg(reinterpret_cast<const uint4*>(in + e0));
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[v][j] = u.e[j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[v][j] = e0 + j < n ? in[e0 + j] : T(0);
    }
  }
  T base[VECS];
  const T warp_sum = warp_striped_scan<T, VECS, kVec>(x, base);
  T warp_off;
  const T prefix = tile_prefix<T>(state, tile, (n + kTileN - 1) / kTileN, warp_sum, s_warp,
                                  &s_prefix, total, warp_off);
  if (out == nullptr) return;
  store_scanned<T, VECS>(out, n, wbase, prefix + warp_off, x, base, exclusive, vec_ok);
}

// Exclusive scan of one value per thread across the block; every thread
// gets the sum of the values of the threads before it (K17: the digit
// bases of the sort's plan and the digit offsets of a tile).
template <typename T>
__device__ T block_exclusive_scan(T v, T* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sums[lane] : T(0);
    T wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    T we = __shfl_up_sync(kFull, wi, 1);
    if (lane == 0) we = T(0);
    if (lane < kWarps) warp_sums[lane] = we;
  }
  __syncthreads();
  return excl + warp_sums[warp];
}

// The look-back state's bytes for `tiles` tiles: the counter, then one
// word a tile.
inline long long lb_state_bytes(long long tiles) { return 8 * (tiles + 1); }

// `lanes` rows of n values each (lane-major), a look-back chain a lane:
// the one memset empties every lane's state, and a lane's tiles wait only
// on that lane's (its own counter hands them out).
template <typename T>
cudaError_t scan_lookback(const T* in, T* out, T* total, long long n,
                          unsigned long long* state, int exclusive, cudaStream_t s,
                          long long lanes = 1) {
  if (lanes <= 0) return cudaSuccess;
  if (n <= 0) {
    return total != nullptr ? cudaMemsetAsync(total, 0, lanes * sizeof(T), s) : cudaSuccess;
  }
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  cudaError_t e = cudaMemsetAsync(state, 0xff, lanes * lb_state_bytes(tiles), s);
  if (e != cudaSuccess) return e;
  const int vec_ok = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0 && (lanes == 1 || n % 4 == 0);
  scan_lookback_kernel<T><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
      in, out, total, n, state, exclusive, vec_ok);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2a: degree_counts (replaces csr.degree_counts :39).
// Bound: K*4 read (srcs) + 2 indptr reads per valid source + K*4 written.
// One thread per source; padding (src < 0) counts 0. The source is clipped
// into [0, V-1] before indexing, where jnp.take would clip silently. The
// engine no longer calls it (degree_scan_i32 below computes the counts in
// its load stage); it stays as the counterpart of the reference function.
// ---------------------------------------------------------------------------
__global__ void degree_counts_kernel(const int* __restrict__ indptr, long long nv,
                                     const int* __restrict__ srcs, long long k,
                                     int* __restrict__ out) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= k) return;
  int s = srcs[i];
  if (s < 0 || nv <= 0) {
    out[i] = 0;
    return;
  }
  long long c = s < nv ? s : nv - 1;
  out[i] = indptr[c + 1] - indptr[c];
}

// ---------------------------------------------------------------------------
// K2: degree_scan_i32, a one-hop expansion's offsets and total (replaces
// csr.degree_counts :39 followed by csr.exclusive_cumsum :47 and the sum
// of the counts, the engine's count → scan → total).
// Bound: K*4 bytes of srcs read, 8 of indptr a valid source, K*4 of
// offsets written (Q3's second hop, 65,536 sources of which ~20k live:
// ~0.69 MB, ~0.0002 ms), so the launch and the look-back chain decide.
// Design: K1's single-pass decoupled look-back scan (scan_lookback_kernel)
// with K2a's work in its load stage: a thread loads its sources with
// 16-byte loads where aligned (kDegVecs of them, warp-striped as in K1),
// issues both indptr reads of every valid source before it uses any,
// scans the degrees in registers and shuffles, and writes the exclusive
// offsets; the last tile writes the total. One launch after one memset of
// the look-back state; no counts array and no second launch. The tile
// (kDegTile = 2,048 sources) is smaller than K1's so that a frontier of a
// few tens of thousands of sources still spreads over several SMs. int32
// sums are taken in uint32 and wrap as the reference's int32 cumsum does.
// The source's span comes from a `Span` (CsrSpan here: the CSR's indptr
// at the clipped source; K17 passes RunSpan, each row's run in its sorted
// window).
// ---------------------------------------------------------------------------
constexpr int kDegVecs = 2;  // 16-byte source loads a thread
constexpr long long kDegTile = kThreads * 4LL * kDegVecs;

// A source's CSR span: indptr[c] .. indptr[c+1] at c = clip(src, 0, V-1);
// padding (src < 0) and an empty graph give an empty span. A span type
// gives the spans of a thread's sources at once (`bounds`, so that every
// load can be in flight before any is used), by source or by position.
struct CsrSpan {
  static constexpr bool kReadsSrcs = true;
  const unsigned* indptr;
  long long nv;
  template <int V, int J>
  __device__ __forceinline__ void bounds(long long, long long, const int (&c)[V][J],
                                         unsigned (&lo)[V][J], unsigned (&hi)[V][J]) const {
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        lo[v][j] = hi[v][j] = 0u;
        if (c[v][j] >= 0 && nv > 0) {
          const long long cc = c[v][j] < nv ? c[v][j] : nv - 1;
          lo[v][j] = __ldg(indptr + cc);
          hi[v][j] = __ldg(indptr + cc + 1);
        }
      }
    }
  }
};

template <typename Span>
__global__ void __launch_bounds__(kThreads)
degree_scan_kernel(const Span span, const int* __restrict__ srcs,
                   long long k, unsigned* __restrict__ offsets, unsigned* __restrict__ total,
                   unsigned long long* __restrict__ state, int vec_ok) {
  constexpr int kVec = 4;
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_prefix;
  {
    // the lane form: grid row y takes lane y's k sources of [lanes, k]
    // into its offsets and total, on its own look-back state
    const long long y = blockIdx.y;
    srcs += y * k;
    offsets += y * k;
    total += y;
    state += y * ((k + kDegTile - 1) / kDegTile + 1);
  }
  const unsigned tile = lb_tile(state, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase = tile * kDegTile + static_cast<long long>(warp) * 32 * kVec * kDegVecs;
  int src[kDegVecs][kVec] = {};
  if constexpr (Span::kReadsSrcs) {
#pragma unroll
    for (int v = 0; v < kDegVecs; ++v) {
      const long long e0 = wbase + static_cast<long long>(v * 32 + lane) * kVec;
      if (vec_ok && e0 + kVec <= k) {
        const int4 raw = __ldg(reinterpret_cast<const int4*>(srcs + e0));
        src[v][0] = raw.x;
        src[v][1] = raw.y;
        src[v][2] = raw.z;
        src[v][3] = raw.w;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) src[v][j] = e0 + j < k ? srcs[e0 + j] : -1;
      }
    }
  }
  unsigned lo[kDegVecs][kVec], hi[kDegVecs][kVec];
  span.bounds(wbase, k, src, lo, hi);
  unsigned x[kDegVecs][kVec];
#pragma unroll
  for (int v = 0; v < kDegVecs; ++v) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[v][j] = hi[v][j] - lo[v][j];
  }
  unsigned base[kDegVecs];
  const unsigned warp_sum = warp_striped_scan<unsigned, kDegVecs, kVec>(x, base);
  unsigned warp_off;
  const unsigned prefix = tile_prefix<unsigned>(state, tile, (k + kDegTile - 1) / kDegTile, warp_sum,
                                                s_warp, &s_prefix, total, warp_off);
  store_scanned<unsigned, kDegVecs>(offsets, k, wbase, prefix + warp_off, x, base, 1, vec_ok);
}

// The merge-path split of diagonal d (Merrill and Garland, SC'16): items
// x = 0, 1, ... of a keyed list (keys non-decreasing) merged with the
// items y = 0, 1, ... of a plain sequence, keyed item x before item y when
// key(x) <= y. Returns the number of keyed items among the first d merged
// items: the first x in [lo, hi) with key(x) > d - x - 1, or hi (the
// caller passes lo = max(0, d - plain items), hi = min(d, keyed items)).
// Run by a whole warp: 32 pivots a step narrow the range 33-fold (five
// steps of dependent loads over 8M keys, against 23 for one thread); every
// lane gets the answer. The result stays in [lo, hi] whatever the keys.
// K2b splits row offsets against output slots with it, K4 segment ends
// against values.
template <typename Key>
__device__ __forceinline__ long long warp_merge_split(Key key, long long lo, long long hi,
                                                      long long d) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned below = __ballot_sync(kFull, key(p) <= d - p - 1);
    const int c = __popc(below);  // the pivots still before the answer
    const long long plo = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const long long phi = __shfl_sync(kFull, p, c < 32 ? c : 31);
    if (c > 0) lo = plo + 1;
    if (c < 32) hi = phi;
  }
  const long long x = lo + lane;
  const unsigned before = __ballot_sync(kFull, x < hi && key(x) <= d - x - 1);
  return lo + __popc(before);
}

// Writes the triples f(i) = (row, edge position, neighbour) of the slots
// p0 + i, i < n, by the whole block: a scalar head up to 16-byte alignment
// of the outputs, four slots a thread with one 16-byte store an output,
// a scalar tail (all scalar when `vec` is 0). A warp's stores cover
// consecutive slots either way.
template <typename F>
__device__ __forceinline__ void store_triples(long long p0, int n, int vec, int* __restrict__ a,
                                              int* __restrict__ b, int* __restrict__ c, F f) {
  int head = vec ? static_cast<int>((4 - (p0 & 3)) & 3) : n;
  if (head > n) head = n;
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    const int3 v = f(i);
    a[p0 + i] = v.x;
    b[p0 + i] = v.y;
    c[p0 + i] = v.z;
  }
  for (int g = threadIdx.x; g < body; g += kThreads) {
    const int i = head + 4 * g;
    const int3 v0 = f(i), v1 = f(i + 1), v2 = f(i + 2), v3 = f(i + 3);
    const long long q = (p0 + i) >> 2;
    reinterpret_cast<int4*>(a)[q] = make_int4(v0.x, v1.x, v2.x, v3.x);
    reinterpret_cast<int4*>(b)[q] = make_int4(v0.y, v1.y, v2.y, v3.y);
    reinterpret_cast<int4*>(c)[q] = make_int4(v0.z, v1.z, v2.z, v3.z);
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads) {
    const int3 v = f(i);
    a[p0 + i] = v.x;
    b[p0 + i] = v.y;
    c[p0 + i] = v.z;
  }
}

// ---------------------------------------------------------------------------
// K2b: gather_expand (replaces csr.gather_expand :54).
// Bound: srcs, offsets and indptr read once per source (12 bytes each), one
// neighbour read per live slot (and one edge-map read with `edge_map`),
// three int32 outputs per slot written (Q3's second hop: 65,536 sources,
// ~200k slots in a 524,288 bucket, ~0.0024 ms).
// Design: a merge-path load-balanced search (moderngpu's LoadBalanceSearch,
// after Merrill and Garland's merge path). The K row offsets and the
// n = min(total, out_size) live slots form one merged sequence (row r
// before slot p when offsets[r] <= p, so a slot follows exactly the rows
// the reference's upper bound counts); the padding slots [n, out_size)
// follow it, so the tiles cover K + out_size items, kExpandTile
// consecutive ones each, however many zero-degree or padding rows share an
// offset and however long one row is. A block a tile (a grid capped at the
// blocks the card holds at once, each looping over tiles, measured slower).
// A block:
//  1. finds its first and last merged item's row by two warp-cooperative
//     merge-path searches over offsets (warps 0 and 1);
//  2. stages its rows' offsets[r] and indptr[clip(srcs[r])] in shared
//     memory, with the row before its first (a slot at the tile's start
//     belongs to it; row -1 is row 0, the reference's clip);
//  3. each thread finds its own start among the tile's items by a search in
//     shared memory and walks its kExpandItems items once, writing each
//     slot's row to shared memory;
//  4. the block writes the slots in order: consecutive slots of a row read
//     consecutive neighbours (and edge-map entries), so a warp's loads
//     coalesce, and the outputs go out four slots a thread as 16-byte
//     stores;
//  5. a tile past the live slots writes -1 to all three outputs in a
//     straight line (the tile that holds the total, its part past it).
// Every clip of the reference is kept: the row into [0, K-1] (the last of
// several rows that share an offset wins), the source into [0, V-1], the
// edge position into [0, E-1] for the read only, nbr -1 when E is 0. A
// replay may see total > out_size: every slot is then live and nothing is
// written past out_size. With `edge_map` (the in walk's edge_id_in, of nm
// entries) the position output holds edge_map[clip(edge_pos)] (-1 where
// edge_pos < 0 or nm is 0), the reference's take_pad(edge_id_in, pos, -1).
// Offsets that are not non-decreasing give another answer but no access
// out of range. A row's staged operand (`Gather::Row`, its edge base at
// least) and a slot's outputs come from a `Gather` (CsrGather here; K17
// passes SlabGather, the sorted window's runs; K21 PagedGather, the page
// indirection of a tiered partition).
// ---------------------------------------------------------------------------
constexpr int kExpandItems = 8;  // merged items a thread
constexpr int kExpandTile = kThreads * kExpandItems;

// K2b over a CSR: a row's base is indptr[clip(src)]; edge position ep gives
// (ep, or edge_map[clip(ep)] with a map; nbrs[clip(ep)], -1 when E is 0).
struct CsrGather {
  const int* indptr;
  long long nv;
  const int* nbrs;
  long long ne;
  const int* edge_map;
  long long nm;
  using Row = int;  // the row's edge base
  __device__ __forceinline__ static int base(Row x) { return x; }
  __device__ __forceinline__ Row row(long long, long long c) const {
    if (nv < 0) return 0;
    c = c > nv - 1 ? nv - 1 : c;
    return __ldg(indptr + (c < 0 ? 0 : c));
  }
  __device__ __forceinline__ int3 emit(Row, long long r, int ep) const {
    int nb = -1;
    if (ne > 0) nb = __ldg(nbrs + (ep < 0 ? 0 : (ep > ne - 1 ? ne - 1 : ep)));
    int pos = ep;
    if (edge_map != nullptr) {
      pos = ep >= 0 && nm > 0 ? __ldg(edge_map + (ep > nm - 1 ? nm - 1 : ep)) : -1;
    }
    return make_int3(static_cast<int>(r), pos, nb);
  }
};

template <typename Gather>
__global__ void __launch_bounds__(kThreads)
gather_expand_kernel(const Gather gather, const int* __restrict__ srcs,
                     const int* __restrict__ offsets, long long k, const int* __restrict__ total,
                     long long out_size, int* __restrict__ row_out, int* __restrict__ pos_out,
                     int* __restrict__ nbr_out, int vec) {
  __shared__ int s_off[kExpandTile + 1];  // offsets of rows i0 - 1 .. i1 - 1
  __shared__ typename Gather::Row s_base[kExpandTile + 1];  // gather.row(r, srcs[r]) of the same rows
  __shared__ int s_row[kExpandTile];       // a slot's row, as its index in the two above
  __shared__ long long s_split[2];
  {
    // the lane form: grid row y expands lane y's k sources and offsets of
    // [lanes, k] by its total into its row of the [lanes, out_size] outputs
    const long long y = blockIdx.y;
    srcs += y * k;
    offsets += y * k;
    total += y;
    row_out += y * out_size;
    pos_out += y * out_size;
    nbr_out += y * out_size;
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long t = k > 0 ? static_cast<long long>(__ldg(total)) : 0;
  const long long n_slots = t < 0 ? 0 : (t > out_size ? out_size : t);
  const long long m = k + n_slots;  // the merged sequence's length
  const long long d0 = static_cast<long long>(blockIdx.x) * kExpandTile;
  const long long d1 = d0 + kExpandTile < k + out_size ? d0 + kExpandTile : k + out_size;
  if (d0 < m) {  // uniform across the block
    const long long e1 = d1 < m ? d1 : m;
    if (warp < 2) {
      const long long d = warp == 0 ? d0 : e1;
      const long long lo = d > n_slots ? d - n_slots : 0, hi = d < k ? d : k;
      const long long x = warp_merge_split(
          [&](long long r) { return static_cast<long long>(__ldg(offsets + r)); }, lo, hi, d);
      if ((tid & 31) == 0) s_split[warp] = x;
    }
    __syncthreads();
    const long long i0 = s_split[0];
    const int items = static_cast<int>(e1 - d0);
    long long i1 = s_split[1];
    i1 = i1 < i0 ? i0 : (i1 > i0 + items ? i0 + items : i1);
    const int ni = static_cast<int>(i1 - i0), nj = items - ni;
    const long long j0 = d0 - i0;  // the tile's first slot
    for (int e = tid; e <= ni; e += kThreads) {
      const long long r = i0 - 1 + e < 0 ? 0 : i0 - 1 + e;
      s_off[e] = __ldg(offsets + r);
      s_base[e] = gather.row(r, __ldg(srcs + r));
    }
    __syncthreads();
    // the tile's row x is staged at x + 1; the thread's first item is the
    // first x with offsets[i0 + x] > its slot
    const int ds = tid * kExpandItems < items ? tid * kExpandItems : items;
    const int cnt = (ds + kExpandItems < items ? ds + kExpandItems : items) - ds;
    int lo = ds > nj ? ds - nj : 0, hi = ds < ni ? ds : ni;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<long long>(s_off[mid + 1]) <= j0 + ds - mid - 1) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int x = lo, y = ds - lo;
#pragma unroll
    for (int q = 0; q < kExpandItems; ++q) {
      if (q < cnt) {
        if (x < ni && (y >= nj || static_cast<long long>(s_off[x + 1]) <= j0 + y)) {
          ++x;  // a row starts: later slots belong to it
        } else {
          s_row[y++] = x;  // the slot belongs to the latest row (staged at x)
        }
      }
    }
    __syncthreads();
    store_triples(j0, nj, vec, row_out, pos_out, nbr_out, [&](int yy) {
      const int e = s_row[yy];
      const long long r = i0 - 1 + e < 0 ? 0 : i0 - 1 + e;
      // int32 arithmetic, wrapping as the reference's
      const typename Gather::Row x = s_base[e];
      const int ep = static_cast<int>(static_cast<unsigned>(Gather::base(x)) +
                                      static_cast<unsigned>(j0 + yy) -
                                      static_cast<unsigned>(s_off[e]));
      return gather.emit(x, r, ep);
    });
  }
  // the slots past the total: -1 in all three outputs
  const long long pa = (d0 > m ? d0 : m) - k, pb = d1 - k;
  if (pb > pa) {
    store_triples(pa, static_cast<int>(pb - pa), vec, row_out, pos_out, nbr_out,
                  [](int) { return make_int3(-1, -1, -1); });
  }
}

// ---------------------------------------------------------------------------
// K3: compact_indices (replaces csr.compact_indices :185).
// Bound: n bytes of mask read + 4 bytes a written slot: out_size*4 in the
// fill form, 4 a kept index in the offset form.
// Design: one pass on K1's look-back, with no scan launch and no ranks
// array. Each thread loads 16 mask bytes at a time with 16-byte loads
// (kCompactVecs of them, warp-striped as in K1: a tile of 16,384 bytes,
// which measured as fast as 32,768, PERF.md §6) and counts their nonzero bytes;
// the block scans the counts as K1 does, which gives each thread its
// exclusive rank in the tile, and looks back for the tile's offset. Each
// kept index i of global rank r (1-based) with r <= out_size goes to slot
// r-1, in ascending order; anything past out_size is dropped (the
// reference's truncation). A warp stages the kept indices of one load in
// shared memory in rank order and writes them with consecutive lanes on
// consecutive slots, so the stores coalesce whatever the mask's density.
// Every index has one slot, so the output does not depend on the order in
// which the look-back finds the tiles. One result covers both of the
// reference's regimes (nonzero, and prefix sum + searchsorted).
// The fill form (`fill` 1) gives the out_size slots -1 past the count: the
// wrapper allocates the look-back state right behind the slots, so the one
// cudaMemsetAsync of 0xFF bytes that empties the state also sets every
// slot to -1 before the kernel writes the kept ones. The offset form (`fill`
// 0: a TRAVERSE level written at its offset into the replay's one output
// buffer, `out` already advanced by the wrapper) writes only the kept
// indices and leaves the slots past the count as they are (the buffer is
// -1-filled once).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
compact_lookback_kernel(const unsigned char* __restrict__ mask, long long n, long long out_size,
                        int* __restrict__ out, unsigned long long* __restrict__ state,
                        int vec_ok) {
  constexpr int VECS = kCompactVecs;
  constexpr long long kTileN = kCompactTile;
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_prefix;
  __shared__ int s_stage[kWarps][32 * 16];  // a warp's kept indices of one load
  {
    // the lane form: grid row y compacts lane y of a [lanes, n] mask into
    // its row of the [lanes, out_size] output, on its own look-back state
    const long long y = blockIdx.y;
    mask += y * n;
    out += y * out_size;
    state += y * ((n + kTileN - 1) / kTileN + 1);
  }
  const unsigned tile = lb_tile(state, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase = tile * kTileN + static_cast<long long>(warp) * 32 * 16 * VECS;
  unsigned bits[VECS];  // bit j of load v: byte e0 + j is nonzero
  unsigned x[VECS][1];
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    const long long e0 = wbase + static_cast<long long>(v * 32 + lane) * 16;
    unsigned b = 0;
    if (vec_ok && e0 + 16 <= n) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(mask + e0));
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned nz = __vcmpne4(w[q], 0u);  // 0xFF in each nonzero byte
#pragma unroll
        for (int k = 0; k < 4; ++k) b |= ((nz >> (8 * k + 7)) & 1u) << (4 * q + k);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (e0 + j < n && mask[e0 + j]) b |= 1u << j;
      }
    }
    bits[v] = b;
    x[v][0] = __popc(b);
  }
  unsigned base[VECS];
  const unsigned warp_sum = warp_striped_scan<unsigned, VECS, 1>(x, base);
  unsigned warp_off;
  const unsigned prefix = tile_prefix<unsigned>(state, tile, (n + kTileN - 1) / kTileN, warp_sum,
                                                s_warp, &s_prefix, nullptr, warp_off);
  const long long start = static_cast<long long>(prefix) + warp_off;  // the warp's first rank
  int* stage = s_stage[warp];
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    // the warp's kept indices of load v have the consecutive ranks from
    // start + first: staged in shared memory in rank order, then written
    // by consecutive lanes to consecutive slots
    const unsigned first = __shfl_sync(kFull, base[v], 0);
    const unsigned count = __shfl_sync(kFull, base[v] + x[v][0], 31) - first;
    const long long r0 = start + first;
    if (count == 0 || r0 >= out_size) continue;  // uniform across the warp
    const long long e0 = wbase + static_cast<long long>(v * 32 + lane) * 16;
    unsigned pos = base[v] - first;
    for (unsigned b = bits[v]; b != 0; b &= b - 1) stage[pos++] = static_cast<int>(e0 + __ffs(b) - 1);
    __syncwarp();
    for (unsigned i = lane; i < count && r0 + i < out_size; i += 32) out[r0 + i] = stage[i];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K4: indptr_segment_sum (replaces csr.indptr_segment_sum :227).
// Bound: E*4 bytes of values + (nseg+1)*4 of indptr read, out_size*4
// written (A: 80M int32 into 2^23, ~0.39 GB, ~0.115 ms; E1: 80M into 2^25
// over 24M segments, ~0.55 GB, ~0.164 ms).
// Design: a merge-path segmented reduction (Merrill and Garland,
// "Merge-based Parallel Sparse Matrix-Vector Multiplication", SC'16). The
// values and the segment ends form one merged sequence of nseg + nv items
// (a value moves the path down, a segment end moves it right, an end
// before the value at the same index); each block owns kSegTile
// consecutive items of it, so its work is the same whatever the degrees
// (Poisson, Zipf, runs of empty segments, one segment over many tiles).
// Three launches on the caller's stream:
//  1. seg_partition_kernel: a warp a tile boundary searches the merge path
//     for the boundary's segment coordinate (warp_merge_split, 32 pivots a
//     step: five steps of dependent loads over 8M segments); the
//     same launch writes the zero padding [nseg, out_size) with 16-byte
//     stores;
//  2. seg_sum_kernel: a block stages its tile's segment ends and values in
//     shared memory (values with 16-byte loads and stores where the source
//     is aligned: the 16-byte part lands on aligned shared memory), each thread
//     finds its own start there and walks its kSegItems items once,
//     branch-free, writing every segment that ends in its share to shared
//     memory (an empty one writes 0); the block combines the threads'
//     trailing partials by a segmented scan (a fixed tree: the float32
//     order is the same every run) and adds each thread's carry-in to its
//     first finished segment, then stores its finished segments with
//     coalesced stores; the partial of the segment still open at the
//     tile's end (its carry) goes to a small array;
//  3. seg_fixup_kernel: the first tile of each run of tiles that end in
//     the same open segment adds the run's carries, in tile order, to that
//     segment's output (written by the tile where the segment ends).
// No atomics: int32 sums (in uint32) are exact mod 2^32 in any order, and
// float32 sums are the same bit for bit from run to run. A segment is
// [clip(indptr[s]), clip(indptr[s+1])) with clip(x) = min(max(x, 0), ne)
// for a non-decreasing indptr, the CSR's own; the plain version's
// scan-and-difference gives the same int32 sums. Measured on the card
// (PERF.md §6): 20 items a thread beat 8 and 16; what is left over the
// bound is the walk's shared-memory traffic and the partition search.
// ---------------------------------------------------------------------------
constexpr int kSegItems = 20;  // merge items a thread
constexpr long long kSegTile = static_cast<long long>(kThreads) * kSegItems;

__device__ __forceinline__ long long seg_clip(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The merged sequence's extent: values [v0, v0 + nv), nseg segment ends.
struct SegSpan {
  long long v0, nv;
};

__device__ __forceinline__ SegSpan seg_span(const int* __restrict__ indptr, long long ne,
                                            long long nseg) {
  SegSpan s;
  s.v0 = seg_clip(indptr[0], 0, ne);
  s.nv = nseg > 0 ? seg_clip(indptr[nseg], s.v0, ne) - s.v0 : 0;
  return s;
}

// Segment s's end, relative to v0.
__device__ __forceinline__ long long seg_end(const int* __restrict__ indptr, SegSpan s,
                                             long long seg) {
  return seg_clip(indptr[seg + 1], s.v0, s.v0 + s.nv) - s.v0;
}

// The partition of `nsh` independent merge paths (K4: one; K23: a held
// shard each, its indptr row at indptr + h * ind_stride): rowc[h * (tiles +
// 1) + t] is the segment coordinate of path h's tile boundary t. The zero
// padding goes to `nout` output rows of out_size (K4's lane form: a lane
// each).
__global__ void seg_partition_kernel(const int* __restrict__ indptr, long long ind_stride,
                                     long long nsh, long long ne, long long nseg,
                                     long long tiles, int* __restrict__ rowc,
                                     unsigned* __restrict__ out, long long out_size,
                                     long long nout) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (tiles > 0) {
    // a warp a boundary: the number of segment ends among its first d
    // items (a segment end before the value at its own index)
    for (long long t = tid >> 5; t < nsh * (tiles + 1); t += step >> 5) {
      const long long h = t / (tiles + 1);
      const int* ip = indptr + h * ind_stride;
      const SegSpan sp = seg_span(ip, ne, nseg);
      const long long total = nseg + sp.nv;
      const long long b = t - h * (tiles + 1);
      const long long d = b * kSegTile < total ? b * kSegTile : total;
      const long long x = warp_merge_split([&](long long p) { return seg_end(ip, sp, p); },
                                           d > sp.nv ? d - sp.nv : 0, d < nseg ? d : nseg, d);
      if (lane == 0) rowc[t] = static_cast<int>(x);
    }
  }
  // zeros past the segments of each output row: a scalar head up to
  // 16-byte alignment, then 16-byte stores, then a scalar tail
  const long long npad = out_size - nseg;
  if (npad <= 0) return;
  for (long long r = 0; r < nout; ++r) {
    unsigned* pad = out + r * out_size + nseg;
    long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(pad) & 15u)) & 15u) / 4;
    if (head > npad) head = npad;
    const long long body = (npad - head) / 4;
    if (tid < head) pad[tid] = 0u;
    uint4* vec = reinterpret_cast<uint4*>(pad + head);
    for (long long k = tid; k < body; k += step) vec[k] = make_uint4(0u, 0u, 0u, 0u);
    const long long tail = head + 4 * body + tid;
    if (tail < npad && tid < 4) pad[tail] = 0u;
  }
}

// 32 bits read as T
template <typename T>
__device__ __forceinline__ T bits_as(unsigned u);
template <>
__device__ __forceinline__ unsigned bits_as<unsigned>(unsigned u) { return u; }
template <>
__device__ __forceinline__ int bits_as<int>(unsigned u) { return static_cast<int>(u); }
template <>
__device__ __forceinline__ float bits_as<float>(unsigned u) { return __uint_as_float(u); }

// K4's value source: the values themselves, in memory, and one output of
// nseg sums. head() is the scalar head up to the values' 16-byte
// alignment; stage() copies the tile's values [j, j + nj) into shared
// memory (16-byte loads and stores where the source is aligned).
template <typename T>
struct SegValues {
  const T* vals;
  const int* ind;
  T* out;
  __device__ const int* indptr(long long) const { return ind; }
  __device__ int head(long long j, int nj) const {
    const unsigned* src = reinterpret_cast<const unsigned*>(vals) + j;
    const int h = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) / 4;
    return h > nj ? nj : h;
  }
  __device__ void stage(unsigned* s_val, long long, long long j, int nj, int head) const {
    const int tid = threadIdx.x;
    const unsigned* src = reinterpret_cast<const unsigned*>(vals) + j;
    const int body = (nj - head) / 4;
    if (tid < head) s_val[tid] = src[tid];
    const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
    uint4* vdst = reinterpret_cast<uint4*>(s_val + head);
#pragma unroll 4
    for (int k = tid; k < body; k += kThreads) vdst[k] = __ldcs(vsrc + k);
    const int tail = head + 4 * body + tid;
    if (tid < 4 && tail < nj) s_val[tail] = src[tail];
  }
  __device__ void store(long long, long long i, T v) const { out[i] = v; }
  __device__ void add(long long, long long i, T v) const { out[i] += v; }
};

// One tile's pass over its staged segment ends (s_end, ni of them and a
// sentinel) and values (s_val, nj): each thread walks its `cnt` merged
// items from (xs, ds - xs) once, branch-free, writing every segment that
// ends in its share to s_out (an empty one writes 0); the block combines
// the threads' trailing partials by a segmented scan (a fixed tree: the
// float32 order is the same every run) and adds each thread's carry-in to
// its first finished segment; `store(k, v)` takes finished segment k of the
// tile, and *carry_slot the partial of the segment still open at its end.
template <typename T, typename Store>
__device__ __forceinline__ void seg_tile_pass(const int* s_end, const unsigned* s_val, T* s_out,
                                              T* s_wv, int* s_wf, int ni, int xs, int ds, int cnt,
                                              T* carry_slot, Store store) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // one branch-free walk: a segment end stores the running sum (the first
  // one without the earlier threads' part of it, added below), a value
  // adds to it; the current end stays in a register and is read again only
  // after a segment ended
  T acc = T(0);
  int x = xs, y = ds - xs;
  int e = s_end[x];
  auto walk = [&](bool all) {
#pragma unroll
    for (int k = 0; k < kSegItems; ++k) {
      if (all || k < cnt) {
        const T val = bits_as<T>(s_val[y]);
        const bool right = e <= y;
        if (right) {
          s_out[x] = acc;
          e = s_end[x + 1];
        }
        acc = right ? T(0) : acc + val;
        x += right ? 1 : 0;
        y += right ? 0 : 1;
      }
    }
  };
  if (cnt == kSegItems) {
    walk(true);
  } else {
    walk(false);
  }
  // segmented scan of (segment ended in the share, partial): inclusive
  // within the warp, then the warps' totals in order
  bool f = x != xs;
  T v = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T vo = __shfl_up_sync(kFull, v, o);
    const bool fo = __shfl_up_sync(kFull, f ? 1 : 0, o) != 0;
    if (lane >= o) {
      if (!f) v = vo + v;
      f = f || fo;
    }
  }
  if (lane == 31) {
    s_wv[warp] = v;
    s_wf[warp] = f ? 1 : 0;
  }
  __syncthreads();
  T pv = T(0);  // the warps before this one, combined in order
  for (int w = 0; w < warp; ++w) pv = s_wf[w] ? s_wv[w] : pv + s_wv[w];
  const T ev = __shfl_up_sync(kFull, v, 1);
  const bool ef = __shfl_up_sync(kFull, f ? 1 : 0, 1) != 0;
  if (tid == kThreads - 1) *carry_slot = f ? v : pv + v;
  // the first segment that ends in the share gets the earlier threads' part
  if (tid > 0 && x != xs) s_out[xs] = (lane == 0 ? pv : (ef ? ev : pv + ev)) + s_out[xs];
  __syncthreads();
  for (int k = tid; k < ni; k += kThreads) store(k, s_out[k]);
}

// A thread's share of a tile of `items` merged items (ni segment ends in
// s_end, the rest values): its first item ds, its count, and its first
// segment xs by a search in shared memory.
__device__ __forceinline__ void seg_share(const int* s_end, int ni, int nj, int& xs, int& ds,
                                          int& cnt) {
  const int items = ni + nj;
  ds = threadIdx.x * kSegItems < items ? threadIdx.x * kSegItems : items;
  cnt = (ds + kSegItems < items ? ds + kSegItems : items) - ds;
  int lo = ds > nj ? ds - nj : 0, hi = ds < ni ? ds : ni;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= ds - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  xs = lo;
}

// The tiles of `nsh` merge paths (see seg_partition_kernel), `tiles` a
// path: block b is tile b % tiles of path b / tiles. `Src` gives a path's
// indptr, stages a tile's values and takes its finished sums.
template <typename T, typename Src>
__global__ void __launch_bounds__(kThreads)
    seg_sum_kernel(const Src src, long long ne, long long nseg, long long tiles,
                   const int* __restrict__ rowc_all, T* __restrict__ carry) {
  // the tile's segment ends (relative to its first value), a sentinel end,
  // then its values placed so that the 16-byte-aligned part of their
  // source lands on 16-byte-aligned shared memory (up to 3 slots of gap),
  // and one spare slot a walk may read past the last
  __shared__ __align__(16) unsigned s_buf[kSegTile + 6];
  __shared__ T s_out[kSegTile];
  __shared__ T s_wv[kWarps];
  __shared__ int s_wf[kWarps];
  const int tid = threadIdx.x;
  const long long h = blockIdx.x / tiles;
  const long long b = blockIdx.x - h * tiles;
  const int* indptr = src.indptr(h);
  const int* rowc = rowc_all + h * (tiles + 1);
  const SegSpan sp = seg_span(indptr, ne, nseg);
  const long long total = nseg + sp.nv;
  const long long d0 = b * kSegTile < total ? b * kSegTile : total;
  const long long d1 = d0 + kSegTile < total ? d0 + kSegTile : total;
  const int i0 = rowc[b], i1 = rowc[b + 1];
  const long long j0 = d0 - i0;
  const int ni = i1 - i0;
  const int nj = static_cast<int>(d1 - i1 - j0);
  const int head = src.head(sp.v0 + j0, nj);
  int* s_end = reinterpret_cast<int*>(s_buf);
  unsigned* s_val = s_buf + (((ni + 1 + head + 3) & ~3) - head);
  for (int k = tid; k < ni; k += kThreads) {
    s_end[k] = static_cast<int>(seg_end(indptr, sp, i0 + k) - j0);
  }
  if (tid == 0) s_end[ni] = 0x7fffffff;  // past the tile's last end: only values
  src.stage(s_val, h, sp.v0 + j0, nj, head);
  __syncthreads();
  int xs, ds, cnt;
  seg_share(s_end, ni, nj, xs, ds, cnt);
  seg_tile_pass<T>(s_end, s_val, s_out, s_wv, s_wf, ni, xs, ds, cnt, carry + blockIdx.x,
                   [&](int k, T v) { src.store(h, i0 + k, v); });
}

// K4's lane form: B lanes of values, lane-major ([B, ne]: lane l's at
// vals + l * ne), over ONE indptr, into B output rows of out_size. The
// partition is the single form's (it depends only on indptr and ne).
template <typename T>
struct SegLanes {
  const T* vals;
  long long ne;
  const int* ind;
  T* out;
  long long out_size;
  __device__ void add(long long lane, long long i, T v) const { out[lane * out_size + i] += v; }
};

// The lane form's tile pass: block b stages tile b's segment ends and
// finds each thread's share once, then for each lane stages that lane's
// values, walks them over the same ends and stores the lane's finished
// sums and carry (carry[lane * tiles + b]); each lane's float32 sums are
// the single form's, bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_sum_lanes_kernel(const SegLanes<T> src, long long lanes, long long nseg, long long tiles,
                         const int* __restrict__ rowc, T* __restrict__ carry) {
  __shared__ __align__(16) unsigned s_buf[kSegTile + 6];
  __shared__ T s_out[kSegTile];
  __shared__ T s_wv[kWarps];
  __shared__ int s_wf[kWarps];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const SegSpan sp = seg_span(src.ind, src.ne, nseg);
  const long long total = nseg + sp.nv;
  const long long d0 = b * kSegTile < total ? b * kSegTile : total;
  const long long d1 = d0 + kSegTile < total ? d0 + kSegTile : total;
  const int i0 = rowc[b], i1 = rowc[b + 1];
  const long long j0 = d0 - i0;
  const int ni = i1 - i0;
  const int nj = static_cast<int>(d1 - i1 - j0);
  int* s_end = reinterpret_cast<int*>(s_buf);
  for (int k = tid; k < ni; k += kThreads) {
    s_end[k] = static_cast<int>(seg_end(src.ind, sp, i0 + k) - j0);
  }
  if (tid == 0) s_end[ni] = 0x7fffffff;
  __syncthreads();
  int xs, ds, cnt;
  seg_share(s_end, ni, nj, xs, ds, cnt);
  for (long long l = 0; l < lanes; ++l) {
    const SegValues<T> lane{src.vals + l * src.ne, src.ind, nullptr};
    const int head = lane.head(sp.v0 + j0, nj);
    unsigned* s_val = s_buf + (((ni + 1 + head + 3) & ~3) - head);
    lane.stage(s_val, 0, sp.v0 + j0, nj, head);
    __syncthreads();
    T* out = src.out + l * src.out_size;
    seg_tile_pass<T>(s_end, s_val, s_out, s_wv, s_wf, ni, xs, ds, cnt, carry + l * tiles + b,
                     [&](int k, T v) { out[i0 + k] = v; });
    __syncthreads();  // s_val and s_out are the next lane's
  }
}

// Adds each run's carries to the segment the run ends in (see above), path
// by path: a run never crosses into the next path's tiles.
// The lanes of K4's lane form are paths that share one partition
// (`rowc_stride` 0; tiles + 1 where each path has its own).
template <typename T, typename Src>
__global__ void seg_fixup_kernel(const Src src, const int* __restrict__ rowc_all,
                                 const T* __restrict__ carry_all, long long tiles, long long nsh,
                                 long long nseg, long long rowc_stride) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < nsh * tiles; g += step) {
    const long long h = g / tiles, t = g - h * tiles;
    const int* rowc = rowc_all + h * rowc_stride;
    const T* carry = carry_all + h * tiles;
    const int key = rowc[t + 1];
    if (key >= nseg || (t > 0 && rowc[t] == key)) continue;
    T s = carry[t];
    for (long long u = t + 1; u < tiles && rowc[u + 1] == key; ++u) s += carry[u];
    src.add(h, key, s);
  }
}

// ---------------------------------------------------------------------------
// K5a: take_pad (replaces csr.take_pad, orientdb_tpu/ops/csr.py:211), and
// its fused form on the COUNT pushdown's weight pass, weight_gather
// (replaces the chain of orientdb_tpu/exec/tpu_engine.py:1600-1606).
//
// take_pad: out[j] = fill where idx[j] < 0 or the table is empty, else
// vals[min(idx[j], n - 1)] (the reference's clip). Bound: 4 bytes of index
// read and one value written an element, the table read once (A's weight
// pass, 80M indices into 2^23 int32 values: 672 MB, 0.20 ms). A random
// gather moves a whole 32-byte sector out of L2 whatever its width, so L2's
// sector rate, and whether the table stays in L2, bound it in practice. The
// first cut ran one index a thread with one gather in flight, and its 640
// MB of index and output streamed through the 50 MB L2 at default priority
// beside the table. Design: a warp owns 32 * kTakeRun consecutive
// elements in units of four (one 16-byte index load, one store of four
// values), warp-striped so that each load and store instruction of a warp
// covers contiguous memory; a thread takes kTakeRun of them (8 values of 4
// bytes, 16 bytes), loads all its indices, issues all its table loads and
// only then stores. Index and output stream with evict-first hints (ld/st
// .cs, in L1 and L2); a table the caller marks `keep` (ops/csr.py decides
// which tables fit L2) is read on the read-only path under an L2
// evict_last policy (createpolicy), so that it stays in L2 while the
// streams pass. The hints are per instruction: no device-wide cache
// setting changes, and a captured graph replays them as they are. A
// negative index issues no load (a predicated instruction) and reads the
// fill. The output is a fresh allocation (aligned); where the index is not
// 16-byte aligned, or the values are bytes, the same warp-striped pass
// runs with 4- and 1-byte accesses (kVec false). The aligned body's tail
// (m % 4 elements) takes one extra thread an element.
// ---------------------------------------------------------------------------
constexpr int kTakeRun = 8;  // elements a thread

// Four consecutive 4-byte values stored at once as one 16-byte vector.
template <typename T>
union Pack4 {
  uint4 v;
  T e[4];
};

__device__ inline unsigned long long l2_policy(bool keep) {
  unsigned long long policy;
  if (keep) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  } else {
    asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(policy));
  }
  return policy;
}

// A table load on the read-only path under an L2 policy, issued only where
// `pred` holds (a predicated instruction); `v` keeps its value otherwise.
__device__ inline int ld_table(const int* p, unsigned long long policy, bool pred, int v) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t@q ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;\n\t}"
      : "+r"(v) : "l"(p), "l"(policy), "r"(static_cast<unsigned>(pred)));
  return v;
}
__device__ inline unsigned ld_table(const unsigned* p, unsigned long long policy, bool pred, unsigned v) {
  return static_cast<unsigned>(ld_table(reinterpret_cast<const int*>(p), policy, pred, static_cast<int>(v)));
}
__device__ inline float ld_table(const float* p, unsigned long long policy, bool pred, float v) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t@q ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n\t}"
      : "+f"(v) : "l"(p), "l"(policy), "r"(static_cast<unsigned>(pred)));
  return v;
}
__device__ inline unsigned char ld_table(const unsigned char* p, unsigned long long policy, bool pred,
                                         unsigned char v) {
  unsigned x = v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t@q ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;\n\t}"
      : "+r"(x) : "l"(p), "l"(policy), "r"(static_cast<unsigned>(pred)));
  return static_cast<unsigned char>(x);
}

// take_pad of one index: vals[min(i, n - 1)], or the fill where i < 0 or
// the table is empty (then no load is issued).
template <typename T>
__device__ inline T take_one(const T* __restrict__ vals, long long n, int i, T fill,
                             unsigned long long policy) {
  const bool go = i >= 0 && n > 0;
  const long long c = go ? (i < n ? i : n - 1) : 0;
  return ld_table(vals + c, policy, go, fill);
}

// The table that index j reads: `vals` itself, or with a lane stride
// (`lane_m` > 0: the index is a [lanes, lane_m] stack of lane-local rows)
// lane j / lane_m's table of n values at vals + lane * stride.
template <typename T>
struct TakeTable {
  const T* vals;
  long long lane_m;
  long long stride;
  __device__ __forceinline__ const T* at(long long j) const {
    return lane_m > 0 ? vals + (j / lane_m) * stride : vals;
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    take_pad_kernel(const TakeTable<T> tab, long long n, const int* __restrict__ idx,
                    long long m, T fill, bool keep, T* __restrict__ out) {
  constexpr int kRun = kTakeRun, kUnits = kRun / 4;
  const unsigned long long policy = l2_policy(keep);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if constexpr (kVec) {
    const long long nv = m / 4;  // units of the aligned body
    const long long tv = (nv + 32 * kUnits - 1) / (32 * kUnits) * 32;
    if (t < tv) {
      const long long u0 = (t >> 5) * 32 * kUnits + lane;
      const int4* vidx = reinterpret_cast<const int4*>(idx);
      int ix[kRun];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const long long u = u0 + 32 * k;
        const int4 x = u < nv ? __ldcs(vidx + u) : make_int4(-1, -1, -1, -1);
        ix[4 * k] = x.x;
        ix[4 * k + 1] = x.y;
        ix[4 * k + 2] = x.z;
        ix[4 * k + 3] = x.w;
      }
      T r[kRun];
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        r[e] = take_one(tab.at(4 * (u0 + 32 * (e / 4)) + e % 4), n, ix[e], fill, policy);
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const long long u = u0 + 32 * k;
        if (u < nv) {
          Pack4<T> o;
#pragma unroll
          for (int e = 0; e < 4; ++e) o.e[e] = r[4 * k + e];
          __stcs(reinterpret_cast<uint4*>(out) + u, o.v);
        }
      }
      return;
    }
    // the tail after the aligned body
    const long long j = t - tv + 4 * nv;
    if (j < m) out[j] = take_one(tab.at(j), n, __ldcs(idx + j), fill, policy);
  } else {
    const long long j0 = (t >> 5) * 32 * kRun + lane;
    int ix[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const long long j = j0 + 32 * k;
      ix[k] = j < m ? __ldcs(idx + j) : -1;
    }
    T r[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) r[k] = take_one(tab.at(j0 + 32 * k), n, ix[k], fill, policy);
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const long long j = j0 + 32 * k;
      if (j < m) __stcs(out + j, r[k]);
    }
  }
}

// weight_gather: the COUNT pushdown's value of each edge j of one class and
// direction,
//   out[j] = keep(j) ? (w ? take_pad(w, e, 0) : 1) : 0,   e = emit[j],
//   keep(j) = take_pad(ok, e, false) & node_ok[j]
//             & (eid ? take_pad(emask, eid[j], false) : emask[j]),
// each factor only where its operand is given; without emit, e = j (the
// identity over the vertex universe: `ok ? w : 0`, the vertex mask folded
// into the weights before the walks gather them). This is the reference's
// `em & take_pad(ok_vec, emit, False)`, `.astype(dtype)`, `* take_pad(w,
// emit, dtype(0))` in one pass, bit for bit wherever the weights are finite
// and not -0.0 (T(0) * w is +0 there), as the pushdown's weights, sums of
// ones, always are. Bound: 4 bytes of emit, 4
// of eid, 1 of node_ok and of a direct emask read and 4 written an edge,
// each table (ok, w, a gathered emask) read once: Q1's step (emit, ok,
// out) 9 bytes an edge. A random gather moves a 32-byte sector out of L2
// whatever its width, so the gathers, not the streams, bound it. Design:
// take_pad's (a warp owns 32 * 8 consecutive edges, a thread 8: two 16-byte
// vectors of emit, eid and output, two 4-byte words of each byte stream;
// streams evict-first, each table under take_pad's L2 policy), with the
// gathers in stages that load only for the edges still kept: the vertex
// mask (a small table), then the edge mask through eid (the in walk's, as
// large as the edge list), then the weight, each stage's loads of a
// thread's 8 edges issued together as predicated instructions; emit is not
// read where no table is read through it (the node-mask operand alone).
struct WeightArgs {
  const int* emit;                // [m] far endpoints, or null (e = j)
  long long m;
  const unsigned char* ok;        // [n_ok] a vertex mask read at e, or null
  long long n_ok;
  const unsigned char* node_ok;   // [m] the node mask at each edge's endpoint, or null
  const unsigned char* emask;     // an edge mask, read at eid[j] (or at j), or null
  long long n_em;
  const int* eid;                 // [m] edge ids into emask, or null
  const void* w;                  // [n_w] the weights after this hop, or null (ones)
  long long n_w;
  unsigned keep;                  // tables under evict_last: 1 ok, 2 emask, 4 w
};

constexpr int kWeightRun = 8;  // edges a thread

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) weight_gather_kernel(const WeightArgs a, T* __restrict__ out) {
  const bool direct_em = a.emask != nullptr && a.eid == nullptr;
  const bool need_e = a.ok != nullptr || a.w != nullptr;  // a table is read through emit
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int e[kWeightRun], id[kWeightRun];
  unsigned nb[kWeightRun], ed[kWeightRun];  // node_ok and direct emask bytes
  long long nv = 0, tv = 0, u0 = 0, j0 = 0;
  bool scalar_one = false;  // this thread takes one element of the tail
  long long js = 0;
  if constexpr (kVec) {
    nv = a.m / 4;
    tv = (nv + 63) / 64 * 32;
    if (t < tv) {
      u0 = (t >> 5) * 64 + lane;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long long u = u0 + 32 * k;
        const bool in = u < nv;
        const int j = static_cast<int>(4 * u);
        const int4 x = !(in && need_e) ? make_int4(-1, -1, -1, -1)
                       : a.emit != nullptr ? __ldcs(reinterpret_cast<const int4*>(a.emit) + u)
                                           : make_int4(j, j + 1, j + 2, j + 3);
        const int4 y = in && a.eid != nullptr ? __ldcs(reinterpret_cast<const int4*>(a.eid) + u)
                                              : make_int4(0, 0, 0, 0);
        const unsigned wn = !in ? 0u
                            : a.node_ok != nullptr
                                ? __ldcs(reinterpret_cast<const unsigned*>(a.node_ok) + u)
                                : 0x01010101u;
        const unsigned we = !in ? 0u
                            : direct_em ? __ldcs(reinterpret_cast<const unsigned*>(a.emask) + u)
                                        : 0x01010101u;
        e[4 * k] = x.x;
        e[4 * k + 1] = x.y;
        e[4 * k + 2] = x.z;
        e[4 * k + 3] = x.w;
        id[4 * k] = y.x;
        id[4 * k + 1] = y.y;
        id[4 * k + 2] = y.z;
        id[4 * k + 3] = y.w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          nb[4 * k + q] = (wn >> (8 * q)) & 0xffu;
          ed[4 * k + q] = (we >> (8 * q)) & 0xffu;
        }
      }
    } else {
      js = t - tv + 4 * nv;
      if (js >= a.m) return;
      scalar_one = true;
    }
  } else {
    j0 = (t >> 5) * 32 * kWeightRun + lane;
  }
  if (!kVec || scalar_one) {
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      const long long j = scalar_one ? js : j0 + 32 * k;
      const bool in = j < a.m && (k == 0 || !scalar_one);
      e[k] = !(in && need_e) ? -1 : a.emit != nullptr ? __ldcs(a.emit + j) : static_cast<int>(j);
      id[k] = in && a.eid != nullptr ? __ldcs(a.eid + j) : 0;
      nb[k] = !in ? 0u : a.node_ok != nullptr ? static_cast<unsigned>(__ldcs(a.node_ok + j)) : 1u;
      ed[k] = !in ? 0u : direct_em ? static_cast<unsigned>(__ldcs(a.emask + j)) : 1u;
    }
  }
  // each stage gathers only for the edges still kept: the vertex mask (a
  // small table), then the edge mask through eid, then the weight
  bool keep[kWeightRun];
#pragma unroll
  for (int k = 0; k < kWeightRun; ++k) keep[k] = nb[k] != 0u && ed[k] != 0u;
  if (a.ok != nullptr) {
    const unsigned long long policy = l2_policy(a.keep & 1u);
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      keep[k] = take_one(a.ok, a.n_ok, keep[k] ? e[k] : -1, static_cast<unsigned char>(0), policy) != 0;
    }
  }
  if (a.eid != nullptr) {
    const unsigned long long policy = l2_policy(a.keep & 2u);
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      keep[k] = take_one(a.emask, a.n_em, keep[k] ? id[k] : -1, static_cast<unsigned char>(0), policy) != 0;
    }
  }
  T r[kWeightRun];
  if (a.w != nullptr) {
    const T* w = static_cast<const T*>(a.w);
    const unsigned long long policy = l2_policy(a.keep & 4u);
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) r[k] = take_one(w, a.n_w, keep[k] ? e[k] : -1, T(0), policy);
  } else {
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) r[k] = keep[k] ? T(1) : T(0);
  }
  if (kVec && !scalar_one) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const long long u = u0 + 32 * k;
      if (u < nv) {
        Pack4<T> o;
#pragma unroll
        for (int q = 0; q < 4; ++q) o.e[q] = r[4 * k + q];
        uint4* to = reinterpret_cast<uint4*>(out) + u;
        if (a.emit != nullptr) {
          __stcs(to, o.v);
        } else {
          *to = o.v;  // folded weights: left in L2 for the walks' gathers
        }
      }
    }
  } else if (scalar_one) {
    out[js] = r[0];
  } else {
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      const long long j = j0 + 32 * k;
      if (j < a.m) __stcs(out + j, r[k]);
    }
  }
}

// weight_gather's lane form: out[l * m + j] for B lanes l (the reference's
// chain under its vmap over a group's lanes), each of ok, node_ok, emask
// and w shared (stride 0) or lane-stacked, lane-major (lane l's row at
// + l * stride: K15's lane form writes masks so, K4's reads values so, and a
// lane's stream stays contiguous); emit and eid are shared. Bound: emit,
// eid and the shared streams once an edge, each shared table once; a lane
// its lane-stacked mask bytes (or, read through emit or eid, a random
// 32-byte sector each) and 4 bytes written an edge. Design: the lane loop
// runs inside the thread over the lane-varying operands only. A thread
// owns kWeightRun edges warp-striped (a warp's load or store instruction
// covers contiguous memory), loads their emit and eid, the shared node and
// direct edge masks, and gathers the shared tables (the vertex mask, the
// edge mask through eid, the weight) once, for the edges still kept; then
// for each lane it ANDs that lane's masks in (a gather through emit or eid
// for a lane-stacked table, only where the edge is still kept) and stores
// the lane's values. E1's random gathers of its folded weights through
// emit then happen once for all lanes, not once a lane.
struct WeightLaneArgs {
  const int* emit;                // [m] far endpoints, or null (e = j)
  long long m;
  const unsigned char* ok;        // a vertex mask [n_ok] a row, or null
  long long n_ok, ok_stride;      // stride 0: shared
  const unsigned char* node_ok;   // [m] a row, or null
  long long node_stride;
  const unsigned char* emask;     // an edge mask [n_em] a row, at eid[j] (or j), or null
  long long n_em, em_stride;
  const int* eid;                 // [m] edge ids into emask, or null
  const void* w;                  // weights [n_w] a row, or null (ones)
  long long n_w, w_stride;
  long long lanes;
  unsigned keep;                  // tables under evict_last: 1 ok, 2 emask, 4 w
};

template <typename T>
__global__ void __launch_bounds__(kThreads) weight_gather_lanes_kernel(const WeightLaneArgs a,
                                                                      T* __restrict__ out) {
  const bool need_e = a.ok != nullptr || a.w != nullptr;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long j0 = (t >> 5) * 32 * kWeightRun + (threadIdx.x & 31);
  const unsigned long long p_ok = l2_policy(a.keep & 1u), p_em = l2_policy(a.keep & 2u),
                           p_w = l2_policy(a.keep & 4u);
  const T* w = static_cast<const T*>(a.w);
  int e[kWeightRun], id[kWeightRun];
  bool in[kWeightRun], keep[kWeightRun];
  T wv[kWeightRun];
#pragma unroll
  for (int k = 0; k < kWeightRun; ++k) {
    const long long j = j0 + 32 * k;
    in[k] = j < a.m;
    e[k] = !(in[k] && need_e) ? -1 : a.emit != nullptr ? __ldcs(a.emit + j) : static_cast<int>(j);
    id[k] = in[k] && a.eid != nullptr ? __ldcs(a.eid + j) : 0;
    keep[k] = in[k];
    if (in[k] && a.node_ok != nullptr && a.node_stride == 0) keep[k] = __ldcs(a.node_ok + j) != 0;
    if (keep[k] && a.emask != nullptr && a.eid == nullptr && a.em_stride == 0) {
      keep[k] = __ldcs(a.emask + j) != 0;
    }
  }
  // the shared tables, once for every lane, for the edges still kept
  if (a.ok != nullptr && a.ok_stride == 0) {
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      keep[k] = take_one(a.ok, a.n_ok, keep[k] ? e[k] : -1, static_cast<unsigned char>(0), p_ok) != 0;
    }
  }
  if (a.emask != nullptr && a.eid != nullptr && a.em_stride == 0) {
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      keep[k] = take_one(a.emask, a.n_em, keep[k] ? id[k] : -1, static_cast<unsigned char>(0), p_em) != 0;
    }
  }
  const bool w_shared = w != nullptr && a.w_stride == 0;
#pragma unroll
  for (int k = 0; k < kWeightRun; ++k) {
    wv[k] = w_shared ? take_one(w, a.n_w, keep[k] ? e[k] : -1, T(0), p_w) : T(1);
  }
  // the lane-varying operands, lane by lane
  for (long long l = 0; l < a.lanes; ++l) {
    bool kl[kWeightRun];
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      const long long j = j0 + 32 * k;
      kl[k] = keep[k];
      if (kl[k] && a.node_stride != 0) kl[k] = __ldcs(a.node_ok + l * a.node_stride + j) != 0;
      if (kl[k] && a.emask != nullptr && a.eid == nullptr && a.em_stride != 0) {
        kl[k] = __ldcs(a.emask + l * a.em_stride + j) != 0;
      }
    }
    if (a.ok != nullptr && a.ok_stride != 0) {
      const unsigned char* ok = a.ok + l * a.ok_stride;
#pragma unroll
      for (int k = 0; k < kWeightRun; ++k) {
        kl[k] = take_one(ok, a.n_ok, kl[k] ? e[k] : -1, static_cast<unsigned char>(0), p_ok) != 0;
      }
    }
    if (a.emask != nullptr && a.eid != nullptr && a.em_stride != 0) {
      const unsigned char* em = a.emask + l * a.em_stride;
#pragma unroll
      for (int k = 0; k < kWeightRun; ++k) {
        kl[k] = take_one(em, a.n_em, kl[k] ? id[k] : -1, static_cast<unsigned char>(0), p_em) != 0;
      }
    }
    T r[kWeightRun];
    if (w != nullptr && !w_shared) {
      const T* wl = w + l * a.w_stride;
#pragma unroll
      for (int k = 0; k < kWeightRun; ++k) r[k] = take_one(wl, a.n_w, kl[k] ? e[k] : -1, T(0), p_w);
    } else {
#pragma unroll
      for (int k = 0; k < kWeightRun; ++k) r[k] = kl[k] ? wv[k] : T(0);
    }
    T* ol = out + l * a.m;
#pragma unroll
    for (int k = 0; k < kWeightRun; ++k) {
      const long long j = j0 + 32 * k;
      if (in[k]) {
        if (a.emit != nullptr) {
          __stcs(ol + j, r[k]);
        } else {
          ol[j] = r[k];  // folded weights: left in L2 for the walks' gathers
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5b: mask_count (replaces csr.mask_count, orientdb_tpu/ops/csr.py:222).
// Bound: n bytes read, 4 written (2^23: 0.0025 ms). The first cut loaded a
// byte a thread at a time over up to 4,096 blocks, after a memset of the
// count, with an atomic a warp. Design: 16-byte loads, kCountLoads of them
// in flight a thread, bytes counted by __popc(__vcmpne4(word, 0) &
// 0x01010101) (any non-zero byte counts, as before), a block's sum by warp
// shuffles and shared memory. A mask of at most one block's tile (16 KiB:
// V1's chunk counts, small root masks) is counted by one block that
// stores the count: no memset, no atomic. A larger one gets a one-wave
// grid (kCountBlocksPerSm blocks an SM, each looping over tiles) and one
// atomic a block into a count the entry point zeroes first; integer adds
// commute, so the count is exact and the same on every call. An unaligned
// head and the tail are counted a byte a thread by block 0.
// The lane form (K5b over a [B, n] mask, replacing csr.mask_count under the
// reference's vmap) counts row b in grid row b (blockIdx.y): one launch for
// all lanes, each row counted as above; a row shares nothing with another,
// so the lane is a grid dimension here.
// ---------------------------------------------------------------------------
constexpr int kCountLoads = 4;
constexpr long long kCountTile = static_cast<long long>(kThreads) * kCountLoads * 16;
constexpr int kCountBlocksPerSm = 4;

__device__ inline unsigned nonzero_bytes(unsigned x) { return __popc(__vcmpne4(x, 0u) & 0x01010101u); }

__global__ void __launch_bounds__(kThreads)
    mask_count_kernel(const unsigned char* __restrict__ masks, long long n, long long stride,
                      unsigned* __restrict__ outs, int store) {
  __shared__ unsigned sums[kWarps];
  const int tid = threadIdx.x;
  const unsigned char* mask = masks + blockIdx.y * stride;
  unsigned* out = outs + blockIdx.y;
  long long head = static_cast<long long>((16u - (reinterpret_cast<uintptr_t>(mask) & 15u)) & 15u);
  if (head > n) head = n;
  const long long groups = (n - head) / 16;
  const uint4* v = reinterpret_cast<const uint4*>(mask + head);
  unsigned c = 0;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kCountLoads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kCountLoads + tid; base < groups;
       base += step) {
    uint4 x[kCountLoads];
#pragma unroll
    for (int k = 0; k < kCountLoads; ++k) {
      const long long g = base + static_cast<long long>(k) * kThreads;
      x[k] = g < groups ? __ldcs(v + g) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kCountLoads; ++k) {
      c += nonzero_bytes(x[k].x) + nonzero_bytes(x[k].y) + nonzero_bytes(x[k].z) + nonzero_bytes(x[k].w);
    }
  }
  if (blockIdx.x == 0) {
    const long long tail = head + 16 * groups;
    if (tid < head) c += mask[tid] != 0;
    if (tail + tid < n) c += mask[tail + tid] != 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  if ((tid & 31) == 0) sums[tid >> 5] = c;
  __syncthreads();
  if (tid < 32) {
    c = tid < kWarps ? sums[tid] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
    if (tid == 0) {
      if (store) {
        *out = c;
      } else if (c) {
        atomicAdd(out, c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: front_pack (replaces the front-pack of _CompiledPlan._replay_core,
// orientdb_tpu/exec/tpu_engine.py:3030-3039: compact_indices over the valid
// mask, then a stack of take_pad(col, perm, -1)).
// Bound: W*4 bytes of valid + W*4 of ranks + C*W*4 of columns read,
// C*W*4 written (Q3's W = 2^17, C = 3: ~2.6 MB, under a microsecond of
// bytes). Design: after K1's inclusive scan of the valid mask, one thread
// per slot moves its C values to row ranks[t]-1 of a row-major [W, C]
// output (a page of the result is then a contiguous prefix of rows), and
// every row at or past the live count is -1. The reference's [W] perm is
// never materialised. Column pointers travel by value, kMaxCols a launch.
// ---------------------------------------------------------------------------
constexpr int kMaxCols = 16;
struct ColPtrs {
  const int* p[kMaxCols];
};

__global__ void front_pack_kernel(const int* __restrict__ valid,
                                  const int* __restrict__ ranks, long long w,
                                  ColPtrs cols, int ncols, int col0, int stride,
                                  int* __restrict__ out, long long out_lane) {
  // the lane form: grid row y packs lane y of [lanes, w] valid masks,
  // ranks and columns into the [w, stride] rows at out + y * out_lane
  const long long y = blockIdx.y;
  valid += y * w;
  ranks += y * w;
  out += y * out_lane;
  long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= w) return;
  if (valid[t] != 0) {
    long long r = static_cast<long long>(ranks[t]) - 1;
    for (int c = 0; c < ncols; ++c) out[r * stride + col0 + c] = cols.p[c][y * w + t];
  }
  if (t >= static_cast<long long>(ranks[w - 1])) {
    for (int c = 0; c < ncols; ++c) out[t * stride + col0 + c] = -1;
  }
}

// ---------------------------------------------------------------------------
// K7: replay_meta (replaces _CompiledPlan._fits16_flag :3041 and the meta
// stack of _replay :3179-3181 / the direct buffer's meta row :3169-3173).
// Bound: count*C*4 bytes of the live prefix read, 12 bytes written.
// Design: one block strides over the live prefix of the front-packed [W, C]
// rows (count clipped to [0, W]); __syncthreads_or joins the "a value is
// outside (-32768, 32767)" bits, and thread 0 writes [count, overflow,
// fits16]. One block is enough for the result widths of a row plan; the
// result sizes nothing else, so no grid-wide reduction is needed.
// ---------------------------------------------------------------------------
constexpr int kMetaThreads = 1024;

__global__ void replay_meta_kernel(const int* __restrict__ data, long long w,
                                   int ncols, const int* __restrict__ count,
                                   const int* __restrict__ overflow,
                                   int* __restrict__ out, long long data_lane, long long out_lane) {
  // the lane form: block b writes lane b's row from its [w, ncols] page at
  // data + b * data_lane, its count and its flag, to out + b * out_lane
  const long long b = blockIdx.x;
  data += b * data_lane;
  count += b;
  overflow += b;
  out += b * out_lane;
  long long n = *count;
  if (n < 0) n = 0;
  if (n > w) n = w;
  n *= ncols;
  int bad = 0;
  for (long long i = threadIdx.x; i < n; i += kMetaThreads) {
    int x = data[i];
    bad |= (x >= 32767) | (x <= -32768);
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    out[0] = *count;
    out[1] = *overflow;
    out[2] = bad ? 0 : 1;
  }
}

// ---------------------------------------------------------------------------
// K8: narrow_i16 (replaces the int16 pages of _replay :3197-3201,
// `.astype(jnp.int16)`). Bound: n*4 bytes read, n*2 written. One thread per
// element; the conversion keeps the low 16 bits, as XLA's s32->s16 does.
// ---------------------------------------------------------------------------
__global__ void narrow_i16_kernel(const int* __restrict__ in, long long n,
                                  short* __restrict__ out) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = static_cast<short>(static_cast<unsigned short>(in[i] & 0xffff));
}

// ---------------------------------------------------------------------------
// K9–K12: the bitmap BFS of variable-depth MATCH arms and of NOT arms.
// A frontier is a [C, vb] bool bitmap (one byte a vertex, row c for binding
// row c of a chunk), vb = bucket(V) = 2^23 at 8M vertices and C = 8, so one
// bitmap is 64 MiB. bool bytes are 0 or 1, so a 32-bit word of them ANDs,
// ORs and popcounts (__popc counts set bytes) as four flags at once.
// ---------------------------------------------------------------------------

constexpr unsigned kMaxBlocks = 132 * 32;  // grid-stride loops: 32 blocks an SM

inline unsigned grid_for(long long n, long long per_thread) {
  long long b = (n + kThreads * per_thread - 1) / (kThreads * per_thread);
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Adds each thread's `c` into *out: warp shuffles, one atomic a warp.
__device__ inline void warp_count_add(unsigned c, unsigned* out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(out, c);
}

union Bytes16 {
  uint4 v;
  unsigned w[4];
  unsigned char b[16];
};

// ---------------------------------------------------------------------------
// K9: rows_to_bitmap (replaces csr.rows_to_bitmap, orientdb_tpu/ops/csr.py:251).
// Bound: C*4 bytes read, C*vb written (64 MiB at C = 8: ~0.02 ms). The
// entry point zeroes the bitmap (cudaMemsetAsync, the write bound) and one
// thread per row sets its clipped column; a row id < 0 leaves its row zero.
// ---------------------------------------------------------------------------
__global__ void rows_to_bitmap_kernel(const int* __restrict__ rows, long long c,
                                      long long vb, unsigned char* __restrict__ out) {
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= c) return;
  int r = rows[i];
  if (r < 0) return;
  long long col = r < vb ? r : vb - 1;  // jnp.clip(rows, 0, vb - 1)
  out[i * vb + col] = 1;
}

// ---------------------------------------------------------------------------
// K10, edge-list form: bitmap_hop (csr.bitmap_hop, orientdb_tpu/ops/csr.py:260,
// over an arbitrary edge list; the engine runs it over a delta slab's slots,
// which no CSR row holds, beside the CSR form below, for a class one of
// whose buckets filled: the others probe the slab inside the push,
// SlabProbe below).
// out[c, emit[e]] |= frontier[c, act[e]] & mask[e] (& gate[act[e]]).
// Bound: 8 bytes of endpoints (+1 of mask, +1 of gate) an edge, the
// frontier read once and `out` written once: 9*E + 2*64 MiB ~ 0.85 GB,
// ~0.25 ms at E = 80M. Design: a grid-stride loop over the edges, one edge
// a thread; per edge the C frontier bytes at the active endpoint are read
// (out-CSR order makes `act` = edge_src ascending for an out hop, so those
// reads coalesce; an in hop reads them scattered) and a 1 is stored at the
// emitted endpoint only where a row is active. Threads that race on one
// byte all store 1, so no atomics are needed; a 0 is never stored (the
// entry point zeroes `out` first, or accumulates into it). `alive` (may be
// null) is the frontier's popcount on the device (K12's, or the roots'):
// when it is 0 every thread returns at once, so the many hops that walk an
// empty frontier cost a memset and a launch. The optional `gate` is the
// WHILE condition at the level being expanded, read at the active endpoint
// (the reference's `frontier & gate[None, :]`, folded in).
// ---------------------------------------------------------------------------
__global__ void bitmap_hop_kernel(const int* __restrict__ act,
                                  const int* __restrict__ emit,
                                  const unsigned char* __restrict__ emask,
                                  long long ne,
                                  const unsigned char* __restrict__ frontier,
                                  const unsigned char* __restrict__ gate,
                                  long long c, long long vb,
                                  const int* __restrict__ alive,
                                  unsigned char* __restrict__ out) {
  if (alive != nullptr && *alive == 0) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       e < ne; e += stride) {
    if (emask != nullptr && !emask[e]) continue;
    long long a = act[e];
    a = a < 0 ? 0 : (a < vb ? a : vb - 1);  // jnp.clip(act_idx, 0, vb - 1)
    if (gate != nullptr && !gate[a]) continue;
    long long m = emit[e];
    m = m < 0 ? 0 : (m < vb ? m : vb - 1);  // jnp.clip(emit_idx, 0, vb - 1)
    for (long long r = 0; r < c; ++r) {
      if (frontier[r * vb + a]) out[r * vb + m] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// K10, push forms: one frontier hop walked by the endpoint that must be
// active, reading only the active vertices' adjacency. One kernel body
// (bitmap_push_kernel) over three row lookups:
// - CsrRows, K10's CSR form: bitmap_hop_csr (replaces csr.bitmap_hop,
//   orientdb_tpu/ops/csr.py:260, as build_bitmap_hops drives it,
//   orientdb_tpu/exec/tpu_engine.py:487, over a class's base CSR);
// - ShardRows, K10's eid form: bitmap_hop_shard (replaces
//   mesh_graph.sharded_bitmap_hop, orientdb_tpu/parallel/mesh_graph.py:426,
//   which scatters every edge of each shard's edge-list slice) over the
//   row-sharded CSR of the direction (`sh:<class>:{out,in}:*`);
// - PagedRows, K19: paged_hop_csr (replaces tiering.paged_hop,
//   orientdb_tpu/storage/tiering.py:575, which walks every pool slot) over
//   the resident indptr and the page indirection of a paged partition.
// With CsrRows a `Probe` (SlabProbe) may add a delta slab's edges of each
// active vertex (bitmap_hop_probe, K10's CSR form on dirty topology).
// out[c, nbr[s]] |= frontier[c, v] & gate[v] & mask[edge(s)] for every slot
// s of row v: the rows are the endpoint that must be active, `nbr` the
// endpoint reached, edge(s) the slot's out-order edge id, read only to
// index `mask` (a negative id reads False, one past the end the last entry:
// take_pad's semantics). The mask is tested first and `nbr` clipped after,
// as the reference's edge list does (a tombstoned slot's -1 neighbour is
// masked by `live` before its clip could alias vertex 0).
// Bound: the work depends on the frontier. Read: C*vb frontier bytes (and
// vb of gate), 8 bytes of indptr an active vertex (+4 of ebase a shard
// row, +12 of blockv / pageof / estart a paged row), 4 of nbr (+1 of mask,
// +4 of eid) an edge of an active vertex; written: C*vb. At V1's level 1
// (8 roots, ~80 active vertices, [8, 2^23]): 2*64 MiB, ~0.04 ms.
// Design: a warp takes 128 vertices a step (4 a lane: one 32-bit load a
// frontier row, coalesced), ANDs in the gate and packs its vertices' rows
// into a 32-bit row mask (rows in blocks of 32 when C > 32). A ballot skips
// the group when none is active, so a sparse hop costs its frontier read
// and the zeroing. Otherwise the warp looks up its active vertices' rows
// (Rows::row: the slot base, the degree and an operand of the slot and
// edge-id maps), lists those of nonzero degree in shared memory (base,
// operand, exclusive prefix of degree, row mask; two warp scans), walks the
// flat span of their edges 32 slots a step, each lane finding its slot's
// vertex by a binary search of the prefixes, and stores a 1 for each set
// row bit at the reached vertex. Every entry keeps its own base, so the
// slots of neighbouring vertices need not be contiguous (a group straddling
// two shards, or two pages); within a row they are, so nbr reads coalesce
// at any density. Racing stores all write 1: no atomics. The walk covers
// the vertices [lo, hi) (hi <= vb); the grid is sized from that row count,
// never from the active count, so a captured replay needs no host read;
// `alive` at 0 returns at once.
// ---------------------------------------------------------------------------
constexpr int kHopGroup = 128;  // vertices a warp step: 4 a lane

// K10's CSR form: row v is indptr[v] .. indptr[v+1] of `nbr`; the edge id is
// eid[slot] (eid may be null: the mask is then indexed by slot).
struct CsrRows {
  const int* indptr;
  const int* eid;
  long long lo, hi;
  __device__ int row(long long v, long long& base, long long& aux) const {
    const int st = indptr[v];
    base = st;
    aux = 0;
    return indptr[v + 1] - st;
  }
  __device__ long long slot(long long base, long long, int j) const { return base + j; }
  __device__ long long edge(long long s, long long) const { return eid != nullptr ? eid[s] : s; }
};

// K10's eid form over the row-sharded CSR of the shards s0 .. s0 + S_l - 1
// held here: vertex v is row v - s*R of shard s = v / R, whose rebased
// indptr row is indptr[(s - s0) * (R + 1) ...] and whose slots are
// nbr[(s - s0) * emax ...]. The edge id is ebase[s - s0] + the local slot
// (out: `extra` is ebase, [S_l]) or eid[s - s0, local slot] (in: `extra` is
// the in CSR's out-order ids, [S_l, emax]). Rows past V repeat the last
// offset (degree 0).
struct ShardRows {
  const int* indptr;
  const int* extra;
  long long r, s0, emax;
  int is_out;
  long long lo, hi;
  __device__ int row(long long v, long long& base, long long& aux) const {
    const long long sl = v / r - s0;
    const int* ind = indptr + sl * (r + 1);
    const long long l = v - (sl + s0) * r;
    const int st = ind[l];
    base = sl * emax + st;
    aux = is_out ? static_cast<long long>(extra[sl]) - sl * emax : 0;
    return ind[l + 1] - st;
  }
  __device__ long long slot(long long base, long long, int j) const { return base + j; }
  __device__ long long edge(long long s, long long aux) const { return is_out ? s + aux : extra[s]; }
};

// K19 over a paged partition: vertex v's edges are indptr[v] .. indptr[v+1]
// of the partition's order; its block b = blockv[v] sits at page p =
// pageof[b] (-1: cold, no slots), where edge i is slot p*Wp + i - estart[b]
// of the pool, with K21's clips (b to nb - 1, the local slot to [0, Wp-1],
// the flat slot to ns - 1). nbr and the edge id are read from the pool's
// rows in both directions. The push relies on the pool invariant that
// TierManager keeps (storage/tiering.py): a resident block's page holds
// that block's slots (`_load_blocks` copies the rows, then `pageof`), and
// an evicted block's pageof is -1 before its page is reused (`_evict` sets
// the host entry, and the device copy of pageof ends the same load wave,
// on the replay stream, before any hop reads the page). So every slot the
// reference's slot walk counts (own >= 0: a resident block's row) is one
// the push reaches, and an evicted page's stale nbr / eid rows behind a -1
// owner row are never read. A cold block contributes nothing, as in the
// slot walk. With `miss` (K20 folded in) the row map also raises the
// cold-miss flag, as tiering.paged_hop_miss (orientdb_tpu/storage/
// tiering.py:590) does: an active, gated vertex with edges whose block b
// lies in [0, nb) (a b past the end is clipped for the reads but never
// flags) and is cold. It stores only 1s; the caller zeroes the byte. The
// walk then covers [0, min(V, vb)) even when the pool holds no slot.
struct PagedRows {
  const int* indptr;
  const int* blockv;
  const int* pageof;
  const int* estart;
  const int* eid;
  long long nb, wp, ns;
  long long lo, hi;
  unsigned char* miss;  // the cold-miss flag, or null
  __device__ int row(long long v, long long& base, long long& aux) const {
    const int b = blockv[v];
    if (b < 0 || nb <= 0) return 0;
    const long long bc = b < nb ? b : nb - 1;
    const int p = pageof[bc];
    if (p < 0) {
      if (miss != nullptr && b < nb && indptr[v + 1] > indptr[v]) *miss = 1;
      return 0;
    }
    if (ns <= 0) return 0;
    const int st = indptr[v];
    base = static_cast<long long>(p) * wp;
    aux = static_cast<long long>(st) - estart[bc];
    return indptr[v + 1] - st;
  }
  __device__ long long slot(long long base, long long aux, int j) const {
    long long local = aux + j;
    local = local < 0 ? 0 : (local < wp ? local : wp - 1);
    const long long s = base + local;
    return s < ns ? s : ns - 1;
  }
  __device__ long long edge(long long s, long long) const { return eid[s]; }
};

// The slab's part of a dirty hop, folded into K10's CSR push (replaces the
// edge-list form over a delta slab's whole window [base, cap), which the
// engine ran beside the CSR form: orientdb_tpu/exec/tpu_engine.py:527-542
// runs csr.bitmap_hop over every edge with the `live` mask). A delta-
// maintained snapshot indexes its appended edges by endpoint
// (storage/deltas.py's bucket tables `bk:{class}:{out,in}`): NB buckets of
// BK relative slab slots, bucket key & (NB - 1), -1 empty; every live slab
// edge of a class whose buckets never filled is in the bucket of its active
// endpoint. For each active, gated vertex v of its group the push reads
// bucket v & (NB - 1) (BK int32: one 32-byte sector at BK = 8) and keeps
// entry rel >= 0 at slot at = base + rel where at < the edge count, own[at]
// == v (a bucket is shared by many vertices), live[at] and take_pad(emask,
// at, False) hold; it stores a 1 at clip(nbr[at], 0, vb - 1) for each set
// row bit. Bound added to the push: BK * 4 bytes an active vertex, 5 (own
// and live) a filled entry, 4 (+1 of emask) a kept one. A vertex of base
// degree 0 probes too (a vertex appended to the slab has no CSR row); the
// walk covers [0, min(nv, vb)), every vertex a slab edge can start from
// when the CSR's indptr spans the padded vertex universe.
struct SlabProbe {
  const int* tab;  // [nb * bk]
  const int* own;  // the endpoint that must be active, a slot
  const int* nbr;  // the endpoint reached, a slot
  const unsigned char* live;
  long long base, ecap;
  int nb, bk;
  __device__ __forceinline__ void visit(long long v, unsigned bits, const unsigned char* __restrict__ emask,
                                        long long ne, long long rb, long long vb,
                                        unsigned char* __restrict__ out) const {
    const int* t = tab + static_cast<long long>(static_cast<int>(v) & (nb - 1)) * bk;
    for (int j0 = 0; j0 < bk; j0 += 8) {
      int rel[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) rel[q] = j0 + q < bk ? __ldg(t + j0 + q) : -1;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long at = base + rel[q];
        if (rel[q] < 0 || at >= ecap) continue;
        if (__ldg(own + at) != v || !__ldg(live + at)) continue;
        if (emask != nullptr && (ne <= 0 || !emask[at < ne ? at : ne - 1])) continue;
        long long m = __ldg(nbr + at);
        m = m < 0 ? 0 : (m < vb ? m : vb - 1);  // jnp.clip(emit_idx, 0, vb - 1)
        unsigned b = bits;
        while (b != 0u) {
          const int r = __ffs(b) - 1;
          b &= b - 1u;
          out[(rb + r) * vb + m] = 1;
        }
      }
    }
  }
};

// No slab: the push forms without a probe.
struct NoProbe {
  __device__ __forceinline__ void visit(long long, unsigned, const unsigned char*, long long, long long,
                                        long long, unsigned char*) const {}
};

// The lane form (under the reference's vmap of a group replay: frontier
// [B, C, vb], lane-major): blockIdx.y is the lane, whose blocks walk only
// its own C rows, so a 32-row batch never straddles two lanes and the
// lane's gate row (gate_stride vb; 0: one gate the lanes share) and alive
// count are the block's constants; a lane whose alive is 0 returns at once.
// The single form is instantiated without the lane arithmetic (kLanes
// false).
template <bool kVec, bool kLanes, typename Rows, typename Probe>
__global__ void __launch_bounds__(kThreads)
bitmap_push_kernel(const Rows rows, const Probe probe, const int* __restrict__ nbr,
                   const unsigned char* __restrict__ emask, long long ne,
                   const unsigned char* __restrict__ frontier,
                   const unsigned char* __restrict__ gate, long long c, long long vb,
                   const int* __restrict__ alive, unsigned char* __restrict__ out,
                   long long gate_stride) {
  if constexpr (kLanes) {
    const long long lane = blockIdx.y;
    frontier += lane * c * vb;
    out += lane * c * vb;
    if (gate != nullptr) gate += lane * gate_stride;
    if (alive != nullptr) alive += lane;
  }
  if (alive != nullptr && *alive == 0) return;
  __shared__ long long s_base[kWarps][kHopGroup];
  __shared__ long long s_aux[kWarps][kHopGroup];
  __shared__ int s_pref[kWarps][kHopGroup];
  __shared__ unsigned s_rows[kWarps][kHopGroup];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long lo = rows.lo, hi = rows.hi;
  const long long g0 = lo / kHopGroup;  // groups start 128-aligned: v0 % 4 == 0
  const long long groups = (hi + kHopGroup - 1) / kHopGroup - g0;
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + w; g < groups; g += wstride) {
    const long long v0 = (g0 + g) * kHopGroup + 4 * lane;  // this lane's first vertex
    for (long long rb = 0; rb < c; rb += 32) {
      const int nr = static_cast<int>(c - rb < 32 ? c - rb : 32);
      unsigned mk[4] = {0u, 0u, 0u, 0u};
      if (v0 < hi && v0 + 3 >= lo) {
        const unsigned char* f = frontier + rb * vb + v0;
        if (kVec) {
          // vb % 4 == 0 and v0 < hi <= vb: the 4 bytes lie inside the row
#pragma unroll 8
          for (int r = 0; r < nr; ++r) {
            const unsigned x = __ldg(reinterpret_cast<const unsigned*>(f + r * vb));
#pragma unroll
            for (int k = 0; k < 4; ++k) mk[k] |= static_cast<unsigned>(((x >> (8 * k)) & 0xffu) != 0) << r;
          }
          if (gate != nullptr) {
            const unsigned x = __ldg(reinterpret_cast<const unsigned*>(gate + v0));
#pragma unroll
            for (int k = 0; k < 4; ++k) if (((x >> (8 * k)) & 0xffu) == 0) mk[k] = 0;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (v0 + k >= hi) break;
            if (v0 + k < lo) continue;
            for (int r = 0; r < nr; ++r) mk[k] |= static_cast<unsigned>(f[r * vb + k] != 0) << r;
            if (gate != nullptr && !gate[v0 + k]) mk[k] = 0;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) if (v0 + k < lo || v0 + k >= hi) mk[k] = 0;
      }
      if (!__any_sync(kFull, (mk[0] | mk[1] | mk[2] | mk[3]) != 0u)) continue;
      // the lane's active vertices of nonzero degree
      long long bs[4], ax[4];
      int dg[4];
      int cnt = 0, dsum = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bs[k] = 0;
        ax[k] = 0;
        dg[k] = 0;
        if (mk[k] != 0u) {
          probe.visit(v0 + k, mk[k], emask, ne, rb, vb, out);
          dg[k] = rows.row(v0 + k, bs[k], ax[k]);
          if (dg[k] > 0) {
            ++cnt;
            dsum += dg[k];
          } else {
            mk[k] = 0u;
          }
        }
      }
      int ic = cnt, id = dsum;  // inclusive warp scans
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int tc = __shfl_up_sync(kFull, ic, o);
        const int td = __shfl_up_sync(kFull, id, o);
        if (lane >= o) {
          ic += tc;
          id += td;
        }
      }
      const int na = __shfl_sync(kFull, ic, 31);
      const int total = __shfl_sync(kFull, id, 31);
      int pos = ic - cnt, off = id - dsum;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (mk[k] != 0u) {
          s_base[w][pos] = bs[k];
          s_aux[w][pos] = ax[k];
          s_pref[w][pos] = off;
          s_rows[w][pos] = mk[k];
          ++pos;
          off += dg[k];
        }
      }
      __syncwarp();
      for (int p = lane; p < total; p += 32) {
        int a = 0, z = na - 1;  // the last entry whose prefix is <= p
        while (a < z) {
          const int mid = (a + z + 1) >> 1;
          if (s_pref[w][mid] <= p) a = mid; else z = mid - 1;
        }
        const long long aux = s_aux[w][a];
        const long long s = rows.slot(s_base[w][a], aux, p - s_pref[w][a]);
        if (emask != nullptr) {
          long long e = rows.edge(s, aux);  // take_pad(mask, edge, False)
          if (e < 0 || ne <= 0) continue;
          if (!emask[e < ne ? e : ne - 1]) continue;
        }
        long long m = nbr[s];
        m = m < 0 ? 0 : (m < vb ? m : vb - 1);  // jnp.clip(emit_idx, 0, vb - 1)
        unsigned bits = s_rows[w][a];
        while (bits != 0u) {
          const int r = __ffs(bits) - 1;
          bits &= bits - 1u;
          out[(rb + r) * vb + m] = 1;
        }
      }
      __syncwarp();
    }
  }
}

// Zeroes `out` when asked, then launches bitmap_push_kernel over `rows`
// (the 4-byte frontier loads when vb and the pointers allow them), with
// `probe` at each active vertex. kLaneForm: `lanes` lanes of `c` rows each
// (grid y), `gate_stride` between the lanes' gate rows.
template <typename Rows, typename Probe = NoProbe, bool kLaneForm = false>
int launch_push(const Rows& rows, const void* nbr, const void* emask, long long ne,
                const void* frontier, const void* gate, long long c, long long vb,
                const void* alive, int zero_out, void* out, void* stream,
                const Probe& probe = Probe{}, long long lanes = 1, long long gate_stride = 0) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || lanes > 65535) return lanes == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (zero_out && c * vb > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(lanes * c * vb), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows.hi > rows.lo && c > 0 && vb > 0) {
    const long long groups = (rows.hi + kHopGroup - 1) / kHopGroup - rows.lo / kHopGroup;
    long long blocks = (groups + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const bool vec = vb % 4 == 0 && (reinterpret_cast<uintptr_t>(frontier) & 3u) == 0 &&
                     (gate == nullptr || (reinterpret_cast<uintptr_t>(gate) & 3u) == 0);
    auto kernel = vec ? bitmap_push_kernel<true, kLaneForm, Rows, Probe>
                      : bitmap_push_kernel<false, kLaneForm, Rows, Probe>;
    kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
        rows, probe, static_cast<const int*>(nbr), static_cast<const unsigned char*>(emask), ne,
        static_cast<const unsigned char*>(frontier), static_cast<const unsigned char*>(gate), c,
        vb, static_cast<const int*>(alive), static_cast<unsigned char*>(out), gate_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K11: bitmap_emit (replaces tpu_engine._var_emit_mask,
// orientdb_tpu/exec/tpu_engine.py:475, with the level sums of the COUNT
// path :2136-2138 and the NOT arm's cur.any(axis=1) :1335).
// emit = reached & node[None, :] (& column == bound[c]); outputs (each may
// be null): the emit bitmap, a per-row any, and the popcount (an int32
// device scalar).
// Bound (the least bytes the function needs): reached read once (C*vb),
// 16 bytes of node for each non-zero group of it, and C*vb written when
// the bitmap is asked for; with `bound` and no bitmap, 2*C bytes (only
// reached[c, bound[c]] and node[bound[c]] can be set).
// Design (redesigned for sparse levels, where most 16-byte groups of
// `reached` are zero): a streaming pass over `reached`, kInFlight 16-byte
// loads a thread issued before any is tested; node is loaded only for a
// non-zero group; a zero group stores a zero emit group when the bitmap is
// asked for and nothing otherwise. With `bound` and no bitmap,
// bitmap_emit_bound_kernel reads the two bytes of each row instead (C
// threads). The any flags store only 1s (benign races on a zeroed row
// flag); the count is reduced per block, one atomic a block. One byte a
// thread when vb is not a multiple of 16 or a pointer is not 16-byte
// aligned (a group never straddles two rows otherwise).
// ---------------------------------------------------------------------------
constexpr int kInFlight = 4;  // loads a thread issues before it tests any

// The warp's sum of `c`, in lane 0.
__device__ inline unsigned warp_total(unsigned c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  return c;
}

// Adds the block's `a` into *out_a and its `b` into *out_b (null: not
// counted): warp shuffles, the warps' sums in shared memory, one atomic a
// block and count. Every thread of the block calls it.
__device__ inline void block_count_add(unsigned a, unsigned* out_a, unsigned b, unsigned* out_b) {
  __shared__ unsigned sums[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_total(a);
  b = warp_total(b);
  if (lane == 0) {
    sums[0][warp] = a;
    sums[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = warp_total(lane < kWarps ? sums[0][lane] : 0u);
    b = warp_total(lane < kWarps ? sums[1][lane] : 0u);
    if (lane == 0 && out_a != nullptr && a) atomicAdd(out_a, a);
    if (lane == 0 && out_b != nullptr && b) atomicAdd(out_b, b);
  }
}

__device__ inline bool any16(const uint4& x) { return (x.x | x.y | x.z | x.w) != 0u; }

// x (group cg of a row of `reached` or of the new frontier) restricted to
// column b and to node[b] (b < 0 or outside the group: nothing). The byte
// is picked by selects and shifts, so the group stays in registers.
__device__ inline Bytes16 at_column16(Bytes16 x, const unsigned char* __restrict__ node,
                                      long long cg, long long b) {
  const long long j = b - cg * 16;
  unsigned keep = 0;
  int wi = 0;
  if (j >= 0 && j < 16) {
    wi = static_cast<int>(j >> 2);
    const unsigned w = wi == 0 ? x.w[0] : wi == 1 ? x.w[1] : wi == 2 ? x.w[2] : x.w[3];
    const unsigned shift = 8u * static_cast<unsigned>(j & 3);
    const unsigned byte = (w >> shift) & 0xffu;
    keep = byte ? (byte & node[b]) << shift : 0u;
  }
  x.v = make_uint4(wi == 0 ? keep : 0u, wi == 1 ? keep : 0u, wi == 2 ? keep : 0u, wi == 3 ? keep : 0u);
  return x;
}

__device__ inline unsigned popc16(const Bytes16& x) {
  return __popc(x.w[0]) + __popc(x.w[1]) + __popc(x.w[2]) + __popc(x.w[3]);
}

// The lane form (under the reference's vmap of a group replay): reached,
// emit [B, C, vb], bound and any [B, C], node shared or [B, vb]
// (node_stride vb), one count a lane ([B]); blockIdx.y is the lane, whose
// blocks read and write only its rows, so the block's count is its lane's.
// The single form is instantiated without the lane arithmetic (kLanes
// false). Bound: the single form's bytes over all lanes' rows, a stacked
// node once.
template <bool kVec, bool kLanes>
__global__ void bitmap_emit_kernel(const unsigned char* __restrict__ reached,
                                   const unsigned char* __restrict__ node,
                                   const int* __restrict__ bound, long long c,
                                   long long vb, unsigned char* __restrict__ emit,
                                   unsigned char* __restrict__ any,
                                   unsigned* __restrict__ count, long long node_stride) {
  if constexpr (kLanes) {
    const long long lane = blockIdx.y;
    reached += lane * c * vb;
    node += lane * node_stride;
    if (bound != nullptr) bound += lane * c;
    if (emit != nullptr) emit += lane * c * vb;
    if (any != nullptr) any += lane * c;
    if (count != nullptr) count += lane;
  }
  constexpr long long kW = kVec ? 16 : 1;
  const long long groups = c * vb / kW;
  const long long row_groups = vb / kW;
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kInFlight;
  unsigned cnt = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kInFlight + threadIdx.x;
       base < groups; base += step) {
    if constexpr (kVec) {
      uint4 x[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long g = base + static_cast<long long>(k) * kThreads;
        x[k] = g < groups ? __ldcs(reinterpret_cast<const uint4*>(reached) + g) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long g = base + static_cast<long long>(k) * kThreads;
        if (g >= groups) break;
        Bytes16 e;
        e.v = x[k];
        if (any16(e.v)) {
          const long long row = g / row_groups;
          const long long cg = g - row * row_groups;
          if (bound != nullptr) {
            e = at_column16(e, node, cg, bound[row]);
          } else {
            Bytes16 y;
            y.v = __ldg(reinterpret_cast<const uint4*>(node) + cg);
#pragma unroll
            for (int w = 0; w < 4; ++w) e.w[w] &= y.w[w];
          }
          const unsigned n_set = popc16(e);
          if (any != nullptr && n_set) any[row] = 1;
          cnt += n_set;
        }
        if (emit != nullptr) reinterpret_cast<uint4*>(emit)[g] = e.v;
      }
    } else {
      unsigned char x[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long g = base + static_cast<long long>(k) * kThreads;
        x[k] = g < groups ? reached[g] : 0;
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long g = base + static_cast<long long>(k) * kThreads;
        if (g >= groups) break;
        unsigned char v = 0;
        if (x[k]) {
          const long long row = g / vb;
          const long long col = g - row * vb;
          v = x[k] & node[col];
          if (bound != nullptr && static_cast<long long>(bound[row]) != col) v = 0;
          if (any != nullptr && v) any[row] = 1;
          cnt += v;
        }
        if (emit != nullptr) emit[g] = v;
      }
    }
  }
  if (count != nullptr) block_count_add(cnt, count, 0, nullptr);
}

// K11 with `bound` and no emit bitmap: row r can emit only at column
// bound[r], so a thread a row reads reached[r, bound[r]] and node[bound[r]].
template <bool kLanes>
__global__ void bitmap_emit_bound_kernel(const unsigned char* __restrict__ reached,
                                         const unsigned char* __restrict__ node,
                                         const int* __restrict__ bound, long long c,
                                         long long vb, unsigned char* __restrict__ any,
                                         unsigned* __restrict__ count, long long node_stride) {
  if constexpr (kLanes) {
    const long long lane = blockIdx.y;
    reached += lane * c * vb;
    node += lane * node_stride;
    bound += lane * c;
    if (any != nullptr) any += lane * c;
    if (count != nullptr) count += lane;
  }
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned v = 0;
  if (r < c) {
    const long long b = bound[r];
    if (b >= 0 && b < vb) v = reached[r * vb + b] & node[b];
    if (any != nullptr && v) any[r] = 1;
  }
  if (count != nullptr) block_count_add(v, count, 0, nullptr);
}

// ---------------------------------------------------------------------------
// K12: frontier_advance (replaces the level step of _expand_var_depth,
// orientdb_tpu/exec/tpu_engine.py:2171-2176: nxt & ~visited, visited | nxt,
// mask_count(nxt)). In place on both bitmaps: nxt &= ~visited;
// visited |= nxt; the popcount of the new nxt into an int32 device scalar
// (the level's alive observe, and K10's early exit on the next level).
// TRAVERSE's admission (orientdb_tpu/exec/tpu_engine.py:2644-2651) adds a
// gate: nxt &= ~visited & gate[column], gate a [vb] bool vector broadcast
// over the rows; a vertex the gate rejects is neither kept nor marked
// visited. With `node` (and `bound`), the COUNT path's emission count of
// the level, K11's count over the new nxt, comes out of the same pass
// into a second scalar, so a variable-depth COUNT level reads nxt once.
// Bound: nxt read once (C*vb bytes), plus, for each non-zero 16-byte group
// of it, 16 bytes of visited loaded and stored, of nxt stored, and of gate
// and node loaded; a dense level 4*C*vb (4*64 MiB at [8, 2^23]: 0.080 ms),
// a sparse one ~C*vb (0.020 ms).
// Design (redesigned for sparse levels): the function needs visited, gate
// and node only where nxt is set and changes nxt and visited only there,
// so the kernel streams nxt, kInFlight 16-byte loads a thread in flight,
// and touches the rest only for a non-zero group; a zero group is skipped
// (nothing loaded, nothing stored); a non-zero group issues all its other
// loads before it uses the first. The counts are reduced per block, one
// atomic a block. Grid-stride over a grid sized to the card (grids of 528
// and 1,056 blocks, eight loads in flight and one atomic a warp measured
// within noise of this design, `PERF.md` §6). One byte a
// thread when the bitmaps are not 16-byte aligned or a multiple of 16 long
// (or, with gate or node, vb is not a multiple of 16). Skipping a zero
// group changes no result: nxt & ~visited is zero there and visited keeps
// its bytes.
// ---------------------------------------------------------------------------
// The lane form (under the reference's vmap of a group replay): nxt and
// visited [B, C, vb] (n bytes a lane), gate and node shared or
// [B, vb] (their strides vb), bound [B, C], one alive and one emitted count a
// lane ([B]); blockIdx.y is the lane, whose blocks touch only its rows. The
// single form is instantiated without the lane arithmetic (kLanes false).
template <bool kVec, bool kLanes>
__global__ void frontier_advance_kernel(unsigned char* __restrict__ nxt,
                                        unsigned char* __restrict__ visited,
                                        const unsigned char* __restrict__ gate,
                                        const unsigned char* __restrict__ node,
                                        const int* __restrict__ bound, long long n,
                                        long long vb, unsigned* __restrict__ count,
                                        unsigned* __restrict__ emitted, long long gate_stride,
                                        long long node_stride) {
  if constexpr (kLanes) {
    const long long lane = blockIdx.y;
    nxt += lane * n;
    visited += lane * n;
    if (gate != nullptr) gate += lane * gate_stride;
    if (node != nullptr) node += lane * node_stride;
    if (bound != nullptr) bound += lane * (n / vb);
    count += lane;
    if (emitted != nullptr) emitted += lane;
  }
  constexpr long long kW = kVec ? 16 : 1;
  const long long groups = n / kW;
  const long long row_groups = vb / kW;  // used only with gate or node
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kInFlight;
  unsigned cnt = 0, ecnt = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kInFlight + threadIdx.x;
       base < groups; base += step) {
    if constexpr (kVec) {
      uint4 x[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long g = base + static_cast<long long>(k) * kThreads;
        x[k] = g < groups ? __ldcs(reinterpret_cast<const uint4*>(nxt) + g) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (!any16(x[k])) continue;  // also every slot past the end
        const long long g = base + static_cast<long long>(k) * kThreads;
        // every load of the group is issued before the first is used
        Bytes16 a, v, s, y;
        a.v = x[k];
        v.v = reinterpret_cast<const uint4*>(visited)[g];
        if (gate != nullptr) s.v = __ldg(reinterpret_cast<const uint4*>(gate) + g % row_groups);
        long long cg = 0, b = 0;
        if (node != nullptr) {
          const long long row = g / row_groups;
          cg = g - row * row_groups;
          if (bound != nullptr) {
            b = bound[row];
          } else {
            y.v = __ldg(reinterpret_cast<const uint4*>(node) + cg);
          }
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          a.w[w] &= ~v.w[w];
          if (gate != nullptr) a.w[w] &= s.w[w];
          v.w[w] |= a.w[w];
        }
        cnt += popc16(a);
        reinterpret_cast<uint4*>(nxt)[g] = a.v;
        reinterpret_cast<uint4*>(visited)[g] = v.v;
        if (node != nullptr && bound != nullptr) {
          ecnt += popc16(at_column16(a, node, cg, b));
        } else if (node != nullptr) {
#pragma unroll
          for (int w = 0; w < 4; ++w) a.w[w] &= y.w[w];
          ecnt += popc16(a);
        }
      }
    } else {
      unsigned char x[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long g = base + static_cast<long long>(k) * kThreads;
        x[k] = g < groups ? nxt[g] : 0;
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        if (!x[k]) continue;
        const long long g = base + static_cast<long long>(k) * kThreads;
        unsigned char a = x[k] & static_cast<unsigned char>(!visited[g]);
        if (gate != nullptr) a &= static_cast<unsigned char>(gate[g % vb] != 0);
        nxt[g] = a;
        visited[g] |= a;
        cnt += a;
        if (node != nullptr && a) {
          const long long row = g / vb;
          const long long col = g - row * vb;
          unsigned char e = a & node[col];
          if (bound != nullptr && static_cast<long long>(bound[row]) != col) e = 0;
          ecnt += e;
        }
      }
    }
  }
  block_count_add(cnt, count, ecnt, emitted);
}

// ---------------------------------------------------------------------------
// K13: rows_with_matches (replaces csr.rows_with_matches,
// orientdb_tpu/ops/csr.py:283): the OPTIONAL arm's left-join bookkeeping,
// out[r] += #{i : mask[i] && rows[i] == r} for 0 <= r < nseg; ids outside
// the range are dropped, as segment_sum drops them.
// Bound: w*(4+1) bytes read, nseg*4 written (2^26 slots: 336 MB, ~0.1 ms).
// Design: one slot a thread, grid-stride over warp-aligned bases so that
// every lane of a warp runs each iteration. An expansion's rows ascend, so
// a warp's 32 slots name one or two rows: __match_any_sync groups the lanes
// by row and the lowest lane of each group adds the group's size, one
// integer atomic a distinct row a warp (integer adds commute: exact).
// The lane form (under the reference's vmap of a group replay): rows and
// mask [lanes, w] of lane-local rows, out [lanes, nseg]; blockIdx.y is the
// lane, which reads and adds only its own rows. The single form is the
// lane form at one lane. Bound: lanes times the single form's bytes.
// ---------------------------------------------------------------------------
__global__ void rows_with_matches_kernel(const int* __restrict__ rows,
                                         const unsigned char* __restrict__ mask,
                                         long long w, long long nseg,
                                         unsigned* __restrict__ out) {
  rows += static_cast<long long>(blockIdx.y) * w;
  mask += static_cast<long long>(blockIdx.y) * w;
  out += static_cast<long long>(blockIdx.y) * nseg;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < w; base += stride) {
    const long long i = base + lane;
    int r = -1;
    if (i < w && mask[i]) {
      const int v = rows[i];
      if (v >= 0 && v < nseg) r = v;
    }
    const unsigned peers = __match_any_sync(kFull, r);
    if (r >= 0 && lane == __ffs(peers) - 1) atomicAdd(out + r, __popc(peers));
  }
}

// ---------------------------------------------------------------------------
// K14: group_page (replaces _CompiledPlan._page_fn / group_page,
// orientdb_tpu/exec/tpu_engine.py:3074 / :3131): the compact page of a rows
// group after the meta wave, out[b, r, c] = in[b, r, c] for b < B, r < n,
// c < C, narrowed to int16 (low 16 bits, as narrow_i16) when every live
// value of every lane fits. The stack is lane-major with rows leading
// ([Bb, W, C]; the reference's is [Bb, C, W]), so lane b's page is ONE
// contiguous run of n*C values at b*W*C in the stack and at b*n*C in the
// page: the kernel is a copy of B runs.
// Bound: B*n*C*4 bytes read + B*n*C*(4 or 2) written (BQ3's full int32
// page, 16 x 131072 x 3: 50 MB, ~0.015 ms).
// Design: a straight-line copy, one launch for every run length and
// alignment. gridDim.y walks the lanes and gridDim.x covers a lane's run in
// tiles of kThreads*kPageUnroll 16-byte output units, sized to the run (no
// grid-stride cap). Each thread starts its kPageUnroll loads (streaming,
// __ldcs: the stack is read once) before its first store. A unit is 16
// bytes out: four int32 in, or eight int32 (32 bytes) in the narrow form.
// Units are aligned to the lane's output run: a scalar head (values before
// the output's first 16-byte boundary) and a scalar tail (past the last
// whole unit) are copied by the lane's first block; a source that is not
// 16-byte aligned at the same value (a lane stride W*C not a multiple of
// 4, or a head that shifts it) is read with 4-byte loads, still kPageUnroll
// units in flight.
// ---------------------------------------------------------------------------
constexpr int kPageUnroll = 4;  // output units a thread

__device__ inline unsigned pack_i16(unsigned lo, unsigned hi) {
  return (lo & 0xffffu) | (hi << 16);
}

template <bool kNarrow>
__device__ inline void page_store1(unsigned char* dst, long long i, int v) {
  if (kNarrow) {
    reinterpret_cast<short*>(dst)[i] = static_cast<short>(static_cast<unsigned short>(v & 0xffff));
  } else {
    reinterpret_cast<int*>(dst)[i] = v;
  }
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
group_page_kernel(const int* __restrict__ in, long long src_run, long long lanes, long long run,
                  void* __restrict__ out) {
  constexpr int kVals = kNarrow ? 8 : 4;  // int32 values a 16-byte output unit
  constexpr int kOut = kNarrow ? 2 : 4;   // bytes an output value
  constexpr int kIn = kNarrow ? 2 : 1;    // 16-byte loads a unit
  for (long long b = blockIdx.y; b < lanes; b += gridDim.y) {
    const int* src = in + b * src_run;
    unsigned char* dst = static_cast<unsigned char*>(out) + b * run * kOut;
    long long head = static_cast<long long>(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) / kOut);
    if (head > run) head = run;
    const long long units = (run - head) / kVals;
    const long long tail = head + units * kVals;  // first value of the scalar tail
    const int* s = src + head;
    uint4* d = reinterpret_cast<uint4*>(dst + head * kOut);
    const bool s_vec = (reinterpret_cast<uintptr_t>(s) & 15u) == 0;
    const long long u0 = static_cast<long long>(blockIdx.x) * (kThreads * kPageUnroll) + threadIdx.x;
    uint4 v[kPageUnroll][kIn];
#pragma unroll
    for (int j = 0; j < kPageUnroll; ++j) {
      const long long u = u0 + static_cast<long long>(j) * kThreads;
      if (u >= units) continue;
#pragma unroll
      for (int h = 0; h < kIn; ++h) {
        if (s_vec) {
          v[j][h] = __ldcs(reinterpret_cast<const uint4*>(s) + u * kIn + h);
        } else {
          const int* p = s + (u * kIn + h) * 4;
          v[j][h] = make_uint4(static_cast<unsigned>(__ldcs(p)), static_cast<unsigned>(__ldcs(p + 1)),
                               static_cast<unsigned>(__ldcs(p + 2)), static_cast<unsigned>(__ldcs(p + 3)));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPageUnroll; ++j) {
      const long long u = u0 + static_cast<long long>(j) * kThreads;
      if (u >= units) continue;
      if (kNarrow) {
        d[u] = make_uint4(pack_i16(v[j][0].x, v[j][0].y), pack_i16(v[j][0].z, v[j][0].w),
                          pack_i16(v[j][kIn - 1].x, v[j][kIn - 1].y),
                          pack_i16(v[j][kIn - 1].z, v[j][kIn - 1].w));
      } else {
        d[u] = v[j][0];
      }
    }
    if (blockIdx.x == 0) {
      const long long t = threadIdx.x;  // head and tail are each < kVals values
      if (t < head) page_store1<kNarrow>(dst, t, __ldcs(src + t));
      if (tail + t < run) page_store1<kNarrow>(dst, tail + t, __ldcs(src + tail + t));
    }
  }
}

template <bool kNarrow>
void launch_group_page(const int* in, long long src_run, long long lanes, long long run,
                       void* out, cudaStream_t s) {
  constexpr long long kVals = kNarrow ? 8 : 4;
  const long long units = run / kVals;  // a lane's units are this or one fewer
  const unsigned gx = blocks_for(units > 0 ? units : 1, static_cast<long long>(kThreads) * kPageUnroll);
  const unsigned gy = static_cast<unsigned>(lanes < 65535 ? lanes : 65535);
  group_page_kernel<kNarrow><<<dim3(gx, gy), kThreads, 0, s>>>(in, src_run, lanes, run, out);
}


// ---------------------------------------------------------------------------
// K15: predicate_eval (replaces the closures of predicates.Compiler,
// orientdb_tpu/ops/predicates.py: _column_val :198, _binding_val :213,
// _distance :318, _param_val :371, _arith :392, _bool :428, _truthy :475,
// _code_table_mask :492, _in :533, _compare :550, _cmp_str_lit :627, and the
// class-closure test of tpu_engine's node masks, and its rid filter
// `idx == idx_of(rid)` at orientdb_tpu/exec/tpu_engine.py:874-877, the ID
// instruction): one compiled WHERE program over n slots.
//
// A program is a postfix list of int4 instructions {op, a, b, c} (PredOp in
// orientdb_tpu_torch/ops/csr.py) over a per-slot stack of (32 bits, present)
// pairs; a mask is a pair whose `present` is the mask. Value kinds are
// resolved at compile time, so no instruction carries a runtime type tag.
// A mask's root AND is emitted as guarded conjuncts, cheapest first: each
// conjunct is followed by GUARD, which pops it and ANDs its presence into
// the slot's live bit; the mask is then the live bit.
// Bound: bytes. Each slot reads its id (4 bytes, none in identity mode), a
// value and a presence byte for each column the program reads (a random
// gather where the ids are random), the slot's binding rows, and writes one
// byte; a slot a GUARD has killed reads nothing more. A distance() slot
// does ~18 float operations and six calls (sin and cos twice, asin, sqrt).
// Design: a tiled interpreter. A block takes tiles of kThreads * kPredV
// slots, kPredV consecutive slots a thread, so each instruction is fetched
// (from the block's shared-memory copy of the program when it fits in 48 KB,
// else through the read-only cache) and decoded once per kPredV slots; every
// thread runs the same instruction sequence, so control flow never
// diverges. The top of the stack (kPredV values and a presence bit each)
// lives in registers, in arrays indexed only inside unrolled loops; the
// entries below it live in dynamic shared memory, [need - 1][kPredV]
// [kThreads] values and [need - 1][kThreads] presence words, sized by the
// program's own stack need (PredArgs.need), so a thread's slots sit in
// separate banks; an empty stack's top is a constant, never stored. In
// identity mode a thread's column values, class ids and presence bytes are
// 16- and 4-byte vector loads where aligned; with an id array its kPredV
// ids, then its kPredV gathers, are issued before their first use. Every
// load of an instruction is predicated on the slot's live bit, and a warp
// whose slots are all dead after a GUARD (one ballot) skips the rest of the
// program. The mask's kPredV bytes go out as one 8-byte store. Every
// per-call pointer and scalar is a launch argument (a __grid_constant__
// struct, indexed in place), so a captured CUDA graph bakes them per launch;
// parameters are always read from device memory. Arithmetic follows the
// reference: int32 in uint32 (wraps), float32 one IEEE operation at a time
// (the _rn intrinsics: no FMA contraction), floor modulo, division and
// modulo by zero absent; a gather clips as take_pad does. Measured on the
// card (PERF.md §6): 8 slots a thread beat 4; 16 would need more shared
// memory than a deep program's stack leaves; a one-wave grid looping over
// tiles was no faster than grid_for's.
// The stacked form (K15 over lane-stacked ids, under the reference's vmap of
// a group replay): blockIdx.y is the lane. Lane b reads ids + b*n, its
// parameter row params + b*pstride and writes out + b*n; each buffer has a
// lane stride, 0 for what the lanes share (columns, code and class tables)
// and n for what is lane-stacked (slot-aligned binding rows, a split
// program's earlier values and presence: the `lane_bufs` bits). Nothing is
// cached across lanes, so the shared memory is the single form's and a
// split program runs too. The single form is the stacked form at one lane,
// the same body instantiated without the lane offsets (kStacked false: with
// them it ran 1.7-2.7 % slower in a graph, PERF.md §6).
// Bound: the single form's bytes a lane (ids, gathers and mask bytes a
// lane; the shared columns through L2).
// ---------------------------------------------------------------------------
constexpr int kStack = 16;     // a program's stack need at most (PRED_STACK)
constexpr int kMaxBufs = 32;   // buffers a launch reads (PRED_BUFS)
constexpr int kProgSmem = 48 * 1024;
constexpr int kPredV = 8;      // consecutive slots a thread
// the lane form: rows a launch, parameters a row, shared-memory entries
// (the stack below the top and the cached loads; PRED_LANES,
// PRED_LANE_PARAMS, PRED_LANE_ENTRIES) and its dynamic shared memory
constexpr int kPredLanes = 64;
constexpr int kPredLaneParams = 32;
constexpr int kPredLaneEntries = 20;
constexpr int kPredLaneSmem = 232448;
static_assert(kPredV % 4 == 0, "a thread's mask bytes go out as 4-byte words");
constexpr long long kPredTile = static_cast<long long>(kThreads) * kPredV;
constexpr unsigned kPredAll = (1u << kPredV) - 1u;
// shared memory of one stack entry below the top: kPredV values and a
// presence word a thread
constexpr int kPredEntryBytes = kThreads * (kPredV + 1) * 4;

enum PredOp : int {
  kCol = 1, kBCol = 2, kConst = 3, kParam = 4, kDepth = 5, kTmp = 6, kI2F = 7, kNeg = 8,
  kArith = 9, kCmp = 10, kTable = 11, kTruthy = 12, kIsNull = 13, kAnd = 14, kOr = 15,
  kNot = 16, kMask = 17, kClass = 18, kValid = 19, kDist = 20, kId = 21, kGuard = 22,
};
// the instructions that push an entry, as a bit set of opcodes
constexpr unsigned kPredPushes = (1u << kCol) | (1u << kBCol) | (1u << kConst) | (1u << kParam) |
                                 (1u << kDepth) | (1u << kTmp) | (1u << kMask) | (1u << kClass) |
                                 (1u << kValid) | (1u << kId);

struct PredArgs {
  const int4* prog;
  long long len;
  const int* ids;          // null: identity mode
  long long n;
  long long n_valid;
  long long base;
  const int* params;
  unsigned char* out_p;
  int* out_v;              // null unless the caller wants the values (a split)
  int depth;
  int nbufs;
  int need;                // the program's stack need: entries in shared memory
  unsigned lane_bufs;      // the stacked form: bit k set when buf[k] is lane-stacked
  long long pstride;       // the stacked form: params' lane stride (0: one row shared)
  const void* buf[kMaxBufs];
  long long blen[kMaxBufs];
};

__device__ __forceinline__ float as_f(unsigned v) { return __uint_as_float(v); }
__device__ __forceinline__ unsigned as_u(float f) { return __float_as_uint(f); }

__device__ __forceinline__ bool pred_aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// kPredV bits, bit v = f(v)
template <typename F>
__device__ __forceinline__ unsigned pred_bits(F f) {
  unsigned m = 0u;
#pragma unroll
  for (int v = 0; v < kPredV; ++v) m |= (f(v) ? 1u : 0u) << v;
  return m;
}

// four bool bytes of a word → four bits
__device__ __forceinline__ unsigned pred_byte_bits(unsigned w) {
  return ((w & 0xffu) ? 1u : 0u) | ((w & 0xff00u) ? 2u : 0u) | ((w & 0xff0000u) ? 4u : 0u) |
         ((w & 0xff000000u) ? 8u : 0u);
}

// four bits → four bool bytes of a word
__device__ __forceinline__ unsigned pred_bit_bytes(unsigned m) {
  return (m & 1u) | ((m >> 1) & 1u) << 8 | ((m >> 2) & 1u) << 16 | ((m >> 3) & 1u) << 24;
}

__device__ __forceinline__ void pred_swap(unsigned (&x)[kPredV], unsigned (&y)[kPredV]) {
#pragma unroll
  for (int v = 0; v < kPredV; ++v) {
    const unsigned t = x[v];
    x[v] = y[v];
    y[v] = t;
  }
}

// A column through ids (the padding-safe gather of take_pad: a negative id
// or an empty column reads absent, value 0; an id past the end reads the
// last element), for the live slots. `run`: the ids are kPredV consecutive
// valid ids (identity mode), so aligned columns are read as vectors.
__device__ __forceinline__ void pred_column(const PredArgs& a, int vbuf, int pbuf,
                                            const int (&id)[kPredV], unsigned live, bool run,
                                            unsigned (&tv)[kPredV], unsigned& tp) {
  const unsigned* vals = static_cast<const unsigned*>(a.buf[vbuf]);
  const unsigned char* pres = static_cast<const unsigned char*>(a.buf[pbuf]);
  const int len = static_cast<int>(a.blen[vbuf]);
  if (run && live && id[0] >= 0 && id[0] <= len - kPredV && pred_aligned(vals + id[0], 16) &&
      pred_aligned(pres + id[0], 4)) {
    tp = 0u;
#pragma unroll
    for (int q = 0; q < kPredV / 4; ++q) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(vals + id[0]) + q);
      const unsigned p = __ldg(reinterpret_cast<const unsigned*>(pres + id[0]) + q);
      tv[4 * q] = w.x;
      tv[4 * q + 1] = w.y;
      tv[4 * q + 2] = w.z;
      tv[4 * q + 3] = w.w;
      tp |= pred_byte_bits(p) << (4 * q);
    }
    return;
  }
  unsigned char pb[kPredV];
#pragma unroll
  for (int v = 0; v < kPredV; ++v) {
    tv[v] = 0u;
    pb[v] = 0;
    if (((live >> v) & 1u) && id[v] >= 0 && len > 0) {
      const int j = id[v] < len ? id[v] : len - 1;
      tv[v] = __ldg(vals + j);
      pb[v] = __ldg(pres + j);
    }
  }
  tp = pred_bits([&](int v) { return pb[v] != 0; });
}

// The block's lane in the stacked form (blockIdx.y, a grid row a lane); the
// single and lane forms compile no lane offset.
template <bool kStacked>
__device__ __forceinline__ long long pred_lane() {
  return kStacked ? static_cast<long long>(blockIdx.y) : 0;
}

// A slot-aligned buffer of the block's lane: lane-stacked ones ([lanes, n],
// a lane_bufs bit) at the lane's row, shared ones as they are.
template <bool kStacked, typename T>
__device__ __forceinline__ const T* pred_slot_buf(const PredArgs& a, int k) {
  const T* p = static_cast<const T*>(a.buf[k]);
  if (!kStacked) return p;
  return ((a.lane_bufs >> k) & 1u) ? p + pred_lane<kStacked>() * a.n : p;
}

// A slot-aligned array (binding rows, an earlier launch's values) at slots
// i0 .. i0 + kPredV - 1, for the live ones (`dead` elsewhere).
__device__ __forceinline__ void pred_slots(const unsigned* p, long long i0, long long n,
                                           unsigned live, unsigned dead, unsigned (&out)[kPredV]) {
  if (live == kPredAll && i0 + kPredV <= n && pred_aligned(p + i0, 16)) {
#pragma unroll
    for (int q = 0; q < kPredV / 4; ++q) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p + i0) + q);
      out[4 * q] = w.x;
      out[4 * q + 1] = w.y;
      out[4 * q + 2] = w.z;
      out[4 * q + 3] = w.w;
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < kPredV; ++v) out[v] = ((live >> v) & 1u) ? __ldg(p + i0 + v) : dead;
}

// the presence bytes of an earlier launch at slots i0 .., as bits
__device__ __forceinline__ unsigned pred_slot_bits(const unsigned char* p, long long i0,
                                                   long long n, unsigned live) {
  if (live == kPredAll && i0 + kPredV <= n && pred_aligned(p + i0, 4)) {
    unsigned m = 0u;
#pragma unroll
    for (int q = 0; q < kPredV / 4; ++q) {
      m |= pred_byte_bits(__ldg(reinterpret_cast<const unsigned*>(p + i0) + q)) << (4 * q);
    }
    return m;
  }
  unsigned char b[kPredV];
#pragma unroll
  for (int v = 0; v < kPredV; ++v) b[v] = ((live >> v) & 1u) ? __ldg(p + i0 + v) : 0;
  return pred_bits([&](int v) { return b[v] != 0; });
}

// The class-closure test (CLASS): table[v_class[id]], padding-safe, for
// the live slots; class ids are vector loads in a run of identity slots.
__device__ __forceinline__ void pred_class(const PredArgs& a, int cbuf, int tbuf,
                                           const int (&id)[kPredV], unsigned live, bool run,
                                           unsigned (&tv)[kPredV], unsigned& tp) {
  const int* vc = static_cast<const int*>(a.buf[cbuf]);
  const unsigned char* tab = static_cast<const unsigned char*>(a.buf[tbuf]);
  const int nc = static_cast<int>(a.blen[cbuf]), nt = static_cast<int>(a.blen[tbuf]);
  int cls[kPredV];
  if (run && live && id[0] >= 0 && id[0] <= nc - kPredV && pred_aligned(vc + id[0], 16)) {
#pragma unroll
    for (int q = 0; q < kPredV / 4; ++q) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(vc + id[0]) + q);
      cls[4 * q] = w.x;
      cls[4 * q + 1] = w.y;
      cls[4 * q + 2] = w.z;
      cls[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPredV; ++v) {
      cls[v] = -1;
      if (((live >> v) & 1u) && id[v] >= 0 && nc > 0) cls[v] = __ldg(vc + (id[v] < nc ? id[v] : nc - 1));
    }
  }
  unsigned char hit[kPredV];
#pragma unroll
  for (int v = 0; v < kPredV; ++v) {
    tv[v] = 0u;
    hit[v] = 0;
    if (((live >> v) & 1u) && cls[v] >= 0 && nt > 0) hit[v] = __ldg(tab + (cls[v] < nt ? cls[v] : nt - 1));
  }
  tp = pred_bits([&](int v) { return hit[v] != 0; });
}

// The instructions that push: the current top has been saved below.
template <bool kStacked>
__device__ __forceinline__ void pred_push(const PredArgs& a, int4 ins, const int (&id)[kPredV],
                                          long long i0, unsigned live, bool run,
                                          unsigned (&tv)[kPredV], unsigned& tp) {
  switch (ins.x) {
    case kCol: pred_column(a, ins.y, ins.z, id, live, run, tv, tp); break;
    case kBCol: {
      unsigned r[kPredV];
      pred_slots(pred_slot_buf<kStacked, unsigned>(a, ins.w), i0, a.n, live, 0xffffffffu, r);
      int rows[kPredV];
#pragma unroll
      for (int v = 0; v < kPredV; ++v) rows[v] = static_cast<int>(r[v]);
      pred_column(a, ins.y, ins.z, rows, live, false, tv, tp);
      break;
    }
    case kConst:
#pragma unroll
      for (int v = 0; v < kPredV; ++v) tv[v] = static_cast<unsigned>(ins.y);
      tp = ins.z ? kPredAll : 0u;
      break;
    case kParam: {
      const unsigned p = static_cast<unsigned>(__ldg(a.params + pred_lane<kStacked>() * a.pstride + ins.y));
#pragma unroll
      for (int v = 0; v < kPredV; ++v) tv[v] = p;
      tp = kPredAll;
      break;
    }
    case kDepth:
#pragma unroll
      for (int v = 0; v < kPredV; ++v) tv[v] = static_cast<unsigned>(a.depth);
      tp = kPredAll;
      break;
    case kTmp:
      pred_slots(pred_slot_buf<kStacked, unsigned>(a, ins.y), i0, a.n, live, 0u, tv);
      tp = pred_slot_bits(pred_slot_buf<kStacked, unsigned char>(a, ins.z), i0, a.n, live);
      break;
    case kMask:
#pragma unroll
      for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
      tp = ins.y ? kPredAll : 0u;
      break;
    case kClass: pred_class(a, ins.y, ins.z, id, live, run, tv, tp); break;
    case kId:
#pragma unroll
      for (int v = 0; v < kPredV; ++v) tv[v] = static_cast<unsigned>(id[v]);
      tp = pred_bits([&](int v) { return id[v] >= 0; });
      break;
    default:  // kValid
#pragma unroll
      for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
      tp = pred_bits([&](int v) { return id[v] >= 0; });
      break;
  }
}

// x op y for kPredV slots, into y; returns the slots where it is defined
// (division and modulo by zero are absent)
__device__ __forceinline__ unsigned pred_arith(int op, int kind, const unsigned (&x)[kPredV],
                                               unsigned (&y)[kPredV]) {
  unsigned ok = kPredAll;
  if (kind) {
#pragma unroll
    for (int v = 0; v < kPredV; ++v) {
      const float fx = as_f(x[v]), fy = as_f(y[v]);
      float r;
      if (op == 0) {
        r = __fadd_rn(fx, fy);
      } else if (op == 1) {
        r = __fsub_rn(fx, fy);
      } else if (op == 2) {
        r = __fmul_rn(fx, fy);
      } else {
        if (fy == 0.0f) ok &= ~(1u << v);
        const float dd = fy != 0.0f ? fy : 1.0f;
        if (op == 3) {
          r = __fdiv_rn(fx, dd);
        } else {
          r = fmodf(fx, dd);
          if (r != 0.0f && ((dd < 0.0f) != (r < 0.0f))) r = __fadd_rn(r, dd);
        }
      }
      y[v] = as_u(r);
    }
    return ok;
  }
#pragma unroll
  for (int v = 0; v < kPredV; ++v) {
    if (op == 0) {
      y[v] = x[v] + y[v];
    } else if (op == 1) {
      y[v] = x[v] - y[v];
    } else if (op == 2) {
      y[v] = x[v] * y[v];
    } else {  // floor modulo (division is always float32)
      const int ix = static_cast<int>(x[v]), iy = static_cast<int>(y[v]);
      if (iy == 0) ok &= ~(1u << v);
      int m = 0;  // x mod -1 = 0; INT_MIN % -1 traps
      if (iy != 0 && iy != -1) {
        m = ix % iy;
        if (m != 0 && ((iy < 0) != (m < 0))) m += iy;
      }
      y[v] = static_cast<unsigned>(m);
    }
  }
  return ok;
}

template <typename T, typename C>
__device__ __forceinline__ unsigned pred_cmp_as(const unsigned (&x)[kPredV],
                                                const unsigned (&y)[kPredV], C c) {
  return pred_bits([&](int v) { return c(bits_as<T>(x[v]), bits_as<T>(y[v])); });
}

template <typename T>
__device__ __forceinline__ unsigned pred_cmp_kind(int op, const unsigned (&x)[kPredV],
                                                  const unsigned (&y)[kPredV]) {
  switch (op) {
    case 0: return pred_cmp_as<T>(x, y, [](T p, T q) { return p == q; });
    case 1: return pred_cmp_as<T>(x, y, [](T p, T q) { return p != q; });
    case 2: return pred_cmp_as<T>(x, y, [](T p, T q) { return p < q; });
    case 3: return pred_cmp_as<T>(x, y, [](T p, T q) { return p <= q; });
    case 4: return pred_cmp_as<T>(x, y, [](T p, T q) { return p > q; });
    default: return pred_cmp_as<T>(x, y, [](T p, T q) { return p >= q; });
  }
}

// The reference's float32 haversine, operation by operation:
// deg2rad as a multiply, h, clip to [0, 1], 2R * asin(sqrt(h)) * scale.
__device__ __forceinline__ float pred_haversine(float lat1, float lon1, float lat2, float lon2,
                                                float scale) {
  const float k = 0.017453292519943295f;
  lat1 = __fmul_rn(lat1, k);
  lon1 = __fmul_rn(lon1, k);
  lat2 = __fmul_rn(lat2, k);
  lon2 = __fmul_rn(lon2, k);
  const float s1 = sinf(__fdiv_rn(__fsub_rn(lat2, lat1), 2.0f));
  const float s2 = sinf(__fdiv_rn(__fsub_rn(lon2, lon1), 2.0f));
  const float cc = __fmul_rn(cosf(lat1), cosf(lat2));
  float h = __fadd_rn(__fmul_rn(s1, s1), __fmul_rn(cc, __fmul_rn(s2, s2)));
  h = h < 0.0f ? 0.0f : (h > 1.0f ? 1.0f : h);  // NaN stays NaN, as clip
  return __fmul_rn(__fmul_rn(12742.0f, asinf(sqrtf(h))), scale);
}

// The instructions that read a buffer at the slot (COL, BCOL, CLASS, TMP):
// the lane form loads each once a tile and caches it (PredProgram.loads).
constexpr unsigned kPredLoads = (1u << kCol) | (1u << kBCol) | (1u << kClass) | (1u << kTmp);

// The interpreter over a thread's kPredV slots: runs the program on the
// stack below the top (sval / spm) and returns the slots' mask bits, the
// top's values in tv. kLanes (the lane form): a push that reads a buffer
// takes its values from the tile's cache (cval / cpm, entry c the
// program's c-th such push), and PARAM reads `params`, the lane's row in
// shared memory; otherwise PARAM reads a.params in device memory (the
// block's lane's row in the stacked form, kStacked).
template <bool kLanes, bool kStacked>
__device__ __forceinline__ unsigned pred_run(const PredArgs& a, const int4* prog, bool prog_in_smem,
                                             unsigned* sval, unsigned* spm, const unsigned* cval,
                                             const unsigned* cpm, const int* params,
                                             const int (&id)[kPredV], long long i0, unsigned live,
                                             bool run, unsigned (&tv)[kPredV]) {
  const int tid = threadIdx.x;
  const int len = static_cast<int>(a.len);
  // the top; with an empty stack it reads (0, present), so a program
  // that ends on its last GUARD leaves the live bits as its mask
#pragma unroll
  for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
  unsigned tp = kPredAll;
  int depth = 0;  // entries on the stack, the top included
  int c = 0;      // the lane form's cache entry of the next buffer push
  for (int pc = 0; pc < len; ++pc) {
    const int4 ins = prog_in_smem ? prog[pc] : __ldg(prog + pc);
    const int op = ins.x;
    if ((kPredPushes >> op) & 1u) {
      if (depth > 0) {  // the top goes below (an empty stack's top is not kept)
        const int k = depth - 1;
#pragma unroll
        for (int v = 0; v < kPredV; ++v) sval[(k * kPredV + v) * kThreads + tid] = tv[v];
        spm[k * kThreads + tid] = tp;
      }
      ++depth;
      if (kLanes && ((kPredLoads >> op) & 1u)) {
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = cval[(c * kPredV + v) * kThreads + tid];
        tp = cpm[c * kThreads + tid];
        ++c;
      } else if (kLanes && op == kParam) {
        const unsigned p = static_cast<unsigned>(params[ins.y]);
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = p;
        tp = kPredAll;
      } else {
        pred_push<kStacked>(a, ins, id, i0, live, run, tv, tp);
      }
      continue;
    }
    if (op == kGuard) {
      live &= tp;
      --depth;
      if (depth > 0) {
        const int k = depth - 1;
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = sval[(k * kPredV + v) * kThreads + tid];
        tp = spm[k * kThreads + tid];
      } else {
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
        tp = kPredAll;
      }
      if (__ballot_sync(kFull, live != 0u) == 0u) break;  // the warp's slots are all dead
      continue;
    }
    // binary instructions take the entry below the top as their left operand
    unsigned x[kPredV];
    unsigned px = 0u;
    if (op == kArith || op == kCmp || op == kAnd || op == kOr) {
      const int k = depth - 2;
#pragma unroll
      for (int v = 0; v < kPredV; ++v) x[v] = sval[(k * kPredV + v) * kThreads + tid];
      px = spm[k * kThreads + tid];
      --depth;
    }
    switch (op) {
      case kI2F:
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = as_u(__int2float_rn(static_cast<int>(tv[v])));
        break;
      case kNeg:
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = ins.z ? (tv[v] ^ 0x80000000u) : (0u - tv[v]);
        break;
      case kArith: {
        unsigned py = tp;
        if (ins.w) {
          pred_swap(x, tv);
          const unsigned t = px;
          px = py;
          py = t;
        }
        tp = px & py & pred_arith(ins.y, ins.z, x, tv);
        break;
      }
      case kCmp: {
        const unsigned both = px & tp;
        if (ins.w) pred_swap(x, tv);
        tp = both & (ins.z ? pred_cmp_kind<float>(ins.y, x, tv) : pred_cmp_kind<int>(ins.y, x, tv));
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
        break;
      }
      case kTable: {
        const unsigned char* tab = static_cast<const unsigned char*>(a.buf[ins.y]);
        const int nt = static_cast<int>(a.blen[ins.y]);
        unsigned char hit[kPredV];
#pragma unroll
        for (int v = 0; v < kPredV; ++v) {
          hit[v] = 0;
          const int cv = static_cast<int>(tv[v]);
          if ((((tp & live) >> v) & 1u) && nt > 0) hit[v] = __ldg(tab + (cv < 0 ? 0 : (cv >= nt ? nt - 1 : cv)));
          tv[v] = 0u;
        }
        tp &= pred_bits([&](int v) { return hit[v] != 0; });
        break;
      }
      case kTruthy:
        tp &= pred_bits([&](int v) { return ins.z ? as_f(tv[v]) != 0.0f : tv[v] != 0u; });
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
        break;
      case kIsNull:
        tp = ins.y ? tp : (~tp & kPredAll);
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
        break;
      case kAnd:
      case kOr:
        tp = op == kAnd ? (px & tp) : (px | tp);
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
        break;
      case kNot:
        tp = ~tp & kPredAll;
#pragma unroll
        for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
        break;
      case kDist: {
        // lat1, lng1, lat2 in the three entries below the top, lng2 on it
        const int k = depth - 4;
        unsigned p = tp;
#pragma unroll
        for (int j = 0; j < 3; ++j) p &= spm[(k + j) * kThreads + tid];
#pragma unroll
        for (int v = 0; v < kPredV; ++v) {
          const float lat1 = as_f(sval[(k * kPredV + v) * kThreads + tid]);
          const float lng1 = as_f(sval[((k + 1) * kPredV + v) * kThreads + tid]);
          const float lat2 = as_f(sval[((k + 2) * kPredV + v) * kThreads + tid]);
          tv[v] = as_u(pred_haversine(lat1, lng1, lat2, as_f(tv[v]), __int_as_float(ins.y)));
        }
        tp = p;
        depth -= 3;
        break;
      }
      default: break;
    }
  }
  return live & tp;
}

// A tile's slot ids: kPredV consecutive slots from i0, from the id array
// (the block's lane's row; 16-byte loads where aligned) or in identity mode
// (base + i below n_valid, else -1).
template <bool kStacked>
__device__ __forceinline__ void pred_ids(const PredArgs& a, long long i0, bool whole, int (&id)[kPredV]) {
  const int* ids = a.ids ? a.ids + pred_lane<kStacked>() * a.n : nullptr;
  if (ids && whole && pred_aligned(ids + i0, 16)) {
#pragma unroll
    for (int q = 0; q < kPredV / 4; ++q) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(ids + i0) + q);
      id[4 * q] = w.x;
      id[4 * q + 1] = w.y;
      id[4 * q + 2] = w.z;
      id[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPredV; ++v) {
      const long long i = i0 + v;
      if (ids) {
        id[v] = i < a.n ? __ldg(ids + i) : -1;
      } else {
        id[v] = i < a.n_valid ? static_cast<int>(a.base + i) : -1;
      }
    }
  }
}

// The mask bytes of slots i0 .. (kPredV of them, those below n) at out.
__device__ __forceinline__ void pred_store_mask(unsigned char* out, long long i0, long long n, bool whole,
                                                unsigned res) {
  if (whole && pred_aligned(out + i0, 4 * (kPredV / 4))) {
    unsigned w[kPredV / 4];
#pragma unroll
    for (int q = 0; q < kPredV / 4; ++q) w[q] = pred_bit_bytes(res >> (4 * q));
    if constexpr (kPredV == 8) {
      *reinterpret_cast<uint2*>(out + i0) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int q = 0; q < kPredV / 4; ++q) reinterpret_cast<unsigned*>(out + i0)[q] = w[q];
    }
  } else {
#pragma unroll
    for (int v = 0; v < kPredV; ++v) {
      if (i0 + v < n) out[i0 + v] = static_cast<unsigned char>((res >> v) & 1u);
    }
  }
}

template <bool kStacked>
__global__ void __launch_bounds__(kThreads)
    predicate_eval_kernel(const __grid_constant__ PredArgs a, int prog_smem) {
  extern __shared__ __align__(16) unsigned char pred_smem[];
  const int4* prog = a.prog;
  if (prog_smem) {
    int4* sp = reinterpret_cast<int4*>(pred_smem);
    for (long long i = threadIdx.x; i < a.len; i += blockDim.x) sp[i] = a.prog[i];
    __syncthreads();
    prog = sp;
  }
  const int tid = threadIdx.x;
  // the entries below the top (need - 1 at most): value v of entry k at
  // sval[(k * kPredV + v) * kThreads + tid], its presence bits at
  // spm[k * kThreads + tid]
  unsigned* sval = reinterpret_cast<unsigned*>(pred_smem + prog_smem);
  unsigned* spm = sval + static_cast<long long>(a.need - 1) * kPredV * kThreads;
  // the block's lane (the stacked form; 0 in the single form)
  const long long lane_off = pred_lane<kStacked>() * a.n;
  unsigned char* out_p = a.out_p + lane_off;
  int* out_v = a.out_v ? a.out_v + lane_off : nullptr;
  const long long step = static_cast<long long>(gridDim.x) * kPredTile;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kPredTile; t0 < a.n; t0 += step) {
    const long long i0 = t0 + static_cast<long long>(tid) * kPredV;
    const bool whole = i0 + kPredV <= a.n;
    int id[kPredV];
    pred_ids<kStacked>(a, i0, whole, id);
    // slots past n are dead from the start; a GUARD kills more
    const unsigned live = pred_bits([&](int v) { return i0 + v < a.n; });
    const bool run = a.ids == nullptr && whole && i0 + kPredV <= a.n_valid;
    unsigned tv[kPredV];
    const unsigned res = pred_run<false, kStacked>(a, prog, prog_smem != 0, sval, spm, nullptr, nullptr,
                                                   nullptr, id, i0, live, run, tv);
    pred_store_mask(out_p, i0, a.n, whole, res);
    if (out_v) {
      if (whole && pred_aligned(out_v + i0, 16)) {
#pragma unroll
        for (int q = 0; q < kPredV / 4; ++q) {
          reinterpret_cast<uint4*>(out_v + i0)[q] =
              make_uint4(tv[4 * q], tv[4 * q + 1], tv[4 * q + 2], tv[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kPredV; ++v) {
          if (i0 + v < a.n) out_v[i0 + v] = static_cast<int>(tv[v]);
        }
      }
    }
  }
}

// K15's lane form (the compiled WHERE under the reference's vmap over a
// group's lanes): one program over n slots against each of `lanes`
// parameter rows (nparams values each), out_p [lanes, n]. Bound: the
// column bytes once (each slot's ids, values and presence as the single
// form reads them) and lanes * n mask bytes written. Design: the lane loop
// runs inside the thread, over what varies by lane only. The rows are
// staged in shared memory once a block. For each tile a thread loads its
// slots' ids, then runs every buffer-reading push of the program (`nloads`
// of them) once, for all its slots in range, into a cache in shared memory
// beside the stack ([nloads][kPredV][kThreads] values and [nloads]
// [kThreads] presence words: no load is skipped by a lane's GUARD, since
// another lane may keep the slot); then it runs the program once a lane
// against the cache and that lane's row, and stores the lane's kPredV mask
// bytes (coalesced along the lane's row). A lane's arithmetic is the
// single form's, so its mask is the single form's on that row.
__global__ void __launch_bounds__(kThreads)
    predicate_eval_lanes_kernel(const __grid_constant__ PredArgs a, int prog_smem, int lanes,
                                int nparams, int nloads) {
  extern __shared__ __align__(16) unsigned char pred_smem[];
  const int4* prog = a.prog;
  if (prog_smem) {
    int4* sp = reinterpret_cast<int4*>(pred_smem);
    for (long long i = threadIdx.x; i < a.len; i += blockDim.x) sp[i] = a.prog[i];
    prog = sp;
  }
  const int tid = threadIdx.x;
  unsigned* sval = reinterpret_cast<unsigned*>(pred_smem + prog_smem);
  unsigned* spm = sval + static_cast<long long>(a.need - 1) * kPredV * kThreads;
  unsigned* cval = spm + static_cast<long long>(a.need - 1) * kThreads;
  unsigned* cpm = cval + static_cast<long long>(nloads) * kPredV * kThreads;
  int* s_params = reinterpret_cast<int*>(cpm + static_cast<long long>(nloads) * kThreads);
  for (int i = tid; i < lanes * nparams; i += kThreads) s_params[i] = a.params[i];
  __syncthreads();
  const int len = static_cast<int>(a.len);
  const long long step = static_cast<long long>(gridDim.x) * kPredTile;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kPredTile; t0 < a.n; t0 += step) {
    const long long i0 = t0 + static_cast<long long>(tid) * kPredV;
    const bool whole = i0 + kPredV <= a.n;
    int id[kPredV];
    pred_ids<false>(a, i0, whole, id);
    const unsigned live = pred_bits([&](int v) { return i0 + v < a.n; });
    const bool run = a.ids == nullptr && whole && i0 + kPredV <= a.n_valid;
    // the tile's buffer loads, once for every lane
    unsigned tv[kPredV];
    unsigned tp;
    for (int pc = 0, c = 0; pc < len && c < nloads; ++pc) {
      const int4 ins = prog_smem ? prog[pc] : __ldg(prog + pc);
      if (!((kPredLoads >> ins.x) & 1u)) continue;
      pred_push<false>(a, ins, id, i0, live, run, tv, tp);
#pragma unroll
      for (int v = 0; v < kPredV; ++v) cval[(c * kPredV + v) * kThreads + tid] = tv[v];
      cpm[c * kThreads + tid] = tp;
      ++c;
    }
    for (int l = 0; l < lanes; ++l) {
      const unsigned res = pred_run<true, false>(a, prog, prog_smem != 0, sval, spm, cval, cpm,
                                          s_params + l * nparams, id, i0, live, run, tv);
      pred_store_mask(a.out_p + static_cast<long long>(l) * a.n, i0, a.n, whole, res);
    }
  }
}

// ---------------------------------------------------------------------------
// K16: scatter_set (replaces device_graph.apply_patches :382, the
// `arr.at[idx].set(vals)` of one delta key).
// Bound: S*(4 + w) bytes read (index and value) + S*w written, w = 4 (int32,
// float32) or 1 (bool).
// Design: one thread per (index, value) pair, a plain store into the
// resident array, in place: a captured replay keeps the array's pointer.
// The maintainer keeps one (phase, value) per cell and the pow2 padding
// repeats the last pair, so repeated indices always carry the same value
// and no atomics are needed. An index outside [0, len) is dropped (the
// wrapper refuses such a segment before it uploads it).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void scatter_set_kernel(T* __restrict__ arr, long long len,
                                   const int* __restrict__ idx,
                                   const T* __restrict__ vals, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    const long long j = idx[i];
    if (j >= 0 && j < len) arr[j] = vals[i];
  }
}

// Sum of one value per thread across the block, returned to every thread.
__device__ unsigned block_sum(unsigned v, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  unsigned t = 0u;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) t += warp_sums[k];
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------------------
// K17: slab_scan (replaces tpu_engine._expand_slab :1007, the window scan a
// class falls back to once one of its slab buckets overflowed).
// Bound: a join of the W window slots with the R rows' sources. Read: R*4
// bytes of sources, W*(4 + 1) of the window's active endpoints and
// liveness, and the emitted endpoint at each hit (4 bytes, h of them);
// written: 12 bytes an output slot (n of them). At W4's shape (R 2,048,
// W 2^19, 46 hits into 128) ~2.6 MB, ~0.0008 ms. The reference's
// [R, W] compare mask (R*W compares) is its algorithm, not the function's
// cost, so no stage here grows with R*W.
// Design: a window join in eight launches after one memset, no [R, W]
// mask and no library sort, search or compaction:
//  1. slab_hist_kernel: one read of the window; the live slots' active
//     endpoints (keys) counted by each of their four 8-bit digits into
//     per-pass histograms (a block's counts in shared memory, added to
//     the global ones once a block); the last block to finish writes the
//     sort's plan (the live count, one past the last live slot, each
//     pass's digit bases, which passes move pairs and which buffer each
//     reads);
//  2. slab_sort_pass_kernel, four LSD radix passes over (key, slot):
//     pass 0 reads the window itself, up to its last live slot, and keeps
//     only the live slots (a tombstone or a -1 endpoint matches no
//     source), so later passes sort L <= W pairs. A block takes a tile
//     of 4,096 pairs (16 a thread, warp-striped, so a warp's pairs are
//     consecutive), ranks each pair among the tile's pairs of its digit in
//     pair order (the lanes of a digit by eight ballots, a running count a
//     warp and digit in shared memory, then the warps' counts scanned
//     digit by digit), stages the tile in shared memory in digit order,
//     finds the pairs of each digit in earlier tiles by a decoupled
//     look-back by tile (the tile number from an atomic counter), and
//     writes each digit's run of the tile to consecutive positions: its
//     digit's base in the pass + that prefix.
//     Each pass is stable, so the window ends sorted by (key, slot). A
//     pass whose digit is one value for every key (the high digits of
//     vertex ids below 2^24 or 2^16) is skipped: its launch returns, and
//     the sorted pairs stay in the buffer the last pass wrote (the plan
//     says which, so a replay needs no host read);
//  3. each row's hits are one run of the sorted keys, [lower bound,
//     upper bound) of its source: slab_runs_kernel finds them (a thread a
//     row, its search narrowed to the source's bucket of the last moving
//     pass), and K2's degree scan over RunSpan gives each row its output
//     offset and the device total;
//  4. K2b's merge-path gather over SlabGather writes (row, base + slot,
//     e[slot]) for the first min(total, capacity) hits in row-major order
//     (row ascending, then slot ascending) and -1 to the capacity.
// Exact under skew: a source with thousands of slab edges is one long run
// that K2b's merge path splits across blocks, and a source repeated on
// many rows finds the same run on each. The output capacity comes from
// the caller's size_for(total) between launches 7 and 8, as before.
// ---------------------------------------------------------------------------
constexpr int kSortItems = 16;  // pairs a thread
constexpr long long kSortTile = kThreads * kSortItems;  // pairs a tile
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kSortPasses = 32 / kDigitBits;
constexpr unsigned kNoDigit = 0xffffffffu;
static_assert(kDigits == kThreads, "one thread a digit in the look-back and the plans");

// The sort's scratch, one allocation set to 0xFF bytes by one memset: the
// histograms (kSortPasses x kDigits complemented counts: ~x is the count,
// so the memset is their zero), the plan, then each pass's look-back state
// (a tile counter word, a status word a tile, then kDigits counts a tile
// and kDigits inclusive prefixes a tile), then the rows' runs and K2's
// look-back state.
inline long long sort_tiles(long long w) { return w > 0 ? (w + kSortTile - 1) / kSortTile : 0; }
inline long long sort_hist_bytes() { return 4LL * kSortPasses * kDigits; }
inline long long sort_pass_words(long long w) {
  return 1 + (sort_tiles(w) + 1) / 2 + sort_tiles(w) * kDigits;  // 8-byte words
}
constexpr long long kSortPlanBytes = 4LL * (16 + kSortPasses * kDigits);  // slab_hist_kernel's plan
inline long long sort_starts_bytes(long long r) { return 8 * ((r + 1) / 2); }
inline long long sort_scratch_bytes(long long w, long long r) {
  return sort_hist_bytes() + kSortPlanBytes + 8 * kSortPasses * sort_pass_words(w) +
         2 * sort_starts_bytes(r) + lb_state_bytes(r > 0 ? (r + kDegTile - 1) / kDegTile : 0);
}

// The scratch's parts in that order; a row's run is two uint32 arrays
// ([r] starts, then [r] ends).
struct SlabScratch {
  unsigned* hist;
  unsigned* plan;
  unsigned long long* pass[kSortPasses];
  unsigned* starts;
  unsigned* ends;
  unsigned long long* scan;
};

inline SlabScratch slab_scratch(void* p, long long w, long long r) {
  char* c = static_cast<char*>(p);
  SlabScratch sc;
  sc.hist = reinterpret_cast<unsigned*>(c);
  sc.plan = reinterpret_cast<unsigned*>(c + sort_hist_bytes());
  unsigned long long* st = reinterpret_cast<unsigned long long*>(c + sort_hist_bytes() + kSortPlanBytes);
  for (int q = 0; q < kSortPasses; ++q) sc.pass[q] = st + q * sort_pass_words(w);
  sc.starts = reinterpret_cast<unsigned*>(st + kSortPasses * sort_pass_words(w));
  sc.ends = reinterpret_cast<unsigned*>(reinterpret_cast<char*>(sc.starts) + sort_starts_bytes(r));
  sc.scan = reinterpret_cast<unsigned long long*>(reinterpret_cast<char*>(sc.ends) + sort_starts_bytes(r));
  return sc;
}

// The sort's plan, written once by the histogram's last block: [0] the
// sorted pairs' count n (the live slots), [1] the buffer that ends with
// them, [2 + p] pass p's form (bit 1: it moves pairs; bit 0: the buffer it
// reads; bits 8-15 of a pass that moves nothing: the digit every key has
// there), [6] the last pass that moves pairs, [7] the histogram blocks'
// done counter, [8] one past the window's last live slot (pass 0 reads no
// further), then from [16] each pass's digit bases (the exclusive scan of
// its digit counts). Past the last moving pass every key shares its digits, so
// that pass's bases split the sorted keys into 256 contiguous buckets.
constexpr int kPlanPass = 2;
constexpr int kPlanTop = 6;
constexpr int kPlanDone = 7;
constexpr int kPlanEnd = 8;
constexpr int kPlanBase = 16;

__global__ void __launch_bounds__(kThreads)
slab_hist_kernel(const int* __restrict__ a, const unsigned char* __restrict__ live, long long w,
                 unsigned* __restrict__ hist, unsigned* __restrict__ plan) {
  __shared__ unsigned s_h[kSortPasses * kDigits];
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_end;
  __shared__ bool s_last;
  const int t = threadIdx.x;
  for (int i = t; i < kSortPasses * kDigits; i += kThreads) s_h[i] = 0u;
  if (t == 0) s_end = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned end = 0u;  // one past this thread's last live slot
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + t; j < w; j += stride) {
    const int x = __ldg(a + j);
    if (x < 0 || !__ldg(live + j)) continue;
    end = static_cast<unsigned>(j) + 1u;
#pragma unroll
    for (int p = 0; p < kSortPasses; ++p) {
      atomicAdd(&s_h[p * kDigits + ((static_cast<unsigned>(x) >> (kDigitBits * p)) & (kDigits - 1))], 1u);
    }
  }
  if (end != 0u) atomicMax(&s_end, end);
  __syncthreads();
  for (int i = t; i < kSortPasses * kDigits; i += kThreads) {
    if (s_h[i] != 0u) atomicSub(hist + i, s_h[i]);
  }
  if (t == 0 && s_end != 0u) atomicMin(plan + kPlanEnd, ~s_end);  // complemented: the memset is 0
  // the last block to finish writes the plan (the counter starts at ~0)
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(plan + kPlanDone, 1u) + 1u == gridDim.x - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  unsigned c[kSortPasses];
#pragma unroll
  for (int p = 0; p < kSortPasses; ++p) c[p] = ~__ldcg(hist + p * kDigits + t);
  const unsigned n = block_sum(c[0], s_warp);
  int cur = 0, top = 0;  // pass 0 reads the window and writes buffer 0
#pragma unroll
  for (int p = 0; p < kSortPasses; ++p) {
    // a pass whose digit is one value for every key keeps the order
    const bool moves = p == 0 || __syncthreads_or(c[p] == n) == 0;
    if (moves) {
      if (t == 0) plan[kPlanPass + p] = 2u | static_cast<unsigned>(cur);
      if (p > 0) {
        cur ^= 1;
        top = p;
      }
    } else if (c[p] == n && (n > 0 || t == 0)) {
      plan[kPlanPass + p] = static_cast<unsigned>(t) << 8 | static_cast<unsigned>(cur);
    }
    plan[kPlanBase + p * kDigits + t] = block_exclusive_scan<unsigned>(c[p], s_warp);
  }
  if (t == 0) {
    plan[0] = n;
    plan[1] = static_cast<unsigned>(cur);
    plan[kPlanTop] = static_cast<unsigned>(top);
    plan[kPlanEnd] = ~__ldcg(plan + kPlanEnd);
  }
}

template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
slab_sort_pass_kernel(const int* __restrict__ a, const unsigned char* __restrict__ live,
                      long long w, unsigned* __restrict__ keys0, unsigned* __restrict__ slots0,
                      unsigned* __restrict__ keys1, unsigned* __restrict__ slots1,
                      const unsigned* __restrict__ plan, unsigned long long* __restrict__ state,
                      int pass) {
  __shared__ unsigned s_cnt[kWarps][kDigits];  // a warp's running count, then its offset
  __shared__ unsigned s_toff[kDigits];         // a digit's first pair in the staged tile
  __shared__ unsigned s_base[kDigits];         // global position - staged position, by digit
  __shared__ unsigned s_key[kSortTile];        // the tile's pairs, staged in digit order
  __shared__ unsigned s_slot[kSortTile];
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_tile;
  __shared__ unsigned s_m;                     // the tile's pairs
  __shared__ long long s_from;  // the nearest earlier tile with inclusive prefixes
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned form = __ldg(plan + kPlanPass + pass);
  if (!(form & 2u)) return;  // uniform: the pass keeps the order
  // pass 0 reads the window up to its last live slot, a later pass the n pairs
  const long long n = static_cast<long long>(__ldg(plan + (kFirst ? kPlanEnd : 0)));
  const unsigned dbase = __ldg(plan + kPlanBase + pass * kDigits + t);  // the digit's base in the pass
  const unsigned tile = lb_tile(state, &s_tile);
  const long long t0 = static_cast<long long>(tile) * kSortTile;
  if (t0 >= n) return;  // uniform; no later tile is live either
  // pass 0 reads the window and writes buffer 0; a later pass writes the
  // buffer it does not read
  const int from = static_cast<int>(form & 1u);
  const unsigned* kin = from ? keys1 : keys0;
  const unsigned* sin = from ? slots1 : slots0;
  unsigned* kout = kFirst || from ? keys0 : keys1;
  unsigned* sout = kFirst || from ? slots0 : slots1;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) s_cnt[wi][t] = 0u;
  unsigned key[kSortItems], slot[kSortItems], dig[kSortItems], rank[kSortItems];
  const long long wbase = t0 + static_cast<long long>(warp) * 32 * kSortItems;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const long long pos = wbase + i * 32 + lane;
    dig[i] = kNoDigit;
    key[i] = slot[i] = 0u;
    if (pos < n) {
      if (kFirst) {
        const int x = __ldg(a + pos);
        if (x >= 0 && __ldg(live + pos)) {
          key[i] = static_cast<unsigned>(x);
          slot[i] = static_cast<unsigned>(pos);
          dig[i] = key[i] & (kDigits - 1);
        }
      } else {
        key[i] = __ldg(kin + pos);
        slot[i] = __ldg(sin + pos);
        dig[i] = (key[i] >> (kDigitBits * pass)) & (kDigits - 1);
      }
    }
  }
  __syncthreads();
  // a pair's rank among the warp's earlier pairs of its digit (pair order:
  // item i before i + 1, lane order within an item); the lanes of a digit
  // by one ballot a digit bit
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const unsigned d = dig[i];
    unsigned peers = __ballot_sync(kFull, d != kNoDigit);
#pragma unroll
    for (int b = 0; b < kDigitBits; ++b) {
      const unsigned bit = (d >> b) & 1u;
      const unsigned m = __ballot_sync(kFull, bit != 0u);
      peers &= bit ? m : ~m;
    }
    const unsigned before = __popc(peers & below);
    if (d != kNoDigit) rank[i] = s_cnt[warp][d] + before;
    __syncwarp();
    if (d != kNoDigit && before == 0) s_cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // digit t: the warps' exclusive offsets in the tile and the tile's count
  unsigned count = 0u;
#pragma unroll
  for (int wi = 0; wi < kWarps; ++wi) {
    const unsigned c = s_cnt[wi][t];
    s_cnt[wi][t] = count;
    count += c;
  }
  const unsigned toff = block_exclusive_scan<unsigned>(count, s_warp);
  s_toff[t] = toff;
  if (t == kThreads - 1) s_m = toff + count;
  __syncthreads();
  // the tile's pairs staged in shared memory in (digit, pair) order, so that
  // each digit's run goes out to consecutive global positions
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const unsigned d = dig[i];
    if (d == kNoDigit) continue;
    const unsigned q = s_toff[d] + s_cnt[warp][d] + rank[i];
    s_key[q] = key[i];
    s_slot[q] = slot[i];
  }
  // each digit's pairs in the earlier tiles: a decoupled look-back by tile.
  // A tile publishes its 256 counts, then its status; warp 0 finds the
  // nearest predecessor with inclusive prefixes (32 status words at once),
  // and thread t adds that tile's prefix of digit t and the counts of the
  // tiles after it (eight rows in flight). Only one warp a tile polls.
  const long long tiles = (w + kSortTile - 1) / kSortTile;
  unsigned* status = reinterpret_cast<unsigned*>(state + 1);
  unsigned* agg = reinterpret_cast<unsigned*>(state + 1 + (tiles + 1) / 2);
  unsigned* incl = agg + tiles * kDigits;
  unsigned prefix = 0u;
  if (tile == 0) {
    incl[t] = count;
    __syncthreads();
    if (t == 0) tile_publish(status, kLbPrefix);
  } else {
    agg[static_cast<long long>(tile) * kDigits + t] = count;
    __syncthreads();
    if (t == 0) tile_publish(status + tile, kLbAggregate);
    if (warp == 0) {
      long long pred = static_cast<long long>(tile) - 1 - lane;  // lane 0 the nearest
      for (;;) {
        unsigned st = kLbPrefix;  // before tile 0: a zero prefix
        do {
          if (pred >= 0) st = tile_status(status + pred);
        } while (__any_sync(kFull, st == kLbEmpty));
        const unsigned prefixes = __ballot_sync(kFull, st == kLbPrefix);
        if (prefixes) {
          if (lane == __ffs(prefixes) - 1) s_from = pred < 0 ? 0 : pred;
          break;
        }
        pred -= 32;
      }
    }
    __syncthreads();
    const long long first = s_from;  // < tile
    unsigned part[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) part[u] = 0u;
    long long q = first + 1;
    for (; q + 8 <= tile; q += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) part[u] += __ldcg(agg + (q + u) * kDigits + t);
    }
    for (; q < tile; ++q) part[0] += __ldcg(agg + q * kDigits + t);
    prefix = __ldcg(incl + first * kDigits + t);
#pragma unroll
    for (int u = 0; u < 8; ++u) prefix += part[u];
    incl[static_cast<long long>(tile) * kDigits + t] = prefix + count;
    __syncthreads();
    if (t == 0) tile_publish(status + tile, kLbPrefix);
  }
  s_base[t] = dbase + prefix - toff;
  __syncthreads();
  const int m = static_cast<int>(s_m);
  for (int i = t; i < m; i += kThreads) {
    const unsigned k = s_key[i];
    const unsigned g = s_base[(k >> (kDigitBits * pass)) & (kDigits - 1)] + static_cast<unsigned>(i);
    kout[g] = k;
    sout[g] = s_slot[i];
  }
}

// Step 3a: each row's run of the sorted keys, [the first key not below its
// source, the first key above it), one thread a row over as many blocks as
// the rows need (a search's loads are scattered: one block would be bound
// by its SM's load rate). The plan narrows the search to the source's
// bucket of the last moving pass (a source whose higher digits are not
// every key's matches nothing), then two branch-free binary searches run
// in lockstep. A -1 source's run is empty.
constexpr int kRunThreads = 128;

__global__ void __launch_bounds__(kRunThreads)
slab_runs_kernel(const unsigned* __restrict__ keys0, const unsigned* __restrict__ keys1,
                 const unsigned* __restrict__ plan, const int* __restrict__ srcs, long long r,
                 unsigned* __restrict__ starts, unsigned* __restrict__ ends) {
  const long long i = blockIdx.x * static_cast<long long>(kRunThreads) + threadIdx.x;
  if (i >= r) return;
  const int c = __ldg(srcs + i);
  const unsigned n = __ldg(plan);
  unsigned lo = 0u, hi = 0u;
  if (c >= 0 && n > 0u) {
    const unsigned x = static_cast<unsigned>(c);
    const int top = static_cast<int>(__ldg(plan + kPlanTop));
    bool in = true;
    for (int p = top + 1; p < kSortPasses; ++p) {
      in = in && ((x >> (kDigitBits * p)) & (kDigits - 1)) == (__ldg(plan + kPlanPass + p) >> 8);
    }
    if (in) {
      const unsigned d = (x >> (kDigitBits * top)) & (kDigits - 1);
      const unsigned* base = plan + kPlanBase + top * kDigits;
      lo = hi = __ldg(base + d);
      const unsigned end = d + 1 < static_cast<unsigned>(kDigits) ? __ldg(base + d + 1) : n;
      const unsigned* kk = __ldg(plan + 1) ? keys1 : keys0;
      const unsigned m = end - lo;
      for (unsigned step = m == 0u ? 0u : 1u << (31 - __clz(m)); step != 0u; step >>= 1) {
        const unsigned ka = __ldg(kk + min(lo + step, end) - 1);
        const unsigned kb = __ldg(kk + min(hi + step, end) - 1);
        if (lo + step <= end && ka < x) lo += step;
        if (hi + step <= end && kb <= x) hi += step;
      }
    }
  }
  starts[i] = lo;
  ends[i] = hi;
}

// K2 over the sorted window: row i's span is its run, read by position.
struct RunSpan {
  static constexpr bool kReadsSrcs = false;  // a row's span is read by position
  const unsigned* starts;
  const unsigned* ends;
  template <int V, int J>
  __device__ __forceinline__ void bounds(long long wbase, long long k, const int (&)[V][J],
                                         unsigned (&lo)[V][J], unsigned (&hi)[V][J]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const long long i = wbase + static_cast<long long>(v * 32 + lane) * J + j;
        lo[v][j] = i < k ? __ldg(starts + i) : 0u;
        hi[v][j] = i < k ? __ldg(ends + i) : 0u;
      }
    }
  }
};

// K2b over the sorted window: row r's base is its run's start; position ep
// of the sorted pairs is window slot s, written as (base + s, e[s]).
struct SlabGather {
  const unsigned* slots[2];
  const unsigned* plan;
  const unsigned* starts;
  const int* e;
  int eid_base;
  using Row = int;  // the row's run start
  __device__ __forceinline__ static int base(Row x) { return x; }
  __device__ __forceinline__ Row row(long long r, long long) const {
    return static_cast<int>(__ldg(starts + r));
  }
  __device__ __forceinline__ int3 emit(Row, long long r, int ep) const {
    const unsigned n = __ldg(plan), b = __ldg(plan + 1);
    if (n == 0u) return make_int3(static_cast<int>(r), -1, -1);
    const unsigned i = ep < 0 ? 0u : (static_cast<unsigned>(ep) < n ? static_cast<unsigned>(ep) : n - 1u);
    const unsigned s = __ldg((b ? slots[1] : slots[0]) + i);
    return make_int3(static_cast<int>(r), static_cast<int>(static_cast<unsigned>(eid_base) + s), __ldg(e + s));
  }
};

// ---------------------------------------------------------------------------
// K18: slab_probe (replaces tpu_engine._expand_slab_bucketed :1061, the
// usual slab path).
// Bound: R*4 bytes (sources) + (rows with a source)*BK*4 (their buckets'
// entries) + (filled entries probed)*(4 + 1) (the owning endpoint and
// liveness behind each) + matches*4 (their neighbours) read, plus the
// decode's output (12 bytes a slot); a -1 source and an empty entry read
// nothing behind the table.
// Design: one thread per (row, bucket slot) probes bucket src & (NB-1) (a
// -1 source masks to the last bucket, as in the reference, and matches
// nothing) and writes the match flag and the relative slot; the existing
// compact_indices (K3) compacts the flags in row-major order; the decode
// pass, one thread per output slot, writes (row, base + rel, nbr_a[base +
// rel]), -1 past the compacted count.
// ---------------------------------------------------------------------------
__global__ void slab_probe_kernel(const int* __restrict__ tab, const int* __restrict__ own,
                                  const unsigned char* __restrict__ live, long long ecap,
                                  const int* __restrict__ srcs, long long r, int nb, int bk,
                                  int base, unsigned char* __restrict__ mask,
                                  int* __restrict__ rel_o) {
  const long long n = r * bk;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    const long long row = i / bk;
    const int slot = static_cast<int>(i - row * bk);
    const int src = srcs[row];
    const int b = src & (nb - 1);
    const int rel = tab[static_cast<long long>(b) * bk + slot];
    bool m = false;
    if (rel >= 0 && src >= 0) {
      const long long at = static_cast<long long>(base) + rel;
      m = at < ecap && own[at] == src && live[at] != 0;
    }
    mask[i] = m ? 1 : 0;
    rel_o[i] = rel;
  }
}

__global__ void slab_decode_kernel(const int* __restrict__ idx, long long out,
                                   const int* __restrict__ rel, int bk, int base,
                                   const int* __restrict__ nbr_a, long long ecap,
                                   int* __restrict__ row_o, int* __restrict__ eid_o,
                                   int* __restrict__ nbr_o) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < out;
       q += stride) {
    const int i = idx[q];
    if (i < 0) {
      row_o[q] = -1;
      eid_o[q] = -1;
      nbr_o[q] = -1;
      continue;
    }
    const int eid = base + rel[i];
    const long long at = eid < 0 ? 0 : (eid < ecap ? eid : ecap - 1);
    row_o[q] = i / bk;
    eid_o[q] = eid;
    nbr_o[q] = nbr_a[at];
  }
}

// ---------------------------------------------------------------------------
// The tier plane's paged reads (replace orientdb_tpu/storage/tiering.py
// paged_hop :575, paged_hop_miss :590, paged_expand :606). A paged
// (edge class, direction) partition keeps its edges in a device pool of P
// pages of Wp slots, three int32 rows a page: `own` (the endpoint that must
// be active, -1 on an unused slot and on every slot of an evicted page),
// `nbr` (the endpoint reached) and `eid` (the edge id in out order); a
// `pageof[B]` indirection maps each vertex-range block to its page (-1 =
// cold) and `blockv[V]` each vertex to its block. Loads and evictions write
// these rows in place on the replay stream, so a captured replay reads them
// through the pointers it holds. Every gather below keeps take_pad's
// semantics: a negative index reads the fill, an index past the end the
// last value. K19, the hop, is K10's push over the resident indptr and this
// indirection (PagedRows, beside K10's CSR form).
// ---------------------------------------------------------------------------

// K20: paged_hop_miss. Sets *flag when some vertex v < V is active in a
// frontier row (and in the WHILE gate), has degree > 0 in this direction,
// and its block is cold: the reference's scatter-max of the active vertices
// over the blocks followed by any(touched & pageof < 0), without the [B]
// temporary. Bound: the frontier's first V columns (C bytes a vertex), the
// gate at the vertices active in a row, and at those that pass it 8 bytes
// of indptr and 8 of blockv and pageof.
// Design: one thread per vertex in a grid-stride loop, the frontier tested
// first (most vertices are inactive), all C rows loaded without an early
// exit so the loads overlap; the entry point zeroes the flag and
// threads store only 1s; nothing syncs. `alive` (may be null) at 0 exits.
// A replay does not launch it: K19's push raises the same flag in its
// row map (PagedRows::miss), so a tiered hop is one launch; this kernel
// stays as the flag's standalone form, held against its plain version.
__global__ void paged_hop_miss_kernel(const unsigned char* __restrict__ frontier,
                                      const unsigned char* __restrict__ gate, long long c,
                                      long long vb, const int* __restrict__ blockv,
                                      long long nv, const int* __restrict__ pageof,
                                      long long nb, const int* __restrict__ indptr,
                                      const int* __restrict__ alive,
                                      unsigned char* __restrict__ flag) {
  if (alive != nullptr && *alive == 0) return;
  const long long n = nv < vb ? nv : vb;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < n;
       v += stride) {
    bool act = false;  // every row read: independent loads, no chain
    for (long long r = 0; r < c; ++r) act |= frontier[r * vb + v] != 0;
    if (!act || (gate != nullptr && !gate[v])) continue;
    if (indptr[v + 1] - indptr[v] <= 0) continue;
    const int b = blockv[v];
    if (b >= 0 && b < nb && pageof[b] < 0) *flag = 1;
  }
}

// K21: paged_expand (replaces tiering.paged_expand, orientdb_tpu/storage/
// tiering.py:606): K2b's merge-path gather (gather_expand_kernel) over the
// resident indptr, with PagedGather as its Gather. Row and edge position
// are K2b's; nbr (and, for the in direction, the out-order edge id) come
// from pool[pageof[b] * Wp + clip(edge_pos - estart[b], 0, Wp-1)] (at most
// the last pool slot) with b = blockv[clip(src, 0, V-1)] clipped to B-1 for
// the reads, the reference's take_pad clips. A live slot of a row whose
// block is cold (b or pageof[b] below 0, or no blocks) is -1 in all three
// outputs and stores 1 into the cold flag; the out direction's edge id is
// the edge position. Bound: K2b's (12 bytes a source, three int32 outputs
// a slot) plus 12 bytes of blockv / pageof / estart a source and one or
// two pool reads a live slot.
// Design: the row stage stages, once a row, the edge base indptr[clip(src)],
// the page p and the block start estart[b] (Row, 12 bytes: 41 KB of shared
// memory a block with K2b's other arrays), so that a slot reads only the
// pool; consecutive slots of a row read consecutive pool slots, and a row
// longer than a tile spans tiles as in K2b. The flag byte only receives 1s:
// a replay passes its schedule's shared miss byte (zeroed once), else the
// host entry zeroes the byte first.
struct PagedGather {
  const int* indptr;
  long long nv;
  const int* blockv;
  const int* pageof;
  long long nb;
  const int* estart;
  const int* pool_nbr;
  const int* pool_eid;  // null on the out direction
  long long ns, wp;
  unsigned char* flag;
  struct Row {
    int base;   // indptr[clip(src)]
    int page;   // pageof[b], -1 cold
    int start;  // estart[b]
  };
  __device__ __forceinline__ static int base(const Row& x) { return x.base; }
  __device__ __forceinline__ Row row(long long, long long c) const {
    c = c > nv - 1 ? nv - 1 : c;
    c = c < 0 ? 0 : c;
    Row x{__ldg(indptr + c), -1, 0};
    const long long b = nv > 0 ? __ldg(blockv + c) : -1;
    const long long bc = b < nb ? b : nb - 1;
    if (bc >= 0) {
      x.page = __ldg(pageof + bc);
      x.start = __ldg(estart + bc);
    }
    return x;
  }
  __device__ __forceinline__ int3 emit(const Row& x, long long r, int ep) const {
    if (x.page < 0) {
      *flag = 1;
      return make_int3(-1, -1, -1);
    }
    long long local = static_cast<long long>(ep) - x.start;
    local = local < 0 ? 0 : (local < wp ? local : wp - 1);
    long long flat = static_cast<long long>(x.page) * wp + local;
    flat = flat > ns - 1 ? ns - 1 : flat;
    const int nbr = ns > 0 ? __ldg(pool_nbr + flat) : -1;
    const int eid = pool_eid == nullptr ? ep : (ns > 0 ? __ldg(pool_eid + flat) : -1);
    return make_int3(static_cast<int>(r), eid, nbr);
  }
};

// ---------------------------------------------------------------------------
// The mesh (orientdb_tpu/parallel/mesh_graph.py, orientdb_tpu/parallel/
// sharded.py). A sharded array keeps the reference's host layout with a
// leading [S_l, ...] axis (S_l the shards held by this process: all S in one
// process, one a rank of a process group), and each kernel launches once
// over every shard it holds. Where the reference merges shards with a
// collective, these kernels write the merged result directly: rows at each
// shard's global offset (disjoint), 1s into one bitmap, integer atomics into
// one vector. A rank of a process group runs the same kernels at S_l = 1 on
// a zeroed private buffer and merges with the collective (`plus_one` makes
// K22's disjoint rows summable: value + 1, 0 elsewhere).
// ---------------------------------------------------------------------------

// K2 range form (replaces mesh_graph.expand_totals,
// orientdb_tpu/parallel/mesh_graph.py:258). Grid (sources, shards): shard s
// counts the out-degree of each source inside its row range [lo, hi), read
// from `span` ([S_l, 2], the `sh:rowspan` rows) on the device, through its
// rebased indptr row `ind + s * r1`; counts[s, i] is written and the shard's
// total added into tots[s] (integer atomics a warp: exact). Bound: the
// sources once a shard, two indptr reads an owned source, counts written.
__global__ void degree_counts_range_kernel(const int* __restrict__ ind, long long r1,
                                           const int* __restrict__ span,
                                           const int* __restrict__ srcs, long long n,
                                           int* __restrict__ counts,
                                           unsigned* __restrict__ tots) {
  const long long s = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned c = 0;
  if (i < n) {
    const int lo = span[2 * s];
    const int hi = span[2 * s + 1];
    const int src = srcs[i];
    const long long nv = r1 - 1;
    if (src >= lo && src < hi && nv > 0) {
      long long ls = static_cast<long long>(src) - lo;
      if (ls > nv - 1) ls = nv - 1;
      const int* row = ind + s * r1;
      c = static_cast<unsigned>(row[ls + 1] - row[ls]);
    }
    counts[s * n + i] = static_cast<int>(c);
  }
  warp_count_add(c, tots + s);
}

// K22: shard_gather (replaces mesh_graph.expand_gather,
// orientdb_tpu/parallel/mesh_graph.py:345). Output slot p of the merged
// [cap_total] segment belongs to the shard s whose range [base_s, base_s +
// min(tot_s, cap)) holds it, base_s the exclusive prefix of the global
// totals `tots` ([S]; this process holds shards s0 .. s0 + S_l - 1). Within
// the shard, q = p - base_s is found as in K2b: an upper-bound search over
// the shard's row of `offsets` (the flat exclusive scan of K2's [S_l, n]
// counts, rebased by its first element), then the rebased edge position
// epos = ind[s][src - lo] + (q - off), the neighbour nbr[s][epos] and the
// edge id epos + ebase[s] (out, extra is [S_l, 1]) or eid[s][epos] (in,
// extra is [S_l, emax]). Slots of no shard are -1 (or 0 with `plus_one`,
// which writes value + 1 elsewhere). The segment is shard-major, as the
// reference's psum of disjoint rows leaves it; an empty shard owns no slot,
// which is the reference's cond-skip decided on the device. Bound: three
// int32 outputs a slot, the S totals, log2(n) offsets and four reads a live
// slot. One thread a slot; the totals' prefix is computed per block in
// shared memory (S <= 1024).
__global__ void shard_gather_kernel(const int* __restrict__ ind, long long r1,
                                    const int* __restrict__ nbr, long long emax,
                                    const int* __restrict__ extra, long long extra_w,
                                    const int* __restrict__ span,
                                    const int* __restrict__ srcs, long long n,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ tots, long long n_shards,
                                    long long s0, long long s_local, long long cap,
                                    long long cap_total, int is_out, int plus_one,
                                    int* __restrict__ row_out, int* __restrict__ eid_out,
                                    int* __restrict__ nbr_out) {
  __shared__ long long base[1025];
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (long long t = 0; t < n_shards; ++t) {
      base[t] = acc;
      acc += static_cast<long long>(tots[t]);
    }
    base[n_shards] = acc;
  }
  __syncthreads();
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= cap_total) return;
  const int pad = plus_one ? 0 : -1;
  long long sl = -1;
  for (long long k = 0; k < s_local; ++k) {
    const long long t = s0 + k;
    long long lim = base[t + 1] - base[t];
    if (lim > cap) lim = cap;
    if (p >= base[t] && p < base[t] + lim) {
      sl = k;
      break;
    }
  }
  if (sl < 0 || n == 0) {
    row_out[p] = pad;
    eid_out[p] = pad;
    nbr_out[p] = pad;
    return;
  }
  const long long q = p - base[s0 + sl];
  const int* off = offsets + sl * n;
  const long long row0 = off[0];
  long long lo = 0, hi = n;  // first row whose offset is > q
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(off[mid]) - row0 <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long r = lo > 0 ? lo - 1 : 0;
  const long long nv = r1 - 1;
  long long ls = static_cast<long long>(srcs[r]) - span[2 * sl];
  ls = ls < 0 ? 0 : (ls < nv ? ls : nv - 1);  // clip(src, 0, R-1)
  const long long epos =
      static_cast<long long>(ind[sl * r1 + ls]) + (q - (static_cast<long long>(off[r]) - row0));
  long long c = epos < 0 ? 0 : (epos < emax ? epos : emax - 1);
  const int nb = nbr[sl * emax + c];
  int eid;
  if (is_out) {
    eid = static_cast<int>(epos) + extra[sl * extra_w];
  } else {
    eid = epos < 0 ? -1 : extra[sl * extra_w + c];
  }
  const int add = plus_one ? 1 : 0;
  row_out[p] = static_cast<int>(r) + add;
  eid_out[p] = eid + add;
  nbr_out[p] = nb + add;
}

// K23: shard_weight_pass (replaces mesh_graph.sharded_weight_pass,
// orientdb_tpu/parallel/mesh_graph.py:480): one COUNT-pushdown weight pass
// over the held shards, out[v] += sum over v's edges of emask(e) * ok(u) *
// w(u) (each factor only where given). The reference scatters every slot
// of the equal edge-range slices (`el:*`) into out[clip(seg)]; this walks
// the row-sharded CSR of the direction instead (`sh:<class>:{out,in}:*`):
// an out pass sums at the source over `:out:` (u = nbr, edge id ebase +
// slot), an in pass at the target over `:in:` (u = nbr, edge id
// `:in:eid`). A held row is vertex (s0 + h) * R + l; rows at or past vb
// hold no edge in any layout MeshGraph builds (R * S covers V <= vb with
// empty rows) and are not written. ok, w and emask are take_pad's (-1 reads
// False / 0, past the end the last).
// Bound: 4 bytes of nbr an edge (+1 of a direct mask, +4 of eid in), 4 of
// indptr a row, out read and written at each held row below vb, each
// table once (and the fold's [vb] pass where it folds); a random gather
// moves a 32-byte L2 sector, so at A's pass (80M edges) the sectors bound
// it, not the bytes.
// Design: K4's merge path (seg_partition_kernel, seg_sum_kernel,
// seg_fixup_kernel), one path a held shard in one launch each: the grid is
// S_l * ceil((R + emax) / kSegTile) tiles, sized from the held rows and
// slots (a tile past its shard's edges has nothing to do), never from a
// value read on the host. The gather goes in the tile's load stage: each
// thread takes kSegItems slots in two runs of kWeightStage, streams their
// nbr (and eid) first, then gathers the tables in stages that load only
// for the slots still kept (the direct edge mask, the vertex mask, the
// edge mask through eid, the weight), each stage's loads issued together,
// and stores the values' bits in shared memory for K4's walk. The vertex
// mask is folded into the weights first (shard_fold_kernel) where that is
// worth it: an edge then needs one gather, of the folded weight. A random
// gather from a 32 MiB table costs ~1.45 times one from an 8 MiB mask on
// the card (PERF.md §6, K23), so with weights that large the fold
// kernel samples the mask first and folds only where it keeps at least 30
// % of the vertices; else the tiles gather the mask, then the weights of
// the kept edges. Both give the same values. A row that ends in a tile is
// added into out once, by one thread; a row across tiles gets its carries
// in tile order. No atomics: int32 sums (in uint32) wrap as the atomics
// did, and the float32 sums repeat bit for bit between calls.
constexpr int kWeightStage = kSegItems / 2;  // slots a thread gathers at once
static_assert(kSegItems % kWeightStage == 0, "whole stage runs");
// K23's fold of ok into w: none (an in pass reading its edge mask through
// :in:eid, or tables of other lengths), always (weights L2 gathers at its
// full rate), or decided on the device by a sample of ok.
constexpr int kFoldNone = 0, kFoldAlways = 1, kFoldSample = 2;
// The fold pays from this many kept samples of kThreads (30 %) on.
constexpr int kSampleKeep = kThreads * 3 / 10;

// K23's fold: folded[i] = ok[i] ? w[i] : 0 over the n weights (ok is as
// long: launch_shard_weight_pass checks), after *decide is set: 1 to fold
// and gather the folded weights alone, 0 to gather ok and w as they are. Under
// kFoldSample every block reads ok at the same kThreads fixed positions
// (L1 and L2 hits after the first block) and folds only when at least
// kSampleKeep of them are kept; a block that does not fold returns at once.
// Bound: n bytes of ok, 4n of w read, 4n written.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    shard_fold_kernel(const unsigned char* __restrict__ ok, const T* __restrict__ w, long long n,
                      int fold, int* __restrict__ decide, T* __restrict__ folded) {
  int fold_it = 1;
  if (fold == kFoldSample) {
    const unsigned long long pos = (static_cast<unsigned long long>(threadIdx.x) * 2654435761ull) % n;
    fold_it = __syncthreads_count(ok[pos] != 0) >= kSampleKeep;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *decide = fold_it;
  if (!fold_it) return;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
    folded[i] = ok[i] ? w[i] : T(0);
  }
}

template <typename T>
struct ShardWeights {
  const int* ind;                // [S_l, r + 1] rebased rows
  long long r;
  const int* nbr;                // [S_l, emax]
  long long emax;
  const int* extra;              // out: ebase [S_l]; in: eid [S_l, emax]
  int is_out;
  const unsigned char* emask;    // [n_em] or null
  long long n_em;
  const unsigned char* ok;       // [n_ok] or null
  long long n_ok;
  const T* w;                    // [n_w] or null (ones)
  long long n_w;
  unsigned keep;                 // tables under evict_last: 1 ok, 2 emask, 4 w
  const int* decide;             // the fold's decision, or null (no fold)
  const T* folded;               // [n_w] ok folded into w, where *decide
  T* out;                        // [vb]
  long long row0, vb;            // the first held row's vertex (s0 * r)
  __device__ const int* indptr(long long h) const { return ind + h * (r + 1); }
  __device__ int head(long long, int) const { return 0; }
  __device__ void stage(unsigned* s_val, long long h, long long j, int nj, int) const {
    const int tid = threadIdx.x;
    // folded: the weight alone, whose gathers return 0 where ok is False
    const bool fold = decide != nullptr && *decide != 0;
    const bool use_ok = ok != nullptr && !fold;
    const T* wt = fold ? folded : w;
    const int* nb = nbr + h * emax + j;
    const int* ids = is_out ? nullptr : extra + h * emax + j;
    const long long ebase = is_out ? static_cast<long long>(extra[h]) + j : 0;
    const bool in_mask = emask != nullptr && !is_out;
#pragma unroll 1
    for (int run = 0; run < kSegItems; run += kWeightStage) {
      int e[kWeightStage], id[kWeightStage];
      bool kp[kWeightStage];
#pragma unroll
      for (int q = 0; q < kWeightStage; ++q) {
        const int k = tid + (run + q) * kThreads;
        kp[q] = k < nj;
        e[q] = kp[q] ? __ldcs(nb + k) : -1;
        id[q] = kp[q] && in_mask ? __ldcs(ids + k) : -1;
      }
      if (emask != nullptr && is_out) {  // the edge id is ebase + slot: a direct byte stream
#pragma unroll
        for (int q = 0; q < kWeightStage; ++q) {
          const long long i = ebase + tid + (run + q) * kThreads;
          kp[q] = kp[q] && i >= 0 && n_em > 0 && emask[i < n_em ? i : n_em - 1] != 0;
        }
      }
      if (use_ok) {
        const unsigned long long policy = l2_policy(keep & 1u);
#pragma unroll
        for (int q = 0; q < kWeightStage; ++q) {
          kp[q] = take_one(ok, n_ok, kp[q] ? e[q] : -1, static_cast<unsigned char>(0), policy) != 0;
        }
      }
      if (in_mask) {
        const unsigned long long policy = l2_policy(keep & 2u);
#pragma unroll
        for (int q = 0; q < kWeightStage; ++q) {
          kp[q] = take_one(emask, n_em, kp[q] ? id[q] : -1, static_cast<unsigned char>(0), policy) != 0;
        }
      }
      T v[kWeightStage];
      if (wt != nullptr) {
        const unsigned long long policy = l2_policy(keep & 4u);
#pragma unroll
        for (int q = 0; q < kWeightStage; ++q) v[q] = take_one(wt, n_w, kp[q] ? e[q] : -1, T(0), policy);
      } else {
#pragma unroll
        for (int q = 0; q < kWeightStage; ++q) v[q] = kp[q] ? T(1) : T(0);
      }
#pragma unroll
      for (int q = 0; q < kWeightStage; ++q) {
        const int k = tid + (run + q) * kThreads;
        if (k < nj) s_val[k] = lb_bits(v[q]);
      }
    }
  }
  __device__ void store(long long h, long long i, T v) const { add(h, i, v); }
  __device__ void add(long long h, long long i, T v) const {
    const long long g = row0 + h * r + i;
    if (g < vb) out[g] += v;
  }
};

// K24: rowshard_hop (replaces the hop of sharded.build_bfs_step,
// orientdb_tpu/parallel/sharded.py:202-257). Row-sharded multi-source BFS:
// shard s holds rows [s R, (s+1) R) of the out-CSR (rebased indptr [S_l,
// R+1], dst [S_l, e_max]) and its [Q, R] slice of the frontier; an edge of a
// lit row r reaching d sets out[d / R, q, d % R] for every query q lit at r
// (out is [S, Q, R], shard-major, so a process group's reduce-scatter hands
// each rank its own slice). Edges past indptr[R] or with d < 0 are the
// reference's dead padding (edge_live); d clips to [0, S R - 1] as dst_c
// does.
// Bound: the frontier read once and out written once (2 S_l Q R bytes with
// S_l = S), 8 bytes of indptr a lit row, 4 of dst a lit row's edge. At
// MBFS's first hop ([4, 4, 2^21], 4 lit rows) ~0.019 ms.
// Design: a coalesced push. A warp takes a run of 512 consecutive rows of
// one shard (16 a lane) and reads each query's bytes of them with one
// 16-byte load a lane (a warp's load of one query is 512 contiguous bytes;
// a guarded byte loop where R is not a multiple of 16, so a run never
// reads past its shard's slice), folding them into a 32-bit mask of lit
// queries a row (32 queries at a time when Q > 32). A ballot skips a run
// with no lit row, so a sparse hop costs its frontier read and the
// zeroing. Otherwise the warp lists its lit rows of nonzero span, 128 at a
// time (as K10's push does: their indptr spans, two warp scans, shared
// memory), and walks the flat span of their edges 32 slots a step, each
// lane finding its slot's row by a binary search of the prefixes: dst
// reads coalesce within a row at any density. Only a lit row reads its
// indptr pair. Stores are only 1s: no atomics.
// ---------------------------------------------------------------------------
constexpr int kRunRows = 16;  // rows a lane: one 16-byte load a query
constexpr long long kRunLen = 32LL * kRunRows;  // rows a warp run
constexpr int kRunChunk = kHopGroup / 32;  // rows a lane lists at a time

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rowshard_hop_kernel(const int* __restrict__ indptr, long long r, const int* __restrict__ dst,
                    long long emax, const unsigned char* __restrict__ frontier,
                    long long s_local, long long q, long long v_pad,
                    unsigned char* __restrict__ out) {
  __shared__ int s_base[kWarps][kHopGroup];
  __shared__ int s_pref[kWarps][kHopGroup];
  __shared__ unsigned s_rows[kWarps][kHopGroup];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long runs = (r + kRunLen - 1) / kRunLen;  // a shard's runs
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  const unsigned ur = static_cast<unsigned>(r);  // r <= v_pad < 2^31
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + w; g < s_local * runs;
       g += wstride) {
    const long long sl = g / runs;
    const long long row0 = (g - sl * runs) * kRunLen + static_cast<long long>(lane) * kRunRows;
    const unsigned char* fs = frontier + sl * q * r + row0;
    const int* ip = indptr + sl * (r + 1);
    const int* dl = dst + sl * emax;
    long long lim = -1;
    for (long long q0 = 0; q0 < q; q0 += 32) {
      const int nq = static_cast<int>(q - q0 < 32 ? q - q0 : 32);
      unsigned mk[kRunRows];
#pragma unroll
      for (int b = 0; b < kRunRows; ++b) mk[b] = 0u;
      if (row0 < r) {
        if (kVec) {
          // R % 16 == 0: the lane's 16 bytes of a query lie inside the row
          for (int k0 = 0; k0 < nq; k0 += 4) {
            uint4 x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              x[j] = k0 + j < nq ? __ldg(reinterpret_cast<const uint4*>(fs + (q0 + k0 + j) * r))
                                 : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (!any16(x[j])) continue;
              const unsigned wd[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
#pragma unroll
              for (int b = 0; b < kRunRows; ++b) {
                mk[b] |= static_cast<unsigned>(((wd[b >> 2] >> (8 * (b & 3))) & 0xffu) != 0u) << (k0 + j);
              }
            }
          }
        } else {
          for (int k = 0; k < nq; ++k) {
            const unsigned char* f = fs + (q0 + k) * r;
#pragma unroll
            for (int b = 0; b < kRunRows; ++b) {
              if (row0 + b < r && f[b] != 0) mk[b] |= 1u << k;
            }
          }
        }
      }
      unsigned lit = 0u;
#pragma unroll
      for (int b = 0; b < kRunRows; ++b) lit |= mk[b];
      if (!__any_sync(kFull, lit != 0u)) continue;
      if (lim < 0) {
        lim = __ldg(ip + r);
        if (lim > emax) lim = emax;
      }
#pragma unroll
      for (int c = 0; c < kRunRows / kRunChunk; ++c) {
        // the lane's lit rows of this chunk with a nonempty span
        int bs[kRunChunk], dg[kRunChunk];
        unsigned m[kRunChunk];
        int cnt = 0, dsum = 0;
#pragma unroll
        for (int k = 0; k < kRunChunk; ++k) {
          m[k] = mk[c * kRunChunk + k];
          bs[k] = dg[k] = 0;
          if (m[k] != 0u) {
            const long long row = row0 + c * kRunChunk + k;
            long long b = __ldg(ip + row), e = __ldg(ip + row + 1);
            if (b < 0) b = 0;
            if (e > lim) e = lim;
            if (e > b) {
              bs[k] = static_cast<int>(b);
              dg[k] = static_cast<int>(e - b);
              ++cnt;
              dsum += dg[k];
            } else {
              m[k] = 0u;
            }
          }
        }
        if (!__any_sync(kFull, cnt != 0)) continue;
        int ic = cnt, id = dsum;  // inclusive warp scans
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int tc = __shfl_up_sync(kFull, ic, o);
          const int td = __shfl_up_sync(kFull, id, o);
          if (lane >= o) {
            ic += tc;
            id += td;
          }
        }
        const int na = __shfl_sync(kFull, ic, 31);
        const int total = __shfl_sync(kFull, id, 31);
        int pos = ic - cnt, off = id - dsum;
#pragma unroll
        for (int k = 0; k < kRunChunk; ++k) {
          if (m[k] != 0u) {
            s_base[w][pos] = bs[k];
            s_pref[w][pos] = off;
            s_rows[w][pos] = m[k];
            ++pos;
            off += dg[k];
          }
        }
        __syncwarp();
        for (int p = lane; p < total; p += 32) {
          int a = 0, z = na - 1;  // the last entry whose prefix is <= p
          while (a < z) {
            const int mid = (a + z + 1) >> 1;
            if (s_pref[w][mid] <= p) a = mid; else z = mid - 1;
          }
          long long d = __ldg(dl + s_base[w][a] + (p - s_pref[w][a]));
          if (d < 0) continue;
          if (d > v_pad - 1) d = v_pad - 1;
          const unsigned t = static_cast<unsigned>(d) / ur;
          const long long col = d - static_cast<long long>(t) * r;
          unsigned bits = s_rows[w][a];
          while (bits != 0u) {
            const int k = __ffs(bits) - 1;
            bits &= bits - 1u;
            out[(static_cast<long long>(t) * q + q0 + k) * r + col] = 1;
          }
        }
        __syncwarp();
      }
    }
  }
}

template <typename T>
int launch_segment_sum(const void* vals, long long ne, const void* indptr, long long nseg,
                       long long out_size, void* out, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_size <= 0) return static_cast<int>(cudaGetLastError());
  // the host sizes the grid by nseg + ne; the merged sequence is nseg + nv
  // long (nv <= ne, read on the device), and tiles past it are empty
  const long long tiles = nseg > 0 ? (nseg + ne + kSegTile - 1) / kSegTile : 0;
  int* rowc = static_cast<int*>(scratch);
  T* carry = reinterpret_cast<T*>(rowc + tiles + 1);
  const long long npad = out_size - nseg;
  const long long work = 32 * (tiles + 1) > npad / 4 ? 32 * (tiles + 1) : npad / 4;
  const int* ip = static_cast<const int*>(indptr);
  seg_partition_kernel<<<grid_for(work, 1), kThreads, 0, s>>>(ip, 0, 1, ne, nseg, tiles, rowc,
                                                             static_cast<unsigned*>(out), out_size, 1);
  if (tiles > 0) {
    const SegValues<T> src{static_cast<const T*>(vals), ip, static_cast<T*>(out)};
    seg_sum_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(src, ne, nseg, tiles,
                                                                        rowc, carry);
    seg_fixup_kernel<T><<<grid_for(tiles, 1), kThreads, 0, s>>>(src, rowc, carry, tiles, 1, nseg,
                                                                tiles + 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's lane form: the partition once, the lanes' tile passes, the lanes'
// carries; `scratch` holds csr_segment_lanes_scratch words.
template <typename T>
int launch_segment_sum_lanes(const void* vals, long long ne, long long lanes, const void* indptr,
                             long long nseg, long long out_size, void* out, void* scratch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_size <= 0 || lanes <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = nseg > 0 ? (nseg + ne + kSegTile - 1) / kSegTile : 0;
  int* rowc = static_cast<int*>(scratch);
  T* carry = reinterpret_cast<T*>(rowc + tiles + 1);
  const long long npad = out_size - nseg;
  const long long work = 32 * (tiles + 1) > npad / 4 ? 32 * (tiles + 1) : npad / 4;
  const int* ip = static_cast<const int*>(indptr);
  seg_partition_kernel<<<grid_for(work, 1), kThreads, 0, s>>>(ip, 0, 1, ne, nseg, tiles, rowc,
                                                             static_cast<unsigned*>(out), out_size, lanes);
  if (tiles > 0) {
    const SegLanes<T> src{static_cast<const T*>(vals), ne, ip, static_cast<T*>(out), out_size};
    seg_sum_lanes_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(src, lanes, nseg, tiles,
                                                                              rowc, carry);
    seg_fixup_kernel<T><<<grid_for(lanes * tiles, 1), kThreads, 0, s>>>(src, rowc, carry, tiles, lanes,
                                                                        nseg, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// K23's scratch: each path's tile coordinates (tiles + 1) and carries,
// the fold's decision, then (16-byte aligned) the folded weights.
template <typename T>
struct ShardScratch {
  long long tiles;
  int* rowc;
  T* carry;
  int* decide;
  T* folded;
};

inline long long shard_tiles(long long r, long long emax) {
  return r > 0 ? (r + emax + kSegTile - 1) / kSegTile : 0;
}

inline long long shard_scratch_words(long long s_local, long long r, long long emax) {
  return (s_local * (2 * shard_tiles(r, emax) + 1) + 4 + 3) / 4 * 4;  // the decision word, aligned
}

template <typename T>
ShardScratch<T> shard_scratch(void* scratch, long long s_local, long long r, long long emax) {
  ShardScratch<T> sc;
  sc.tiles = shard_tiles(r, emax);
  sc.rowc = static_cast<int*>(scratch);
  sc.carry = reinterpret_cast<T*>(sc.rowc + s_local * (sc.tiles + 1));
  const long long head = shard_scratch_words(s_local, r, emax);
  sc.decide = sc.rowc + head - 4;
  sc.folded = reinterpret_cast<T*>(sc.rowc + head);
  return sc;
}

// K23 over the held shards (see ShardWeights): `scratch` holds
// csr_shard_weight_scratch words.
template <typename T>
int launch_shard_weight_pass(const void* ind, long long r, long long s_local, long long s0,
                             const void* nbr, long long emax, const void* extra, int is_out,
                             const void* emask, long long n_em, const void* ok, long long n_ok,
                             const void* w, long long n_w, int keep, int fold, long long vb,
                             void* out, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_local <= 0 || r <= 0 || vb <= 0) return static_cast<int>(cudaGetLastError());
  const ShardScratch<T> sc = shard_scratch<T>(scratch, s_local, r, emax);
  const int* ip = static_cast<const int*>(ind);
  seg_partition_kernel<<<grid_for(32 * s_local * (sc.tiles + 1), 1), kThreads, 0, s>>>(
      ip, r + 1, s_local, emax, r, sc.tiles, sc.rowc, nullptr, 0, 0);
  const bool folds = fold != kFoldNone && ok != nullptr && w != nullptr && n_w > 0 && n_ok == n_w;
  if (folds) {
    shard_fold_kernel<T><<<grid_for(n_w, 1), kThreads, 0, s>>>(
        static_cast<const unsigned char*>(ok), static_cast<const T*>(w), n_w, fold, sc.decide, sc.folded);
  }
  const ShardWeights<T> src{ip, r, static_cast<const int*>(nbr), emax, static_cast<const int*>(extra),
                            is_out, static_cast<const unsigned char*>(emask), n_em,
                            static_cast<const unsigned char*>(ok), n_ok, static_cast<const T*>(w), n_w,
                            static_cast<unsigned>(keep), folds ? sc.decide : nullptr, sc.folded,
                            static_cast<T*>(out), s0 * r, vb};
  seg_sum_kernel<T><<<static_cast<unsigned>(s_local * sc.tiles), kThreads, 0, s>>>(
      src, emax, r, sc.tiles, sc.rowc, sc.carry);
  seg_fixup_kernel<T><<<grid_for(s_local * sc.tiles, 1), kThreads, 0, s>>>(src, sc.rowc, sc.carry,
                                                                           sc.tiles, s_local, r,
                                                                           sc.tiles + 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_take_pad(const void* vals, long long n, const void* idx, long long m, T fill, int keep, void* out,
                    void* stream, long long lane_m = 0, long long stride = 0) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const TakeTable<T> v{static_cast<const T*>(vals), lane_m, stride};
    const int* i = static_cast<const int*>(idx);
    T* d = static_cast<T*>(out);
    if constexpr (sizeof(T) == 4) {
      if (((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0) {
        constexpr long long kUnits = kTakeRun / 4;
        const long long nv = m / 4;
        const long long threads = (nv + 32 * kUnits - 1) / (32 * kUnits) * 32 + (m - 4 * nv);
        take_pad_kernel<T, true><<<blocks_for(threads, kThreads), kThreads, 0, s>>>(v, n, i, m, fill, keep != 0, d);
        return static_cast<int>(cudaGetLastError());
      }
    }
    const long long run = 32LL * kTakeRun;
    const long long threads = (m + run - 1) / run * 32;
    take_pad_kernel<T, false><<<blocks_for(threads, kThreads), kThreads, 0, s>>>(v, n, i, m, fill, keep != 0, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_weight_gather(const void* emit, long long m, const void* ok, long long n_ok,
                         const void* node_ok, const void* emask, long long n_em, const void* eid,
                         const void* w, long long n_w, int keep, void* out, void* stream) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const WeightArgs a = {static_cast<const int*>(emit), m, static_cast<const unsigned char*>(ok), n_ok,
                          static_cast<const unsigned char*>(node_ok), static_cast<const unsigned char*>(emask),
                          n_em, static_cast<const int*>(eid), w, n_w, static_cast<unsigned>(keep)};
    // the output is a fresh allocation (aligned): the vector body runs
    // where every stream starts aligned with it
    auto at = [](const void* p, uintptr_t width) {
      return p == nullptr || (reinterpret_cast<uintptr_t>(p) % width) == 0;
    };
    const bool vec = at(out, 16) && at(emit, 16) && at(eid, 16) && at(node_ok, 4) && (eid != nullptr || at(emask, 4));
    T* d = static_cast<T*>(out);
    if (vec) {
      const long long nv = m / 4;
      const long long threads = (nv + 63) / 64 * 32 + (m - 4 * nv);
      weight_gather_kernel<T, true><<<blocks_for(threads, kThreads), kThreads, 0, s>>>(a, d);
    } else {
      const long long threads = (m + 32LL * kWeightRun - 1) / (32LL * kWeightRun) * 32;
      weight_gather_kernel<T, false><<<blocks_for(threads, kThreads), kThreads, 0, s>>>(a, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K5b over `lanes` rows of n bytes each (a row a lane, stride n): one
// block a row that stores its count up to kCountTile, else a one-wave grid
// of blocks a row, after a memset of the counts, with an atomic a block.
int launch_mask_count(const void* mask, long long n, long long lanes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned char* p = static_cast<const unsigned char*>(mask);
  unsigned* count = static_cast<unsigned*>(out);
  if (n <= kCountTile) {
    mask_count_kernel<<<dim3(1, static_cast<unsigned>(lanes)), kThreads, 0, s>>>(p, n, n, count, 1);
    return static_cast<int>(cudaGetLastError());
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0) {
      sms = 132;
    }
  }
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned) * lanes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (n / 16 + kThreads * kCountLoads - 1) / (kThreads * kCountLoads);
  long long wave = static_cast<long long>(sms) * kCountBlocksPerSm / lanes;
  if (wave < 1) wave = 1;
  if (blocks > wave) blocks = wave;
  mask_count_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
      p, n, n, count, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_weight_gather_lanes(const void* emit, long long m, const void* ok, long long n_ok,
                               long long ok_stride, const void* node_ok, long long node_stride,
                               const void* emask, long long n_em, long long em_stride, const void* eid,
                               const void* w, long long n_w, long long w_stride, long long lanes,
                               int keep, void* out, void* stream) {
  if (m > 0 && lanes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const WeightLaneArgs a = {static_cast<const int*>(emit), m,
                              static_cast<const unsigned char*>(ok), n_ok, ok_stride,
                              static_cast<const unsigned char*>(node_ok), node_stride,
                              static_cast<const unsigned char*>(emask), n_em, em_stride,
                              static_cast<const int*>(eid), w, n_w, w_stride, lanes,
                              static_cast<unsigned>(keep)};
    const long long threads = (m + 32LL * kWeightRun - 1) / (32LL * kWeightRun) * 32;
    weight_gather_lanes_kernel<T><<<blocks_for(threads, kThreads), kThreads, 0, s>>>(a, static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of look-back state that K1 (csr_scan_*) and K3 (csr_compact)
// need for n elements: the tile counter, then one word a tile.
long long csr_scan_scratch(long long n) {
  return lb_state_bytes(n > 0 ? (n + kScanTile - 1) / kScanTile : 0);
}

long long csr_compact_scratch(long long n) {
  return lb_state_bytes(n > 0 ? (n + kCompactTile - 1) / kCompactTile : 0);
}

// K1 over int32 (as uint32) or float32. `out` (null: no output, the total
// alone) and `total` (null: none) are optional.
int csr_scan_i32(const void* in, void* out, void* total, long long n, void* state,
                 int exclusive, void* stream) {
  return static_cast<int>(scan_lookback<unsigned>(
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out),
      static_cast<unsigned*>(total), n, static_cast<unsigned long long*>(state), exclusive,
      static_cast<cudaStream_t>(stream)));
}

int csr_scan_f32(const void* in, void* out, void* total, long long n, void* state,
                 int exclusive, void* stream) {
  return static_cast<int>(scan_lookback<float>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<float*>(total), n,
      static_cast<unsigned long long*>(state), exclusive, static_cast<cudaStream_t>(stream)));
}

// K1's lane form: `lanes` rows of n values (lane-major) scanned a row each,
// one memset of `lanes` look-back states (csr_scan_scratch(n) bytes a lane)
// and one launch; `total` (optional) takes a sum a lane.
int csr_scan_lanes_i32(const void* in, void* out, void* total, long long n, long long lanes, void* state,
                       int exclusive, void* stream) {
  return static_cast<int>(scan_lookback<unsigned>(
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out), static_cast<unsigned*>(total), n,
      static_cast<unsigned long long*>(state), exclusive, static_cast<cudaStream_t>(stream), lanes));
}

int csr_degree_counts(const void* indptr, long long nv, const void* srcs,
                      long long k, void* out, void* stream) {
  if (k > 0) {
    degree_counts_kernel<<<blocks_for(k, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), nv, static_cast<const int*>(srcs), k,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K2's look-back state for k sources, in bytes.
long long csr_degree_scan_scratch(long long k) {
  return lb_state_bytes(k > 0 ? (k + kDegTile - 1) / kDegTile : 0);
}

// K2: lane y's k sources of [lanes, k] into the exclusive offsets of their
// degrees and their total (of [lanes], device int32s), one memset of every
// lane's state (csr_degree_scan_scratch(k) bytes a lane) and one launch; a
// single call is one lane.
int csr_degree_scan_lanes_i32(const void* indptr, long long nv, const void* srcs, long long k,
                              long long lanes, void* offsets, void* total, void* state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0) return static_cast<int>(cudaMemsetAsync(total, 0, lanes * sizeof(int), s));
  const long long tiles = (k + kDegTile - 1) / kDegTile;
  cudaError_t e = cudaMemsetAsync(state, 0xff, lanes * lb_state_bytes(tiles), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_ok = aligned16(srcs) && aligned16(offsets) && (lanes == 1 || k % 4 == 0);
  degree_scan_kernel<CsrSpan><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
      CsrSpan{static_cast<const unsigned*>(indptr), nv}, static_cast<const int*>(srcs), k,
      static_cast<unsigned*>(offsets), static_cast<unsigned*>(total),
      static_cast<unsigned long long*>(state), vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// K2b: lane y's k sources and offsets of [lanes, k] and its total into row
// y of the [lanes, out_size] outputs (a single call is one lane); the CSR
// and `edge_map` are shared. `edge_map` (nm entries) is optional: null
// writes the edge position.
int csr_gather_expand_lanes(const void* indptr, long long nv, const void* nbrs, long long ne,
                            const void* srcs, const void* offsets, long long k, long long lanes,
                            const void* total, long long out_size, const void* edge_map, long long nm,
                            void* row_out, void* pos_out, void* nbr_out, void* stream) {
  if (out_size > 0 && lanes > 0) {
    const int vec = aligned16(row_out) && aligned16(pos_out) && aligned16(nbr_out) && (lanes == 1 || out_size % 4 == 0);
    const CsrGather g{static_cast<const int*>(indptr), nv, static_cast<const int*>(nbrs), ne,
                      static_cast<const int*>(edge_map), nm};
    gather_expand_kernel<CsrGather>
        <<<dim3(blocks_for(k + out_size, kExpandTile), static_cast<unsigned>(lanes)), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            g, static_cast<const int*>(srcs), static_cast<const int*>(offsets), k,
            static_cast<const int*>(total), out_size, static_cast<int*>(row_out),
            static_cast<int*>(pos_out), static_cast<int*>(nbr_out), vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: lane y of a [lanes, n] mask into row y of the [lanes, out_size]
// output (a single call is one lane). The fill form (`fill` 1) needs the
// lanes' states (csr_compact_scratch(n) bytes a lane) right behind the
// lanes * out_size slots in one allocation: one memset of 0xFF bytes covers
// all of them.
int csr_compact_lanes(const void* mask, long long n, long long lanes, long long out_size, void* out,
                      void* state, int fill, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = n > 0 ? (n + kCompactTile - 1) / kCompactTile : 0;
  char* lo = static_cast<char*>(fill ? out : state);
  char* hi = static_cast<char*>(state) + lanes * lb_state_bytes(tiles);
  if (fill && static_cast<char*>(state) < static_cast<char*>(out) + 4 * lanes * out_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaMemsetAsync(lo, 0xff, hi - lo, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0 && out_size > 0) {
    const int vec_ok = reinterpret_cast<uintptr_t>(mask) % 16 == 0 && (lanes == 1 || n % 16 == 0);
    compact_lookback_kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
        static_cast<const unsigned char*>(mask), n, out_size, static_cast<int*>(out),
        static_cast<unsigned long long*>(state), vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's scratch, in int32 words: the tile coordinates (tiles + 1) and the
// tiles' carries.
long long csr_segment_scratch(long long nseg, long long ne) {
  const long long tiles = nseg > 0 ? (nseg + ne + kSegTile - 1) / kSegTile : 0;
  return 2 * tiles + 1;
}

int csr_segment_sum_i32(const void* vals, long long ne, const void* indptr, long long nseg,
                        long long out_size, void* out, void* scratch, void* stream) {
  return launch_segment_sum<unsigned>(vals, ne, indptr, nseg, out_size, out, scratch, stream);
}

int csr_segment_sum_f32(const void* vals, long long ne, const void* indptr, long long nseg,
                        long long out_size, void* out, void* scratch, void* stream) {
  return launch_segment_sum<float>(vals, ne, indptr, nseg, out_size, out, scratch, stream);
}

// K4's lane form's scratch, in int32 words: the tile coordinates (tiles +
// 1) and each lane's carries.
long long csr_segment_lanes_scratch(long long nseg, long long ne, long long lanes) {
  const long long tiles = nseg > 0 ? (nseg + ne + kSegTile - 1) / kSegTile : 0;
  return tiles + 1 + lanes * tiles;
}

int csr_segment_sum_lanes_i32(const void* vals, long long ne, long long lanes, const void* indptr,
                              long long nseg, long long out_size, void* out, void* scratch,
                              void* stream) {
  return launch_segment_sum_lanes<unsigned>(vals, ne, lanes, indptr, nseg, out_size, out, scratch, stream);
}

int csr_segment_sum_lanes_f32(const void* vals, long long ne, long long lanes, const void* indptr,
                              long long nseg, long long out_size, void* out, void* scratch,
                              void* stream) {
  return launch_segment_sum_lanes<float>(vals, ne, lanes, indptr, nseg, out_size, out, scratch, stream);
}

// K5a. `keep` (non-zero: gather the table under L2 evict_last; for
// weight_gather a set of bits, 1 ok, 2 emask, 4 w) is the caller's choice
// of the tables that fit L2; `out` is a fresh allocation.
// The lane stride (`lane_m` > 0): the m indices are a [m / lane_m, lane_m]
// stack of lane-local rows, and index j reads the n-value table at vals +
// (j / lane_m) * stride (a lane-stacked table of stride values a lane);
// lane_m 0 reads the one table.
int csr_take_pad_i32(const void* vals, long long n, const void* idx, long long m,
                     int fill, int keep, void* out, long long lane_m, long long stride, void* stream) {
  return launch_take_pad<int>(vals, n, idx, m, fill, keep, out, stream, lane_m, stride);
}

int csr_take_pad_f32(const void* vals, long long n, const void* idx, long long m,
                     float fill, int keep, void* out, long long lane_m, long long stride, void* stream) {
  return launch_take_pad<float>(vals, n, idx, m, fill, keep, out, stream, lane_m, stride);
}

int csr_take_pad_b8(const void* vals, long long n, const void* idx, long long m,
                    int fill, int keep, void* out, long long lane_m, long long stride, void* stream) {
  return launch_take_pad<unsigned char>(vals, n, idx, m, static_cast<unsigned char>(fill != 0), keep, out,
                                        stream, lane_m, stride);
}

int csr_weight_gather_i32(const void* emit, long long m, const void* ok, long long n_ok,
                          const void* node_ok, const void* emask, long long n_em, const void* eid,
                          const void* w, long long n_w, int keep, void* out, void* stream) {
  return launch_weight_gather<int>(emit, m, ok, n_ok, node_ok, emask, n_em, eid, w, n_w, keep, out, stream);
}

int csr_weight_gather_f32(const void* emit, long long m, const void* ok, long long n_ok,
                          const void* node_ok, const void* emask, long long n_em, const void* eid,
                          const void* w, long long n_w, int keep, void* out, void* stream) {
  return launch_weight_gather<float>(emit, m, ok, n_ok, node_ok, emask, n_em, eid, w, n_w, keep, out, stream);
}

// K5a's lane form: strides 0 mark the shared operands; `out` is [lanes, m].
int csr_weight_gather_lanes_i32(const void* emit, long long m, const void* ok, long long n_ok,
                                long long ok_stride, const void* node_ok, long long node_stride,
                                const void* emask, long long n_em, long long em_stride, const void* eid,
                                const void* w, long long n_w, long long w_stride, long long lanes,
                                int keep, void* out, void* stream) {
  return launch_weight_gather_lanes<int>(emit, m, ok, n_ok, ok_stride, node_ok, node_stride, emask, n_em,
                                         em_stride, eid, w, n_w, w_stride, lanes, keep, out, stream);
}

int csr_weight_gather_lanes_f32(const void* emit, long long m, const void* ok, long long n_ok,
                                long long ok_stride, const void* node_ok, long long node_stride,
                                const void* emask, long long n_em, long long em_stride, const void* eid,
                                const void* w, long long n_w, long long w_stride, long long lanes,
                                int keep, void* out, void* stream) {
  return launch_weight_gather_lanes<float>(emit, m, ok, n_ok, ok_stride, node_ok, node_stride, emask, n_em,
                                           em_stride, eid, w, n_w, w_stride, lanes, keep, out, stream);
}

int csr_mask_count(const void* mask, long long n, void* out, void* stream) {
  return launch_mask_count(mask, n, 1, out, stream);
}

// K5b's lane form: `lanes` rows of n bytes into `lanes` int32 counts.
int csr_mask_count_lanes(const void* mask, long long n, long long lanes, void* out, void* stream) {
  return launch_mask_count(mask, n, lanes, out, stream);
}

// `col_ptrs` is a HOST array of `ncols` (<= kMaxCols) device pointers; the
// columns land at [col0, col0 + ncols) of each output row of `stride` ints.
// K6 (under the group replay's vmap too): `lanes` rows of w valid flags,
// ranks (K1) and column values (each column a [lanes, w] stack), lane y's
// page at out + y * out_lane; a single call is one lane.
int csr_front_pack_lanes(const void* valid, const void* ranks, long long w, long long lanes,
                         const void* col_ptrs, int ncols, int col0, int stride,
                         void* out, long long out_lane, void* stream) {
  if (ncols < 0 || ncols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  ColPtrs cols = {};
  const void* const* ptrs = static_cast<const void* const*>(col_ptrs);
  for (int c = 0; c < ncols; ++c) cols.p[c] = static_cast<const int*>(ptrs[c]);
  if (w > 0 && ncols > 0 && lanes > 0) {
    front_pack_kernel<<<dim3(blocks_for(w, kThreads), static_cast<unsigned>(lanes)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(valid), static_cast<const int*>(ranks), w, cols,
        ncols, col0, stride, static_cast<int*>(out), out_lane);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: a block a lane, lane b's page at data + b * data_lane, its count and
// flag at count[b], overflow[b], its row at out + b * out_lane; a single
// call is one lane.
int csr_replay_meta_lanes(const void* data, long long w, int ncols, long long lanes, long long data_lane,
                          const void* count, const void* overflow, void* out, long long out_lane,
                          void* stream) {
  if (lanes > 0) {
    replay_meta_kernel<<<static_cast<unsigned>(lanes), kMetaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(data), w, ncols, static_cast<const int*>(count),
        static_cast<const int*>(overflow), static_cast<int*>(out), data_lane, out_lane);
  }
  return static_cast<int>(cudaGetLastError());
}
int csr_narrow_i16(const void* in, long long n, void* out, void* stream) {
  if (n > 0) {
    narrow_i16_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(in), n, static_cast<short*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_rows_to_bitmap(const void* rows, long long c, long long vb, void* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c * vb > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(c * vb), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    rows_to_bitmap_kernel<<<blocks_for(c, kThreads), kThreads, 0, s>>>(
        static_cast<const int*>(rows), c, vb, static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// `emask`, `gate` and `alive` may be null (every edge / no WHILE gate / no
// early exit). With `zero_out` the entry point clears `out` first; without,
// the hop ORs into it (the second direction of a `both` arm, or another
// edge class).
int csr_bitmap_hop(const void* act, const void* emit, const void* emask,
                   long long ne, const void* frontier, const void* gate,
                   long long c, long long vb, const void* alive, int zero_out,
                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_out && c * vb > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(c * vb), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (ne > 0 && c > 0 && vb > 0) {
    bitmap_hop_kernel<<<grid_for(ne, 1), kThreads, 0, s>>>(
        static_cast<const int*>(act), static_cast<const int*>(emit),
        static_cast<const unsigned char*>(emask), ne,
        static_cast<const unsigned char*>(frontier),
        static_cast<const unsigned char*>(gate), c, vb,
        static_cast<const int*>(alive), static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K10's CSR form. `indptr` has nv + 1 entries (nv <= vb); `eid`, `emask`
// (ne entries, indexed by eid when given, else by slot), `gate` and `alive`
// may be null; `zero_out` as for csr_bitmap_hop. The lane form: `lanes` > 1
// lanes of `c` rows each (the frontier and `out` hold lanes * c rows),
// `alive` one count a lane, `gate` one row a lane when `gate_lanes` is set
// (else shared); the single form is lanes = 1.
int csr_bitmap_hop_csr(const void* indptr, long long nv, const void* nbr, const void* eid,
                       const void* emask, long long ne, const void* frontier, const void* gate,
                       long long c, long long vb, const void* alive, int zero_out, void* out,
                       long long lanes, int gate_lanes, void* stream) {
  const CsrRows rows{static_cast<const int*>(indptr), static_cast<const int*>(eid), 0,
                     nv < vb ? nv : vb};
  if (lanes == 1) {
    return launch_push(rows, nbr, emask, ne, frontier, gate, c, vb, alive, zero_out, out, stream);
  }
  return launch_push<CsrRows, NoProbe, true>(rows, nbr, emask, ne, frontier, gate, c, vb, alive,
                                             zero_out, out, stream, NoProbe{}, lanes,
                                             gate_lanes ? vb : 0);
}

// K10's CSR form with the slab probe: `tab` ([nb * bk] int32, nb a power
// of two) holds relative slots of the slab that starts at edge slot `base`;
// `own`, `snbr` and `live` have `ecap` entries, one an edge slot (the
// endpoint that must be active, the one reached, liveness). The rest as
// for csr_bitmap_hop_csr's single form.
int csr_bitmap_hop_probe(const void* indptr, long long nv, const void* nbr, const void* eid,
                         const void* emask, long long ne, const void* tab, const void* own,
                         const void* snbr, const void* live, long long base, long long ecap, int nb,
                         int bk, const void* frontier, const void* gate, long long c, long long vb,
                         const void* alive, int zero_out, void* out, void* stream) {
  const CsrRows rows{static_cast<const int*>(indptr), static_cast<const int*>(eid), 0,
                     nv < vb ? nv : vb};
  const SlabProbe probe{static_cast<const int*>(tab), static_cast<const int*>(own),
                        static_cast<const int*>(snbr), static_cast<const unsigned char*>(live),
                        base, ecap, nb, bk};
  return launch_push(rows, nbr, emask, ne, frontier, gate, c, vb, alive, zero_out, out, stream, probe);
}

// `bound`, `emit`, `any` and `count` may be null. `any` ([lanes * c] bytes)
// and `count` (one int32 a lane) are zeroed here before the pass. The lane
// form: `lanes` > 1 lanes of `c` rows each, `node` one row a lane when
// `node_lanes` is set (else shared); the single form is lanes = 1.
int csr_bitmap_emit(const void* reached, const void* node, const void* bound,
                    long long c, long long vb, void* emit, void* any, void* count,
                    long long lanes, int node_lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (lanes <= 0 || lanes > 65535) return lanes == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (any != nullptr && c > 0) {
    e = cudaMemsetAsync(any, 0, static_cast<size_t>(lanes * c), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (count != nullptr) {
    e = cudaMemsetAsync(count, 0, static_cast<size_t>(lanes) * sizeof(unsigned), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n = c * vb;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned char* r = static_cast<const unsigned char*>(reached);
  const unsigned char* nd = static_cast<const unsigned char*>(node);
  const int* b = static_cast<const int*>(bound);
  unsigned char* em = static_cast<unsigned char*>(emit);
  unsigned char* an = static_cast<unsigned char*>(any);
  unsigned* cn = static_cast<unsigned*>(count);
  const long long ns = node_lanes ? vb : 0;
  const bool many = lanes > 1;  // the single form: no lane arithmetic
  const unsigned gy = static_cast<unsigned>(lanes);
  if (b != nullptr && em == nullptr) {
    auto kernel = many ? bitmap_emit_bound_kernel<true> : bitmap_emit_bound_kernel<false>;
    kernel<<<dim3(blocks_for(c, kThreads), gy), kThreads, 0, s>>>(r, nd, b, c, vb, an, cn, ns);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = vb % 16 == 0 && aligned16(reached) && aligned16(node) &&
                   (emit == nullptr || aligned16(emit));
  auto kernel = vec ? (many ? bitmap_emit_kernel<true, true> : bitmap_emit_kernel<true, false>)
                    : (many ? bitmap_emit_kernel<false, true> : bitmap_emit_kernel<false, false>);
  kernel<<<dim3(grid_for(n, (vec ? 16 : 1) * kInFlight), gy), kThreads, 0, s>>>(r, nd, b, c, vb, em, an,
                                                                                cn, ns);
  return static_cast<int>(cudaGetLastError());
}

// Both bitmaps hold `n` bytes a lane (rows of `vb`); `gate` and `node`
// (null: none) hold `vb` (a row a lane with `gate_lanes` / `node_lanes`),
// `bound` (null: none; only with `node`) n / vb int32 a lane; `count` and
// `emitted` (one int32 a lane each; `emitted` only with `node`) are zeroed
// here. The single form is lanes = 1.
int csr_frontier_advance(void* nxt, void* visited, const void* gate, const void* node,
                         const void* bound, long long n, long long vb, void* count,
                         void* emitted, long long lanes, int gate_lanes, int node_lanes,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || lanes > 65535) return lanes == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(count, 0, static_cast<size_t>(lanes) * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (emitted != nullptr) {
    e = cudaMemsetAsync(emitted, 0, static_cast<size_t>(lanes) * sizeof(unsigned), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  unsigned char* x = static_cast<unsigned char*>(nxt);
  unsigned char* v = static_cast<unsigned char*>(visited);
  const unsigned char* a = static_cast<const unsigned char*>(gate);
  const unsigned char* nd = static_cast<const unsigned char*>(node);
  const int* b = static_cast<const int*>(bound);
  unsigned* cn = static_cast<unsigned*>(count);
  unsigned* en = static_cast<unsigned*>(emitted);
  const long long gs = gate_lanes ? vb : 0, ns = node_lanes ? vb : 0;
  const bool many = lanes > 1;  // the single form: no lane arithmetic
  const bool vec = n % 16 == 0 && aligned16(nxt) && aligned16(visited) &&
                   (gate == nullptr || (vb % 16 == 0 && aligned16(gate))) &&
                   (node == nullptr || (vb % 16 == 0 && aligned16(node)));
  auto kernel = vec ? (many ? frontier_advance_kernel<true, true> : frontier_advance_kernel<true, false>)
                    : (many ? frontier_advance_kernel<false, true> : frontier_advance_kernel<false, false>);
  kernel<<<dim3(grid_for(n, (vec ? 16 : 1) * kInFlight), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
      x, v, a, nd, b, n, vb, cn, en, gs, ns);
  return static_cast<int>(cudaGetLastError());
}

// `rows` and `mask` hold `lanes` rows of `w` slots, `out` `lanes` rows of
// `nseg` int32 counts; zeroed here first when `zero` is set, else the
// counts add into it. The single form is one lane.
int csr_rows_with_matches_lanes(const void* rows, const void* mask, long long w, long long lanes,
                                long long nseg, int zero, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 0 || lanes > 65535) return lanes == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (zero && nseg > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, lanes * nseg * sizeof(unsigned), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (w > 0 && nseg > 0) {
    rows_with_matches_kernel<<<dim3(grid_for(w, 1), static_cast<unsigned>(lanes)), kThreads, 0, s>>>(
        static_cast<const int*>(rows), static_cast<const unsigned char*>(mask), w, nseg,
        static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// `in` is an int32 [*, w, ncols] stack; `out` receives lanes [0, b) and rows
// [0, n) of it as a contiguous [b, n, ncols] page, int16 when `narrow` is set.
int csr_group_page(const void* in, long long w, int ncols, long long b, long long n,
                   int narrow, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long run = n * ncols;
  const long long src_run = w * ncols;
  if (b <= 0 || run <= 0) return static_cast<int>(cudaGetLastError());
  const int* src = static_cast<const int*>(in);
  if (narrow) {
    launch_group_page<true>(src, src_run, b, run, out, s);
  } else {
    launch_group_page<false>(src, src_run, b, run, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// `args` is a PredArgs (the wrapper's ctypes twin); the kernel takes it by
// value, so a captured graph keeps this launch's pointers and scalars. The
// dynamic shared memory holds the program (when it fits in 48 KB) and
// the need - 1 stack entries below the top; the first call raises the
// kernel's limit to the most any program can ask (48 KB + kStack - 1
// entries). `lanes` rows of ids (the stacked form; the single form is one
// lane), each lane a grid row.
int csr_predicate_eval_stacked(const void* args, long long lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PredArgs& a = *static_cast<const PredArgs*>(args);
  if (a.n <= 0 || lanes == 0) return static_cast<int>(cudaGetLastError());
  if (a.need < 1 || a.need > kStack || lanes < 0 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_max = kProgSmem + (kStack - 1) * kPredEntryBytes;
  static const cudaError_t limit = [smem_max] {
    const cudaError_t one = cudaFuncSetAttribute(predicate_eval_kernel<false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    return one != cudaSuccess ? one
                              : cudaFuncSetAttribute(predicate_eval_kernel<true>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  }();
  if (limit != cudaSuccess) return static_cast<int>(limit);
  const long long bytes = a.len * static_cast<long long>(sizeof(int4));
  const int prog_smem = bytes <= kProgSmem ? static_cast<int>(bytes) : 0;
  const size_t smem = prog_smem + (a.need - 1) * kPredEntryBytes;
  // one lane (the single form) compiles no lane offset: lane 0's are zero
  if (lanes == 1) {
    predicate_eval_kernel<false><<<grid_for(a.n, kPredV), kThreads, smem, s>>>(a, prog_smem);
  } else {
    predicate_eval_kernel<true><<<dim3(grid_for(a.n, kPredV), static_cast<unsigned>(lanes)), kThreads, smem, s>>>(
        a, prog_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

// K15's lane form: `params` [lanes, nparams] (at most kPredLanes rows of
// kPredLaneParams), `out_p` [lanes, n]; dynamic shared memory holds the
// program (when everything fits), the stack below the top, the tile's
// cache of its `nloads` buffer loads and the parameter rows.
int csr_predicate_eval_lanes(const void* args, long long lanes, long long nparams, long long nloads,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PredArgs& a = *static_cast<const PredArgs*>(args);
  if (a.n <= 0 || lanes <= 0) return static_cast<int>(cudaGetLastError());
  if (a.need < 1 || a.need > kStack || lanes > kPredLanes || nparams < 1 || nparams > kPredLaneParams ||
      nloads < 0 || a.need - 1 + nloads > kPredLaneEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t limit = cudaFuncSetAttribute(
      predicate_eval_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPredLaneSmem);
  if (limit != cudaSuccess) return static_cast<int>(limit);
  const long long data = (a.need - 1 + nloads) * static_cast<long long>(kPredEntryBytes) +
                         lanes * nparams * static_cast<long long>(sizeof(int));
  const long long bytes = a.len * static_cast<long long>(sizeof(int4));
  const int prog_smem = bytes <= kProgSmem && bytes + data <= kPredLaneSmem ? static_cast<int>(bytes) : 0;
  predicate_eval_lanes_kernel<<<grid_for(a.n, kPredV), kThreads, prog_smem + data, s>>>(
      a, prog_smem, static_cast<int>(lanes), static_cast<int>(nparams), static_cast<int>(nloads));
  return static_cast<int>(cudaGetLastError());
}

// `arr` (`len` elements of `elem` bytes: 4 for int32 and float32, 1 for
// bool) receives vals[i] at idx[i] for i < n, in place.
int csr_scatter_set(void* arr, long long len, const void* idx, const void* vals, long long n,
                    int elem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (elem == 4) {
    scatter_set_kernel<unsigned><<<grid_for(n, 1), kThreads, 0, s>>>(
        static_cast<unsigned*>(arr), len, static_cast<const int*>(idx),
        static_cast<const unsigned*>(vals), n);
  } else if (elem == 1) {
    scatter_set_kernel<unsigned char><<<grid_for(n, 1), kThreads, 0, s>>>(
        static_cast<unsigned char*>(arr), len, static_cast<const int*>(idx),
        static_cast<const unsigned char*>(vals), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K17's scratch in bytes for a window of w slots and r rows (one memset
// of 0xFF in csr_slab_scan_hist empties all of it).
long long csr_slab_scan_scratch(long long w, long long r) { return sort_scratch_bytes(w, r); }

// The radix passes a call makes (csr_slab_scan_pass's `pass` runs over
// 0 .. this - 1).
int csr_slab_scan_passes() { return kSortPasses; }

// Step 1: empties the scratch, then counts the live slots' key digits and
// writes the sort's plan.
int csr_slab_scan_hist(const void* a, const void* live, long long w, long long r, void* scratch,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0xff, static_cast<size_t>(sort_scratch_bytes(w, r)), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned blocks = w > 0 ? blocks_for(w, kThreads) : 1;
  if (blocks > 2 * 132) blocks = 2 * 132;
  const SlabScratch sc = slab_scratch(scratch, w, r);
  slab_hist_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int*>(a),
                                               static_cast<const unsigned char*>(live), w,
                                               sc.hist, sc.plan);
  return static_cast<int>(cudaGetLastError());
}

// Step 2: radix pass `pass` over the (key, slot) buffers `pairs` ([4, w]
// int32: keys and slots of buffer 0, then of buffer 1).
int csr_slab_scan_pass(const void* a, const void* live, long long w, long long r, void* pairs,
                       void* scratch, int pass, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass < 0 || pass >= kSortPasses) return static_cast<int>(cudaErrorInvalidValue);
  const SlabScratch sc = slab_scratch(scratch, w, r);
  unsigned* k0 = static_cast<unsigned*>(pairs);
  const unsigned blocks = static_cast<unsigned>(w > 0 ? sort_tiles(w) : 1);
  auto kernel = pass == 0 ? slab_sort_pass_kernel<true> : slab_sort_pass_kernel<false>;
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int*>(a),
                                     static_cast<const unsigned char*>(live), w, k0, k0 + w,
                                     k0 + 2 * w, k0 + 3 * w, sc.plan, sc.pass[pass], pass);
  return static_cast<int>(cudaGetLastError());
}

// Step 3a: each row's run of its source in the sorted window (r > 0).
int csr_slab_scan_runs(const void* pairs, long long w, const void* srcs, long long r,
                       void* scratch, void* stream) {
  const SlabScratch sc = slab_scratch(scratch, w, r);
  const unsigned* k0 = static_cast<const unsigned*>(pairs);
  slab_runs_kernel<<<blocks_for(r, kRunThreads), kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k0 + 2 * w, sc.plan, static_cast<const int*>(srcs), r, sc.starts, sc.ends);
  return static_cast<int>(cudaGetLastError());
}

// Step 3b: each row's output offset (the exclusive scan of its run's
// length) and the device total (r > 0).
int csr_slab_scan_rows(long long w, long long r, void* offsets, void* total, void* scratch,
                       void* stream) {
  const SlabScratch sc = slab_scratch(scratch, w, r);
  degree_scan_kernel<RunSpan><<<static_cast<unsigned>((r + kDegTile - 1) / kDegTile), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      RunSpan{sc.starts, sc.ends}, nullptr, r, static_cast<unsigned*>(offsets),
      static_cast<unsigned*>(total), sc.scan, aligned16(offsets));
  return static_cast<int>(cudaGetLastError());
}

// Step 4: the hits in row-major order into `out` slots of row / eid / nbr
// (eid = base + window slot, nbr = e[slot]); -1 from the total on.
int csr_slab_scan_gather(const void* pairs, long long w, const void* e, int base,
                         const void* srcs, const void* offsets, long long r, const void* total,
                         long long out, void* row, void* eid, void* nbr, void* scratch,
                         void* stream) {
  if (out > 0) {
    const SlabScratch sc = slab_scratch(scratch, w, r);
    const unsigned* k0 = static_cast<const unsigned*>(pairs);
    const SlabGather g{{k0 + w, k0 + 3 * w}, sc.plan, sc.starts, static_cast<const int*>(e), base};
    const int vec = aligned16(row) && aligned16(eid) && aligned16(nbr);
    gather_expand_kernel<SlabGather><<<blocks_for(r + out, kExpandTile), kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        g, static_cast<const int*>(srcs), static_cast<const int*>(offsets), r,
        static_cast<const int*>(total), out, static_cast<int*>(row), static_cast<int*>(eid),
        static_cast<int*>(nbr), vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// For each (row, bucket slot) of the [r, bk] probe: the match flag (bool
// `mask`) and the table's relative slab slot (int32 `rel`).
int csr_slab_probe(const void* tab, const void* own, const void* live, long long ecap,
                   const void* srcs, long long r, int nb, int bk, int base, void* mask,
                   void* rel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = r * bk;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  slab_probe_kernel<<<grid_for(n, 1), kThreads, 0, s>>>(
      static_cast<const int*>(tab), static_cast<const int*>(own),
      static_cast<const unsigned char*>(live), ecap, static_cast<const int*>(srcs), r, nb, bk,
      base, static_cast<unsigned char*>(mask), static_cast<int*>(rel));
  return static_cast<int>(cudaGetLastError());
}

// The probe's compacted flat indices `idx` (`out` slots, -1 padded) decoded
// into row / eid / nbr.
int csr_slab_decode(const void* idx, long long out, const void* rel, int bk, int base,
                    const void* nbr_a, long long ecap, void* row, void* eid, void* nbr,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out <= 0) return static_cast<int>(cudaGetLastError());
  slab_decode_kernel<<<grid_for(out, 1), kThreads, 0, s>>>(
      static_cast<const int*>(idx), out, static_cast<const int*>(rel), bk, base,
      static_cast<const int*>(nbr_a), ecap, static_cast<int*>(row), static_cast<int*>(eid),
      static_cast<int*>(nbr));
  return static_cast<int>(cudaGetLastError());
}

// K19's push. `indptr` ([nv + 1]) is the partition's resident indptr,
// `blockv` [nv], `pageof` [nb], `estart` [nb + 1]; `nbr` and `eid` are the
// pool's `ns` = P*Wp slots, pages of `wp`. `emask`, `gate` and `alive` may
// be null; `zero_out` as for csr_bitmap_hop. `miss` (one byte, or null) is
// the cold-miss flag K20 computes, set here to 1 and never zeroed.
int csr_paged_hop_csr(const void* indptr, long long nv, const void* blockv, const void* pageof,
                      long long nb, const void* estart, const void* nbr, const void* eid,
                      long long ns, long long wp, const void* emask, long long ne,
                      const void* frontier, const void* gate, long long c, long long vb,
                      const void* alive, int zero_out, void* out, void* miss, void* stream) {
  const PagedRows rows{static_cast<const int*>(indptr), static_cast<const int*>(blockv),
                       static_cast<const int*>(pageof), static_cast<const int*>(estart),
                       static_cast<const int*>(eid), nb, wp, ns, 0,
                       ns > 0 || miss != nullptr ? (nv < vb ? nv : vb) : 0,
                       static_cast<unsigned char*>(miss)};
  return launch_push(rows, nbr, emask, ne, frontier, gate, c, vb, alive, zero_out, out, stream);
}

// K20. `flag` is one byte, zeroed here; `gate` and `alive` may be null.
int csr_paged_hop_miss(const void* frontier, const void* gate, long long c, long long vb,
                       const void* blockv, long long nv, const void* pageof, long long nb,
                       const void* indptr, const void* alive, void* flag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, 1, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = nv < vb ? nv : vb;
  if (n > 0 && c > 0) {
    paged_hop_miss_kernel<<<grid_for(n, 1), kThreads, 0, s>>>(
        static_cast<const unsigned char*>(frontier), static_cast<const unsigned char*>(gate), c,
        vb, static_cast<const int*>(blockv), nv, static_cast<const int*>(pageof), nb,
        static_cast<const int*>(indptr), static_cast<const int*>(alive),
        static_cast<unsigned char*>(flag));
  }
  return static_cast<int>(cudaGetLastError());
}

// K21. `pool_eid` is read only when not `out_dir`; `ns` is the pool's P*Wp
// slots. `flag` (one byte) only receives 1s; with `zero_flag` it is zeroed
// here first.
int csr_paged_expand(const void* indptr, long long nv, const void* srcs, const void* offsets,
                     long long k, const void* total, long long out_size, const void* blockv,
                     const void* pageof, long long nb, const void* estart,
                     const void* pool_nbr, const void* pool_eid, long long ns, long long wp,
                     int out_dir, void* row_out, void* eid_out, void* nbr_out, void* flag,
                     int zero_flag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_flag) {
    cudaError_t e = cudaMemsetAsync(flag, 0, 1, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (out_size > 0) {
    const int vec = aligned16(row_out) && aligned16(eid_out) && aligned16(nbr_out);
    const PagedGather g{static_cast<const int*>(indptr), nv, static_cast<const int*>(blockv),
                        static_cast<const int*>(pageof), nb, static_cast<const int*>(estart),
                        static_cast<const int*>(pool_nbr),
                        out_dir ? nullptr : static_cast<const int*>(pool_eid), ns, wp,
                        static_cast<unsigned char*>(flag)};
    gather_expand_kernel<PagedGather><<<blocks_for(k + out_size, kExpandTile), kThreads, 0, s>>>(
        g, static_cast<const int*>(srcs), static_cast<const int*>(offsets), k,
        static_cast<const int*>(total), out_size, static_cast<int*>(row_out),
        static_cast<int*>(eid_out), static_cast<int*>(nbr_out), vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 range form. `tots` ([S_l] int32) is zeroed here; `counts` is [S_l, n].
int csr_degree_counts_range(const void* ind, long long r1, const void* span, const void* srcs,
                            long long n, long long s_local, void* counts, void* tots,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_local <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = cudaMemsetAsync(tots, 0, static_cast<size_t>(s_local) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    degree_counts_range_kernel<<<dim3(blocks_for(n, kThreads), static_cast<unsigned>(s_local)),
                                 kThreads, 0, s>>>(
        static_cast<const int*>(ind), r1, static_cast<const int*>(span),
        static_cast<const int*>(srcs), n, static_cast<int*>(counts),
        static_cast<unsigned*>(tots));
  }
  return static_cast<int>(cudaGetLastError());
}

// K22. `tots` holds the totals of all `n_shards` shards; this process holds
// shards s0 .. s0 + s_local - 1 (the leading axis of ind, nbr, extra, span
// and offsets). At most 1024 shards.
int csr_shard_gather(const void* ind, long long r1, const void* nbr, long long emax,
                     const void* extra, long long extra_w, const void* span, const void* srcs,
                     long long n, const void* offsets, const void* tots, long long n_shards,
                     long long s0, long long s_local, long long cap, long long cap_total,
                     int is_out, int plus_one, void* row_out, void* eid_out, void* nbr_out,
                     void* stream) {
  if (n_shards > 1024 || s0 < 0 || s0 + s_local > n_shards) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap_total > 0) {
    shard_gather_kernel<<<blocks_for(cap_total, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ind), r1, static_cast<const int*>(nbr), emax,
        static_cast<const int*>(extra), extra_w, static_cast<const int*>(span),
        static_cast<const int*>(srcs), n, static_cast<const int*>(offsets),
        static_cast<const int*>(tots), n_shards, s0, s_local, cap, cap_total, is_out, plus_one,
        static_cast<int*>(row_out), static_cast<int*>(eid_out), static_cast<int*>(nbr_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K10's eid form over the row-sharded CSR of the shards s0 .. s0 + s_local
// - 1: `indptr` [s_local, r + 1], `nbr` [s_local, emax], `extra` ebase
// [s_local] (is_out) or the in CSR's eid [s_local, emax]. The rows walked
// are the held vertices [s0*r, (s0 + s_local)*r) below vb. `emask`, `gate`
// and `alive` may be null; `zero_out` as for csr_bitmap_hop.
int csr_bitmap_hop_shard(const void* indptr, long long r, long long s_local, long long s0,
                         const void* nbr, long long emax, const void* extra, int is_out,
                         const void* emask, long long ne, const void* frontier, const void* gate,
                         long long c, long long vb, const void* alive, int zero_out, void* out,
                         void* stream) {
  long long hi = (s0 + s_local) * r;
  const ShardRows rows{static_cast<const int*>(indptr), static_cast<const int*>(extra), r, s0,
                       emax, is_out, s0 * r, hi < vb ? hi : vb};
  return launch_push(rows, nbr, emask, ne, frontier, gate, c, vb, alive, zero_out, out, stream);
}

// K23's scratch in int32 words for s_local shards of r rows and emax
// slots, with room for n_fold folded weights (0: no fold).
long long csr_shard_weight_scratch(long long s_local, long long r, long long emax, long long n_fold) {
  return shard_scratch_words(s_local, r, emax) + n_fold;
}

// K23 over the row-sharded CSR of the shards s0 .. s0 + s_local - 1:
// `ind` [s_local, r + 1], `nbr` [s_local, emax], `extra` ebase [s_local]
// (is_out) or eid [s_local, emax]. `emask`, `ok` and `w` may be null (every
// edge / vertex kept, weight 1); `keep` as for weight_gather; `fold`
// kFoldNone, kFoldAlways or kFoldSample (ok folded into w in scratch first,
// always or where a sample of ok says it pays); `out` ([vb]) accumulates.
int csr_shard_weight_pass_i32(const void* ind, long long r, long long s_local, long long s0,
                              const void* nbr, long long emax, const void* extra, int is_out,
                              const void* emask, long long n_em, const void* ok, long long n_ok,
                              const void* w, long long n_w, int keep, int fold, long long vb,
                              void* out, void* scratch, void* stream) {
  return launch_shard_weight_pass<unsigned>(ind, r, s_local, s0, nbr, emax, extra, is_out, emask,
                                            n_em, ok, n_ok, w, n_w, keep, fold, vb, out, scratch,
                                            stream);
}

int csr_shard_weight_pass_f32(const void* ind, long long r, long long s_local, long long s0,
                              const void* nbr, long long emax, const void* extra, int is_out,
                              const void* emask, long long n_em, const void* ok, long long n_ok,
                              const void* w, long long n_w, int keep, int fold, long long vb,
                              void* out, void* scratch, void* stream) {
  return launch_shard_weight_pass<float>(ind, r, s_local, s0, nbr, emax, extra, is_out, emask, n_em,
                                         ok, n_ok, w, n_w, keep, fold, vb, out, scratch, stream);
}

// K24. `frontier` is [s_local, q, r]; `out` is [n_shards, q, r], zeroed
// here first when `zero_out` is set.
int csr_rowshard_hop(const void* indptr, long long r, const void* dst, long long emax,
                     const void* frontier, long long s_local, long long q, long long n_shards,
                     int zero_out, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = n_shards * q * r;
  if (zero_out && n_out > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(n_out), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (s_local > 0 && q > 0 && r > 0 && emax > 0) {
    const long long warps = s_local * ((r + kRunLen - 1) / kRunLen);
    long long blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const bool vec = r % 16 == 0 && aligned16(frontier);
    auto kernel = vec ? rowshard_hop_kernel<true> : rowshard_hop_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(indptr), r, static_cast<const int*>(dst), emax,
        static_cast<const unsigned char*>(frontier), s_local, q, n_shards * r,
        static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
