// Hand-written Hopper (sm_90a) kernels for the CSR primitives of the
// compiled MATCH path, the bitmap BFS of variable-depth and NOT arms, the
// result stage of a captured replay, the page of a batch's rows group, the
// interpreter of a compiled WHERE program, the delta path (the in-place
// patch scatter and the two append-slab expansions), the tier plane's
// paged hop, cold-miss flag and paged gather, and the mesh's per-shard
// expansion totals and gather, edge-list hop, weight pass and row-sharded
// BFS hop.
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
// gets the sum of the values of the threads before it (K17's emit pass).
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

template <typename T>
cudaError_t scan_lookback(const T* in, T* out, T* total, long long n,
                          unsigned long long* state, int exclusive, cudaStream_t s) {
  if (n <= 0) {
    return total != nullptr ? cudaMemsetAsync(total, 0, sizeof(T), s) : cudaSuccess;
  }
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  cudaError_t e = cudaMemsetAsync(state, 0xff, lb_state_bytes(tiles), s);
  if (e != cudaSuccess) return e;
  const int vec_ok = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  scan_lookback_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
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
// ---------------------------------------------------------------------------
constexpr int kDegVecs = 2;  // 16-byte source loads a thread
constexpr long long kDegTile = kThreads * 4LL * kDegVecs;

__global__ void __launch_bounds__(kThreads)
degree_scan_kernel(const unsigned* __restrict__ indptr, long long nv, const int* __restrict__ srcs,
                   long long k, unsigned* __restrict__ offsets, unsigned* __restrict__ total,
                   unsigned long long* __restrict__ state, int vec_ok) {
  constexpr int kVec = 4;
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_prefix;
  const unsigned tile = lb_tile(state, &s_tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wbase = tile * kDegTile + static_cast<long long>(warp) * 32 * kVec * kDegVecs;
  int src[kDegVecs][kVec];
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
  unsigned lo[kDegVecs][kVec], hi[kDegVecs][kVec];
#pragma unroll
  for (int v = 0; v < kDegVecs; ++v) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      lo[v][j] = hi[v][j] = 0u;
      const int c = src[v][j];
      if (c >= 0 && nv > 0) {  // clip(src, 0, V-1); padding counts 0
        const long long cc = c < nv ? c : nv - 1;
        lo[v][j] = __ldg(indptr + cc);
        hi[v][j] = __ldg(indptr + cc + 1);
      }
    }
  }
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
// out of range.
// ---------------------------------------------------------------------------
constexpr int kExpandItems = 8;  // merged items a thread
constexpr int kExpandTile = kThreads * kExpandItems;

__global__ void __launch_bounds__(kThreads)
gather_expand_kernel(const int* __restrict__ indptr, long long nv, const int* __restrict__ nbrs,
                     long long ne, const int* __restrict__ srcs, const int* __restrict__ offsets,
                     long long k, const int* __restrict__ total, long long out_size,
                     const int* __restrict__ edge_map, long long nm, int* __restrict__ row_out,
                     int* __restrict__ pos_out, int* __restrict__ nbr_out, int vec) {
  __shared__ int s_off[kExpandTile + 1];   // offsets of rows i0 - 1 .. i1 - 1
  __shared__ int s_base[kExpandTile + 1];  // indptr[clip(srcs[r])] of the same rows
  __shared__ int s_row[kExpandTile];       // a slot's row, as its index in the two above
  __shared__ long long s_split[2];
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
      int b = 0;
      if (nv >= 0) {
        long long c = __ldg(srcs + r);
        c = c > nv - 1 ? nv - 1 : c;
        b = __ldg(indptr + (c < 0 ? 0 : c));
      }
      s_base[e] = b;
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
      const int ep = static_cast<int>(static_cast<unsigned>(s_base[e]) +
                                      static_cast<unsigned>(j0 + yy) -
                                      static_cast<unsigned>(s_off[e]));
      int nb = -1;
      if (ne > 0) nb = __ldg(nbrs + (ep < 0 ? 0 : (ep > ne - 1 ? ne - 1 : ep)));
      int pos = ep;
      if (edge_map != nullptr) {
        pos = ep >= 0 && nm > 0 ? __ldg(edge_map + (ep > nm - 1 ? nm - 1 : ep)) : -1;
      }
      return make_int3(static_cast<int>(r), pos, nb);
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

__global__ void seg_partition_kernel(const int* __restrict__ indptr, long long ne, long long nseg,
                                     long long tiles, int* __restrict__ rowc,
                                     unsigned* __restrict__ out, long long out_size) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (tiles > 0) {
    const SegSpan sp = seg_span(indptr, ne, nseg);
    const long long total = nseg + sp.nv;
    // a warp a boundary: the number of segment ends among its first d
    // items (a segment end before the value at its own index)
    for (long long t = tid >> 5; t <= tiles; t += step >> 5) {
      const long long d = t * kSegTile < total ? t * kSegTile : total;
      const long long x = warp_merge_split([&](long long p) { return seg_end(indptr, sp, p); },
                                           d > sp.nv ? d - sp.nv : 0, d < nseg ? d : nseg, d);
      if (lane == 0) rowc[t] = static_cast<int>(x);
    }
  }
  // zeros past the segments: a scalar head up to 16-byte alignment, then
  // 16-byte stores, then a scalar tail
  const long long npad = out_size - nseg;
  if (npad <= 0) return;
  unsigned* pad = out + nseg;
  long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(pad) & 15u)) & 15u) / 4;
  if (head > npad) head = npad;
  const long long body = (npad - head) / 4;
  if (tid < head) pad[tid] = 0u;
  uint4* vec = reinterpret_cast<uint4*>(pad + head);
  for (long long k = tid; k < body; k += step) vec[k] = make_uint4(0u, 0u, 0u, 0u);
  const long long tail = head + 4 * body + tid;
  if (tail < npad && tid < 4) pad[tail] = 0u;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    seg_sum_kernel(const T* __restrict__ vals, long long ne, const int* __restrict__ indptr,
                   long long nseg, const int* __restrict__ rowc, T* __restrict__ out,
                   T* __restrict__ carry) {
  // the tile's segment ends (relative to its first value), a sentinel end,
  // then its values placed so that the 16-byte-aligned part of their
  // source lands on 16-byte-aligned shared memory (up to 3 slots of gap),
  // and one spare slot a walk may read past the last
  __shared__ __align__(16) unsigned s_buf[kSegTile + 6];
  __shared__ T s_out[kSegTile];
  __shared__ T s_wv[kWarps];
  __shared__ int s_wf[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const SegSpan sp = seg_span(indptr, ne, nseg);
  const long long total = nseg + sp.nv;
  const long long b = blockIdx.x;
  const long long d0 = b * kSegTile < total ? b * kSegTile : total;
  const long long d1 = d0 + kSegTile < total ? d0 + kSegTile : total;
  const int i0 = rowc[b], i1 = rowc[b + 1];
  const long long j0 = d0 - i0;
  const int ni = i1 - i0;
  const int nj = static_cast<int>(d1 - i1 - j0);
  const unsigned* src = reinterpret_cast<const unsigned*>(vals) + sp.v0 + j0;
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) / 4;
  if (head > nj) head = nj;
  int* s_end = reinterpret_cast<int*>(s_buf);
  unsigned* s_val = s_buf + (((ni + 1 + head + 3) & ~3) - head);
  for (int k = tid; k < ni; k += kThreads) {
    s_end[k] = static_cast<int>(seg_end(indptr, sp, i0 + k) - j0);
  }
  if (tid == 0) s_end[ni] = 0x7fffffff;  // past the tile's last end: only values
  {
    const int body = (nj - head) / 4;
    if (tid < head) s_val[tid] = src[tid];
    const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
    uint4* vdst = reinterpret_cast<uint4*>(s_val + head);
#pragma unroll 4
    for (int k = tid; k < body; k += kThreads) vdst[k] = __ldcs(vsrc + k);
    const int tail = head + 4 * body + tid;
    if (tid < 4 && tail < nj) s_val[tail] = src[tail];
  }
  __syncthreads();
  // this thread's share of the tile: its start by a search in shared memory
  const int items = ni + nj;
  const int ds = tid * kSegItems < items ? tid * kSegItems : items;
  const int cnt = (ds + kSegItems < items ? ds + kSegItems : items) - ds;
  int lo = ds > nj ? ds - nj : 0, hi = ds < ni ? ds : ni;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= ds - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int xs = lo;
  // one branch-free walk: a segment end stores the running sum (the first
  // one without the earlier threads' part of it, added below), a value
  // adds to it; the current end stays in a register and is read again only
  // after a segment ended
  T acc = T(0);
  int x = xs, y = ds - lo;
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
  if (tid == kThreads - 1) carry[b] = f ? v : pv + v;
  // the first segment that ends in the share gets the earlier threads' part
  if (tid > 0 && x != xs) s_out[xs] = (lane == 0 ? pv : (ef ? ev : pv + ev)) + s_out[xs];
  __syncthreads();
  for (int k = tid; k < ni; k += kThreads) out[i0 + k] = s_out[k];
}

// Adds each run's carries to the segment the run ends in (see above).
template <typename T>
__global__ void seg_fixup_kernel(const int* __restrict__ rowc, const T* __restrict__ carry,
                                 long long tiles, long long nseg, T* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < tiles;
       t += step) {
    const int key = rowc[t + 1];
    if (key >= nseg || (t > 0 && rowc[t] == key)) continue;
    T s = carry[t];
    for (long long u = t + 1; u < tiles && rowc[u + 1] == key; ++u) s += carry[u];
    out[key] += s;
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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    take_pad_kernel(const T* __restrict__ vals, long long n, const int* __restrict__ idx,
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
      for (int e = 0; e < kRun; ++e) r[e] = take_one(vals, n, ix[e], fill, policy);
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
    if (j < m) out[j] = take_one(vals, n, __ldcs(idx + j), fill, policy);
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
    for (int k = 0; k < kRun; ++k) r[k] = take_one(vals, n, ix[k], fill, policy);
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
// ---------------------------------------------------------------------------
constexpr int kCountLoads = 4;
constexpr long long kCountTile = static_cast<long long>(kThreads) * kCountLoads * 16;
constexpr int kCountBlocksPerSm = 4;

__device__ inline unsigned nonzero_bytes(unsigned x) { return __popc(__vcmpne4(x, 0u) & 0x01010101u); }

__global__ void __launch_bounds__(kThreads)
    mask_count_kernel(const unsigned char* __restrict__ mask, long long n, long long head,
                      unsigned* __restrict__ out, int store) {
  __shared__ unsigned sums[kWarps];
  const int tid = threadIdx.x;
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
                                  int* __restrict__ out) {
  long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= w) return;
  if (valid[t] != 0) {
    long long r = static_cast<long long>(ranks[t]) - 1;
    for (int c = 0; c < ncols; ++c) out[r * stride + col0 + c] = cols.p[c][t];
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
                                   int* __restrict__ out) {
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
// which no CSR row holds, beside the CSR form below).
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
// K10, CSR form: bitmap_hop_csr (replaces csr.bitmap_hop,
// orientdb_tpu/ops/csr.py:260, as build_bitmap_hops drives it,
// orientdb_tpu/exec/tpu_engine.py:487, over a class's base CSR).
// out[c, nbr[s]] |= frontier[c, v] & gate[v] & mask[eid[s] or s] for every
// slot s of row v of `indptr`: the rows are the endpoint that must be
// active (indptr_out for an out hop, indptr_in for an in hop), `nbr` the
// endpoint reached, `eid` (may be null) the slot's out-order edge id, read
// only to index `mask`. The mask is tested first and `nbr` clipped after,
// as the reference's edge list does (a tombstoned slot's -1 neighbour is
// masked by `live` before its clip could alias vertex 0).
// Bound: the work depends on the frontier. Read: C*vb frontier bytes (and
// vb of gate), 8 bytes of indptr an active vertex, 4 of nbr (+1 of mask,
// +4 of eid) an edge of an active vertex; written: C*vb. At V1's level 1
// (8 roots, ~80 active vertices, [8, 2^23]): 2*64 MiB, ~0.04 ms.
// Design: a warp takes 128 vertices a step (4 a lane: one 32-bit load a
// frontier row, coalesced), ANDs in the gate and packs its vertices' rows
// into a 32-bit row mask (rows in blocks of 32 when C > 32). A ballot skips
// the group when none is active, so a sparse hop costs its frontier read
// and the zeroing. Otherwise the warp lists its active vertices of nonzero
// degree in shared memory (start slot, exclusive prefix of degree, row
// mask; two warp scans), walks the flat span of their edges 32 slots a
// step, each lane finding its slot's vertex by a binary search of the
// prefixes, and stores a 1 for each set row bit at the reached vertex.
// Consecutive vertices' slots are contiguous in `nbr`, so those reads
// coalesce at any density. Racing stores all write 1: no atomics. The grid
// is sized from the row count, never from the active count, so a captured
// replay needs no host read; `alive` at 0 returns at once.
// ---------------------------------------------------------------------------
constexpr int kHopGroup = 128;  // vertices a warp step: 4 a lane

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bitmap_hop_csr_kernel(const int* __restrict__ indptr, long long nv,
                      const int* __restrict__ nbr, const int* __restrict__ eid,
                      const unsigned char* __restrict__ emask, long long ne,
                      const unsigned char* __restrict__ frontier,
                      const unsigned char* __restrict__ gate, long long c, long long vb,
                      const int* __restrict__ alive, unsigned char* __restrict__ out) {
  if (alive != nullptr && *alive == 0) return;
  __shared__ int s_start[kWarps][kHopGroup];
  __shared__ int s_pref[kWarps][kHopGroup];
  __shared__ unsigned s_rows[kWarps][kHopGroup];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long groups = (nv + kHopGroup - 1) / kHopGroup;
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + w; g < groups; g += wstride) {
    const long long v0 = g * kHopGroup + 4 * lane;  // this lane's first vertex
    for (long long rb = 0; rb < c; rb += 32) {
      const int nr = static_cast<int>(c - rb < 32 ? c - rb : 32);
      unsigned mk[4] = {0u, 0u, 0u, 0u};
      if (v0 < nv) {
        const unsigned char* f = frontier + rb * vb + v0;
        if (kVec) {
          // vb % 4 == 0 and v0 < nv <= vb: the 4 bytes lie inside the row
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
            if (v0 + k >= nv) break;
            for (int r = 0; r < nr; ++r) mk[k] |= static_cast<unsigned>(f[r * vb + k] != 0) << r;
            if (gate != nullptr && !gate[v0 + k]) mk[k] = 0;
          }
        }
#pragma unroll
        for (int k = 1; k < 4; ++k) if (v0 + k >= nv) mk[k] = 0;
      }
      if (!__any_sync(kFull, (mk[0] | mk[1] | mk[2] | mk[3]) != 0u)) continue;
      // the lane's active vertices of nonzero degree
      int st[4], dg[4];
      int cnt = 0, dsum = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        st[k] = 0;
        dg[k] = 0;
        if (mk[k] != 0u) {
          st[k] = indptr[v0 + k];
          dg[k] = indptr[v0 + k + 1] - st[k];
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
          s_start[w][pos] = st[k];
          s_pref[w][pos] = off;
          s_rows[w][pos] = mk[k];
          ++pos;
          off += dg[k];
        }
      }
      __syncwarp();
      for (int p = lane; p < total; p += 32) {
        int lo = 0, hi = na - 1;  // the last entry whose prefix is <= p
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_pref[w][mid] <= p) lo = mid; else hi = mid - 1;
        }
        const long long slot = static_cast<long long>(s_start[w][lo]) + (p - s_pref[w][lo]);
        if (emask != nullptr) {
          long long e = slot;
          if (eid != nullptr) {
            const int x = eid[slot];  // take_pad(mask, eid, False)
            if (x < 0 || ne <= 0) continue;
            e = x < ne ? x : ne - 1;
          }
          if (!emask[e]) continue;
        }
        long long m = nbr[slot];
        m = m < 0 ? 0 : (m < vb ? m : vb - 1);  // jnp.clip(emit_idx, 0, vb - 1)
        unsigned rows = s_rows[w][lo];
        while (rows != 0u) {
          const int r = __ffs(rows) - 1;
          rows &= rows - 1u;
          out[(rb + r) * vb + m] = 1;
        }
      }
      __syncwarp();
    }
  }
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

template <bool kVec>
__global__ void bitmap_emit_kernel(const unsigned char* __restrict__ reached,
                                   const unsigned char* __restrict__ node,
                                   const int* __restrict__ bound, long long c,
                                   long long vb, unsigned char* __restrict__ emit,
                                   unsigned char* __restrict__ any,
                                   unsigned* __restrict__ count) {
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
__global__ void bitmap_emit_bound_kernel(const unsigned char* __restrict__ reached,
                                         const unsigned char* __restrict__ node,
                                         const int* __restrict__ bound, long long c,
                                         long long vb, unsigned char* __restrict__ any,
                                         unsigned* __restrict__ count) {
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
template <bool kVec>
__global__ void frontier_advance_kernel(unsigned char* __restrict__ nxt,
                                        unsigned char* __restrict__ visited,
                                        const unsigned char* __restrict__ gate,
                                        const unsigned char* __restrict__ node,
                                        const int* __restrict__ bound, long long n,
                                        long long vb, unsigned* __restrict__ count,
                                        unsigned* __restrict__ emitted) {
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
// ---------------------------------------------------------------------------
__global__ void rows_with_matches_kernel(const int* __restrict__ rows,
                                         const unsigned char* __restrict__ mask,
                                         long long w, long long nseg,
                                         unsigned* __restrict__ out) {
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
// ---------------------------------------------------------------------------
constexpr int kStack = 16;     // a program's stack need at most (PRED_STACK)
constexpr int kMaxBufs = 32;   // buffers a launch reads (PRED_BUFS)
constexpr int kProgSmem = 48 * 1024;
constexpr int kPredV = 8;      // consecutive slots a thread
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
__device__ __forceinline__ void pred_push(const PredArgs& a, int4 ins, const int (&id)[kPredV],
                                          long long i0, unsigned live, bool run,
                                          unsigned (&tv)[kPredV], unsigned& tp) {
  switch (ins.x) {
    case kCol: pred_column(a, ins.y, ins.z, id, live, run, tv, tp); break;
    case kBCol: {
      unsigned r[kPredV];
      pred_slots(static_cast<const unsigned*>(a.buf[ins.w]), i0, a.n, live, 0xffffffffu, r);
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
      const unsigned p = static_cast<unsigned>(__ldg(a.params + ins.y));
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
      pred_slots(static_cast<const unsigned*>(a.buf[ins.y]), i0, a.n, live, 0u, tv);
      tp = pred_slot_bits(static_cast<const unsigned char*>(a.buf[ins.z]), i0, a.n, live);
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
  const int len = static_cast<int>(a.len);
  const long long step = static_cast<long long>(gridDim.x) * kPredTile;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kPredTile; t0 < a.n; t0 += step) {
    const long long i0 = t0 + static_cast<long long>(tid) * kPredV;
    const bool whole = i0 + kPredV <= a.n;
    int id[kPredV];
    if (a.ids && whole && pred_aligned(a.ids + i0, 16)) {
#pragma unroll
      for (int q = 0; q < kPredV / 4; ++q) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(a.ids + i0) + q);
        id[4 * q] = w.x;
        id[4 * q + 1] = w.y;
        id[4 * q + 2] = w.z;
        id[4 * q + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kPredV; ++v) {
        const long long i = i0 + v;
        if (a.ids) {
          id[v] = i < a.n ? __ldg(a.ids + i) : -1;
        } else {
          id[v] = i < a.n_valid ? static_cast<int>(a.base + i) : -1;
        }
      }
    }
    // slots past n are dead from the start; a GUARD kills more
    unsigned live = pred_bits([&](int v) { return i0 + v < a.n; });
    const bool run = a.ids == nullptr && whole && i0 + kPredV <= a.n_valid;
    // the top; with an empty stack it reads (0, present), so a program
    // that ends on its last GUARD leaves the live bits as its mask
    unsigned tv[kPredV];
#pragma unroll
    for (int v = 0; v < kPredV; ++v) tv[v] = 0u;
    unsigned tp = kPredAll;
    int depth = 0;  // entries on the stack, the top included
    for (int pc = 0; pc < len; ++pc) {
      const int4 ins = prog_smem ? prog[pc] : __ldg(prog + pc);
      const int op = ins.x;
      if ((kPredPushes >> op) & 1u) {
        if (depth > 0) {  // the top goes below (an empty stack's top is not kept)
          const int k = depth - 1;
#pragma unroll
          for (int v = 0; v < kPredV; ++v) sval[(k * kPredV + v) * kThreads + tid] = tv[v];
          spm[k * kThreads + tid] = tp;
        }
        ++depth;
        pred_push(a, ins, id, i0, live, run, tv, tp);
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
            const int c = static_cast<int>(tv[v]);
            if ((((tp & live) >> v) & 1u) && nt > 0) hit[v] = __ldg(tab + (c < 0 ? 0 : (c >= nt ? nt - 1 : c)));
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
    const unsigned res = live & tp;
    if (whole && pred_aligned(a.out_p + i0, 4 * (kPredV / 4))) {
      unsigned w[kPredV / 4];
#pragma unroll
      for (int q = 0; q < kPredV / 4; ++q) w[q] = pred_bit_bytes(res >> (4 * q));
      if constexpr (kPredV == 8) {
        *reinterpret_cast<uint2*>(a.out_p + i0) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int q = 0; q < kPredV / 4; ++q) reinterpret_cast<unsigned*>(a.out_p + i0)[q] = w[q];
      }
    } else {
#pragma unroll
      for (int v = 0; v < kPredV; ++v) {
        if (i0 + v < a.n) a.out_p[i0 + v] = static_cast<unsigned char>((res >> v) & 1u);
      }
    }
    if (a.out_v) {
      if (whole && pred_aligned(a.out_v + i0, 16)) {
#pragma unroll
        for (int q = 0; q < kPredV / 4; ++q) {
          reinterpret_cast<uint4*>(a.out_v + i0)[q] =
              make_uint4(tv[4 * q], tv[4 * q + 1], tv[4 * q + 2], tv[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kPredV; ++v) {
          if (i0 + v < a.n) a.out_v[i0 + v] = static_cast<int>(tv[v]);
        }
      }
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
// Bound: the larger of R*4 (sources) + W*(4 + 4 + 1) bytes (the window's
// active and emitted endpoints and liveness) read plus the output, and the
// R*W compares (rows with a source times window slots), the reference's own
// cost, at the card's 32-bit scalar rate.
// Design: the [R, W] match mask is never stored. A count pass gives each
// row its matches (kSlabRows rows a block, each window entry loaded once
// for all of them); the exclusive scan of the counts (K1) gives each row
// its output offset; an emit pass, one block per row with matches, walks
// the window in order and writes (row, base + j, e[j]) at offset + rank,
// ranks from a block scan, and stops after the row's last match:
// row-major order, as compact_indices over the reshaped mask gives it.
// Slots from the total to the capacity get -1.
// ---------------------------------------------------------------------------
constexpr int kSlabRows = 8;

__global__ void slab_scan_count_kernel(const int* __restrict__ a,
                                       const unsigned char* __restrict__ live, long long w,
                                       const int* __restrict__ srcs, long long r,
                                       int* __restrict__ counts) {
  __shared__ unsigned warp_sums[kWarps];
  for (long long r0 = blockIdx.x * static_cast<long long>(kSlabRows); r0 < r;
       r0 += static_cast<long long>(gridDim.x) * kSlabRows) {
    int src[kSlabRows];
    unsigned c[kSlabRows];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kSlabRows; ++k) {
      src[k] = r0 + k < r ? srcs[r0 + k] : -1;
      c[k] = 0u;
      any = any || src[k] >= 0;
    }
    if (any) {  // uniform across the block
      for (long long j = threadIdx.x; j < w; j += blockDim.x) {
        if (!live[j]) continue;
        const int x = a[j];
#pragma unroll
        for (int k = 0; k < kSlabRows; ++k) c[k] += (src[k] >= 0 && x == src[k]) ? 1u : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlabRows; ++k) {
      const unsigned t = block_sum(c[k], warp_sums);
      if (threadIdx.x == 0 && r0 + k < r) counts[r0 + k] = static_cast<int>(t);
    }
  }
}

__global__ void slab_scan_emit_kernel(const int* __restrict__ a, const int* __restrict__ e,
                                      const unsigned char* __restrict__ live, long long w,
                                      const int* __restrict__ srcs,
                                      const int* __restrict__ counts,
                                      const int* __restrict__ offsets, long long r,
                                      const int* __restrict__ total, int base, long long out,
                                      int* __restrict__ row_o, int* __restrict__ eid_o,
                                      int* __restrict__ nbr_o) {
  __shared__ unsigned warp_sums[kWarps];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long t = *total;
  if (t < 0) t = 0;
  for (long long q = t + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < out;
       q += stride) {
    row_o[q] = -1;
    eid_o[q] = -1;
    nbr_o[q] = -1;
  }
  for (long long row = blockIdx.x; row < r; row += gridDim.x) {
    const int src = srcs[row];
    if (src < 0 || counts[row] == 0) continue;  // uniform across the block
    long long pos = offsets[row];
    const long long end = pos + counts[row];  // past the row's last hit
    for (long long j0 = 0; j0 < w && pos < end && pos < out; j0 += blockDim.x) {
      const long long j = j0 + threadIdx.x;
      const unsigned hit = (j < w && live[j] && a[j] == src) ? 1u : 0u;
      const unsigned rank = block_exclusive_scan<unsigned>(hit, warp_sums);
      if (hit) {
        const long long q = pos + rank;
        if (q < out) {
          row_o[q] = static_cast<int>(row);
          eid_o[q] = base + static_cast<int>(j);
          nbr_o[q] = e[j];
        }
      }
      pos += __syncthreads_count(hit);
    }
  }
}

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
// last value.
// ---------------------------------------------------------------------------

// K19: paged_hop. out[c, nbr[s]] |= frontier[c, own[s]] over the flattened
// pool [P*Wp], for slots with own[s] >= 0 and, with an edge mask,
// emask[eid[s]] (a -1 eid reads False, as take_pad(emask, eid, False)).
// Bound: `own` over the whole pool (4 bytes a slot), the frontier rows and
// the gate at the vertices of resident blocks (C + 1 bytes a vertex), nbr
// (+4 eid and 1 mask byte with an edge mask) only at the live slots whose
// owner is active, and `out` written once. Design: K10's grid-stride loop
// over the slots with K10's options (gate, alive, out). `own` is tested
// before anything else: an evicted page keeps stale nbr and eid rows behind
// its -1 owner row, and K10's clip of a -1 endpoint to vertex 0 would let a
// frontier holding vertex 0 reach every stale neighbour. The gate and the
// frontier come next, so eid, the mask and nbr are read only at slots whose
// owner is active. The mask is gathered through eid here, so no [P*Wp] mask
// is ever stored. Stores are only 1s, with no atomics, as in K10.
__global__ void paged_hop_kernel(const int* __restrict__ own, const int* __restrict__ nbr,
                                 const int* __restrict__ eid, long long ns,
                                 const unsigned char* __restrict__ emask, long long ne,
                                 const unsigned char* __restrict__ frontier,
                                 const unsigned char* __restrict__ gate, long long c,
                                 long long vb, const int* __restrict__ alive,
                                 unsigned char* __restrict__ out) {
  if (alive != nullptr && *alive == 0) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; s < ns;
       s += stride) {
    const int o = own[s];
    if (o < 0) continue;
    const long long a = o < vb ? o : vb - 1;
    if (gate != nullptr && !gate[a]) continue;
    bool act = false;  // every row read: independent loads, no chain
    for (long long r = 0; r < c; ++r) act |= frontier[r * vb + a] != 0;
    if (!act) continue;
    if (emask != nullptr) {
      const int e = eid[s];
      if (e < 0 || ne <= 0) continue;
      if (!emask[e < ne ? e : ne - 1]) continue;
    }
    long long m = nbr[s];
    m = m < 0 ? 0 : (m < vb ? m : vb - 1);
    for (long long r = 0; r < c; ++r) {
      if (frontier[r * vb + a]) out[r * vb + m] = 1;
    }
  }
}

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

// K21: paged_expand. The CSR gather of K2b (row by an upper-bound search
// over the exclusive offsets, edge_pos from the resident indptr), fused
// with the block -> page indirection: nbr (and, for the in direction, eid)
// read from pool[pageof[blockv[src]] * Wp + edge_pos - estart[b]], with the
// reference's clips clip(src, 0, V-1), clip(p, 0) and clip(local, 0,
// Wp-1). A live slot whose block is cold (p < 0) sets *flag; row, eid and
// nbr are -1 there and past the total. The out direction's eid is
// edge_pos. Bound: K2b's (12 bytes a source, three int32 outputs a slot)
// plus a slot's blockv, pageof, estart and one or two pool reads. Design:
// one thread per output slot; the three index reads of a slot hit L2
// (blockv, pageof and estart of one source are shared by its slots).
__global__ void paged_expand_kernel(const int* __restrict__ indptr, long long nv,
                                    const int* __restrict__ srcs,
                                    const int* __restrict__ offsets, long long k,
                                    const int* __restrict__ total, long long out_size,
                                    const int* __restrict__ blockv,
                                    const int* __restrict__ pageof, long long nb,
                                    const int* __restrict__ estart,
                                    const int* __restrict__ pool_nbr,
                                    const int* __restrict__ pool_eid, long long ns,
                                    long long wp, int out_dir, int* __restrict__ row_out,
                                    int* __restrict__ eid_out, int* __restrict__ nbr_out,
                                    unsigned char* __restrict__ flag) {
  long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= out_size) return;
  if (q >= static_cast<long long>(*total) || k == 0 || nv <= 0) {
    row_out[q] = -1;
    eid_out[q] = -1;
    nbr_out[q] = -1;
    return;
  }
  long long lo = 0, hi = k;  // first row whose offset is > q
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(offsets[mid]) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long r = lo > 0 ? lo - 1 : 0;  // clip(row, 0, K-1)
  const int src = srcs[r];
  long long s = src < 0 ? 0 : src;  // clip(src, 0, V-1)
  if (s > nv - 1) s = nv - 1;
  const int edge_pos = indptr[s] + static_cast<int>(q - offsets[r]);
  const int b = blockv[s];
  const int p = b < 0 ? -1 : pageof[b < nb ? b : nb - 1];
  if (p < 0) {  // a cold block: the slot is nulled and flags
    *flag = 1;
    row_out[q] = -1;
    eid_out[q] = -1;
    nbr_out[q] = -1;
    return;
  }
  long long local = static_cast<long long>(edge_pos) - estart[b < nb ? b : nb - 1];
  local = local < 0 ? 0 : (local < wp ? local : wp - 1);
  long long flat = static_cast<long long>(p) * wp + local;
  if (flat > ns - 1) flat = ns - 1;
  row_out[q] = static_cast<int>(r);
  nbr_out[q] = ns > 0 ? pool_nbr[flat] : -1;
  eid_out[q] = out_dir ? edge_pos : (ns > 0 ? pool_eid[flat] : -1);
}

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
// orientdb_tpu/parallel/mesh_graph.py:480). One fused pass over the edge-
// list slots of every shard held: a slot with seg >= 0, emask[eid] (when a
// mask is given; eid -1 reads False) and ok[emit] (take_pad: -1 reads
// False, past the end the last) adds w[emit] (1 without w) into
// out[clip(seg, 0, vb - 1)]. The reference clips seg the same way and masks
// the -1 padding with seg >= 0, so no slot writes out of bounds. int32 adds
// are integer atomics (exact, wrapping); the float32 twin's atomics add in
// another order than the reference's segment_sum + psum. Bound: 12 bytes of
// slots, the mask, ok and w at each slot, out read and written.
template <typename T>
__global__ void shard_weight_pass_kernel(const int* __restrict__ seg,
                                         const int* __restrict__ emit,
                                         const int* __restrict__ eid, long long ns,
                                         const unsigned char* __restrict__ emask, long long ne,
                                         const unsigned char* __restrict__ ok,
                                         const T* __restrict__ w, long long vb,
                                         T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < ns;
       j += stride) {
    const int sg = seg[j];
    if (sg < 0) continue;
    if (emask != nullptr) {
      const int e = eid[j];
      if (e < 0 || ne <= 0 || !emask[e < ne ? e : ne - 1]) continue;
    }
    const int m = emit[j];
    if (m < 0) continue;
    const long long mc = m < vb ? m : vb - 1;
    if (!ok[mc]) continue;
    const T v = w != nullptr ? w[mc] : T(1);
    const long long dst = sg < vb ? sg : vb - 1;
    atomicAdd(out + dst, v);
  }
}

// K24: rowshard_hop (replaces the hop of sharded.build_bfs_step,
// orientdb_tpu/parallel/sharded.py:202-257). Row-sharded multi-source BFS:
// shard s holds rows [s R, (s+1) R) of the out-CSR (rebased indptr [S_l,
// R+1], dst [S_l, e_max]) and its [Q, R] slice of the frontier; an edge of a
// lit row r reaching d sets out[d / R, q, d % R] for every query q lit at r
// (out is [S, Q, R], shard-major, so a process group's reduce-scatter hands
// each rank its own slice). Edges past indptr[R] or with d < 0 are the
// reference's dead padding (edge_live); d clips to [0, S R - 1] as dst_c
// does. Design: a warp per local row (no [e_max] source array, where the
// reference derives each edge's row by searchsorted), the lit queries of a
// row as a ballot mask of 32, the row's edges strided over the lanes;
// stores are only 1s, no atomics. Bound: the frontier read once, 8 bytes of
// indptr and 4 of dst a lit row's edge, out written once.
__global__ void rowshard_hop_kernel(const int* __restrict__ indptr, long long r,
                                    const int* __restrict__ dst, long long emax,
                                    const unsigned char* __restrict__ frontier,
                                    long long s_local, long long q, long long v_pad,
                                    unsigned char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long rows = s_local * r;
  for (long long g = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       g < rows; g += warps) {
    const long long sl = g / r;
    const long long row = g - sl * r;
    const unsigned char* fr = frontier + sl * q * r + row;
    const int* ip = indptr + sl * (r + 1);
    long long b = -1, e = -1;
    for (long long q0 = 0; q0 < q; q0 += 32) {
      const unsigned bits = __ballot_sync(kFull, q0 + lane < q && fr[(q0 + lane) * r] != 0);
      if (bits == 0) continue;
      if (b < 0) {
        long long lim = ip[r];
        if (lim > emax) lim = emax;
        b = ip[row];
        e = ip[row + 1];
        if (b < 0) b = 0;
        if (e > lim) e = lim;
      }
      for (long long i = b + lane; i < e; i += 32) {
        long long d = dst[sl * emax + i];
        if (d < 0) continue;
        if (d > v_pad - 1) d = v_pad - 1;
        const long long t = d / r;
        const long long c = d - t * r;
        unsigned m = bits;
        while (m) {
          const long long k = __ffs(m) - 1;
          m &= m - 1;
          out[(t * q + q0 + k) * r + c] = 1;
        }
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
  seg_partition_kernel<<<grid_for(work, 1), kThreads, 0, s>>>(ip, ne, nseg, tiles, rowc,
                                                             static_cast<unsigned*>(out), out_size);
  if (tiles > 0) {
    seg_sum_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        static_cast<const T*>(vals), ne, ip, nseg, rowc, static_cast<T*>(out), carry);
    seg_fixup_kernel<T><<<grid_for(tiles, 1), kThreads, 0, s>>>(rowc, carry, tiles, nseg,
                                                                static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_take_pad(const void* vals, long long n, const void* idx, long long m, T fill, int keep, void* out,
                    void* stream) {
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* v = static_cast<const T*>(vals);
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

// K2: the exclusive offsets of the sources' degrees and their total (a
// device int32), after one memset of `state`.
int csr_degree_scan_i32(const void* indptr, long long nv, const void* srcs, long long k,
                        void* offsets, void* total, void* state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0) return static_cast<int>(cudaMemsetAsync(total, 0, sizeof(int), s));
  const long long tiles = (k + kDegTile - 1) / kDegTile;
  cudaError_t e = cudaMemsetAsync(state, 0xff, lb_state_bytes(tiles), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_ok = aligned16(srcs) && aligned16(offsets);
  degree_scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const unsigned*>(indptr), nv, static_cast<const int*>(srcs), k,
      static_cast<unsigned*>(offsets), static_cast<unsigned*>(total),
      static_cast<unsigned long long*>(state), vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// K2b. `edge_map` (nm entries) is optional: null writes the edge position.
int csr_gather_expand(const void* indptr, long long nv, const void* nbrs,
                      long long ne, const void* srcs, const void* offsets,
                      long long k, const void* total, long long out_size,
                      const void* edge_map, long long nm,
                      void* row_out, void* pos_out, void* nbr_out, void* stream) {
  if (out_size > 0) {
    const int vec = aligned16(row_out) && aligned16(pos_out) && aligned16(nbr_out);
    gather_expand_kernel<<<blocks_for(k + out_size, kExpandTile), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), nv, static_cast<const int*>(nbrs), ne,
        static_cast<const int*>(srcs), static_cast<const int*>(offsets), k,
        static_cast<const int*>(total), out_size, static_cast<const int*>(edge_map), nm,
        static_cast<int*>(row_out), static_cast<int*>(pos_out), static_cast<int*>(nbr_out),
        vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3. The fill form (`fill` 1) needs `state` right behind the out_size
// slots of `out` in one allocation: one memset of 0xFF bytes covers both.
int csr_compact(const void* mask, long long n, long long out_size, void* out, void* state,
                int fill, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long tiles = n > 0 ? (n + kCompactTile - 1) / kCompactTile : 0;
  char* lo = static_cast<char*>(fill ? out : state);
  char* hi = static_cast<char*>(state) + lb_state_bytes(tiles);
  if (fill && static_cast<char*>(state) < static_cast<char*>(out) + 4 * out_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaMemsetAsync(lo, 0xff, hi - lo, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0 && out_size > 0) {
    const int vec_ok = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
    compact_lookback_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
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

// K5a. `keep` (non-zero: gather the table under L2 evict_last; for
// weight_gather a set of bits, 1 ok, 2 emask, 4 w) is the caller's choice
// of the tables that fit L2; `out` is a fresh allocation.
int csr_take_pad_i32(const void* vals, long long n, const void* idx, long long m,
                     int fill, int keep, void* out, void* stream) {
  return launch_take_pad<int>(vals, n, idx, m, fill, keep, out, stream);
}

int csr_take_pad_f32(const void* vals, long long n, const void* idx, long long m,
                     float fill, int keep, void* out, void* stream) {
  return launch_take_pad<float>(vals, n, idx, m, fill, keep, out, stream);
}

int csr_take_pad_b8(const void* vals, long long n, const void* idx, long long m,
                    int fill, int keep, void* out, void* stream) {
  return launch_take_pad<unsigned char>(vals, n, idx, m, static_cast<unsigned char>(fill != 0), keep, out,
                                        stream);
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

int csr_mask_count(const void* mask, long long n, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* p = static_cast<const unsigned char*>(mask);
  long long head = static_cast<long long>((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u);
  if (head > n) head = n;
  unsigned* count = static_cast<unsigned*>(out);
  if (n <= kCountTile) {
    mask_count_kernel<<<1, kThreads, 0, s>>>(p, n, head, count, 1);
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
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = ((n - head) / 16 + kThreads * kCountLoads - 1) / (kThreads * kCountLoads);
  if (blocks > static_cast<long long>(sms) * kCountBlocksPerSm) blocks = static_cast<long long>(sms) * kCountBlocksPerSm;
  mask_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p, n, head, count, 0);
  return static_cast<int>(cudaGetLastError());
}

// `col_ptrs` is a HOST array of `ncols` (<= kMaxCols) device pointers; the
// columns land at [col0, col0 + ncols) of each output row of `stride` ints.
int csr_front_pack(const void* valid, const void* ranks, long long w,
                   const void* col_ptrs, int ncols, int col0, int stride,
                   void* out, void* stream) {
  if (ncols < 0 || ncols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  ColPtrs cols = {};
  const void* const* ptrs = static_cast<const void* const*>(col_ptrs);
  for (int c = 0; c < ncols; ++c) cols.p[c] = static_cast<const int*>(ptrs[c]);
  if (w > 0 && ncols > 0) {
    front_pack_kernel<<<blocks_for(w, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(valid), static_cast<const int*>(ranks), w, cols,
        ncols, col0, stride, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_replay_meta(const void* data, long long w, int ncols, const void* count,
                    const void* overflow, void* out, void* stream) {
  replay_meta_kernel<<<1, kMetaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(data), w, ncols, static_cast<const int*>(count),
      static_cast<const int*>(overflow), static_cast<int*>(out));
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
// may be null; `zero_out` as for csr_bitmap_hop.
int csr_bitmap_hop_csr(const void* indptr, long long nv, const void* nbr, const void* eid,
                       const void* emask, long long ne, const void* frontier, const void* gate,
                       long long c, long long vb, const void* alive, int zero_out, void* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_out && c * vb > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(c * vb), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nv > 0 && c > 0 && vb > 0) {
    const long long groups = (nv + kHopGroup - 1) / kHopGroup;
    long long blocks = (groups + kWarps - 1) / kWarps;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const bool vec = vb % 4 == 0 && (reinterpret_cast<uintptr_t>(frontier) & 3u) == 0 &&
                     (gate == nullptr || (reinterpret_cast<uintptr_t>(gate) & 3u) == 0);
    auto kernel = vec ? bitmap_hop_csr_kernel<true> : bitmap_hop_csr_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int*>(indptr), nv, static_cast<const int*>(nbr),
        static_cast<const int*>(eid), static_cast<const unsigned char*>(emask), ne,
        static_cast<const unsigned char*>(frontier), static_cast<const unsigned char*>(gate), c,
        vb, static_cast<const int*>(alive), static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// `bound`, `emit`, `any` and `count` may be null. `any` ([C] bytes) and
// `count` (one int32) are zeroed here before the pass.
int csr_bitmap_emit(const void* reached, const void* node, const void* bound,
                    long long c, long long vb, void* emit, void* any, void* count,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (any != nullptr && c > 0) {
    e = cudaMemsetAsync(any, 0, static_cast<size_t>(c), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (count != nullptr) {
    e = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
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
  if (b != nullptr && em == nullptr) {
    bitmap_emit_bound_kernel<<<blocks_for(c, kThreads), kThreads, 0, s>>>(r, nd, b, c, vb, an, cn);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = vb % 16 == 0 && aligned16(reached) && aligned16(node) &&
                   (emit == nullptr || aligned16(emit));
  if (vec) {
    bitmap_emit_kernel<true><<<grid_for(n, 16 * kInFlight), kThreads, 0, s>>>(r, nd, b, c, vb, em, an, cn);
  } else {
    bitmap_emit_kernel<false><<<grid_for(n, kInFlight), kThreads, 0, s>>>(r, nd, b, c, vb, em, an, cn);
  }
  return static_cast<int>(cudaGetLastError());
}

// Both bitmaps hold `n` bytes (rows of `vb`); `gate` and `node` (null:
// none) hold `vb`, `bound` (null: none; only with `node`) n / vb int32;
// `count` and `emitted` (one int32 each; `emitted` only with `node`) are
// zeroed here.
int csr_frontier_advance(void* nxt, void* visited, const void* gate, const void* node,
                         const void* bound, long long n, long long vb, void* count,
                         void* emitted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (emitted != nullptr) {
    e = cudaMemsetAsync(emitted, 0, sizeof(unsigned), s);
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
  const bool vec = n % 16 == 0 && aligned16(nxt) && aligned16(visited) &&
                   (gate == nullptr || (vb % 16 == 0 && aligned16(gate))) &&
                   (node == nullptr || (vb % 16 == 0 && aligned16(node)));
  if (vec) {
    frontier_advance_kernel<true><<<grid_for(n, 16 * kInFlight), kThreads, 0, s>>>(x, v, a, nd, b, n, vb, cn, en);
  } else {
    frontier_advance_kernel<false><<<grid_for(n, kInFlight), kThreads, 0, s>>>(x, v, a, nd, b, n, vb, cn, en);
  }
  return static_cast<int>(cudaGetLastError());
}

// `out` holds `nseg` int32 counts; zeroed here first when `zero` is set,
// else the counts add into it.
int csr_rows_with_matches(const void* rows, const void* mask, long long w,
                          long long nseg, int zero, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero && nseg > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, nseg * sizeof(unsigned), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (w > 0 && nseg > 0) {
    rows_with_matches_kernel<<<grid_for(w, 1), kThreads, 0, s>>>(
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
// entries).
int csr_predicate_eval(const void* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PredArgs& a = *static_cast<const PredArgs*>(args);
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  if (a.need < 1 || a.need > kStack) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t limit = cudaFuncSetAttribute(
      predicate_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProgSmem + (kStack - 1) * kPredEntryBytes);
  if (limit != cudaSuccess) return static_cast<int>(limit);
  const long long bytes = a.len * static_cast<long long>(sizeof(int4));
  const int prog_smem = bytes <= kProgSmem ? static_cast<int>(bytes) : 0;
  predicate_eval_kernel<<<grid_for(a.n, kPredV), kThreads,
                          prog_smem + (a.need - 1) * kPredEntryBytes, s>>>(a, prog_smem);
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

// Per row r < `r`, the live window entries j < `w` with a[j] == srcs[r]
// (0 for a padding row): int32 `counts`.
int csr_slab_scan_count(const void* a, const void* live, long long w, const void* srcs,
                        long long r, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (r + kSlabRows - 1) / kSlabRows;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  slab_scan_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(a), static_cast<const unsigned char*>(live), w,
      static_cast<const int*>(srcs), r, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The matches of csr_slab_scan_count in row-major order into `out` slots of
// row / eid / nbr; `offsets` is the exclusive scan of `counts` and `total`
// (device int32) its sum; slots from the total on are -1.
int csr_slab_scan_emit(const void* a, const void* e, const void* live, long long w,
                       const void* srcs, const void* counts, const void* offsets, long long r,
                       const void* total, int base, long long out, void* row, void* eid,
                       void* nbr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = r > out ? r : out;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  slab_scan_emit_kernel<<<grid_for(n, 1), kThreads, 0, s>>>(
      static_cast<const int*>(a), static_cast<const int*>(e),
      static_cast<const unsigned char*>(live), w, static_cast<const int*>(srcs),
      static_cast<const int*>(counts), static_cast<const int*>(offsets), r,
      static_cast<const int*>(total), base, out, static_cast<int*>(row),
      static_cast<int*>(eid), static_cast<int*>(nbr));
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

// K19. `emask`, `gate` and `alive` may be null; `zero_out` as for
// csr_bitmap_hop. `own`, `nbr` and `eid` are the pool's `ns` = P*Wp slots.
int csr_paged_hop(const void* own, const void* nbr, const void* eid, long long ns,
                  const void* emask, long long ne, const void* frontier, const void* gate,
                  long long c, long long vb, const void* alive, int zero_out, void* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_out && c * vb > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(c * vb), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (ns > 0 && c > 0 && vb > 0) {
    paged_hop_kernel<<<grid_for(ns, 1), kThreads, 0, s>>>(
        static_cast<const int*>(own), static_cast<const int*>(nbr),
        static_cast<const int*>(eid), ns, static_cast<const unsigned char*>(emask), ne,
        static_cast<const unsigned char*>(frontier), static_cast<const unsigned char*>(gate), c,
        vb, static_cast<const int*>(alive), static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
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

// K21. `pool_eid` may be null when `out_dir`; `flag` is one byte, zeroed
// here. `ns` is the pool's P*Wp slots.
int csr_paged_expand(const void* indptr, long long nv, const void* srcs, const void* offsets,
                     long long k, const void* total, long long out_size, const void* blockv,
                     const void* pageof, long long nb, const void* estart,
                     const void* pool_nbr, const void* pool_eid, long long ns, long long wp,
                     int out_dir, void* row_out, void* eid_out, void* nbr_out, void* flag,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, 1, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (out_size > 0) {
    paged_expand_kernel<<<blocks_for(out_size, kThreads), kThreads, 0, s>>>(
        static_cast<const int*>(indptr), nv, static_cast<const int*>(srcs),
        static_cast<const int*>(offsets), k, static_cast<const int*>(total), out_size,
        static_cast<const int*>(blockv), static_cast<const int*>(pageof), nb,
        static_cast<const int*>(estart), static_cast<const int*>(pool_nbr),
        static_cast<const int*>(pool_eid), ns, wp, out_dir, static_cast<int*>(row_out),
        static_cast<int*>(eid_out), static_cast<int*>(nbr_out),
        static_cast<unsigned char*>(flag));
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

// K10's eid form (the mesh hop over edge-list slices): K19's slot kernel,
// with act as the owner row, emit as the neighbour and the mask read
// through eid. Arguments as for csr_paged_hop.
int csr_bitmap_hop_eid(const void* act, const void* emit, const void* eid, long long ns,
                       const void* emask, long long ne, const void* frontier, const void* gate,
                       long long c, long long vb, const void* alive, int zero_out, void* out,
                       void* stream) {
  return csr_paged_hop(act, emit, eid, ns, emask, ne, frontier, gate, c, vb, alive, zero_out,
                       out, stream);
}

// K23. `emask` and `w` may be null (every edge / weight 1); `out` ([vb])
// accumulates.
int csr_shard_weight_pass_i32(const void* seg, const void* emit, const void* eid, long long ns,
                              const void* emask, long long ne, const void* ok, const void* w,
                              long long vb, void* out, void* stream) {
  if (ns > 0 && vb > 0) {
    shard_weight_pass_kernel<int><<<grid_for(ns, 1), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(seg), static_cast<const int*>(emit),
        static_cast<const int*>(eid), ns, static_cast<const unsigned char*>(emask), ne,
        static_cast<const unsigned char*>(ok), static_cast<const int*>(w), vb,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_shard_weight_pass_f32(const void* seg, const void* emit, const void* eid, long long ns,
                              const void* emask, long long ne, const void* ok, const void* w,
                              long long vb, void* out, void* stream) {
  if (ns > 0 && vb > 0) {
    shard_weight_pass_kernel<float><<<grid_for(ns, 1), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(seg), static_cast<const int*>(emit),
        static_cast<const int*>(eid), ns, static_cast<const unsigned char*>(emask), ne,
        static_cast<const unsigned char*>(ok), static_cast<const float*>(w), vb,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
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
    rowshard_hop_kernel<<<grid_for(s_local * r * 32, 1), kThreads, 0, s>>>(
        static_cast<const int*>(indptr), r, static_cast<const int*>(dst), emax,
        static_cast<const unsigned char*>(frontier), s_local, q, n_shards * r,
        static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
