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
  const T start = prefix + warp_off;
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
      uint4* dst = reinterpret_cast<uint4*>(out + e0);
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        dst[q] = make_uint4(lb_bits(y[4 * q]), lb_bits(y[4 * q + 1]), lb_bits(y[4 * q + 2]),
                            lb_bits(y[4 * q + 3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (e0 + j < n) out[e0 + j] = y[j];
      }
    }
  }
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
// into [0, V-1] before indexing, where jnp.take would clip silently.
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
// K2b: gather_expand (replaces csr.gather_expand :54).
// Bound: srcs, offsets and indptr read once per source (12 bytes each), one
// neighbour read per live slot, three int32 outputs per slot written.
// Design: one thread per output slot finds its source row by binary search
// (upper bound) over the exclusive offsets, log2(K) dependent reads that
// hit L2 for the frontier sizes of the path. The TPU's scatter+cumsum rank
// search avoided serial gathers on the TPU's vector unit; a GPU thread does
// a binary search cheaply. Every clip of the reference is kept: an
// out-of-range index here is a sticky device fault.
// ---------------------------------------------------------------------------
__global__ void gather_expand_kernel(const int* __restrict__ indptr, long long nv,
                                     const int* __restrict__ nbrs, long long ne,
                                     const int* __restrict__ srcs,
                                     const int* __restrict__ offsets, long long k,
                                     const int* __restrict__ total,
                                     long long out_size, int* __restrict__ row_out,
                                     int* __restrict__ pos_out,
                                     int* __restrict__ nbr_out) {
  long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= out_size) return;
  if (p >= static_cast<long long>(*total) || k == 0) {
    row_out[p] = -1;
    pos_out[p] = -1;
    nbr_out[p] = -1;
    return;
  }
  long long lo = 0, hi = k;  // first row whose offset is > p
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(offsets[mid]) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  long long r = lo > 0 ? lo - 1 : 0;  // clip(row, 0, K-1)
  int src = srcs[r];
  long long s = src < 0 ? 0 : src;  // clip(src, 0, V-1)
  if (s > nv - 1) s = nv - 1;
  if (s < 0) s = 0;
  int edge_pos = indptr[s] + static_cast<int>(p - offsets[r]);
  int nbr = -1;
  if (ne > 0) {
    long long c = edge_pos < 0 ? 0 : edge_pos;  // clip(edge_pos, 0, E-1)
    if (c > ne - 1) c = ne - 1;
    nbr = nbrs[c];
  }
  row_out[p] = static_cast<int>(r);
  pos_out[p] = edge_pos;
  nbr_out[p] = nbr;
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
// Bound: E*4 bytes of values + (V+1)*4 of indptr read, out_size*4 written
// (80M int32 into 2^23: ~0.37 GB, ~0.11 ms).
// Design: one warp per segment strides over its CSR slice
// [indptr[v], indptr[v+1]) with coalesced loads and reduces by shuffles.
// No atomics, so a float32 sum has one fixed order per segment (it differs
// from a sequential CPU sum). Segments past V are zero-padded to out_size.
// The reference's scan-and-difference gives the same int32 sums mod 2^32.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ vals, long long ne,
                                   const int* __restrict__ indptr, long long nseg,
                                   long long out_size, T* __restrict__ out) {
  long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= out_size) return;  // uniform across the warp
  T acc = T(0);
  if (w < nseg) {
    long long b = indptr[w];
    long long e = indptr[w + 1];
    if (b < 0) b = 0;
    if (e > ne) e = ne;
    for (long long i = b + lane; i < e; i += 32) acc += vals[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
  if (lane == 0) out[w] = acc;
}

// ---------------------------------------------------------------------------
// K5a: take_pad (replaces csr.take_pad :211).
// Bound: m*4 bytes of indices read, one value read per index >= 0, m values
// written. One thread per index; indices past the end clip to the last
// value as the reference's clip does; negative indices give `fill`.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void take_pad_kernel(const T* __restrict__ vals, long long n,
                                const int* __restrict__ idx, long long m, T fill,
                                T* __restrict__ out) {
  long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= m) return;
  int i = idx[j];
  if (i < 0 || n == 0) {
    out[j] = fill;
    return;
  }
  out[j] = vals[i < n ? i : n - 1];
}

// ---------------------------------------------------------------------------
// K5b: mask_count (replaces csr.mask_count :222).
// Bound: n bytes read, 4 written. Grid-stride popcount per thread, warp
// shuffle reduction, one integer atomicAdd per warp (integer adds commute,
// so the count is exact and deterministic).
// ---------------------------------------------------------------------------
__global__ void mask_count_kernel(const unsigned char* __restrict__ mask, long long n,
                                  unsigned* __restrict__ out) {
  unsigned c = 0;
  long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    c += mask[i] ? 1u : 0u;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(out, c);
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
// Bound: bytes. Each slot reads its id (4 bytes, none in identity mode), a
// value and a presence byte for each column the program reads (a random
// gather where the ids are random), the slot's binding rows, and writes one
// byte; a distance() slot does ~40 float operations and four transcendental
// calls, far under the card's float32 rate.
// Design: a grid-stride loop, one slot a thread; the block copies the program
// into shared memory once (when it fits in 48 KB; else it is read from device
// memory through the read-only cache), and every thread then runs the same
// instruction sequence, so control flow never diverges — only the gathers are
// data-dependent. The stack's top entry lives in registers, the presence
// bits below it in one register and their values in a per-thread array of
// kStack (local memory); the compiler orders each subtree deeper-operand-first and splits whatever still
// needs more into earlier launches (a split's values and presence come back
// through TMP). Every per-call pointer and scalar is a launch argument (a
// __grid_constant__ struct, indexed in place), so a captured CUDA graph bakes
// them per launch; parameters are always read from
// device memory. Arithmetic follows the reference: int32 in uint32 (wraps),
// float32 one IEEE operation at a time (the _rn intrinsics: no FMA
// contraction), floor modulo, division and modulo by zero absent.
// ---------------------------------------------------------------------------
constexpr int kStack = 16;     // per-thread value stack (PRED_STACK)
constexpr int kMaxBufs = 32;   // buffers a launch reads (PRED_BUFS)
constexpr int kProgSmem = 48 * 1024;

enum PredOp : int {
  kCol = 1, kBCol = 2, kConst = 3, kParam = 4, kDepth = 5, kTmp = 6, kI2F = 7, kNeg = 8,
  kArith = 9, kCmp = 10, kTable = 11, kTruthy = 12, kIsNull = 13, kAnd = 14, kOr = 15,
  kNot = 16, kMask = 17, kClass = 18, kValid = 19, kDist = 20, kId = 21,
};

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
  const void* buf[kMaxBufs];
  long long blen[kMaxBufs];
};

// The padding-safe gather of take_pad: a negative index or an empty column
// reads absent (value 0), an index past the end reads the last element.
// Ids and column lengths are int32 (a column is indexed by int32 ids).
__device__ __forceinline__ bool pred_gather(const PredArgs& a, int vbuf, int pbuf, int i,
                                            unsigned* v) {
  const int len = static_cast<int>(a.blen[vbuf]);
  if (i < 0 || len == 0) {
    *v = 0u;
    return false;
  }
  const int j = i < len ? i : len - 1;
  *v = static_cast<const unsigned*>(a.buf[vbuf])[j];
  return static_cast<const unsigned char*>(a.buf[pbuf])[j] != 0;
}

__device__ __forceinline__ float as_f(unsigned v) { return __uint_as_float(v); }
__device__ __forceinline__ unsigned as_u(float f) { return __float_as_uint(f); }

__device__ __forceinline__ unsigned pred_arith(int op, int kind, unsigned x, unsigned y,
                                               bool* ok) {
  if (kind) {
    const float fx = as_f(x), fy = as_f(y);
    switch (op) {
      case 0: return as_u(__fadd_rn(fx, fy));
      case 1: return as_u(__fsub_rn(fx, fy));
      case 2: return as_u(__fmul_rn(fx, fy));
      case 3: {
        *ok = fy != 0.0f;
        return as_u(__fdiv_rn(fx, *ok ? fy : 1.0f));
      }
      default: {
        *ok = fy != 0.0f;
        const float d = *ok ? fy : 1.0f;
        float m = fmodf(fx, d);
        if (m != 0.0f && ((d < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, d);
        return as_u(m);
      }
    }
  }
  switch (op) {
    case 0: return x + y;
    case 1: return x - y;
    case 2: return x * y;
    default: {  // floor modulo (division is always float32)
      const int ix = static_cast<int>(x), iy = static_cast<int>(y);
      *ok = iy != 0;
      if (iy == 0 || iy == -1) return 0u;  // x mod -1 = 0; INT_MIN % -1 traps
      int m = ix % iy;
      if (m != 0 && ((iy < 0) != (m < 0))) m += iy;
      return static_cast<unsigned>(m);
    }
  }
}

__device__ __forceinline__ bool pred_cmp(int op, int kind, unsigned x, unsigned y) {
  if (kind) {
    const float fx = as_f(x), fy = as_f(y);
    switch (op) {
      case 0: return fx == fy;
      case 1: return fx != fy;
      case 2: return fx < fy;
      case 3: return fx <= fy;
      case 4: return fx > fy;
      default: return fx >= fy;
    }
  }
  const int ix = static_cast<int>(x), iy = static_cast<int>(y);
  switch (op) {
    case 0: return ix == iy;
    case 1: return ix != iy;
    case 2: return ix < iy;
    case 3: return ix <= iy;
    case 4: return ix > iy;
    default: return ix >= iy;
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
    predicate_eval_kernel(const __grid_constant__ PredArgs a, int smem) {
  extern __shared__ int4 sprog[];
  const int4* prog = a.prog;
  if (smem) {
    for (long long i = threadIdx.x; i < a.len; i += blockDim.x) sprog[i] = a.prog[i];
    __syncthreads();
    prog = sprog;
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const int len = static_cast<int>(a.len);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += step) {
    const int id = a.ids ? a.ids[i] : (i < a.n_valid ? static_cast<int>(a.base + i) : -1);
    // the top entry lives in registers (tv, tp); the values below it in
    // sv[0..d] (sv[0] the empty stack's placeholder), their presence bits in
    // spm (bit 0: the entry just below the top)
    unsigned sv[kStack];
    unsigned spm = 0u;
    int d = -1;
    unsigned tv = 0u;
    bool tp = false;
    for (int pc = 0; pc < len; ++pc) {
      const int4 ins = smem ? prog[pc] : __ldg(prog + pc);
      const int op = ins.x;
      if (op <= kTmp || op == kMask || op == kClass || op == kValid || op == kId) {  // pushes
        sv[++d] = tv;
        spm = (spm << 1) | (tp ? 1u : 0u);
        switch (op) {
          case kCol: tp = pred_gather(a, ins.y, ins.z, id, &tv); break;
          case kBCol:
            tp = pred_gather(a, ins.y, ins.z, static_cast<const int*>(a.buf[ins.w])[i], &tv);
            break;
          case kConst: tv = static_cast<unsigned>(ins.y); tp = ins.z != 0; break;
          case kParam: tv = static_cast<unsigned>(a.params[ins.y]); tp = true; break;
          case kDepth: tv = static_cast<unsigned>(a.depth); tp = true; break;
          case kTmp:
            tv = static_cast<const unsigned*>(a.buf[ins.y])[i];
            tp = static_cast<const unsigned char*>(a.buf[ins.z])[i] != 0;
            break;
          case kMask: tv = 0u; tp = ins.y != 0; break;
          case kClass: {
            const int nc = static_cast<int>(a.blen[ins.y]), nt = static_cast<int>(a.blen[ins.z]);
            bool m = false;
            if (id >= 0 && nc > 0) {
              const int cls = static_cast<const int*>(a.buf[ins.y])[id < nc ? id : nc - 1];
              if (cls >= 0 && nt > 0) {
                m = static_cast<const unsigned char*>(a.buf[ins.z])[cls < nt ? cls : nt - 1] != 0;
              }
            }
            tv = 0u;
            tp = m;
            break;
          }
          case kId: tv = static_cast<unsigned>(id); tp = id >= 0; break;
          default: tv = 0u; tp = id >= 0; break;  // kValid
        }
        continue;
      }
      switch (op) {
        case kI2F: tv = as_u(__int2float_rn(static_cast<int>(tv))); break;
        case kNeg: tv = ins.z ? (tv ^ 0x80000000u) : (0u - tv); break;
        case kArith: {
          unsigned x = sv[d--], y = tv;
          bool px = spm & 1u, py = tp;
          spm >>= 1;
          if (ins.w) { unsigned t = x; x = y; y = t; bool q = px; px = py; py = q; }
          bool ok = true;
          tv = pred_arith(ins.y, ins.z, x, y, &ok);
          tp = px && py && ok;
          break;
        }
        case kCmp: {
          unsigned x = sv[d--], y = tv;
          const bool both = (spm & 1u) && tp;
          spm >>= 1;
          if (ins.w) { unsigned t = x; x = y; y = t; }
          tp = both && pred_cmp(ins.y, ins.z, x, y);
          tv = 0u;
          break;
        }
        case kTable: {
          const int n = static_cast<int>(a.blen[ins.y]);
          const int c = static_cast<int>(tv);
          const int j = c < 0 ? 0 : (c >= n ? n - 1 : c);
          tp = tp && n > 0 && static_cast<const unsigned char*>(a.buf[ins.y])[j] != 0;
          tv = 0u;
          break;
        }
        case kTruthy:
          tp = tp && (ins.z ? as_f(tv) != 0.0f : tv != 0u);
          tv = 0u;
          break;
        case kIsNull: tp = ins.y ? tp : !tp; tv = 0u; break;
        case kAnd: tp = (spm & 1u) && tp; spm >>= 1; --d; break;
        case kOr: tp = (spm & 1u) || tp; spm >>= 1; --d; break;
        case kNot: tp = !tp; break;
        case kDist: {
          const bool p = (spm & 7u) == 7u && tp;
          tv = as_u(pred_haversine(as_f(sv[d - 2]), as_f(sv[d - 1]), as_f(sv[d]), as_f(tv),
                                   __int_as_float(ins.y)));
          tp = p;
          spm >>= 3;
          d -= 3;
          break;
        }
        default: break;
      }
    }
    a.out_p[i] = tp ? 1 : 0;
    if (a.out_v) a.out_v[i] = static_cast<int>(tv);
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

int csr_gather_expand(const void* indptr, long long nv, const void* nbrs,
                      long long ne, const void* srcs, const void* offsets,
                      long long k, const void* total, long long out_size,
                      void* row_out, void* pos_out, void* nbr_out, void* stream) {
  if (out_size > 0) {
    gather_expand_kernel<<<blocks_for(out_size, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), nv, static_cast<const int*>(nbrs), ne,
        static_cast<const int*>(srcs), static_cast<const int*>(offsets), k,
        static_cast<const int*>(total), out_size, static_cast<int*>(row_out),
        static_cast<int*>(pos_out), static_cast<int*>(nbr_out));
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

int csr_segment_sum_i32(const void* vals, long long ne, const void* indptr,
                        long long nseg, long long out_size, void* out,
                        void* stream) {
  if (out_size > 0) {
    segment_sum_kernel<unsigned><<<blocks_for(out_size, kWarps), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(vals), ne, static_cast<const int*>(indptr),
        nseg, out_size, static_cast<unsigned*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_segment_sum_f32(const void* vals, long long ne, const void* indptr,
                        long long nseg, long long out_size, void* out,
                        void* stream) {
  if (out_size > 0) {
    segment_sum_kernel<float><<<blocks_for(out_size, kWarps), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), ne, static_cast<const int*>(indptr),
        nseg, out_size, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_take_pad_i32(const void* vals, long long n, const void* idx, long long m,
                     int fill, void* out, void* stream) {
  if (m > 0) {
    take_pad_kernel<int><<<blocks_for(m, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vals), n, static_cast<const int*>(idx), m, fill,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_take_pad_f32(const void* vals, long long n, const void* idx, long long m,
                     float fill, void* out, void* stream) {
  if (m > 0) {
    take_pad_kernel<float><<<blocks_for(m, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), n, static_cast<const int*>(idx), m, fill,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_take_pad_b8(const void* vals, long long n, const void* idx, long long m,
                    int fill, void* out, void* stream) {
  if (m > 0) {
    take_pad_kernel<unsigned char><<<blocks_for(m, kThreads), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(vals), n, static_cast<const int*>(idx),
        m, static_cast<unsigned char>(fill != 0), static_cast<unsigned char*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int csr_mask_count(const void* mask, long long n, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    mask_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const unsigned char*>(mask), n, static_cast<unsigned*>(out));
  }
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
// value, so a captured graph keeps this launch's pointers and scalars.
int csr_predicate_eval(const void* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PredArgs& a = *static_cast<const PredArgs*>(args);
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  const long long bytes = a.len * static_cast<long long>(sizeof(int4));
  const int smem = bytes <= kProgSmem ? static_cast<int>(bytes) : 0;
  predicate_eval_kernel<<<grid_for(a.n, 1), kThreads, smem, s>>>(a, smem);
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
