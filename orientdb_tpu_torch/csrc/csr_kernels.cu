// Hand-written Hopper (sm_90a) kernels for the CSR primitives of the
// compiled MATCH path. Port of the jitted functions of
// orientdb_tpu/ops/csr.py; the wrappers are in orientdb_tpu_torch/ops/csr.py
// and bind these functions through ctypes (orientdb_tpu_torch/ops/_kernels.py).
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
// algorithm allows it, no atomics where the order of a float sum matters.
// int32 sums are taken in uint32 so that overflow wraps modulo 2^32 as the
// reference's int32 arithmetic does (signed overflow is undefined in C++).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                   // scan items per thread
constexpr long long kTile = kThreads * kItems;  // scan elements per block
constexpr unsigned kFull = 0xffffffffu;

inline unsigned blocks_for(long long n, long long per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// ---------------------------------------------------------------------------
// K1: inclusive / exclusive prefix sum (replaces csr.value_cumsum :129,
// csr.mask_cumsum :97, csr._block_scan_f32 :118, csr.exclusive_cumsum :47).
//
// Bound: n*4 bytes read + n*4 bytes written (80M int32: 640 MB, ~0.19 ms).
// Design: reduce-then-scan in three launches per level. (1) each block sums
// its tile of kTile elements; (2) the tile sums are scanned, recursively, by
// the same routine; (3) each block scans its tile in shared memory and adds
// the scanned sum of the tiles before it. Reads 2n, writes n: within 1.5x of
// the one-pass bound, with no inter-block communication. The TPU version's
// triangular matmul on 16-bit halves was a way to use the systolic array;
// int32 adds are exact here, so only its result is ported.
// ---------------------------------------------------------------------------

// Exclusive scan of one value per thread across the block; every thread
// gets the sum of the values of the threads before it.
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

template <typename T>
__global__ void tile_sums_kernel(const T* __restrict__ in, long long n,
                                 T* __restrict__ sums) {
  __shared__ T warp_sums[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    long long i = base + k * kThreads + threadIdx.x;
    if (i < n) acc += in[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    T w = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
    if (threadIdx.x == 0) sums[blockIdx.x] = w;
  }
}

// Scan of one tile per block. `tile_prefix` (may be null) holds the
// inclusive scan of the tile sums: tile b adds tile_prefix[b-1]. `in` and
// `out` may alias: a block reads its whole tile before writing it.
template <typename T>
__global__ void tile_scan_kernel(const T* in, T* out, long long n,
                                 const T* __restrict__ tile_prefix,
                                 int exclusive) {
  __shared__ T tile[kTile];
  __shared__ T warp_sums[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int j = k * kThreads + threadIdx.x;
    long long i = base + j;
    tile[j] = i < n ? in[i] : T(0);
  }
  __syncthreads();
  T local[kItems];
  T run = T(0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    local[k] = run;  // exclusive within this thread's items
    run += tile[threadIdx.x * kItems + k];
  }
  T prefix = block_exclusive_scan(run, warp_sums);
  if (tile_prefix != nullptr && blockIdx.x > 0) {
    prefix += tile_prefix[blockIdx.x - 1];
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int j = threadIdx.x * kItems + k;
    T x = tile[j];
    tile[j] = exclusive ? prefix + local[k] : prefix + (local[k] + x);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int j = k * kThreads + threadIdx.x;
    long long i = base + j;
    if (i < n) out[i] = tile[j];
  }
}

template <typename T>
cudaError_t scan_rec(const T* in, T* out, long long n, T* scratch,
                     int exclusive, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles == 1) {
    tile_scan_kernel<T><<<1, kThreads, 0, s>>>(in, out, n, nullptr, exclusive);
    return cudaGetLastError();
  }
  T* sums = scratch;
  tile_sums_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(in, n, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = scan_rec<T>(sums, sums, tiles, scratch + tiles, 0, s);
  if (e != cudaSuccess) return e;
  tile_scan_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, out, n, sums, exclusive);
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
// Bound: n bytes of mask read, out_size*4 bytes written (the scan of the
// mask is K1 and counted there).
// Design: after K1's inclusive scan of the mask, each True position i with
// rank r <= out_size writes i to slot r-1, and every slot at or past the
// count is -1. One result covers both of the reference's regimes (nonzero
// and prefix sum + searchsorted), truncation to the first out_size
// included. One launch over max(n, out_size) threads.
// ---------------------------------------------------------------------------
__global__ void compact_scatter_kernel(const unsigned char* __restrict__ mask,
                                       const int* __restrict__ ranks, long long n,
                                       long long out_size, int* __restrict__ out) {
  long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n && mask[t]) {
    long long r = ranks[t];
    if (r <= out_size) out[r - 1] = static_cast<int>(t);
  }
  if (t < out_size) {
    long long count = n > 0 ? static_cast<long long>(ranks[n - 1]) : 0;
    if (t >= count) out[t] = -1;
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

}  // namespace

extern "C" {

// Scratch elements (of the scan's type) that csr_scan_* needs for n inputs:
// one tile sum per tile at every level above the last.
long long csr_scan_scratch(long long n) {
  long long total = 0;
  while (n > kTile) {
    n = (n + kTile - 1) / kTile;
    total += n;
  }
  return total;
}

int csr_scan_i32(const void* in, void* out, long long n, void* scratch,
                 int exclusive, void* stream) {
  return static_cast<int>(scan_rec<unsigned>(
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out), n,
      static_cast<unsigned*>(scratch), exclusive,
      static_cast<cudaStream_t>(stream)));
}

int csr_scan_f32(const void* in, void* out, long long n, void* scratch,
                 int exclusive, void* stream) {
  return static_cast<int>(scan_rec<float>(
      static_cast<const float*>(in), static_cast<float*>(out), n,
      static_cast<float*>(scratch), exclusive, static_cast<cudaStream_t>(stream)));
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

int csr_compact_scatter(const void* mask, const void* ranks, long long n,
                        long long out_size, void* out, void* stream) {
  long long threads = n > out_size ? n : out_size;
  if (threads > 0) {
    compact_scatter_kernel<<<blocks_for(threads, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(mask), static_cast<const int*>(ranks),
        n, out_size, static_cast<int*>(out));
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

}  // extern "C"
