// bin_scan — the counting-sort machinery shared by segments.cu and
// bucket_sort.cu: rows binned by an id, counted per 4,096-row tile and per
// warp with __match_any_sync, the (bin, tile) counts scanned into each
// tile's first output row per bin, and a stable second pass that moves
// every column to its row. The sources that include it say what bounds
// them and why.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 16
#define WARP_ROWS (32 * ITEMS)
#define TILE_ROWS (THREADS * ITEMS)
#define MAX_BINS 257
#define MAX_COLS 32
#define SCAN_THREADS 1024
#define SCAN_ITEMS 8
#define SCAN_CHUNK (SCAN_THREADS * SCAN_ITEMS)
#define FULL 0xffffffffu

struct Cols {
  int n_cols;
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];          // bytes per element: 1, 2, 4 or 8
};

__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int size, int64_t from,
                                          int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from]; break;
    case 2: ((uint16_t*)dst)[to] = ((const uint16_t*)src)[from]; break;
    case 4: ((uint32_t*)dst)[to] = ((const uint32_t*)src)[from]; break;
    default: ((uint64_t*)dst)[to] = ((const uint64_t*)src)[from]; break;
  }
}

__device__ __forceinline__ void zero_counters(int* wcnt, int nbins) {
  for (int i = threadIdx.x; i < WARPS * nbins; i += THREADS)
    wcnt[(i / nbins) * MAX_BINS + i % nbins] = 0;
}

// Adds each warp's rows of this tile to its per-bin counters wcnt[warp].
__device__ __forceinline__ void count_warp_rows(int64_t n,
                                                const int32_t* ids,
                                                int* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * TILE_ROWS +
                     (int64_t)warp * WARP_ROWS;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = w0 + j * 32 + lane;
    const bool in = r < n;
    const unsigned act = __ballot_sync(FULL, in);
    if (in) {
      const int id = ids[r];
      const unsigned peers = __match_any_sync(act, id);
      if (lane == __ffs(peers) - 1)
        wcnt[warp * MAX_BINS + id] += __popc(peers);
    }
    __syncwarp();
  }
}

// Exclusive scan of v across the block; *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = SCAN_THREADS / 32;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[nw - 1];
  __syncthreads();
  return excl;
}

__global__ void scan_reduce(int64_t e, const int32_t* in,
                            int32_t* chunk_sums) {
  __shared__ int warp_sums[32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_CHUNK +
                       (int64_t)threadIdx.x * SCAN_ITEMS;
  int s = 0;
  for (int i = 0; i < SCAN_ITEMS; ++i)
    if (base + i < e) s += in[base + i];
  int total;
  block_exclusive_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) chunk_sums[blockIdx.x] = total;
}

// One block: exclusive scan of the chunk totals, in place.
__global__ void scan_top(int64_t nchunks, int32_t* chunk_sums) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int64_t base = 0; base < nchunks; base += SCAN_THREADS) {
    const int64_t i = base + threadIdx.x;
    const int v = i < nchunks ? chunk_sums[i] : 0;
    int total;
    const int excl = block_exclusive_scan(v, warp_sums, &total);
    if (i < nchunks) chunk_sums[i] = carry + excl;
    carry += total;
  }
}

__global__ void scan_apply(int64_t e, const int32_t* in,
                           const int32_t* chunk_base, int32_t* out) {
  __shared__ int warp_sums[32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_CHUNK +
                       (int64_t)threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int s = 0;
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    v[i] = base + i < e ? in[base + i] : 0;
    s += v[i];
  }
  int total;
  int run = block_exclusive_scan(s, warp_sums, &total) +
            (chunk_base != nullptr ? chunk_base[blockIdx.x] : 0);
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    if (base + i < e) out[base + i] = run;
    run += v[i];
  }
}


// Exclusive scan of the bin-major (bin, tile) histogram `hist` (e entries)
// into `offs`: each (bin, tile) gets its first output row. One block per
// SCAN_CHUNK entries, with one block over the chunk totals between when
// there is more than one chunk.
static cudaError_t scan_bins(int64_t e, const int32_t* hist, int32_t* offs,
                             int32_t* chunk_sums, cudaStream_t s) {
  const int64_t nchunks = (e + SCAN_CHUNK - 1) / SCAN_CHUNK;
  cudaError_t err;
  const int32_t* base = nullptr;
  if (nchunks > 1) {
    scan_reduce<<<(unsigned)nchunks, SCAN_THREADS, 0, s>>>(e, hist,
                                                          chunk_sums);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scan_top<<<1, SCAN_THREADS, 0, s>>>(nchunks, chunk_sums);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    base = chunk_sums;
  }
  scan_apply<<<(unsigned)nchunks, SCAN_THREADS, 0, s>>>(e, hist, base, offs);
  return cudaGetLastError();
}
