// bin_scan — the counting-sort machinery of bucket_sort.cu (its only
// user): the tile and warp shape of its per-tile, per-warp bin counts,
// their counters, and the exclusive scan of the (bin, tile) counts into
// each tile's first output row per bin. bucket_sort.cu says what bounds
// it and why.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 16
#define WARP_ROWS (32 * ITEMS)
#define TILE_ROWS (THREADS * ITEMS)
#define MAX_BINS 257
#define SCAN_THREADS 1024
#define SCAN_ITEMS 8
#define SCAN_CHUNK (SCAN_THREADS * SCAN_ITEMS)
#define FULL 0xffffffffu

__device__ __forceinline__ void zero_counters(int* wcnt, int nbins) {
  for (int i = threadIdx.x; i < WARPS * nbins; i += THREADS)
    wcnt[(i / nbins) * MAX_BINS + i % nbins] = 0;
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
