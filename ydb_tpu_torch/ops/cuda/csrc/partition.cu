// partition — a stable counting sort of rows by hash partition.
//
// Replaces ydb_tpu/ops/spill.py:_partition_sort's partition ids, counts
// and lax.sort([pkey, iota]) + gathers (the spill feed of the merge
// budget), and the GraceJoin probe routing of
// ydb_tpu/query/executor.py:_partition_block, which compresses the block
// once per partition. Row r goes to partition h[r] % nparts when
// r < *length and to the extra bin nparts otherwise; every column is
// moved to (partition, row) order. Within a bin rows keep their order, so
// the result equals the reference's sort by (pkey, iota), rows past the
// length last, and each partition is one contiguous range.
// Bound on the H100: bytes. Each hash is read once, the ids are written
// once and read twice, each column is read once and written once; the
// histogram and its scan are (nparts + 1) ints per 4,096-row tile.
// Design: a counting sort, not a comparison sort (nparts + 1 <= 257 bins
// fit shared memory). (1) Each block of 4,096 rows computes the ids and
// counts them per bin: each warp walks 512 consecutive rows 32 at a time,
// __match_any_sync groups the lanes of one bin and the group's first lane
// adds its size to the warp's counter of that bin; the block writes its
// per-bin totals bin-major. (2) An exclusive scan over (bin, tile) gives
// each tile its first output row per bin (one block per 8,192 entries,
// with a block over the chunk totals between when there is more than one
// chunk). (3) Each block recounts its warps, turns the counts into each
// warp's first row per bin (tile base plus the warps before it), and
// walks its rows again in the same order: a row's output row is its
// warp's running row for its bin plus the number of lanes of the same bin
// below it. Every column moves in that pass (up to 32 per launch).
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

__global__ void part_hist(int64_t n, const uint64_t* h,
                          const int32_t* length, int nparts, int32_t* ids,
                          int32_t* hist, int64_t ntiles) {
  __shared__ int wcnt[WARPS * MAX_BINS];
  const int nbins = nparts + 1;
  zero_counters(wcnt, nbins);
  const int64_t len = (int64_t)(*length);
  const int64_t base = (int64_t)blockIdx.x * TILE_ROWS;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = base + (int64_t)j * THREADS + threadIdx.x;
    if (r < n)
      ids[r] = r < len ? (int32_t)(h[r] % (uint64_t)nparts) : nparts;
  }
  __syncthreads();
  count_warp_rows(n, ids, wcnt);
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += THREADS) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) s += wcnt[w * MAX_BINS + b];
    hist[(int64_t)b * ntiles + blockIdx.x] = s;
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

__global__ void part_counts(int nparts, const int32_t* offs, int64_t ntiles,
                            int64_t* counts) {
  for (int b = threadIdx.x; b < nparts; b += blockDim.x)
    counts[b] = (int64_t)offs[(int64_t)(b + 1) * ntiles] -
                (int64_t)offs[(int64_t)b * ntiles];
}

__global__ void part_scatter(int64_t n, const int32_t* ids,
                             const int32_t* offs, int64_t ntiles, int nparts,
                             Cols cols) {
  __shared__ int wcnt[WARPS * MAX_BINS];
  const int nbins = nparts + 1;
  zero_counters(wcnt, nbins);
  __syncthreads();
  count_warp_rows(n, ids, wcnt);
  __syncthreads();
  // each warp's first output row per bin: the tile's base for the bin
  // plus the rows of that bin in the warps before it
  for (int b = threadIdx.x; b < nbins; b += THREADS) {
    int run = offs[(int64_t)b * ntiles + blockIdx.x];
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w * MAX_BINS + b];
      wcnt[w * MAX_BINS + b] = run;
      run += c;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * TILE_ROWS +
                     (int64_t)warp * WARP_ROWS;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = w0 + j * 32 + lane;
    const bool in = r < n;
    const unsigned act = __ballot_sync(FULL, in);
    int id = 0;
    unsigned peers = 0;
    if (in) {
      id = ids[r];
      peers = __match_any_sync(act, id);
      const int64_t dst = (int64_t)wcnt[warp * MAX_BINS + id] +
                          __popc(peers & ((1u << lane) - 1u));
      for (int c = 0; c < cols.n_cols; ++c)
        copy_elem(cols.src[c], cols.dst[c], cols.size[c], r, dst);
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1)
      wcnt[warp * MAX_BINS + id] += __popc(peers);
    __syncwarp();
  }
}

// count_pass: compute ids, the histogram, its scan and the counts (the
// first launch of a call); later launches move more columns with them.
extern "C" int partition_launch(int64_t n, const void* hashes,
                                const void* length, int nparts, void* ids,
                                void* hist, void* offs, void* chunk_sums,
                                void* counts, int n_cols,
                                const int64_t* src_ptrs,
                                const int64_t* dst_ptrs,
                                const int32_t* sizes, int count_pass,
                                void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || nparts < 1 ||
      nparts > MAX_BINS - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) {
    if (count_pass)
      return (int)cudaMemsetAsync(counts, 0, sizeof(int64_t) * nparts, s);
    return (int)cudaSuccess;
  }
  const int64_t ntiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const int64_t e = (int64_t)(nparts + 1) * ntiles;
  const int64_t nchunks = (e + SCAN_CHUNK - 1) / SCAN_CHUNK;
  cudaError_t err;
  if (count_pass) {
    part_hist<<<(unsigned)ntiles, THREADS, 0, s>>>(
        n, (const uint64_t*)hashes, (const int32_t*)length, nparts,
        (int32_t*)ids, (int32_t*)hist, ntiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int32_t* base = nullptr;
    if (nchunks > 1) {
      scan_reduce<<<(unsigned)nchunks, SCAN_THREADS, 0, s>>>(
          e, (const int32_t*)hist, (int32_t*)chunk_sums);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      scan_top<<<1, SCAN_THREADS, 0, s>>>(nchunks, (int32_t*)chunk_sums);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      base = (const int32_t*)chunk_sums;
    }
    scan_apply<<<(unsigned)nchunks, SCAN_THREADS, 0, s>>>(
        e, (const int32_t*)hist, base, (int32_t*)offs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    part_counts<<<1, THREADS, 0, s>>>(nparts, (const int32_t*)offs, ntiles,
                                      (int64_t*)counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (n_cols == 0) return (int)cudaSuccess;
  Cols cols;
  cols.n_cols = n_cols;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < n_cols;
    cols.src[c] = on ? (const void*)src_ptrs[c] : nullptr;
    cols.dst[c] = on ? (void*)dst_ptrs[c] : nullptr;
    cols.size[c] = on ? sizes[c] : 8;
  }
  part_scatter<<<(unsigned)ntiles, THREADS, 0, s>>>(
      n, (const int32_t*)ids, (const int32_t*)offs, ntiles, nparts, cols);
  return (int)cudaGetLastError();
}
