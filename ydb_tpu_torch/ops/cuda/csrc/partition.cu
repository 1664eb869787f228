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
#include "bin_scan.cuh"

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
  cudaError_t err;
  if (count_pass) {
    part_hist<<<(unsigned)ntiles, THREADS, 0, s>>>(
        n, (const uint64_t*)hashes, (const int32_t*)length, nparts,
        (int32_t*)ids, (int32_t*)hist, ntiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = scan_bins(e, (const int32_t*)hist, (int32_t*)offs,
                         (int32_t*)chunk_sums, s)) != cudaSuccess)
      return (int)err;
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
