// segments — the send segments of one shard's rows for a mesh exchange.
//
// Replaces ydb_tpu/parallel/collective.py:38 bucket_of and :56
// bucket_segments (one compress per target device) in one pass. Row r
// goes to target t = hash(keys[r]) % ndev as uint64, where hash is
// splitmix64 of each key as int64 (float keys converted as XLA converts:
// truncated, NaN 0, out-of-range values saturated), zeroed where the key
// is NULL, folded from the left by hash_combine (hash64.cuh, the same
// functions as hash64.cu). Rows r >= *length belong to no target. Each
// live row gets its rank among the earlier rows of its target (stable),
// and every column's value goes to segment[t][rank] when rank < seg.
// counts[t] = min(count_t, seg) and *overflow = any(count_t > seg). Slots
// past a segment's count are zero (a valid slot false). A caller may give
// the targets (`targets_in`) instead of the keys, and may ask for every
// row's target (`targets_out`, rows past the length included: what
// bucket_of returns).
// Bound on the H100: bytes. The keys are read once and each column is
// read once; each segment slot is written once (a live row by the
// scatter, the rest by the tail pass); the ids are written once and read
// twice; the histogram is (ndev + 1) ints per 4,096-row tile. The hash is
// a few multiplies and shifts per key, far below the integer rate.
// Design: partition.cu's counting sort (bin_scan.cuh): per-tile, per-warp
// counts with __match_any_sync, an exclusive scan over (target, tile), a
// stable second pass; a row's rank within its target is its (target,
// tile) offset less the target's first offset. What differs is the fixed
// [ndev, seg] layout, the clamp to seg and the overflow flag, and the
// tail pass that zeroes the slots past each count, so no output is
// cleared before the scatter.
#include "bin_scan.cuh"
#include "hash64.cuh"

#define MAX_KEYS 16

struct Keys {
  int n;
  const void* k[MAX_KEYS];
  const bool* v[MAX_KEYS];
  int kind[MAX_KEYS];          // 0 int64, 1 int32, 2 float64
};

// int64(x) as XLA converts a double: truncation toward zero, NaN to 0,
// values at or past +-2^63 saturated.
__device__ __forceinline__ int64_t f64_to_i64(double x) {
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return INT64_MAX;
  if (x <= -9223372036854775808.0) return INT64_MIN;
  return (int64_t)x;
}

__device__ __forceinline__ int target_of(const Keys& K, int64_t r,
                                         int ndev) {
  uint64_t h = 0;
  for (int j = 0; j < K.n; ++j) {
    int64_t k;
    switch (K.kind[j]) {
      case 1: k = ((const int32_t*)K.k[j])[r]; break;
      case 2: k = f64_to_i64(((const double*)K.k[j])[r]); break;
      default: k = ((const int64_t*)K.k[j])[r]; break;
    }
    uint64_t x = splitmix64((uint64_t)k);
    if (K.v[j] != nullptr && !K.v[j][r]) x = 0;
    h = j == 0 ? x : hash_combine(h, x);
  }
  return (int)(h % (uint64_t)ndev);
}

__global__ void seg_hist(int64_t n, Keys K, const int32_t* targets_in,
                         const int32_t* length, int ndev, int32_t* ids,
                         int32_t* targets_out, int32_t* hist,
                         int64_t ntiles) {
  __shared__ int wcnt[WARPS * MAX_BINS];
  const int nbins = ndev + 1;
  zero_counters(wcnt, nbins);
  const int64_t len = (int64_t)(*length);
  const int64_t base = (int64_t)blockIdx.x * TILE_ROWS;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = base + (int64_t)j * THREADS + threadIdx.x;
    if (r >= n) continue;
    const int t = targets_in != nullptr ? targets_in[r]
                                        : target_of(K, r, ndev);
    if (targets_out != nullptr) targets_out[r] = t;
    ids[r] = r < len && t >= 0 && t < ndev ? t : ndev;
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

// counts clamped to seg, and the overflow flag (one block)
__global__ void seg_counts(int ndev, const int32_t* offs, int64_t ntiles,
                           int seg, int32_t* counts, bool* overflow) {
  __shared__ int any;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < ndev; t += blockDim.x) {
    const int c = offs == nullptr
                      ? 0
                      : offs[(int64_t)(t + 1) * ntiles] -
                            offs[(int64_t)t * ntiles];
    counts[t] = c < seg ? c : seg;
    if (c > seg) atomicOr(&any, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) *overflow = any != 0;
}

// a NULL source stands for a column of ones (the valid of a column
// without NULLs)
__device__ __forceinline__ void put_elem(const void* src, void* dst,
                                         int size, int64_t from,
                                         int64_t to) {
  if (src == nullptr)
    ((uint8_t*)dst)[to] = 1;
  else
    copy_elem(src, dst, size, from, to);
}

__global__ void seg_scatter(int64_t n, const int32_t* ids,
                            const int32_t* offs, int64_t ntiles, int ndev,
                            int seg, Cols cols) {
  __shared__ int wcnt[WARPS * MAX_BINS];
  const int nbins = ndev + 1;
  zero_counters(wcnt, nbins);
  __syncthreads();
  count_warp_rows(n, ids, wcnt);
  __syncthreads();
  // each warp's first rank per target: the tile's offset within the
  // target plus the target's rows in the warps before it
  for (int b = threadIdx.x; b < nbins; b += THREADS) {
    int run = offs[(int64_t)b * ntiles + blockIdx.x] -
              offs[(int64_t)b * ntiles];
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
      const int rank = wcnt[warp * MAX_BINS + id] +
                       __popc(peers & ((1u << lane) - 1u));
      if (id < ndev && rank < seg) {
        const int64_t dst = (int64_t)id * seg + rank;
        for (int c = 0; c < cols.n_cols; ++c)
          put_elem(cols.src[c], cols.dst[c], cols.size[c], r, dst);
      }
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1)
      wcnt[warp * MAX_BINS + id] += __popc(peers);
    __syncwarp();
  }
}

// zero every slot past its segment's count
__global__ void seg_tail(int ndev, int seg, const int32_t* counts,
                         Cols cols) {
  const int64_t total = (int64_t)ndev * seg;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int t = (int)(i / seg);
    if (i - (int64_t)t * seg < counts[t]) continue;
    for (int c = 0; c < cols.n_cols; ++c) {
      switch (cols.size[c]) {
        case 1: ((uint8_t*)cols.dst[c])[i] = 0; break;
        case 2: ((uint16_t*)cols.dst[c])[i] = 0; break;
        case 4: ((uint32_t*)cols.dst[c])[i] = 0; break;
        default: ((uint64_t*)cols.dst[c])[i] = 0; break;
      }
    }
  }
}

// count_pass: targets, histogram, scan, counts and overflow (the first
// launch of a call); later launches move more columns with them. With
// n_cols == 0 and no counts the call only writes targets_out.
extern "C" int segments_launch(
    int64_t n, int n_keys, const int64_t* key_ptrs,
    const int64_t* key_valid_ptrs, const int32_t* key_kinds,
    const void* targets_in, void* targets_out, const void* length, int ndev,
    int seg, void* ids, void* hist, void* offs, void* chunk_sums,
    void* counts, void* overflow, int n_cols, const int64_t* src_ptrs,
    const int64_t* dst_ptrs, const int32_t* sizes, int count_pass,
    void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || ndev < 1 || ndev > MAX_BINS - 1 ||
      seg < 0 || n_keys < 0 || n_keys > MAX_KEYS ||
      (targets_in == nullptr && n_keys == 0) ||
      (int64_t)ndev * seg >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const int64_t ntiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  if (count_pass) {
    if (n > 0) {
      Keys K;
      K.n = n_keys;
      for (int j = 0; j < MAX_KEYS; ++j) {
        const bool on = j < n_keys;
        K.k[j] = on ? (const void*)key_ptrs[j] : nullptr;
        K.v[j] = on ? (const bool*)key_valid_ptrs[j] : nullptr;
        K.kind[j] = on ? key_kinds[j] : 0;
      }
      seg_hist<<<(unsigned)ntiles, THREADS, 0, s>>>(
          n, K, (const int32_t*)targets_in, (const int32_t*)length, ndev,
          (int32_t*)ids, (int32_t*)targets_out, (int32_t*)hist, ntiles);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      if (counts == nullptr) return (int)cudaSuccess;
      if ((err = scan_bins((int64_t)(ndev + 1) * ntiles,
                           (const int32_t*)hist, (int32_t*)offs,
                           (int32_t*)chunk_sums, s)) != cudaSuccess)
        return (int)err;
    }
    if (counts == nullptr) return (int)cudaSuccess;
    seg_counts<<<1, THREADS, 0, s>>>(ndev, n > 0 ? (const int32_t*)offs
                                                 : nullptr,
                                     ntiles, seg, (int32_t*)counts,
                                     (bool*)overflow);
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
  if (n > 0) {
    seg_scatter<<<(unsigned)ntiles, THREADS, 0, s>>>(
        n, (const int32_t*)ids, (const int32_t*)offs, ntiles, ndev, seg,
        cols);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int64_t slots = (int64_t)ndev * seg;
  if (slots > 0) {
    int64_t blocks = (slots + THREADS - 1) / THREADS;
    if (blocks > 4096) blocks = 4096;
    seg_tail<<<(unsigned)blocks, THREADS, 0, s>>>(ndev, seg,
                                                  (const int32_t*)counts,
                                                  cols);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
