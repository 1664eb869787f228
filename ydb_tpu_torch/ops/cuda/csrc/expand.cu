// expand — the expanding (duplicate-key) join probe.
//
// Replaces ydb_tpu/ops/join.py:_expand_counts and _expand_gather, which
// probe_expand runs on the portioned path when a build side holds a key
// more than once.
// expand_counts: per probe row r < length, the lower and upper bound of
// its key in the power-of-two padded sorted build keys (the reference's
// searchsorted left / right; keys of the same dtype, int64 or float64,
// padded with INT64_MAX or +inf), both clipped to n_build so the padding
// never matches; mcounts = hi - lo for a matchable row (active, key not
// NULL), else 0; counts = max(mcounts, 1) for an active row of a LEFT
// join, mcounts otherwise; and the exclusive prefix of the counts
// (offsets) with their total.
// expand_gather: per output slot j < out_cap, its probe row (the last
// row whose offset is <= j), its match k = j - offsets[row], its build
// row lo[row] + k (clipped to the payload capacity), and whether it is a
// match (mcounts[row] > 0 and j < total; a null-extended LEFT row is
// not); then every column in one pass: probe columns at the probe row,
// payload columns at the build row, payload validity as the match flag
// and the payload's own validity.
// Bound on the H100: bytes. counts reads each probe key and validity
// once and writes 16 bytes per row; the build keys (50,000 at most on
// the TPC-DS paths) stay in L2. gather writes every output column once
// and reads the probe and build columns through the row maps (gathers
// from L2-resident builds; the probe columns are read in order, one
// probe row feeding its matches' consecutive slots).
// Design: the skew hazard — one key matching 100,000 build rows — is
// met by giving each OUTPUT slot a thread, which binary-searches the
// offsets (L2-resident) for its probe row, so a hot key spreads over as
// many threads as it has matches; a thread per probe row would
// serialize it. The prefix is a three-launch scan (tile totals in the
// counts kernel, one block scanning the totals, tile-local scans plus
// the carry), exact in int64.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 1024                     // rows per block of the prefix
#define MAX_COLS 32

enum { M_PROBE = 0, M_BUILD = 1, M_BUILD_VALID = 2 };

// first position whose key is not < e (upper: not <= e) in keys[0, kcap),
// kcap a power of two; the result is in [0, kcap]
template <typename T, bool UPPER>
__device__ __forceinline__ int64_t bound_pow2(const T* keys, int64_t kcap,
                                              T e) {
  int64_t pos = 0;
  for (int64_t step = kcap >> 1; step > 0; step >>= 1) {
    const T kv = keys[pos + step - 1];
    if (UPPER ? (kv <= e) : (kv < e)) pos += step;
  }
  const T kv = keys[pos];
  if (UPPER ? (kv <= e) : (kv < e)) ++pos;
  return pos;
}

__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* red) {
  // red: 32 slots of shared memory
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;                          // valid in thread 0
}

__global__ void ex_counts(int64_t n, const void* key, int key_f64,
                          const uint8_t* kvalid, const int32_t* length,
                          const void* keys_sorted, int64_t kcap,
                          int64_t n_build, int left, int32_t* lo_out,
                          int32_t* mcount_out, int64_t* counts,
                          int64_t* tile_sum) {
  __shared__ int64_t red[32];
  const int64_t r = (int64_t)blockIdx.x * TILE + threadIdx.x;
  int64_t c = 0;
  if (r < n) {
    const bool active = r < (int64_t)*length;
    const bool matchable = active && (kvalid == nullptr || kvalid[r] != 0);
    int64_t lo, hi;
    if (key_f64) {
      const double e = ((const double*)key)[r];
      lo = bound_pow2<double, false>((const double*)keys_sorted, kcap, e);
      hi = bound_pow2<double, true>((const double*)keys_sorted, kcap, e);
    } else {
      const int64_t e = ((const int64_t*)key)[r];
      lo = bound_pow2<int64_t, false>((const int64_t*)keys_sorted, kcap, e);
      hi = bound_pow2<int64_t, true>((const int64_t*)keys_sorted, kcap, e);
    }
    lo = lo < n_build ? lo : n_build;
    hi = hi < n_build ? hi : n_build;
    const int64_t m = matchable ? hi - lo : 0;
    c = left ? (active ? (m > 1 ? m : 1) : 0) : m;
    lo_out[r] = (int32_t)lo;
    mcount_out[r] = (int32_t)m;
    counts[r] = c;
  }
  const int64_t s = block_sum(c, red);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = s;
}

// one block: exclusive prefix of the tile totals, and the grand total
__global__ void ex_scan_tiles(int64_t T, const int64_t* tile_sum,
                              int64_t* tile_off, int64_t* total) {
  __shared__ int64_t s[TILE];
  const int tid = threadIdx.x;
  int64_t run = 0;
  for (int64_t base = 0; base < T; base += TILE) {
    const int64_t t = base + tid;
    s[tid] = t < T ? tile_sum[t] : 0;
    __syncthreads();
    for (int d = 1; d < TILE; d <<= 1) {
      const int64_t o = tid >= d ? s[tid - d] : 0;
      __syncthreads();
      s[tid] += o;
      __syncthreads();
    }
    if (t < T) tile_off[t] = run + (tid ? s[tid - 1] : 0);
    const int64_t last = s[TILE - 1];
    __syncthreads();
    run += last;
  }
  if (tid == 0) *total = run;
}

// tile-local exclusive scan of the counts plus the tile's offset; in
// place (counts → offsets)
__global__ void ex_offsets(int64_t n, const int64_t* tile_off,
                           int64_t* offsets) {
  __shared__ int64_t s[TILE];
  const int tid = threadIdx.x;
  const int64_t r = (int64_t)blockIdx.x * TILE + tid;
  const int64_t c = r < n ? offsets[r] : 0;
  s[tid] = c;
  __syncthreads();
  for (int d = 1; d < TILE; d <<= 1) {
    const int64_t o = tid >= d ? s[tid - d] : 0;
    __syncthreads();
    s[tid] += o;
    __syncthreads();
  }
  if (r < n) offsets[r] = tile_off[blockIdx.x] + s[tid] - c;
}

struct Cols {
  int n;
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];
  int mode[MAX_COLS];
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

__device__ __forceinline__ void zero_elem(void* dst, int size, int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = 0; break;
    case 2: ((uint16_t*)dst)[to] = 0; break;
    case 4: ((uint32_t*)dst)[to] = 0; break;
    default: ((uint64_t*)dst)[to] = 0; break;
  }
}

__global__ void ex_gather(int64_t out_cap, int64_t n, const int32_t* lo,
                          const int32_t* mcounts, const int64_t* offsets,
                          const int64_t* total, int64_t pcap, Cols C) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  int64_t row = 0, lo_r = 0, off_r = 0, m = 0;
  if (n > 0) {
    int64_t a = 0, b = n;            // count of offsets <= j
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (offsets[mid] <= j) a = mid + 1;
      else b = mid;
    }
    row = a - 1;
    row = row < 0 ? 0 : (row > n - 1 ? n - 1 : row);
    lo_r = lo[row];
    off_r = offsets[row];
    m = mcounts[row];
  }
  int64_t bidx = lo_r + (j - off_r);
  bidx = bidx < 0 ? 0 : (bidx > pcap - 1 ? pcap - 1 : bidx);
  const bool found = m > 0 && j < *total;
  for (int c = 0; c < C.n; ++c) {
    switch (C.mode[c]) {
      case M_PROBE:
        if (n > 0) copy_elem(C.src[c], C.dst[c], C.size[c], row, j);
        else zero_elem(C.dst[c], C.size[c], j);    // no probe rows
        break;
      case M_BUILD:
        copy_elem(C.src[c], C.dst[c], C.size[c], bidx, j);
        break;
      default:                       // M_BUILD_VALID
        ((uint8_t*)C.dst[c])[j] =
            found && (C.src[c] == nullptr ||
                      ((const uint8_t*)C.src[c])[bidx] != 0);
        break;
    }
  }
}

extern "C" int expand_counts_launch(int64_t n, const void* key, int key_f64,
                                    const void* kvalid, const void* length,
                                    const void* keys_sorted, int64_t kcap,
                                    int64_t n_build, int left, void* lo,
                                    void* mcounts, void* offsets,
                                    void* total, void* tile_sum,
                                    void* tile_off, void* stream) {
  if (kcap < 1 || (kcap & (kcap - 1)) || n_build > kcap ||
      n >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t T = n > 0 ? (n + TILE - 1) / TILE : 1;
  if (n > 0)
    ex_counts<<<(unsigned)T, TILE, 0, s>>>(
        n, key, key_f64, (const uint8_t*)kvalid, (const int32_t*)length,
        keys_sorted, kcap, n_build, left, (int32_t*)lo, (int32_t*)mcounts,
        (int64_t*)offsets, (int64_t*)tile_sum);
  else
    cudaMemsetAsync(tile_sum, 0, sizeof(int64_t), s);
  ex_scan_tiles<<<1, TILE, 0, s>>>(T, (const int64_t*)tile_sum,
                                   (int64_t*)tile_off, (int64_t*)total);
  if (n > 0)
    ex_offsets<<<(unsigned)T, TILE, 0, s>>>(n, (const int64_t*)tile_off,
                                            (int64_t*)offsets);
  return (int)cudaGetLastError();
}

extern "C" int expand_gather_launch(int64_t out_cap, int64_t n,
                                    const void* lo, const void* mcounts,
                                    const void* offsets, const void* total,
                                    int64_t pcap, int n_cols,
                                    const int64_t* src_ptrs,
                                    const int64_t* dst_ptrs,
                                    const int32_t* sizes,
                                    const int32_t* modes, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || pcap < 1)
    return (int)cudaErrorInvalidValue;
  if (out_cap == 0) return (int)cudaSuccess;
  Cols C;
  C.n = n_cols;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < n_cols;
    C.src[c] = on ? (const void*)src_ptrs[c] : nullptr;
    C.dst[c] = on ? (void*)dst_ptrs[c] : nullptr;
    C.size[c] = on ? sizes[c] : 1;
    C.mode[c] = on ? modes[c] : M_BUILD_VALID;
  }
  const int threads = 256;
  const int64_t blocks = (out_cap + threads - 1) / threads;
  ex_gather<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out_cap, n, (const int32_t*)lo, (const int32_t*)mcounts,
      (const int64_t*)offsets, (const int64_t*)total, pcap, C);
  return (int)cudaGetLastError();
}
