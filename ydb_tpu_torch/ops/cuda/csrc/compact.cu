// compact — stable compaction of the active rows of a column set.
//
// Replaces ydb_tpu/ops/xla_exec.py:compress (argsort of (dropped, row))
// and compact_env (cumsum rank + dropping scatter into new_cap slots).
// A row is active when row < *length and (no mask, or mask[row]).
// Bound on the H100: bytes — the mask is read twice (count, scatter),
// each column is read once where active and written once.
// Design: three launches. (1) each block of 1024 rows counts its active
// rows; (2) one block turns the counts into exclusive offsets and writes
// live = total, new_len = min(live, new_cap) and overflow = live > new_cap;
// (3) each block rescans its rows in order with ballot prefix sums and
// copies every column of an active row to offset + rank, dropping ranks
// at or past new_cap. Rows keep their order, so the result is the stable
// compaction. Only [0, new_len) is defined as output; the caller zeroes
// the buffers, which matches compact_env's zero-filled tail.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 4
#define BLOCK_ROWS (THREADS * ITEMS)
#define MAX_COLS 24

struct Cols {
  int n_cols;
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];          // bytes per element: 1, 2, 4 or 8
};

__device__ __forceinline__ bool is_active(int64_t r, int64_t n,
                                          const int32_t* length,
                                          const uint8_t* mask) {
  return r < n && r < (int64_t)(*length) && (mask == nullptr || mask[r]);
}

__global__ void compact_count(int64_t n, const int32_t* length,
                              const uint8_t* mask, int32_t* block_counts) {
  const int64_t base = (int64_t)blockIdx.x * BLOCK_ROWS;
  int c = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = base + (int64_t)j * THREADS + threadIdx.x;
    c += __syncthreads_count(is_active(r, n, length, mask));
  }
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void compact_scan(int nblocks, const int32_t* block_counts,
                             int32_t* block_offsets, int64_t new_cap,
                             int32_t* live, int32_t* new_len,
                             uint8_t* overflow) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < nblocks; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < nblocks ? block_counts[i] : 0;
    int x = v;                                    // inclusive warp scan
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x / 32;
      int w = lane < nw ? warp_sums[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      if (lane < nw) warp_sums[lane] = w;        // inclusive warp totals
    }
    __syncthreads();
    const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < nblocks) block_offsets[i] = carry + before;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry += before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *live = carry;
    *new_len = (int64_t)carry < new_cap ? carry : (int32_t)new_cap;
    *overflow = (int64_t)carry > new_cap;
  }
}

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

__global__ void compact_scatter(int64_t n, const int32_t* length,
                                const uint8_t* mask,
                                const int32_t* block_offsets,
                                int64_t new_cap, Cols cols) {
  __shared__ int32_t warp_counts[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * BLOCK_ROWS;
  int64_t carry = block_offsets[blockIdx.x];
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = base + (int64_t)j * THREADS + threadIdx.x;
    const bool act = is_active(r, n, length, mask);
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    if (lane == 0) warp_counts[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = warp_counts[w];
      if (w < warp) before += c;
      total += c;
    }
    if (act) {
      const int64_t dst = carry + before +
                          __popc(bal & ((1u << lane) - 1u));
      if (dst < new_cap)
        for (int c = 0; c < cols.n_cols; ++c)
          copy_elem(cols.src[c], cols.dst[c], cols.size[c], r, dst);
    }
    carry += total;
    __syncthreads();
  }
}

extern "C" int compact_launch(int64_t n, const void* length,
                              const void* mask, int64_t new_cap,
                              void* block_counts, void* block_offsets,
                              void* live, void* new_len, void* overflow,
                              int n_cols, const int64_t* src_ptrs,
                              const int64_t* dst_ptrs, const int32_t* sizes,
                              int count_pass, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = (int)((n + BLOCK_ROWS - 1) / BLOCK_ROWS);
  if (nblocks == 0) {
    compact_scan<<<1, 1024, 0, s>>>(0, (const int32_t*)block_counts,
                                    (int32_t*)block_offsets, new_cap,
                                    (int32_t*)live, (int32_t*)new_len,
                                    (uint8_t*)overflow);
    return (int)cudaGetLastError();
  }
  cudaError_t err;
  if (count_pass) {
    compact_count<<<nblocks, THREADS, 0, s>>>(
        n, (const int32_t*)length, (const uint8_t*)mask,
        (int32_t*)block_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    compact_scan<<<1, 1024, 0, s>>>(nblocks, (const int32_t*)block_counts,
                                    (int32_t*)block_offsets, new_cap,
                                    (int32_t*)live, (int32_t*)new_len,
                                    (uint8_t*)overflow);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
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
  compact_scatter<<<nblocks, THREADS, 0, s>>>(
      n, (const int32_t*)length, (const uint8_t*)mask,
      (const int32_t*)block_offsets, new_cap, cols);
  return (int)cudaGetLastError();
}
