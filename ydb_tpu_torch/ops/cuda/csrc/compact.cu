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
// Member axis (compact_batched_launch, the batched serving lane): B
// members, each with its own mask row and length, over columns that are
// either shared (member stride 0) or per member. The same three launches
// take a second grid dimension: one count pass over (block, member), one
// scan block per member, one scatter over (block, member) into the
// member's row of a (B, new_cap) output. The single-query entry is the
// case B = 1.
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
  int64_t stride[MAX_COLS];    // elements between members' rows; 0 = shared
};

// A member's view of the rows: its length and its mask row.
struct Member {
  const int32_t* length;       // lengths[b * length_stride]
  const uint8_t* mask;         // mask + b * mask_stride, or null
};

__device__ __forceinline__ Member member(int b, const int32_t* lengths,
                                         int length_stride,
                                         const uint8_t* mask,
                                         int64_t mask_stride) {
  Member m;
  m.length = lengths + (int64_t)b * length_stride;
  m.mask = mask ? mask + (int64_t)b * mask_stride : nullptr;
  return m;
}

__device__ __forceinline__ bool is_active(int64_t r, int64_t n,
                                          const Member& m) {
  return r < n && r < (int64_t)(*m.length) &&
         (m.mask == nullptr || m.mask[r]);
}

// grid (nblocks, B): block_counts[b * nblocks + block]
__global__ void compact_count(int64_t n, const int32_t* lengths,
                              int length_stride, const uint8_t* mask,
                              int64_t mask_stride, int32_t* block_counts) {
  const Member m = member(blockIdx.y, lengths, length_stride, mask,
                          mask_stride);
  const int64_t base = (int64_t)blockIdx.x * BLOCK_ROWS;
  int c = 0;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = base + (int64_t)j * THREADS + threadIdx.x;
    c += __syncthreads_count(is_active(r, n, m));
  }
  if (threadIdx.x == 0)
    block_counts[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = c;
}

// one block per member: its blocks' exclusive offsets and its totals
__global__ void compact_scan(int nblocks, const int32_t* block_counts_all,
                             int32_t* block_offsets_all, int64_t new_cap,
                             int32_t* live, int32_t* new_len,
                             uint8_t* overflow) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t carry;
  const int64_t mb = blockIdx.x;
  const int32_t* block_counts = block_counts_all + mb * nblocks;
  int32_t* block_offsets = block_offsets_all + mb * nblocks;
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
    live[mb] = carry;
    new_len[mb] = (int64_t)carry < new_cap ? carry : (int32_t)new_cap;
    overflow[mb] = (int64_t)carry > new_cap;
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

// grid (nblocks, B): member b's rows land in row b of each (B, new_cap)
// output
__global__ void compact_scatter(int64_t n, const int32_t* lengths,
                                int length_stride, const uint8_t* mask,
                                int64_t mask_stride,
                                const int32_t* block_offsets,
                                int64_t new_cap, Cols cols) {
  __shared__ int32_t warp_counts[THREADS / 32];
  const int b = blockIdx.y;
  const Member m = member(b, lengths, length_stride, mask, mask_stride);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * BLOCK_ROWS;
  int64_t carry = block_offsets[(int64_t)b * gridDim.x + blockIdx.x];
  const int64_t out0 = (int64_t)b * new_cap;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t r = base + (int64_t)j * THREADS + threadIdx.x;
    const bool act = is_active(r, n, m);
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
          copy_elem(cols.src[c], cols.dst[c], cols.size[c],
                    r + (int64_t)b * cols.stride[c], out0 + dst);
    }
    carry += total;
    __syncthreads();
  }
}

static int launch(int64_t n, int B, const void* lengths, int length_stride,
                  const void* mask, int64_t mask_stride, int64_t new_cap,
                  void* block_counts, void* block_offsets, void* live,
                  void* new_len, void* overflow, int n_cols,
                  const int64_t* src_ptrs, const int64_t* src_strides,
                  const int64_t* dst_ptrs, const int32_t* sizes,
                  int count_pass, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = (int)((n + BLOCK_ROWS - 1) / BLOCK_ROWS);
  if (nblocks == 0) {
    if (count_pass)
      compact_scan<<<B, 1024, 0, s>>>(0, (const int32_t*)block_counts,
                                      (int32_t*)block_offsets, new_cap,
                                      (int32_t*)live, (int32_t*)new_len,
                                      (uint8_t*)overflow);
    return (int)cudaGetLastError();
  }
  const dim3 grid(nblocks, B);
  cudaError_t err;
  if (count_pass) {
    compact_count<<<grid, THREADS, 0, s>>>(
        n, (const int32_t*)lengths, length_stride, (const uint8_t*)mask,
        mask_stride, (int32_t*)block_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    compact_scan<<<B, 1024, 0, s>>>(nblocks, (const int32_t*)block_counts,
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
    cols.stride[c] = on && src_strides ? src_strides[c] : 0;
  }
  compact_scatter<<<grid, THREADS, 0, s>>>(
      n, (const int32_t*)lengths, length_stride, (const uint8_t*)mask,
      mask_stride, (const int32_t*)block_offsets, new_cap, cols);
  return (int)cudaGetLastError();
}

extern "C" int compact_launch(int64_t n, const void* length,
                              const void* mask, int64_t new_cap,
                              void* block_counts, void* block_offsets,
                              void* live, void* new_len, void* overflow,
                              int n_cols, const int64_t* src_ptrs,
                              const int64_t* dst_ptrs, const int32_t* sizes,
                              int count_pass, void* stream) {
  return launch(n, 1, length, 0, mask, 0, new_cap, block_counts,
                block_offsets, live, new_len, overflow, n_cols, src_ptrs,
                nullptr, dst_ptrs, sizes, count_pass, stream);
}

// B members: lengths (B,) int32 (length_stride 1) or one shared length
// (0); mask rows mask_stride bytes apart (0 = one shared mask, or null);
// column c's member rows src_strides[c] elements apart (0 = shared);
// outputs (B, new_cap); block_counts / block_offsets B * nblocks; live,
// new_len and overflow (B,).
extern "C" int compact_batched_launch(
    int64_t n, int B, const void* lengths, int length_stride,
    const void* mask, int64_t mask_stride, int64_t new_cap,
    void* block_counts, void* block_offsets, void* live, void* new_len,
    void* overflow, int n_cols, const int64_t* src_ptrs,
    const int64_t* src_strides, const int64_t* dst_ptrs,
    const int32_t* sizes, int count_pass, void* stream) {
  return launch(n, B, lengths, length_stride, mask, mask_stride, new_cap,
                block_counts, block_offsets, live, new_len, overflow, n_cols,
                src_ptrs, src_strides, dst_ptrs, sizes, count_pass, stream);
}
