// sort — lexicographic sort of rows by a list of 64-bit keys, row id last.
//
// Replaces ydb_tpu/ops/sort.py:_sort_impl (lax.sort over dropped rank,
// [null rank, key]... and an iota). The caller encodes every operand as
// an order-preserving unsigned 64-bit key (ops/sort.py, plain torch), so
// the kernel compares words; the row id as the final key makes all keys
// distinct and any correct sort stable. Output: the int32 permutation.
// Bound on the H100: operations on small inputs (one 128-row tile for
// Q1's ORDER BY sits in one block's shared memory); at scan capacity the
// merge passes re-read keys log2(n / 1024) times.
// Design: (1) each block bitonic-sorts a tile of 1024 row ids in shared
// memory; (2) merge passes double the sorted run length: every element's
// output slot is its rank in its own run plus a lower_bound in the
// partner run, so a pass is one independent thread per element.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_KEYS 16
#define TILE 1024

struct Keys {
  int n_keys;
  const uint64_t* k[MAX_KEYS];
};

__device__ __forceinline__ bool row_less(const Keys& K, int32_t a,
                                         int32_t b) {
  if (a < 0) return false;                 // padding sorts last
  if (b < 0) return true;
  for (int i = 0; i < K.n_keys; ++i) {
    const uint64_t x = K.k[i][a], y = K.k[i][b];
    if (x != y) return x < y;
  }
  return a < b;
}

__global__ void sort_tiles(int64_t n, Keys K, int32_t* out) {
  __shared__ int32_t s[TILE];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += blockDim.x)
    s[i] = base + i < n ? (int32_t)(base + i) : -1;
  __syncthreads();
  for (int k = 2; k <= TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const int32_t a = s[i], b = s[ixj];
          if (up ? row_less(K, b, a) : row_less(K, a, b)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < TILE; i += blockDim.x)
    if (base + i < n) out[base + i] = s[i];
}

__global__ void merge_pass(int64_t n, int64_t w, Keys K, const int32_t* src,
                           int32_t* dst) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t run = i / w;
  const int64_t base = (run / 2) * 2 * w;
  const int64_t mine = run * w;
  const int64_t rank = i - mine;
  const int64_t pstart = (run & 1) ? base : base + w;
  int64_t pend = pstart + w;
  if (pend > n) pend = n;
  const int32_t x = src[i];
  int64_t lo = 0;
  if (pstart < n) {
    int64_t hi = pend - pstart;
    while (lo < hi) {                      // partner elements less than x
      const int64_t mid = (lo + hi) >> 1;
      if (row_less(K, src[pstart + mid], x)) lo = mid + 1;
      else hi = mid;
    }
  }
  dst[base + rank + lo] = x;
}

extern "C" int sort_launch(int64_t n, int n_keys, const int64_t* key_ptrs,
                           void* perm, void* scratch, void* stream) {
  if (n_keys < 0 || n_keys > MAX_KEYS) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Keys K;
  K.n_keys = n_keys;
  for (int i = 0; i < MAX_KEYS; ++i)
    K.k[i] = i < n_keys ? (const uint64_t*)key_ptrs[i] : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + TILE - 1) / TILE;
  int passes = 0;
  for (int64_t w = TILE; w < n; w <<= 1) ++passes;
  // the tile sort writes where the last pass must end in `perm`
  int32_t* bufs[2] = {(int32_t*)perm, (int32_t*)scratch};
  int cur = passes & 1;
  sort_tiles<<<(unsigned)tiles, 512, 0, s>>>(n, K, bufs[cur]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int64_t w = TILE; w < n; w <<= 1) {
    merge_pass<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        n, w, K, bufs[cur], bufs[cur ^ 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}
