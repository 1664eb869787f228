// dq_counts — the DQ channel plane's count exchange: the bucket plane of
// a hash-shuffle edge, and the per-(producer, target) live-row counts
// that size its segments.
//
// Replaces ydb_tpu/dq/ici.py:457 _build_counts_fn and :474
// _build_counts_batched_fn (counts[c, p, d] = sum over r of
// plane[c, p, r] == d, as int32), and the bucket plane those programs
// read (ydb_tpu/dq/ici.py:763-783, computed there as jnp glue before the
// count program).
//
// dq_bucket_plane_launch: plane[p, r] for producer p's row r of a
// [nprod, cap] key plane. A row r >= lengths[p], or one whose key is
// NULL (valid false), is -1: it routes nowhere (the inner-shuffle
// semantics of the host plane). Otherwise, for an int key, splitmix64 of
// the key as int64 mod ndev, as uint64 (hash64.cuh: the host plane's
// `key_buckets` hash); for a string key, lut[clamp(code, 0, lut_len-1)]
// (the host crc32 of each value of the union dictionary mod ndev).
// dq_counts_launch: counts[c, p, d] for planes [nch, nprod, cap] and
// d < ndev; a plane value outside [0, ndev) counts nowhere. The solo
// count exchange is nch = 1.
//
// Bound on the H100: bytes. The plane pass reads each key (8 or 4 bytes)
// and valid once and writes the 4-byte plane value; the count pass reads
// each plane value once and writes nch * nprod * ndev ints. A hash is a
// few multiplies and shifts, far below the integer rate.
// Design: the plane is a flat elementwise pass (a thread per row). The
// count pass is one histogram per (tile of 4,096 rows, producer,
// channel): ndev counters in shared memory, a shared atomic per row,
// then one global atomic per bin into the zeroed output. ndev is at most
// 1,024 (the counters fit in 4 KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash64.cuh"

#define COUNT_TILE 4096
#define COUNT_THREADS 256
#define MAX_TARGETS 1024

// kind: 0 int64 keys hashed, 1 int32 codes through the lut
__global__ void bucket_plane_kernel(int64_t cap, int nprod, int kind,
                                    const void* keys, const bool* valid,
                                    const int32_t* lengths,
                                    const int32_t* lut, int lut_len,
                                    int ndev, int32_t* plane) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap * (int64_t)nprod) return;
  const int p = (int)(i / cap);
  const int64_t r = i - (int64_t)p * cap;
  int32_t b = -1;
  if (r < (int64_t)lengths[p] && (valid == nullptr || valid[i])) {
    if (kind == 0) {
      const uint64_t h = splitmix64((uint64_t)((const int64_t*)keys)[i]);
      b = (int32_t)(h % (uint64_t)ndev);
    } else {
      int32_t c = ((const int32_t*)keys)[i];
      c = c < 0 ? 0 : (c > lut_len - 1 ? lut_len - 1 : c);
      b = lut[c];
    }
  }
  plane[i] = b;
}

__global__ void counts_kernel(int64_t cap, int nprod, int ndev,
                              const int32_t* plane, int32_t* counts) {
  __shared__ int bins[MAX_TARGETS];
  const int p = blockIdx.y;
  const int c = blockIdx.z;
  for (int d = threadIdx.x; d < ndev; d += blockDim.x) bins[d] = 0;
  __syncthreads();
  const int32_t* row = plane + ((int64_t)c * nprod + p) * cap;
  const int64_t base = (int64_t)blockIdx.x * COUNT_TILE;
  const int64_t end = base + COUNT_TILE < cap ? base + COUNT_TILE : cap;
  for (int64_t r = base + threadIdx.x; r < end; r += blockDim.x) {
    const int32_t d = row[r];
    if (d >= 0 && d < ndev) atomicAdd(&bins[d], 1);
  }
  __syncthreads();
  int32_t* out = counts + ((int64_t)c * nprod + p) * ndev;
  for (int d = threadIdx.x; d < ndev; d += blockDim.x)
    if (bins[d]) atomicAdd(&out[d], bins[d]);
}

extern "C" int dq_bucket_plane_launch(int64_t cap, int nprod, int kind,
                                      const void* keys, const bool* valid,
                                      const int32_t* lengths,
                                      const int32_t* lut, int lut_len,
                                      int ndev, int32_t* plane,
                                      void* stream) {
  if (ndev < 1 || nprod < 1 || (kind != 0 && kind != 1) ||
      (kind == 1 && lut_len < 1))
    return (int)cudaErrorInvalidValue;
  const int64_t n = cap * (int64_t)nprod;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t grid = (n + threads - 1) / threads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bucket_plane_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      cap, nprod, kind, keys, valid, lengths, lut, lut_len, ndev, plane);
  return (int)cudaGetLastError();
}

// counts must hold nch * nprod * ndev zeros
extern "C" int dq_counts_launch(int64_t cap, int nch, int nprod, int ndev,
                                const int32_t* plane, int32_t* counts,
                                void* stream) {
  if (ndev < 1 || ndev > MAX_TARGETS || nch < 1 || nprod < 1 ||
      nprod > 65535 || nch > 65535)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaSuccess;
  const int64_t tiles = (cap + COUNT_TILE - 1) / COUNT_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)nprod, (unsigned)nch);
  counts_kernel<<<grid, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
      cap, nprod, ndev, plane, counts);
  return (int)cudaGetLastError();
}
