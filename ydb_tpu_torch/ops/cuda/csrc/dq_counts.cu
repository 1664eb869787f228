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
// Bound on the H100: bytes. The plane pass reads each live key (8 or 4
// bytes) and valid once and writes the 4-byte plane value; the count
// pass reads each plane value once and writes nch * nprod * ndev ints.
//
// Design of the plane pass. Hopper has no integer divider: a 64-bit
// division or remainder is a called routine of tens of instructions, so
// the power-of-two path divides nothing a row; and the pass keeps
// several 16-byte loads in flight a thread:
// - the grid is (row tiles, producer): blockIdx.y is p, so no `i / cap`;
//   `lengths[p]` is read once a block (clamped to [0, cap]);
// - the modulo: `h & (ndev - 1)` when ndev is a power of two (the DQ
//   paths' 4 workers); any other ndev keeps `h % ndev` (no path runs
//   one);
// - 8 rows a thread, as 4 row pairs at a 64-row stride, so that every
//   access of a warp is one run of whole lines: a 16-byte load a pair of
//   int64 keys (512 bytes a warp), an 8-byte load a pair of int32 codes,
//   a 2-byte load a pair of valid bytes, an 8-byte store a pair of
//   plane values (256 bytes a warp); the thread issues its 4 pairs'
//   loads before it hashes any;
// - nothing is loaded past the length: a pair past it stores -1 without
//   a load, a pair across it goes row by row;
// - ragged caps: producer p starts at flat row p * cap, so the pairs
//   start at the first even flat row (p * cap + 1 for an odd p * cap: a
//   head row done alone), and a last lone row goes alone; the vector
//   accesses then sit at their natural alignment (the wrapper refuses
//   keys or valid whose data pointer breaks it);
// - dictionary codes (kind 1) read the LUT through the read-only cache:
//   staging it in shared memory would cost every block the whole LUT,
//   more bytes than its gathers at the union dictionaries' sizes.
// The count pass is one histogram per (tile of 4,096 rows, producer,
// channel): ndev counters in shared memory, a shared atomic per row,
// then one global atomic per bin into the zeroed output. ndev is at most
// 1,024 (the counters fit in 4 KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash64.cuh"

#define COUNT_TILE 4096
#define COUNT_THREADS 256
#define MAX_TARGETS 1024
#define PLANE_THREADS 256
#define PLANE_PAIRS 4                              // row pairs a thread
#define PLANE_ROWS 8                               // rows a thread
#define PLANE_TILE (PLANE_THREADS * PLANE_ROWS)    // rows a block
static_assert(PLANE_ROWS == 2 * PLANE_PAIRS, "a pair is two rows");

// MODE 0: int64 keys, ndev a power of two (mask = ndev - 1); 1: int64
// keys, any ndev; 2: int32 codes through the lut
template <int MODE>
__device__ __forceinline__ int32_t route(int64_t k, const int32_t* lut,
                                         int lut_len, uint32_t mask,
                                         uint32_t ndev) {
  if (MODE == 2) {
    int32_t c = (int32_t)k;
    c = c < 0 ? 0 : (c > lut_len - 1 ? lut_len - 1 : c);
    return __ldg(lut + c);
  }
  const uint64_t h = splitmix64((uint64_t)k);
  return MODE == 0 ? (int32_t)((uint32_t)h & mask)
                   : (int32_t)(h % (uint64_t)ndev);
}

// one row r of the producer alone: the head, a pair across the length,
// the last lone row
template <int MODE>
__device__ __forceinline__ void plane_row(
    int64_t r, int64_t len, const void* keys, const uint8_t* valid,
    const int32_t* lut, int lut_len, uint32_t mask, uint32_t ndev,
    int32_t* out) {
  int32_t b = -1;
  if (r < len && (valid == nullptr || valid[r]))
    b = route<MODE>(MODE == 2 ? (int64_t)((const int32_t*)keys)[r]
                              : ((const int64_t*)keys)[r],
                    lut, lut_len, mask, ndev);
  out[r] = b;
}

template <int MODE>
__global__ void __launch_bounds__(PLANE_THREADS)
    bucket_plane_kernel(int64_t cap, const void* keys, const uint8_t* valid,
                        const int32_t* lengths, const int32_t* lut,
                        int lut_len, uint32_t mask, uint32_t ndev,
                        int32_t* plane) {
  __shared__ int64_t s_len;
  const int p = blockIdx.y;
  const int64_t base = (int64_t)p * cap;
  if (threadIdx.x == 0) {
    const int64_t l = lengths[p];
    s_len = l < 0 ? 0 : (l > cap ? cap : l);
  }
  __syncthreads();
  const int64_t len = s_len;
  // the producer's rows from here on: keys, valid and plane at row 0
  const void* k = MODE == 2 ? (const void*)((const int32_t*)keys + base)
                            : (const void*)((const int64_t*)keys + base);
  const uint8_t* v = valid == nullptr ? nullptr : valid + base;
  int32_t* out = plane + base;
  const int64_t head = base & 1;       // a row before the first even flat row
  if (head && blockIdx.x == 0 && threadIdx.x == 0)
    plane_row<MODE>(0, len, k, v, lut, lut_len, mask, ndev, out);
  const int lane = threadIdx.x & 31;
  // pair j of the lane: rows r0 + 64 j, + 1
  const int64_t r0 = head + (int64_t)blockIdx.x * PLANE_TILE +
                     (threadIdx.x >> 5) * (32 * PLANE_ROWS) + 2 * lane;
  int64_t ka[PLANE_PAIRS], kb[PLANE_PAIRS];
  uint32_t vb[PLANE_PAIRS];
#pragma unroll
  for (int j = 0; j < PLANE_PAIRS; ++j) {
    const int64_t r = r0 + 64 * j;
    ka[j] = kb[j] = 0;
    vb[j] = 0x0101u;
    if (r + 2 <= len) {
      if (MODE == 2) {
        const int2 c = __ldcs((const int2*)((const int32_t*)k + r));
        ka[j] = c.x;
        kb[j] = c.y;
      } else {
        const longlong2 c = __ldcs((const longlong2*)((const int64_t*)k + r));
        ka[j] = c.x;
        kb[j] = c.y;
      }
      if (v != nullptr) vb[j] = __ldcs((const unsigned short*)(v + r));
    }
  }
#pragma unroll
  for (int j = 0; j < PLANE_PAIRS; ++j) {
    const int64_t r = r0 + 64 * j;
    if (r + 2 <= len) {
      int2 o;
      o.x = (vb[j] & 0xffu) ? route<MODE>(ka[j], lut, lut_len, mask, ndev) : -1;
      o.y = (vb[j] >> 8) ? route<MODE>(kb[j], lut, lut_len, mask, ndev) : -1;
      *(int2*)(out + r) = o;
    } else if (r >= len && r + 2 <= cap) {
      *(int2*)(out + r) = make_int2(-1, -1);
    } else {
      if (r < cap) plane_row<MODE>(r, len, k, v, lut, lut_len, mask, ndev, out);
      if (r + 1 < cap)
        plane_row<MODE>(r + 1, len, k, v, lut, lut_len, mask, ndev, out);
    }
  }
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
  if (ndev < 1 || nprod < 1 || nprod > 65535 || cap < 0 ||
      (kind != 0 && kind != 1) || (kind == 1 && lut_len < 1))
    return (int)cudaErrorInvalidValue;
  const bool pow2 = (ndev & (ndev - 1)) == 0;
  if (cap == 0) return (int)cudaSuccess;
  // the vector accesses' alignment: a key pair, a valid pair, a plane pair
  if ((uintptr_t)keys % (kind == 0 ? 16 : 8) || (uintptr_t)valid % 2 ||
      (uintptr_t)plane % 8)
    return (int)cudaErrorMisalignedAddress;
  const int64_t tiles = (cap + PLANE_TILE - 1) / PLANE_TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)nprod);
  const uint8_t* v = (const uint8_t*)valid;
  const uint32_t mask = (uint32_t)(ndev - 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 1)
    bucket_plane_kernel<2><<<grid, PLANE_THREADS, 0, s>>>(
        cap, keys, v, lengths, lut, lut_len, mask, (uint32_t)ndev, plane);
  else if (pow2)
    bucket_plane_kernel<0><<<grid, PLANE_THREADS, 0, s>>>(
        cap, keys, v, lengths, lut, lut_len, mask, (uint32_t)ndev, plane);
  else
    bucket_plane_kernel<1><<<grid, PLANE_THREADS, 0, s>>>(
        cap, keys, v, lengths, lut, lut_len, mask, (uint32_t)ndev, plane);
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
