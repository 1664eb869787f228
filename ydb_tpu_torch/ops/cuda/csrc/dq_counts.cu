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
//
// Design of the count pass: one launch, no zeroed output, and no shared
// atomic a row (a warp's 32 atomics on ndev 4 addresses serialize):
// - the grid is (blocks, producer, channel); the blocks of a (channel,
//   producer) row take its steps of COUNT_STEP 16-byte vectors in turn
//   (a step: COUNT_LOADS int4 loads a thread, all issued before any is
//   counted), as many blocks as give each the same number of steps, at
//   most COUNT_SM_BLOCKS a SM over the launch (the wrapper's cap from
//   the card's SMs; each thread of the register mode in at most 32
//   registers: every block resident at once, 64 bytes in flight a
//   thread);
// - the row's values before its first 16-byte boundary and after its
//   last whole vector (ragged caps, a producer at any flat row) are
//   counted by warp 0 of block 0 as lanes of one more round;
// - counting, by ndev: up to REG_TARGETS (4, the DQ paths' workers),
//   each thread keeps its counters in registers (c[d] += v == d,
//   unrolled; a value >= ndev lands in a counter that is never
//   written), then a warp sum a counter (__reduce_add_sync); past 4, a
//   histogram in shared memory with one atomic a distinct value a warp
//   (__match_any_sync);
// - each block writes its ndev counts as a partial row, then draws a
//   ticket of its (channel, producer); the last block to draw folds the
//   row's partials (warp w targets w, w + 8, ...; lanes over the
//   blocks, then a warp sum), writes the counts and resets the ticket
//   for the next launch (one word per (channel, producer), zeroed once
//   a stream by the wrapper). Integer sums: any order gives the same.
// ndev is at most MAX_TARGETS (the shared histogram's 4 KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash64.cuh"

#define COUNT_THREADS 256
#define COUNT_WARPS (COUNT_THREADS / 32)
#define COUNT_LOADS 4                              // int4 loads a thread
#define COUNT_STEP (COUNT_THREADS * COUNT_LOADS)   // int4 vectors a step
#define COUNT_SM_BLOCKS 8                          // blocks a SM at once
#define REG_TARGETS 4                              // counters in registers
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

#define FULL_MASK 0xffffffffu

// REG: REG_TARGETS counters a thread (ndev <= REG_TARGETS); else the
// shared histogram. Every lane of a warp calls count() together (the
// histogram's is a warp collective); a lane with no value passes -1.
template <bool REG>
struct Counter {
  uint32_t c[REG ? REG_TARGETS : 1];

  __device__ __forceinline__ Counter() {
#pragma unroll
    for (int d = 0; d < (REG ? REG_TARGETS : 1); ++d) c[d] = 0;
  }

  __device__ __forceinline__ void count(int32_t v, int ndev, int* bins) {
    if (REG) {
#pragma unroll
      for (int d = 0; d < REG_TARGETS; ++d) c[d] += v == d;
    } else {
      const uint32_t peers = __match_any_sync(FULL_MASK, v);
      if (v >= 0 && v < ndev && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&bins[v], __popc(peers));
    }
  }

  __device__ __forceinline__ void count4(const int4 x, int ndev, int* bins) {
    count(x.x, ndev, bins);
    count(x.y, ndev, bins);
    count(x.z, ndev, bins);
    count(x.w, ndev, bins);
  }
};

template <bool REG>
__global__ void __launch_bounds__(COUNT_THREADS, REG ? COUNT_SM_BLOCKS : 4)
    counts_kernel(int64_t cap, int nprod, int ndev, const int32_t* planes,
                  int32_t* part, unsigned* tickets, int32_t* counts) {
  __shared__ int bins[REG ? COUNT_WARPS * REG_TARGETS : MAX_TARGETS];
  __shared__ bool s_last;
  const int G = gridDim.x, g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t cp = (int64_t)blockIdx.z * nprod + blockIdx.y;
  const int32_t* row = planes + cp * cap;
  // the row as a head before its first 16-byte boundary, nv whole
  // vectors, and a tail of at most 3 values
  int64_t head = (int64_t)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
  head = head < cap ? head : cap;
  const int64_t nv = (cap - head) >> 2;
  const int64_t tail = head + 4 * nv;
  const int4* body = (const int4*)(row + head);
  if (!REG) {
    for (int d = threadIdx.x; d < ndev; d += COUNT_THREADS) bins[d] = 0;
    __syncthreads();
  }
  Counter<REG> k;
  if (g == 0 && warp == 0) {          // the head and the tail: one round
    const int64_t r = lane < head ? lane : tail + (lane - head);
    k.count(lane < head || r < cap ? row[r] : -1, ndev, bins);
  }
  for (int64_t s0 = (int64_t)g * COUNT_STEP; s0 < nv;
       s0 += (int64_t)G * COUNT_STEP) {
    int4 x[COUNT_LOADS];
#pragma unroll
    for (int j = 0; j < COUNT_LOADS; ++j) {
      const int64_t q = s0 + j * COUNT_THREADS + threadIdx.x;
      x[j] = q < nv ? __ldcs(body + q) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < COUNT_LOADS; ++j) k.count4(x[j], ndev, bins);
  }
  // the block's counts: its partial row
  int32_t* prow = part + cp * ndev * G + g;     // target d at prow[d * G]
  if (REG) {
#pragma unroll
    for (int d = 0; d < REG_TARGETS; ++d) {
      const uint32_t t = __reduce_add_sync(FULL_MASK, k.c[d]);
      if (lane == 0) bins[warp * REG_TARGETS + d] = (int)t;
    }
    __syncthreads();
    if (threadIdx.x < ndev) {
      int t = 0;
#pragma unroll
      for (int w = 0; w < COUNT_WARPS; ++w)
        t += bins[w * REG_TARGETS + threadIdx.x];
      prow[(int64_t)threadIdx.x * G] = t;
    }
  } else {
    __syncthreads();
    for (int d = threadIdx.x; d < ndev; d += COUNT_THREADS)
      prow[(int64_t)d * G] = bins[d];
  }
  // the ticket of (channel, producer): the last block folds the row
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(tickets + cp, 1u);
    s_last = t == (unsigned)G - 1;
    if (s_last) tickets[cp] = 0;        // every block has drawn: reset
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int d = warp; d < ndev; d += COUNT_WARPS) {
    const int32_t* pd = part + (cp * ndev + d) * G;
    uint32_t t = 0;
#pragma unroll 4
    for (int b = lane; b < G; b += 32) t += (uint32_t)__ldcg(pd + b);
    t = __reduce_add_sync(FULL_MASK, t);
    if (lane == 0) counts[cp * ndev + d] = (int32_t)t;
  }
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

// counts[nch, nprod, ndev] in one launch of `blocks` blocks a (channel,
// producer) row (the wrapper keeps the launch within COUNT_SM_BLOCKS a
// SM); part: nch * nprod * ndev * blocks ints of scratch;
// tickets: nch * nprod words, zero, left zero
extern "C" int dq_counts_ticket_launch(int64_t cap, int nch, int nprod,
                                       int ndev, int blocks,
                                       const int32_t* planes, int32_t* part,
                                       unsigned* tickets, int32_t* counts,
                                       void* stream) {
  if (ndev < 1 || ndev > MAX_TARGETS || nch < 1 || nprod < 1 ||
      nprod > 65535 || nch > 65535 || cap < 0 || blocks < 1 ||
      part == nullptr || tickets == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)nprod, (unsigned)nch);
  cudaStream_t s = (cudaStream_t)stream;
  if (ndev <= REG_TARGETS)
    counts_kernel<true><<<grid, COUNT_THREADS, 0, s>>>(
        cap, nprod, ndev, planes, part, tickets, counts);
  else
    counts_kernel<false><<<grid, COUNT_THREADS, 0, s>>>(
        cap, nprod, ndev, planes, part, tickets, counts);
  return (int)cudaGetLastError();
}
