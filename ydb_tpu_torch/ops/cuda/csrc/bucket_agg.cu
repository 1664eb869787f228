// bucket_agg — per-bucket masked aggregation for bounded key domains.
//
// Replaces ydb_tpu/ops/xla_exec.py:_groupby_global (keyless: one bucket)
// and the aggregation core of _groupby_small_domain (<= 512 buckets).
// Bound on the H100: bytes. Every row is read once (bucket id, activity,
// validity, one 8-byte value per aggregate) and the outputs are tiny, so
// the floor is the input bytes over 3.35 TB/s.
// Design: a block stages a tile of 512 rows (ids, validity bits, values)
// in shared memory with coalesced loads and orders the tile's rows by
// bucket, each bucket's rows in row order: a row's slot is its bucket's
// start, plus the rows of that bucket in earlier 32-row chunks, plus its
// rank among the same bucket's lanes of its own chunk (__match_any_sync).
// Each bucket's segment is then folded into the block's accumulators by
// one owner: a short segment (< 16 rows, the common case when hundreds of
// buckets share a tile) by one thread in row order, a long one (a handful
// of hot buckets, TPC-H Q1) by one warp whose lanes fold rows in
// registers and combine through a fixed-order shuffle tree. No two owners
// share a bucket, so there are no atomics and no contention, and the work
// per tile follows the rows, not the number of buckets. Each block writes
// one partial per (aggregate, bucket); a second launch folds the partials
// in block order. Tiles are dealt to blocks in a fixed pattern, so float
// sums are bit-for-bit repeatable. Keyless aggregation (TPC-H Q6, Q14)
// has nothing to order and takes its own partial kernel, which folds rows
// straight from device memory in registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_AGGS 16
#define MAX_BUCKETS 512
#define TILE 512
#define THREADS 256
#define WARPS (THREADS / 32)
#define CHUNKS (TILE / 32)
#define LONG_SEGMENT 16                   // rows; a warp folds longer ones

enum { F_COUNT = 0, F_SUM = 1, F_MIN = 2, F_MAX = 3, F_FIRST = 4 };
enum { T_F64 = 0, T_I64 = 1, T_U64 = 2 };

struct AggSpec {
  int n_aggs;
  const uint64_t* data[MAX_AGGS];   // 8-byte values; null for count/first
  const uint8_t* valid[MAX_AGGS];   // null = every row valid
  int func[MAX_AGGS];
  int type[MAX_AGGS];
};

__device__ __forceinline__ uint64_t identity(int f, int t) {
  if (f == F_MIN) {
    if (t == T_F64) return 0x7FF0000000000000ull;   // +inf
    if (t == T_I64) return 0x7FFFFFFFFFFFFFFFull;
    return 0xFFFFFFFFFFFFFFFFull;
  }
  if (f == F_MAX) {
    if (t == T_F64) return 0xFFF0000000000000ull;   // -inf
    if (t == T_I64) return 0x8000000000000000ull;
    return 0ull;
  }
  if (f == F_FIRST) return 0xFFFFFFFFFFFFFFFFull;
  return 0ull;                                      // sum, count
}

__device__ __forceinline__ uint64_t combine(int f, int t, uint64_t a,
                                            uint64_t b) {
  if (f == F_SUM) {
    if (t == T_F64)
      return __double_as_longlong(__longlong_as_double(a) +
                                  __longlong_as_double(b));
    return a + b;                                   // two's complement wrap
  }
  if (f == F_MIN || f == F_MAX) {
    bool lt;                                        // b < a
    if (t == T_F64) {
      double x = __longlong_as_double(a), y = __longlong_as_double(b);
      if (isnan(x)) return a;                       // NaN propagates
      if (isnan(y)) return b;
      lt = (f == F_MIN) ? (y < x) : (y > x);
    } else if (t == T_I64) {
      lt = (f == F_MIN) ? ((int64_t)b < (int64_t)a) : ((int64_t)b > (int64_t)a);
    } else {
      lt = (f == F_MIN) ? (b < a) : (b > a);
    }
    return lt ? b : a;
  }
  if (f == F_FIRST) return b < a ? b : a;
  return a;
}

__device__ __forceinline__ uint64_t warp_fold(int f, int t, uint64_t x) {
  for (int off = 16; off > 0; off >>= 1) {
    uint64_t y = __shfl_down_sync(0xffffffffu, x, off);
    x = combine(f, t, x, y);
  }
  return x;
}

__device__ __forceinline__ void fold_row(const AggSpec& spec, int A,
                                         uint32_t bits, const uint64_t* tv,
                                         uint64_t* la, unsigned* lc) {
#pragma unroll
  for (int a = 0; a < MAX_AGGS; ++a) {
    if (a < A && ((bits >> a) & 1u)) {
      ++lc[a];
      if (spec.func[a] != F_COUNT)
        la[a] = combine(spec.func[a], spec.type[a], la[a],
                        tv[(size_t)a * TILE]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bucket_agg_partial(int64_t n, int nb, const int32_t* kid,
                   const uint8_t* active, AggSpec spec, uint64_t* part_val,
                   unsigned long long* part_cnt,
                   unsigned long long* part_present) {
  extern __shared__ unsigned long long smem[];
  const int A = spec.n_aggs;
  uint64_t* acc = (uint64_t*)smem;                      // A * nb
  uint64_t* tval = acc + (size_t)A * nb;                // A * TILE
  uint32_t* cnt = (uint32_t*)(tval + (size_t)A * TILE); // A * nb
  uint32_t* pres = cnt + (size_t)A * nb;                // nb
  int32_t* tkid = (int32_t*)(pres + nb);                // TILE; -1 = skip
  uint32_t* tbits = (uint32_t*)(tkid + TILE);           // valid | rank<<16
  int32_t* seg0 = (int32_t*)(tbits + TILE);             // nb
  int32_t* seglen = seg0 + nb;                          // nb
  uint16_t* coff = (uint16_t*)(seglen + nb);            // CHUNKS * nb
  uint16_t* order = coff + (size_t)CHUNKS * nb;         // TILE

  for (int i = threadIdx.x; i < A * nb; i += blockDim.x) {
    const int a = i / nb;
    acc[i] = identity(spec.func[a], spec.type[a]);
    cnt[i] = 0;
  }
  for (int b = threadIdx.x; b < nb; b += blockDim.x) pres[b] = 0;
  for (int i = threadIdx.x; i < CHUNKS * nb; i += blockDim.x) coff[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t ntiles = (n + TILE - 1) / TILE;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // 1. stage the tile; count each chunk's rows per bucket and rank
    //    every row among its chunk's rows of the same bucket
#pragma unroll
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int64_t r = t * TILE + j;
      int k = -1;
      uint32_t bits = 0;
      if (r < n) {           // every load is issued before any is tested
        const bool on = active == nullptr || active[r];
        const int kk = kid ? kid[r] : 0;
#pragma unroll
        for (int a = 0; a < MAX_AGGS; ++a) {
          if (a < A) {
            if (spec.valid[a] == nullptr || spec.valid[a][r])
              bits |= 1u << a;
            uint64_t x = 0;
            if (spec.func[a] == F_FIRST) x = (uint64_t)r;
            else if (spec.data[a] != nullptr) x = spec.data[a][r];
            tval[(size_t)a * TILE + j] = x;
          }
        }
        if (on && kk >= 0 && kk < nb) k = kk;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      const unsigned before = peers & ((1u << lane) - 1u);
      if (k >= 0 && before == 0)
        coff[(j >> 5) * nb + k] = (uint16_t)__popc(peers);
      tkid[j] = k;
      tbits[j] = bits | ((uint32_t)__popc(before) << 16);
    }
    __syncthreads();
    // 2. per bucket: its rows in the tile, and each chunk's offset
    //    inside the bucket's segment
    for (int b = threadIdx.x; b < nb; b += THREADS) {
      int run = 0;
      for (int c = 0; c < CHUNKS; ++c) {
        const int x = coff[c * nb + b];
        coff[c * nb + b] = (uint16_t)run;
        run += x;
      }
      seglen[b] = run;
    }
    __syncthreads();
    // 3. segment starts: an exclusive scan of the lengths by one warp
    if (warp == 0) {
      int carry = 0;
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int b = b0 + lane;
        const int v = b < nb ? seglen[b] : 0;
        int x = v;
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x += y;
        }
        if (b < nb) seg0[b] = carry + x - v;
        carry += __shfl_sync(0xffffffffu, x, 31);
      }
    }
    __syncthreads();
    // 4. the tile's rows in bucket order, each bucket's in row order
    for (int j = threadIdx.x; j < TILE; j += THREADS) {
      const int k = tkid[j];
      if (k >= 0)
        order[seg0[k] + coff[(j >> 5) * nb + k] + (tbits[j] >> 16)] =
            (uint16_t)j;
    }
    __syncthreads();
    // 5. fold every segment into the block's accumulators: a short one
    //    by one thread, a long one by one warp (disjoint buckets)
    for (int b = threadIdx.x; b < nb; b += THREADS) {
      for (int c = 0; c < CHUNKS; ++c) coff[c * nb + b] = 0;
      const int len = seglen[b];
      if (len == 0 || len >= LONG_SEGMENT) continue;
      uint64_t la[MAX_AGGS];
      unsigned lc[MAX_AGGS];
#pragma unroll
      for (int a = 0; a < MAX_AGGS; ++a) {
        la[a] = a < A ? acc[(size_t)a * nb + b] : 0;
        lc[a] = 0;
      }
      for (int i = 0; i < len; ++i) {
        const int j = order[seg0[b] + i];
        fold_row(spec, A, tbits[j], tval + j, la, lc);
      }
#pragma unroll
      for (int a = 0; a < MAX_AGGS; ++a) {
        if (a < A) {
          acc[(size_t)a * nb + b] = la[a];
          cnt[(size_t)a * nb + b] += lc[a];
        }
      }
      pres[b] += len;
    }
    for (int b = warp; b < nb; b += WARPS) {
      const int len = seglen[b];
      if (len < LONG_SEGMENT) continue;        // uniform across the warp
      uint64_t la[MAX_AGGS];
      unsigned lc[MAX_AGGS];
#pragma unroll
      for (int a = 0; a < MAX_AGGS; ++a) {
        la[a] = a < A ? identity(spec.func[a], spec.type[a]) : 0;
        lc[a] = 0;
      }
      for (int i = lane; i < len; i += 32) {   // this lane's rows, in order
        const int j = order[seg0[b] + i];
        fold_row(spec, A, tbits[j], tval + j, la, lc);
      }
      if (lane == 0) pres[b] += len;
#pragma unroll
      for (int a = 0; a < MAX_AGGS; ++a) {
        if (a >= A) break;
        const unsigned tc = __reduce_add_sync(0xffffffffu, lc[a]);
        if (tc == 0) continue;                 // uniform across the warp
        const int f = spec.func[a], ty = spec.type[a];
        uint64_t x = 0;
        if (f != F_COUNT) x = warp_fold(f, ty, la[a]);
        if (lane == 0) {
          const size_t q = (size_t)a * nb + b;
          if (f != F_COUNT) acc[q] = combine(f, ty, acc[q], x);
          cnt[q] += tc;
        }
      }
    }
    __syncthreads();
  }
  const size_t base = (size_t)blockIdx.x * A * nb;
  for (int i = threadIdx.x; i < A * nb; i += blockDim.x) {
    part_val[base + i] = acc[i];
    part_cnt[base + i] = cnt[i];
  }
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    part_present[(size_t)blockIdx.x * nb + b] = pres[b];
}

// Keyless (one bucket, no ids): no staging and no ordering. Each thread
// folds the rows r = its global index + k * grid size in registers, lanes
// fold through the shuffle tree, and the block's first threads fold the
// warps in warp order: the same fixed order on every run.
__global__ void __launch_bounds__(THREADS)
bucket_agg_keyless(int64_t n, const uint8_t* active, AggSpec spec,
                   uint64_t* part_val, unsigned long long* part_cnt,
                   unsigned long long* part_present) {
  __shared__ uint64_t wval[WARPS][MAX_AGGS];
  __shared__ unsigned wcnt[WARPS][MAX_AGGS + 1];
  const int A = spec.n_aggs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t la[MAX_AGGS];
  unsigned lc[MAX_AGGS];
#pragma unroll
  for (int a = 0; a < MAX_AGGS; ++a) {
    la[a] = a < A ? identity(spec.func[a], spec.type[a]) : 0;
    lc[a] = 0;
  }
  unsigned lp = 0;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t r0 = (int64_t)blockIdx.x * THREADS + threadIdx.x; r0 < n;
       r0 += 2 * stride) {
    // every load of both rows is issued before any is tested
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t r = r0 + u * stride;
      if (r >= n) break;
      const bool on = active == nullptr || active[r];
      lp += on;
#pragma unroll
      for (int a = 0; a < MAX_AGGS; ++a) {
        if (a < A) {
          const int f = spec.func[a];
          const bool v = spec.valid[a] == nullptr || spec.valid[a][r];
          const uint64_t x = f == F_FIRST ? (uint64_t)r
                             : spec.data[a] != nullptr ? spec.data[a][r] : 0;
          if (on && v) {
            ++lc[a];
            if (f != F_COUNT) la[a] = combine(f, spec.type[a], la[a], x);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_AGGS; ++a) {
    if (a >= A) break;
    const unsigned c = __reduce_add_sync(0xffffffffu, lc[a]);
    const uint64_t x = spec.func[a] == F_COUNT
                           ? 0 : warp_fold(spec.func[a], spec.type[a], la[a]);
    if (lane == 0) {
      wval[warp][a] = x;
      wcnt[warp][a] = c;
    }
  }
  const unsigned p = __reduce_add_sync(0xffffffffu, lp);
  if (lane == 0) wcnt[warp][MAX_AGGS] = p;
  __syncthreads();
  if (threadIdx.x < A) {
    const int a = threadIdx.x, f = spec.func[a], ty = spec.type[a];
    uint64_t acc = identity(f, ty);
    unsigned long long c = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (f != F_COUNT) acc = combine(f, ty, acc, wval[w][a]);
      c += wcnt[w][a];
    }
    part_val[(size_t)blockIdx.x * A + a] = acc;
    part_cnt[(size_t)blockIdx.x * A + a] = c;
  }
  if (threadIdx.x == 0) {
    unsigned long long c = 0;
    for (int w = 0; w < WARPS; ++w) c += wcnt[w][MAX_AGGS];
    part_present[blockIdx.x] = c;
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// One warp per output: lane l folds the partials of blocks l, l + 32, ...
// in order, then the lanes fold through the shuffle tree. A fixed order.
__global__ void bucket_agg_final(int G, int nb, int64_t cap, AggSpec spec,
                                 const uint64_t* part_val,
                                 const unsigned long long* part_cnt,
                                 const unsigned long long* part_present,
                                 uint64_t* out_val, int64_t* out_cnt,
                                 int64_t* out_present) {
  const int A = spec.n_aggs;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i < A * nb) {
    const int a = i / nb, f = spec.func[a], ty = spec.type[a];
    uint64_t acc = identity(f, ty);
    unsigned long long c = 0;
    for (int g = lane; g < G; g += 32) {
      const size_t j = (size_t)g * A * nb + i;
      acc = combine(f, ty, acc, part_val[j]);
      c += part_cnt[j];
    }
    acc = warp_fold(f, ty, acc);
    c = warp_sum(c);
    if (lane == 0) {
      if (f == F_COUNT) acc = c;
      else if ((f == F_MIN || f == F_MAX) && c == 0) acc = 0;   // typed zero
      else if (f == F_FIRST && c == 0) acc = (uint64_t)cap;
      out_val[i] = acc;
      out_cnt[i] = (int64_t)c;
    }
  } else if (i < A * nb + nb) {
    const int b = i - A * nb;
    unsigned long long p = 0;
    for (int g = lane; g < G; g += 32) p += part_present[(size_t)g * nb + b];
    p = warp_sum(p);
    if (lane == 0) out_present[b] = (int64_t)p;
  }
}

extern "C" size_t bucket_agg_smem_bytes(int n_aggs, int nb) {
  return (size_t)n_aggs * nb * 12 + (size_t)n_aggs * TILE * 8 +
         (size_t)nb * 12 + (size_t)TILE * 8 + (size_t)CHUNKS * nb * 2 +
         (size_t)TILE * 2;
}

extern "C" int bucket_agg_launch(int64_t n, int nb, const void* kid,
                                 const void* active, int n_aggs,
                                 const int64_t* data_ptrs,
                                 const int64_t* valid_ptrs,
                                 const int32_t* funcs, const int32_t* types,
                                 int64_t cap, int G, void* part_val,
                                 void* part_cnt, void* part_present,
                                 void* out_val, void* out_cnt,
                                 void* out_present, void* stream) {
  if (n_aggs < 0 || n_aggs > MAX_AGGS || nb < 1 || nb > MAX_BUCKETS ||
      G < 1 || (kid == nullptr && nb != 1))
    return (int)cudaErrorInvalidValue;
  AggSpec spec;
  spec.n_aggs = n_aggs;
  for (int a = 0; a < MAX_AGGS; ++a) {
    const bool on = a < n_aggs;
    spec.data[a] = on ? (const uint64_t*)data_ptrs[a] : nullptr;
    spec.valid[a] = on ? (const uint8_t*)valid_ptrs[a] : nullptr;
    spec.func[a] = on ? funcs[a] : F_COUNT;
    spec.type[a] = on ? types[a] : T_I64;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (kid == nullptr) {                 // keyless: nb == 1
    bucket_agg_keyless<<<G, THREADS, 0, s>>>(
        n, (const uint8_t*)active, spec, (uint64_t*)part_val,
        (unsigned long long*)part_cnt, (unsigned long long*)part_present);
  } else {
    const size_t smem = bucket_agg_smem_bytes(n_aggs, nb);
    err = cudaFuncSetAttribute(bucket_agg_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    bucket_agg_partial<<<G, THREADS, smem, s>>>(
        n, nb, (const int32_t*)kid, (const uint8_t*)active, spec,
        (uint64_t*)part_val, (unsigned long long*)part_cnt,
        (unsigned long long*)part_present);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = n_aggs * nb + nb;
  bucket_agg_final<<<(total + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      G, nb, cap, spec, (const uint64_t*)part_val,
      (const unsigned long long*)part_cnt,
      (const unsigned long long*)part_present, (uint64_t*)out_val,
      (int64_t*)out_cnt, (int64_t*)out_present);
  return (int)cudaGetLastError();
}
