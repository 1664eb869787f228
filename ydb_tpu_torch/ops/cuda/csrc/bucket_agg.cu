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
// sums are bit-for-bit repeatable.
// Keyless aggregation (K2: TPC-H Q6, Q14, every keyless aggregate;
// bucket_agg_keyless_launch) has nothing to order. Its bound is the mask
// byte and one 8-byte value per sum a row, read once: 107 MB at Q14's
// shape (6,291,456 rows, two float64 sums), 0.0319 ms at 3.35 TB/s. It
// lives on bytes in flight, so its design is one launch over a
// persistent grid of KL_GRID blocks, two 256-thread blocks on each SM:
// each lane issues a step's loads (J 2-byte mask loads and J 16-byte
// loads a sum, every one coalesced across the warp) before it folds any,
// about 8.7 KB a warp and 139 KB a SM in flight at two sums; the common
// spec folds by a branch fixed for the launch, not per element; and the
// last block to finish folds the partials, so there is no second
// launch. See the note above keyless_finish.
// Member axis (bucket_agg_batched_launch, the batched serving lane): B
// members with their own masks over shared (or per-member) ids and
// values; see the notes above each partial kernel. The keyed
// single-query entry is the case B = 1.
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
  int64_t dstride[MAX_AGGS];        // elements between members' rows of
  int64_t vstride[MAX_AGGS];        // data / valid; 0 = shared
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

// B members (the batched serving lane): member b is block row
// blockIdx.y = b and runs the single query's body over its own mask,
// ids and per-member values (each at b times its member stride; a
// shared input has stride 0). MEMBERS = false compiles the single
// query's kernel, with the member offsets folded away.
struct Members {
  int B;                    // members in all (1 for a single query)
  const uint8_t* active;    // member b's mask at b * mask_stride; null = all
  int64_t mask_stride;
  int64_t kid_stride;       // elements between members' ids; 0 = shared
};

template <bool MEMBERS>
__global__ void __launch_bounds__(THREADS)
bucket_agg_partial(int64_t n, int nb, const int32_t* kid, Members M,
                   AggSpec spec, uint64_t* part_val,
                   unsigned long long* part_cnt,
                   unsigned long long* part_present) {
  extern __shared__ unsigned long long smem[];
  const int A = spec.n_aggs;
  const int64_t mb = MEMBERS ? blockIdx.y : 0;
  const uint8_t* active =
      M.active == nullptr ? nullptr : M.active + mb * M.mask_stride;
  if (MEMBERS) kid += mb * M.kid_stride;
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
            const int64_t vr = MEMBERS ? r + mb * spec.vstride[a] : r;
            const int64_t dr = MEMBERS ? r + mb * spec.dstride[a] : r;
            if (spec.valid[a] == nullptr || spec.valid[a][vr])
              bits |= 1u << a;
            uint64_t x = 0;
            if (spec.func[a] == F_FIRST) x = (uint64_t)r;
            else if (spec.data[a] != nullptr) x = spec.data[a][dr];
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
  const size_t part = (size_t)mb * gridDim.x + blockIdx.x;
  for (int i = threadIdx.x; i < A * nb; i += blockDim.x) {
    part_val[part * A * nb + i] = acc[i];
    part_cnt[part * A * nb + i] = cnt[i];
  }
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    part_present[part * nb + b] = pres[b];
}

// Keyless (K2: one bucket, no ids), one launch. Nothing is staged or
// ordered: each block folds its rows in registers, writes one partial per
// aggregate, and the last block to finish (a ticket) folds the partials
// in block order. Two bodies write the same partials:
// - keyless_stream, the common spec (TPC-H Q6, Q14): every aggregate a
//   count or a sum (float64, int64 or uint64) with no validity, at most
//   KL_MAX_SUMS sums, the columns 16-byte aligned. A warp takes 64 * J
//   rows a step; lane l reads the mask bytes of rows 2q, 2q + 1 as one
//   16-bit load and each sum's two values as one 16-byte load, for q =
//   step + 32 j + l, j < J: every load of a step is coalesced and issued
//   before any is folded. The sums are folded by a branch uniform over
//   the launch (float or integer), not by `combine`.
// - keyless_fold, any other spec: each thread folds the rows r = its
//   global index + k * grid size through `combine`, two rows in flight.
// Lanes fold through the shuffle tree, a block's warps in warp order, and
// the partials in block order: a fixed order, so float sums repeat bit
// for bit. The ticket is a word per stream that the last block resets.
#define KL_GRID 264                       // 2 blocks a SM on the H100's 132
#define KL_MAX_SUMS 4
#define KL_MAX_G 528                      // keyless_fold's most blocks
#define KL_STAGE 4                        // outputs the last block folds
                                          // a round

// The last block to arrive folds every block's partials: warp w takes
// outputs w, w + WARPS, ... (each aggregate, then the row count); lane l
// folds partials l, l + 32, ... in order, then the shuffle tree.
__device__ void keyless_finish(const AggSpec& spec, int64_t cap,
                               const uint64_t* part_val,
                               const unsigned long long* part_cnt,
                               const unsigned long long* part_present,
                               unsigned* ticket, uint64_t* out_val,
                               int64_t* out_cnt, int64_t* out_present) {
  __shared__ bool s_last;
  const int A = spec.n_aggs, G = gridDim.x;
  __threadfence();                      // this block's partials, then
  __syncthreads();                      // its ticket
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    s_last = t == (unsigned)G - 1;
    if (s_last) *ticket = 0;            // every block has drawn: reset
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the G partials of each output, loaded all at once (a fold of them
  // in place would wait on one L2 round trip a partial), KL_STAGE
  // outputs a round
  __shared__ unsigned long long sv[KL_STAGE][KL_MAX_G];
  __shared__ unsigned long long sc[KL_STAGE][KL_MAX_G];
  for (int i0 = 0; i0 <= A; i0 += KL_STAGE) {
    const int m = A + 1 - i0 < KL_STAGE ? A + 1 - i0 : KL_STAGE;
    for (int k = threadIdx.x; k < m * G; k += blockDim.x) {
      const int j = k / G, g = k - j * G, i = i0 + j;
      if (i < A) {
        sv[j][g] = __ldcg((const unsigned long long*)part_val +
                          (size_t)g * A + i);
        sc[j][g] = __ldcg(part_cnt + (size_t)g * A + i);
      } else {
        sc[j][g] = __ldcg(part_present + g);
      }
    }
    __syncthreads();
    // warp j folds output i0 + j: lane l the partials l, l + 32, ... in
    // order, then the shuffle tree
    if (warp < m) {
      const int i = i0 + warp;
      const int f = i < A ? spec.func[i] : F_COUNT;
      const int ty = i < A ? spec.type[i] : T_I64;
      uint64_t acc = identity(f, ty);
      unsigned long long c = 0;
      for (int g = lane; g < G; g += 32) {
        if (f != F_COUNT) acc = combine(f, ty, acc, sv[warp][g]);
        c += sc[warp][g];
      }
      if (f != F_COUNT) acc = warp_fold(f, ty, acc);
      for (int off = 16; off > 0; off >>= 1)
        c += __shfl_down_sync(0xffffffffu, c, off);
      if (lane == 0) {
        if (i == A) {
          *out_present = (int64_t)c;
        } else {
          if (f == F_COUNT) acc = c;
          else if ((f == F_MIN || f == F_MAX) && c == 0) acc = 0;  // typed 0
          else if (f == F_FIRST && c == 0) acc = (uint64_t)cap;
          out_val[i] = acc;
          out_cnt[i] = (int64_t)c;
        }
      }
    }
    __syncthreads();
  }
}

// Streaming loads: read once, so they skip L1 (L1::no_allocate).
__device__ __forceinline__ ulonglong2 load_stream(const uint64_t* p) {
  ulonglong2 r;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u64 {%0, %1}, [%2];"
               : "=l"(r.x), "=l"(r.y) : "l"(p));
  return r;
}

__device__ __forceinline__ unsigned load_stream(const uint8_t* p) {
  unsigned short r;                     // two mask bytes
  asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];"
               : "=h"(r) : "l"(p));
  return r;
}

// The common spec's sums: column d of `data`, float64 where bit d of
// `fmask` is set (else a wrapping integer sum). Aggregate a is a sum
// where bit a of `sums` is set, of column popc(sums & ((1 << a) - 1)),
// else a count.
struct StreamSpec {
  const uint64_t* data[KL_MAX_SUMS];
  unsigned fmask;
  unsigned sums;
};

template <int D, int J>
__global__ void __launch_bounds__(THREADS, 2)
keyless_stream(int64_t n, const uint8_t* active, StreamSpec S, AggSpec spec,
               int64_t cap, uint64_t* part_val,
               unsigned long long* part_cnt,
               unsigned long long* part_present, unsigned* ticket,
               uint64_t* out_val, int64_t* out_cnt, int64_t* out_present) {
  __shared__ uint64_t wsum[WARPS][D > 0 ? D : 1];
  __shared__ unsigned wcnt[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t step_rows = (int64_t)WARPS * 64 * J;
  const int64_t steps = (n + step_rows - 1) / step_rows;
  double fs[D > 0 ? D : 1];
  uint64_t is[D > 0 ? D : 1];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    fs[d] = 0.0;
    is[d] = 0;
  }
  unsigned cnt = 0;
  for (int64_t s = blockIdx.x; s < steps; s += gridDim.x) {
    const int64_t w0 = s * step_rows + (int64_t)warp * 64 * J;
    unsigned m[J];
    ulonglong2 x[D > 0 ? D : 1][J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int64_t e = w0 + 64 * j + 2 * lane;     // rows e, e + 1
      if (e + 1 < n) {
        m[j] = load_stream(active + e);
#pragma unroll
        for (int d = 0; d < D; ++d) x[d][j] = load_stream(S.data[d] + e);
      } else {
        const bool one = e < n;
        m[j] = one ? active[e] : 0u;
#pragma unroll
        for (int d = 0; d < D; ++d)
          x[d][j] = make_ulonglong2(one ? S.data[d][e] : 0ull, 0ull);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const bool a0 = (m[j] & 0xFFu) != 0, a1 = (m[j] >> 8) != 0;
      cnt += (unsigned)a0 + (unsigned)a1;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if ((S.fmask >> d) & 1u) {
          fs[d] += a0 ? __longlong_as_double(x[d][j].x) : 0.0;
          fs[d] += a1 ? __longlong_as_double(x[d][j].y) : 0.0;
        } else {
          is[d] += a0 ? x[d][j].x : 0ull;
          is[d] += a1 ? x[d][j].y : 0ull;
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool fl = (S.fmask >> d) & 1u;
    uint64_t v = fl ? (uint64_t)__double_as_longlong(fs[d]) : is[d];
    v = warp_fold(F_SUM, fl ? T_F64 : T_I64, v);
    if (lane == 0) wsum[warp][d] = v;
  }
  const unsigned c = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) wcnt[warp] = c;
  __syncthreads();
  const int A = spec.n_aggs;
  const size_t g = blockIdx.x;
  if ((int)threadIdx.x < A) {
    const int a = threadIdx.x;
    const int d = ((S.sums >> a) & 1u) ? __popc(S.sums & ((1u << a) - 1u))
                                       : -1;
    uint64_t acc = 0;
    if (d >= 0) {
      const int ty = ((S.fmask >> d) & 1u) ? T_F64 : T_I64;
      for (int w = 0; w < WARPS; ++w)
        acc = combine(F_SUM, ty, acc, wsum[w][d]);
    }
    unsigned long long tc = 0;
    for (int w = 0; w < WARPS; ++w) tc += wcnt[w];
    part_val[g * A + a] = acc;
    part_cnt[g * A + a] = tc;
  }
  if (threadIdx.x == 0) {
    unsigned long long tc = 0;
    for (int w = 0; w < WARPS; ++w) tc += wcnt[w];
    part_present[g] = tc;
  }
  keyless_finish(spec, cap, part_val, part_cnt, part_present, ticket,
                 out_val, out_cnt, out_present);
}

// Any other spec: each thread folds the rows r = its global index + k *
// grid size in registers through `combine`, two rows in flight.
__global__ void __launch_bounds__(THREADS)
keyless_fold(int64_t n, const uint8_t* active, AggSpec spec, int64_t cap,
             uint64_t* part_val, unsigned long long* part_cnt,
             unsigned long long* part_present, unsigned* ticket,
             uint64_t* out_val, int64_t* out_cnt, int64_t* out_present) {
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
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t r = r0 + u * stride;
      if (r >= n) break;
      const bool on = active[r];
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
  if ((int)threadIdx.x < A) {
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
  keyless_finish(spec, cap, part_val, part_cnt, part_present, ticket,
                 out_val, out_cnt, out_present);
}

#define SLOTS 8                           // keyless members' register slots

// Keyless for B members: each thread folds its rows in registers, one
// slot per (member, aggregate) of its block's members (per_block x
// n_aggs <= SLOTS slots, their member and aggregate worked out once;
// more members take more block rows along y),
// lanes fold through the shuffle tree, and the block's first threads
// fold the warps in warp order: a fixed order. A shared value is read
// from device memory once per row; the other members' reads of it hit L1.
__global__ void __launch_bounds__(THREADS, 2)
bucket_agg_keyless_batched(int64_t n, Members M, int per_block,
                           AggSpec spec,
                           uint64_t* part_val, unsigned long long* part_cnt,
                           unsigned long long* part_present) {
  __shared__ uint64_t wval[WARPS][SLOTS];
  __shared__ unsigned wcnt[WARPS][SLOTS];
  __shared__ unsigned wpres[WARPS][SLOTS];
  const int A = spec.n_aggs;
  const int b0 = blockIdx.y * per_block;
  const int nm = M.B - b0 < per_block ? M.B - b0 : per_block;
  const int S = nm * A;                    // live (member, aggregate) slots
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t la[SLOTS];
  unsigned lc[SLOTS], lp[SLOTS];
  int sm[SLOTS], sa[SLOTS];          // slot -> member, aggregate
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    sm[i] = i < S ? i / A : 0;
    sa[i] = i < S ? i % A : 0;
    la[i] = i < S ? identity(spec.func[sa[i]], spec.type[sa[i]]) : 0;
    lc[i] = 0;
    lp[i] = 0;
  }
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t r0 = (int64_t)blockIdx.x * THREADS + threadIdx.x; r0 < n;
       r0 += 2 * stride) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t r = r0 + u * stride;
      if (r >= n) break;
#pragma unroll
      for (int m = 0; m < SLOTS; ++m)
        if (m < nm)
          lp[m] += M.active == nullptr ||
                   M.active[(b0 + m) * M.mask_stride + r];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        if (i < S) {
          const int a = sa[i], f = spec.func[a];
          const int64_t b = b0 + sm[i];
          const bool on = M.active == nullptr ||
                          M.active[b * M.mask_stride + r];
          const bool v = spec.valid[a] == nullptr ||
                         spec.valid[a][b * spec.vstride[a] + r];
          const uint64_t x =
              f == F_FIRST ? (uint64_t)r
              : spec.data[a] != nullptr
                  ? spec.data[a][b * spec.dstride[a] + r] : 0;
          if (on && v) {
            ++lc[i];
            if (f != F_COUNT) la[i] = combine(f, spec.type[a], la[i], x);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (i >= S) break;
    const int f = spec.func[sa[i]];
    const unsigned c = __reduce_add_sync(0xffffffffu, lc[i]);
    const uint64_t x =
        f == F_COUNT ? 0 : warp_fold(f, spec.type[sa[i]], la[i]);
    if (lane == 0) {
      wval[warp][i] = x;
      wcnt[warp][i] = c;
    }
  }
#pragma unroll
  for (int m = 0; m < SLOTS; ++m) {
    if (m >= nm) break;
    const unsigned c = __reduce_add_sync(0xffffffffu, lp[m]);
    if (lane == 0) wpres[warp][m] = c;
  }
  __syncthreads();
  if ((int)threadIdx.x < S) {
    const int i = threadIdx.x, m = i / A, a = i - m * A;
    const int f = spec.func[a], ty = spec.type[a];
    uint64_t acc = identity(f, ty);
    unsigned long long c = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (f != F_COUNT) acc = combine(f, ty, acc, wval[w][i]);
      c += wcnt[w][i];
    }
    const size_t part = (size_t)(b0 + m) * gridDim.x + blockIdx.x;
    part_val[part * A + a] = acc;
    part_cnt[part * A + a] = c;
  }
  if ((int)threadIdx.x < nm) {
    unsigned long long c = 0;
    for (int w = 0; w < WARPS; ++w) c += wpres[w][threadIdx.x];
    part_present[(size_t)(b0 + threadIdx.x) * gridDim.x + blockIdx.x] = c;
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// One warp per output: lane l folds the partials of blocks l, l + 32, ...
// in order, then the lanes fold through the shuffle tree. A fixed order.
// Outputs per member b: out_val / out_cnt (b, a, bucket), out_present
// (b, bucket).
__global__ void bucket_agg_final(int G, int nb, int64_t cap, int B,
                                 AggSpec spec, const uint64_t* part_val,
                                 const unsigned long long* part_cnt,
                                 const unsigned long long* part_present,
                                 uint64_t* out_val, int64_t* out_cnt,
                                 int64_t* out_present) {
  const int A = spec.n_aggs;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int per = A * nb + nb;
  const int64_t b = w / per;
  const int i = (int)(w % per);
  if (b >= B) return;
  if (i < A * nb) {
    const int a = i / nb, f = spec.func[a], ty = spec.type[a];
    uint64_t acc = identity(f, ty);
    unsigned long long c = 0;
    for (int g = lane; g < G; g += 32) {
      const size_t j = ((size_t)b * G + g) * A * nb + i;
      acc = combine(f, ty, acc, part_val[j]);
      c += part_cnt[j];
    }
    acc = warp_fold(f, ty, acc);
    c = warp_sum(c);
    if (lane == 0) {
      if (f == F_COUNT) acc = c;
      else if ((f == F_MIN || f == F_MAX) && c == 0) acc = 0;   // typed zero
      else if (f == F_FIRST && c == 0) acc = (uint64_t)cap;
      out_val[(size_t)b * A * nb + i] = acc;
      out_cnt[(size_t)b * A * nb + i] = (int64_t)c;
    }
  } else {
    const int k = i - A * nb;
    unsigned long long p = 0;
    for (int g = lane; g < G; g += 32)
      p += part_present[((size_t)b * G + g) * nb + k];
    p = warp_sum(p);
    if (lane == 0) out_present[(size_t)b * nb + k] = (int64_t)p;
  }
}

extern "C" size_t bucket_agg_smem_bytes(int n_aggs, int nb) {
  return (size_t)n_aggs * nb * 12 + (size_t)n_aggs * TILE * 8 +
         (size_t)nb * 12 + (size_t)TILE * 8 + (size_t)CHUNKS * nb * 2 +
         (size_t)TILE * 2;
}

static AggSpec make_spec(int n_aggs, const int64_t* data_ptrs,
                         const int64_t* data_strides,
                         const int64_t* valid_ptrs,
                         const int64_t* valid_strides, const int32_t* funcs,
                         const int32_t* types) {
  AggSpec spec;
  spec.n_aggs = n_aggs;
  for (int a = 0; a < MAX_AGGS; ++a) {
    const bool on = a < n_aggs;
    spec.data[a] = on ? (const uint64_t*)data_ptrs[a] : nullptr;
    spec.valid[a] = on ? (const uint8_t*)valid_ptrs[a] : nullptr;
    spec.func[a] = on ? funcs[a] : F_COUNT;
    spec.type[a] = on ? types[a] : T_I64;
    spec.dstride[a] = on && data_strides && spec.data[a] ? data_strides[a]
                                                         : 0;
    spec.vstride[a] = on && valid_strides && spec.valid[a]
                          ? valid_strides[a] : 0;
  }
  return spec;
}

// Keyed (nb buckets) and member-axis aggregation: the partial kernel,
// then bucket_agg_final.
static int launch(int64_t n, int nb, const void* kid, Members M, int n_aggs,
                  const int64_t* data_ptrs, const int64_t* data_strides,
                  const int64_t* valid_ptrs, const int64_t* valid_strides,
                  const int32_t* funcs, const int32_t* types, int64_t cap,
                  int G, void* part_val, void* part_cnt, void* part_present,
                  void* out_val, void* out_cnt, void* out_present,
                  void* stream) {
  // keyless members: as many per block as their slots hold
  const int per_block = kid != nullptr || n_aggs > SLOTS ? 1
                        : SLOTS / (n_aggs > 0 ? n_aggs : 1);
  const int rows = (M.B + per_block - 1) / per_block;
  if (n_aggs < 0 || n_aggs > MAX_AGGS || nb < 1 || nb > MAX_BUCKETS ||
      G < 1 || (kid == nullptr && nb != 1) || M.B < 1 || rows > 65535 ||
      (kid == nullptr && n_aggs > SLOTS))
    return (int)cudaErrorInvalidValue;
  const AggSpec spec = make_spec(n_aggs, data_ptrs, data_strides,
                                 valid_ptrs, valid_strides, funcs, types);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const dim3 grid(G, rows);
  if (kid == nullptr) {                 // keyless members: nb == 1
    bucket_agg_keyless_batched<<<grid, THREADS, 0, s>>>(
        n, M, per_block, spec, (uint64_t*)part_val,
        (unsigned long long*)part_cnt, (unsigned long long*)part_present);
  } else {
    const size_t smem = bucket_agg_smem_bytes(n_aggs, nb);
    auto kernel = M.B > 1 ? &bucket_agg_partial<true>
                          : &bucket_agg_partial<false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, s>>>(
        n, nb, (const int32_t*)kid, M, spec, (uint64_t*)part_val,
        (unsigned long long*)part_cnt, (unsigned long long*)part_present);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)M.B * (n_aggs * nb + nb);
  bucket_agg_final<<<(unsigned)((total + WARPS - 1) / WARPS), THREADS, 0,
                     s>>>(G, nb, cap, M.B, spec, (const uint64_t*)part_val,
                          (const unsigned long long*)part_cnt,
                          (const unsigned long long*)part_present,
                          (uint64_t*)out_val, (int64_t*)out_cnt,
                          (int64_t*)out_present);
  return (int)cudaGetLastError();
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
  const Members M = {1, (const uint8_t*)active, 0, 0};
  return launch(n, nb, kid, M, n_aggs, data_ptrs, nullptr, valid_ptrs,
                nullptr, funcs, types, cap, G, part_val, part_cnt,
                part_present, out_val, out_cnt, out_present, stream);
}

// B members: masks (B, n) rows mask_stride apart; ids shared (kid_stride
// 0) or per member; each aggregate's data and validity shared or per
// member (strides in elements). Partials B * G * n_aggs * nb; outputs
// (B, n_aggs, nb) and (B, nb).
extern "C" int bucket_agg_batched_launch(
    int64_t n, int nb, const void* kid, int64_t kid_stride, int B,
    const void* masks, int64_t mask_stride, int n_aggs,
    const int64_t* data_ptrs, const int64_t* data_strides,
    const int64_t* valid_ptrs, const int64_t* valid_strides,
    const int32_t* funcs, const int32_t* types, int64_t cap, int G,
    void* part_val, void* part_cnt, void* part_present, void* out_val,
    void* out_cnt, void* out_present, void* stream) {
  const Members M = {B, (const uint8_t*)masks, mask_stride, kid_stride};
  return launch(n, nb, kid, M, n_aggs, data_ptrs, data_strides, valid_ptrs,
                valid_strides, funcs, types, cap, G, part_val, part_cnt,
                part_present, out_val, out_cnt, out_present, stream);
}

template <int D, int J>
static void stream_launch(int G, cudaStream_t s, int64_t n,
                          const uint8_t* active, const StreamSpec& S,
                          const AggSpec& spec, int64_t cap, void* pv,
                          void* pc, void* pp, void* ticket, void* ov,
                          void* oc, void* op) {
  keyless_stream<D, J><<<G, THREADS, 0, s>>>(
      n, active, S, spec, cap, (uint64_t*)pv, (unsigned long long*)pc,
      (unsigned long long*)pp, (unsigned*)ticket, (uint64_t*)ov,
      (int64_t*)oc, (int64_t*)op);
}

// A single keyless query (K2), one launch. J = 0 takes keyless_fold; J >
// 0 keyless_stream with J 16-byte loads a sum a lane a step (the wrapper's
// plan: 8 for up to two sums, else 4), which needs the common spec and
// aligned columns. Partials G * n_aggs values and counts, G row counts;
// `ticket` one zeroed word per stream; outputs n_aggs values and counts
// and the row count.
extern "C" int bucket_agg_keyless_launch(
    int64_t n, const void* active, int n_aggs, const int64_t* data_ptrs,
    const int64_t* valid_ptrs, const int32_t* funcs, const int32_t* types,
    int64_t cap, int J, int G, void* part_val, void* part_cnt,
    void* part_present, void* ticket, void* out_val, void* out_cnt,
    void* out_present, void* stream) {
  if (n_aggs < 0 || n_aggs > MAX_AGGS || G < 1 || active == nullptr ||
      ticket == nullptr || (J != 0 && J != 4 && J != 8) ||
      G > (J == 0 ? KL_MAX_G : KL_GRID))
    return (int)cudaErrorInvalidValue;
  const AggSpec spec = make_spec(n_aggs, data_ptrs, nullptr, valid_ptrs,
                                 nullptr, funcs, types);
  cudaStream_t s = (cudaStream_t)stream;
  if (J == 0) {
    keyless_fold<<<G, THREADS, 0, s>>>(
        n, (const uint8_t*)active, spec, cap, (uint64_t*)part_val,
        (unsigned long long*)part_cnt, (unsigned long long*)part_present,
        (unsigned*)ticket, (uint64_t*)out_val, (int64_t*)out_cnt,
        (int64_t*)out_present);
    return (int)cudaGetLastError();
  }
  StreamSpec S;
  S.fmask = 0;
  S.sums = 0;
  int D = 0;
  bool ok = (uintptr_t)active % 2 == 0;
  for (int d = 0; d < KL_MAX_SUMS; ++d) S.data[d] = nullptr;
  for (int a = 0; a < n_aggs && ok; ++a) {
    if (spec.valid[a] != nullptr) ok = false;
    else if (spec.func[a] == F_COUNT) ok = spec.data[a] == nullptr;
    else if (spec.func[a] != F_SUM || spec.data[a] == nullptr ||
             D == KL_MAX_SUMS || (uintptr_t)spec.data[a] % 16 != 0)
      ok = false;
    else {
      S.sums |= 1u << a;
      S.data[D] = spec.data[a];
      if (spec.type[a] == T_F64) S.fmask |= 1u << D;
      ++D;
    }
  }
  if (!ok || J != (D <= 2 ? 8 : 4)) return (int)cudaErrorInvalidValue;
  const uint8_t* act = (const uint8_t*)active;
  switch (D) {
    case 0: stream_launch<0, 8>(G, s, n, act, S, spec, cap, part_val,
                                part_cnt, part_present, ticket, out_val,
                                out_cnt, out_present); break;
    case 1: stream_launch<1, 8>(G, s, n, act, S, spec, cap, part_val,
                                part_cnt, part_present, ticket, out_val,
                                out_cnt, out_present); break;
    case 2: stream_launch<2, 8>(G, s, n, act, S, spec, cap, part_val,
                                part_cnt, part_present, ticket, out_val,
                                out_cnt, out_present); break;
    case 3: stream_launch<3, 4>(G, s, n, act, S, spec, cap, part_val,
                                part_cnt, part_present, ticket, out_val,
                                out_cnt, out_present); break;
    default: stream_launch<4, 4>(G, s, n, act, S, spec, cap, part_val,
                                 part_cnt, part_present, ticket, out_val,
                                 out_cnt, out_present); break;
  }
  return (int)cudaGetLastError();
}
