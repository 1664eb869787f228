// bucket_agg — per-bucket masked aggregation for bounded key domains.
//
// Replaces ydb_tpu/ops/xla_exec.py:_groupby_global (keyless: one bucket)
// and the aggregation core of _groupby_small_domain (<= 512 buckets), and
// for the batched serving lane their vmap inside ops/fused.py
// build_fused_batched_fn (K2/K3 xB): B members, each with its own mask
// over ids and values that are shared (member stride 0) or per member.
// Bound on the H100: bytes. Every row is read once (bucket id, each
// member's mask byte, validity, one 8-byte value per aggregate, a shared
// input once for every member) and the outputs are small, so the floor is
// the input bytes over 3.35 TB/s.
// Keyed (K3 and its member form, bucket_agg_members; a single query is
// the case B = 1): nothing is ordered across a block. A tile of 1,024
// rows is 32 chunks of 32 rows; a warp orders each chunk by bucket id
// alone (a stable rank from a ballot per id bit, no shared counters per
// bucket), once for every member, since the order does not depend on the
// masks; the tile's member masks and shared validity columns are staged
// as bits per row with coalesced loads at the same time. Then a warp
// folds its slots (a slot: one (member, aggregate), or a member's row
// count) over its chunks, two chunks a round: the lanes take the chunk's
// rows in bucket order, a segmented shuffle scan folds each bucket's run
// (its steps end at the chunk's longest run: one or two at hundreds of
// buckets), and the run's last lane folds it into the slot's accumulator
// in shared memory. A shared value column is loaded once per chunk for
// each aggregate, and the next slot's values are in flight while a slot
// folds. Lanes work on rows, not buckets, so a few hot buckets (TPC-H
// Q1) keep every lane busy. No two lanes or warps share an accumulator:
// a warp's slots are its own, and for small domains the block keeps P
// copies (one per partition of a tile's chunks) so that more warps fold
// at once. The function and type of a slot are uniform over the warp:
// one branch for 32 rows. The accumulators live across a block's tiles
// (tiles f, f + F, ...) and are written once as its partial; a second
// kernel folds the F partials of each output in order, with coalesced
// reads. A block row holds as many slots as its shared memory takes:
// all of them at Q1's shape, 17 at 512 buckets x 16 aggregates (two
// aggregates of every member at B = 8: each value column is read by one
// block row, the ids and masks by every row).
// The fold order of a member's slot depends on the ids, the row count
// and the plan's P and F, which follow the shape alone (rows, buckets,
// distinct aggregates), never B or the other members: member b of a
// batched call equals a single call over its mask bit for bit, and calls
// repeat bit for bit.
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
// launch. See the note above keyless_finish. Keyless members
// (keyless_members) stream the same way: each shared value is loaded
// once for every member of the block, beside each member's mask bytes;
// other specs take the keyed body with one bucket.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_AGGS 16
#define MAX_BUCKETS 512
#define THREADS 256
#define WARPS (THREADS / 32)

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

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
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

// --------------------------------------------------------------------------
// Keyed aggregation (K3) and its member form (K2/K3 xB): see the top.

#define KT_CHUNKS 32                      // 32-row chunks a tile
#define KT_TILE (KT_CHUNKS * 32)          // 1,024 rows a tile
#define KT_TILE_BYTES (KT_TILE * 7)       // a tile's order (key, lane) and
                                          // staged bits (members, validity)
#define KT_STAGED 16                      // staged members, validity columns
#define KT_GROUP 1                        // slots a group (registers: 80)
#define KT_MAX_SMEM 114688                // two blocks a SM

// The plan (bindings.bucket_agg_plan). A member's slots are its n_aggs
// aggregates, then its row count (slot n_aggs); slot (member m,
// aggregate j) is s = j * B + m. With shared ids (RPM = 0) block row y
// takes the slots [y * SR, y * SR + SR); with per-member ids member m
// takes RPM block rows, row r its aggregates [r * SR, r * SR + SR).
struct Keyed {
  int64_t n;
  int nb;                   // buckets; key nb: no bucket (an id out of
  int kbits;                // range, or a row past n); bits of nb
  const int32_t* kid;       // null: every row in bucket 0
  int64_t kid_stride;       // elements between members' ids (RPM > 0)
  const uint8_t* masks;     // member m's row at m * mask_stride
  int64_t mask_stride;
  int B;
  int S1;                   // slots a member: n_aggs + 1
  int SR;                   // slots a block row
  int RPM;                  // block rows a member (per-member ids), or 0
  int P;                    // chunk partitions a block: 1, 2, 4 or 8
};

__device__ __forceinline__ int row_slots(const Keyed& K, int y) {
  const int left = K.RPM ? K.S1 - (y % K.RPM) * K.SR
                         : K.S1 * K.B - y * K.SR;
  return left < K.SR ? left : K.SR;
}

__device__ __forceinline__ void slot_of(const Keyed& K, int y, int i,
                                        int& j, int& m) {
  if (K.RPM) {
    m = y / K.RPM;
    j = (y % K.RPM) * K.SR + i;
  } else {
    const int s = y * K.SR + i;
    j = s / K.B;
    m = s - j * K.B;
  }
}

// The spec in shared memory: a slot's aggregate is a runtime index, and
// an indexed kernel parameter would go through a stack copy. Entry
// n_aggs (at most MAX_AGGS) is the row count: a count with no validity.
struct SpecSmem {
  const unsigned long long* data[MAX_AGGS + 1];
  const uint8_t* valid[MAX_AGGS + 1];
  int64_t dstride[MAX_AGGS + 1];
  int64_t vstride[MAX_AGGS + 1];
  int func[MAX_AGGS + 1];
  int type[MAX_AGGS + 1];
};

__device__ __forceinline__ void spec_to_smem(const AggSpec& spec,
                                             SpecSmem& s) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int a = 0; a <= MAX_AGGS; ++a) {
      const bool on = a < MAX_AGGS && a < spec.n_aggs;
      s.data[a] = on ? (const unsigned long long*)spec.data[a] : nullptr;
      s.valid[a] = on ? spec.valid[a] : nullptr;
      s.dstride[a] = on ? spec.dstride[a] : 0;
      s.vstride[a] = on ? spec.vstride[a] : 0;
      s.func[a] = on ? spec.func[a] : F_COUNT;
      s.type[a] = on ? spec.type[a] : T_I64;
    }
  }
  __syncthreads();
}

// The slot after (j, m) in a block row: a row of shared ids holds
// aggregate j's slots of members m, m + 1, ... side by side, a row of
// per-member ids one member's aggregates.
__device__ __forceinline__ void next_slot(const Keyed& K, int& j, int& m) {
  if (K.RPM) {
    ++j;
  } else if (++m == K.B) {
    m = 0;
    ++j;
  }
}

// A chunk as the warp sees it in bucket order: lane l holds the chunk's
// l-th row by bucket, the row's staged bits and its run's place (kept
// small: a warp holds two chunks beside a group's values).
struct Chunk {
  int r;                    // the row in the tile
  int key;                  // its bucket; nb: no row
  int seg0;                 // the first lane of its run
  int span;                 // the chunk's longest run
  unsigned bits;            // member bits | validity bits << 16 (staged)
  bool tail;                // the last lane of its run
};

// The chunk's rows, from the tile's order and staged bits: all the
// loads of a round need are these.
__device__ __forceinline__ void chunk_rows(const uint16_t* skey,
                                           const uint8_t* sidx,
                                           const uint16_t* smb,
                                           const uint16_t* svb, int c,
                                           int lane, Chunk& C) {
  const int at = c * 32 + lane;
  C.r = c * 32 + sidx[at];
  C.key = skey[at];
  C.bits = (unsigned)smb[C.r] | (unsigned)svb[C.r] << 16;
}

// The chunk's runs of equal keys (warp collectives).
__device__ __forceinline__ void chunk_runs(int lane, unsigned le, Chunk& C) {
  const int kp = __shfl_up_sync(0xffffffffu, C.key, 1);
  const int kn = __shfl_down_sync(0xffffffffu, C.key, 1);
  const unsigned heads =
      __ballot_sync(0xffffffffu, lane == 0 || kp != C.key);
  C.tail = lane == 31 || kn != C.key;
  C.seg0 = 31 - __clz(heads & le);
  C.span = (int)__reduce_max_sync(0xffffffffu, (unsigned)(lane - C.seg0 + 1));
}

// No rows: the second chunk of a round past the partition's last.
__device__ __forceinline__ void dead_chunk(int nb, int lane, Chunk& C) {
  C.r = 0;
  C.key = nb;
  C.seg0 = lane;
  C.span = 1;
  C.bits = 0;
  C.tail = false;
}

// Member m's mask at the chunk row (live: key < nb): staged, bit 0 the
// row's member (per-member ids) or bit m (at most KT_STAGED members),
// else loaded.
__device__ __forceinline__ bool member_on(const Keyed& K, const Chunk& C,
                                          int64_t base, int m) {
  if (C.key >= K.nb) return false;
  if (K.RPM) return C.bits & 1u;
  if (K.B <= KT_STAGED) return (C.bits >> m) & 1u;
  return __ldg(K.masks + m * K.mask_stride + base + C.r) != 0;
}

// Aggregate j's validity for member m at the chunk row: a shared column
// of the row's first KT_STAGED aggregates (from jlo) staged, else loaded.
__device__ __forceinline__ bool valid_on(const SpecSmem& S, const Chunk& C,
                                         int64_t base, int j, int m,
                                         int jlo) {
  if (S.valid[j] == nullptr) return true;
  if (S.vstride[j] == 0 && j - jlo < KT_STAGED)
    return (C.bits >> (16 + j - jlo)) & 1u;
  return __ldg(S.valid[j] + m * S.vstride[j] + base + C.r) != 0;
}

// The values of KT_GROUP slots from slot g0 (aggregate j, member m, both
// advanced past the group) at both chunks' rows, every load issued
// before any is used.
__device__ __forceinline__ void group_loads(const Keyed& K,
                                            const SpecSmem& S,
                                            const Chunk& C0, const Chunk& C1,
                                            int64_t base, int g0, int i1,
                                            int& j, int& m,
                                            unsigned long long* x0,
                                            unsigned long long* x1) {
#pragma unroll
  for (int u = 0; u < KT_GROUP; ++u) {
    x0[u] = x1[u] = 0;
    if (g0 + u < i1 && S.data[j] != nullptr) {
      const unsigned long long* dp = S.data[j] + m * S.dstride[j] + base;
      if (C0.key < K.nb) x0[u] = __ldg(dp + C0.r);
      if (C1.key < K.nb) x1[u] = __ldg(dp + C1.r);
    }
    next_slot(K, j, m);
  }
}

// One slot over two chunks (a and b, in that order): each run's lanes
// folded by the run scan (both chunks' scans side by side), each run's
// last lane folds the result into the slot's accumulator of its bucket,
// chunk a's runs before chunk b's. `fn` and `ty` are the slot's, uniform
// over the warp: one branch.
__device__ __forceinline__ void fold2(const Chunk& A, const Chunk& Bc,
                                      int nb, int64_t base, int lane,
                                      unsigned le, bool on_a,
                                      unsigned long long xa, bool on_b,
                                      unsigned long long xb, int fn, int ty,
                                      uint64_t* acc, unsigned* cnt) {
  const unsigned oa = __ballot_sync(0xffffffffu, on_a);
  const unsigned ob = __ballot_sync(0xffffffffu, on_b);
  if ((oa | ob) == 0) return;                           // uniform
  const int span = A.span > Bc.span ? A.span : Bc.span;
  const unsigned run_a = le & ~((1u << A.seg0) - 1u);   // the run's lanes
  const unsigned run_b = le & ~((1u << Bc.seg0) - 1u);  // up to this one
  unsigned long long va = 0, vb = 0;
  if (fn == F_SUM && ty == T_F64) {
    double a = on_a ? __longlong_as_double(xa) : 0.0;
    double b = on_b ? __longlong_as_double(xb) : 0.0;
    for (int d = 1; d < span; d <<= 1) {
      const double ya = __shfl_up_sync(0xffffffffu, a, d);
      const double yb = __shfl_up_sync(0xffffffffu, b, d);
      if (lane - d >= A.seg0) a = ya + a;
      if (lane - d >= Bc.seg0) b = yb + b;
    }
    va = __double_as_longlong(a);
    vb = __double_as_longlong(b);
  } else if (fn == F_SUM) {
    unsigned long long a = on_a ? xa : 0ull, b = on_b ? xb : 0ull;
    for (int d = 1; d < span; d <<= 1) {
      const unsigned long long ya = __shfl_up_sync(0xffffffffu, a, d);
      const unsigned long long yb = __shfl_up_sync(0xffffffffu, b, d);
      if (lane - d >= A.seg0) a = ya + a;
      if (lane - d >= Bc.seg0) b = yb + b;
    }
    va = a;
    vb = b;
  } else if (fn == F_FIRST) {          // rows keep their order in a run
    const unsigned fa = oa & run_a, fb = ob & run_b;
    va = (unsigned long long)base +
         __shfl_sync(0xffffffffu, A.r, fa ? __ffs(fa) - 1 : lane);
    vb = (unsigned long long)base +
         __shfl_sync(0xffffffffu, Bc.r, fb ? __ffs(fb) - 1 : lane);
  } else if (fn != F_COUNT) {
    const unsigned long long id = identity(fn, ty);
    unsigned long long a = on_a ? xa : id, b = on_b ? xb : id;
    for (int d = 1; d < span; d <<= 1) {
      const unsigned long long ya = __shfl_up_sync(0xffffffffu, a, d);
      const unsigned long long yb = __shfl_up_sync(0xffffffffu, b, d);
      if (lane - d >= A.seg0) a = combine(fn, ty, ya, a);
      if (lane - d >= Bc.seg0) b = combine(fn, ty, yb, b);
    }
    va = a;
    vb = b;
  }
  const unsigned ca = __popc(oa & run_a), cb = __popc(ob & run_b);
  if (A.tail && A.key < nb && ca != 0) {
    if (fn != F_COUNT) acc[A.key] = combine(fn, ty, acc[A.key], va);
    cnt[A.key] += ca;
  }
  __syncwarp();                        // chunk a's folds before chunk b's
  if (Bc.tail && Bc.key < nb && cb != 0) {
    if (fn != F_COUNT) acc[Bc.key] = combine(fn, ty, acc[Bc.key], vb);
    cnt[Bc.key] += cb;
  }
  __syncwarp();
}

// Block (row y, tile group f) folds the tiles f, f + F, ... into its
// slots' accumulators (P copies: partition p folds the chunks p, p + P,
// ... of each tile), then writes the copies folded in order as its
// partial, (F, S1 * B, nb) values and counts.
__global__ void __launch_bounds__(THREADS, 3)
bucket_agg_members(Keyed K, AggSpec spec, uint64_t* part_val,
                   unsigned* part_cnt) {
  extern __shared__ unsigned long long smem[];
  __shared__ SpecSmem S;
  __shared__ uint16_t skey[KT_TILE];        // the tile's order: key and
  __shared__ uint8_t sidx[KT_TILE];         // lane by chunk position;
  __shared__ uint16_t smb[KT_TILE];         // each row's member bits and
  __shared__ uint16_t svb[KT_TILE];         // validity bits
  spec_to_smem(spec, S);
  const int nb = K.nb, P = K.P, Q = WARPS / P;
  const int y = blockIdx.x, f = blockIdx.y, F = gridDim.y;
  const int R = row_slots(K, y);
  const size_t ps = (size_t)K.SR * nb;                  // a partition's
  uint64_t* acc = (uint64_t*)smem;                        // P * ps
  unsigned* cnt = (unsigned*)(acc + (size_t)P * ps);      // P * ps
  const int32_t* kid = K.kid;
  if (kid != nullptr && K.RPM) kid += (int64_t)(y / K.RPM) * K.kid_stride;
  for (int e = threadIdx.x; e < P * R * nb; e += THREADS) {
    const int pp = e / (R * nb), r = e - pp * R * nb;
    int j, m;
    slot_of(K, y, r / nb, j, m);
    acc[pp * ps + r] = identity(S.func[j], S.type[j]);
    cnt[pp * ps + r] = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u, le = lt | (1u << lane);
  const int part = warp % P, q = warp / P;
  const int per = (R + Q - 1) / Q;                       // this warp's
  const int i0 = q * per < R ? q * per : R;              // slots [i0, i1)
  const int i1 = i0 + per < R ? i0 + per : R;
  const int nc = KT_CHUNKS / P;                          // its chunks
  const int mrow = K.RPM ? y / K.RPM : 0;
  int j0 = 0, m0 = 0, jlo, mlo, jhi, mhi;                // slot i0's, the
  if (i0 < i1) slot_of(K, y, i0, j0, m0);                // row's first and
  slot_of(K, y, 0, jlo, mlo);                            // last slots'
  slot_of(K, y, R - 1, jhi, mhi);
  // the staged members: the row's member (per-member ids), or members
  // 0 .. B - 1 (at most KT_STAGED)
  const int nstaged = K.RPM ? 1 : (K.B <= KT_STAGED ? K.B : 0);
  const int64_t ntiles = (K.n + KT_TILE - 1) / KT_TILE;
  for (int64_t t = f; t < ntiles; t += F) {
    const int64_t base = t * KT_TILE;
    // 1. each chunk's rows in bucket order, stable: a row's rank is the
    //    rows of smaller key (a ballot per key bit, most significant
    //    first) plus its same-key rows in lower lanes; once for every
    //    member, since it depends on the ids alone
    for (int c = warp; c < KT_CHUNKS; c += WARPS) {
      const int64_t r = base + c * 32 + lane;
      int k = nb;
      if (r < K.n) {
        const int kk = kid != nullptr ? __ldg(kid + r) : 0;
        if (kk >= 0 && kk < nb) k = kk;
      }
      unsigned eq = 0xffffffffu;
      int less = 0;
      for (int b = K.kbits - 1; b >= 0; --b) {
        const bool one = (k >> b) & 1;
        const unsigned ones = __ballot_sync(0xffffffffu, one);
        if (one) {
          less += __popc(eq & ~ones);
          eq &= ones;
        } else {
          eq &= ~ones;
        }
      }
      const int at = c * 32 + less + __popc(eq & lt);
      skey[at] = (uint16_t)k;
      sidx[at] = (uint8_t)lane;
    }
    //    and each row's member bits and the validity bits of the row's
    //    shared validity columns, read once with coalesced loads: thread
    //    t the tile's rows 4t .. 4t + 3
    {
      const int r0 = threadIdx.x * 4;
      unsigned mb[4] = {0u, 0u, 0u, 0u}, vb[4] = {0u, 0u, 0u, 0u};
      for (int mi = 0; mi < nstaged; ++mi) {
        const uint8_t* mp = K.masks + (K.RPM ? mrow : mi) * K.mask_stride;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (base + r0 + u < K.n)
            mb[u] |= (unsigned)(__ldg(mp + base + r0 + u) != 0) << mi;
      }
      for (int j = jlo; j <= jhi && j - jlo < KT_STAGED; ++j) {
        const uint8_t* vp = S.valid[j];
        if (vp == nullptr || S.vstride[j] != 0) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (base + r0 + u < K.n)
            vb[u] |= (unsigned)(__ldg(vp + base + r0 + u) != 0) << (j - jlo);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        smb[r0 + u] = (uint16_t)mb[u];
        svb[r0 + u] = (uint16_t)vb[u];
      }
    }
    __syncthreads();
    // 2. this warp's slots over its partition's chunks (p, p + P, ...),
    //    two chunks a round; the values of a group of KT_GROUP slots are
    //    loaded while the group before it folds, and each slot folds its
    //    chunks in order
    for (int cu = 0; cu < nc && i0 < i1; cu += 2) {
      Chunk C0, C1;
      chunk_rows(skey, sidx, smb, svb, part + P * cu, lane, C0);
      if (cu + 1 < nc)
        chunk_rows(skey, sidx, smb, svb, part + P * (cu + 1), lane, C1);
      else
        dead_chunk(nb, lane, C1);
      int gj = j0, gm = m0;                  // the next group's first slot
      unsigned long long xa0[KT_GROUP], xa1[KT_GROUP];
      group_loads(K, S, C0, C1, base, i0, i1, gj, gm, xa0, xa1);
      chunk_runs(lane, le, C0);
      chunk_runs(lane, le, C1);
      int fj = j0, fm = m0;                  // the slot to fold
      for (int g0 = i0; g0 < i1; g0 += KT_GROUP) {
        unsigned long long xb0[KT_GROUP], xb1[KT_GROUP];
        if (g0 + KT_GROUP < i1)
          group_loads(K, S, C0, C1, base, g0 + KT_GROUP, i1, gj, gm, xb0,
                      xb1);
#pragma unroll
        for (int u = 0; u < KT_GROUP; ++u) {
          const int i = g0 + u;
          if (i >= i1) break;                        // uniform
          const size_t o = part * ps + (size_t)i * nb;
          fold2(C0, C1, nb, base, lane, le,
                member_on(K, C0, base, fm) &&
                    valid_on(S, C0, base, fj, fm, jlo),
                xa0[u],
                member_on(K, C1, base, fm) &&
                    valid_on(S, C1, base, fj, fm, jlo),
                xa1[u], S.func[fj], S.type[fj], acc + o, cnt + o);
          next_slot(K, fj, fm);
        }
#pragma unroll
        for (int u = 0; u < KT_GROUP; ++u) {
          xa0[u] = xb0[u];
          xa1[u] = xb1[u];
        }
      }
    }
    __syncthreads();
  }
  // 3. the partitions folded in order: the block's partial
  const size_t SB = (size_t)K.S1 * K.B;
  for (int r = threadIdx.x; r < R * nb; r += THREADS) {
    const int i = r / nb, k = r - i * nb;
    int j, m;
    slot_of(K, y, i, j, m);
    const int fn = S.func[j], ty = S.type[j];
    uint64_t v = acc[r];
    unsigned c = cnt[r];
    for (int pp = 1; pp < P; ++pp) {
      v = combine(fn, ty, v, acc[pp * ps + r]);
      c += cnt[pp * ps + r];
    }
    const size_t o = ((size_t)f * SB + (size_t)j * K.B + m) * nb + k;
    part_val[o] = v;
    part_cnt[o] = c;
  }
}

// Folds the F tile groups' partials of each output in group order and
// writes it: member m's out_val / out_cnt (m, aggregate, bucket) and
// out_present (m, bucket). LANES (few outputs a member, Q1's): a warp an
// output, lane l the groups l, l + 32, ..., then the shuffle tree; else a
// thread an output, each round's reads coalesced across the warp. The
// choice follows S1 * nb, not B.
template <bool LANES>
__global__ void __launch_bounds__(THREADS)
bucket_agg_members_final(int F, int nb, int S1, int B, int64_t cap,
                         AggSpec spec, const uint64_t* part_val,
                         const unsigned* part_cnt, uint64_t* out_val,
                         int64_t* out_cnt, int64_t* out_present) {
  __shared__ SpecSmem S;
  spec_to_smem(spec, S);
  const int64_t per = (int64_t)S1 * B * nb;
  const int lane = threadIdx.x & 31;
  const int64_t e = LANES
      ? (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5)
      : (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= per) return;                  // uniform over a warp if LANES
  const int s = (int)(e / nb), k = (int)(e - (int64_t)s * nb);
  const int j = s / B, m = s - j * B;
  const int fn = S.func[j], ty = S.type[j];
  const unsigned long long* pv = (const unsigned long long*)part_val;
  uint64_t v = identity(fn, ty);
  unsigned long long c = 0;
  if (LANES) {
    for (int g = lane; g < F; g += 32) {
      const size_t o = (size_t)g * per + e;
      if (fn != F_COUNT) v = combine(fn, ty, v, __ldcg(pv + o));
      c += __ldcg(part_cnt + o);
    }
    if (fn != F_COUNT) v = warp_fold(fn, ty, v);
    c = warp_sum(c);
    if (lane != 0) return;
  } else {
#pragma unroll 4
    for (int g = 0; g < F; ++g) {
      const size_t o = (size_t)g * per + e;
      if (fn != F_COUNT) v = combine(fn, ty, v, __ldcg(pv + o));
      c += __ldcg(part_cnt + o);
    }
  }
  const int A = spec.n_aggs;
  if (j == A) {
    out_present[(size_t)m * nb + k] = (int64_t)c;
    return;
  }
  if (fn == F_COUNT) v = c;
  else if ((fn == F_MIN || fn == F_MAX) && c == 0) v = 0;   // typed zero
  else if (fn == F_FIRST && c == 0) v = (uint64_t)cap;
  const size_t o = ((size_t)m * A + j) * nb + k;
  out_val[o] = v;
  out_cnt[o] = (int64_t)c;
}

// --------------------------------------------------------------------------
// Keyless for B members, the common spec (counts and at most KL_MAX_SUMS
// sums over shared 16-byte aligned columns, no validity; every mask row
// 2-byte aligned), one launch. Block row y takes the members y * MB, ...:
// a lane's loads of a step are, for q = step + 32 j + l as in
// keyless_stream, each member's mask bytes of rows 2q, 2q + 1 (one 2-byte
// load) and each sum's two values (one 16-byte load, shared by the MB
// members); then MB x D register sums by a branch fixed for the launch.
// Lanes fold through the shuffle tree, a block's warps in warp order,
// and the last block to take the ticket folds the G x B partials in
// block order (members_finish): a fixed order.
#define KM_MAX_G 288                      // 9 partials a lane in the finish
#define KM_LOADS (KM_MAX_G / 32)

__device__ void members_finish(const StreamSpec& S, int A, int B,
                               const uint64_t* part_val,
                               const unsigned long long* part_cnt,
                               const unsigned long long* part_present,
                               unsigned* ticket, uint64_t* out_val,
                               int64_t* out_cnt, int64_t* out_present) {
  __shared__ bool s_last;
  const int G = gridDim.x;
  const unsigned blocks = gridDim.x * gridDim.y;
  __threadfence();                      // this block's partials, then
  __syncthreads();                      // its ticket
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    s_last = t == blocks - 1;
    if (s_last) *ticket = 0;            // every block has drawn: reset
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned long long* pv = (const unsigned long long*)part_val;
  for (int o = warp; o < B * (A + 1); o += WARPS) {
    const int b = o / (A + 1), i = o - b * (A + 1);
    const int d = i < A && ((S.sums >> i) & 1u)
                      ? __popc(S.sums & ((1u << i) - 1u)) : -1;
    const int ty = d >= 0 && ((S.fmask >> d) & 1u) ? T_F64 : T_I64;
    unsigned long long x[KM_LOADS], c[KM_LOADS];
#pragma unroll
    for (int u = 0; u < KM_LOADS; ++u) {   // every load first
      const int g = lane + 32 * u;
      const size_t bg = (size_t)g * B + b;
      x[u] = g < G && d >= 0 ? __ldcg(pv + bg * A + i) : 0ull;
      c[u] = g >= G ? 0ull
             : __ldcg(i < A ? part_cnt + bg * A + i : part_present + bg);
    }
    uint64_t acc = 0;
    unsigned long long tc = 0;
#pragma unroll
    for (int u = 0; u < KM_LOADS; ++u) {
      if (lane + 32 * u < G && d >= 0) acc = combine(F_SUM, ty, acc, x[u]);
      tc += c[u];
    }
    acc = warp_fold(F_SUM, ty, acc);
    tc = warp_sum(tc);
    if (lane == 0) {
      if (i == A) {
        out_present[b] = (int64_t)tc;
      } else {
        out_val[(size_t)b * A + i] = d >= 0 ? acc : tc;
        out_cnt[(size_t)b * A + i] = (int64_t)tc;
      }
    }
  }
}

template <int D, int MB, int J>
__global__ void __launch_bounds__(THREADS, 2)
keyless_members(int64_t n, int B, const uint8_t* masks, int64_t mask_stride,
                StreamSpec S, int A, uint64_t* part_val,
                unsigned long long* part_cnt,
                unsigned long long* part_present, unsigned* ticket,
                uint64_t* out_val, int64_t* out_cnt, int64_t* out_present) {
  __shared__ uint64_t wsum[WARPS][MB][D > 0 ? D : 1];
  __shared__ unsigned wcnt[WARPS][MB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MB;
  const int nm = B - m0 < MB ? B - m0 : MB;
  const int64_t step_rows = (int64_t)WARPS * 64 * J;
  const int64_t steps = (n + step_rows - 1) / step_rows;
  uint64_t ac[MB][D > 0 ? D : 1];
  unsigned cnt[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    cnt[m] = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) ac[m][d] = 0;
  }
  for (int64_t s = blockIdx.x; s < steps; s += gridDim.x) {
    const int64_t w0 = s * step_rows + (int64_t)warp * 64 * J;
    unsigned mk[MB][J];
    ulonglong2 x[D > 0 ? D : 1][J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int64_t e = w0 + 64 * j + 2 * lane;     // rows e, e + 1
      if (e + 1 < n) {
#pragma unroll
        for (int m = 0; m < MB; ++m)
          mk[m][j] = m < nm ? load_stream(masks + (m0 + m) * mask_stride + e)
                            : 0u;
#pragma unroll
        for (int d = 0; d < D; ++d) x[d][j] = load_stream(S.data[d] + e);
      } else {
        const bool one = e < n;
#pragma unroll
        for (int m = 0; m < MB; ++m)
          mk[m][j] = m < nm && one
                         ? (unsigned)masks[(m0 + m) * mask_stride + e] : 0u;
#pragma unroll
        for (int d = 0; d < D; ++d)
          x[d][j] = make_ulonglong2(one ? S.data[d][e] : 0ull, 0ull);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const bool a0 = (mk[m][j] & 0xFFu) != 0, a1 = (mk[m][j] >> 8) != 0;
        cnt[m] += (unsigned)a0 + (unsigned)a1;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if ((S.fmask >> d) & 1u) {
            double v = __longlong_as_double(ac[m][d]);
            v += a0 ? __longlong_as_double(x[d][j].x) : 0.0;
            v += a1 ? __longlong_as_double(x[d][j].y) : 0.0;
            ac[m][d] = __double_as_longlong(v);
          } else {
            ac[m][d] += a0 ? x[d][j].x : 0ull;
            ac[m][d] += a1 ? x[d][j].y : 0ull;
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MB; ++m) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint64_t v =
          warp_fold(F_SUM, ((S.fmask >> d) & 1u) ? T_F64 : T_I64, ac[m][d]);
      if (lane == 0) wsum[warp][m][d] = v;
    }
    const unsigned c = __reduce_add_sync(0xffffffffu, cnt[m]);
    if (lane == 0) wcnt[warp][m] = c;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nm * (A + 1); t += THREADS) {
    const int m = t / (A + 1), i = t - m * (A + 1);
    unsigned long long tc = 0;
    for (int w = 0; w < WARPS; ++w) tc += wcnt[w][m];
    const size_t b = (size_t)blockIdx.x * B + m0 + m;
    if (i == A) {
      part_present[b] = tc;
      continue;
    }
    uint64_t acc = 0;
    if ((S.sums >> i) & 1u) {
      const int d = __popc(S.sums & ((1u << i) - 1u));
      const int ty = ((S.fmask >> d) & 1u) ? T_F64 : T_I64;
      for (int w = 0; w < WARPS; ++w)
        acc = combine(F_SUM, ty, acc, wsum[w][m][d]);
    }
    part_val[b * A + i] = acc;
    part_cnt[b * A + i] = tc;
  }
  members_finish(S, A, B, part_val, part_cnt, part_present, ticket, out_val,
                 out_cnt, out_present);
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
    spec.valid[a] = on && valid_ptrs ? (const uint8_t*)valid_ptrs[a]
                                     : nullptr;
    spec.func[a] = on ? funcs[a] : F_COUNT;
    spec.type[a] = on ? types[a] : T_I64;
    spec.dstride[a] = on && data_strides && spec.data[a] ? data_strides[a]
                                                         : 0;
    spec.vstride[a] = on && valid_strides && spec.valid[a]
                          ? valid_strides[a] : 0;
  }
  return spec;
}

// Keyed and member-axis aggregation (bucket_agg for a single query, with
// B = 1 and its mask as member 0's; bucket_agg_batched for B members):
// bucket_agg_members, then bucket_agg_members_final. masks: member m's row
// at m * mask_stride; ids shared (kid_stride 0) or per member (null: one
// bucket); each aggregate's data and validity shared or per member
// (strides in elements). plan: {F tile groups, Y block rows, P, SR, RPM,
// LANES final} (bindings.bucket_agg_plan). Partials F * (n_aggs + 1) * B
// * nb values and 32-bit counts; outputs (B, n_aggs, nb) values and
// counts, (B, nb) row counts.
extern "C" int bucket_agg_members_launch(
    int64_t n, int nb, const void* kid, int64_t kid_stride, int B,
    const void* masks, int64_t mask_stride, int n_aggs,
    const int64_t* data_ptrs, const int64_t* data_strides,
    const int64_t* valid_ptrs, const int64_t* valid_strides,
    const int32_t* funcs, const int32_t* types, int64_t cap,
    const int32_t* plan, void* part_val, void* part_cnt, void* out_val,
    void* out_cnt, void* out_present, void* stream) {
  const int F = plan[0], Y = plan[1], P = plan[2], SR = plan[3],
            RPM = plan[4], lanes = plan[5];
  Keyed K;
  K.n = n;
  K.nb = nb;
  K.kbits = 0;
  while ((nb >> K.kbits) != 0) ++K.kbits;
  K.kid = (const int32_t*)kid;
  K.kid_stride = kid_stride;
  K.masks = (const uint8_t*)masks;
  K.mask_stride = mask_stride;
  K.B = B;
  K.S1 = n_aggs + 1;
  K.SR = SR;
  K.RPM = RPM;
  K.P = P;
  const size_t smem = (size_t)P * SR * nb * 12;       // + KT_TILE_BYTES
  if (smem + KT_TILE_BYTES > KT_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool rows_ok = RPM > 0
      ? (kid != nullptr && Y == B * RPM && (int64_t)RPM * SR >= K.S1 &&
         (int64_t)(RPM - 1) * SR < K.S1)
      : (kid_stride == 0 && (int64_t)Y * SR >= (int64_t)K.S1 * B &&
         (int64_t)(Y - 1) * SR < (int64_t)K.S1 * B);
  if (n_aggs < 0 || n_aggs > MAX_AGGS || nb < 1 || nb > MAX_BUCKETS ||
      (kid == nullptr && nb != 1) || B < 1 || masks == nullptr ||
      F < 1 || F > 65535 || Y < 1 || SR < 1 || !rows_ok ||
      (P != 1 && P != 2 && P != 4 && P != 8) ||
      n >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  const AggSpec spec = make_spec(n_aggs, data_ptrs, data_strides,
                                 valid_ptrs, valid_strides, funcs, types);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      bucket_agg_members, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bucket_agg_members<<<dim3(Y, F), THREADS, smem, s>>>(
      K, spec, (uint64_t*)part_val, (unsigned*)part_cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t per = (int64_t)K.S1 * B * nb;
  if (lanes)
    bucket_agg_members_final<true>
        <<<(unsigned)((per + WARPS - 1) / WARPS), THREADS, 0, s>>>(
            F, nb, K.S1, B, cap, spec, (const uint64_t*)part_val,
            (const unsigned*)part_cnt, (uint64_t*)out_val,
            (int64_t*)out_cnt, (int64_t*)out_present);
  else
    bucket_agg_members_final<false>
        <<<(unsigned)((per + THREADS - 1) / THREADS), THREADS, 0, s>>>(
            F, nb, K.S1, B, cap, spec, (const uint64_t*)part_val,
            (const unsigned*)part_cnt, (uint64_t*)out_val,
            (int64_t*)out_cnt, (int64_t*)out_present);
  return (int)cudaGetLastError();
}

// The common keyless spec's streaming layout, from the aggregates: D sums
// (column d float64 where bit d of fmask is set), aggregate a a sum where
// bit a of `sums` is set, else a count. False when the spec is not the
// common one or a column is not 16-byte aligned.
static bool stream_spec(const AggSpec& spec, StreamSpec& S, int& D) {
  S.fmask = 0;
  S.sums = 0;
  D = 0;
  for (int d = 0; d < KL_MAX_SUMS; ++d) S.data[d] = nullptr;
  for (int a = 0; a < spec.n_aggs; ++a) {
    if (spec.valid[a] != nullptr) return false;
    if (spec.func[a] == F_COUNT) {
      if (spec.data[a] != nullptr) return false;
      continue;
    }
    if (spec.func[a] != F_SUM || spec.data[a] == nullptr ||
        D == KL_MAX_SUMS || (uintptr_t)spec.data[a] % 16 != 0 ||
        spec.dstride[a] != 0)
      return false;
    S.sums |= 1u << a;
    S.data[D] = spec.data[a];
    if (spec.type[a] == T_F64) S.fmask |= 1u << D;
    ++D;
  }
  return true;
}

template <int D, int MB, int J>
static void members_stream(int G, int Y, cudaStream_t s, int64_t n, int B,
                           const uint8_t* masks, int64_t mask_stride,
                           const StreamSpec& S, int A, void* pv, void* pc,
                           void* pp, void* ticket, void* ov, void* oc,
                           void* op) {
  keyless_members<D, MB, J><<<dim3(G, Y), THREADS, 0, s>>>(
      n, B, masks, mask_stride, S, A, (uint64_t*)pv,
      (unsigned long long*)pc, (unsigned long long*)pp, (unsigned*)ticket,
      (uint64_t*)ov, (int64_t*)oc, (int64_t*)op);
}

// Keyless B members, the common spec, one launch (keyless_members): G
// blocks a row of MB members (8 up to two sums, else 4) with J = 4 (at
// most one sum) or 2 16-byte loads a sum a lane a step; Y = ceil(B / MB)
// rows. Partials G * B * n_aggs values and counts, G * B row counts;
// `ticket` one zeroed word per stream; outputs (B, n_aggs) values and
// counts and (B,) row counts.
extern "C" int bucket_agg_keyless_batched_launch(
    int64_t n, int B, const void* masks, int64_t mask_stride, int n_aggs,
    const int64_t* data_ptrs, const int32_t* funcs, const int32_t* types,
    int G, int Y, void* part_val, void* part_cnt, void* part_present,
    void* ticket, void* out_val, void* out_cnt, void* out_present,
    void* stream) {
  if (n_aggs < 0 || n_aggs > MAX_AGGS || B < 1 || masks == nullptr ||
      ticket == nullptr || G < 1 || G > KM_MAX_G ||
      (uintptr_t)masks % 2 != 0 || mask_stride % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const AggSpec spec = make_spec(n_aggs, data_ptrs, nullptr, nullptr,
                                 nullptr, funcs, types);
  StreamSpec S;
  int D;
  if (!stream_spec(spec, S, D)) return (int)cudaErrorInvalidValue;
  const int MB = D <= 2 ? 8 : 4;
  if (Y != (B + MB - 1) / MB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* mk = (const uint8_t*)masks;
  switch (D) {
    case 0: members_stream<0, 8, 4>(G, Y, s, n, B, mk, mask_stride, S,
                                    n_aggs, part_val, part_cnt, part_present,
                                    ticket, out_val, out_cnt, out_present);
            break;
    case 1: members_stream<1, 8, 4>(G, Y, s, n, B, mk, mask_stride, S,
                                    n_aggs, part_val, part_cnt, part_present,
                                    ticket, out_val, out_cnt, out_present);
            break;
    case 2: members_stream<2, 8, 2>(G, Y, s, n, B, mk, mask_stride, S,
                                    n_aggs, part_val, part_cnt, part_present,
                                    ticket, out_val, out_cnt, out_present);
            break;
    case 3: members_stream<3, 4, 2>(G, Y, s, n, B, mk, mask_stride, S,
                                    n_aggs, part_val, part_cnt, part_present,
                                    ticket, out_val, out_cnt, out_present);
            break;
    default: members_stream<4, 4, 2>(G, Y, s, n, B, mk, mask_stride, S,
                                     n_aggs, part_val, part_cnt,
                                     part_present, ticket, out_val, out_cnt,
                                     out_present);
             break;
  }
  return (int)cudaGetLastError();
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
  int D;
  if (!stream_spec(spec, S, D) || (uintptr_t)active % 2 != 0 ||
      J != (D <= 2 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
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
