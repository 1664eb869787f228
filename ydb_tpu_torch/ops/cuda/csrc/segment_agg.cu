// segment_agg — per-group aggregation over rows in key-sorted order.
//
// Replaces the body of ydb_tpu/ops/xla_exec.py:_trace_group_by_sorted
// after its sort: the group boundaries (an active row whose key words
// differ from the previous row's), ngroups, the group starts compacted to
// the front of the output capacity, and count / sum / min / max / first
// per group — what _gather_sorted, _csum_diffs and _segment_scan built for
// XLA. The medium-domain lane (_groupby_medium_domain) uses it too, with
// the bucket id as the only key, after bucket_sort.cu's permutation.
// Bound on the H100: bytes. Each sorted position reads its permutation
// entry and, through it, the row's activity, key words and one 8-byte
// value and validity byte per aggregate; every output slot (oc of them:
// lead, present, a value and a count per aggregate) is written once. The
// reads through the permutation are gathers: coalesced where the input is
// already nearly in key order (lineitem by l_orderkey), scattered
// otherwise (the medium-domain lane).
// Design: two launches and no atomics on values.
// (1) seg_fold: a block takes the next 2,048 sorted rows by ticket (an
// atomic counter, so tiles start in order); each of its 8 warps walks
// 256 rows as 8 strips of 32, one row a lane. A lane reads its
// permutation entry and the row's activity and key words once; its
// predecessor's words come from the neighbouring lane (__shfl_up_sync),
// so a start flag costs no second gather. Rows past the first inactive
// one are not read (the active rows come first), and a tile that starts
// past them stops after the look-back, writing no partial. The block
// counts its starts and finds its first group id by a decoupled
// look-back over the earlier tiles' published counts, then folds: each
// lane loads its row's values once; a strip of 32 rows inside one group
// that began before it is folded by a fixed shuffle tree and added to
// the carried group; in any other strip the first lane of every piece
// (the rows between two starts) folds the piece row by row, taking its
// rows from the lanes above it by shuffles, and a piece that runs into
// the next strip is carried in registers, its fold going on there.
// Across warps, each warp's head (rows before its first start) and
// tail (its last group so far) are combined in warp order in shared memory; a tile's
// own head and tail go to per-tile partials. (2) seg_fix: a warp per
// tile with a start folds the tile's tail with the heads of the
// following tiles up to the next start, in tile order, and the grid
// writes zeros to the slots past ngroups, so the caller allocates its
// outputs without clearing them. A head shorter than SHORT rows joins
// the group before it row by row (its warp loads the rows again and
// hands them to one lane in order), not as a partial: so a group of up
// to SHORT rows is always folded from the identity one row at a time in
// sorted order — the old kernel's order for such groups — wherever the
// strips, warps and tiles cut it, and two layouts of the same rows (the
// DQ planes) give the same bits. Longer groups combine partials in an
// order fixed by their position. Accumulators live in registers: the
// fold is a template on the number of aggregates (1, 2, 4 or 8, the
// slots past a call's count inert; the wrapper runs more aggregates in
// chunks of 8) and on the member axis, every array indexed by
// compile-time constants (the key words, read once a row, loop at run
// time: unrolled, they cost registers and time); both kernels declare
// one resident block as their floor (__launch_bounds__(THREADS, 1)),
// without which ptxas held some instantiations below the registers they
// need and spilled. Every combining order
// is fixed by the input, so float sums repeat bit for bit from run to
// run.
// Member axis (segment_agg_batched_launch, the batched serving lane): B
// members share one sort — the rows active in any member first, by key —
// and differ in their masks (and in any per-member value column). The
// runs of equal keys are cut once, over the union of the masks; the fold
// spreads the members over up to 8 blocks a tile (each block cuts the
// tile's runs, the first does the look-back, the others wait for its
// count), each loading its members' masks and values through the same
// rows in turn: a block's passes are serial, and the few tiles that hold
// a small union's rows set the time (one block walking 8 members took
// 0.28 of c40's 0.34 ms). seg_fix takes a warp per (tile, member). Each member gets a partial per
// run of the union, written only for the union's runs (nothing is
// zeroed). (3) seg_members keeps, for each member, the runs where it has
// rows — exactly the groups a sort of that member's rows alone gives —
// and writes every output slot once: tiles of 4,096 runs of a member by
// ticket, each run's presence read once, ranked by ballots and a scan over
// the warps, the member's earlier tiles added by a decoupled look-back;
// the kept runs' lead (the hidden first's value, as int32), present,
// values and counts go to their ranks, and the items after the tiles
// zero [ngroups_b, oc) of every output in 16-byte stores. Bound of the
// member form: the distinct inputs, the union's partials written and read
// once, and B x oc slots of lead (4 bytes), present (8) and a value and a
// count per aggregate (16) written once. Its control words are kept per
// stream: the fold's look-back words and ticket are left zero by the
// last block of seg_members, whose own look-back words seg_fix clears.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_AGGS 8
#define MAX_KEYS 16
#define THREADS 256
#define WARPS (THREADS / 32)
#define STRIPS 8                          // 32-row strips a warp walks
#define WARP_ROWS (32 * STRIPS)
#define TILE (WARPS * WARP_ROWS)          // sorted rows per block
#define FULL 0xffffffffu
#define MGROUPS 8                         // member fold: blocks a tile
#define SHORT 32                          // rows: a group this short or
                                          // shorter folds row by row
#define FLAG_AGG (1ull << 62)             // a tile's own count is published
#define FLAG_PRE (2ull << 62)             // its inclusive prefix is
#define VALUE_MASK ((1ull << 62) - 1)

enum { F_COUNT = 0, F_SUM = 1, F_MIN = 2, F_MAX = 3, F_FIRST = 4 };
enum { T_F64 = 0, T_I64 = 1, T_U64 = 2 };

struct Keys {
  int n;
  const uint64_t* k[MAX_KEYS];
};

struct AggSpec {
  int n_aggs;
  const uint64_t* data[MAX_AGGS];   // 8-byte values; null for count/first
  const uint8_t* valid[MAX_AGGS];   // null = every row valid
  int func[MAX_AGGS];
  int type[MAX_AGGS];
  int64_t dstride[MAX_AGGS];        // elements between members' rows of
  int64_t vstride[MAX_AGGS];        // data / valid; 0 = shared
};

// A partial: per aggregate a folded value and the count of rows that fed
// it, plus the count of active rows. Laid out as val[a * stride + slot].
struct Part {
  uint64_t* val;
  uint64_t* cnt;
  uint64_t* pres;
  int64_t stride;
};

// member b's partials: B consecutive (n_aggs, stride) blocks
__device__ __forceinline__ Part member_part(Part P, int n_aggs, int64_t b) {
  Part q = P;
  q.val += b * n_aggs * P.stride;
  q.cnt += b * n_aggs * P.stride;
  q.pres += b * P.stride;
  return q;
}

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
    bool take;                                      // b replaces a
    if (t == T_F64) {
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      if (isnan(x)) return a;                       // NaN propagates
      if (isnan(y)) return b;
      take = (f == F_MIN) ? (y < x) : (y > x);
    } else if (t == T_I64) {
      take = (f == F_MIN) ? ((int64_t)b < (int64_t)a)
                          : ((int64_t)b > (int64_t)a);
    } else {
      take = (f == F_MIN) ? (b < a) : (b > a);
    }
    return take ? b : a;
  }
  if (f == F_FIRST) return b < a ? b : a;
  return a;
}

// A running fold of A aggregate slots (slots past spec.n_aggs are inert)
// and the count of active rows. Every loop over it unrolls, so it stays
// in registers.
template <int A>
struct Acc {
  uint64_t v[A];
  uint32_t c[A];
  uint32_t p;
};

template <int A>
__device__ __forceinline__ void acc_init(const AggSpec& s, Acc<A>& x) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
    x.v[a] = identity(s.func[a], s.type[a]);
    x.c[a] = 0;
  }
  x.p = 0;
}

// x = x (+) y, x first
template <int A>
__device__ __forceinline__ void acc_add(const AggSpec& s, Acc<A>& x,
                                        const Acc<A>& y) {
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (a < s.n_aggs) {
      x.v[a] = combine(s.func[a], s.type[a], x.v[a], y.v[a]);
      x.c[a] += y.c[a];
    }
  x.p += y.p;
}

// lane `src`'s fold, on every lane
template <int A>
__device__ __forceinline__ void acc_bcast(const AggSpec& s, Acc<A>& out,
                                          const Acc<A>& x, int src) {
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (a < s.n_aggs) {
      out.v[a] = __shfl_sync(FULL, x.v[a], src);
      out.c[a] = __shfl_sync(FULL, x.c[a], src);
    }
  out.p = __shfl_sync(FULL, x.p, src);
}

// the row's contribution: its values where it is active for the member
// and valid, the identity elsewhere
template <int A, bool MEMBERS>
__device__ __forceinline__ void acc_row(const AggSpec& s, int32_t r,
                                        int64_t b, bool on, Acc<A>& x) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
    uint64_t v = identity(s.func[a], s.type[a]);
    uint32_t c = 0;
    if (a < s.n_aggs && on) {
      // the value and its validity loaded side by side, not one after
      // the other
      const int64_t vr = MEMBERS ? b * s.vstride[a] + r : r;
      const int64_t dr = MEMBERS ? b * s.dstride[a] + r : r;
      const bool has = s.func[a] != F_FIRST && s.func[a] != F_COUNT;
      const uint64_t d = has ? s.data[a][dr] : (uint64_t)r;
      if (s.valid[a] == nullptr || s.valid[a][vr] != 0) {
        c = 1;
        if (s.func[a] != F_COUNT) v = d;
      }
    }
    x.v[a] = v;
    x.c[a] = c;
  }
  x.p = on ? 1u : 0u;
}

// rows i0 .. i0 + len - 1 (len <= 32) of the sorted order folded into
// lane 0's acc one by one, in row order (a short head that ends a group
// from before): each lane loads one row, lane 0 takes them in turn
template <int A, bool MEMBERS>
__device__ __forceinline__ void warp_rows(const AggSpec& s,
                                          const int32_t* perm,
                                          const uint8_t* active,
                                          const uint8_t* mask, int64_t b,
                                          int64_t i0, int len, Acc<A>& acc) {
  const int lane = threadIdx.x & 31;
  int32_t r = 0;
  bool on = false;
  if (lane < len) {
    r = perm[i0 + lane];
    on = active[r] != 0;
    if (MEMBERS && on) on = mask[r] != 0;
  }
  Acc<A> x;
  acc_row<A, MEMBERS>(s, r, b, on, x);
  for (int k = 0; k < len; ++k) {
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (a < s.n_aggs) {
        const uint64_t y = __shfl_sync(FULL, x.v[a], k);
        const uint32_t c = __shfl_sync(FULL, x.c[a], k);
        if (lane == 0) {
          acc.v[a] = combine(s.func[a], s.type[a], acc.v[a], y);
          acc.c[a] += c;
        }
      }
    const uint32_t p = __shfl_sync(FULL, x.p, k);
    if (lane == 0) acc.p += p;
  }
}

// the whole warp's fold, in lane 0 (a fixed shuffle tree)
template <int A>
__device__ __forceinline__ void acc_warp_fold(const AggSpec& s, Acc<A>& x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (a < s.n_aggs) {
        const uint64_t y = __shfl_down_sync(FULL, x.v[a], off);
        const uint32_t c = __shfl_down_sync(FULL, x.c[a], off);
        x.v[a] = combine(s.func[a], s.type[a], x.v[a], y);
        x.c[a] += c;
      }
    x.p += __shfl_down_sync(FULL, x.p, off);
  }
}

template <int A>
__device__ __forceinline__ void store_raw(const AggSpec& s, Part P,
                                          int64_t slot, const Acc<A>& x) {
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (a < s.n_aggs) {
      P.val[a * P.stride + slot] = x.v[a];
      P.cnt[a * P.stride + slot] = x.c[a];
    }
  P.pres[slot] = x.p;
}

template <int A>
__device__ __forceinline__ void load_raw(const AggSpec& s, Part P,
                                         int64_t slot, Acc<A>& x) {
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (a < s.n_aggs) {
      x.v[a] = P.val[a * P.stride + slot];
      x.c[a] = (uint32_t)P.cnt[a * P.stride + slot];
    }
  x.p = (uint32_t)P.pres[slot];
}

// a finished group: counts as values for count, typed zero for min / max
// with no valid row, n for first with none
template <int A>
__device__ __forceinline__ void store_final(const AggSpec& s, Part P,
                                            int64_t slot, const Acc<A>& x,
                                            int64_t n, bool write_pres) {
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (a < s.n_aggs) {
      const int f = s.func[a];
      uint64_t v = x.v[a];
      if (f == F_COUNT) v = x.c[a];
      else if ((f == F_MIN || f == F_MAX) && x.c[a] == 0) v = 0;
      else if (f == F_FIRST && x.c[a] == 0) v = (uint64_t)n;
      P.val[a * P.stride + slot] = v;
      P.cnt[a * P.stride + slot] = x.c[a];
    }
  if (write_pres) P.pres[slot] = x.p;
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  return *(const volatile uint64_t*)p;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  *(volatile uint64_t*)p = v;
}

// bit s: the lane's row of strip s is active in the union (`act`) and in
// `mask`
__device__ __forceinline__ unsigned member_bits(const uint8_t* mask,
                                                unsigned act,
                                                const int32_t (&rr)[STRIPS]) {
  unsigned bits = 0;
#pragma unroll
  for (int s = 0; s < STRIPS; ++s)
    if (((act >> s) & 1u) && mask[rr[s]] != 0) bits |= 1u << s;
  return bits;
}

// B members: member b's activity is masks[b * mask_stride + row]; with
// MEMBERS false `masks` is the single query's activity (= active).
// G blocks a tile (items (tile, member group) by ticket, the group-0
// block first): block mg folds members mg, mg + G, ...; the group-0 block
// does the look-back and writes the tile's counts, the others wait for
// its inclusive count. With members, a tile whose first row is inactive
// holds no active row: every block of it stops at once, but the group-0
// block of the first such tile, which counts the groups through the
// look-back.
template <int A, bool MEMBERS>
__global__ void __launch_bounds__(THREADS, 1)
seg_fold(int64_t n, const int32_t* perm, Keys K, const uint8_t* active,
         int B, int G, const uint8_t* masks, int64_t mask_stride,
         int64_t oc, AggSpec spec, int write_lead, int write_pres,
         int32_t* lead, Part out, Part head, Part tail, uint64_t* status,
         int64_t T, int32_t* tile_cnt, int64_t* tile_off,
         int32_t* ngroups) {
  __shared__ int64_t s_tile, s_g0;
  __shared__ int s_dead, s_mg;
  __shared__ int s_cnt[WARPS], s_excl[WARPS], s_hlen[WARPS];
  __shared__ Acc<A> s_head[WARPS], s_tail[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (!MEMBERS) G = 1;
  if (threadIdx.x == 0) {
    const int64_t item =
        (int64_t)atomicAdd((unsigned long long*)&status[T], 1ull);
    const int64_t tt = MEMBERS ? item / G : item;
    const int mg = MEMBERS ? (int)(item - tt * G) : 0;
    const int64_t r0 = tt * TILE;
    const bool dead = MEMBERS && active[perm[r0]] == 0;
    // the first such tile: the tile before it starts with an active row
    const bool first_dead =
        dead && (tt == 0 || active[perm[r0 - TILE]] != 0);
    if (dead && (mg > 0 || !first_dead)) {
      if (mg == 0) {
        tile_cnt[tt] = 0;
        tile_cnt[T + tt] = -1;
      }
      s_tile = -1;
    } else {
      s_tile = tt;
    }
    s_mg = mg;
  }
  __syncthreads();
  if (s_tile < 0) return;
  const int64_t t = s_tile;
  const int mg = MEMBERS ? s_mg : 0;
  const int64_t wbase = t * TILE + (int64_t)warp * WARP_ROWS;

  // (1) the warp's rows, their activity and start flags
  int32_t rr[STRIPS];
  unsigned sm[STRIPS];
  unsigned act = 0;                       // bit s: this lane's row is active
  int32_t prev_r = 0;
  bool prev_a = false;
  if (wbase > 0 && wbase < n) {           // the row before the warp's first
    prev_r = perm[wbase - 1];
    prev_a = active[prev_r] != 0;
  }
  // the active rows come first: past an inactive row nothing is read
  bool live = wbase < n && (wbase == 0 || prev_a);
#pragma unroll
  for (int s = 0; s < STRIPS; ++s) {
    const int64_t i = wbase + s * 32 + lane;
    rr[s] = live && i < n ? perm[i] : 0;
  }
  int cnt = 0;
  int hlen = WARP_ROWS;                   // rows before the warp's first start
#pragma unroll
  for (int s = 0; s < STRIPS; ++s) {
    const int64_t i = wbase + s * 32 + lane;
    const int32_t r = rr[s];
    const bool a = live && i < n && active[r] != 0;
    int32_t q = __shfl_up_sync(FULL, r, 1);
    bool qa = __shfl_up_sync(FULL, (int)a, 1) != 0;
    if (lane == 0) {
      q = prev_r;
      qa = prev_a;
    }
    bool start = a && !qa;
    const bool cmp = a && qa;
#pragma unroll 1
    for (int k = 0; k < K.n; ++k) {
      const uint64_t kr = a ? K.k[k][r] : 0;
      uint64_t kq = __shfl_up_sync(FULL, kr, 1);
      if (lane == 0 && cmp) kq = K.k[k][q];
      start = start || (cmp && kr != kq);
    }
    sm[s] = __ballot_sync(FULL, start);
    if (a) act |= 1u << s;
    if (cnt == 0 && sm[s]) hlen = s * 32 + __ffs(sm[s]) - 1;
    cnt += __popc(sm[s]);
    prev_r = __shfl_sync(FULL, r, 31);
    prev_a = __shfl_sync(FULL, (int)a, 31) != 0;
    live = __all_sync(FULL, a);           // the active rows come first
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_hlen[warp] = hlen;
  }
  // a tile whose first row is inactive holds no active row: past the
  // count and the look-back it has nothing to fold
  if (threadIdx.x == 0) s_dead = !(act & 1u);
  __syncthreads();

  // the tile's first group id: a decoupled look-back over the earlier
  // tiles, warp 0 reading 32 of them at a time; another member group's
  // block waits for the tile's inclusive count
  if (MEMBERS && warp == 0 && mg > 0) {
    const int v = lane < WARPS ? s_cnt[lane] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane < WARPS) s_excl[lane] = x - v;
    const int64_t total = __shfl_sync(FULL, x, 31);
    if (lane == 0) {
      uint64_t w;
      while (((w = load_status(&status[t])) >> 62) != 2) {
      }
      s_g0 = (int64_t)(w & VALUE_MASK) - total;
    }
  } else if (warp == 0) {
    const int v = lane < WARPS ? s_cnt[lane] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane < WARPS) s_excl[lane] = x - v;
    const int64_t total = __shfl_sync(FULL, x, 31);
    int64_t excl = 0;
    if (t == 0) {
      if (lane == 0) store_status(&status[0], FLAG_PRE | (uint64_t)total);
    } else {
      if (lane == 0) store_status(&status[t], FLAG_AGG | (uint64_t)total);
      for (int64_t j = t - 1;; j -= 32) {
        const int64_t jj = j - lane;
        uint64_t w = jj >= 0 ? load_status(&status[jj]) : FLAG_PRE;
        while (__any_sync(FULL, (w >> 62) == 0))
          if ((w >> 62) == 0) w = load_status(&status[jj]);
        const unsigned pre = __ballot_sync(FULL, (w >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        int64_t part = lane <= stop ? (int64_t)(w & VALUE_MASK) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(FULL, part, off);
        excl += part;
        if (pre) break;
      }
      if (lane == 0)
        store_status(&status[t], FLAG_PRE | (uint64_t)(excl + total));
    }
    if (lane == 0) {
      s_g0 = excl;
      tile_cnt[t] = (int32_t)total;
      // the tile's head, -1 for a tile with no active row
      tile_cnt[T + t] = s_dead ? -1 : s_cnt[0] > 0 ? s_hlen[0] : TILE;
      tile_off[t] = excl;
      if (t == T - 1 || (MEMBERS && s_dead))
        *ngroups = (int32_t)(excl + total);
    }
  }
  __syncthreads();
  if (s_dead) return;
  const int64_t g0 = s_g0 + s_excl[warp];  // the warp's first group id

  if (write_lead && lead != nullptr && mg == 0) {
#pragma unroll
    for (int s = 0, g = 0; s < STRIPS; ++s) {
      if ((sm[s] >> lane) & 1u) {
        const int64_t gid = g0 + g + __popc(sm[s] & below);
        if (gid < oc) lead[gid] = rr[s];
      }
      g += __popc(sm[s]);
    }
  }

  // (2) fold, member by member. A member's mask bits of the warp's rows
  // are loaded a member ahead, eight independent loads: a pass waits on
  // its mask once at most, not once a strip.
  unsigned on_next =
      MEMBERS ? member_bits(masks + (int64_t)mg * mask_stride, act, rr) : act;
  for (int b = mg; b < (MEMBERS ? B : 1); b += (MEMBERS ? G : 1)) {
    const uint8_t* mask = masks + (int64_t)b * mask_stride;
    const unsigned on_bits = on_next;     // bit s: active for the member
    if (MEMBERS && b + G < B)
      on_next = member_bits(mask + (int64_t)G * mask_stride, act, rr);
    const Part mout = member_part(out, spec.n_aggs, b);
    Acc<A> carry;
    acc_init(spec, carry);
    bool open = false;                    // carry holds a group of this warp
    int64_t g = g0;                       // the id of the next start
#pragma unroll
    for (int s = 0; s < STRIPS; ++s) {
      const unsigned m = sm[s];
      const int32_t r = rr[s];
      // the rows active in the union: a prefix of the strip's lanes
      const unsigned live_lanes = __ballot_sync(FULL, (act >> s) & 1u);
      if (live_lanes == 0) continue;      // past the active rows
      const bool on = (on_bits >> s) & 1u;
      Acc<A> x;
      acc_row<A, MEMBERS>(spec, r, b, on, x);
      if (m == 0 && live_lanes == FULL) {
        // 32 rows inside a group that began before them: a group of
        // more than 32 rows, folded by a fixed tree and carried on
        acc_warp_fold(spec, x);
        Acc<A> y;
        acc_bcast(spec, y, x, 0);
        acc_add(spec, carry, y);
        continue;
      }
      // this lane's piece ends at the next start above it (or at the
      // last active row)
      const unsigned above = m & ~((2u << lane) - 1u);
      const int end = min(above ? __ffs(above) - 1 : 32, __popc(live_lanes));
      // the first lane of each piece folds it row by row, in row order,
      // from the identity (piece 0 from the carry): a group's fold does
      // not depend on where the strips cut it
      const bool first = ((m >> lane) & 1u) || lane == 0;
      Acc<A> acc;
      acc_init(spec, acc);
      if (lane == 0 && !(m & 1u)) acc = carry;
      acc_add(spec, acc, x);
      for (int k = 1; k < 32; ++k) {
        const bool need = first && lane + k < end;
        if (!__any_sync(FULL, need)) break;
#pragma unroll
        for (int a = 0; a < A; ++a)
          if (a < spec.n_aggs) {
            const uint64_t y = __shfl_down_sync(FULL, x.v[a], k);
            const uint32_t c = __shfl_down_sync(FULL, x.c[a], k);
            if (need) {
              acc.v[a] = combine(spec.func[a], spec.type[a], acc.v[a], y);
              acc.c[a] += c;
            }
          }
        const uint32_t p = __shfl_down_sync(FULL, x.p, k);
        if (need) acc.p += p;
      }
      if (!(m & 1u)) acc_bcast(spec, carry, acc, 0);   // piece 0 joins carry
      if (m) {
        if (open) {                       // carry's group ends here
          if (lane == 0 && g - 1 < oc)
            store_final(spec, mout, g - 1, carry, n, write_pres);
        } else if (lane == 0) {
          s_head[warp] = carry;           // the warp's rows before its start
        }
        if (((m >> lane) & 1u) && above) {
          const int64_t gid = g + __popc(m & below);
          if (gid < oc) store_final(spec, mout, gid, acc, n, write_pres);
        }
        acc_bcast(spec, carry, acc, 31 - __clz(m));
        open = true;
        g += __popc(m);
      }
    }
    if (lane == 0) {
      if (open) s_tail[warp] = carry;
      else s_head[warp] = carry;
    }
    __syncthreads();
    // across warps, in warp order: a warp's last group runs through the
    // heads of the following warps up to the next start; the tile's head
    // is the warps' heads up to its first start. A head of fewer than
    // SHORT rows is folded row by row by its own warp, onto the tail
    // before it (the group's order, wherever the warps cut it).
    if (warp > 0 && s_cnt[warp] > 0 && s_hlen[warp] < SHORT &&
        s_cnt[warp - 1] > 0) {
      Acc<A> acc = s_tail[warp - 1];
      warp_rows<A, MEMBERS>(spec, perm, active, mask, b, wbase,
                            s_hlen[warp], acc);
      const int64_t gid = s_g0 + s_excl[warp - 1] + s_cnt[warp - 1] - 1;
      if (lane == 0 && gid < oc)
        store_final(spec, mout, gid, acc, n, write_pres);
    }
    if (threadIdx.x < WARPS) {
      const int w = threadIdx.x;
      const bool short_next = w + 1 < WARPS && s_cnt[w + 1] > 0 &&
                              s_hlen[w + 1] < SHORT;
      if (s_cnt[w] > 0 && !short_next) {
        Acc<A> acc = s_tail[w];
        int w2 = w + 1;
        for (; w2 < WARPS && s_cnt[w2] == 0; ++w2) acc_add(spec, acc, s_head[w2]);
        if (w2 < WARPS) {
          acc_add(spec, acc, s_head[w2]);
          const int64_t gid = s_g0 + s_excl[w] + s_cnt[w] - 1;
          if (gid < oc) store_final(spec, mout, gid, acc, n, write_pres);
        } else {
          store_raw(spec, member_part(tail, spec.n_aggs, b), t, acc);
        }
      }
    } else if (threadIdx.x == WARPS) {
      Acc<A> acc = s_head[0];
      for (int w2 = 0; s_cnt[w2] == 0 && w2 + 1 < WARPS;) {
        ++w2;
        acc_add(spec, acc, s_head[w2]);
      }
      store_raw(spec, member_part(head, spec.n_aggs, b), t, acc);
    }
    __syncthreads();                      // s_head / s_tail are reused
  }
}

// (a) one warp per (tile with a group start, member): that tile's last
// group is its tail plus the heads of the following tiles, through the
// next tile that holds a start (whose head ends at that start); a head
// shorter than SHORT rows is folded row by row (the group's order, as in
// seg_fold), a tile with no active row (head length -1) adding nothing;
// (b) with `zero_slots`, every slot past ngroups gets zeros;
// (c) `clear_words` words of `clear` (seg_members' look-back words) are
// zeroed. tile_cnt holds the tiles' start counts, then their head
// lengths.
template <int A, bool MEMBERS>
__global__ void __launch_bounds__(THREADS, 1)
seg_fix(int64_t T, int64_t n, const int32_t* perm, const uint8_t* active,
        const uint8_t* masks, int64_t mask_stride, const int32_t* tile_cnt,
        const int64_t* tile_off, const int32_t* ngroups, int64_t oc,
        AggSpec spec, int write_lead, int write_pres, int32_t* lead,
        Part out_all, Part head_all, Part tail_all, int zero_slots,
        unsigned long long* clear, int64_t clear_words) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.y == 0)
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
         i < clear_words; i += (int64_t)gridDim.x * THREADS)
      clear[i] = 0;
  const int64_t b = blockIdx.y;
  const uint8_t* mask = masks + b * mask_stride;
  const Part out = member_part(out_all, spec.n_aggs, b);
  const Part head = member_part(head_all, spec.n_aggs, b);
  const Part tail = member_part(tail_all, spec.n_aggs, b);
  const int64_t nwarps = (int64_t)gridDim.x * WARPS;
  for (int64_t t = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5); t < T;
       t += nwarps) {
    if (tile_cnt[t] == 0) continue;       // whole warp together
    const int64_t g = tile_off[t] + tile_cnt[t] - 1;
    if (g >= oc) continue;
    int64_t e = T;
    for (int64_t j0 = t + 1; j0 < T; j0 += 32) {
      const int64_t j = j0 + lane;
      const unsigned m = __ballot_sync(FULL, j < T && tile_cnt[j] > 0);
      if (m) {
        e = j0 + __ffs(m) - 1;
        break;
      }
    }
    if (e < T && e == t + 1 && tile_cnt[T + e] < SHORT) {
      Acc<A> x;
      load_raw(spec, tail, t, x);
      warp_rows<A, MEMBERS>(spec, perm, active, mask, b, e * TILE,
                            tile_cnt[T + e], x);
      if (lane == 0) store_final(spec, out, g, x, n, write_pres);
      continue;
    }
    const int64_t last = e < T ? e : T - 1;
    Acc<A> acc;
    acc_init(spec, acc);
    for (int64_t j = t + 1 + lane; j <= last; j += 32) {
      if (tile_cnt[T + j] < 0) continue;  // no active row: the identity
      Acc<A> h;
      load_raw(spec, head, j, h);
      acc_add(spec, acc, h);
    }
    acc_warp_fold(spec, acc);
    if (lane == 0) {
      Acc<A> x;
      load_raw(spec, tail, t, x);
      acc_add(spec, x, acc);
      store_final(spec, out, g, x, n, write_pres);
    }
  }
  if (!zero_slots) return;
  const int64_t ng = *ngroups;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t slot = ng + (int64_t)blockIdx.x * THREADS + threadIdx.x;
       slot < oc; slot += stride) {
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (a < spec.n_aggs) {
        out.val[a * out.stride + slot] = 0;
        out.cnt[a * out.stride + slot] = 0;
      }
    if (write_pres) out.pres[slot] = 0;
    if (write_lead && b == 0) lead[slot] = 0;
  }
}

template <int A>
static cudaError_t launch_a(int64_t n, const int32_t* perm, const Keys& K,
                            const uint8_t* active, int B,
                            const uint8_t* masks, int64_t mask_stride,
                            int64_t oc, const AggSpec& spec, int write_lead,
                            int write_pres, int32_t* lead, Part out,
                            Part head, Part tail, uint64_t* status,
                            int64_t T, int32_t* tile_cnt, int64_t* tile_off,
                            int32_t* ngroups, int zero_slots,
                            unsigned long long* clear, int64_t clear_words,
                            cudaStream_t s) {
  // member groups a tile: the members' passes spread over G blocks
  const int G = B < MGROUPS ? B : MGROUPS;
  if (B > 1)
    seg_fold<A, true><<<(unsigned)(T * G), THREADS, 0, s>>>(
        n, perm, K, active, B, G, masks, mask_stride, oc, spec, write_lead,
        write_pres, lead, out, head, tail, status, T, tile_cnt, tile_off,
        ngroups);
  else
    seg_fold<A, false><<<(unsigned)T, THREADS, 0, s>>>(
        n, perm, K, active, 1, 1, active, 0, oc, spec, write_lead,
        write_pres, lead, out, head, tail, status, T, tile_cnt, tile_off,
        ngroups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // enough warps for the tiles, and enough threads for the zero slots
  int64_t blocks = (T + WARPS - 1) / WARPS;
  const int64_t zero_blocks = zero_slots
      ? (oc + THREADS * 8 - 1) / (THREADS * 8)
      : (clear_words + THREADS * 8 - 1) / (THREADS * 8);
  if (zero_blocks > blocks) blocks = zero_blocks < 4096 ? zero_blocks : 4096;
  const dim3 grid((unsigned)blocks, B);
  if (B > 1)
    seg_fix<A, true><<<grid, THREADS, 0, s>>>(
        T, n, perm, active, masks, mask_stride, tile_cnt, tile_off, ngroups,
        oc, spec, write_lead, write_pres, lead, out, head, tail, zero_slots,
        clear, clear_words);
  else
    seg_fix<A, false><<<grid, THREADS, 0, s>>>(
        T, n, perm, active, active, 0, tile_cnt, tile_off, ngroups, oc,
        spec, write_lead, write_pres, lead, out, head, tail, zero_slots,
        clear, clear_words);
  return cudaGetLastError();
}

// ------------------------------------------------------- member compaction

#define MT 256                            // threads of seg_members
#define MWARPS (MT / 32)
#define MPT 16                            // runs a thread of a tile
#define MTILE (MT * MPT)                  // runs a tile: 4,096
#define MZROWS 16384                      // slots a zero item
#define MBLOCKS 4                         // seg_members blocks an SM
#define MLB_AGG (1ull << 32)              // look-back words: the flags,
#define MLB_PRE (1ull << 33)              // then the count
#define MLB_VALUE 0xffffffffull
#define MLB_WALK 8                        // earlier tiles' words read at once

// A chunk's outputs: per aggregate its (B, oc) values and counts (null:
// not written — the hidden first, whose value is lead); lead (B, oc)
// int32, present (B, oc) and ngroups (B,) from the first chunk only.
struct MOut {
  int n_aggs;
  uint64_t* val[MAX_AGGS];
  uint64_t* cnt[MAX_AGGS];
  int lead_agg;                           // -1: no lead in this chunk
  int32_t* lead;
  uint64_t* pres;
  int32_t* ngroups;
};

// elements [e0, e1) of dst zeroed: 16-byte stores, the unaligned ends
// element by element
__device__ __forceinline__ void zero_range(void* dst, int size, int64_t e0,
                                           int64_t e1) {
  char* p = (char*)dst;
  const uintptr_t b0 = (uintptr_t)(p + e0 * size);
  const uintptr_t b1 = (uintptr_t)(p + e1 * size);
  const uintptr_t a0 = (b0 + 15) & ~(uintptr_t)15, a1 = b1 & ~(uintptr_t)15;
  if (a0 >= a1) {
    for (int64_t e = e0 + threadIdx.x; e < e1; e += MT) {
      if (size == 4) ((uint32_t*)p)[e] = 0;
      else ((uint64_t*)p)[e] = 0;
    }
    return;
  }
  const int head = (int)((a0 - b0) / size), tail = (int)((b1 - a1) / size);
  for (int i = threadIdx.x; i < head + tail; i += MT) {
    const int64_t e = i < head ? e0 + i : e1 - tail + (i - head);
    if (size == 4) ((uint32_t*)p)[e] = 0;
    else ((uint64_t*)p)[e] = 0;
  }
  uint4* v = (uint4*)a0;
  const int64_t nv = (int64_t)(a1 - a0) / 16;
  for (int64_t q = threadIdx.x; q < nv; q += MT) v[q] = make_uint4(0, 0, 0, 0);
}

// Items by ticket: (tile of 4,096 union runs, member) tile by tile, then
// (member, chunk of MZROWS slots) zero items. A tile ranks the member's
// runs with rows (present > 0) and moves their partials to their ranks;
// its base is the member's kept runs in earlier tiles (a look-back over
// words member_lb[b * TMcap + t]). A zero item clears [ngroups_b, oc) ∩
// its chunk, waiting for the member's last tile where the chunk starts
// below the union's runs. The block that draws the last ticket clears the
// ticket and the fold's `fold_words` control words.
__global__ void __launch_bounds__(MT, MBLOCKS)
seg_members(int B, int64_t oc, const int32_t* ngroups_u, Part part,
            MOut out, unsigned long long* ticket,
            unsigned long long* member_lb, int64_t TMcap,
            unsigned long long* fold_ctl, int64_t fold_words) {
  __shared__ int64_t s_item, s_before, s_ng;
  __shared__ int s_wcnt[MWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t ngu_raw = *ngroups_u;
  const int64_t ngu = ngu_raw < oc ? ngu_raw : oc;
  const int64_t TM = (ngu + MTILE - 1) / MTILE;
  const int64_t ZC = (oc + MZROWS - 1) / MZROWS;
  const int64_t total = TM * B + (int64_t)B * ZC;
  const int A = out.n_aggs;
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t item = (int64_t)atomicAdd(ticket, 1ull);
      if (item == total + gridDim.x - 1) {      // the last draw
        *ticket = 0;
        s_item = -1;
      } else {
        s_item = item;
      }
    }
    __syncthreads();
    const int64_t item = s_item;
    if (item < 0) {                             // every block is done
      for (int64_t i = threadIdx.x; i < fold_words; i += MT) fold_ctl[i] = 0;
      return;
    }
    if (item >= total) return;
    if (item >= TM * B) {                       // a zero item
      const int64_t z = item - TM * B;
      const int b = (int)(z / ZC);
      const int64_t j = z - (int64_t)b * ZC;
      const int64_t lo = j * MZROWS;
      const int64_t hi = lo + MZROWS < oc ? lo + MZROWS : oc;
      if (threadIdx.x == 0) {
        int64_t ng = 0;
        if (lo < ngu && TM > 0) {               // the member's count
          const unsigned long long* w = member_lb + b * TMcap + (TM - 1);
          uint64_t v;
          while (((v = *(const volatile unsigned long long*)w) & MLB_PRE)
                 == 0) {
          }
          ng = (int64_t)(v & MLB_VALUE);
        }
        if (TM == 0 && j == 0 && out.ngroups != nullptr) out.ngroups[b] = 0;
        s_ng = ng;
      }
      __syncthreads();
      const int64_t from = lo > s_ng ? lo : s_ng;
      if (from < hi) {
        const int64_t e0 = (int64_t)b * oc + from, e1 = (int64_t)b * oc + hi;
        if (out.lead != nullptr) zero_range(out.lead, 4, e0, e1);
        if (out.pres != nullptr) zero_range(out.pres, 8, e0, e1);
        for (int a = 0; a < A; ++a) {
          if (out.val[a] != nullptr) zero_range(out.val[a], 8, e0, e1);
          if (out.cnt[a] != nullptr) zero_range(out.cnt[a], 8, e0, e1);
        }
      }
      continue;
    }
    const int64_t t = item / B;
    const int b = (int)(item - t * B);
    const Part P = member_part(part, A, b);
    // (1) each warp's 512 runs, 32 at a time: present > 0, ranked by
    // ballots
    const int64_t w0 = t * MTILE + (int64_t)warp * (32 * MPT);
    unsigned keep = 0;                          // bit j: run j is kept
    int wrank[MPT];
    int c = 0;
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int64_t g = w0 + j * 32 + lane;
      const bool k = g < ngu && P.pres[g] != 0;
      const unsigned m = __ballot_sync(FULL, k);
      wrank[j] = c + __popc(m & below);
      c += __popc(m);
      if (k) keep |= 1u << j;
    }
    if (lane == 0) s_wcnt[warp] = c;
    __syncthreads();
    // (2) the tile's count and the warps' bases; the member's earlier
    // tiles by a look-back (warp 0)
    if (warp == 0) {
      int x = lane < MWARPS ? s_wcnt[lane] : 0;
      const int v = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      const int tc = __shfl_sync(FULL, x, 31);
      if (lane < MWARPS) s_wcnt[lane] = x - v;
      int64_t before = 0;
      if (lane == 0) {
        unsigned long long* mine = member_lb + b * TMcap + t;
        if (t == 0) {
          *(volatile unsigned long long*)mine = MLB_PRE | (uint64_t)tc;
        } else {
          *(volatile unsigned long long*)mine = MLB_AGG | (uint64_t)tc;
          for (int64_t i = t - 1;;) {
            uint64_t w[MLB_WALK];
#pragma unroll
            for (int k = 0; k < MLB_WALK; ++k)
              w[k] = i - k >= 0
                  ? *(const volatile unsigned long long*)(member_lb +
                                                          b * TMcap + i - k)
                  : MLB_PRE;
            bool done = false;
#pragma unroll
            for (int k = 0; k < MLB_WALK; ++k) {
              if ((w[k] & (MLB_AGG | MLB_PRE)) == 0) break;
              before += (int64_t)(w[k] & MLB_VALUE);
              --i;
              if (w[k] & MLB_PRE) {
                done = true;
                break;
              }
            }
            if (done) break;
          }
          *(volatile unsigned long long*)mine =
              MLB_PRE | (uint64_t)(before + tc);
        }
        if (t == TM - 1 && out.ngroups != nullptr)
          out.ngroups[b] = (int32_t)(before + tc);
        s_before = before;
      }
    }
    __syncthreads();
    // (3) the kept runs' partials to their ranks
    const int64_t base = (int64_t)b * oc + s_before + s_wcnt[warp];
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      if (!((keep >> j) & 1u)) continue;
      const int64_t g = w0 + j * 32 + lane;
      const int64_t dst = base + wrank[j];
      if (out.pres != nullptr) out.pres[dst] = P.pres[g];
      for (int a = 0; a < A; ++a) {
        if (a == out.lead_agg && out.lead != nullptr)
          out.lead[dst] = (int32_t)P.val[a * P.stride + g];
        if (out.val[a] != nullptr) out.val[a][dst] = P.val[a * P.stride + g];
        if (out.cnt[a] != nullptr) out.cnt[a][dst] = P.cnt[a * P.stride + g];
      }
    }
  }
}

static int launch(
    int64_t n, const void* perm, int n_keys, const int64_t* key_ptrs,
    const void* active, int B, const void* masks, int64_t mask_stride,
    int n_aggs, const int64_t* data_ptrs, const int64_t* data_strides,
    const int64_t* valid_ptrs, const int64_t* valid_strides,
    const int32_t* funcs, const int32_t* types, int64_t oc, void* status,
    void* tile_cnt, void* tile_off, void* ngroups, void* lead,
    void* out_val, void* out_cnt, void* out_pres, void* head_val,
    void* head_cnt, void* head_pres, void* tail_val, void* tail_cnt,
    void* tail_pres, int first_chunk, int write_lead, const MOut* members,
    void* member_ctl, void* stream) {
  if (n_keys < 1 || n_keys > MAX_KEYS || n_aggs < 0 || n_aggs > MAX_AGGS ||
      oc < 1 || n >= (int64_t)1 << 31 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (n == 0) {                           // no group: every slot is zero
    if (members != nullptr) return (int)cudaErrorInvalidValue;
    const size_t slots = (size_t)B * oc * 8;
    if ((err = cudaMemsetAsync(out_val, 0, slots * n_aggs, s)) ||
        (err = cudaMemsetAsync(out_cnt, 0, slots * n_aggs, s)))
      return (int)err;
    if (first_chunk) {
      if ((err = cudaMemsetAsync(out_pres, 0, slots, s)) ||
          (err = cudaMemsetAsync(ngroups, 0, sizeof(int32_t), s)))
        return (int)err;
      if (write_lead && (err = cudaMemsetAsync(lead, 0, oc * 4, s)))
        return (int)err;
    }
    return (int)cudaSuccess;
  }
  Keys K;
  K.n = n_keys;
  for (int k = 0; k < MAX_KEYS; ++k)
    K.k[k] = k < n_keys ? (const uint64_t*)key_ptrs[k] : nullptr;
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
  const int64_t T = (n + TILE - 1) / TILE;
  const Part out = {(uint64_t*)out_val, (uint64_t*)out_cnt,
                    (uint64_t*)out_pres, oc};
  const Part head = {(uint64_t*)head_val, (uint64_t*)head_cnt,
                     (uint64_t*)head_pres, T};
  const Part tail = {(uint64_t*)tail_val, (uint64_t*)tail_cnt,
                     (uint64_t*)tail_pres, T};
  // the member form: seg_members' ticket, then its look-back words
  const int64_t TMcap = (oc + MTILE - 1) / MTILE;
  unsigned long long* mctl = (unsigned long long*)member_ctl;
  unsigned long long* clear = members != nullptr ? mctl + 1 : nullptr;
  const int64_t clear_words = members != nullptr ? (int64_t)B * TMcap : 0;
#define LAUNCH_A(A_)                                                        \
  launch_a<A_>(n, (const int32_t*)perm, K, (const uint8_t*)active, B,       \
               (const uint8_t*)masks, mask_stride, oc, spec,                \
               write_lead && first_chunk, first_chunk, (int32_t*)lead, out, \
               head, tail, (uint64_t*)status, T, (int32_t*)tile_cnt,       \
               (int64_t*)tile_off, (int32_t*)ngroups, members == nullptr,  \
               clear, clear_words, s)
  if (n_aggs <= 1) err = LAUNCH_A(1);
  else if (n_aggs <= 2) err = LAUNCH_A(2);
  else if (n_aggs <= 4) err = LAUNCH_A(4);
  else err = LAUNCH_A(8);
#undef LAUNCH_A
  if (err != cudaSuccess || members == nullptr) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int64_t items = (int64_t)B * TMcap +
                        (int64_t)B * ((oc + MZROWS - 1) / MZROWS);
  const int64_t cap = (int64_t)MBLOCKS * sms;
  seg_members<<<(unsigned)(items < cap ? items : cap), MT, 0, s>>>(
      B, oc, (const int32_t*)ngroups, out, *members, mctl, mctl + 1, TMcap,
      (unsigned long long*)status, T + 1);
  return (int)cudaGetLastError();
}

// status: T + 1 zeroed words (T = ceil(n / 2048)): the tiles' look-back
// words and the ticket counter; tile_cnt: 2T ints (the tiles' start
// counts, then their head lengths). Later chunks (first_chunk = 0) write the
// values and counts of their aggregates only.
extern "C" int segment_agg_launch(
    int64_t n, const void* perm, int n_keys, const int64_t* key_ptrs,
    const void* active, int n_aggs, const int64_t* data_ptrs,
    const int64_t* valid_ptrs, const int32_t* funcs, const int32_t* types,
    int64_t oc, void* status, void* tile_cnt, void* tile_off, void* ngroups,
    void* lead, void* out_val, void* out_cnt, void* out_pres,
    void* head_val, void* head_cnt, void* head_pres, void* tail_val,
    void* tail_cnt, void* tail_pres, int first_chunk, void* stream) {
  return launch(n, perm, n_keys, key_ptrs, active, 1, active, 0, n_aggs,
                data_ptrs, nullptr, valid_ptrs, nullptr, funcs, types, oc,
                status, tile_cnt, tile_off, ngroups, lead, out_val, out_cnt,
                out_pres, head_val, head_cnt, head_pres, tail_val, tail_cnt,
                tail_pres, first_chunk, 1, nullptr, nullptr, stream);
}

// B members over one shared sort: `active` is the union of the masks
// (the runs are cut over it), masks (B, n) rows mask_stride apart; each
// aggregate's data / validity shared or per member (strides in
// elements). Three launches: the fold and the fix write each member's
// partials at the union's runs (part_* (B, n_aggs, oc) and (B, oc), only
// [0, ngroups_u) written; head / tail (B, n_aggs, T) and (B, T)), and
// seg_members writes the outputs: per aggregate (B, oc) values and counts
// (val_ptrs / cnt_ptrs, 0: not written), and from the first chunk lead
// (B, oc) int32 from aggregate lead_agg, present (B, oc) and ngroups (B,)
// (the first chunk's fold writes the presence partials the later chunks
// rank by). fold_ctl: T + 1 words, zero on entry and left zero;
// member_ctl: 1 + B x ceil(oc / 4,096) words, the first zero on entry and
// left zero. n >= 1.
extern "C" int segment_agg_batched_launch(
    int64_t n, const void* perm, int n_keys, const int64_t* key_ptrs,
    const void* active, int B, const void* masks, int64_t mask_stride,
    int n_aggs, const int64_t* data_ptrs, const int64_t* data_strides,
    const int64_t* valid_ptrs, const int64_t* valid_strides,
    const int32_t* funcs, const int32_t* types, int64_t oc, void* fold_ctl,
    void* member_ctl, void* tile_cnt, void* tile_off, void* ngroups_u,
    void* part_val, void* part_cnt, void* part_pres, void* head_val,
    void* head_cnt, void* head_pres, void* tail_val, void* tail_cnt,
    void* tail_pres, int first_chunk, int lead_agg, void* lead,
    void* present, void* ngroups, const int64_t* val_ptrs,
    const int64_t* cnt_ptrs, void* stream) {
  if (n_aggs < 1 || n_aggs > MAX_AGGS || lead_agg >= n_aggs)
    return (int)cudaErrorInvalidValue;
  MOut mo;
  mo.n_aggs = n_aggs;
  for (int a = 0; a < MAX_AGGS; ++a) {
    mo.val[a] = a < n_aggs ? (uint64_t*)val_ptrs[a] : nullptr;
    mo.cnt[a] = a < n_aggs ? (uint64_t*)cnt_ptrs[a] : nullptr;
  }
  mo.lead_agg = lead_agg;
  mo.lead = first_chunk ? (int32_t*)lead : nullptr;
  mo.pres = first_chunk ? (uint64_t*)present : nullptr;
  mo.ngroups = first_chunk ? (int32_t*)ngroups : nullptr;
  return launch(n, perm, n_keys, key_ptrs, active, B, masks, mask_stride,
                n_aggs, data_ptrs, data_strides, valid_ptrs, valid_strides,
                funcs, types, oc, fold_ctl, tile_cnt, tile_off, ngroups_u,
                nullptr, part_val, part_cnt, part_pres, head_val, head_cnt,
                head_pres, tail_val, tail_cnt, tail_pres, first_chunk, 0,
                &mo, member_ctl, stream);
}
