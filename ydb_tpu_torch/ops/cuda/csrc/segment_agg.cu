// segment_agg — per-group aggregation over rows in key-sorted order.
//
// Replaces the body of ydb_tpu/ops/xla_exec.py:_trace_group_by_sorted
// after its sort: the group boundaries (an active row whose key words
// differ from the previous row's), ngroups, the group starts compacted to
// the front of the output capacity, and count / sum / min / max / first
// per group — what _gather_sorted, _csum_diffs and _segment_scan built for
// XLA. The medium-domain lane (_groupby_medium_domain) uses it too, with
// the bucket id as the only key.
// Bound on the H100: bytes. Each sorted position reads its permutation
// entry and, through it, the row's activity, key words and one 8-byte
// value and validity byte per aggregate; the outputs are a few words per
// group. The reads through the permutation are gathers: coalesced where
// the input is already nearly in key order (lineitem by l_orderkey),
// scattered otherwise.
// Design: values are read through the permutation inside the kernel, so
// nothing is gathered into sorted order at scan capacity. Four launches:
// (1) seg_flags marks each sorted row that starts a group and counts the
// starts of each 1024-row tile; (2) seg_scan turns the tile counts into
// each tile's first group id and ngroups; (3) seg_reduce cuts each tile
// into pieces at its group starts: pieces shorter than 32 rows are folded
// by one thread in row order, longer ones by one warp (lanes fold rows in
// registers, then a fixed shuffle tree), so a group holding half the scan
// spreads over thousands of tiles instead of serializing one warp. Groups
// that start and end inside a tile are written at once; the piece before
// a tile's first start (its head) and the piece from its last start to
// its end (its tail) go to per-tile partials; (4) seg_fix gives a warp to
// each tile's last group and folds its tail with the heads of the
// following tiles up to the next start, in tile order. Sums fold each
// segment directly (no cumulative-sum differences), without atomics, in
// an order fixed by the input: float sums repeat bit for bit.
// Member axis (segment_agg_batched_launch, the batched serving lane): B
// members share one sort — the rows active in any member first, by key —
// and differ in their masks (and in any per-member value column). The
// runs of equal keys are cut once, over the union of the masks (launches
// 1 and 2 as above); seg_reduce stages each tile's permutation and run
// starts once and folds the tile for each member in turn, and seg_fix
// takes a warp per (tile, member). Each member gets a partial per run;
// the caller keeps the runs where the member has rows (compact_batched),
// which are exactly the groups a sort of that member's rows alone gives.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_AGGS 16
#define MAX_KEYS 16
#define TILE 1024
#define THREADS 256
#define WARPS (THREADS / 32)
#define PER_THREAD (TILE / THREADS)
#define LONG_PIECE 32                     // rows; a warp folds longer ones
#define FULL 0xffffffffu

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

__device__ __forceinline__ void init(const AggSpec& spec, uint64_t* la,
                                     uint64_t* lc) {
#pragma unroll
  for (int a = 0; a < MAX_AGGS; ++a) {
    la[a] = identity(spec.func[a], spec.type[a]);
    lc[a] = 0;
  }
}

// fold original row r (an active row of member b) into the running
// partial; MEMBERS = false (a single query) folds the stride terms away
template <bool MEMBERS>
__device__ __forceinline__ void fold_row(const AggSpec& spec, int32_t r,
                                         int64_t b, uint64_t* la,
                                         uint64_t* lc) {
#pragma unroll
  for (int a = 0; a < MAX_AGGS; ++a) {
    const int64_t vr = MEMBERS ? b * spec.vstride[a] + r : r;
    const int64_t dr = MEMBERS ? b * spec.dstride[a] + r : r;
    if (a < spec.n_aggs &&
        (spec.valid[a] == nullptr || spec.valid[a][vr] != 0)) {
      ++lc[a];
      const int f = spec.func[a];
      if (f == F_FIRST) la[a] = combine(f, spec.type[a], la[a], (uint64_t)r);
      else if (f != F_COUNT)
        la[a] = combine(f, spec.type[a], la[a], spec.data[a][dr]);
    }
  }
}

__device__ __forceinline__ void warp_fold_all(const AggSpec& spec,
                                              uint64_t* la, uint64_t* lc,
                                              uint64_t* lp) {
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < MAX_AGGS; ++a) {
      if (a < spec.n_aggs) {
        const uint64_t y = __shfl_down_sync(FULL, la[a], off);
        la[a] = combine(spec.func[a], spec.type[a], la[a], y);
        lc[a] += __shfl_down_sync(FULL, lc[a], off);
      }
    }
    *lp += __shfl_down_sync(FULL, *lp, off);
  }
}

__device__ __forceinline__ void store_raw(const AggSpec& spec, Part P,
                                          int64_t slot, const uint64_t* la,
                                          const uint64_t* lc, uint64_t lp) {
  for (int a = 0; a < spec.n_aggs; ++a) {
    P.val[a * P.stride + slot] = la[a];
    P.cnt[a * P.stride + slot] = lc[a];
  }
  P.pres[slot] = lp;
}

// a finished group: counts as values for count, typed zero for min / max
// with no valid row, n for first with none
__device__ __forceinline__ void store_final(const AggSpec& spec, Part P,
                                            int64_t slot, const uint64_t* la,
                                            const uint64_t* lc, uint64_t lp,
                                            int64_t n) {
  for (int a = 0; a < spec.n_aggs; ++a) {
    const int f = spec.func[a];
    uint64_t v = la[a];
    if (f == F_COUNT) v = lc[a];
    else if ((f == F_MIN || f == F_MAX) && lc[a] == 0) v = 0;
    else if (f == F_FIRST && lc[a] == 0) v = (uint64_t)n;
    P.val[a * P.stride + slot] = v;
    P.cnt[a * P.stride + slot] = lc[a];
  }
  P.pres[slot] = lp;
}

__global__ void __launch_bounds__(THREADS)
seg_flags(int64_t n, const int32_t* perm, Keys K, const uint8_t* active,
          uint8_t* flags, int32_t* tile_cnt) {
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int count = 0;
  for (int j = 0; j < PER_THREAD; ++j) {
    const int64_t i = base + j * THREADS + threadIdx.x;
    bool f = false;
    if (i < n) {
      const int32_t r = perm[i];
      if (active[r]) {
        if (i == 0) {
          f = true;
        } else {
          const int32_t q = perm[i - 1];
          f = active[q] == 0;
          for (int k = 0; k < K.n && !f; ++k) f = K.k[k][r] != K.k[k][q];
        }
      }
      flags[i] = f;
    }
    count += __syncthreads_count(f);
  }
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = count;
}

// one block: exclusive scan of the tile counts, and their total
__global__ void seg_scan(int64_t T, const int32_t* tile_cnt,
                         int64_t* tile_off, int32_t* ngroups) {
  __shared__ int64_t s[1024];
  const int64_t per = (T + blockDim.x - 1) / blockDim.x;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < T ? lo + per : T;
  int64_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += tile_cnt[i];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const int64_t v = threadIdx.x >= (unsigned)off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  int64_t run = s[threadIdx.x] - sum;
  for (int64_t i = lo; i < hi; ++i) {
    tile_off[i] = run;
    run += tile_cnt[i];
  }
  if (threadIdx.x == blockDim.x - 1) *ngroups = (int32_t)s[blockDim.x - 1];
}

// B members: member b's activity is masks[b * mask_stride + row]
template <bool MEMBERS>
__global__ void __launch_bounds__(THREADS)
seg_reduce(int64_t n, const int32_t* perm, int B, const uint8_t* masks,
           int64_t mask_stride, const uint8_t* flags,
           const int32_t* tile_cnt, const int64_t* tile_off, int64_t oc,
           AggSpec spec, int write_lead, int32_t* lead, Part out, Part head,
           Part tail) {
  __shared__ int32_t s_row[TILE];
  __shared__ uint8_t s_act[TILE];
  __shared__ uint8_t s_flag[TILE];
  __shared__ int16_t s_start[TILE];
  __shared__ int s_wsum[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x, base = t * TILE;
  const int len = (int)(n - base < TILE ? n - base : TILE);
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    int32_t r = 0;
    uint8_t a = 0, f = 0;
    if (i < len) {
      r = perm[base + i];
      if (!MEMBERS) a = masks[r];      // a single query's activity
      f = flags[base + i];
    }
    s_row[i] = r;
    s_act[i] = a;
    s_flag[i] = f;
  }
  __syncthreads();
  // positions of the tile's group starts, in order (block prefix sum)
  int c = 0;
  for (int j = 0; j < PER_THREAD; ++j) c += s_flag[threadIdx.x * PER_THREAD + j];
  int x = c;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_wsum[warp] = x;
  __syncthreads();
  int pos = x - c;
  for (int w = 0; w < warp; ++w) pos += s_wsum[w];
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x * PER_THREAD + j;
    if (s_flag[i]) s_start[pos++] = (int16_t)i;
  }
  __syncthreads();
  const int nb = tile_cnt[t];
  const int64_t g0 = tile_off[t];
  if (write_lead)
    for (int j = threadIdx.x; j < nb; j += THREADS)
      if (g0 + j < oc) lead[g0 + j] = s_row[s_start[j]];

  // piece p in [0, nb]: p = 0 is the head (rows before the first start),
  // piece p >= 1 starts at the p-th start; piece nb (nb >= 1) is the tail
  uint64_t la[MAX_AGGS], lc[MAX_AGGS];
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* active = masks + b * mask_stride;
    const Part mout = member_part(out, spec.n_aggs, b);
    const Part mhead = member_part(head, spec.n_aggs, b);
    const Part mtail = member_part(tail, spec.n_aggs, b);
    if (MEMBERS) {                       // this member's activity
      __syncthreads();                   // the previous member is folded
      for (int i = threadIdx.x; i < TILE; i += THREADS)
        s_act[i] = i < len ? active[s_row[i]] : 0;
      __syncthreads();
    }
    for (int p = threadIdx.x; p <= nb; p += THREADS) {
      const int lo = p == 0 ? 0 : s_start[p - 1];
      const int hi = p < nb ? s_start[p] : len;
      if (hi - lo >= LONG_PIECE) continue;
      init(spec, la, lc);
      uint64_t lp = 0;
      for (int i = lo; i < hi; ++i)
        if (s_act[i]) {
          ++lp;
          fold_row<MEMBERS>(spec, s_row[i], b, la, lc);
        }
      if (p == 0) store_raw(spec, mhead, t, la, lc, lp);
      else if (p == nb) store_raw(spec, mtail, t, la, lc, lp);
      else if (g0 + p - 1 < oc)
        store_final(spec, mout, g0 + p - 1, la, lc, lp, n);
    }
    for (int p = warp; p <= nb; p += WARPS) {
      const int lo = p == 0 ? 0 : s_start[p - 1];
      const int hi = p < nb ? s_start[p] : len;
      if (hi - lo < LONG_PIECE) continue;
      init(spec, la, lc);
      uint64_t lp = 0;
      for (int i = lo + lane; i < hi; i += 32)
        if (s_act[i]) {
          ++lp;
          fold_row<MEMBERS>(spec, s_row[i], b, la, lc);
        }
      warp_fold_all(spec, la, lc, &lp);
      if (lane == 0) {
        if (p == 0) store_raw(spec, mhead, t, la, lc, lp);
        else if (p == nb) store_raw(spec, mtail, t, la, lc, lp);
        else if (g0 + p - 1 < oc)
          store_final(spec, mout, g0 + p - 1, la, lc, lp, n);
      }
    }
  }
}

// one warp per (tile with a group start, member): that tile's last group
// is its tail plus the heads of the following tiles, through the next
// tile that holds a start (whose head ends at that start)
__global__ void __launch_bounds__(THREADS)
seg_fix(int64_t T, int64_t n, const int32_t* tile_cnt,
        const int64_t* tile_off, int64_t oc, AggSpec spec, Part out_all,
        Part head_all, Part tail_all) {
  const int lane = threadIdx.x & 31;
  const Part out = member_part(out_all, spec.n_aggs, blockIdx.y);
  const Part head = member_part(head_all, spec.n_aggs, blockIdx.y);
  const Part tail = member_part(tail_all, spec.n_aggs, blockIdx.y);
  const int64_t t = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T || tile_cnt[t] == 0) return;          // whole warp together
  const int64_t g = tile_off[t] + tile_cnt[t] - 1;
  if (g >= oc) return;
  int64_t e = T;
  for (int64_t b = t + 1; b < T; b += 32) {
    const int64_t j = b + lane;
    const unsigned m = __ballot_sync(FULL, j < T && tile_cnt[j] > 0);
    if (m) {
      e = b + __ffs(m) - 1;
      break;
    }
  }
  const int64_t last = e < T ? e : T - 1;
  uint64_t la[MAX_AGGS], lc[MAX_AGGS];
  init(spec, la, lc);
  uint64_t lp = 0;
  for (int64_t j = t + 1 + lane; j <= last; j += 32) {
    for (int a = 0; a < spec.n_aggs; ++a) {
      la[a] = combine(spec.func[a], spec.type[a], la[a],
                      head.val[a * head.stride + j]);
      lc[a] += head.cnt[a * head.stride + j];
    }
    lp += head.pres[j];
  }
  warp_fold_all(spec, la, lc, &lp);
  if (lane == 0) {
    uint64_t va[MAX_AGGS], vc[MAX_AGGS];
    for (int a = 0; a < spec.n_aggs; ++a) {
      va[a] = combine(spec.func[a], spec.type[a],
                      tail.val[a * tail.stride + t], la[a]);
      vc[a] = tail.cnt[a * tail.stride + t] + lc[a];
    }
    store_final(spec, out, g, va, vc, tail.pres[t] + lp, n);
  }
}

static int launch(
    int64_t n, const void* perm, int n_keys, const int64_t* key_ptrs,
    const void* active, int B, const void* masks, int64_t mask_stride,
    int n_aggs, const int64_t* data_ptrs, const int64_t* data_strides,
    const int64_t* valid_ptrs, const int64_t* valid_strides,
    const int32_t* funcs, const int32_t* types, int64_t oc, void* flags,
    void* tile_cnt, void* tile_off, void* ngroups, void* lead,
    void* out_val, void* out_cnt, void* out_pres, void* head_val,
    void* head_cnt, void* head_pres, void* tail_val, void* tail_cnt,
    void* tail_pres, int first_chunk, int write_lead, void* stream) {
  if (n_keys < 1 || n_keys > MAX_KEYS || n_aggs < 0 || n_aggs > MAX_AGGS ||
      oc < 1 || n >= (int64_t)1 << 31 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
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
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (first_chunk) {
    seg_flags<<<(unsigned)T, THREADS, 0, s>>>(
        n, (const int32_t*)perm, K, (const uint8_t*)active, (uint8_t*)flags,
        (int32_t*)tile_cnt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    seg_scan<<<1, 1024, 0, s>>>(T, (const int32_t*)tile_cnt,
                                (int64_t*)tile_off, (int32_t*)ngroups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 1)
    seg_reduce<true><<<(unsigned)T, THREADS, 0, s>>>(
        n, (const int32_t*)perm, B, (const uint8_t*)masks, mask_stride,
        (const uint8_t*)flags, (const int32_t*)tile_cnt,
        (const int64_t*)tile_off, oc, spec, write_lead, (int32_t*)lead, out,
        head, tail);
  else
    seg_reduce<false><<<(unsigned)T, THREADS, 0, s>>>(
        n, (const int32_t*)perm, B, (const uint8_t*)masks, mask_stride,
        (const uint8_t*)flags, (const int32_t*)tile_cnt,
        (const int64_t*)tile_off, oc, spec, write_lead, (int32_t*)lead, out,
        head, tail);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 fix_grid((unsigned)((T + WARPS - 1) / WARPS), B);
  seg_fix<<<fix_grid, THREADS, 0, s>>>(
      T, n, (const int32_t*)tile_cnt, (const int64_t*)tile_off, oc, spec,
      out, head, tail);
  return (int)cudaGetLastError();
}

extern "C" int segment_agg_launch(
    int64_t n, const void* perm, int n_keys, const int64_t* key_ptrs,
    const void* active, int n_aggs, const int64_t* data_ptrs,
    const int64_t* valid_ptrs, const int32_t* funcs, const int32_t* types,
    int64_t oc, void* flags, void* tile_cnt, void* tile_off, void* ngroups,
    void* lead, void* out_val, void* out_cnt, void* out_pres,
    void* head_val, void* head_cnt, void* head_pres, void* tail_val,
    void* tail_cnt, void* tail_pres, int first_chunk, void* stream) {
  return launch(n, perm, n_keys, key_ptrs, active, 1, active, 0, n_aggs,
                data_ptrs, nullptr, valid_ptrs, nullptr, funcs, types, oc,
                flags, tile_cnt, tile_off, ngroups, lead, out_val, out_cnt,
                out_pres, head_val, head_cnt, head_pres, tail_val, tail_cnt,
                tail_pres, first_chunk, first_chunk, stream);
}

// B members over one shared sort: `active` is the union of the masks
// (the runs are cut over it), masks (B, n) rows mask_stride apart; each
// aggregate's data / validity shared or per member (strides in
// elements). Outputs per member at the union's group slots: out
// (B, n_aggs, oc) and (B, oc); head / tail (B, n_aggs, T) and (B, T).
extern "C" int segment_agg_batched_launch(
    int64_t n, const void* perm, int n_keys, const int64_t* key_ptrs,
    const void* active, int B, const void* masks, int64_t mask_stride,
    int n_aggs, const int64_t* data_ptrs, const int64_t* data_strides,
    const int64_t* valid_ptrs, const int64_t* valid_strides,
    const int32_t* funcs, const int32_t* types, int64_t oc, void* flags,
    void* tile_cnt, void* tile_off, void* ngroups, void* out_val,
    void* out_cnt, void* out_pres, void* head_val, void* head_cnt,
    void* head_pres, void* tail_val, void* tail_cnt, void* tail_pres,
    int first_chunk, void* stream) {
  return launch(n, perm, n_keys, key_ptrs, active, B, masks, mask_stride,
                n_aggs, data_ptrs, data_strides, valid_ptrs, valid_strides,
                funcs, types, oc, flags, tile_cnt, tile_off, ngroups,
                nullptr, out_val, out_cnt, out_pres, head_val, head_cnt,
                head_pres, tail_val, tail_cnt, tail_pres, first_chunk, 0,
                stream);
}
