// window_scan — segmented scans over rows in window-sorted order.
//
// Replaces the scans of ydb_tpu/ops/window_dev.py:_build_window_fn:
// the partition and order-group boundaries (adjacent comparison of the
// sorted operands), _seg_starts / _seg_ends (cummax / flipped cummin),
// the rank group starts, the dense-rank cumsum, the prefix sums of
// _prefix with their valid counts, and _segmented_scan_minmax. Per
// sorted position it writes, for each requested scan q, an inclusive
// scan of a per-row operand: the start index of the row's partition or
// order group (a max scan over the rows that start one), the count of
// order groups since the partition start, or a value (an 8-byte int or
// float read through the permutation, the identity where invalid) and
// its valid count under sum, min or max, reset at partition starts. The
// partition end index follows from the starts.
// Bound on the H100: bytes. Each sorted position reads its permutation
// entry and, through it, the words of its row (gathers: coalesced only
// where the frame is already nearly in window order; the row before's
// words are the neighbour's, mostly in L1) and one value and validity
// byte per scan; it writes 8 bytes per scan and the partition end. The
// arithmetic is a few adds and compares per scan.
// Design: two launches, every output row written once. (1) ws_scan: a block
// takes the next 1,024 sorted rows by ticket (so tiles start in order) and
// copies the scans' descriptors from the kernel parameters into shared
// memory (a parameter indexed by a run-time scan number is a slow
// constant-bank load at every use); its row ids come in and its outputs go
// out through shared memory, so global accesses are coalesced while each
// thread scans four consecutive rows. It marks the boundaries and scans
// every q within the tile (a warp scan by shuffles over (flag, value) pairs,
// the eight warp totals scanned in warp order; the operator a template
// argument, so a combine is one instruction), writing at once the rows at or
// after the tile's first partition start, whose values need nothing from
// earlier tiles. Scans that follow from the partition starts alone are
// written from them with no scan: a valid count without a validity column
// (the rows since the start) and, with no order words, the order-group start
// and the dense rank. The block's last warp publishes every q's tile
// aggregate and "holds a partition start", then walks back over the earlier
// tiles' status words to the nearest tile that holds a start or has
// published its inclusive prefix (only a tile without a start publishes
// one), and lane q folds that tile's prefix (or aggregate) and the
// aggregates after it in tile order into the carry, (f1,v1) . (f2,v2) =
// (f1|f2, f2 ? v2 : v1 o v2). The carry therefore is always the strict left
// fold from the tile that holds the partition's start, whichever predecessor
// had its prefix ready: float sums repeat bit for bit from run to run, and
// the exact scans (integer sums, counts, index max scans, float min / max,
// whose leftmost extreme wins ties and NaN) need no such care. The rows
// before the first start (the head, at the tile's start: the last warp holds
// them only in a tile without a start) are scanned again with the carry,
// from the thread's saved prefix and its operands read again (issued while
// the carry is found). A partition spanning many tiles costs each tile a
// walk back to the nearest published prefix and a fold of the aggregates
// since: with every tile in flight that is some hundred tiles back, so at
// 2^22 rows in one partition (4,097 tiles, all of them head) a tile reads
// that many aggregates per scan, eight loads at a time, and the head's
// second pass doubles the scan work (chip_smoke.py times this case). Each
// row's partition end comes from the flags alone, before the carry: the end
// row of a partition writes its index on the rows of its partition in its
// own tile, and at the partition's start row when that lies in an earlier
// tile. (2) ws_ends: a tile whose last partition runs on past it copies that
// mark, read once, to its rows of that partition, and every tile's status
// words go back to zero, so the caller keeps them from call to call with no
// fill of its own. Sums reset at partition starts, so a prefix never crosses
// a partition; a frame sum is a difference of prefixes of its own partition.
// Float sums are taken in another order than the plain version's (rtol 1e-9
// between them), without atomics on values.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_Q 32
#define MAX_WORDS 16
#define THREADS 256
#define WARPS (THREADS / 32)
#define PER 4
#define TILE (THREADS * PER)
#define FULL 0xffffffffu
#define NO_START INT64_MAX

// a tile's status word; status[T] is the ticket counter
#define ST_AGG 1u                   // its aggregates are published
#define ST_PRE 2u                   // its inclusive prefixes are published
#define ST_START 4u                 // it holds a partition start

enum { OP_SUM_I = 0, OP_SUM_F = 1, OP_MIN_I = 2, OP_MIN_F = 3,
       OP_MAX_I = 4, OP_MAX_F = 5 };
enum { SRC_PART_IDX = 0, SRC_ORDER_IDX = 1, SRC_ORDER_CNT = 2,
       SRC_VALUE = 3, SRC_VALID_CNT = 4 };

struct Words {
  int n_part;                       // the first n_part words: partition
  int n;                            // all words: partition, then order
  const int64_t* w[MAX_WORDS];
};

struct Scans {
  int nq;
  int op[MAX_Q];
  int seg[MAX_Q];                   // 1: reset at partition starts
  int src[MAX_Q];
  const uint64_t* data[MAX_Q];      // SRC_VALUE: 8-byte values
  const uint8_t* valid[MAX_Q];      // null = every row valid
  uint64_t* out[MAX_Q];
};

__device__ __forceinline__ double u2d(uint64_t u) {
  return __longlong_as_double((long long)u);
}
__device__ __forceinline__ uint64_t d2u(double d) {
  return (uint64_t)__double_as_longlong(d);
}

__device__ __forceinline__ uint64_t identity(int op) {
  switch (op) {
    case OP_MIN_I: return (uint64_t)INT64_MAX;
    case OP_MAX_I: return (uint64_t)INT64_MIN;
    case OP_MIN_F: return d2u(INFINITY);
    case OP_MAX_F: return d2u(-INFINITY);
    default: return 0;              // 0 and +0.0 share their bits
  }
}

// a ∘ b with a the earlier operand. Float min / max propagate NaN, as
// torch.minimum / torch.maximum (and jnp's) do.
__device__ __forceinline__ uint64_t apply_op(int op, uint64_t a,
                                             uint64_t b) {
  switch (op) {
    case OP_SUM_I: return (uint64_t)((int64_t)a + (int64_t)b);
    case OP_SUM_F: return d2u(u2d(a) + u2d(b));
    case OP_MIN_I: return (int64_t)b < (int64_t)a ? b : a;
    case OP_MAX_I: return (int64_t)b > (int64_t)a ? b : a;
    case OP_MIN_F: {
      const double x = u2d(a), y = u2d(b);
      return (x != x || x <= y) ? a : b;
    }
    default: {                      // OP_MAX_F
      const double x = u2d(a), y = u2d(b);
      return (x != x || x >= y) ? a : b;
    }
  }
}

// What a scan reads from memory for a thread's rows: the value and the
// validity of each row (SRC_VALUE; SRC_VALID_CNT with a validity column).
struct Raw {
  uint64_t v[PER];
  bool ok[PER];
};

// A scan's descriptor, copied once per block from the kernel parameters
// into shared memory: indexing the parameters by a run-time scan number
// reads the constant bank on every use, one slow load after another.
struct QDesc {
  int op, seg, src, derived;
  const uint64_t* data;
  const uint8_t* valid;
  uint64_t* out;
};

__device__ __forceinline__ bool reads_memory(const QDesc* Q, int q) {
  return Q[q].src == SRC_VALUE ||
         (Q[q].src == SRC_VALID_CNT && Q[q].valid != nullptr);
}

// the first scan at or after q that reads memory (nq: none)
__device__ __forceinline__ int next_read(const QDesc* Q, int nq, int q) {
  while (q < nq && !reads_memory(Q, q)) ++q;
  return q;
}

__device__ __forceinline__ void fetch(const QDesc* Q, int q,
                                      const int32_t* p, int rows, Raw& r) {
  const uint8_t* valid = Q[q].valid;
  const uint64_t* data = Q[q].src == SRC_VALUE ? Q[q].data : nullptr;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    r.v[k] = 0;
    r.ok[k] = true;
    if (k >= rows) continue;
    if (valid != nullptr) r.ok[k] = valid[p[k]] != 0;
    if (data != nullptr) r.v[k] = data[p[k]];
  }
}

// scan q's operand at sorted position i (boundary flags f; r: what
// fetch read, for the scans that read memory)
__device__ __forceinline__ uint64_t operand(const QDesc& d, int64_t i,
                                            int f, const Raw& r, int k,
                                            uint64_t id) {
  switch (d.src) {
    case SRC_PART_IDX: return (f & 1) ? (uint64_t)i : id;
    case SRC_ORDER_IDX: return (f & 2) ? (uint64_t)i : id;
    case SRC_ORDER_CNT: return (f & 2) ? 1 : 0;
    case SRC_VALUE: return r.ok[k] ? r.v[k] : id;
    default:                                // SRC_VALID_CNT
      return (d.valid == nullptr || r.ok[k]) ? 1 : 0;
  }
}

// an aggregate or prefix another block wrote: from L2, past this SM's L1
__device__ __forceinline__ uint64_t load_cg(const uint64_t* p) {
  return (uint64_t)__ldcg((const unsigned long long*)p);
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// A warp's 32 x PER rows pass through shared memory on their way in
// (row ids) and out (every scan, the ends), so that global accesses are
// coalesced while each thread scans PER consecutive rows. Padded slots
// keep the two access patterns nearly free of bank conflicts.
#define STAGE (32 * PER + 32)
#define FLAGS(f, k) (((f) >> (4 * (k))) & 15u)
__device__ __forceinline__ int pad64(int i) { return i + (i >> 2); }
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// One scan of a tile (OP a compile-time operator, so each combine is one
// instruction): the thread's PER operands v scanned in order, a warp scan
// of the thread totals by shuffles over (flag, value) pairs, (fa, a) .
// (fb, b) = (fa | fb, fb ? b : a o b), the warps' totals scanned in warp
// order (every warp alike), each row's value staged for a coalesced
// store of the rows at or after the tile's first start. Returns the
// thread's exclusive prefix; the last thread's last row is the tile's
// total.
struct TileCtx {
  int tid, lane, warp, wrow, first;
  int64_t t0, n;
  uint64_t* stage;
  uint64_t (*wv)[WARPS];
  int (*wf)[WARPS];
};

// The thread's PER row values r, staged, then stored coalesced: the rows
// at or after the tile's first start (the head waits for the carry).
__device__ __forceinline__ void store_rows(const TileCtx& c, uint64_t* out,
                                           const uint64_t (&r)[PER]) {
#pragma unroll
  for (int k = 0; k < PER; ++k) c.stage[pad64(c.lane * PER + k)] = r[k];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int l = c.wrow + j * 32 + c.lane;
    if (c.t0 + l < c.n && l >= c.first)
      out[c.t0 + l] = c.stage[pad64(j * 32 + c.lane)];
  }
  __syncwarp();
}

// Scans that follow from the partition starts alone, exactly, with no
// scan of their own: a valid count without a validity column (the rows
// since the start), and with no order words the order-group start (the
// partition start) and the dense rank (1).
enum { D_NONE = 0, D_ROWS = 1, D_START = 2, D_ONE = 3 };
__device__ __forceinline__ int derived(const Scans& S, const Words& W,
                                       int q) {
  if (S.src[q] == SRC_VALID_CNT && S.valid[q] == nullptr && S.seg[q])
    return D_ROWS;
  if (W.n == W.n_part && S.src[q] == SRC_ORDER_IDX) return D_START;
  if (W.n == W.n_part && S.src[q] == SRC_ORDER_CNT && S.seg[q]) return D_ONE;
  return D_NONE;
}

__device__ __forceinline__ uint64_t derive(int d, int64_t i,
                                           uint64_t start) {
  return d == D_ROWS ? (uint64_t)(i - (int64_t)start + 1)
                     : (d == D_START ? start : 1);
}

template <int OP>
__device__ __forceinline__ uint64_t scan_tile(const TileCtx& c, int q,
                                              int seg, unsigned f,
                                              uint64_t (&v)[PER],
                                              uint64_t* out,
                                              uint64_t* own, uint64_t* tot) {
  const uint64_t id = identity(OP);
  const int lane = c.lane, warp = c.warp, h = q & 1;
  bool tf = seg && (f & 1u);
#pragma unroll
  for (int k = 1; k < PER; ++k) {
    const bool reset = seg && (FLAGS(f, k) & 1u);
    v[k] = reset ? v[k] : apply_op(OP, v[k - 1], v[k]);
    tf = tf || reset;
  }
  uint64_t x = v[PER - 1];
  bool xf = tf;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t y = __shfl_up_sync(FULL, x, off);
    const bool yf = __shfl_up_sync(FULL, (int)xf, off) != 0;
    if (lane >= off) {
      x = xf ? x : apply_op(OP, y, x);
      xf = xf || yf;
    }
  }
  const uint64_t lx = __shfl_up_sync(FULL, x, 1);
  const bool lxf = __shfl_up_sync(FULL, (int)xf, 1) != 0;
  if (lane == 31) {
    c.wv[h][warp] = x;
    c.wf[h][warp] = xf;
  }
  __syncthreads();
  uint64_t wv = lane < WARPS ? c.wv[h][lane] : id;
  bool wf = lane < WARPS && c.wf[h][lane];
#pragma unroll
  for (int off = 1; off < WARPS; off <<= 1) {
    const uint64_t y = __shfl_up_sync(FULL, wv, off);
    const bool yf = __shfl_up_sync(FULL, (int)wf, off) != 0;
    if (lane >= off) {
      wv = wf ? wv : apply_op(OP, y, wv);
      wf = wf || yf;
    }
  }
  const uint64_t wp = __shfl_sync(FULL, wv, (warp + 31) & 31);
  uint64_t e = id;
  if (warp > 0) e = lane > 0 ? (lxf ? lx : apply_op(OP, wp, lx)) : wp;
  else if (lane > 0) e = lx;
  bool seen = false;
  uint64_t r[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    seen = seen || (seg && (FLAGS(f, k) & 1u));
    r[k] = (c.tid > 0 && !seen) ? apply_op(OP, e, v[k]) : v[k];
    if (own != nullptr) own[c.tid * PER + k] = r[k];
  }
  if (c.tid == THREADS - 1) *tot = r[PER - 1];
  store_rows(c, out, r);
  return e;
}

// The head rows (the thread's first hrows, before the tile's first start)
// from the thread's exclusive prefix e and the tile's carry.
template <int OP>
__device__ __forceinline__ void scan_head(int tid, int hrows, uint64_t e,
                                          uint64_t carry,
                                          const uint64_t (&v)[PER],
                                          int64_t r0, uint64_t* out,
                                          uint64_t* own) {
  uint64_t acc = v[0];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k >= hrows) break;
    if (k) acc = apply_op(OP, acc, v[k]);
    const uint64_t r = apply_op(OP, carry, tid > 0 ? apply_op(OP, e, acc)
                                                   : acc);
    out[r0 + k] = r;
    if (own != nullptr) own[tid * PER + k] = r;
  }
}

#define DISPATCH(op, CALL)                                                 \
  switch (op) {                                                            \
    case OP_SUM_I: { constexpr int O = OP_SUM_I; CALL; } break;            \
    case OP_SUM_F: { constexpr int O = OP_SUM_F; CALL; } break;            \
    case OP_MIN_I: { constexpr int O = OP_MIN_I; CALL; } break;            \
    case OP_MIN_F: { constexpr int O = OP_MIN_F; CALL; } break;            \
    case OP_MAX_I: { constexpr int O = OP_MAX_I; CALL; } break;            \
    default: { constexpr int O = OP_MAX_F; CALL; } break;                  \
  }

// s_excl: nq x THREADS words of dynamic shared memory (each thread's
// exclusive prefix within the tile, per scan); agg, inc: nq x T words.
__global__ void __launch_bounds__(THREADS, 3)
ws_scan(int64_t n, int64_t T, const int32_t* perm, Words W, Scans S,
        int do_ends, uint32_t* status, uint64_t* agg, uint64_t* inc,
        int64_t* seg_end) {
  extern __shared__ uint64_t s_excl[];
  __shared__ uint64_t s_stage[WARPS][STAGE];
  __shared__ uint64_t s_own[TILE];  // scan 0 (the partition start) per row
  __shared__ uint64_t s_wv[2][WARPS], s_tot[MAX_Q], s_carry[MAX_Q];
  __shared__ int s_wf[2][WARPS];
  __shared__ int64_t s_tile, s_after, s_wmin[WARPS];
  __shared__ int s_first;
  __shared__ QDesc s_q[MAX_Q];
  __shared__ const int64_t* s_w[MAX_WORDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = S.nq, n_words = W.n, n_part = W.n_part;
  if (tid == 0) {
    s_tile = (int64_t)atomicAdd(&status[T], 1u);
    s_first = TILE;
  }
  if (tid >= 32 && tid < 32 + nq) {
    const int q = tid - 32;
    s_q[q] = {S.op[q],   S.seg[q],   S.src[q], derived(S, W, q),
              S.data[q], S.valid[q], S.out[q]};
  }
  if (tid >= 64 && tid < 64 + n_words) s_w[tid - 64] = W.w[tid - 64];
  __syncthreads();
  const int64_t t = s_tile, t0 = t * TILE;
  const int64_t r0 = t0 + (int64_t)tid * PER;
  const int wrow = warp * 32 * PER;           // the warp's first row, local
  uint64_t* stage = s_stage[warp];

  // (1) boundaries: bit 0 a partition start, bit 1 an order-group start.
  // Every load of the rows is issued before any is used: the row ids,
  // the row before's, the first scan's operands, the words.
  const int rows = r0 >= n ? 0 : (int)(n - r0 < PER ? n - r0 : PER);
  // the last thread also reads the first row after the tile (does it
  // start a partition? the end of the rows counts as one)
  const bool edge = do_ends && tid == THREADS - 1 && t0 + TILE < n;
  const int32_t after = edge ? perm[t0 + TILE] : 0;
  int32_t p[PER], before;
  {
    const int64_t wb = t0 + wrow;           // the row before the warp's
    const int32_t wbefore =
        lane == 0 && wb > 0 && wb <= n ? perm[wb - 1] : 0;
    int32_t* st = (int32_t*)stage;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t i = wb + j * 32 + lane;
      st[pad32(j * 32 + lane)] = i < n ? perm[i] : 0;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER; ++k) p[k] = st[pad32(lane * PER + k)];
    before = lane > 0 ? st[pad32(lane * PER - 1)] : wbefore;
    __syncwarp();
  }
  int lq = next_read(s_q, nq, 0);
  Raw pre;
  if (lq < nq) fetch(s_q, lq, p, rows, pre);
  unsigned bp = r0 == 0 ? 1u : 0u, bo = 0u;   // bit k: row k's flags
  bool after_starts = false;
#pragma unroll 1
  for (int w = 0; w < n_words; ++w) {
    const int64_t* col = s_w[w];
    int64_t x[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) x[k] = k < rows ? col[p[k]] : 0;
    int64_t prev = rows > 0 && r0 > 0 ? col[before] : 0;
    const int64_t xa = edge && w < n_part ? col[after] : 0;
    unsigned d = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (k < rows && r0 + k > 0 && x[k] != prev) d |= 1u << k;
      prev = x[k];
    }
    if (w < n_part) {
      bp |= d;
      after_starts = after_starts || (edge && xa != x[PER - 1]);
    } else {
      bo |= d;
    }
  }
  // f: bits 0 / 1 of nibble k are row k's partition / order-group start
  unsigned f = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (k >= rows) continue;
    const unsigned a = (bp >> k) & 1u, o = ((bp | bo) >> k) & 1u;
    f |= (a | (o << 1)) << (4 * k);
    if (a) atomicMin(&s_first, tid * PER + k);
  }
  if (do_ends && tid == THREADS - 1)
    s_after = t0 + TILE >= n ? n : (after_starts ? t0 + TILE : NO_START);
  __syncthreads();
  const int first = s_first;        // the tile's first partition start
  const bool head = tid * PER < first;

  // (2) every scan within the tile; the rows from the first start on are
  // final
  const TileCtx ctx = {tid,   lane, warp,  wrow, first,
                       t0,    n,    stage, s_wv, s_wf};
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    const QDesc& d = s_q[q];
    const int seg = d.seg;
    const uint64_t id = identity(d.op);
    const int dq = d.derived;
    if (dq != D_NONE) {
      uint64_t r[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k)
        r[k] = derive(dq, r0 + k, s_own[tid * PER + k]);
      store_rows(ctx, d.out, r);
      if (tid == 0) s_tot[q] = 0;      // no carry: it has no scan
      continue;
    }
    // this scan's operands, and the next memory-reading scan's loads (a
    // scan that reads nothing waits on none of them)
    Raw raw;
    if (q == lq) {
      raw = pre;
      lq = next_read(s_q, nq, q + 1);
      if (lq < nq) fetch(s_q, lq, p, rows, pre);
    }
    uint64_t v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      v[k] = k < rows ? operand(d, r0 + k, (int)FLAGS(f, k), raw, k, id)
                      : id;
    uint64_t e;
    DISPATCH(d.op, e = scan_tile<O>(ctx, q, seg, f, v, d.out,
                                        q == 0 ? s_own : nullptr,
                                        &s_tot[q]));
    s_excl[q * THREADS + tid] = e;
  }
  // (3) partition ends, from the flags alone: the first start in the
  // thread's rows, the warp's suffix minimum of them
  int64_t right = NO_START;
  if (do_ends) {
    int64_t m = NO_START;
#pragma unroll
    for (int k = PER - 1; k >= 0; --k)
      if (FLAGS(f, k) & 1u) m = r0 + k;
    int64_t x = m;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_down_sync(FULL, x, off);
      if (lane + off < 32 && y < x) x = y;
    }
    right = __shfl_down_sync(FULL, x, 1);
    if (lane == 31) right = NO_START;
    if (lane == 0) s_wmin[warp] = x;
  }
  __syncthreads();

  // the head's first operands, read again while the carry is found
  const int hrows = head ? min(rows, first - tid * PER) : 0;
  int hq = next_read(s_q, nq, 0);
  Raw hpre;
  if (head && hq < nq) fetch(s_q, hq, p, hrows, hpre);

  // (4) publish the aggregates
  const uint32_t st = first < TILE ? ST_START : 0u;
  // (the last warp: it holds no head rows, whose reads run meanwhile)
  if (warp == WARPS - 1) {
    const int q = lane;
    if (q < nq) agg[(int64_t)q * T + t] = s_tot[q];
    if (t == 0 && q < nq) inc[(int64_t)q * T] = s_tot[q];
    __threadfence();
    __syncwarp();
    if (lane == 0)
      *(volatile uint32_t*)&status[t] = ST_AGG | st | (t == 0 ? ST_PRE : 0u);
  }
  // each row's partition end: the next start after it, past the tile the
  // next tile's first row if it starts one; the end row of a partition
  // begun in an earlier tile leaves its index at the partition's start
  // for ws_ends (in the head, once the carry gives that start)
  int64_t head_end = -1;
  if (do_ends) {
    for (int w = warp + 1; w < WARPS; ++w)
      if (s_wmin[w] < right) right = s_wmin[w];
    if (s_after < right) right = s_after;
    int64_t nxt = right;
#pragma unroll
    for (int k = PER - 1; k >= 0; --k) {
      const int64_t i = r0 + k;
      // NO_START: the row's partition runs on past the tile (ws_ends)
      stage[pad64(lane * PER + k)] =
          (uint64_t)(nxt == NO_START ? NO_START : nxt - 1);
      if (k < rows && nxt == i + 1) {
        if (tid * PER + k < first) {
          head_end = i;
        } else {
          const int64_t start = (int64_t)s_own[tid * PER + k];
          if (start < t0) seg_end[start] = i;
        }
      }
      if (FLAGS(f, k) & 1u) nxt = i;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int64_t i = t0 + wrow + j * 32 + lane;
      const int64_t e = (int64_t)stage[pad64(j * 32 + lane)];
      if (i < n && e != NO_START) seg_end[i] = e;
    }
  }

  // the carry from the earlier tiles
  if (warp == WARPS - 1) {
    const int q = lane;
    if (t > 0) {
      // the nearest earlier tile that holds a start or has its prefix
      int64_t stop = -1;
      uint32_t stop_s = 0;
      for (int64_t base = t - 1; stop < 0; base -= 32) {
        const int64_t j = base - lane;
        uint32_t s = j >= 0 ? load_status(&status[j]) : ST_PRE;
        while (__any_sync(FULL, s == 0))
          if (s == 0) s = load_status(&status[j]);
        const unsigned hit = __ballot_sync(FULL, (s & (ST_PRE | ST_START))
                                                     != 0);
        if (hit) {
          const int l = __ffs(hit) - 1;
          stop = base - l;
          stop_s = __shfl_sync(FULL, s, l);
        }
      }
      __syncwarp();   // the lanes' acquire loads order every lane's reads
      if (q < nq) {
        const int op = s_q[q].op;
        const uint64_t* a = agg + (int64_t)q * T;
        uint64_t c = load_cg((stop_s & ST_PRE) ? &inc[(int64_t)q * T + stop]
                                               : &a[stop]);
        // in tile order, the loads eight at a time ahead of the folds
        for (int64_t j = stop + 1; j < t; j += 8) {
          uint64_t x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = j + u < t ? load_cg(&a[j + u]) : 0;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (j + u < t) c = apply_op(op, c, x[u]);
        }
        s_carry[q] = c;
        if (!st) inc[(int64_t)q * T + t] = apply_op(op, c, s_tot[q]);
      }
      // a tile that holds a start ends every later walk with its
      // aggregates; the others publish their prefixes
      if (!st) {
        __threadfence();
        __syncwarp();
        if (lane == 0) *(volatile uint32_t*)&status[t] = ST_AGG | ST_PRE;
      }
    }
  }
  __syncthreads();

  // (5) the head: the rows before the tile's first start, scanned again
  // from the thread's saved prefix, with the carry; the end row of the
  // head's partition (begun in an earlier tile, at the carry) leaves its
  // index there for ws_ends
  if (head_end >= 0) seg_end[s_carry[0]] = head_end;
  if (head) {
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
      const QDesc& d = s_q[q];
      const int dq = d.derived;
      if (dq != D_NONE) {
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (k < hrows)
            d.out[r0 + k] = derive(dq, r0 + k, s_own[tid * PER + k]);
        continue;
      }
      const int op = d.op;
      const uint64_t id = identity(op), c = s_carry[q];
      const uint64_t e = s_excl[q * THREADS + tid];
      Raw raw;
      if (q == hq) {
        raw = hpre;
        hq = next_read(s_q, nq, q + 1);
        if (hq < nq) fetch(s_q, hq, p, hrows, hpre);
      }
      uint64_t v[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k)
        v[k] = k < hrows ? operand(d, r0 + k, (int)FLAGS(f, k), raw, k, id)
                         : id;
      DISPATCH(op, scan_head<O>(tid, hrows, e, c, v, r0, d.out,
                                     q == 0 ? s_own : nullptr));
    }
  }
}

// A tile whose last partition runs on past it: its rows of that partition
// take the end the partition's end row left at the partition's start.
// Every launch's status words go back to zero for the next call.
__global__ void ws_ends(int64_t n, int64_t T, const int64_t* seg_start,
                        int64_t* seg_end, uint32_t* status, int chunks) {
  __shared__ int64_t s_lo, s_v;
  const int64_t t = blockIdx.x, t0 = t * TILE;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    status[c * (T + 1) + t] = 0;
    if (t == 0) status[c * (T + 1) + T] = 0;      // the ticket
  }
  const int64_t last = (t0 + TILE < n ? t0 + TILE : n) - 1;
  if (threadIdx.x == 0) {
    s_lo = -1;
    if (last < n - 1 && seg_start[last + 1] != last + 1) {
      const int64_t s = seg_start[last];
      s_v = seg_end[s];
      s_lo = s >= t0 ? s + 1 : t0;  // the start row holds the end already
    }
  }
  __syncthreads();
  if (s_lo < 0) return;
  for (int64_t i = s_lo + threadIdx.x; i <= last; i += blockDim.x)
    seg_end[i] = s_v;
}

// status: chunks x (T + 1) words (T = ceil(n / 1024)), zero on entry and
// left zero on return: each launch's tiles' flags and ticket; this is
// launch `chunk` of `chunks` (the first also marks the partition ends,
// out[0] must be the partition start; the last runs ws_ends). lookback:
// 2 x nq x T words (the tiles' aggregates, then their prefixes).
extern "C" int window_scan_launch(
    int64_t n, const void* perm, int n_part, int n_words,
    const int64_t* word_ptrs, int nq, const int32_t* ops,
    const int32_t* segs, const int32_t* srcs, const int64_t* data_ptrs,
    const int64_t* valid_ptrs, const int64_t* out_ptrs, int64_t T,
    void* status, int chunk, int chunks, void* lookback, void* seg_end,
    void* stream) {
  if (n_part < 1 || n_words < n_part || n_words > MAX_WORDS || nq < 1 ||
      nq > MAX_Q || srcs[0] != SRC_PART_IDX || n >= ((int64_t)1 << 31) ||
      T != (n + TILE - 1) / TILE + (n == 0) || chunk < 0 || chunk >= chunks)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Words W;
  W.n_part = n_part;
  W.n = n_words;
  for (int w = 0; w < MAX_WORDS; ++w)
    W.w[w] = w < n_words ? (const int64_t*)word_ptrs[w] : nullptr;
  Scans S;
  S.nq = nq;
  for (int q = 0; q < MAX_Q; ++q) {
    const bool on = q < nq;
    S.op[q] = on ? ops[q] : OP_SUM_I;
    S.seg[q] = on ? segs[q] : 0;
    S.src[q] = on ? srcs[q] : SRC_VALID_CNT;
    S.data[q] = on ? (const uint64_t*)data_ptrs[q] : nullptr;
    S.valid[q] = on ? (const uint8_t*)valid_ptrs[q] : nullptr;
    S.out[q] = on ? (uint64_t*)out_ptrs[q] : nullptr;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)nq * THREADS * 8;
  cudaError_t err = cudaFuncSetAttribute(
      ws_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  uint64_t* lb = (uint64_t*)lookback;
  uint32_t* st = (uint32_t*)status;
  ws_scan<<<(unsigned)T, THREADS, smem, s>>>(
      n, T, (const int32_t*)perm, W, S, chunk == 0, st + chunk * (T + 1),
      lb, lb + (int64_t)nq * T, (int64_t*)seg_end);
  if ((err = cudaGetLastError()) != cudaSuccess || chunk != chunks - 1)
    return (int)err;
  ws_ends<<<(unsigned)T, THREADS, 0, s>>>(n, T, (const int64_t*)out_ptrs[0],
                                          (int64_t*)seg_end, st, chunks);
  return (int)cudaGetLastError();
}
