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
// entry and, through it, the words of its row and of the row before
// (gathers: coalesced only where the frame is already nearly in window
// order) and one value and validity byte per scan; it writes 8 bytes
// per scan. The arithmetic is a few adds and compares per scan.
// Design: a tiled block scan with one carry pass across tiles — (1)
// ws_tile: each 1024-row tile marks its boundaries (flags kept for
// later passes) and scans every q within the tile, four consecutive rows
// per thread and a Hillis–Steele pass over the 256 thread totals in
// shared memory, writing tile-local results and each tile's total and
// "holds a partition start" flag; (2) ws_carry: one block per q scans
// the tile totals in chunks of 1024 and writes each tile's exclusive
// carry; (3) ws_apply: each tile combines its carry into the rows
// before its first partition start (every row for the unsegmented start
// scans); (4) ws_end_mark and ws_end_fill: the last row of each
// partition writes its index at the partition's start, and every row
// reads it back from there. Sums reset at partition starts, so a prefix
// never crosses a partition; a frame sum is a difference of prefixes of
// its own partition. Float sums are taken in another order than the
// plain version's (rtol 1e-9 between them), without atomics: repeated
// runs give the same bits. Look-back and fused passes are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_Q 32
#define MAX_WORDS 16
#define THREADS 256
#define PER 4
#define TILE (THREADS * PER)
#define CARRY_THREADS 1024

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

__global__ void ws_tile(int64_t n, int64_t T, const int32_t* perm, Words W,
                        Scans S, uint8_t* flags, uint8_t* tile_flag,
                        uint64_t* tile_val) {
  __shared__ uint64_t sv[THREADS];
  __shared__ uint8_t sf[THREADS];
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * TILE + (int64_t)tid * PER;
  uint8_t f[PER];
  int32_t p[PER];
  for (int k = 0; k < PER; ++k) {
    const int64_t i = r0 + k;
    f[k] = 0;
    p[k] = 0;
    if (i >= n) continue;
    p[k] = perm[i];
    bool bp = i == 0, bo = false;
    if (!bp) {
      const int32_t q = k ? p[k - 1] : perm[i - 1];
      for (int w = 0; w < W.n_part && !bp; ++w)
        bp = W.w[w][p[k]] != W.w[w][q];
      for (int w = W.n_part; w < W.n && !bp && !bo; ++w)
        bo = W.w[w][p[k]] != W.w[w][q];
    }
    f[k] = (bp ? 1 : 0) | ((bp || bo) ? 2 : 0);
    flags[i] = f[k];
  }
  for (int q = 0; q < S.nq; ++q) {
    const int op = S.op[q], seg = S.seg[q], src = S.src[q];
    const uint64_t id = identity(op);
    uint64_t v[PER];
    for (int k = 0; k < PER; ++k) {
      const int64_t i = r0 + k;
      if (i >= n) {
        v[k] = id;
        continue;
      }
      const bool ok = S.valid[q] == nullptr || S.valid[q][p[k]] != 0;
      switch (src) {
        case SRC_PART_IDX: v[k] = (f[k] & 1) ? (uint64_t)i : id; break;
        case SRC_ORDER_IDX: v[k] = (f[k] & 2) ? (uint64_t)i : id; break;
        case SRC_ORDER_CNT: v[k] = (f[k] & 2) ? 1 : 0; break;
        case SRC_VALUE: v[k] = ok ? S.data[q][p[k]] : id; break;
        default: v[k] = ok ? 1 : 0; break;       // SRC_VALID_CNT
      }
    }
    // the thread's own rows, in order
    uint8_t tf = 0;
    uint64_t acc = id;
    for (int k = 0; k < PER; ++k) {
      const bool reset = seg && (f[k] & 1);
      acc = reset ? v[k] : apply_op(op, acc, v[k]);
      v[k] = acc;
      tf |= reset;
    }
    // inclusive scan of the thread totals: (flag, value) pairs under
    // (fa, a) . (fb, b) = (fa | fb, fb ? b : a o b)
    sf[tid] = tf;
    sv[tid] = acc;
    __syncthreads();
    for (int d = 1; d < THREADS; d <<= 1) {
      uint8_t of = 0;
      uint64_t ov = 0;
      if (tid >= d) {
        of = sf[tid - d];
        ov = sv[tid - d];
      }
      __syncthreads();
      if (tid >= d) {
        const uint8_t cf = sf[tid];
        sv[tid] = cf ? sv[tid] : apply_op(op, ov, sv[tid]);
        sf[tid] = cf | of;
      }
      __syncthreads();
    }
    const uint64_t ev = tid ? sv[tid - 1] : id;
    bool seen = false;
    for (int k = 0; k < PER; ++k) {
      const int64_t i = r0 + k;
      if (seg && (f[k] & 1)) seen = true;
      const uint64_t r = (tid && !seen) ? apply_op(op, ev, v[k]) : v[k];
      if (i < n) S.out[q][i] = r;
    }
    if (tid == THREADS - 1) {
      tile_flag[(int64_t)q * T + blockIdx.x] = sf[tid];
      tile_val[(int64_t)q * T + blockIdx.x] = sv[tid];
    }
    __syncthreads();
  }
}

// one block per scan: exclusive carry of every tile
__global__ void ws_carry(int64_t T, Scans S, const uint8_t* tile_flag,
                         const uint64_t* tile_val, uint64_t* carry) {
  __shared__ uint64_t sv[CARRY_THREADS];
  __shared__ uint8_t sf[CARRY_THREADS];
  const int q = blockIdx.x, tid = threadIdx.x;
  const int op = S.op[q], seg = S.seg[q];
  const uint64_t id = identity(op);
  uint64_t run = id;                // everything before this chunk
  for (int64_t base = 0; base < T; base += CARRY_THREADS) {
    const int64_t t = base + tid;
    sf[tid] = (t < T && seg) ? tile_flag[(int64_t)q * T + t] : 0;
    sv[tid] = t < T ? tile_val[(int64_t)q * T + t] : id;
    __syncthreads();
    for (int d = 1; d < CARRY_THREADS; d <<= 1) {
      uint8_t of = 0;
      uint64_t ov = 0;
      if (tid >= d) {
        of = sf[tid - d];
        ov = sv[tid - d];
      }
      __syncthreads();
      if (tid >= d) {
        const uint8_t cf = sf[tid];
        sv[tid] = cf ? sv[tid] : apply_op(op, ov, sv[tid]);
        sf[tid] = cf | of;
      }
      __syncthreads();
    }
    if (t < T) {
      uint64_t c = run;
      if (tid) c = sf[tid - 1] ? sv[tid - 1] : apply_op(op, run, sv[tid - 1]);
      carry[(int64_t)q * T + t] = c;
    }
    const uint8_t lf = sf[CARRY_THREADS - 1];
    const uint64_t lv = sv[CARRY_THREADS - 1];
    __syncthreads();
    run = lf ? lv : apply_op(op, run, lv);
  }
}

__global__ void ws_apply(int64_t n, int64_t T, Scans S,
                         const uint64_t* carry) {
  if (blockIdx.x == 0) return;      // the first tile has no carry
  const int64_t t0 = (int64_t)blockIdx.x * TILE;
  const int64_t r0 = t0 + (int64_t)threadIdx.x * PER;
  for (int k = 0; k < PER; ++k) {
    const int64_t i = r0 + k;
    if (i >= n) return;
    // scan 0 is the partition start, still tile-local here: a start at
    // or after the tile's first row means one lies in [t0, i]
    const bool seen = (int64_t)S.out[0][i] >= t0;
    for (int q = 0; q < S.nq; ++q) {
      if (S.seg[q] && seen) continue;
      S.out[q][i] = apply_op(S.op[q], carry[(int64_t)q * T + blockIdx.x],
                             S.out[q][i]);
    }
  }
}

__global__ void ws_end_mark(int64_t n, const uint8_t* flags,
                            const int64_t* seg_start, int64_t* seg_end) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i == n - 1 || (flags[i + 1] & 1)) seg_end[seg_start[i]] = i;
}

__global__ void ws_end_fill(int64_t n, const int64_t* seg_start,
                            int64_t* seg_end) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = seg_start[i];
  if (s != i) seg_end[i] = seg_end[s];   // s holds the end since ws_end_mark
}

extern "C" int window_scan_launch(
    int64_t n, const void* perm, int n_part, int n_words,
    const int64_t* word_ptrs, int nq, const int32_t* ops,
    const int32_t* segs, const int32_t* srcs, const int64_t* data_ptrs,
    const int64_t* valid_ptrs, const int64_t* out_ptrs, int64_t T,
    void* flags, void* tile_flag, void* tile_val, void* carry,
    void* seg_end, void* stream) {
  if (n_part < 1 || n_words < n_part || n_words > MAX_WORDS || nq < 1 ||
      nq > MAX_Q || srcs[0] != SRC_PART_IDX || n >= ((int64_t)1 << 31) ||
      T != (n + TILE - 1) / TILE + (n == 0))
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
  ws_tile<<<(unsigned)T, THREADS, 0, s>>>(
      n, T, (const int32_t*)perm, W, S, (uint8_t*)flags,
      (uint8_t*)tile_flag, (uint64_t*)tile_val);
  ws_carry<<<(unsigned)nq, CARRY_THREADS, 0, s>>>(
      T, S, (const uint8_t*)tile_flag, (const uint64_t*)tile_val,
      (uint64_t*)carry);
  ws_apply<<<(unsigned)T, THREADS, 0, s>>>(n, T, S, (const uint64_t*)carry);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  ws_end_mark<<<blocks, 256, 0, s>>>(n, (const uint8_t*)flags,
                                     (const int64_t*)out_ptrs[0],
                                     (int64_t*)seg_end);
  ws_end_fill<<<blocks, 256, 0, s>>>(n, (const int64_t*)out_ptrs[0],
                                     (int64_t*)seg_end);
  return (int)cudaGetLastError();
}
