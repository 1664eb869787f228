// segments — the send segments of one shard's rows for a mesh exchange.
//
// Replaces ydb_tpu/parallel/collective.py:38 bucket_of and :56
// bucket_segments (one compress per target device) in one pass. Row r
// goes to target t = hash(keys[r]) % ndev as uint64, where hash is
// splitmix64 of each key as int64 (float keys converted as XLA converts:
// truncated, NaN 0, out-of-range values saturated), zeroed where the key
// is NULL, folded from the left by hash_combine (hash64.cuh, the same
// functions as hash64.cu). Rows r >= *length belong to no target, nor
// does a row whose given target lies outside [0, ndev). Each live row
// gets its rank among the earlier rows of its target (stable), and every
// column's value goes to segment[t][rank] when rank < seg. counts[t] =
// min(count_t, seg) and *overflow = any(count_t > seg). Slots past a
// segment's count are zero (a valid slot false). A caller may give the
// targets (`targets_in`) instead of the keys, and may ask for every
// row's target (`targets_out`, rows past the length included: what
// bucket_of returns).
// Bound on the H100: bytes. The keys (or targets) are read once and each
// column once; each of the [ndev, seg] slots of every output is written
// once. The callers take full-capacity segments (seg = the shard's
// capacity), so most slots are the zero tail and the tail's stores set
// the time. The hash is a few multiplies and shifts a key, far below the
// integer rate.
// Design: one launch up to 32 planes, with no host sync (the length
// stays on the device) and no fill: seg_scatter takes 4,096-row tiles of
// the live rows by ticket, then the zero tail's items. A tile computes
// its rows' targets (from the keys' hash, or the given targets) and ranks
// them stably in shared memory (each warp walks 512 rows 32 at a time;
// ballots on the target's ceil(log2 ndev) bits give a row its rank among
// the warp's rows of its target; a scan over the targets gives its slot
// in the tile); each target's first slot is the rows of the target in
// earlier tiles, a decoupled look-back over their counts (integers: the
// result does not depend on timing), and the last tile's inclusive sums
// are the targets' counts, clamped to seg, and the overflow flag. Then,
// column by column, the tile is read with 16-byte loads into shared
// memory, each row at its slot shifted so that a target's run has the
// alignment its destination has, and written out as one run a target,
// clamped at seg: each 16-byte line of the run is one vector store, the
// run's partial first and last lines element by element. A valid plane
// with no source (a column without NULLs) is written as ones. The next
// column's loads are issued while a column goes out, the first's while
// the tile is ranked. The items after the tiles zero the tail [count_t,
// seg) of every target and plane in 16-byte stores, in chunks of 4,096
// slots, each once the last tile has published the counts (an item is
// drawn after every tile, so the wait ends) unless it starts at or past
// the length, past every count. The look-back words carry
// the call's epoch and the ticket is left zero, so the control words,
// kept per stream, are never cleared. Up to 32 planes (a column's data
// and valid) move in a launch; a further launch moves 32 more, taking
// each tile's bases from the first launch's look-back words. A separate
// small kernel, seg_targets, writes every row's target alone (what
// bucket_of returns). An earlier form counted the targets in a census
// launch first and wrote the ids for the scatter: the census took 0.022
// of 0.267 ms at the shuffle join's routing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash64.cuh"

#define ST 256                  // threads of the scatter
#define SWARPS (ST / 32)
#define SI 16                   // rows a thread of a tile
#define SWROWS (32 * SI)        // rows a warp of a tile: 512
#define STILE (ST * SI)         // rows a tile: 4,096
#define MAX_TARGETS 256
#define MAX_KEYS 16
#define MAX_COLS 32
#define CT 256                  // threads of seg_targets
#define CR 8                    // rows a seg_targets lane reads at once
#define TBLOCKS 8               // seg_targets blocks an SM
#define SBLOCKS 2               // scatter blocks an SM
#define ZROWS 4096              // slots a zero-tail item
#define FULL 0xffffffffu
#define NOSLOT 0xffff           // a tile row that goes nowhere

// the control words (uint64, zeroed once by the wrapper): the ticket,
// left zero by each launch, then the look-back words (tiles x ndev)
#define CTL_HEAD 1

// look-back words: the call's epoch, the flags, then the count; a word
// of another epoch is not out yet
#define LB_WALK 8               // earlier tiles' words read at once
#define LB_AGG (1ull << 32)
#define LB_PRE (1ull << 33)
#define LB_VALUE 0xffffffffull
#define LB_EPOCH 34

// the staging buffer: a tile's rows plus up to V - 1 elements of
// alignment a target (V = 16 / element size), the largest at 8 bytes
#define SBUF_BYTES (((STILE + (MAX_TARGETS + 1) * 15 + 16) > \
                     (STILE + (MAX_TARGETS + 1) + 2) * 8     \
                         ? (STILE + (MAX_TARGETS + 1) * 15 + 16) \
                         : (STILE + (MAX_TARGETS + 1) + 2) * 8) + 15) / 16 * 16

struct Keys {
  int n;
  const void* k[MAX_KEYS];
  const uint8_t* v[MAX_KEYS];
  int kind[MAX_KEYS];          // 0 int64, 1 int32, 2 float64
};

struct Cols {
  int n_cols;
  const void* src[MAX_COLS];   // null: a valid plane of ones
  void* dst[MAX_COLS];
  int size[MAX_COLS];          // bytes per element: 1, 2, 4 or 8
};

// int64(x) as XLA converts a double: truncation toward zero, NaN to 0,
// values at or past +-2^63 saturated.
__device__ __forceinline__ int64_t f64_to_i64(double x) {
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return INT64_MAX;
  if (x <= -9223372036854775808.0) return INT64_MIN;
  return (int64_t)x;
}

__device__ __forceinline__ uint64_t load_lb(const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_lb(unsigned long long* p, uint64_t v) {
  *(volatile unsigned long long*)p = v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

__device__ __forceinline__ int64_t live_length(const int32_t* length,
                                               int64_t value, int64_t n) {
  const int64_t len = length != nullptr ? (int64_t)*length : value;
  return len < 0 ? 0 : (len > n ? n : len);
}

__device__ __forceinline__ int64_t key_i64(int64_t x) { return x; }
__device__ __forceinline__ int64_t key_i64(int32_t x) { return x; }
__device__ __forceinline__ int64_t key_i64(double x) { return f64_to_i64(x); }

// splitmix64 of key k (0 where NULL) at rows rb + 32 j (j < R) below lim,
// folded into h
template <int R, typename T>
__device__ __forceinline__ void hash_key(const T* kp, const uint8_t* vp,
                                         int k, int64_t rb, int64_t lim,
                                         uint64_t (&h)[R]) {
  uint64_t x[R];
  unsigned on = 0;                     // bit j: the key is not NULL
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r = rb + (int64_t)j * 32;
    x[j] = r < lim ? (uint64_t)key_i64(kp[r]) : 0;
    if (r < lim && (vp == nullptr || vp[r])) on |= 1u << j;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint64_t s = (on >> j) & 1u ? splitmix64(x[j]) : 0;
    h[j] = k == 0 ? s : hash_combine(h[j], s);
  }
}

// The given targets of rows rb + 32 j (j < R): -1 for a row at or past
// lim or with a target outside [0, ndev).
template <int R>
__device__ __forceinline__ void given_targets(const int32_t* given,
                                              int64_t rb, int64_t lim,
                                              int ndev, int (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r = rb + (int64_t)j * 32;
    d[j] = r < lim ? given[r] : -1;
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (d[j] >= ndev) d[j] = -1;
}

// The targets of rows rb + 32 j (j < R): the given ones, or the keys'
// hash; -1 for a row at or past lim or with a given target outside
// [0, ndev).
template <int R>
__device__ __forceinline__ void row_targets(const Keys& K,
                                            const int32_t* given,
                                            int64_t rb, int64_t lim,
                                            int ndev, int (&d)[R]) {
  if (given != nullptr) {
    given_targets<R>(given, rb, lim, ndev, d);
    return;
  }
  uint64_t h[R];
#pragma unroll 1
  for (int k = 0; k < K.n; ++k) {
    if (K.kind[k] == 1)
      hash_key<R>((const int32_t*)K.k[k], K.v[k], k, rb, lim, h);
    else if (K.kind[k] == 2)
      hash_key<R>((const double*)K.k[k], K.v[k], k, rb, lim, h);
    else
      hash_key<R>((const int64_t*)K.k[k], K.v[k], k, rb, lim, h);
  }
  const bool pow2 = (ndev & (ndev - 1)) == 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t r = rb + (int64_t)j * 32;
    const uint64_t t = pow2 ? (h[j] & (uint64_t)(ndev - 1))
                            : h[j] % (uint64_t)ndev;
    d[j] = r < lim ? (int)t : -1;
  }
}

// The lanes of the warp whose target equals this lane's, among `in`
// lanes: one ballot a bit of the target.
__device__ __forceinline__ unsigned target_peers(bool in, int d, int bits) {
  unsigned peers = __ballot_sync(FULL, in);
  for (int b = 0; b < bits; ++b) {
    const bool on = (d >> b) & 1;
    const unsigned m = __ballot_sync(FULL, on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// --------------------------------------------------------------- targets

// Every row's target (the keys' hash % ndev): what bucket_of returns.
__global__ void __launch_bounds__(CT)
seg_targets(int64_t n, Keys K, int ndev, int32_t* targets_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * CT * CR;
  for (int64_t c0 = ((int64_t)blockIdx.x * (CT / 32) + warp) * 32 * CR;
       c0 < n; c0 += stride) {
    int d[CR];
    row_targets<CR>(K, nullptr, c0 + lane, n, ndev, d);
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      const int64_t r = c0 + lane + (int64_t)j * 32;
      if (r < n) targets_out[r] = d[j];
    }
  }
}

// ---------------------------------------------------------------- scatter

// The rows of target b in tiles 0 .. t - 1: the earlier tiles' words back
// to the nearest inclusive prefix, LB_WALK words a round loaded at once.
__device__ __forceinline__ int64_t look_back(const unsigned long long* status,
                                             int ndev, int b, int64_t t,
                                             uint64_t epoch) {
  const uint64_t pre = (epoch << LB_EPOCH) | LB_PRE;
  int64_t sum = 0;
  for (int64_t j = t - 1;;) {
    uint64_t w[LB_WALK];
#pragma unroll
    for (int k = 0; k < LB_WALK; ++k)
      w[k] = j - k >= 0 ? load_lb(status + (j - k) * ndev + b) : pre;
#pragma unroll
    for (int k = 0; k < LB_WALK; ++k) {
      if ((w[k] >> LB_EPOCH) != epoch ||
          (w[k] & (LB_AGG | LB_PRE)) == 0)
        break;                                      // not out yet: again
      sum += (int64_t)(w[k] & LB_VALUE);
      --j;
      if (w[k] & LB_PRE) return sum;
    }
  }
}

// The inclusive count of target b through tile t, once that tile has
// published it.
__device__ __forceinline__ int64_t wait_prefix(
    const unsigned long long* status, int ndev, int b, int64_t t,
    uint64_t epoch) {
  const uint64_t pre = (epoch << LB_EPOCH) | LB_PRE;
  uint64_t w;
  while (((w = load_lb(status + t * ndev + b)) & ~LB_VALUE & ~LB_AGG) != pre) {
  }
  return (int64_t)(w & LB_VALUE);
}

// Exclusive scans of two values over a 256-thread block (wsum: 16 ints
// of shared memory); ta and tb get the block's sums.
__device__ __forceinline__ void block_excl2(int& a, int& b, int* wsum,
                                            int& ta, int& tb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = a, y = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, x, off);
    const int v = __shfl_up_sync(FULL, y, off);
    if (lane >= off) {
      x += u;
      y += v;
    }
  }
  if (lane == 31) {
    wsum[warp] = x;
    wsum[SWARPS + warp] = y;
  }
  __syncthreads();
  int bx = 0, by = 0, sx = 0, sy = 0;
#pragma unroll
  for (int w = 0; w < SWARPS; ++w) {
    const int u = wsum[w], v = wsum[SWARPS + w];
    if (w < warp) {
      bx += u;
      by += v;
    }
    sx += u;
    sy += v;
  }
  a = bx + x - a;
  b = by + y - b;
  ta = sx;
  tb = sy;
  __syncthreads();
}

// element e of a 16-byte vector of U
template <typename U>
__device__ __forceinline__ U vec_elem(const uint4& x, int e) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (sizeof(U) == 8) {
    return (U)(((uint64_t)w[2 * e + 1] << 32) | w[2 * e]);
  } else {
    constexpr int S = sizeof(U), E = 4 / S;
    constexpr unsigned M = S == 4 ? 0xffffffffu : (1u << (8 * S)) - 1u;
    return (U)((w[e / E] >> (8 * S * (e % E))) & M);
  }
}

// A column's tile of a full tile over an aligned view into registers,
// 16 bytes a load (size loads a thread); false for any other tile.
__device__ __forceinline__ bool fetch_column(const void* src, int size,
                                             int64_t row0, int rows,
                                             uint4 (&pre)[8]) {
  if (src == nullptr) return false;
  const uint4* sp = (const uint4*)((const char*)src + row0 * size);
  if (rows != STILE || !aligned16(sp)) return false;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < size) pre[k] = sp[threadIdx.x + k * ST];
  return true;
}

// the tile's shared state the columns read: per row its slot (NOSLOT for
// a row that goes nowhere) and target; per target and element size class
// k (1 << k bytes) the shift of its run in the staging buffer and the
// exclusive prefix of its 16-byte output lines; per target its run's
// first element in the output and its clamped length
struct Tile {
  uint16_t* slot;
  uint8_t* bin;
  const uint16_t* shift;       // [4][MAX_TARGETS]
  const int* lstart;           // [4][MAX_TARGETS]
  const int* ltot;             // [4]
  const int* g0;
  const int* m;
  const int* ls;
};

// One column's live tile rows into the staging buffer at their shifted
// slots: from the fetched vectors when `fetched`.
template <typename U>
__device__ __forceinline__ void stage_column(const U* src, int64_t row0,
                                             int rows, U* sb, const Tile& T,
                                             const uint4 (&pre)[8],
                                             bool fetched) {
  constexpr int V = 16 / sizeof(U);
  constexpr int k = sizeof(U) == 1 ? 0 : sizeof(U) == 2 ? 1
                    : sizeof(U) == 4 ? 2 : 3;
  const uint16_t* shift = T.shift + k * MAX_TARGETS;
  if (fetched) {
#pragma unroll
    for (int q = 0; q < (int)sizeof(U); ++q) {
      const int v = threadIdx.x + q * ST;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = v * V + e;
        const int s = T.slot[i];
        if (s != NOSLOT) sb[s + shift[T.bin[i]]] = vec_elem<U>(pre[q], e);
      }
    }
    return;
  }
  const U* sp = src + row0;
  for (int i = threadIdx.x; i < rows; i += ST) {
    const int s = T.slot[i];
    if (s != NOSLOT) sb[s + shift[T.bin[i]]] = sp[i];
  }
}

// a 16-byte vector of elements of value 1
template <typename U>
__device__ __forceinline__ uint4 ones_vec() {
  constexpr unsigned w = sizeof(U) == 1 ? 0x01010101u
                       : sizeof(U) == 2 ? 0x00010001u : 1u;
  if constexpr (sizeof(U) == 8) return make_uint4(1u, 0u, 1u, 0u);
  else return make_uint4(w, w, w, w);
}

// The staged runs out: every 16-byte output line of a target's run is
// one vector store where the run covers it, element by element where it
// begins or ends inside it. `ones`: a valid plane of ones (nothing
// staged).
template <typename U>
__device__ __forceinline__ void write_column(U* dst, const U* sb,
                                             const Tile& T, int ndev,
                                             bool ones) {
  constexpr int V = 16 / sizeof(U);
  constexpr int k = sizeof(U) == 1 ? 0 : sizeof(U) == 2 ? 1
                    : sizeof(U) == 4 ? 2 : 3;
  const int* lstart = T.lstart + k * MAX_TARGETS;
  const uint16_t* shift = T.shift + k * MAX_TARGETS;
  const bool dvec = aligned16(dst);
  const int total = T.ltot[k];
  for (int u = threadIdx.x; u < total; u += ST) {
    int lo = 0, hi = ndev - 1;              // the last b with lstart <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (lstart[mid] <= u) lo = mid;
      else hi = mid - 1;
    }
    const int b = lo;
    const int g0 = T.g0[b], g1 = g0 + T.m[b];
    const int e0 = (g0 / V + (u - lstart[b])) * V;    // the line's first
    const int sb0 = T.ls[b] + shift[b] + (e0 - g0);   // its staged place
    if (dvec && e0 >= g0 && e0 + V <= g1) {
      *(uint4*)(dst + e0) = ones ? ones_vec<U>() : *(const uint4*)(sb + sb0);
      continue;
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e0 + e >= g0 && e0 + e < g1)
        dst[e0 + e] = ones ? (U)1 : sb[sb0 + e];
  }
}

__device__ __forceinline__ void store_zero(char* p, int size, int64_t e) {
  switch (size) {
    case 1: ((uint8_t*)p)[e] = 0; break;
    case 2: ((uint16_t*)p)[e] = 0; break;
    case 4: ((uint32_t*)p)[e] = 0; break;
    default: ((uint64_t*)p)[e] = 0; break;
  }
}

// elements [e0, e1) of dst zeroed: 16-byte stores, the unaligned ends
// element by element
__device__ __forceinline__ void zero_range(void* dst, int size, int64_t e0,
                                           int64_t e1) {
  char* p = (char*)dst;
  const uintptr_t b0 = (uintptr_t)(p + e0 * size);
  const uintptr_t b1 = (uintptr_t)(p + e1 * size);
  const uintptr_t a0 = (b0 + 15) & ~(uintptr_t)15, a1 = b1 & ~(uintptr_t)15;
  if (a0 >= a1) {
    for (int64_t e = e0 + threadIdx.x; e < e1; e += ST) store_zero(p, size, e);
    return;
  }
  const int head = (int)((a0 - b0) / size), tail = (int)((b1 - a1) / size);
  if ((int)threadIdx.x < head) store_zero(p, size, e0 + threadIdx.x);
  if ((int)threadIdx.x < tail) store_zero(p, size, e1 - tail + threadIdx.x);
  uint4* v = (uint4*)a0;
  const int64_t nv = (int64_t)(a1 - a0) / 16;
  for (int64_t q = threadIdx.x; q < nv; q += ST) v[q] = make_uint4(0, 0, 0, 0);
}

// Items by ticket: the tiles of the live rows, then the zero tail's
// chunks (ZROWS slots of a target). `first`: the launch that ranks with
// the look-back and writes the counts and the flag; a later launch reads
// each tile's bases from the look-back words that launch left. The last
// block to draw its final ticket clears the ticket.
__global__ void __launch_bounds__(ST, SBLOCKS)
seg_scatter(int64_t n, Keys K, const int32_t* given, const int32_t* length,
            int64_t length_value, int ndev, int bits, int seg,
            int32_t* counts, bool* overflow, unsigned long long* ctl,
            uint64_t epoch, int first, Cols cols) {
  extern __shared__ uint4 seg_smem[];
  unsigned char* s_buf = (unsigned char*)seg_smem;          // SBUF_BYTES
  uint16_t* s_slot = (uint16_t*)(s_buf + SBUF_BYTES);       // STILE
  uint8_t* s_bin = (uint8_t*)(s_slot + STILE);              // STILE
  int* wcnt = (int*)(s_bin + STILE);                        // SWARPS x ndev
  __shared__ uint16_t s_shift[4 * MAX_TARGETS];
  __shared__ int s_lstart[4 * MAX_TARGETS];
  __shared__ int s_ltot[4];
  __shared__ int s_g0[MAX_TARGETS], s_m[MAX_TARGETS], s_ls[MAX_TARGETS];
  __shared__ int s_wsum[2 * SWARPS];
  __shared__ int s_over;
  __shared__ int64_t s_item, s_count;
  unsigned long long* status = ctl + CTL_HEAD;
  const Tile TS = {s_slot, s_bin, s_shift, s_lstart, s_ltot, s_g0, s_m, s_ls};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = threadIdx.x;                               // this thread's bin
  const unsigned below = (1u << lane) - 1u;
  const int64_t len = live_length(length, length_value, n);
  const int64_t T = (len + STILE - 1) / STILE;
  const int64_t ZC = seg > ZROWS ? (seg + ZROWS - 1) / ZROWS : 1;
  const int64_t total = T + (int64_t)ndev * ZC;
  for (;;) {
    __syncthreads();                   // the previous item is out
    if (threadIdx.x == 0) {
      const int64_t item = (int64_t)atomicAdd(ctl, 1ull);
      if (item == total + gridDim.x - 1) ctl[0] = 0;   // the last draw
      s_item = item;
      s_over = 0;
    }
    __syncthreads();
    const int64_t item = s_item;
    if (item >= total) return;
    if (item >= T) {                   // a chunk of a target's zero tail
      const int64_t z = item - T;
      const int t = (int)(z / ZC);
      const int64_t j = z - (int64_t)t * ZC;
      if (threadIdx.x == 0) {
        // a chunk at or past the length lies past every count: no wait
        const int64_t c = T > 0 && j * ZROWS < len
            ? wait_prefix(status, ndev, t, T - 1, epoch) : 0;
        s_count = c < seg ? c : seg;
        if (first && T == 0 && j == 0) {   // no tile: nothing counted
          counts[t] = 0;
          if (t == 0) *overflow = false;
        }
      }
      __syncthreads();
      const int64_t lo = j * ZROWS > s_count ? j * ZROWS : s_count;
      const int64_t hi = (j + 1) * ZROWS < seg ? (j + 1) * ZROWS : seg;
      if (lo < hi)
        for (int i = 0; i < cols.n_cols; ++i)
          zero_range(cols.dst[i], cols.size[i], (int64_t)t * seg + lo,
                     (int64_t)t * seg + hi);
      continue;
    }
    const int64_t t = item, row0 = t * STILE;
    const int rows = (int)(len - row0 < STILE ? len - row0 : STILE);
    // the first column's tile, loading while the tile is ranked
    uint4 pre[8];
    bool fetched = cols.n_cols > 0 &&
                   fetch_column(cols.src[0], cols.size[0], row0, rows, pre);
    // (1) each row's target, four rows at a time, and its rank among its
    // warp's earlier rows of that target
    for (int i = threadIdx.x; i < SWARPS * ndev; i += ST) wcnt[i] = 0;
    __syncthreads();
    const int w0 = warp * SWROWS;
    int d[SI];
#pragma unroll
    for (int q = 0; q < SI / 4; ++q) {
      int d4[4];
      row_targets<4>(K, given, row0 + w0 + q * 128 + lane, len, ndev, d4);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[q * 4 + k] = d4[k];
    }
    unsigned dig[SI / 4];              // four 8-bit targets an int
    unsigned rank[SI / 2];             // two 16-bit ranks (< SWROWS) an int
    unsigned inm = 0;                  // bit j: row j goes to a target
#pragma unroll
    for (int j = 0; j < SI; ++j) {
      const bool in = d[j] >= 0;
      const int dj = in ? d[j] : 0;
      const unsigned peers = target_peers(in, dj, bits);
      const unsigned r = in ? wcnt[warp * ndev + dj] + __popc(peers & below)
                            : 0;
      if (j & 3) dig[j >> 2] |= (unsigned)dj << (8 * (j & 3));
      else dig[j >> 2] = (unsigned)dj;
      if (j & 1) rank[j >> 1] |= r << 16;
      else rank[j >> 1] = r;
      if (in) inm |= 1u << j;
      __syncwarp();
      if (in && (peers & below) == 0)
        wcnt[warp * ndev + dj] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // (2) target b: the tile's count, each warp's first rank in it, the
    // rows of b in earlier tiles (the look-back; the last tile's sums are
    // the counts), its run in the output and, per element size, its
    // shift in the staging buffer and its 16-byte output lines
    int tc = 0;
    int64_t before = 0;
    if (b < ndev) {
      for (int w = 0; w < SWARPS; ++w) {
        const int c = wcnt[w * ndev + b];
        wcnt[w * ndev + b] = tc;
        tc += c;
      }
      unsigned long long* mine = status + t * ndev + b;
      const uint64_t tag = epoch << LB_EPOCH;
      if (!first) {
        before = t ? (int64_t)(status[(t - 1) * ndev + b] & LB_VALUE) : 0;
      } else if (t == 0) {
        store_lb(mine, tag | LB_PRE | (uint64_t)tc);
      } else {
        store_lb(mine, tag | LB_AGG | (uint64_t)tc);
        before = look_back(status, ndev, b, t, epoch);
        store_lb(mine, tag | LB_PRE | (uint64_t)(before + tc));
      }
      if (first && t == T - 1) {
        const int64_t c = before + tc;
        counts[b] = (int32_t)(c < seg ? c : seg);
        if (c > seg) s_over = 1;
      }
    }
    int ls = tc, zero = 0, t0, t1;
    block_excl2(ls, zero, s_wsum, t0, t1);
    if (first && t == T - 1 && threadIdx.x == 0) *overflow = s_over != 0;
    // the 16-byte lines of each element size, two 16-bit counts an int
    // (a tile's lines of a size stay below 2^13)
    int lines01 = 0, lines23 = 0;
    if (b < ndev) {
      for (int w = 0; w < SWARPS; ++w) wcnt[w * ndev + b] += ls;
      const int64_t room = (int64_t)seg - before;
      const int m = room <= 0 ? 0 : (int)(room < tc ? room : tc);
      const int g0 = b * seg + (int)(before < seg ? before : seg);
      s_g0[b] = g0;
      s_m[b] = m;
      s_ls[b] = ls;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int V = 16 >> k;
        const int R = ls + b * (V - 1);          // the run's region
        s_shift[k * MAX_TARGETS + b] =
            (uint16_t)(b * (V - 1) + (((g0 - R) % V) + V) % V);
        const int lk = m > 0 ? (g0 + m - 1) / V - g0 / V + 1 : 0;
        if (k < 2) lines01 |= lk << (16 * k);
        else lines23 |= lk << (16 * (k - 2));
      }
    }
    block_excl2(lines01, lines23, s_wsum, t0, t1);
    if (b < ndev) {
      s_lstart[b] = lines01 & 0xffff;
      s_lstart[MAX_TARGETS + b] = lines01 >> 16;
      s_lstart[2 * MAX_TARGETS + b] = lines23 & 0xffff;
      s_lstart[3 * MAX_TARGETS + b] = lines23 >> 16;
    }
    if (threadIdx.x == 0) {
      s_ltot[0] = t0 & 0xffff;
      s_ltot[1] = t0 >> 16;
      s_ltot[2] = t1 & 0xffff;
      s_ltot[3] = t1 >> 16;
    }
    __syncthreads();
    // (3) every row's slot in the tile (targets in order, rows in order)
#pragma unroll
    for (int j = 0; j < SI; ++j) {
      const int i = w0 + j * 32 + lane;
      const int dj = (int)((dig[j >> 2] >> (8 * (j & 3))) & 255u);
      int slot = NOSLOT;
      if ((inm >> j) & 1u)
        slot = wcnt[warp * ndev + dj] +
               (int)((rank[j >> 1] >> (16 * (j & 1))) & 0xffffu);
      s_slot[i] = (uint16_t)slot;
      s_bin[i] = (uint8_t)dj;
    }
    __syncthreads();
    // (4) column by column: the next column's tile is loaded while this
    // one goes out
    for (int c = 0; c < cols.n_cols; ++c) {
      const int size = cols.size[c];
      const void* src = cols.src[c];
      void* dst = cols.dst[c];
      if (src != nullptr) {
        switch (size) {
          case 1:
            stage_column((const uint8_t*)src, row0, rows, (uint8_t*)s_buf,
                         TS, pre, fetched);
            break;
          case 2:
            stage_column((const uint16_t*)src, row0, rows, (uint16_t*)s_buf,
                         TS, pre, fetched);
            break;
          case 4:
            stage_column((const uint32_t*)src, row0, rows, (uint32_t*)s_buf,
                         TS, pre, fetched);
            break;
          default:
            stage_column((const uint64_t*)src, row0, rows, (uint64_t*)s_buf,
                         TS, pre, fetched);
            break;
        }
      }
      __syncthreads();
      fetched = c + 1 < cols.n_cols &&
                fetch_column(cols.src[c + 1], cols.size[c + 1], row0, rows,
                             pre);
      const bool ones = src == nullptr;
      switch (size) {
        case 1:
          write_column((uint8_t*)dst, (const uint8_t*)s_buf, TS, ndev, ones);
          break;
        case 2:
          write_column((uint16_t*)dst, (const uint16_t*)s_buf, TS, ndev,
                       ones);
          break;
        case 4:
          write_column((uint32_t*)dst, (const uint32_t*)s_buf, TS, ndev,
                       ones);
          break;
        default:
          write_column((uint64_t*)dst, (const uint64_t*)s_buf, TS, ndev,
                       ones);
          break;
      }
      __syncthreads();
    }
  }
}

// the scatter's dynamic shared memory: the staging buffer, the rows'
// slots and targets, the warps' counts
static size_t scatter_smem(int ndev) {
  return (size_t)SBUF_BYTES + (size_t)STILE * (2 + 1) +
         (size_t)SWARPS * ndev * 4;
}

static int64_t ctl_words(int64_t n, int ndev) {
  return CTL_HEAD + (n + STILE - 1) / STILE * ndev;
}

// With counts (a segments call): chunk 0 launches the first scatter,
// which also writes the counts and the flag; chunk j > 0 the scatter of
// the j-th 32 planes, over the first's look-back words (the same epoch).
// With targets_out and no counts: seg_targets alone. The length is read
// from `length` on the device, or taken as `length_value` when that is
// null. `epoch`: 1 .. 2^30 - 1, another for each call on the stream.
extern "C" int segments_launch(
    int64_t n, int n_keys, const int64_t* key_ptrs,
    const int64_t* key_valid_ptrs, const int32_t* key_kinds,
    const void* targets_in, void* targets_out, const void* length,
    int64_t length_value, int ndev, int seg, void* ctl, int64_t ctl_len,
    int64_t epoch, void* counts, void* overflow, int n_cols,
    const int64_t* src_ptrs, const int64_t* dst_ptrs, const int32_t* sizes,
    int chunk, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || ndev < 1 || ndev > MAX_TARGETS ||
      seg < 0 || n_keys < 0 || n_keys > MAX_KEYS || n < 0 ||
      n >= ((int64_t)1 << 31) || chunk < 0 ||
      (targets_in == nullptr && n_keys == 0) ||
      (int64_t)ndev * seg >= ((int64_t)1 << 31) ||
      ctl_len != ctl_words(n, ndev) || epoch < 1 ||
      epoch >= ((int64_t)1 << 30) ||
      (counts == nullptr && (targets_out == nullptr || n_cols > 0)) ||
      (counts != nullptr && overflow == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_cols; ++c)
    if ((sizes[c] != 1 && sizes[c] != 2 && sizes[c] != 4 && sizes[c] != 8) ||
        (src_ptrs[c] == 0 && sizes[c] != 1 && n > 0))
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  int bits = 0;
  while ((1 << bits) < ndev) ++bits;
  Keys K;
  K.n = targets_in != nullptr ? 0 : n_keys;
  for (int j = 0; j < MAX_KEYS; ++j) {
    const bool on = j < K.n;
    K.k[j] = on ? (const void*)key_ptrs[j] : nullptr;
    K.v[j] = on ? (const uint8_t*)key_valid_ptrs[j] : nullptr;
    K.kind[j] = on ? key_kinds[j] : 0;
  }
  if (counts == nullptr) {               // the targets alone
    if (n == 0) return (int)cudaSuccess;
    const int64_t blocks = (n + CT * CR - 1) / (CT * CR);
    const int64_t cap = (int64_t)TBLOCKS * sms;
    seg_targets<<<(unsigned)(blocks < cap ? blocks : cap), CT, 0, s>>>(
        n, K, ndev, (int32_t*)targets_out);
    return (int)cudaGetLastError();
  }
  Cols cols;
  cols.n_cols = n_cols;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < n_cols;
    cols.src[c] = on ? (const void*)src_ptrs[c] : nullptr;
    cols.dst[c] = on ? (void*)dst_ptrs[c] : nullptr;
    cols.size[c] = on ? sizes[c] : 1;
  }
  const size_t smem = scatter_smem(ndev);
  if ((err = cudaFuncSetAttribute(
           seg_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return (int)err;
  const int64_t items = (n + STILE - 1) / STILE +
                        (int64_t)ndev * (seg > ZROWS ? (seg + ZROWS - 1) / ZROWS
                                                     : 1);
  const int64_t cap = (int64_t)SBLOCKS * sms;
  seg_scatter<<<(unsigned)(items < cap ? items : cap), ST, smem, s>>>(
      n, K, (const int32_t*)targets_in, (const int32_t*)length, length_value,
      ndev, bits, seg, (int32_t*)counts, (bool*)overflow,
      (unsigned long long*)ctl, (uint64_t)epoch, chunk == 0, cols);
  return (int)cudaGetLastError();
}
