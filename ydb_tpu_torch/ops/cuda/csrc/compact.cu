// compact — stable compaction of the active rows of a column set.
//
// Replaces ydb_tpu/ops/xla_exec.py:compress (argsort of (dropped, row))
// and compact_env (cumsum rank + dropping scatter into new_cap slots),
// and for the batched serving lane their vmap (K6 xB): B members, each
// with its own mask row and length, over columns that are shared
// (member stride 0) or per member, into row b of (B, new_cap) outputs.
// The single query (K6) is the case B = 1. A row is active when row <
// the member's length and (no mask, or mask[row]).
// Bound on the H100: bytes — each mask byte read once, each column read
// once where active and written once. At the serving lane's point
// lookups that is the 32 masks alone (67 MB, 0.020 ms).
// Design: one launch, reading each mask once. compact_members deals
// (member, tile) blocks of 32,768 rows by ticket, member by member; a
// block loads its tile's mask in 16-byte streaming loads (issued before
// any is used) into row bitmaps, counts them, and takes the member's
// offset by a decoupled look-back over the member's earlier tiles, a
// warp reading 32 of their words at a time. Only a tile with live rows,
// or a member's last tile (it writes live, new_len and overflow), looks
// back; the others publish their count and go. A tile with live rows
// ranks them by a block scan of its threads' counts and writes them in
// row order, so the result is the stable compaction; ranks at or past
// new_cap are dropped. The look-back words carry an epoch that the
// wrapper advances every call, so they are never zeroed, and the ticket
// is reset by the block that draws the last one. Nothing past a
// member's new_len is written: the caller zeroes the outputs where it
// needs a zero tail (compact_env's), and leaves them undefined where it
// does not (the batched lane's compress).
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_COLS 24
#define CM_THREADS 256
#define CM_VECS 8                           // 16-byte mask vectors a thread
#define CM_TILE (CM_THREADS * CM_VECS * 16) // 32,768 rows a tile
#define CM_AGG 1ull                         // look-back flags
#define CM_INCL 2ull
#define CM_EPOCH_SHIFT 34                   // count 0..31, flag 32..33

struct Cols {
  int n_cols;
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];          // bytes per element: 1, 2, 4 or 8
  int64_t stride[MAX_COLS];    // elements between members' rows; 0 = shared
};

__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int size, int64_t from,
                                          int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from]; break;
    case 2: ((uint16_t*)dst)[to] = ((const uint16_t*)src)[from]; break;
    case 4: ((uint32_t*)dst)[to] = ((const uint32_t*)src)[from]; break;
    default: ((uint64_t*)dst)[to] = ((const uint64_t*)src)[from]; break;
  }
}

struct MemberArgs {
  int64_t n;                  // rows per member
  int64_t T;                  // tiles per member
  const int32_t* lengths;     // lengths[b * length_stride]; null: length
  int length_stride;
  int64_t length;
  const uint8_t* mask;        // row b at b * mask_stride; null: every row
  int64_t mask_stride;
  int64_t new_cap;
  unsigned long long* status; // [0] the ticket, then B * T look-back words
  unsigned long long epoch;   // 1 .. 2^30 - 1, new every call
  int32_t* live;
  int32_t* new_len;
  uint8_t* overflow;
  int count_pass;             // 0: a later chunk of columns, same epoch
};

// A 16-byte streaming load: read once, so it skips L1.
__device__ __forceinline__ uint4 load_stream(const uint8_t* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// Rows r0 .. r0 + 15 of a mask row as a 16-bit bitmap (bit i: row r0 +
// i is nonzero). VEC: one 16-byte load (the row start 16-byte aligned and
// n a multiple of 16), else byte loads.
template <bool VEC>
__device__ __forceinline__ unsigned mask_bits(const uint8_t* row,
                                              int64_t r0, int64_t n) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (r0 < n) v = load_stream(row + r0);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (r0 + i < n) w[i >> 2] |= (uint32_t)row[r0 + i] << (8 * (i & 3));
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // each byte to one bit: nonzero bytes become 0x01, then one multiply
  // gathers bits 0, 8, 16 and 24 into bits 21..24
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
  unsigned bm = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t one = __vcmpne4(q[k], 0u) & 0x01010101u;
    bm |= ((one * 0x00204081u) >> 21 & 0xFu) << (4 * k);
  }
  return bm;
}

template <bool VEC>
__global__ void __launch_bounds__(CM_THREADS, 4)
compact_members(MemberArgs a, Cols cols) {
  __shared__ unsigned long long s_ticket;
  __shared__ int s_wsum[CM_THREADS / 32][CM_VECS];
  __shared__ int s_total;
  __shared__ long long s_excl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(a.status, 1ull);
    if (t == gridDim.x - 1ull) atomicExch(a.status, 0ull);  // all drawn
    s_ticket = t;
  }
  __syncthreads();
  const int64_t mb = (int64_t)(s_ticket / (unsigned long long)a.T);
  const int64_t tile = (int64_t)(s_ticket % (unsigned long long)a.T);
  int64_t lim = a.lengths ? a.lengths[mb * a.length_stride] : a.length;
  lim = lim < 0 ? 0 : (lim > a.n ? a.n : lim);
  const uint8_t* row = a.mask ? a.mask + mb * a.mask_stride : nullptr;
  const int64_t base = tile * CM_TILE;
  // the tile's rows: vector j of thread t holds rows base + j * 4096 +
  // 16 t .. + 15; every load is issued before any is counted
  unsigned bm[CM_VECS];
#pragma unroll
  for (int j = 0; j < CM_VECS; ++j) {
    const int64_t r0 = base + (int64_t)j * CM_THREADS * 16 + 16 * threadIdx.x;
    bm[j] = row ? mask_bits<VEC>(row, r0, lim) : 0xFFFFu;
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < CM_VECS; ++j) {
    const int64_t r0 = base + (int64_t)j * CM_THREADS * 16 + 16 * threadIdx.x;
    const int64_t k = lim - r0;
    bm[j] &= k <= 0 ? 0u : (k >= 16 ? 0xFFFFu : (1u << k) - 1u);
    c += __popc(bm[j]);
  }
  const int wc = __reduce_add_sync(0xffffffffu, (unsigned)c);
  if (lane == 0) s_wsum[warp][0] = wc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < CM_THREADS / 32; ++w) t += s_wsum[w][0];
    s_total = t;
  }
  __syncthreads();
  const long long total = s_total;
  volatile unsigned long long* st =
      (volatile unsigned long long*)(a.status + 1 + mb * a.T);
  // only a tile with rows to write, and a member's last tile (its
  // totals), need their offset; the others publish their count and go
  const bool writes = total > 0 && cols.n_cols > 0;
  const bool need = writes || tile == a.T - 1;
  if (warp == 0) {
    long long excl = 0;
    const unsigned long long tag = a.epoch << CM_EPOCH_SHIFT;
    if (!a.count_pass) {
      // a later chunk of columns: the first launch left every tile that
      // writes its inclusive prefix
      if (tile > 0 && writes) {
        const unsigned long long w = st[tile] & 0xFFFFFFFFull;
        excl = (long long)w - total;
      }
    } else if (tile == 0 || !need) {
      if (lane == 0)
        st[tile] = tag | ((tile == 0 ? CM_INCL : CM_AGG) << 32) |
                   (unsigned long long)total;
    } else {
      if (lane == 0)
        st[tile] = tag | (CM_AGG << 32) | (unsigned long long)total;
      // look back over the member's earlier tiles, 32 at a time: sum
      // their published counts up to the nearest inclusive prefix
      for (int64_t i0 = tile - 1; i0 >= 0; i0 -= 32) {
        const int64_t i = i0 - lane;
        unsigned long long w = tag | (CM_INCL << 32);      // before tile 0
        if (i >= 0) {
          unsigned ns = 32;
          for (;;) {
            w = st[i];
            if ((w >> CM_EPOCH_SHIFT) == a.epoch && ((w >> 32) & 3u) != 0)
              break;
            __nanosleep(ns);               // a predecessor still loads
            ns = ns < 1024 ? 2 * ns : ns;
          }
        }
        const unsigned incl =
            __ballot_sync(0xffffffffu, ((w >> 32) & 3u) == CM_INCL);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        unsigned long long x = lane <= stop ? (w & 0xFFFFFFFFull) : 0ull;
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        excl += (long long)__shfl_sync(0xffffffffu, x, 0);
        if (incl) break;
      }
      if (lane == 0)
        st[tile] = tag | (CM_INCL << 32) |
                   (unsigned long long)(excl + total);
    }
    if (lane == 0) {
      s_excl = excl;
      if (a.count_pass && tile == a.T - 1) {
        const long long live = excl + total;
        a.live[mb] = (int32_t)live;
        a.new_len[mb] = (int32_t)(live < a.new_cap ? live : a.new_cap);
        a.overflow[mb] = live > a.new_cap;
      }
    }
  }
  __syncthreads();
  const long long excl = s_excl;
  if (!writes || excl >= a.new_cap) return;
  // rank the live rows, in row order (vector j, then thread, then bit):
  // each vector's counts scanned over the block
  int incl[CM_VECS];
#pragma unroll
  for (int j = 0; j < CM_VECS; ++j) {
    int x = __popc(bm[j]);
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    incl[j] = x;
  }
  __syncthreads();                          // s_wsum's counts are read
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < CM_VECS; ++j) s_wsum[warp][j] = incl[j];
  }
  __syncthreads();
  long long run = excl;
  const int64_t out0 = mb * a.new_cap;
#pragma unroll
  for (int j = 0; j < CM_VECS; ++j) {
    int before = 0, all = 0;
    for (int w = 0; w < CM_THREADS / 32; ++w) {
      const int x = s_wsum[w][j];
      before += w < warp ? x : 0;
      all += x;
    }
    long long rank = run + before + incl[j] - __popc(bm[j]);
    run += all;
    const int64_t r0 = base + (int64_t)j * CM_THREADS * 16 + 16 * threadIdx.x;
    for (unsigned m = bm[j]; m != 0u && rank < a.new_cap; m &= m - 1u) {
      const int64_t r = r0 + __ffs(m) - 1;
      for (int k = 0; k < cols.n_cols; ++k)
        copy_elem(cols.src[k], cols.dst[k], cols.size[k],
                  r + mb * cols.stride[k], out0 + rank);
      ++rank;
    }
  }
}

// B members (B = 1: the single query): lengths (B,) int32
// (length_stride 1), one shared length on the device (0), or null for
// `length` itself; mask rows mask_stride bytes apart (0 = one shared
// mask, or null); column c's member rows src_strides[c] elements apart
// (0 = shared); outputs (B, new_cap), written only below each member's
// new_len; live, new_len and overflow (B,). `status` holds 1 + B * T
// words (T = the tiles of CM_TILE rows a member, at least 1), kept per
// stream: zeroed once, then left for the next call, whose `epoch` must
// differ. Columns past MAX_COLS go to later calls with count_pass 0 and
// the same epoch, on the same stream.
extern "C" int compact_launch(
    int64_t n, int B, const void* lengths, int length_stride, int64_t length,
    const void* mask, int64_t mask_stride, int64_t new_cap, void* status,
    int64_t epoch, void* live, void* new_len, void* overflow, int n_cols,
    const int64_t* src_ptrs, const int64_t* src_strides,
    const int64_t* dst_ptrs, const int32_t* sizes, int count_pass,
    void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || B < 1 || n < 0 ||
      n >= ((int64_t)1 << 31) || epoch < 1 || epoch >= ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  MemberArgs a;
  a.n = n;
  a.T = n > 0 ? (n + CM_TILE - 1) / CM_TILE : 1;
  a.lengths = (const int32_t*)lengths;
  a.length_stride = length_stride;
  a.length = length;
  a.mask = (const uint8_t*)mask;
  a.mask_stride = mask_stride;
  a.new_cap = new_cap;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch;
  a.live = (int32_t*)live;
  a.new_len = (int32_t*)new_len;
  a.overflow = (uint8_t*)overflow;
  a.count_pass = count_pass;
  Cols cols;
  cols.n_cols = n_cols;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < n_cols;
    cols.src[c] = on ? (const void*)src_ptrs[c] : nullptr;
    cols.dst[c] = on ? (void*)dst_ptrs[c] : nullptr;
    cols.size[c] = on ? sizes[c] : 8;
    cols.stride[c] = on && src_strides ? src_strides[c] : 0;
  }
  const bool vec = mask == nullptr ||
                   ((uintptr_t)mask % 16 == 0 && mask_stride % 16 == 0 &&
                    n % 16 == 0);
  const unsigned blocks = (unsigned)(B * a.T);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    compact_members<true><<<blocks, CM_THREADS, 0, s>>>(a, cols);
  else
    compact_members<false><<<blocks, CM_THREADS, 0, s>>>(a, cols);
  return (int)cudaGetLastError();
}
