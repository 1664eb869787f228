// partition — a stable counting sort of rows by hash partition.
//
// Replaces ydb_tpu/ops/spill.py:_partition_sort's partition ids, counts
// and lax.sort([pkey, iota]) + gathers (the spill feed of the merge
// budget), and the GraceJoin probe routing of
// ydb_tpu/query/executor.py:_partition_block, which compresses the block
// once per partition. Row r < *length goes to partition h[r] % nparts
// (nparts a power of two: the digit h & (nparts - 1)); every column is
// moved to (partition, row) order, rows past the length last and in
// order, in a buffer of out_rows rows whose rows past n are zero. Within
// a partition rows keep their order, so the result equals the
// reference's sort by (pkey, iota), and each partition is one contiguous
// range. The ids (int32, nparts past the length) are written only when
// the caller asks for them.
// Bound on the H100: bytes. Each hash is read once, each column read
// once and written once, the zero tail written once; the control words
// are (nparts x 8) bytes a 4,096-row tile.
// Design: two launches, with no host sync (the length stays on the
// device). (1) part_census reads the hashes in 16-byte strips and counts
// the live rows' digits in shared memory: the lanes of a warp that share
// a digit are found by ballots on its log2(nparts) bits and add once;
// the block's counts go to nparts global counters by integer atomics
// (exact in any order), and the last block by ticket scans them into
// each bin's first output row and writes the counts. (2) part_scatter
// takes 4,096-row tiles by ticket. A tile's live rows are ranked stably
// in shared memory: each warp walks 512 consecutive rows 32 at a time,
// ballots give each row its rank among the warp's rows of its digit, a
// scan over the bins gives each row its slot in the tile (bins in order,
// rows in order), and each bin's first output row is the census base
// plus a decoupled look-back over the earlier tiles' counts of the bin
// (integers: the result does not depend on timing), reading 8 earlier
// tiles' words a round. Then, column by column, the tile is read with
// 16-byte loads into shared memory at the rows' slots and written out as
// one contiguous run per bin; a column's loads are issued into registers
// while the previous column goes out (the first column's while the tile
// is ranked), so a tile waits on memory once, not once a column. Rows
// past the length are not binned: they form the suffix [len, n), copied
// in place by the same loads. The zero tail [n, out_rows) is written by
// the same launch, by the items after the tiles. Up to 32 columns move
// in a launch; a further launch moves 32 more, taking each tile's bases
// from the first launch's look-back words.
#include <cuda_runtime.h>
#include <stdint.h>

#define PT 256                  // threads of the scatter
#define PWARPS (PT / 32)
#define PI 16                   // rows a thread of a tile
#define WROWS (32 * PI)         // rows a warp of a tile: 512
#define PTILE (PT * PI)         // rows a tile: 4,096
#define MAX_BINS 256
#define MAX_COLS 32
#define CT 256                  // threads of the census
#define CU 2                    // 16-byte strips a census lane loads at once
#define CBLOCKS 16              // census blocks an SM
#define SBLOCKS 2               // scatter blocks an SM
#define FULL 0xffffffffu

// look-back words: the flags, then the count
#define LB_WALK 8               // earlier tiles' words read at once
#define LB_AGG (1ull << 32)
#define LB_PRE (1ull << 33)
#define LB_VALUE 0xffffffffull

struct Cols {
  int n_cols;
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];          // bytes per element: 1, 2, 4 or 8
};

__device__ __forceinline__ uint64_t load_lb(const uint64_t* p) {
  return *(const volatile uint64_t*)p;
}

__device__ __forceinline__ void store_lb(uint64_t* p, uint64_t v) {
  *(volatile uint64_t*)p = v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

__device__ __forceinline__ int64_t live_length(const int32_t* length,
                                               int64_t n) {
  const int64_t len = (int64_t)*length;
  return len < 0 ? 0 : (len > n ? n : len);
}

// The lanes of the warp whose digit equals this lane's, among `in` lanes:
// one ballot a bit of the digit.
__device__ __forceinline__ unsigned digit_peers(bool in, int d, int bits) {
  unsigned peers = __ballot_sync(FULL, in);
  for (int b = 0; b < bits; ++b) {
    const bool on = (d >> b) & 1;
    const unsigned m = __ballot_sync(FULL, on);
    peers &= on ? m : ~m;
  }
  return peers;
}

// The rows of bin b in tiles 0 .. t - 1: the earlier tiles' words back
// to the nearest inclusive prefix, LB_WALK words a round loaded at once
// (a tile's word is its count once published, its inclusive prefix once
// its own walk ends; tile 0 publishes its prefix at once).
__device__ __forceinline__ int64_t look_back(const uint64_t* status,
                                             int nparts, int b, int64_t t) {
  int64_t sum = 0;
  for (int64_t j = t - 1;;) {
    uint64_t w[LB_WALK];
#pragma unroll
    for (int k = 0; k < LB_WALK; ++k)
      w[k] = j - k >= 0 ? load_lb(status + (j - k) * nparts + b) : LB_PRE;
#pragma unroll
    for (int k = 0; k < LB_WALK; ++k) {
      if ((w[k] & (LB_AGG | LB_PRE)) == 0) break;   // not out yet: again
      sum += (int64_t)(w[k] & LB_VALUE);
      --j;
      if (w[k] & LB_PRE) return sum;
    }
  }
}

// Exclusive scan of v over a 256-thread block (wsum: 8 ints of shared
// memory).
__device__ __forceinline__ int block_excl_256(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < PWARPS; ++w)
    if (w < warp) before += wsum[w];
  __syncthreads();
  return before + x - v;
}

// ---------------------------------------------------------------- census

__global__ void __launch_bounds__(CT)
part_census(int64_t n, const uint64_t* h, const int32_t* length, int nparts,
            int bits, unsigned long long* census, int64_t* base,
            unsigned* done, int64_t* counts) {
  __shared__ int hist[MAX_BINS];
  __shared__ int s_wsum[PWARPS];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int b = threadIdx.x; b < nparts; b += CT) hist[b] = 0;
  __syncthreads();
  const int64_t len = live_length(length, n);
  const uint64_t mask = (uint64_t)(nparts - 1);
  const bool vec = aligned16(h);
  const int64_t stride = (int64_t)gridDim.x * CT * CU * 2;
  for (int64_t c0 = ((int64_t)blockIdx.x * (CT / 32) + warp) * 64 * CU;
       c0 < len; c0 += stride) {
    uint64_t v[CU][2];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int64_t r = c0 + u * 64 + 2 * lane;
      if (vec && r + 1 < n) {
        const ulonglong2 x = *(const ulonglong2*)(h + r);
        v[u][0] = x.x;
        v[u][1] = x.y;
      } else {
        v[u][0] = r < n ? h[r] : 0;
        v[u][1] = r + 1 < n ? h[r + 1] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool in = c0 + u * 64 + 2 * lane + k < len;
        const int d = (int)(v[u][k] & mask);
        const unsigned peers = digit_peers(in, d, bits);
        if (in && (peers & below) == 0) atomicAdd(&hist[d], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nparts; b += CT)
    if (hist[b]) atomicAdd(&census[b], (unsigned long long)hist[b]);
  // the last block to finish scans the census
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int b = threadIdx.x;
  const int c = b < nparts
      ? (int)*(const volatile unsigned long long*)(census + b) : 0;
  const int excl = block_excl_256(c, s_wsum);
  if (b < nparts) {
    base[b] = excl;
    counts[b] = c;
  }
}

// ---------------------------------------------------------------- scatter

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

// One 16-byte vector q of a column's tile: its live rows to shared memory
// at their slots, the rest (rows past the length) in place.
template <typename U>
__device__ __forceinline__ void place_vec(uint4 x, int q, int live, U* sb,
                                          U* dp, bool dvec,
                                          const uint16_t* s_slot) {
  constexpr int V = 16 / sizeof(U);
  if (dvec && q * V >= live) {
    *(uint4*)(dp + q * V) = x;
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int i = q * V + e;
    const U val = vec_elem<U>(x, e);
    if (i < live) sb[s_slot[i]] = val;
    else dp[i] = val;
  }
}

// A column's tile of a full tile over an aligned view into registers,
// 16 bytes a load (size loads a thread); false for any other tile.
__device__ __forceinline__ bool fetch_column(const void* src, int size,
                                             int64_t row0, int rows,
                                             uint4 (&pre)[8]) {
  const uint4* sp = (const uint4*)((const char*)src + row0 * size);
  if (rows != PTILE || !aligned16(sp)) return false;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < size) pre[k] = sp[threadIdx.x + k * PT];
  return true;
}

// One column of tile rows [row0, row0 + rows): the live rows [0, live)
// into shared memory at their slots, the rest (rows past the length) in
// place; from the fetched vectors when `fetched`.
template <typename U>
__device__ __forceinline__ void place_column(const U* src, U* dst,
                                             int64_t row0, int rows,
                                             int live, U* sb,
                                             const uint16_t* s_slot,
                                             const uint4 (&pre)[8],
                                             bool fetched) {
  constexpr int V = 16 / sizeof(U);
  const U* sp = src + row0;
  U* dp = dst + row0;
  const bool dvec = aligned16(dp);
  if (fetched) {
#pragma unroll
    for (int k = 0; k < (int)sizeof(U); ++k)
      place_vec<U>(pre[k], threadIdx.x + k * PT, live, sb, dp, dvec, s_slot);
    return;
  }
  int done = 0;
  if (aligned16(sp)) {
    const int nv = rows / V;
    for (int q = threadIdx.x; q < nv; q += PT)
      place_vec<U>(*(const uint4*)(sp + q * V), q, live, sb, dp, dvec,
                   s_slot);
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < rows; i += PT) {
    const U val = sp[i];
    if (i < live) sb[s_slot[i]] = val;
    else dp[i] = val;
  }
}

// The live rows out of shared memory: one contiguous run a bin.
template <typename U>
__device__ __forceinline__ void write_column(U* dst, int live, const U* sb,
                                             const uint8_t* s_dig,
                                             const int64_t* s_off) {
  for (int i = threadIdx.x; i < live; i += PT)
    dst[s_off[s_dig[i]] + i] = sb[i];
}

template <typename U>
__device__ __forceinline__ void zero_rows(U* dst, int64_t r0, int rows) {
  for (int i = threadIdx.x; i < rows; i += PT) dst[r0 + i] = (U)0;
}

// Items by ticket: tiles 0 .. T - 1, then the zero tail's chunks.
// `first`: the launch that ranks with the look-back (and writes the ids
// when `ids` is not null); a later launch reads each tile's bases from
// the look-back words that launch left.
__global__ void __launch_bounds__(PT, SBLOCKS)
part_scatter(int64_t n, int64_t out_rows, const uint64_t* h,
             const int32_t* length, int nparts, int bits,
             const int64_t* base, uint64_t* status, unsigned* ticket,
             int first, int32_t* ids, Cols cols) {
  extern __shared__ unsigned long long part_smem[];
  unsigned long long* s_buf = part_smem;                   // PTILE
  uint16_t* s_slot = (uint16_t*)(s_buf + PTILE);           // PTILE
  uint8_t* s_dig = (uint8_t*)(s_slot + PTILE);             // PTILE
  int* wcnt = (int*)(s_dig + PTILE);                       // PWARPS x nparts
  __shared__ int64_t s_off[MAX_BINS];
  __shared__ int s_wsum[PWARPS];
  __shared__ int64_t s_item;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = threadIdx.x;                               // this thread's bin
  const unsigned below = (1u << lane) - 1u;
  const int64_t len = live_length(length, n);
  const uint64_t mask = (uint64_t)(nparts - 1);
  const int64_t T = (n + PTILE - 1) / PTILE;
  const int64_t Z = (out_rows - n + PTILE - 1) / PTILE;
  for (;;) {
    __syncthreads();                   // the previous item is out
    if (threadIdx.x == 0) s_item = atomicAdd(ticket, 1u);
    __syncthreads();
    const int64_t item = s_item;
    if (item >= T + Z) return;
    if (item >= T) {                   // a chunk of the zero tail
      const int64_t r0 = n + (item - T) * PTILE;
      const int rows = (int)(out_rows - r0 < PTILE ? out_rows - r0 : PTILE);
      for (int c = 0; c < cols.n_cols; ++c) {
        switch (cols.size[c]) {
          case 1: zero_rows((uint8_t*)cols.dst[c], r0, rows); break;
          case 2: zero_rows((uint16_t*)cols.dst[c], r0, rows); break;
          case 4: zero_rows((uint32_t*)cols.dst[c], r0, rows); break;
          default: zero_rows((uint64_t*)cols.dst[c], r0, rows); break;
        }
      }
      continue;
    }
    const int64_t t = item, row0 = t * PTILE;
    const int rows = (int)(n - row0 < PTILE ? n - row0 : PTILE);
    // one partition, or no live row in the tile: nothing to rank
    const int live = nparts == 1 ? 0
        : (int)(len - row0 <= 0 ? 0 : (len - row0 < rows ? len - row0 : rows));
    // the first column's tile, loading while the tile is ranked
    uint4 pre[8];
    bool fetched = cols.n_cols > 0 &&
                   fetch_column(cols.src[0], cols.size[0], row0, rows, pre);
    if (live > 0) {
      // (1) each row's rank among its warp's earlier rows of its digit
      for (int i = threadIdx.x; i < PWARPS * nparts; i += PT) wcnt[i] = 0;
      __syncthreads();
      const int w0 = warp * WROWS;
      uint64_t hv[PI];
#pragma unroll
      for (int j = 0; j < PI; ++j) {
        const int i = w0 + j * 32 + lane;
        hv[j] = i < live ? h[row0 + i] : 0;
      }
      unsigned dig[PI / 4];            // four 8-bit digits an int
      unsigned rank[PI / 2];           // two 16-bit ranks (< WROWS) an int
#pragma unroll
      for (int j = 0; j < PI; ++j) {
        const bool in = w0 + j * 32 + lane < live;
        const int d = (int)(hv[j] & mask);
        const unsigned peers = digit_peers(in, d, bits);
        const unsigned r =
            in ? wcnt[warp * nparts + d] + __popc(peers & below) : 0;
        if (j & 3) dig[j >> 2] |= (unsigned)d << (8 * (j & 3));
        else dig[j >> 2] = (unsigned)d;
        if (j & 1) rank[j >> 1] |= r << 16;
        else rank[j >> 1] = r;
        __syncwarp();
        if (in && (peers & below) == 0)
          wcnt[warp * nparts + d] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      // (2) bin b: the tile's count, each warp's first rank in the bin,
      // the rows of the bin in earlier tiles (the look-back)
      int tc = 0;
      int64_t before = 0;
      if (b < nparts) {
        for (int w = 0; w < PWARPS; ++w) {
          const int c = wcnt[w * nparts + b];
          wcnt[w * nparts + b] = tc;
          tc += c;
        }
        uint64_t* mine = status + t * nparts + b;
        if (!first) {
          before = t ? (int64_t)(status[(t - 1) * nparts + b] & LB_VALUE) : 0;
        } else if (t == 0) {
          store_lb(mine, LB_PRE | (uint64_t)tc);
        } else {
          store_lb(mine, LB_AGG | (uint64_t)tc);
          before = look_back(status, nparts, b, t);
          store_lb(mine, LB_PRE | (uint64_t)(before + tc));
        }
      }
      const int ls = block_excl_256(tc, s_wsum);
      if (b < nparts) {
        s_off[b] = base[b] + before - ls;
        for (int w = 0; w < PWARPS; ++w) wcnt[w * nparts + b] += ls;
      }
      __syncthreads();
      // (3) every live row's slot in the tile: bins in order, rows in
      // order; the slot's bin
#pragma unroll
      for (int j = 0; j < PI; ++j) {
        const int i = w0 + j * 32 + lane;
        if (i < live) {
          const int d = (int)((dig[j >> 2] >> (8 * (j & 3))) & 255u);
          const int slot = wcnt[warp * nparts + d] +
                           (int)((rank[j >> 1] >> (16 * (j & 1))) & 0xffffu);
          s_slot[i] = (uint16_t)slot;
          s_dig[slot] = (uint8_t)d;
          if (ids != nullptr) ids[row0 + i] = d;
        }
      }
    }
    if (ids != nullptr)
      for (int i = live + threadIdx.x; i < rows; i += PT)
        ids[row0 + i] = row0 + i < len ? 0 : nparts;
    __syncthreads();
    // (4) column by column: the next column's tile is loaded while this
    // one goes out
    for (int c = 0; c < cols.n_cols; ++c) {
      const int size = cols.size[c];
      const void* src = cols.src[c];
      void* dst = cols.dst[c];
      switch (size) {
        case 1:
          place_column((const uint8_t*)src, (uint8_t*)dst, row0, rows, live,
                       (uint8_t*)s_buf, s_slot, pre, fetched);
          break;
        case 2:
          place_column((const uint16_t*)src, (uint16_t*)dst, row0, rows,
                       live, (uint16_t*)s_buf, s_slot, pre, fetched);
          break;
        case 4:
          place_column((const uint32_t*)src, (uint32_t*)dst, row0, rows,
                       live, (uint32_t*)s_buf, s_slot, pre, fetched);
          break;
        default:
          place_column((const uint64_t*)src, (uint64_t*)dst, row0, rows,
                       live, (uint64_t*)s_buf, s_slot, pre, fetched);
          break;
      }
      __syncthreads();
      fetched = c + 1 < cols.n_cols &&
                fetch_column(cols.src[c + 1], cols.size[c + 1], row0, rows,
                             pre);
      switch (size) {
        case 1:
          write_column((uint8_t*)dst, live, (const uint8_t*)s_buf, s_dig,
                       s_off);
          break;
        case 2:
          write_column((uint16_t*)dst, live, (const uint16_t*)s_buf, s_dig,
                       s_off);
          break;
        case 4:
          write_column((uint32_t*)dst, live, (const uint32_t*)s_buf, s_dig,
                       s_off);
          break;
        default:
          write_column((uint64_t*)dst, live, (const uint64_t*)s_buf, s_dig,
                       s_off);
          break;
      }
      __syncthreads();
    }
  }
}

// the scatter's dynamic shared memory: the staged column, the rows'
// slots, the slots' bins and the warps' counts
static size_t scatter_smem(int nparts) {
  return (size_t)PTILE * (8 + 2 + 1) + (size_t)PWARPS * nparts * 4;
}

// The control words (uint64, zeroed by the caller): the look-back words
// (T x nparts), the census (nparts), the bins' bases (nparts), the
// census's done counter, and a ticket counter per launch of the scatter.
static int64_t ctl_words(int64_t T, int nparts, int chunks) {
  return T * nparts + 2 * (int64_t)nparts + 1 + chunks;
}

// chunk 0 launches the census and the first scatter (which writes the
// ids when `ids` is not null); chunk j > 0 launches the scatter of the
// j-th 32 columns alone.
extern "C" int partition_launch(int64_t n, const void* hashes,
                                const void* length, int nparts, void* ids,
                                void* counts, void* ctl, int64_t ctl_len,
                                int chunks, int chunk, int64_t out_rows,
                                int n_cols, const int64_t* src_ptrs,
                                const int64_t* dst_ptrs,
                                const int32_t* sizes, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || nparts < 1 || nparts > MAX_BINS ||
      (nparts & (nparts - 1)) || n < 1 || n >= ((int64_t)1 << 31) ||
      out_rows < n || chunks < 1 ||
      chunk < 0 || chunk >= chunks)
    return (int)cudaErrorInvalidValue;
  const int64_t T = (n + PTILE - 1) / PTILE;
  if (ctl_len != ctl_words(T, nparts, chunks))
    return (int)cudaErrorInvalidValue;
  int bits = 0;
  while ((1 << bits) < nparts) ++bits;
  uint64_t* status = (uint64_t*)ctl;
  unsigned long long* census = (unsigned long long*)(status + T * nparts);
  int64_t* base = (int64_t*)(census + nparts);
  unsigned* done = (unsigned*)(base + nparts);
  uint64_t* tickets = status + T * nparts + 2 * nparts + 1;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if (chunk == 0) {
    const int64_t cb = (n + CT * CU * 2 - 1) / (CT * CU * 2);
    const int64_t cgrid = cb < (int64_t)CBLOCKS * sms ? cb
                                                      : (int64_t)CBLOCKS * sms;
    part_census<<<(unsigned)cgrid, CT, 0, s>>>(
        n, (const uint64_t*)hashes, (const int32_t*)length, nparts, bits,
        census, base, done, (int64_t*)counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  Cols cols;
  cols.n_cols = n_cols;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < n_cols;
    cols.src[c] = on ? (const void*)src_ptrs[c] : nullptr;
    cols.dst[c] = on ? (void*)dst_ptrs[c] : nullptr;
    cols.size[c] = on ? sizes[c] : 8;
  }
  const size_t smem = scatter_smem(nparts);
  if ((err = cudaFuncSetAttribute(
           part_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return (int)err;
  const int64_t items = T + (out_rows - n + PTILE - 1) / PTILE;
  const int64_t grid = items < (int64_t)SBLOCKS * sms ? items
                                                      : (int64_t)SBLOCKS * sms;
  part_scatter<<<(unsigned)grid, PT, smem, s>>>(
      n, out_rows, (const uint64_t*)hashes, (const int32_t*)length, nparts,
      bits, base, status, (unsigned*)(tickets + chunk), chunk == 0,
      chunk == 0 ? (int32_t*)ids : nullptr, cols);
  return (int)cudaGetLastError();
}
