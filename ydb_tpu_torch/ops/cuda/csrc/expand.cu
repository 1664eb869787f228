// expand — the expanding (duplicate-key) join probe.
//
// Replaces ydb_tpu/ops/join.py:_expand_counts and _expand_gather, which
// probe_expand runs on the portioned path when a build side holds a key
// more than once.
// expand_counts: per probe row r < length, the lower and upper bound of
// its key in the power-of-two padded sorted build keys (the reference's
// searchsorted left / right; keys of the same dtype, int64 or float64,
// padded with INT64_MAX or +inf), both clipped to n_build so the padding
// never matches; mcounts = hi - lo for a matchable row (active, key not
// NULL), else 0; counts = max(mcounts, 1) for an active row of a LEFT
// join, mcounts otherwise; and the exclusive prefix of the counts
// (offsets) with their total.
// expand_gather: per output slot j < out_cap, its probe row (the last
// row whose offset is <= j), its match k = j - offsets[row], its build
// row lo[row] + k (clipped to the payload capacity), and whether it is a
// match (mcounts[row] > 0 and j < total; a null-extended LEFT row is
// not); then every column in one pass: probe columns at the probe row,
// payload columns at the build row, payload validity as the match flag
// and the payload's own validity.
// Bound on the H100: bytes. counts reads each probe key and validity
// once and writes 16 bytes per row; the build keys (50,000 at most on
// the TPC-DS paths) stay in L2. gather writes every output column once
// and reads the probe and build columns through the row maps (gathers
// from L2-resident builds; the probe columns are read in order, one
// probe row feeding its matches' consecutive slots).
// Design of expand_counts: one launch over a persistent grid. A block
// first stages the sorted build keys in shared memory — all of them
// where they fit (kcap <= EX_STAGE, 64 KB), else every (kcap /
// EX_LEVELS)-th, the upper 11 levels of the binary search — so a search
// touches global memory only below them. It then draws tiles of EX_TILE
// probe rows by ticket, in order: each thread searches its EX_ROWS rows'
// lower bounds side by side (their loads in flight together), finds
// each upper bound by galloping from the lower one over the run of equal
// keys (one load for a key with no match, a few for a short run, the
// full search past EX_GALLOP steps), ranks the rows' counts by a block
// scan and takes the tile's offset by a decoupled look-back in which
// every thread reads one earlier tile's word, 256 a round; the last tile
// writes the total.
// The look-back words carry an epoch that the wrapper advances every
// call, so they are never cleared, and the block that draws the last
// ticket resets it.
// Design of expand_gather: the skew hazard — one key matching 100,000
// build rows — is met by giving each OUTPUT slot a thread, which
// binary-searches the offsets (L2-resident) for its probe row, so a hot
// key spreads over as many threads as it has matches; a thread per probe
// row would serialize it.
#include <cuda_runtime.h>
#include <stdint.h>

#define EX_THREADS 256
#define EX_ROWS 8                            // probe rows a thread
#define EX_TILE (EX_THREADS * EX_ROWS)       // 2,048 rows a tile
#define EX_STAGE 8192                        // build keys staged whole
#define EX_LEVELS 2048                       // else staged levels
#define EX_GRID 264                          // most blocks: 2 a SM
#define EX_GALLOP 4                          // gallop steps: runs of 15
#define EX_AGG 1ull                          // look-back flags
#define EX_INCL 2ull
#define MAX_COLS 32

enum { M_PROBE = 0, M_BUILD = 1, M_BUILD_VALID = 2 };

struct Search {
  const void* keys;          // kcap sorted keys, a power of two
  int64_t kcap;
  int64_t W;                 // kcap / staged keys: staged key i is
  int wshift;                // keys[(i + 1) * W - 1]; W = 1 << wshift
};

// A thread's EX_ROWS binary searches side by side: the first position
// in [0, kcap] whose key is not < e (UPPER: not <= e). The levels of step
// >= W come from the staged keys, the rest from global memory — the
// same comparisons, in the same order, as a plain binary search over
// keys[pos + step - 1] and then keys[pos].
template <typename T, bool UPPER>
__device__ __forceinline__ void bounds(const Search& S, const T* sk,
                                       const T* e, int64_t* pos) {
  const T* keys = (const T*)S.keys;
#pragma unroll
  for (int u = 0; u < EX_ROWS; ++u) pos[u] = 0;
  int64_t step = S.kcap >> 1;
  for (; step >= S.W && step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      const T kv = sk[((pos[u] + step) >> S.wshift) - 1];
      if (UPPER ? kv <= e[u] : kv < e[u]) pos[u] += step;
    }
  }
  for (; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      const T kv = __ldg(keys + pos[u] + step - 1);
      if (UPPER ? kv <= e[u] : kv < e[u]) pos[u] += step;
    }
  }
#pragma unroll
  for (int u = 0; u < EX_ROWS; ++u) {
    const T kv = S.W == 1 ? sk[pos[u]] : __ldg(keys + pos[u]);
    if (UPPER ? kv <= e[u] : kv < e[u]) ++pos[u];
  }
}

// The upper bounds from the lower ones (`want`: the rows that need one;
// the others keep hi = lo). A row whose key at lo is > e — no match, most
// rows — ends after that one load; the others gallop from lo over their
// run (steps 1, 2, 4 and 8, the rows side by side), then search inside
// the last step; a run longer than EX_GALLOP steps reach takes the full
// search. The upper bound of e wherever the keys are sorted.
template <typename T>
__device__ __forceinline__ void upper_bounds(const Search& S, const T* sk,
                                             const T* e, const bool* want,
                                             const int64_t* lo,
                                             int64_t* hi) {
  const T* keys = (const T*)S.keys;
  auto at = [&](int64_t i) -> T {
    return S.W == 1 ? sk[i] : __ldg(keys + i);
  };
  // a row's bracket (lo + da, lo + db]: key lo + da <= e, and key lo + db
  // > e or lo + db = kcap; db = 0 while it gallops or has no match
  int da[EX_ROWS], db[EX_ROWS];
  bool open[EX_ROWS];
  T kv[EX_ROWS];
#pragma unroll
  for (int u = 0; u < EX_ROWS; ++u) {
    hi[u] = lo[u];
    da[u] = db[u] = 0;
    open[u] = want[u] && lo[u] < S.kcap;
    kv[u] = open[u] ? at(lo[u]) : T(0);
  }
#pragma unroll
  for (int u = 0; u < EX_ROWS; ++u)
    if (open[u] && !(kv[u] <= e[u])) open[u] = false;
#pragma unroll
  for (int g = 0; g < EX_GALLOP; ++g) {
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      const int64_t nx = lo[u] + da[u] + (1 << g);
      kv[u] = open[u] && nx < S.kcap ? at(nx) : T(0);
    }
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      if (!open[u]) continue;
      const int64_t nx = lo[u] + da[u] + (1 << g);
      if (nx < S.kcap && kv[u] <= e[u]) {
        da[u] += 1 << g;
      } else {
        db[u] = (int)((nx < S.kcap ? nx : S.kcap) - lo[u]);
        open[u] = false;
      }
    }
  }
  bool longer = false;
#pragma unroll
  for (int u = 0; u < EX_ROWS; ++u) longer |= open[u];
  if (longer) {                          // a run past the gallop's reach
    int64_t full[EX_ROWS];
    bounds<T, true>(S, sk, e, full);
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u)
      if (open[u]) hi[u] = full[u];
  }
  for (;;) {
    bool more = false;
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) more |= db[u] - da[u] > 1;
    if (!more) break;
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u)
      kv[u] = db[u] - da[u] > 1 ? at(lo[u] + ((da[u] + db[u]) >> 1)) : T(0);
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      if (db[u] - da[u] <= 1) continue;
      const int mid = (da[u] + db[u]) >> 1;
      if (kv[u] <= e[u]) da[u] = mid;
      else db[u] = mid;
    }
  }
#pragma unroll
  for (int u = 0; u < EX_ROWS; ++u)
    if (db[u] > 0) hi[u] = lo[u] + db[u];
}

// The look-back words: a tile's sum or prefix is stored, then its flag
// word with release semantics; a reader acquires the flag word, then
// reads the value it names.
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

struct Counts {
  int64_t n;
  const void* key;
  const uint8_t* kvalid;
  const int32_t* length;
  int64_t n_build;
  int left;
  int32_t* lo;
  int32_t* mcounts;
  int64_t* offsets;
  int64_t* total;
  int64_t T;                             // tiles
  unsigned long long* status;            // [0] ticket, then T flag words
  int64_t* agg;                          // T tile sums
  int64_t* incl;                         // T inclusive prefixes
  unsigned long long epoch;              // 1 .. 2^62 - 1, new every call
};

// A ticket; the block that draws the last one (each block draws until
// it passes the last tile) resets the word for the next launch.
__device__ __forceinline__ int64_t draw(const Counts& C) {
  const unsigned long long t = atomicAdd(C.status, 1ull);
  if (t == (unsigned long long)(C.T + gridDim.x - 1)) C.status[0] = 0;
  return (int64_t)t;
}

template <typename T>
__global__ void __launch_bounds__(EX_THREADS, 2)
ex_counts(Search S, Counts C) {
  extern __shared__ unsigned long long ex_smem[];
  T* sk = (T*)ex_smem;                           // staged keys
  __shared__ int64_t s_wsum[EX_ROWS][EX_THREADS / 32];
  __shared__ int64_t s_base[EX_ROWS * (EX_THREADS / 32)];
  __shared__ int64_t s_red[EX_THREADS / 32];
  __shared__ unsigned s_inc[EX_THREADS / 32];
  __shared__ int64_t s_total;
  __shared__ int64_t s_tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t staged = S.kcap / S.W;
  const T* keys = (const T*)S.keys;
  for (int64_t i = threadIdx.x; i < staged; i += EX_THREADS)
    sk[i] = __ldg(keys + (i + 1) * S.W - 1);
  const int64_t length = *C.length;
  unsigned long long* st = C.status + 1;
  const unsigned long long tag = C.epoch << 2;
  if (threadIdx.x == 0) s_tile = draw(C);
  for (;;) {
    __syncthreads();                       // staged keys; the tile drawn
    const int64_t tile = s_tile;
    if (tile >= C.T) return;
    // the next tile is drawn now, its ticket's round trip under this
    // tile's work (a block's tiles still come in ticket order)
    int64_t next = 0;
    if (threadIdx.x == 0) next = draw(C);
    // rows tile * EX_TILE + u * EX_THREADS + threadIdx.x, u < EX_ROWS
    const int64_t r0 = tile * EX_TILE + threadIdx.x;
    T e[EX_ROWS];
    bool in[EX_ROWS], act[EX_ROWS], want[EX_ROWS];
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      const int64_t r = r0 + (int64_t)u * EX_THREADS;
      in[u] = r < C.n;
      act[u] = in[u] && r < length;
      e[u] = in[u] ? __ldg((const T*)C.key + r) : T(0);
      want[u] = act[u] && (C.kvalid == nullptr || __ldg(C.kvalid + r) != 0);
    }
    int64_t lo[EX_ROWS], hi[EX_ROWS];
    bounds<T, false>(S, sk, e, lo);
    upper_bounds<T>(S, sk, e, want, lo, hi);
    int64_t c[EX_ROWS];
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      const int64_t r = r0 + (int64_t)u * EX_THREADS;
      const int64_t l = lo[u] < C.n_build ? lo[u] : C.n_build;
      const int64_t m =
          want[u] ? (hi[u] < C.n_build ? hi[u] : C.n_build) - l : 0;
      c[u] = C.left ? (act[u] ? (m > 1 ? m : 1) : 0) : m;
      if (in[u]) {
        C.lo[r] = (int32_t)l;
        C.mcounts[r] = (int32_t)m;
      }
    }
    // the tile's exclusive prefix in row order (u, then thread): a warp
    // scan of each u, then the (u, warp) totals scanned by warp 0
    int64_t x[EX_ROWS];
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      int64_t v = c[u];
      for (int off = 1; off < 32; off <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += y;
      }
      x[u] = v - c[u];                       // exclusive within the warp
      if (lane == 31) s_wsum[u][warp] = v;
    }
    __syncthreads();
    if (warp == 0) {
      // 64 (u, warp) totals in row order, two a lane
      const int64_t a0 = s_wsum[(2 * lane) / 8][(2 * lane) % 8];
      const int64_t a1 = s_wsum[(2 * lane + 1) / 8][(2 * lane + 1) % 8];
      int64_t v = a0 + a1;
      for (int off = 1; off < 32; off <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += y;
      }
      s_base[2 * lane] = v - a0 - a1;
      s_base[2 * lane + 1] = v - a1;
      if (lane == 31) {
        // publish the tile's sum (tile 0: its inclusive prefix)
        s_total = v;
        if (tile == 0) {
          C.incl[0] = v;
          st_release(st, tag | EX_INCL);
        } else {
          C.agg[tile] = v;
          st_release(st + tile, tag | EX_AGG);
        }
      }
    }
    __syncthreads();
    // look back with the whole block: thread t reads tile i0 - t, so a
    // round covers EX_THREADS predecessors; it stops at the nearest one
    // with an inclusive prefix and sums the published words up to it
    int64_t excl = 0;
    for (int64_t i0 = tile - 1; i0 >= 0; i0 -= EX_THREADS) {
      const int64_t i = i0 - threadIdx.x;
      unsigned long long w = tag | EX_INCL;              // before tile 0
      int64_t val = 0;
      if (i >= 0) {
        unsigned ns = 32;
        for (;;) {
          w = ld_acquire(st + i);
          if ((w >> 2) == C.epoch && (w & 3ull) != 0) break;
          __nanosleep(ns);               // a predecessor still works
          ns = ns < 256 ? 2 * ns : ns;
        }
        val = __ldcg((const long long*)((w & 3ull) == EX_INCL ? C.incl : C.agg) +
                     i);
      }
      const unsigned inc = __ballot_sync(0xffffffffu, (w & 3ull) == EX_INCL);
      if (lane == 0) s_inc[warp] = inc;
      __syncthreads();
      int stop = EX_THREADS;
      for (int k = 0; k < EX_THREADS / 32; ++k)
        if (s_inc[k]) {
          stop = k * 32 + __ffs(s_inc[k]) - 1;
          break;
        }
      int64_t y = (int)threadIdx.x <= stop ? val : 0;
      for (int off = 16; off > 0; off >>= 1)
        y += __shfl_down_sync(0xffffffffu, y, off);
      if (lane == 0) s_red[warp] = y;
      __syncthreads();
      for (int k = 0; k < EX_THREADS / 32; ++k) excl += s_red[k];
      __syncthreads();                   // s_inc and s_red reused
      if (stop < EX_THREADS) break;
    }
    if (threadIdx.x == 0) {
      const int64_t total = s_total;
      if (tile > 0) {
        C.incl[tile] = excl + total;
        st_release(st + tile, tag | EX_INCL);
      }
      if (tile == C.T - 1) *C.total = excl + total;
      s_tile = next;
    }
#pragma unroll
    for (int u = 0; u < EX_ROWS; ++u) {
      const int64_t r = r0 + (int64_t)u * EX_THREADS;
      if (r < C.n) C.offsets[r] = excl + s_base[u * 8 + warp] + x[u];
    }
  }
}

struct Cols {
  int n;
  const void* src[MAX_COLS];
  void* dst[MAX_COLS];
  int size[MAX_COLS];
  int mode[MAX_COLS];
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

__device__ __forceinline__ void zero_elem(void* dst, int size, int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = 0; break;
    case 2: ((uint16_t*)dst)[to] = 0; break;
    case 4: ((uint32_t*)dst)[to] = 0; break;
    default: ((uint64_t*)dst)[to] = 0; break;
  }
}

__global__ void ex_gather(int64_t out_cap, int64_t n, const int32_t* lo,
                          const int32_t* mcounts, const int64_t* offsets,
                          const int64_t* total, int64_t pcap, Cols C) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  int64_t row = 0, lo_r = 0, off_r = 0, m = 0;
  if (n > 0) {
    int64_t a = 0, b = n;            // count of offsets <= j
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (offsets[mid] <= j) a = mid + 1;
      else b = mid;
    }
    row = a - 1;
    row = row < 0 ? 0 : (row > n - 1 ? n - 1 : row);
    lo_r = lo[row];
    off_r = offsets[row];
    m = mcounts[row];
  }
  int64_t bidx = lo_r + (j - off_r);
  bidx = bidx < 0 ? 0 : (bidx > pcap - 1 ? pcap - 1 : bidx);
  const bool found = m > 0 && j < *total;
  for (int c = 0; c < C.n; ++c) {
    switch (C.mode[c]) {
      case M_PROBE:
        if (n > 0) copy_elem(C.src[c], C.dst[c], C.size[c], row, j);
        else zero_elem(C.dst[c], C.size[c], j);    // no probe rows
        break;
      case M_BUILD:
        copy_elem(C.src[c], C.dst[c], C.size[c], bidx, j);
        break;
      default:                       // M_BUILD_VALID
        ((uint8_t*)C.dst[c])[j] =
            found && (C.src[c] == nullptr ||
                      ((const uint8_t*)C.src[c])[bidx] != 0);
        break;
    }
  }
}

// One launch: lo, mcounts and offsets (n each), the 0-d total. status:
// 1 + T words (the ticket, zeroed once, then one look-back flag word a
// tile of EX_TILE rows), agg and incl T words each, kept per stream;
// epoch new every call. grid: the blocks (at most EX_GRID and T).
extern "C" int expand_counts_launch(int64_t n, const void* key, int key_f64,
                                    const void* kvalid, const void* length,
                                    const void* keys_sorted, int64_t kcap,
                                    int64_t n_build, int left, void* lo,
                                    void* mcounts, void* offsets,
                                    void* total, void* status, void* agg,
                                    void* incl, int64_t epoch, int grid,
                                    void* stream) {
  const int64_t T = n > 0 ? (n + EX_TILE - 1) / EX_TILE : 1;
  if (kcap < 1 || (kcap & (kcap - 1)) || n_build > kcap || n < 0 ||
      n >= ((int64_t)1 << 31) || epoch < 1 || epoch >= ((int64_t)1 << 62) ||
      grid < 1 || grid > EX_GRID || grid > T)
    return (int)cudaErrorInvalidValue;
  Search S;
  S.keys = keys_sorted;
  S.kcap = kcap;
  S.W = kcap > EX_STAGE ? kcap / EX_LEVELS : 1;
  S.wshift = 0;
  while (((int64_t)1 << S.wshift) < S.W) ++S.wshift;
  Counts C;
  C.n = n;
  C.key = key;
  C.kvalid = (const uint8_t*)kvalid;
  C.length = (const int32_t*)length;
  C.n_build = n_build;
  C.left = left;
  C.lo = (int32_t*)lo;
  C.mcounts = (int32_t*)mcounts;
  C.offsets = (int64_t*)offsets;
  C.total = (int64_t*)total;
  C.T = T;
  C.status = (unsigned long long*)status;
  C.agg = (int64_t*)agg;
  C.incl = (int64_t*)incl;
  C.epoch = (unsigned long long)epoch;
  const size_t smem = (size_t)(kcap / S.W) * 8;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (key_f64) {
    err = cudaFuncSetAttribute(ex_counts<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ex_counts<double><<<grid, EX_THREADS, smem, s>>>(S, C);
  } else {
    err = cudaFuncSetAttribute(ex_counts<long long>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ex_counts<long long><<<grid, EX_THREADS, smem, s>>>(S, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int expand_gather_launch(int64_t out_cap, int64_t n,
                                    const void* lo, const void* mcounts,
                                    const void* offsets, const void* total,
                                    int64_t pcap, int n_cols,
                                    const int64_t* src_ptrs,
                                    const int64_t* dst_ptrs,
                                    const int32_t* sizes,
                                    const int32_t* modes, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || pcap < 1)
    return (int)cudaErrorInvalidValue;
  if (out_cap == 0) return (int)cudaSuccess;
  Cols C;
  C.n = n_cols;
  for (int c = 0; c < MAX_COLS; ++c) {
    const bool on = c < n_cols;
    C.src[c] = on ? (const void*)src_ptrs[c] : nullptr;
    C.dst[c] = on ? (void*)dst_ptrs[c] : nullptr;
    C.size[c] = on ? sizes[c] : 1;
    C.mode[c] = on ? modes[c] : M_BUILD_VALID;
  }
  const int threads = 256;
  const int64_t blocks = (out_cap + threads - 1) / threads;
  ex_gather<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out_cap, n, (const int32_t*)lo, (const int32_t*)mcounts,
      (const int64_t*)offsets, (const int64_t*)total, pcap, C);
  return (int)cudaGetLastError();
}
