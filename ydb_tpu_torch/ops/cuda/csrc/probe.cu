// probe — broadcast-join probe of a key column against a build table.
//
// Replaces ydb_tpu/ops/join.py:probe_lut_traced with bsearch_traced and
// _select_and_gather: a direct-address LUT lookup (integral keys with a
// bounded span) or a branchless lower_bound over power-of-two padded
// sorted keys; the inner / left / left_semi / left_anti / mark selection
// with the NOT IN three-valued rule; and, when payloads are not
// late-materialized, the payload gathers.
// Bound on the H100: bytes. Every probe row reads its key, validity and
// selection and writes found, the clipped build row id and the new
// selection (plus one gathered element per payload column). The LUT
// (200,000 keys of part at SF1 = 1 MB of int32) and the sorted keys stay
// in L2, so what sets the time is the L2 requests the random lookups
// make (about 10^11 a second on the H100, measured), not the device's
// bandwidth.
// Design: a thread takes 8 rows as 4 pairs (pair k of lane l in its
// warp's 256 rows is rows 64k + 2l and 64k + 2l + 1), and a grid of one
// or two blocks an SM walks the tiles. The keys come a pair a 16-byte
// load and the row ids go out a pair a store, each instruction over
// contiguous bytes of the warp; the selection and validity come as 8
// contiguous bytes a lane in one load and the flags go out as one store,
// moved between the two layouts by shuffles. A warp whose rows pass n,
// or a view that does not start on a 16-byte boundary, reads and writes
// row by row in the same launch. Every lookup of a thread's rows is
// issued before the first is used: its LUT gathers, or each search
// level's key loads, overlap. Against one row a thread, byte by byte,
// this was 8-20% faster on the LUT probes and the small searches that
// TPC-H's q9 and q18 make, and level on q9's large search (PERF.md).
// The search makes as few L2 requests a row as it can, with the
// reference's comparisons, in its order, on the same keys, so every key
// lands on the reference's index: sentinel padding, float +-inf, NaN and
// -0.0 included. (1) After L levels of the branchless lower_bound, pos is
// a multiple of W = kcap >> L, and every key read in those levels is
// keys[i * W - 1] for i = 1 .. 2^L - 1. Each block stages those pivots
// (and keys[kcap - 1]) in shared memory once, in breadth-first order, so
// that a level's pivots are contiguous and a warp's lanes spread over
// the banks (in sorted order a deep level's pivots share one bank), and
// runs the first L levels there (L = 14: 128 KB; up to 16,384 keys, the
// whole array). (2) Below them, three levels at a time read one 64-byte
// node: probe_table (a first launch) writes, for each unit of the group,
// the 7 keys its three levels can read, in breadth-first order. (3) The
// last three levels read the 8 keys at pos (64 bytes) at once. Levels
// left over (fewer than three above the last) read a key a load. At
// q9's partsupp build (2^20 keys) a row makes two requests where the
// reference's search made twenty dependent loads. (4) The last
// comparison (keys[pos] == key) needs no load: the key at pos is the
// last one read that was not below the probe (pos's lowest zero bit is
// where it was read, and every comparison after it went up), or
// keys[kcap - 1] when none was. No row skips its lookup: the clipped row
// id is defined on inactive rows too. The payloads are gathered after
// every row of the thread has its row id, one payload at a time over
// the thread's rows.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PAYLOADS 16
#define LUT_PT 512               // threads a block, LUT path
#define SEARCH_PT 384            // threads a block, search
#define LUT_R 8                  // rows a thread, LUT path
#define LUT_BLOCKS 2             // blocks an SM, LUT path
#define SEARCH_R 8               // rows a thread, search
#define SEARCH_BLOCKS 1          // blocks an SM, search
#define MAX_LEVELS 14            // search levels run in shared memory
#define WB 2                     // rows whose node or window load at once
#define MAX_GROUPS 5
#define FULL 0xffffffffu

enum { K_INNER = 0, K_LEFT = 1, K_SEMI = 2, K_ANTI = 3, K_MARK = 4 };

struct Payloads {
  int n;
  const void* src[MAX_PAYLOADS];
  void* dst[MAX_PAYLOADS];
  const uint8_t* pvalid[MAX_PAYLOADS];   // null = all valid
  uint8_t* dvalid[MAX_PAYLOADS];
  int size[MAX_PAYLOADS];
};

struct Probe {
  int64_t n;
  const void* key;
  const uint8_t* kvalid;                 // null = all valid
  const uint8_t* sel;
  const int32_t* lut;
  int64_t span, lut_base;
  const void* keys;                      // sorted, power-of-two padded
  int kcap, levels;                      // levels run in shared memory
  int plain, groups;                     // levels below: see search_shape
  const uint64_t* table;                 // the groups' nodes
  int64_t goff[MAX_GROUPS];              // each group's first word
  int64_t n_build, pcap;
  int kind, not_in, has_null;
  uint8_t* found;
  int32_t* safe;
  uint8_t* sel_out;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// row j of the thread (pair j / 2, row j % 2 of it), from the warp's first
__device__ __forceinline__ int64_t row_of(int64_t w0, int lane, int j) {
  return w0 + (j >> 1) * 64 + 2 * lane + (j & 1);
}

// the nonzero bytes of a word as 4 bits
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return (unsigned)((w & 0xffu) != 0) |
         (unsigned)(((w >> 8) & 0xffu) != 0) << 1 |
         (unsigned)(((w >> 16) & 0xffu) != 0) << 2 |
         (unsigned)(((w >> 24) & 0xffu) != 0) << 3;
}

// 4 bits as 4 bytes of 0 / 1
__device__ __forceinline__ unsigned bits_bytes(unsigned b) {
  return (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 |
         ((b >> 3) & 1u) << 24;
}

// A byte flag of each of the thread's R rows as bit j (rows past n read
// as 0). Whole warps over an aligned view: the lane's R contiguous bytes
// in one load, then each pair's 2 bits from the lane that read them.
template <int R>
__device__ __forceinline__ unsigned load_flags(const uint8_t* p, int64_t w0,
                                               int64_t n, int lane) {
  unsigned m = 0;
  if (w0 + 32 * R <= n && aligned16(p + w0)) {
    const uint8_t* q = p + w0 + R * lane;
    unsigned c;
    if constexpr (R == 16) {
      const uint4 v = *(const uint4*)q;
      c = byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
          byte_bits(v.w) << 12;
    } else if constexpr (R == 8) {
      const uint2 v = *(const uint2*)q;
      c = byte_bits(v.x) | byte_bits(v.y) << 4;
    } else {
      c = byte_bits(*(const unsigned*)q);
    }
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      const int r0 = k * 64 + 2 * lane;
      m |= ((__shfl_sync(FULL, c, r0 / R) >> (r0 % R)) & 3u) << (2 * k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t r = row_of(w0, lane, j);
      if (r < n) m |= (unsigned)(p[r] != 0) << j;
    }
  }
  return m;
}

// The flags of bits m (row j of the thread at bit j) as bytes: whole
// warps over an aligned view as the lane's R contiguous rows in one
// store, each pair's 2 bits taken from the lane that holds them.
template <int R>
__device__ __forceinline__ void store_flags(uint8_t* p, int64_t w0,
                                            int64_t n, int lane,
                                            unsigned m) {
  if (w0 + 32 * R <= n && aligned16(p + w0)) {
    const int k = R * lane / 64, src = (R * lane / 2) % 32;
    unsigned c = 0;
#pragma unroll
    for (int q = 0; q < R / 2; ++q)
      c |= ((__shfl_sync(FULL, m, src + q) >> (2 * k)) & 3u) << (2 * q);
    uint8_t* d = p + w0 + R * lane;
    if constexpr (R == 16)
      *(uint4*)d = make_uint4(bits_bytes(c & 15u), bits_bytes((c >> 4) & 15u),
                              bits_bytes((c >> 8) & 15u), bits_bytes(c >> 12));
    else if constexpr (R == 8)
      *(uint2*)d = make_uint2(bits_bytes(c & 15u), bits_bytes(c >> 4));
    else
      *(unsigned*)d = bits_bytes(c);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t r = row_of(w0, lane, j);
      if (r < n) p[r] = (m >> j) & 1u;
    }
  }
}

__device__ __forceinline__ int64_t from_bits(long long x, int64_t*) {
  return (int64_t)x;
}
__device__ __forceinline__ double from_bits(long long x, double*) {
  return __longlong_as_double(x);
}

// the thread's R keys, a pair a load where the warp is whole and the
// view aligned; rows past n read as 0
template <int R, typename T>
__device__ __forceinline__ void load_keys(const T* p, int64_t w0, int64_t n,
                                          int lane, T (&v)[R]) {
  if (w0 + 32 * R <= n && aligned16(p + w0)) {
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      const longlong2 x = *(const longlong2*)(p + w0 + k * 64 + 2 * lane);
      v[2 * k] = from_bits(x.x, (T*)nullptr);
      v[2 * k + 1] = from_bits(x.y, (T*)nullptr);
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t r = row_of(w0, lane, j);
      v[j] = r < n ? p[r] : (T)0;
    }
  }
}

// 2 integers of S bytes as 2S contiguous bytes
template <typename U>
__device__ __forceinline__ void store_pair(U* d, U a, U b) {
  constexpr int S = sizeof(U);
  if constexpr (S == 8)
    *(ulonglong2*)d = make_ulonglong2((uint64_t)a, (uint64_t)b);
  else if constexpr (S == 4)
    *(uint2*)d = make_uint2((uint32_t)a, (uint32_t)b);
  else if constexpr (S == 2)
    *(uint32_t*)d = (uint32_t)a | (uint32_t)b << 16;
  else
    *(uint16_t*)d = (uint16_t)((uint32_t)a | (uint32_t)b << 8);
}

// the thread's R values, a pair a store where the warp is whole and the
// view aligned
template <int R, typename U>
__device__ __forceinline__ void store_rows(U* p, int64_t w0, int64_t n,
                                           int lane, const U (&v)[R]) {
  if (w0 + 32 * R <= n && aligned16(p + w0)) {
#pragma unroll
    for (int k = 0; k < R / 2; ++k)
      store_pair(p + w0 + k * 64 + 2 * lane, v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int64_t r = row_of(w0, lane, j);
      if (r < n) p[r] = v[j];
    }
  }
}

// 8 keys from a 16-byte aligned address, four 16-byte loads
template <typename T>
__device__ __forceinline__ void load8(const uint64_t* p, T (&v)[8]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const longlong2 x = ((const longlong2*)p)[h];
    v[2 * h] = from_bits(x.x, (T*)nullptr);
    v[2 * h + 1] = from_bits(x.y, (T*)nullptr);
  }
}

// Three levels of the branchless lower_bound over the keys of a subtree
// in breadth-first order (root r; its children c0 < c1; their children
// g0 .. g3): the reference's comparisons, one a level; kf takes each key
// that is not below e. Returns how many eighths of the subtree pos moves
// up (0 .. 7).
template <typename T>
__device__ __forceinline__ int descend3(T r, T c0, T c1, T g0, T g1, T g2,
                                        T g3, T e, T& kf) {
  const bool t1 = r < e;
  if (!t1) kf = r;
  const T k2 = t1 ? c1 : c0;
  const bool t2 = k2 < e;
  if (!t2) kf = k2;
  const T k3 = t1 ? (t2 ? g3 : g2) : (t2 ? g1 : g0);
  const bool t3 = k3 < e;
  if (!t3) kf = k3;
  return (t1 ? 4 : 0) + (t2 ? 2 : 0) + (t3 ? 1 : 0);
}

// one payload over the thread's rows: gathered at the rows' ids
template <int R, typename U>
__device__ __forceinline__ void gather_payload(const U* src, U* dst,
                                               const int32_t (&safe)[R],
                                               int64_t w0, int64_t n,
                                               int lane) {
  U v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = src[safe[j]];
  store_rows<R>(dst, w0, n, lane, v);
}

// MODE 0: the LUT (int64 keys); MODE 1: the sorted-keys search over T;
// NT threads a block, R rows a thread
template <int MODE, typename T, int NT, int R>
__global__ void __launch_bounds__(NT, MODE ? SEARCH_BLOCKS : LUT_BLOCKS)
probe_rows(Probe a, Payloads P) {
  extern __shared__ unsigned long long probe_smem[];
  T* piv = (T*)probe_smem;
  const int64_t n = a.n;
  const T* keys = (const T*)a.keys;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the staged pivots in breadth-first order: level l's 2^l pivots are
  // piv[2^l .. 2^(l+1) - 1], piv[2^l + k] = keys[(2k + 1) * 2^(L-1-l) *
  // W - 1]; piv[0] = keys[kcap - 1]. A level's pivots are contiguous, so
  // the lanes of a warp spread over the banks (in sorted order every
  // pivot of a deep level sits in one bank).
  const int L = a.levels;
  const int W = MODE ? a.kcap >> L : 1;
  const int top = (1 << L) - 1;
  if constexpr (MODE == 1) {
    for (int i = threadIdx.x; i <= top; i += NT) {
      int64_t unit = (int64_t)1 << L;                // piv[0]: the last key
      if (i > 0) {
        const int l = 31 - __clz(i);
        unit = (int64_t)(2 * (i - (1 << l)) + 1) << (L - 1 - l);
      }
      piv[i] = keys[unit * W - 1];
    }
    __syncthreads();
  }
  const int64_t tile_rows = (int64_t)NT * R;
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t w0 = t * tile_rows + (int64_t)warp * 32 * R;
    if (w0 >= n) continue;                         // the whole warp
    const unsigned act = load_flags<R>(a.sel, w0, n, lane);
    const unsigned val = a.kvalid == nullptr
                             ? (1u << R) - 1u
                             : load_flags<R>(a.kvalid, w0, n, lane);
    T e[R];
    load_keys<R>((const T*)a.key, w0, n, lane, e);
    int32_t idx[R];
    unsigned found = 0;
    if constexpr (MODE == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int64_t off = (int64_t)((uint64_t)e[j] - (uint64_t)a.lut_base);
        const int64_t c = off < 0 ? 0 : (off > a.span - 1 ? a.span - 1 : off);
        idx[j] = a.lut[c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int64_t off = (int64_t)((uint64_t)e[j] - (uint64_t)a.lut_base);
        found |= (unsigned)(off >= 0 && off < a.span && idx[j] >= 0) << j;
      }
    } else {
      // kf: the last key read that was not below the probe
      T kf[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        idx[j] = 1;
        kf[j] = piv[0];
      }
      // the first L levels over the staged pivots: node i's children are
      // 2i and 2i + 1; after L levels, node - 2^L is pos in units of W
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const T kv = piv[idx[j]];
          const bool up = kv < e[j];
          if (!up) kf[j] = kv;
          idx[j] = 2 * idx[j] + (up ? 1 : 0);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) idx[j] = (idx[j] - (top + 1)) * W;
      // levels one key a load, level by level across the rows
      int step = W >> 1;
      for (int l = 0; l < a.plain; ++l, step >>= 1) {
        T kv[R];
#pragma unroll
        for (int j = 0; j < R; ++j) kv[j] = keys[idx[j] + step - 1];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (kv[j] < e[j]) idx[j] += step;
          else kf[j] = kv[j];
        }
      }
      // three levels a node: 64 bytes, one load of WB rows at a time
      for (int g = 0; g < a.groups; ++g, step >>= 3) {
        const int U = 2 * step;                    // the node's unit
        const int ush = __ffs(U) - 1;
        const uint64_t* tab = a.table + a.goff[g];
#pragma unroll
        for (int j0 = 0; j0 < R; j0 += WB) {
          T nk[WB][8];
#pragma unroll
          for (int b = 0; b < WB; ++b)
            load8(tab + (int64_t)(idx[j0 + b] >> ush) * 8, nk[b]);
#pragma unroll
          for (int b = 0; b < WB; ++b) {
            const int j = j0 + b;
            idx[j] += (U >> 3) * descend3(nk[b][1], nk[b][2], nk[b][3],
                                          nk[b][4], nk[b][5], nk[b][6],
                                          nk[b][7], e[j], kf[j]);
          }
        }
      }
      // the last three: keys[pos .. pos + 7], 64 bytes, one load
      if (step == 4) {
#pragma unroll
        for (int j0 = 0; j0 < R; j0 += WB) {
          T w[WB][8];
#pragma unroll
          for (int b = 0; b < WB; ++b)
            load8((const uint64_t*)(keys + idx[j0 + b]), w[b]);
#pragma unroll
          for (int b = 0; b < WB; ++b) {
            const int j = j0 + b;
            idx[j] += descend3(w[b][3], w[b][1], w[b][5], w[b][0], w[b][2],
                               w[b][4], w[b][6], e[j], kf[j]);
          }
        }
      }
      // pos <= kcap - 1 always: the reference's clip is a no-op
#pragma unroll
      for (int j = 0; j < R; ++j)
        found |= (unsigned)(kf[j] == e[j] && idx[j] < a.n_build) << j;
    }
    found &= act & val;
    int32_t safe[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      safe[j] = idx[j] < 0 ? 0
                           : (idx[j] > a.pcap - 1 ? (int32_t)(a.pcap - 1)
                                                  : idx[j]);
    unsigned o;
    if (a.kind == K_INNER || a.kind == K_SEMI) o = found;
    else if (a.kind == K_ANTI) o = ~found & act;
    else o = act;
    if (a.kind == K_ANTI && a.not_in) {
      if (a.kvalid != nullptr && a.n_build != 0) o &= val;
      if (a.has_null) o = 0;
    }
    store_flags<R>(a.found, w0, n, lane, found);
    store_rows<R>(a.safe, w0, n, lane, safe);
    store_flags<R>(a.sel_out, w0, n, lane, o);
    for (int p = 0; p < P.n; ++p) {
      switch (P.size[p]) {
        case 1:
          gather_payload<R>((const uint8_t*)P.src[p], (uint8_t*)P.dst[p],
                            safe, w0, n, lane);
          break;
        case 2:
          gather_payload<R>((const uint16_t*)P.src[p], (uint16_t*)P.dst[p],
                            safe, w0, n, lane);
          break;
        case 4:
          gather_payload<R>((const uint32_t*)P.src[p], (uint32_t*)P.dst[p],
                            safe, w0, n, lane);
          break;
        default:
          gather_payload<R>((const uint64_t*)P.src[p], (uint64_t*)P.dst[p],
                            safe, w0, n, lane);
          break;
      }
      unsigned pv = found;
      if (P.pvalid[p] != nullptr) {
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < R; ++j)
          m |= (unsigned)(P.pvalid[p][safe[j]] != 0) << j;
        pv &= m;
      }
      store_flags<R>(P.dvalid[p], w0, n, lane, pv);
    }
  }
}

// The nodes of the search's three-level groups: node q of a group with
// unit U holds, in breadth-first order at words 1 .. 7, the keys its
// three levels read below pos = q * U (word 0 is not read).
struct Groups {
  int n;
  int64_t off[MAX_GROUPS];               // the group's first word
  int ush[MAX_GROUPS];                   // log2 of its unit
};

__global__ void probe_table(const uint64_t* keys, uint64_t* table,
                            int64_t words, Groups G) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += stride) {
    int64_t first = 0;
    int ush = G.ush[0];
#pragma unroll
    for (int g = 1; g < MAX_GROUPS; ++g)
      if (g < G.n && w >= G.off[g]) {
        first = G.off[g];
        ush = G.ush[g];
      }
    const int64_t r = w - first, q = r >> 3;
    const int m = (int)(r & 7);
    uint64_t v = 0;
    if (m) {
      const int d = 31 - __clz(m);
      const int64_t U = (int64_t)1 << ush;
      v = keys[q * U + (int64_t)(2 * (m - (1 << d)) + 1) * (U >> (d + 1)) -
               1];
    }
    table[w] = v;
  }
}

// The search's shape below the shared-memory levels (W = kcap >> L keys
// a unit): `plain` levels a key a load, `groups` groups of three levels
// a node (from the table), the last three from a window of 8 keys; with
// fewer than 8 keys a unit, or keys off a 16-byte boundary, every level
// is plain. Returns the table's words.
static int64_t search_shape(int64_t kcap, int L, const void* keys,
                            Probe* a, Groups* G) {
  const int64_t W = kcap >> L;
  int lw = 0;
  while (((int64_t)1 << lw) < W) ++lw;
  a->plain = lw;
  a->groups = 0;
  if (W >= 8 && ((uintptr_t)keys & 15u) == 0) {
    a->plain = (lw - 3) % 3;
    a->groups = (lw - 3) / 3;
  }
  int64_t words = 0;
  G->n = a->groups;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool on = g < a->groups;
    const int ush = lw - a->plain - 3 * g;
    a->goff[g] = G->off[g] = on ? words : 0;
    G->ush[g] = on ? ush : 0;
    if (on) words += (kcap >> ush) * 8;
  }
  return words;
}

// the levels run in shared memory: all of them up to 2^MAX_LEVELS keys
static int staged_levels(int64_t kcap) {
  int lg = 0;
  while (((int64_t)1 << lg) < kcap) ++lg;
  return lg < MAX_LEVELS ? lg : MAX_LEVELS;
}

template <typename T>
static cudaError_t launch_search(const Probe& a, const Payloads& P, int sms,
                                 cudaStream_t s) {
  const int64_t tile = (int64_t)SEARCH_PT * SEARCH_R;
  const int64_t tiles = (a.n + tile - 1) / tile;
  const int64_t cap = (int64_t)SEARCH_BLOCKS * sms;
  const size_t smem = ((size_t)1 << a.levels) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      probe_rows<1, T, SEARCH_PT, SEARCH_R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  probe_rows<1, T, SEARCH_PT, SEARCH_R>
      <<<(unsigned)(tiles < cap ? tiles : cap), SEARCH_PT, smem, s>>>(a, P);
  return cudaGetLastError();
}

// table: table_len int64 words for the search's node groups (at least
// what search_shape asks); build_table: fill it first (the first call of
// a probe; a call for more payloads reuses it).
extern "C" int probe_launch(int64_t n, const void* key, int key_f64,
                            const void* kvalid, const void* sel, int bsearch,
                            const void* lut, int64_t span, int64_t lut_base,
                            const void* keys_sorted, int64_t kcap,
                            int64_t n_build, int64_t pcap, int kind,
                            int not_in, int has_null, void* found_out,
                            void* safe_out, void* sel_out, int n_payloads,
                            const int64_t* src_ptrs, const int64_t* dst_ptrs,
                            const int64_t* pvalid_ptrs,
                            const int64_t* dvalid_ptrs, const int32_t* sizes,
                            void* stream, void* table, int64_t table_len,
                            int build_table) {
  if (n_payloads < 0 || n_payloads > MAX_PAYLOADS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (pcap < 1 || pcap > ((int64_t)1 << 31) ||
      (bsearch && (kcap < 1 || kcap > ((int64_t)1 << 30) ||
                   (kcap & (kcap - 1)))) ||
      (!bsearch && (span < 1 || key_f64)))
    return (int)cudaErrorInvalidValue;
  Payloads P;
  P.n = n_payloads;
  for (int p = 0; p < MAX_PAYLOADS; ++p) {
    const bool on = p < n_payloads;
    P.src[p] = on ? (const void*)src_ptrs[p] : nullptr;
    P.dst[p] = on ? (void*)dst_ptrs[p] : nullptr;
    P.pvalid[p] = on ? (const uint8_t*)pvalid_ptrs[p] : nullptr;
    P.dvalid[p] = on ? (uint8_t*)dvalid_ptrs[p] : nullptr;
    P.size[p] = on ? sizes[p] : 8;
  }
  Probe a;
  a.n = n;
  a.key = key;
  a.kvalid = (const uint8_t*)kvalid;
  a.sel = (const uint8_t*)sel;
  a.lut = (const int32_t*)lut;
  a.span = span;
  a.lut_base = lut_base;
  a.keys = keys_sorted;
  a.kcap = (int)(bsearch ? kcap : 1);
  a.levels = bsearch ? staged_levels(kcap) : 0;
  a.table = (const uint64_t*)table;
  a.plain = a.groups = 0;
  a.n_build = n_build;
  a.pcap = pcap;
  a.kind = kind;
  a.not_in = not_in;
  a.has_null = has_null;
  a.found = (uint8_t*)found_out;
  a.safe = (int32_t*)safe_out;
  a.sel_out = (uint8_t*)sel_out;
  Groups G;
  const int64_t words =
      bsearch ? search_shape(kcap, a.levels, keys_sorted, &a, &G) : 0;
  if (words > table_len || (words > 0 && table == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (words > 0 && build_table) {
    const int64_t blocks = (words + 255) / 256;
    probe_table<<<(unsigned)(blocks < 4 * sms ? blocks : 4 * sms), 256, 0,
                  s>>>((const uint64_t*)keys_sorted, (uint64_t*)table, words,
                       G);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (bsearch)
    return (int)(key_f64 ? launch_search<double>(a, P, sms, s)
                         : launch_search<int64_t>(a, P, sms, s));
  const int64_t tile = (int64_t)LUT_PT * LUT_R;
  const int64_t tiles = (n + tile - 1) / tile;
  const int64_t cap = (int64_t)LUT_BLOCKS * sms;
  probe_rows<0, int64_t, LUT_PT, LUT_R>
      <<<(unsigned)(tiles < cap ? tiles : cap), LUT_PT, 0, s>>>(a, P);
  return (int)cudaGetLastError();
}
