// sort — lexicographic sort of rows by a list of 64-bit keys, row id last.
//
// Replaces ydb_tpu/ops/sort.py:_sort_impl (lax.sort over dropped rank,
// [null rank, key]... and an iota). The caller encodes every operand as
// an order-preserving unsigned 64-bit key (ops/sort.py, plain torch), so
// the kernel orders words; the row id as the final key makes all keys
// distinct and any correct sort stable. Output: the int32 permutation.
// Bound on the H100: bytes. The least a permutation costs is one read of
// every key word and one write of the row ids (8 bytes a word and 4 a
// row); there is nothing to compute beyond digit extraction. A radix sort
// moves (word, row id) pairs once per live digit on top, so what it pays
// is set by how many of the 8 x words digits vary over the rows.
// Design: an LSD radix sort on 8-bit digits, from the least significant
// digit of the last word up. The words are order-preserving unsigned
// keys and the sort starts from row order, so a stable pass per digit
// gives the comparison sort's permutation bit for bit, with no compares.
// (1) rs_census: one read of every word builds each word's eight 256-bin
// digit histograms (block counts in shared memory, one add per warp
// where its 32 rows share a digit, integer atomics into [words, 8, 256]:
// exact, so the order blocks finish in does not matter); the last block
// to finish marks a digit whose histogram holds all n rows in one bin as
// dead (its pass cannot reorder anything: rank words of 0/1 have one live
// digit, a TPC-H order key three) and writes the device-side pass table:
// live or skipped, input and output buffer, and which live pass is last.
// The host launches the maximal list, 8 passes a word, and reads nothing
// back: no host sync inside a query body. (2) rs_pass, one launch per
// digit: a skipped pass returns at entry; a live one takes 4,096-row tiles
// by ticket, ranks each tile's rows stably in shared memory (per-warp
// digit counts by 8 ballots, a scan over the bins), takes each bin's
// first output row from the census's bin offsets plus a decoupled
// look-back over the earlier tiles' per-bin counts (integers: the result
// does not depend on timing), and writes each bin's rows of the tile as
// one contiguous run. A pass carries (word, row id) pairs: the first live
// pass reads its word in row order, the first pass of a later word
// gathers that word once through the row ids, and the last live pass
// writes the row ids alone into `perm`. If no digit is live (every key
// equal), pass 0 runs alone and writes the identity. (3) rs_block: up to
// 8,192 rows (the ORDER BY shapes) the same digit passes run inside one
// block and one launch, over shared memory: each word is gathered once in
// the current order, one OR of every row's word with row 0's finds its
// live digits, and each live digit is a stable pass ranked by ballots as
// above. A block radix sort rather than a bitonic one: its work follows
// the live digits (Q1's ORDER BY has three), where a bitonic sort pays
// log2(n)^2 / 2 barrier steps of multi-word compares whatever the keys.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_KEYS 16
#define MAX_PASSES (8 * MAX_KEYS)
#define BINS 256
#define RT 256                      // threads of a digit pass (one per bin)
#define RWARPS (RT / 32)
#define RI 16                       // rows a thread of a digit pass
#define WROWS (32 * RI)             // rows a warp of a digit pass
#define RTILE (RT * RI)             // rows a tile: 4,096
#define CT 256                      // threads of the census
#define CU 4                        // strips a census warp loads at once
#define BLOCK_MAX 8192              // the one-block path's most rows
#define FULL 0xffffffffu

// look-back words: epoch (1 + the live pass's ordinal) in the top byte,
// then the flags, then the count
#define LB_AGG (1ull << 32)
#define LB_PRE (1ull << 33)
#define LB_VALUE 0xffffffffull
#define LB_EPOCH (0xffull << 56)

enum { IN_ROWS = 0, IN_PAIRS = 1, IN_GATHER = 2 };
#define OUT_PERM 2

struct Words {
  int n;
  const uint64_t* k[MAX_KEYS];
};

// one entry of the pass table (pass p sorts by digit p % 8 of word
// n - 1 - p / 8)
struct Pass {
  int live;       // 0: the pass returns at entry
  int epoch;      // 1 + the live pass's ordinal
  int word, shift;
  int in_mode;    // IN_ROWS: word in row order; IN_PAIRS: the previous
                  // pass's (word, row id) pairs; IN_GATHER: its row ids,
                  // the word gathered through them
  int in_buf, out_buf;   // ping-pong buffer 0 / 1; OUT_PERM: `perm`
  int write_key;  // the next live pass sorts the same word
};

__device__ __forceinline__ uint64_t load_lb(const uint64_t* p) {
  return *(const volatile uint64_t*)p;
}

__device__ __forceinline__ void store_lb(uint64_t* p, uint64_t v) {
  *(volatile uint64_t*)p = v;
}

// Exclusive scan of v over a 256-thread block (wsum: 8 ints of shared
// memory); *total gets the sum.
__device__ __forceinline__ int block_excl_256(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int s = wsum[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// ---------------------------------------------------------------- census

__global__ void __launch_bounds__(CT)
rs_census(int64_t n, Words K, int32_t* hist, int32_t* done, Pass* table) {
  __shared__ int h[8 * BINS];
  __shared__ int s_live[MAX_PASSES];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * CT * CU;
  for (int w = 0; w < K.n; ++w) {
    for (int i = threadIdx.x; i < 8 * BINS; i += CT) h[i] = 0;
    __syncthreads();
    const uint64_t* kw = K.k[w];
    for (int64_t base = ((int64_t)blockIdx.x * (CT / 32) + warp) * 32 * CU;
         base < n; base += stride) {
      uint64_t key[CU];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int64_t i = base + u * 32 + lane;
        key[u] = i < n ? kw[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const bool in = base + u * 32 + lane < n;
        const unsigned act = __ballot_sync(FULL, in);
        if (act == 0) break;            // lane 0 is in from here on
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int dig = (int)((key[u] >> (8 * d)) & 255u);
          const int d0 = __shfl_sync(FULL, dig, 0);
          if (__ballot_sync(FULL, in && dig != d0) == 0) {
            if (lane == 0) atomicAdd(&h[d * BINS + d0], __popc(act));
          } else if (in) {
            atomicAdd(&h[d * BINS + dig], 1);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * BINS; i += CT)
      if (h[i]) atomicAdd(&hist[w * 8 * BINS + i], h[i]);
    __syncthreads();
  }
  // the last block to finish reads the whole census
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int P = 8 * K.n;
  for (int p = warp; p < P; p += CT / 32) {
    const int w = K.n - 1 - p / 8, d = p % 8;
    const volatile int32_t* hh = hist + (w * 8 + d) * BINS;
    bool one_bin = false;
    for (int b = lane; b < BINS; b += 32) one_bin |= (int64_t)hh[b] == n;
    one_bin = __any_sync(FULL, one_bin);
    if (lane == 0) s_live[p] = !one_bin;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int nlive = 0;
  for (int p = 0; p < P; ++p) nlive += s_live[p];
  if (nlive == 0) s_live[0] = 1;   // every key equal: the identity
  int k = 0, prev_word = -1, last = 0;
  for (int p = 0; p < P; ++p) {
    Pass e = {0, 0, 0, 0, 0, 0, 0, 0};
    if (s_live[p]) {
      e.live = 1;
      e.epoch = k + 1;
      e.word = K.n - 1 - p / 8;
      e.shift = 8 * (p % 8);
      e.in_mode = k == 0 ? IN_ROWS
                         : (e.word == prev_word ? IN_PAIRS : IN_GATHER);
      e.in_buf = (k + 1) & 1;
      e.out_buf = k & 1;
      prev_word = e.word;
      last = p;
      ++k;
    }
    table[p] = e;
  }
  table[last].out_buf = OUT_PERM;
  int next_word = -1;
  for (int p = P - 1; p >= 0; --p) {
    if (!s_live[p]) continue;
    table[p].write_key = table[p].word == next_word;
    next_word = table[p].word;
  }
}

// ---------------------------------------------------------------- pass

// Rows of a warp: w0 + j * 32 + lane for j < RI, in row order.
__global__ void __launch_bounds__(RT, 2)
rs_pass(int64_t n, int p, Words K, const Pass* table, const int32_t* hist,
        uint64_t* kb0, uint64_t* kb1, int32_t* rb0, int32_t* rb1,
        int32_t* perm, uint64_t* status, int32_t* tickets, int64_t T) {
  const Pass P = table[p];
  if (!P.live) return;
  extern __shared__ uint64_t smem[];
  uint64_t* s_key = smem;                           // RTILE
  int32_t* s_row = (int32_t*)(s_key + RTILE);       // RTILE
  int* wcnt = (int*)(s_row + RTILE);                // RWARPS x BINS
  __shared__ int s_base[BINS], s_lstart[BINS], s_gbase[BINS];
  __shared__ int s_wsum[RWARPS];
  __shared__ int64_t s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = threadIdx.x;                        // this thread's bin
  const unsigned below = (1u << lane) - 1u;
  // the bins' first output rows over the whole pass: the census's counts
  // of this digit, scanned
  int unused;
  s_base[b] = block_excl_256(hist[(P.word * 8 + P.shift / 8) * BINS + b],
                             s_wsum, &unused);
  const uint64_t* word = K.k[P.word];
  const uint64_t* kin = P.in_buf ? kb1 : kb0;
  const int32_t* rin = P.in_buf ? rb1 : rb0;
  uint64_t* kout = P.out_buf == 1 ? kb1 : kb0;
  int32_t* rout = P.out_buf == OUT_PERM ? perm : (P.out_buf ? rb1 : rb0);
  const uint64_t ep = (uint64_t)P.epoch << 56;
  const int shift = P.shift;
  for (;;) {
    __syncthreads();                   // the previous tile is out
    if (threadIdx.x == 0) s_tile = atomicAdd(&tickets[p], 1);
    for (int w = 0; w < RWARPS; ++w) wcnt[w * BINS + b] = 0;
    __syncthreads();
    const int64_t t = s_tile;
    if (t >= T) return;
    const int64_t w0 = t * RTILE + (int64_t)warp * WROWS;

    // (1) the warp's rows (every load issued before any is used), each
    // one's rank among the warp's earlier rows of its digit, the counts
    uint64_t key[RI];
    int32_t row[RI];
    int rank[RI / 2];                  // two 16-bit ranks (< WROWS) an int
    if (P.in_mode == IN_ROWS) {
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int64_t i = w0 + j * 32 + lane;
        row[j] = (int32_t)i;
        key[j] = i < n ? word[i] : 0;
      }
    } else {
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int64_t i = w0 + j * 32 + lane;
        row[j] = i < n ? rin[i] : 0;
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int64_t i = w0 + j * 32 + lane;
        key[j] = i >= n ? 0 : (P.in_mode == IN_PAIRS ? kin[i] : word[row[j]]);
      }
    }
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const bool in = w0 + j * 32 + lane < n;
      const int d = (int)((key[j] >> shift) & 255u);
      unsigned peers = __ballot_sync(FULL, in);
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const bool on = (d >> bit) & 1;
        const unsigned m = __ballot_sync(FULL, on);
        peers &= on ? m : ~m;
      }
      const int r = in ? wcnt[warp * BINS + d] + __popc(peers & below) : 0;
      if (j & 1) rank[j >> 1] |= r << 16;
      else rank[j >> 1] = r;
      __syncwarp();
      if (in && (peers & below) == 0) wcnt[warp * BINS + d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // (2) the tile's count of bin b; each warp's first rank in the bin
    int tc = 0;
#pragma unroll
    for (int w = 0; w < RWARPS; ++w) {
      const int c = wcnt[w * BINS + b];
      wcnt[w * BINS + b] = tc;
      tc += c;
    }
    // the bin's rows in earlier tiles: a decoupled look-back
    uint64_t* mine = status + t * BINS + b;
    int64_t before = 0;
    if (t == 0) {
      store_lb(mine, ep | LB_PRE | (uint64_t)tc);
    } else {
      store_lb(mine, ep | LB_AGG | (uint64_t)tc);
      for (int64_t j = t - 1;; --j) {
        uint64_t s;
        do {
          s = load_lb(status + j * BINS + b);
        } while ((s & LB_EPOCH) != ep);
        before += (int64_t)(s & LB_VALUE);
        if (s & LB_PRE) break;
      }
      store_lb(mine, ep | LB_PRE | (uint64_t)(before + tc));
    }
    s_gbase[b] = s_base[b] + (int)before;
    int tile_rows;
    const int ls = block_excl_256(tc, s_wsum, &tile_rows);
    s_lstart[b] = ls;
#pragma unroll
    for (int w = 0; w < RWARPS; ++w) wcnt[w * BINS + b] += ls;
    __syncthreads();

    // (3) every row to its slot in the tile: bins in order, rows in order
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int64_t i = w0 + j * 32 + lane;
      if (i < n) {
        const int d = (int)((key[j] >> shift) & 255u);
        const int slot = wcnt[warp * BINS + d] +
                         ((rank[j >> 1] >> (16 * (j & 1))) & 0xffff);
        s_key[slot] = key[j];
        s_row[slot] = row[j];
      }
    }
    __syncthreads();

    // (4) out in slot order: a bin's rows of the tile as one run
    for (int i = threadIdx.x; i < tile_rows; i += RT) {
      const uint64_t k = s_key[i];
      const int d = (int)((k >> shift) & 255u);
      const int64_t dst = (int64_t)s_gbase[d] + (i - s_lstart[d]);
      rout[dst] = s_row[i];
      if (P.write_key) kout[dst] = k;
    }
  }
}

// ---------------------------------------------------------------- one block

// The radix passes inside one block over n <= BLOCK_MAX rows, in shared
// memory: two N-word buffers (the current word in the current order, and
// the next order's), the warps' counts, two N-entry row-id buffers and N
// 16-bit ranks; a warp takes S consecutive strips of 32 rows. A word's
// live digits are the bytes where some row differs from row 0: one OR
// over the rows finds all eight.
__global__ void __launch_bounds__(RT)
rs_block(int n, int N, Words K, int32_t* perm) {
  extern __shared__ uint64_t smem[];
  uint64_t* ka = smem;
  uint64_t* kb = smem + N;
  int* wcnt = (int*)(smem + 2 * N);
  int32_t* ra = (int32_t*)(wcnt + RWARPS * BINS);
  int32_t* rb = ra + N;
  uint16_t* srank = (uint16_t*)(rb + N);
  __shared__ int s_wsum[RWARPS];
  __shared__ unsigned long long s_diff;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int S = (N + RT - 1) / RT;
  const int w0 = warp * 32 * S;
  for (int i = threadIdx.x; i < n; i += RT) ra[i] = i;
  for (int w = K.n - 1; w >= 0; --w) {
    if (threadIdx.x == 0) s_diff = 0;
    __syncthreads();
    const uint64_t* kw = K.k[w];
    const uint64_t k0 = kw[ra[0]];
    uint64_t diff = 0;
    for (int i = threadIdx.x; i < n; i += RT) {
      const uint64_t k = kw[ra[i]];
      ka[i] = k;
      diff |= k ^ k0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      diff |= __shfl_xor_sync(FULL, diff, off);
    if (lane == 0 && diff) atomicOr(&s_diff, (unsigned long long)diff);
    __syncthreads();
    const uint64_t live = s_diff;
    __syncthreads();                   // before s_diff is cleared again
    for (int shift = 0; shift < 64; shift += 8) {
      if (((live >> shift) & 255u) == 0) continue;   // every row shares it
      for (int v = 0; v < RWARPS; ++v) wcnt[v * BINS + b] = 0;
      __syncthreads();
      for (int j = 0; j < S; ++j) {
        const int i = w0 + j * 32 + lane;
        const bool in = i < n;
        const int d = in ? (int)((ka[i] >> shift) & 255u) : 0;
        unsigned peers = __ballot_sync(FULL, in);
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const bool on = (d >> bit) & 1;
          const unsigned m = __ballot_sync(FULL, on);
          peers &= on ? m : ~m;
        }
        if (in) srank[i] = (uint16_t)(wcnt[warp * BINS + d] +
                                      __popc(peers & below));
        __syncwarp();
        if (in && (peers & below) == 0)
          wcnt[warp * BINS + d] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      int tc = 0;
#pragma unroll
      for (int v = 0; v < RWARPS; ++v) {
        const int c = wcnt[v * BINS + b];
        wcnt[v * BINS + b] = tc;
        tc += c;
      }
      int total;
      const int ls = block_excl_256(tc, s_wsum, &total);
#pragma unroll
      for (int v = 0; v < RWARPS; ++v) wcnt[v * BINS + b] += ls;
      __syncthreads();
      for (int j = 0; j < S; ++j) {
        const int i = w0 + j * 32 + lane;
        if (i >= n) break;
        const uint64_t k = ka[i];
        const int slot = wcnt[warp * BINS + (int)((k >> shift) & 255u)] +
                         srank[i];
        kb[slot] = k;
        rb[slot] = ra[i];
      }
      __syncthreads();
      uint64_t* kt = ka;
      ka = kb;
      kb = kt;
      int32_t* rt = ra;
      ra = rb;
      rb = rt;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += RT) perm[i] = ra[i];
}

// rs_block's shared memory over N rows: 2N words, the warps' counts, 2N
// row ids and N ranks
static size_t block_smem(int N) {
  return (size_t)N * (16 + 8 + 2) + RWARPS * BINS * 4;
}

// The control buffer (int64 words, zeroed by the caller): the look-back
// words (T x 256), then as int32 the census ([words, 8, 256]), a ticket
// per pass, the census's done counter, and the pass table.
static int64_t ctl_words(int64_t T, int n_keys) {
  const int64_t ints = (int64_t)n_keys * 8 * BINS + 8 * n_keys + 1 +
                       (int64_t)(sizeof(Pass) / 4) * 8 * n_keys;
  return T * BINS + (ints + 1) / 2;
}

// block_rows > 0: the one-block path over a tile of block_rows (a power of
// two >= n, at most BLOCK_MAX); 0: the radix passes, with keys (2n uint64),
// rows (2n int32) and ctl (ctl_words zeroed int64 words).
extern "C" int sort_launch(int64_t n, int n_keys, const int64_t* key_ptrs,
                           int block_rows, void* perm, void* keys,
                           void* rows, void* ctl, int64_t ctl_len,
                           void* stream) {
  if (n_keys < 1 || n_keys > MAX_KEYS || n < 0 || n >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Words K;
  K.n = n_keys;
  for (int i = 0; i < MAX_KEYS; ++i)
    K.k[i] = i < n_keys ? (const uint64_t*)key_ptrs[i] : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (block_rows > 0) {
    if (block_rows > BLOCK_MAX || block_rows < n ||
        (block_rows & (block_rows - 1)))
      return (int)cudaErrorInvalidValue;
    const size_t smem = block_smem(block_rows);
    if ((err = cudaFuncSetAttribute(
             rs_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess)
      return (int)err;
    rs_block<<<1, RT, smem, s>>>((int)n, block_rows, K, (int32_t*)perm);
    return (int)cudaGetLastError();
  }
  const int64_t T = (n + RTILE - 1) / RTILE;
  if (ctl_len != ctl_words(T, n_keys)) return (int)cudaErrorInvalidValue;
  uint64_t* status = (uint64_t*)ctl;
  int32_t* hist = (int32_t*)(status + T * BINS);
  int32_t* tickets = hist + n_keys * 8 * BINS;
  int32_t* done = tickets + 8 * n_keys;
  Pass* table = (Pass*)(done + 1);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int64_t cblocks = (n + CT * CU - 1) / (CT * CU);
  rs_census<<<(unsigned)(cblocks < 8 * sms ? cblocks : 8 * sms), CT, 0, s>>>(
      n, K, hist, done, table);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = RTILE * 8 + RTILE * 4 + RWARPS * BINS * 4;
  if ((err = cudaFuncSetAttribute(
           rs_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return (int)err;
  const int64_t grid = T < 3 * sms ? T : 3 * sms;
  uint64_t* kb = (uint64_t*)keys;
  int32_t* rb = (int32_t*)rows;
  for (int p = 0; p < 8 * n_keys; ++p) {
    rs_pass<<<(unsigned)grid, RT, smem, s>>>(
        n, p, K, table, hist, kb, kb + n, rb, rb + n, (int32_t*)perm,
        status, tickets, T);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
