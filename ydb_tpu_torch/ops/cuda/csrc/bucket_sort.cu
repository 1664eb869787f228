// bucket_sort — a stable counting sort of row ids by bucket id (K4).
//
// Replaces the comparison sort of the medium-domain group-by lane: the
// reference scatter-reduces by bucket id (ydb_tpu/ops/xla_exec.py:457
// _groupby_medium_domain); the port sorts the rows by bucket id and folds
// each run with segment_agg.cu, which needs the permutation that
// sort_perm([inactive, encode_key(kid)]) gives: the active rows first, in
// (bucket id, row id) order, then the inactive rows. Member form (the
// batched lane's per-member bucket ids): the B·cap rows of a (B, cap)
// layout, ordered by (member, bucket id, row id).
// Bound on the H100: bytes. The least a permutation costs is one read of
// the ids and the activity and one write of the row ids (9 bytes a row);
// an LSD sort moves (key, row id) pairs once per digit pass on top. The
// key space is small (nbuckets <= 65,535; members <= 65,535), so there
// are no comparisons to speak of.
// Design: an LSD counting sort over 8-bit digits of a 32-bit key
// (member << 16 | bucket id; 0xFFFFFFFF for an inactive row, whose digit
// is always the drop bin 256, after every other bin): one pass when
// nbuckets <= 256, two for the bucket id's two bytes, one or two more for
// the member. Each pass is bin_scan.cuh's machinery: (1) per
// 4,096-row tile, per-warp counts of the 257 bins with __match_any_sync,
// written bin-major; (2) an exclusive scan over (bin, tile); (3) each tile
// ranks its rows stably inside shared memory (bins in order, rows in
// order within a bin) and writes them out bin by bin, so a bin's rows of
// a tile land as one contiguous run instead of one scattered word per
// row. The first pass reads the ids and the activity in row order and
// builds the keys; later passes read the previous pass's (key, row id)
// pairs in order; the last pass writes the row ids alone. Counting is
// exact and stable, so the result is bit-equal to the comparison sort's
// active prefix, run after run, and no atomics are involved.
#include "bin_scan.cuh"

#define DROP 256                      // the inactive rows' bin
#define INACTIVE 0xFFFFFFFFu
#define MAX_PASSES 4

struct Src {
  const int32_t* kid;                 // bucket ids, row order
  const uint8_t* active;              // flags, row order
  int64_t cap;                        // rows per member (member form)
  int members;                        // 0: single form
};

__device__ __forceinline__ uint32_t key_of(const Src& s, int64_t r) {
  if (!s.active[r]) return INACTIVE;
  const uint32_t member = s.members ? (uint32_t)(r / s.cap) : 0u;
  return (member << 16) | (uint32_t)s.kid[r];
}

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return key == INACTIVE ? DROP : (int)((key >> shift) & 255u);
}

// row i of the pass's input: its key and its row id
__device__ __forceinline__ void load_row(const Src& s, const uint32_t* kin,
                                         const int32_t* rin, int64_t i,
                                         uint32_t* key, int32_t* row) {
  if (kin == nullptr) {
    *key = key_of(s, i);
    *row = (int32_t)i;
  } else {
    *key = kin[i];
    *row = rin[i];
  }
}

// per-warp counts of the tile's digits (rows w0 + j * 32 + lane, in order)
__device__ __forceinline__ void count_digits(int64_t n, const Src& s,
                                             const uint32_t* kin, int shift,
                                             int* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * TILE_ROWS +
                     (int64_t)warp * WARP_ROWS;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = w0 + j * 32 + lane;
    const bool in = i < n;
    const unsigned act = __ballot_sync(FULL, in);
    if (in) {
      const uint32_t key = kin == nullptr ? key_of(s, i) : kin[i];
      const int d = digit_of(key, shift);
      const unsigned peers = __match_any_sync(act, d);
      if (lane == __ffs(peers) - 1) wcnt[warp * MAX_BINS + d] += __popc(peers);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(THREADS)
bs_hist(int64_t n, Src s, const uint32_t* kin, int shift, int32_t* hist,
        int64_t ntiles) {
  __shared__ int wcnt[WARPS * MAX_BINS];
  zero_counters(wcnt, MAX_BINS);
  __syncthreads();
  count_digits(n, s, kin, shift, wcnt);
  __syncthreads();
  for (int b = threadIdx.x; b < MAX_BINS; b += THREADS) {
    int c = 0;
    for (int w = 0; w < WARPS; ++w) c += wcnt[w * MAX_BINS + b];
    hist[(int64_t)b * ntiles + blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(THREADS)
bs_scatter(int64_t n, Src s, const uint32_t* kin, const int32_t* rin,
           int shift, const int32_t* offs, int64_t ntiles, uint32_t* kout,
           int32_t* rout) {
  __shared__ int wcnt[WARPS * MAX_BINS];
  __shared__ int lstart[MAX_BINS];
  __shared__ int wsum[WARPS];
  __shared__ uint32_t s_key[TILE_ROWS];
  __shared__ int32_t s_row[TILE_ROWS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  zero_counters(wcnt, MAX_BINS);
  __syncthreads();
  count_digits(n, s, kin, shift, wcnt);
  __syncthreads();
  // the tile's count of bin b (thread b; the drop bin by the last thread
  // after the scan), each warp's first local slot per bin, and the bins'
  // local starts: an exclusive scan of bins 0..255 across the block
  int tc = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = wcnt[w * MAX_BINS + threadIdx.x];
    wcnt[w * MAX_BINS + threadIdx.x] = tc;
    tc += c;
  }
  int x = tc;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int start = x - tc;
  for (int w = 0; w < warp; ++w) start += wsum[w];
  lstart[threadIdx.x] = start;
  for (int w = 0; w < WARPS; ++w) wcnt[w * MAX_BINS + threadIdx.x] += start;
  if (threadIdx.x == THREADS - 1) {       // the drop bin, after the rest
    const int base = start + tc;
    lstart[DROP] = base;
    int run = base;
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w * MAX_BINS + DROP];
      wcnt[w * MAX_BINS + DROP] = run;
      run += c;
    }
  }
  __syncthreads();
  // each row to its local slot: its warp's running slot for its bin plus
  // the lanes of the same bin below it
  const int64_t w0 = (int64_t)blockIdx.x * TILE_ROWS +
                     (int64_t)warp * WARP_ROWS;
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = w0 + j * 32 + lane;
    const bool in = i < n;
    const unsigned act = __ballot_sync(FULL, in);
    int d = 0;
    unsigned peers = 0;
    if (in) {
      uint32_t key;
      int32_t row;
      load_row(s, kin, rin, i, &key, &row);
      d = digit_of(key, shift);
      peers = __match_any_sync(act, d);
      const int slot = wcnt[warp * MAX_BINS + d] +
                       __popc(peers & ((1u << lane) - 1u));
      s_key[slot] = key;
      s_row[slot] = row;
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1)
      wcnt[warp * MAX_BINS + d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // out in local order: slot i of bin b goes to the bin's (b, tile)
  // offset plus its place in the bin's local run
  const int64_t t0 = (int64_t)blockIdx.x * TILE_ROWS;
  const int len = (int)(n - t0 < TILE_ROWS ? n - t0 : TILE_ROWS);
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const uint32_t key = s_key[i];
    const int d = digit_of(key, shift);
    const int64_t dst = (int64_t)offs[(int64_t)d * ntiles + blockIdx.x] +
                        (i - lstart[d]);
    rout[dst] = s_row[i];
    if (kout != nullptr) kout[dst] = key;
  }
}

// kid, active: n = members x cap rows (members = 0: the single form);
// perm: int32 (n); ka/ra, kb/rb: (n) uint32 / int32 ping-pong buffers
// (needed when there is more than one pass); hist/offs: 257 x ntiles;
// chunk_sums: one int per 8,192 histogram entries.
extern "C" int bucket_perm_launch(int64_t n, const void* kid, int64_t cap,
                                  const void* active, int nbuckets,
                                  int members, void* perm, void* ka,
                                  void* ra, void* kb, void* rb, void* hist,
                                  void* offs, void* chunk_sums,
                                  void* stream) {
  if (nbuckets < 1 || nbuckets > 65535 || members < 0 || members > 65535 ||
      n >= (int64_t)1 << 31 || (members > 0 && cap * members != n))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  int shifts[MAX_PASSES], np = 0;
  shifts[np++] = 0;
  if (nbuckets > 256) shifts[np++] = 8;
  if (members > 1) shifts[np++] = 16;
  if (members > 256) shifts[np++] = 24;
  Src s;
  s.kid = (const int32_t*)kid;
  s.active = (const uint8_t*)active;
  s.cap = members > 0 ? cap : n;
  s.members = members > 1 ? members : 0;
  const int64_t ntiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const int64_t e = (int64_t)MAX_BINS * ntiles;
  uint32_t* keys[2] = {(uint32_t*)ka, (uint32_t*)kb};
  int32_t* rows[2] = {(int32_t*)ra, (int32_t*)rb};
  cudaError_t err;
  for (int p = 0; p < np; ++p) {
    const uint32_t* kin = p == 0 ? nullptr : keys[(p - 1) & 1];
    const int32_t* rin = p == 0 ? nullptr : rows[(p - 1) & 1];
    const bool last = p == np - 1;
    bs_hist<<<(unsigned)ntiles, THREADS, 0, st>>>(n, s, kin, shifts[p],
                                                   (int32_t*)hist, ntiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = scan_bins(e, (const int32_t*)hist, (int32_t*)offs,
                         (int32_t*)chunk_sums, st)) != cudaSuccess)
      return (int)err;
    bs_scatter<<<(unsigned)ntiles, THREADS, 0, st>>>(
        n, s, kin, rin, shifts[p], (const int32_t*)offs, ntiles,
        last ? nullptr : keys[p & 1],
        last ? (int32_t*)perm : rows[p & 1]);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
