// hash64 — composite-key hashing on the device.
//
// Replaces the device side of ydb_tpu/utils/hashing.py (splitmix64 and
// hash_combine, lowered by ydb_tpu/ops/kernels.py's hash64 and
// hash_combine): h = hash_combine(f(c0), f(c1), ...), folded from the
// left, where f is the splitmix64 finalizer for a column marked `pre` and
// the identity otherwise (a column that is already a hash). All
// arithmetic is unsigned 64-bit: shifts are logical, products wrap. The
// result equals the host's numpy hashing bit for bit, which the join
// build side uses (query/executor.py _add_hash_column).
// Bound on the H100: bytes. One thread per row reads 8 bytes per column
// and writes 8; three multiplies and a few shifts per column are far
// below the integer rate.
// Design: one elementwise launch for the whole expression (TPC-H q9's
// hash_combine(hash64(ps_partkey), hash64(ps_suppkey)) over lineitem is
// one pass, where a plain torch lowering makes one per operator), with
// coalesced loads and stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash64.cuh"

#define MAX_COLS 16

struct Cols {
  int n;
  const uint64_t* c[MAX_COLS];
  int pre[MAX_COLS];
};

__global__ void hash64_kernel(int64_t n, Cols C, uint64_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t h = 0;
  for (int j = 0; j < C.n; ++j) {
    uint64_t x = C.c[j][i];
    if (C.pre[j]) x = splitmix64(x);
    h = j == 0 ? x : hash_combine(h, x);
  }
  out[i] = h;
}

extern "C" int hash64_launch(int64_t n, int n_cols, const int64_t* col_ptrs,
                             const int32_t* pre, void* out, void* stream) {
  if (n_cols < 1 || n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Cols C;
  C.n = n_cols;
  for (int j = 0; j < MAX_COLS; ++j) {
    C.c[j] = j < n_cols ? (const uint64_t*)col_ptrs[j] : nullptr;
    C.pre[j] = j < n_cols ? pre[j] : 0;
  }
  const int threads = 256;
  hash64_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  (cudaStream_t)stream>>>(n, C, (uint64_t*)out);
  return (int)cudaGetLastError();
}
