// probe — broadcast-join probe of a key column against a build table.
//
// Replaces ydb_tpu/ops/join.py:probe_lut_traced with bsearch_traced and
// _select_and_gather: a direct-address LUT lookup (integral keys with a
// bounded span) or a branchless lower_bound over power-of-two padded
// sorted keys; the inner / left / left_semi / left_anti / mark selection
// with the NOT IN three-valued rule; and, when payloads are not
// late-materialized, the payload gathers.
// Bound on the H100: bytes. One thread per probe row reads its key,
// validity and selection and writes found, the clipped build row id and
// the new selection (plus one gathered element per payload column). The
// LUT (200,000 keys of part at SF1 = 1 MB of int32) and the sorted keys
// stay in L2, so the random lookups cost latency, not device bandwidth.
// Design: no shared memory and no cross-thread work; loads and stores of
// the probe side are coalesced, and the bsearch path does the same
// log2(cap) unconditional steps as the reference so it lands on the
// same index for every key, sentinel padding included.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PAYLOADS 16

enum { K_INNER = 0, K_LEFT = 1, K_SEMI = 2, K_ANTI = 3, K_MARK = 4 };

struct Payloads {
  int n;
  const void* src[MAX_PAYLOADS];
  void* dst[MAX_PAYLOADS];
  const uint8_t* pvalid[MAX_PAYLOADS];   // null = all valid
  uint8_t* dvalid[MAX_PAYLOADS];
  int size[MAX_PAYLOADS];
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

template <typename T>
__device__ __forceinline__ int64_t lower_bound_pow2(const T* keys,
                                                    int64_t kcap, T e) {
  int64_t pos = 0;
  for (int64_t step = kcap >> 1; step > 0; step >>= 1) {
    const T kv = keys[pos + step - 1];
    if (kv < e) pos += step;
  }
  return pos;
}

__global__ void probe_kernel(int64_t n, const void* key, int key_f64,
                             const uint8_t* kvalid, const uint8_t* sel,
                             int bsearch, const int32_t* lut, int64_t span,
                             int64_t lut_base, const void* keys_sorted,
                             int64_t kcap, int64_t n_build, int64_t pcap,
                             int kind, int not_in, int has_null,
                             uint8_t* found_out, int32_t* safe_out,
                             uint8_t* sel_out, Payloads P) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const bool active = sel[r] != 0;
  const bool v = kvalid == nullptr || kvalid[r] != 0;
  const bool matchable = active && v;
  int64_t idx;
  bool found;
  if (bsearch) {
    int64_t pos;
    bool eq;
    if (key_f64) {
      const double e = ((const double*)key)[r];
      const double* ks = (const double*)keys_sorted;
      pos = lower_bound_pow2(ks, kcap, e);
      idx = pos < 0 ? 0 : (pos > kcap - 1 ? kcap - 1 : pos);
      eq = ks[idx] == e;
    } else {
      const int64_t e = ((const int64_t*)key)[r];
      const int64_t* ks = (const int64_t*)keys_sorted;
      pos = lower_bound_pow2(ks, kcap, e);
      idx = pos < 0 ? 0 : (pos > kcap - 1 ? kcap - 1 : pos);
      eq = ks[idx] == e;
    }
    found = eq && matchable && idx < n_build;
  } else {
    const int64_t e = ((const int64_t*)key)[r];
    const int64_t off = (int64_t)((uint64_t)e - (uint64_t)lut_base);
    const bool inb = off >= 0 && off < span;
    const int64_t c = off < 0 ? 0 : (off > span - 1 ? span - 1 : off);
    idx = lut[c];
    found = inb && idx >= 0 && matchable;
  }
  const int64_t safe = idx < 0 ? 0 : (idx > pcap - 1 ? pcap - 1 : idx);
  bool o;
  if (kind == K_INNER || kind == K_SEMI) o = found;
  else if (kind == K_ANTI) o = !found && active;
  else o = active;
  if (kind == K_ANTI && not_in) {
    if (kvalid != nullptr) o = o && (v || n_build == 0);
    if (has_null) o = false;
  }
  found_out[r] = found;
  safe_out[r] = (int32_t)safe;
  sel_out[r] = o;
  for (int p = 0; p < P.n; ++p) {
    copy_elem(P.src[p], P.dst[p], P.size[p], safe, r);
    P.dvalid[p][r] = found && (P.pvalid[p] == nullptr || P.pvalid[p][safe]);
  }
}

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
                            void* stream) {
  if (n_payloads < 0 || n_payloads > MAX_PAYLOADS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
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
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      n, key, key_f64, (const uint8_t*)kvalid, (const uint8_t*)sel, bsearch,
      (const int32_t*)lut, span, lut_base, keys_sorted, kcap, n_build, pcap,
      kind, not_in, has_null, (uint8_t*)found_out, (int32_t*)safe_out,
      (uint8_t*)sel_out, P);
  return (int)cudaGetLastError();
}
