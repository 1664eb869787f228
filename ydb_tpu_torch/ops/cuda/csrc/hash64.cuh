// hash64 device functions — the one device definition of
// ydb_tpu/utils/hashing.py's splitmix64 finalizer and hash_combine, for
// every kernel that hashes (hash64.cu, segments.cu). All arithmetic is
// unsigned 64-bit: shifts are logical, products and sums wrap.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint64_t splitmix64(uint64_t u) {
  u = (u ^ (u >> 30)) * 0xBF58476D1CE4E5B9ull;
  u = (u ^ (u >> 27)) * 0x94D049BB133111EBull;
  return u ^ (u >> 31);
}

__device__ __forceinline__ uint64_t hash_combine(uint64_t h, uint64_t x) {
  return h ^ (x + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2));
}
