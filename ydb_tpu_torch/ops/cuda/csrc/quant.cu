// quant — the int8 block codec of the DQ channel plane's quantized
// columns (per-block symmetric int8 codes with one float32 scale per
// 128 values; NaN rides as the reserved code -128).
//
// Replaces ydb_tpu/parallel/collective.py:160 quantize_blocked and :176
// dequantize_blocked. The values are a flat array whose length is a
// multiple of 128 (the [ndev, seg] send stacks, seg a multiple of 128);
// block b is values [128 b, 128 b + 128).
//
// quantize, per block, in the input's type T (double or float):
//   mag   = max |x| over the block's non-NaN values (inf included)
//   scale = (float)(mag > 0 ? mag / 127 : 1)        (the division in T)
//   q     = rint(x / (T)scale), clipped to [-127, 127]
//   code  = -128 where x is NaN; 0 where q is NaN (x = +-inf over an
//           inf scale: XLA's float -> int8 conversion gives 0 there);
//           else (int8)q
// rint rounds half to even, as jnp.round does; the divisions are IEEE
// (nvcc's default -prec-div=true), so codes and scales equal the
// reference bit for bit.
// dequantize: x = (T)code * (T)scale, NaN where code == -128.
//
// Bound on the H100: bytes. quantize reads each value once (8 or 4
// bytes) and writes its code (1 byte) and 4 bytes per 128 values;
// dequantize the reverse. There are a few operations per value.
// Design: one 128-thread block per 128-value quant block, one value per
// thread (coalesced loads), the max-abs reduced with warp shuffles and
// four shared slots; thread 0 writes the scale. dequantize is a flat
// elementwise pass (a thread per value, its scale read through the
// cache).
#include <cuda_runtime.h>
#include <stdint.h>

#define QBLOCK 128

template <typename T>
__device__ __forceinline__ T rint_t(T x);
template <>
__device__ __forceinline__ double rint_t<double>(double x) { return rint(x); }
template <>
__device__ __forceinline__ float rint_t<float>(float x) { return rintf(x); }

template <typename T>
__global__ void quantize_kernel(const T* x, int8_t* codes, float* scales) {
  __shared__ T wmax[QBLOCK / 32];
  const int64_t i = (int64_t)blockIdx.x * QBLOCK + threadIdx.x;
  const T v = x[i];
  const bool nan = v != v;
  T a = nan ? (T)0 : (v < (T)0 ? -v : v);
  for (int o = 16; o > 0; o >>= 1) {
    const T b = __shfl_xor_sync(0xffffffffu, a, o);
    a = b > a ? b : a;
  }
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = a;
  __syncthreads();
  T mag = wmax[0];
  for (int w = 1; w < QBLOCK / 32; ++w) mag = wmax[w] > mag ? wmax[w] : mag;
  const float scale = (float)(mag > (T)0 ? mag / (T)127 : (T)1);
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
  const T q = rint_t<T>(v / (T)scale);
  int8_t c;
  if (nan)
    c = -128;
  else if (q != q)
    c = 0;
  else
    c = (int8_t)(q < (T)-127 ? (T)-127 : (q > (T)127 ? (T)127 : q));
  codes[i] = c;
}

template <typename T>
__global__ void dequantize_kernel(int64_t n, const int8_t* codes,
                                  const float* scales, T* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int8_t c = codes[i];
  const T s = (T)scales[i / QBLOCK];
  out[i] = c == -128 ? (T)NAN : (T)c * s;
}

// dtype: 0 float64, 1 float32. n is a multiple of QBLOCK.
extern "C" int quantize_blocked_launch(int64_t n, int dtype, const void* x,
                                       int8_t* codes, float* scales,
                                       void* stream) {
  if (n % QBLOCK != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t nblocks = n / QBLOCK;
  if (nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    quantize_kernel<double><<<(unsigned)nblocks, QBLOCK, 0, s>>>(
        (const double*)x, codes, scales);
  else
    quantize_kernel<float><<<(unsigned)nblocks, QBLOCK, 0, s>>>(
        (const float*)x, codes, scales);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_blocked_launch(int64_t n, int dtype,
                                         const int8_t* codes,
                                         const float* scales, void* out,
                                         void* stream) {
  if (n % QBLOCK != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t grid = (n + threads - 1) / threads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    dequantize_kernel<double><<<(unsigned)grid, threads, 0, s>>>(
        n, codes, scales, (double*)out);
  else
    dequantize_kernel<float><<<(unsigned)grid, threads, 0, s>>>(
        n, codes, scales, (float*)out);
  return (int)cudaGetLastError();
}
