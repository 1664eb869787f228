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
// dequantize the reverse. What holds quantize above its bound is not
// measured: more loads in flight, other grids, more quant blocks a warp
// and other load hints made it no faster (PERF.md, K15d).
// Design of quantize:
// - one warp a quant block, 4 values a lane: float32 in one 16-byte load
//   (lane l values 4l..4l+3), float64 in two (lane l values 2l, 2l+1 and
//   64+2l, 65+2l), each load a run of whole lines across the warp;
// - no shared memory and no `__syncthreads`: the NaN-masked max-abs in 5
//   xor shuffles (fmax, which passes over a NaN); every lane makes the
//   scale (the IEEE mag / 127 in T), lane 0 stores it;
// - a lane's 4 codes packed into one 32-bit store (float64 lanes trade
//   their code pairs by 2 shuffles first), so a warp writes its block's
//   128 codes as one 128-byte line;
// - a persistent grid (QSM64 / QSM32 blocks of QWARPS warps an SM)
//   walks the quant blocks, each warp issuing the next block's loads
//   before the current block's reduction and divisions;
// - the divisions stay the IEEE quotient (nvcc's default -prec-div=true;
//   a reciprocal product is not bit-equal to the reference), rint rounds
//   half to even, and NaN, +-inf and all-zero blocks keep their codes.
// The launcher refuses an input, codes or scales pointer that the vector
// accesses cannot take (x 16 bytes, codes and scales 4).
// dequantize is a flat elementwise pass (a thread per value, its scale
// read through the cache).
#include <cuda_runtime.h>
#include <stdint.h>

#define QBLOCK 128
#define QWARPS 8               // warps a CUDA block, a quant block each
#define QSM64 5                // float64: resident CUDA blocks an SM
#define QSM32 8                // float32: resident CUDA blocks an SM

template <typename T>
__device__ __forceinline__ T rint_t(T x);
template <>
__device__ __forceinline__ double rint_t<double>(double x) { return rint(x); }
template <>
__device__ __forceinline__ float rint_t<float>(float x) { return rintf(x); }

__device__ __forceinline__ double max_abs(double a, double v) {
  return fmax(a, fabs(v));
}
__device__ __forceinline__ float max_abs(float a, float v) {
  return fmaxf(a, fabsf(v));
}

// a lane's 4 values of quant block b (layouts above)
__device__ __forceinline__ void qload(const double* x, int64_t b, int lane,
                                      double v[4]) {
  const double2* p = (const double2*)(x + b * QBLOCK);
  const double2 lo = __ldcs(p + lane), hi = __ldcs(p + 32 + lane);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void qload(const float* x, int64_t b, int lane,
                                      float v[4]) {
  const float4 q = __ldcs((const float4*)(x + b * QBLOCK) + lane);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// A zero never reaches a division: its code is 0 whatever the scale (0
// over a finite or infinite scale is 0, over a zero scale NaN, code 0).
// A zero dividend sends the IEEE division to its slow path (a called
// routine), and zeros are most of a send stack: the segments' tails.
template <typename T>
__device__ __forceinline__ uint32_t code_of(T v, T scale) {
  if (v == (T)0) return 0;
  const T q = rint_t<T>(v / scale);
  int8_t c;
  if (v != v)
    c = -128;
  else if (q != q)
    c = 0;
  else
    c = (int8_t)(q < (T)-127 ? (T)-127 : (q > (T)127 ? (T)127 : q));
  return (uint32_t)(uint8_t)c;
}

// the codes of lane l's values in the byte order of codes 4l..4l+3
__device__ __forceinline__ uint32_t code_word(const double v[4], double s,
                                              int lane) {
  const uint32_t c = code_of(v[0], s) | code_of(v[1], s) << 8 |
                     code_of(v[2], s) << 16 | code_of(v[3], s) << 24;
  // codes 4l..4l+3 are lane 2l's and 2l+1's first pairs (l < 16) or
  // lane 2l-32's and 2l-31's second pairs
  const uint32_t u = __shfl_sync(0xffffffffu, c, (2 * lane) & 31);
  const uint32_t w = __shfl_sync(0xffffffffu, c, (2 * lane + 1) & 31);
  return lane < 16 ? (u & 0xffffu) | (w << 16)
                   : (u >> 16) | (w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t code_word(const float v[4], float s,
                                              int lane) {
  return code_of(v[0], s) | code_of(v[1], s) << 8 |
         code_of(v[2], s) << 16 | code_of(v[3], s) << 24;
}

template <typename T>
__device__ __forceinline__ void quantize_one(const T v[4], int64_t b,
                                             int lane, uint32_t* codes,
                                             float* scales) {
  // the max-abs of the non-NaN values: fmax returns the other operand
  // of a NaN, and the lanes' partials are never NaN
  T a = (T)0;
#pragma unroll
  for (int i = 0; i < 4; ++i) a = max_abs(a, v[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = max_abs(a, __shfl_xor_sync(0xffffffffu, a, o));
  // mag / 127, or 1 for an all-zero block: 127 / 127, so that no zero
  // dividend takes the division's slow path
  const float scale = (float)((a > (T)0 ? a : (T)127) / (T)127);
  if (lane == 0) scales[b] = scale;
  codes[b * (QBLOCK / 4) + lane] = code_word(v, (T)scale, lane);
}

// BPS CUDA blocks an SM
template <typename T, int BPS>
__global__ void __launch_bounds__(QWARPS * 32, BPS)
    quantize_kernel(int64_t nblocks, const T* x, uint32_t* codes,
                    float* scales) {
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * QWARPS;
  int64_t b = (int64_t)blockIdx.x * QWARPS + (threadIdx.x >> 5);
  T v[4];
  if (b < nblocks) qload(x, b, lane, v);
  for (; b < nblocks; b += step) {
    T w[4];
    if (b + step < nblocks) qload(x, b + step, lane, w);   // in flight
    quantize_one(v, b, lane, codes, scales);               // meanwhile
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = w[i];
  }
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

// the persistent grid: a quant block a warp, at most bps blocks an SM
static unsigned qgrid(int64_t nblocks, int bps, int sms) {
  const int64_t want = (nblocks + QWARPS - 1) / QWARPS;
  return (unsigned)(want < (int64_t)bps * sms ? want : (int64_t)bps * sms);
}

// dtype: 0 float64, 1 float32. n is a multiple of QBLOCK.
extern "C" int quantize_blocked_launch(int64_t n, int dtype, const void* x,
                                       int8_t* codes, float* scales,
                                       void* stream) {
  if (n % QBLOCK != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if ((uintptr_t)x % 16 || (uintptr_t)codes % 4 || (uintptr_t)scales % 4)
    return (int)cudaErrorMisalignedAddress;
  const int64_t nblocks = n / QBLOCK;
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    quantize_kernel<double, QSM64>
        <<<qgrid(nblocks, QSM64, sms), QWARPS * 32, 0, s>>>(
            nblocks, (const double*)x, (uint32_t*)codes, scales);
  else
    quantize_kernel<float, QSM32>
        <<<qgrid(nblocks, QSM32, sms), QWARPS * 32, 0, s>>>(
            nblocks, (const float*)x, (uint32_t*)codes, scales);
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
