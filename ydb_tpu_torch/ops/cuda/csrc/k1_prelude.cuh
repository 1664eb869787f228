// k1_prelude.cuh — the fixed device helpers of K1's generated kernels.
//
// K1 (ops/k1.py) turns each expression stage of a program (a run of
// Assign and Filter commands) into one CUDA C++ kernel: one thread per
// row reads each input column once, evaluates the whole stage in
// registers and writes each output once. The generator prepends this
// file's text to every body it emits. The helpers reproduce, bit for
// bit, what the plain version (torch over ops/kernels.py) computes:
//   - integer arithmetic wraps (two's complement), as torch's does;
//   - `//` and `%` are floor division and modulo (torch's
//     div_floor_integer / div_floor_floating and remainder), where C's
//     `/` and `%` truncate toward zero;
//   - civil_from_days runs on int64 with floor division, as
//     kernels.py _civil does;
//   - splitmix64 and hash_combine are utils/hashing.py's, on uint64 bits.
//
// The same text compiles three ways: by NVRTC for sm_90a (__CUDACC_RTC__),
// by nvcc (__CUDACC__), and by a host C++ compiler, where the row function
// runs in a plain loop (the CPU tests hold the generator's semantics that
// way). K1_DEV marks every helper. Nothing here includes a header under
// NVRTC: it has the CUDA math functions built in.

#if defined(__CUDACC_RTC__) || defined(__CUDACC__)
#define K1_DEVICE 1
#define K1_DEV __device__ __forceinline__
#else
#include <cmath>
#include <cstring>
#define K1_DEV static inline
using std::ceil;
using std::exp;
using std::floor;
using std::fmod;
using std::log;
using std::pow;
using std::sqrt;
#endif

typedef bool k1_b;
typedef signed char k1_i8;
typedef short k1_i16;
typedef int k1_i32;
typedef long long k1_i64;
typedef unsigned char k1_u8;
typedef float k1_f32;
typedef double k1_f64;
typedef unsigned long long k1_u64;

// -- literals of a float type, from their bits ------------------------------

K1_DEV k1_f64 k1_f64_bits(k1_u64 b) {
#ifdef K1_DEVICE
  return __longlong_as_double((long long)b);
#else
  k1_f64 x;
  std::memcpy(&x, &b, sizeof x);
  return x;
#endif
}

K1_DEV k1_f32 k1_f32_bits(unsigned int b) {
#ifdef K1_DEVICE
  return __int_as_float((int)b);
#else
  k1_f32 x;
  std::memcpy(&x, &b, sizeof x);
  return x;
#endif
}

// -- wrapping integer arithmetic (unsigned, then back) ---------------------

#define K1_WRAP_INT(T, U)                                                    \
  K1_DEV T k1_add(T a, T b) { return (T)((U)a + (U)b); }                     \
  K1_DEV T k1_sub(T a, T b) { return (T)((U)a - (U)b); }                     \
  K1_DEV T k1_mul(T a, T b) { return (T)((U)a * (U)b); }                     \
  K1_DEV T k1_neg(T a) { return (T)((U)0 - (U)a); }                          \
  K1_DEV T k1_abs(T a) { return a < 0 ? (T)((U)0 - (U)a) : a; }

K1_WRAP_INT(k1_i8, unsigned int)
K1_WRAP_INT(k1_i16, unsigned int)
K1_WRAP_INT(k1_i32, unsigned int)
K1_WRAP_INT(k1_i64, k1_u64)

K1_DEV k1_u8 k1_add(k1_u8 a, k1_u8 b) { return (k1_u8)(a + b); }
K1_DEV k1_u8 k1_sub(k1_u8 a, k1_u8 b) { return (k1_u8)(a - b); }
K1_DEV k1_u8 k1_mul(k1_u8 a, k1_u8 b) { return (k1_u8)((unsigned)a * b); }
K1_DEV k1_u8 k1_neg(k1_u8 a) { return (k1_u8)(0u - a); }
K1_DEV k1_u8 k1_abs(k1_u8 a) { return a; }

// bool + bool and bool * bool are torch's logical or / and
K1_DEV k1_b k1_add(k1_b a, k1_b b) { return a || b; }
K1_DEV k1_b k1_mul(k1_b a, k1_b b) { return a && b; }

#define K1_FLOAT_ARITH(T, FABS)                                              \
  K1_DEV T k1_add(T a, T b) { return a + b; }                                \
  K1_DEV T k1_sub(T a, T b) { return a - b; }                                \
  K1_DEV T k1_mul(T a, T b) { return a * b; }                                \
  K1_DEV T k1_neg(T a) { return -a; }                                        \
  K1_DEV T k1_abs(T a) { return FABS(a); }

K1_FLOAT_ARITH(k1_f32, fabsf)
K1_FLOAT_ARITH(k1_f64, fabs)

// -- floor division and modulo ----------------------------------------------

// torch's div_floor_integer (the divisor is never 0 here: the kernels
// replace a zero divisor by 1 first)
#define K1_FLOORDIV_SIGNED(T, MIN)                                           \
  K1_DEV T k1_floordiv(T a, T b) {                                           \
    if (a == (T)(MIN) && b == (T)-1) return a;                               \
    const T q = (T)(a / b);                                                  \
    const T r = (T)(a % b);                                                  \
    return (r != 0 && ((a < 0) != (b < 0))) ? (T)(q - 1) : q;                \
  }                                                                          \
  K1_DEV T k1_mod(T a, T b) {                                                \
    if (b == (T)-1) return (T)0;                                             \
    T r = (T)(a % b);                                                        \
    if (r != 0 && ((b < 0) != (r < 0))) r = (T)(r + b);                      \
    return r;                                                                \
  }

K1_FLOORDIV_SIGNED(k1_i8, -128)
K1_FLOORDIV_SIGNED(k1_i16, -32768)
K1_FLOORDIV_SIGNED(k1_i32, (-2147483647 - 1))
K1_FLOORDIV_SIGNED(k1_i64, (-9223372036854775807LL - 1))

K1_DEV k1_u8 k1_floordiv(k1_u8 a, k1_u8 b) { return (k1_u8)(a / b); }
K1_DEV k1_u8 k1_mod(k1_u8 a, k1_u8 b) { return (k1_u8)(a % b); }

// torch's div_floor_floating and remainder (fmod, moved to the divisor's
// sign)
#define K1_FLOORDIV_FLOAT(T, FMOD, FLOOR, COPYSIGN)                          \
  K1_DEV T k1_floordiv(T a, T b) {                                           \
    if (b == 0) return a / b;                                                \
    const T md = FMOD(a, b);                                                 \
    T div = (a - md) / b;                                                    \
    if ((md != 0) && (b < 0) != (md < 0)) div -= (T)1;                       \
    T fd;                                                                    \
    if (div != 0) {                                                          \
      fd = FLOOR(div);                                                       \
      if (div - fd > (T)0.5) fd += (T)1;                                     \
    } else {                                                                 \
      fd = COPYSIGN((T)0, a / b);                                            \
    }                                                                        \
    return fd;                                                               \
  }                                                                          \
  K1_DEV T k1_mod(T a, T b) {                                                \
    T md = FMOD(a, b);                                                       \
    if ((md != 0) && ((b < 0) != (md < 0))) md += b;                         \
    return md;                                                               \
  }

K1_FLOORDIV_FLOAT(k1_f32, fmodf, floorf, copysignf)
K1_FLOORDIV_FLOAT(k1_f64, fmod, floor, copysign)

// -- sign, clamp_min, rounding and math -------------------------------------

#define K1_SIGN(T)                                                           \
  K1_DEV T k1_sign(T a) { return (T)((T)(0 < a) - (T)(a < 0)); }
K1_SIGN(k1_i8)
K1_SIGN(k1_i16)
K1_SIGN(k1_i32)
K1_SIGN(k1_i64)
K1_SIGN(k1_f32)
K1_SIGN(k1_f64)
K1_DEV k1_u8 k1_sign(k1_u8 a) { return (k1_u8)(a > 0); }

// torch.clamp_min(x, lo): NaN passes through; on the card torch takes
// ::max (fmax), on the host std::max (the first operand on a tie)
#define K1_CLAMP_MIN_INT(T)                                                  \
  K1_DEV T k1_clamp_min(T v, T lo) { return v < lo ? lo : v; }
K1_CLAMP_MIN_INT(k1_i8)
K1_CLAMP_MIN_INT(k1_i16)
K1_CLAMP_MIN_INT(k1_i32)
K1_CLAMP_MIN_INT(k1_i64)
K1_CLAMP_MIN_INT(k1_u8)
#ifdef K1_DEVICE
K1_DEV k1_f32 k1_clamp_min(k1_f32 v, k1_f32 lo) {
  return v != v ? v : fmaxf(v, lo);
}
K1_DEV k1_f64 k1_clamp_min(k1_f64 v, k1_f64 lo) {
  return v != v ? v : fmax(v, lo);
}
#else
K1_DEV k1_f32 k1_clamp_min(k1_f32 v, k1_f32 lo) { return v < lo ? lo : v; }
K1_DEV k1_f64 k1_clamp_min(k1_f64 v, k1_f64 lo) { return v < lo ? lo : v; }
#endif

K1_DEV k1_f32 k1_floor(k1_f32 a) { return floorf(a); }
K1_DEV k1_f64 k1_floor(k1_f64 a) { return floor(a); }
K1_DEV k1_f32 k1_ceil(k1_f32 a) { return ceilf(a); }
K1_DEV k1_f64 k1_ceil(k1_f64 a) { return ceil(a); }
K1_DEV k1_f32 k1_sqrt(k1_f32 a) { return sqrtf(a); }
K1_DEV k1_f64 k1_sqrt(k1_f64 a) { return sqrt(a); }
K1_DEV k1_f32 k1_exp(k1_f32 a) { return expf(a); }
K1_DEV k1_f64 k1_exp(k1_f64 a) { return exp(a); }
K1_DEV k1_f32 k1_log(k1_f32 a) { return logf(a); }
K1_DEV k1_f64 k1_log(k1_f64 a) { return log(a); }
K1_DEV k1_f32 k1_pow(k1_f32 a, k1_f32 b) { return powf(a, b); }
K1_DEV k1_f64 k1_pow(k1_f64 a, k1_f64 b) { return pow(a, b); }

// torch's integer pow (powi): exponent < 0 gives 0 except for bases 1, -1
#define K1_POWI(T, U, SIGNED)                                                \
  K1_DEV T k1_pow(T a, T b) {                                                \
    if (SIGNED && b < 0) {                                                   \
      if (a == 1) return (T)1;                                               \
      if (a == (T)-1) return (T)((((U)0 - (U)b) & 1) ? -1 : 1);              \
      return (T)0;                                                           \
    }                                                                        \
    U r = 1, x = (U)a;                                                       \
    U e = (U)b;                                                              \
    while (e) {                                                              \
      if (e & 1) r = (U)(r * x);                                             \
      e >>= 1;                                                               \
      x = (U)(x * x);                                                        \
    }                                                                        \
    return (T)r;                                                             \
  }
K1_POWI(k1_i8, unsigned char, 1)
K1_POWI(k1_i16, unsigned short, 1)
K1_POWI(k1_i32, unsigned int, 1)
K1_POWI(k1_i64, k1_u64, 1)
K1_POWI(k1_u8, unsigned char, 0)

// -- dates: Howard Hinnant's civil_from_days, as kernels.py _civil ---------

K1_DEV k1_i64 k1_fdiv64(k1_i64 a, k1_i64 b) { return k1_floordiv(a, b); }

// which: 0 year, 1 month, 2 day of month
K1_DEV k1_i32 k1_civil(k1_i64 days, int which) {
  const k1_i64 z = days + 719468;
  const k1_i64 era = k1_fdiv64(z >= 0 ? z : z - 146096, 146097);
  const k1_i64 doe = z - era * 146097;
  const k1_i64 yoe = k1_fdiv64(doe - k1_fdiv64(doe, 1460)
                               + k1_fdiv64(doe, 36524)
                               - k1_fdiv64(doe, 146096), 365);
  k1_i64 y = yoe + era * 400;
  const k1_i64 doy = doe - (365 * yoe + k1_fdiv64(yoe, 4)
                            - k1_fdiv64(yoe, 100));
  const k1_i64 mp = k1_fdiv64(5 * doy + 2, 153);
  const k1_i64 d = doy - k1_fdiv64(153 * mp + 2, 5) + 1;
  const k1_i64 m = mp < 10 ? mp + 3 : mp - 9;
  y = m <= 2 ? y + 1 : y;
  return (k1_i32)(which == 0 ? y : which == 1 ? m : d);
}

// -- hashing: utils/hashing.py on uint64 bits ------------------------------

K1_DEV k1_i64 k1_splitmix64(k1_i64 x) {
  k1_u64 u = (k1_u64)x;
  u = (u ^ (u >> 30)) * 0xBF58476D1CE4E5B9ull;
  u = (u ^ (u >> 27)) * 0x94D049BB133111EBull;
  return (k1_i64)(u ^ (u >> 31));
}

K1_DEV k1_i64 k1_hash_combine(k1_i64 h, k1_i64 x) {
  const k1_u64 a = (k1_u64)h, b = (k1_u64)x;
  return (k1_i64)(a ^ (b + 0x9E3779B97F4A7C15ull + (a << 6) + (a >> 2)));
}

// -- Kleene logic (kernels.py _and_nv, _or_nv): data and validity ---------

K1_DEV k1_b k1_kleene_and_d(k1_b da, k1_b ta, k1_b db, k1_b tb) {
  return (da || !ta) && (db || !tb);
}
K1_DEV k1_b k1_kleene_and_v(k1_b da, k1_b ta, k1_b db, k1_b tb) {
  return (ta && tb) || (ta && !da) || (tb && !db);
}
K1_DEV k1_b k1_kleene_or_d(k1_b da, k1_b ta, k1_b db, k1_b tb) {
  return (da && ta) || (db && tb);
}
K1_DEV k1_b k1_kleene_or_v(k1_b da, k1_b ta, k1_b db, k1_b tb) {
  return (ta && tb) || (ta && da) || (tb && db);
}
