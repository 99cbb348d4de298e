// Shared helpers of the repro_torch CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

// Finite mask value, as in the reference kernels: with -inf a row that meets
// a tile in which every key is masked while its running max is still unset
// would compute exp(-inf - -inf) = NaN; with -1e30 it adds exp(0) terms that
// the next tile's alpha = exp(-1e30 - m) = 0 wipes out.
constexpr float NEG_INF = -1e30f;

// `_build.DTYPE_CODES` of the wrappers
enum DType {
  DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_I32 = 2, DTYPE_F16 = 3, DTYPE_I8 = 4,
  DTYPE_U8 = 5, DTYPE_I16 = 6, DTYPE_U16 = 7, DTYPE_U32 = 8, DTYPE_E4M3 = 9,
  DTYPE_E5M2 = 10
};

using fp8_e4m3 = __nv_fp8_e4m3;
using fp8_e5m2 = __nv_fp8_e5m2;
template <typename E>
constexpr bool is_fp8 =
    std::is_same_v<E, fp8_e4m3> || std::is_same_v<E, fp8_e5m2>;

// float -> fp8, rounded to nearest even without saturation, as XLA converts
// (`ref.to_fp8`): past the largest finite value e4m3fn gives NaN (it has no
// infinity: 500.0 -> NaN) and e5m2 gives +-inf. The hardware's cvt.rn of
// sm_89+ rounds to nearest even but only saturates (__NV_SATFINITE; the
// library's __NV_NOSAT is a software path, some ten times slower in the
// triad), so the overflow is set after it: a magnitude that rounds past the
// largest finite value (e4m3fn above 464, whose tie rounds to 448; e5m2 from
// 61440, whose tie rounds to inf). NaN stays NaN.
__device__ __forceinline__ __nv_fp8_storage_t to_fp8(
    float x, __nv_fp8_interpretation_t kind) {
  const __nv_fp8_storage_t r = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, kind);
  const float a = fabsf(x);
  const bool over = kind == __NV_E4M3 ? a > 464.f : a >= 61440.f;
  const unsigned sign = x < 0.f ? 0x80u : 0u;
  return over ? (__nv_fp8_storage_t)(sign | (kind == __NV_E4M3 ? 0x7Fu : 0x7Cu))
              : r;
}

// float -> integer as XLA converts (`ref.to_int`): toward zero, saturated
// at the type's range, NaN -> 0. Taken in double, so that every int32 is
// exact.
template <typename I>
__device__ __forceinline__ I to_int(double x) {
  constexpr int BITS = 8 * (int)sizeof(I);
  constexpr bool SIGNED = std::is_signed_v<I>;
  const double lo = SIGNED ? -ldexp(1.0, BITS - 1) : 0.0;
  const double hi = ldexp(1.0, SIGNED ? BITS - 1 : BITS) - 1.0;
  if (x != x) return 0;
  return (I)(long long)(x <= lo ? lo : x >= hi ? hi : trunc(x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
// every e4m3 and e5m2 value is exact in f16
__device__ __forceinline__ float to_float(fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}
__device__ __forceinline__ float to_float(fp8_e5m2 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E5M2)));
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ fp8_e4m3 from_float<fp8_e4m3>(float x) {
  fp8_e4m3 r;
  r.__x = to_fp8(x, __NV_E4M3);
  return r;
}
template <> __device__ __forceinline__ fp8_e5m2 from_float<fp8_e5m2>(float x) {
  fp8_e5m2 r;
  r.__x = to_fp8(x, __NV_E5M2);
  return r;
}

// N elements loaded as one aligned vector (at most 16 bytes per instruction).
template <typename T, int N>
struct alignas((sizeof(T) * N > 16) ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(x.v[i]);
}

}  // namespace repro

// The wrapper turns a non-zero return of a launch function into an exception
// with this text.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
