// Shared helpers of the repro_torch CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Finite mask value, as in the reference kernels: with -inf a row that meets
// a tile in which every key is masked while its running max is still unset
// would compute exp(-inf - -inf) = NaN; with -1e30 it adds exp(0) terms that
// the next tile's alpha = exp(-1e30 - m) = 0 wipes out.
constexpr float NEG_INF = -1e30f;

enum DType { DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_I32 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
