// Storage types of the per-observation W blocks (27, n): float, bf16 or f16
// (the JAX package's `facto_dtype`). Every kernel that reads or writes W is
// a template on the storage type T and does its arithmetic and
// accumulation in float; only the load widens and only the store narrows
// (round to nearest even, as the JAX package's astype).
//
// A C entry point takes the storage as a dtype code, `ops/_cuda.py:W_CODES`
// (0 float32, 1 bfloat16, 2 float16), and launches the matching
// instantiation through ba_with_w_type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

__device__ __forceinline__ float ba_ldw(const float* __restrict__ p,
                                        long long i) {
  return p[i];
}
__device__ __forceinline__ float ba_ldw(const __nv_bfloat16* __restrict__ p,
                                        long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ba_ldw(const __half* __restrict__ p,
                                        long long i) {
  return __half2float(p[i]);
}

__device__ __forceinline__ void ba_stw(float* __restrict__ p, long long i,
                                       float v) {
  p[i] = v;
}
__device__ __forceinline__ void ba_stw(__nv_bfloat16* __restrict__ p,
                                       long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void ba_stw(__half* __restrict__ p, long long i,
                                       float v) {
  p[i] = __float2half_rn(v);
}

// v as a reader of W stored in T sees it (ba_stw, then ba_ldw): for a
// kernel that re-derives W in place of reading it.
template <class T>
__device__ __forceinline__ float ba_w_as_stored(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(v));
  } else {
    return v;
  }
}

// f(static_cast<T*>(nullptr)) for the storage type T of ``code``; an
// unknown code is cudaErrorInvalidValue. Inside f, the type is
//   using T = std::remove_pointer_t<decltype(tag)>;
template <class F>
int ba_with_w_type(int code, F&& f) {
  switch (code) {
    case 0:
      return f(static_cast<float*>(nullptr));
    case 1:
      return f(static_cast<__nv_bfloat16*>(nullptr));
    case 2:
      return f(static_cast<__half*>(nullptr));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define BA_W_TYPE(tag) std::remove_pointer_t<decltype(tag)>
