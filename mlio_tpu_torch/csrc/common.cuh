// Helpers shared by the port's kernels. Each kernel source includes this
// header once and is built on its own into a shared library with a plain C
// interface (mlio_tpu_torch/ops/_build.py); the Python wrappers pass raw
// pointers and the stream, and raise when the returned cudaError_t is not 0.
// The kernels are templates on the element type T but are built for bf16
// only, the one dtype the main path runs; another dtype raises in the
// wrappers until a slice needs it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: what a cast to the input dtype does.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Elements of T in one 16-byte vector access.
template <typename T> struct Vec16 { static constexpr int N = 16 / sizeof(T); };

// 16-byte load of N = 16 / sizeof(T) elements, widened to fp32. p must be
// 16-byte aligned (the wrappers check the base pointers and row widths).
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec16<T>::N]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& raw, float (&out)[Vec16<T>::N]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[Vec16<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) e[i] = from_f32<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Eight int8 values (one 8-byte load, element j in byte j % 4 of word j / 4)
// sign-extended to fp32 in registers.
__device__ __forceinline__ void unpack_i8x8(const uint2& raw, float (&out)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = static_cast<float>(static_cast<int>(raw.x << (24 - 8 * j)) >> 24);
    out[4 + j] = static_cast<float>(static_cast<int>(raw.y << (24 - 8 * j)) >> 24);
  }
}

// 8 elements of a K/V cache row, the unit a lane loads: 16 bytes of a 16-bit
// type or 8 bytes of int8 (one 8-byte load of int8 covers the same 8
// elements as a bf16 cache's 16-byte load, so lane layouts stay the same).
template <typename E>
using Raw8 = std::conditional_t<std::is_same<E, int8_t>::value, uint2, uint4>;

template <typename E>
__device__ __forceinline__ void unpack8(const Raw8<E>& raw, float (&out)[8]) {
  if constexpr (std::is_same<E, int8_t>::value) unpack_i8x8(raw, out);
  else unpack_vec<E>(raw, out);
}

template <typename E>
__device__ __forceinline__ Raw8<E> zero8() {
  Raw8<E> r;
  if constexpr (std::is_same<E, int8_t>::value) r = make_uint2(0, 0);
  else r = make_uint4(0, 0, 0, 0);
  return r;
}

// Message for an error code the C entry points return.
extern "C" const char* mlio_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
