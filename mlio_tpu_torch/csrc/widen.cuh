// Weight loads into registers and their widening to fp32: the inner loop
// that K6 (decode_tiled.cuh) streamed its GEMV weights through before it
// moved to the tensor cores, kept for K15 (fp8_convert.cu), which measures
// what that widening costs. frag_pair, at the end, is K6's widening into
// mma.sync fragments.
//
// Formats (FMT): 0 bf16; 1 int8 (a shift pair and a convert a weight);
// 2 fp8 e4m3, two at a time by the card's e4m3x2 -> f16x2 convert (K6's);
// 3 fp8 e4m3 one at a time through the fp8 type's float conversion; 4 fp8
// e4m3 by integer bit assembly into an fp32 (right for zero and the normals;
// a subnormal byte is read as a normal with a zero exponent field, as
// exp_fp8_convert.py's bit assembly reads it). Every bf16, int8 and e4m3
// value is a bf16 and a float, so each widening is exact and equals a cast to
// bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ float2 fp8x2(unsigned short v) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(v, __NV_E4M3);
  return __half22float2(*reinterpret_cast<const __half2*>(&hr));
}

// One e4m3 byte as fp32 through the fp8 type's conversion.
__device__ __forceinline__ float fp8_f32(unsigned byte) {
  __nv_fp8_e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(f);
}

// One e4m3 byte as fp32 by bit assembly: sign, then exponent and mantissa
// re-biased (7 -> 127: + 120 << 3 on the 7-bit field) into fp32's fields.
__device__ __forceinline__ float fp8_bits(unsigned byte) {
  const unsigned rest = byte & 0x7fu;
  return __uint_as_float(rest == 0 ? 0u : ((byte & 0x80u) << 24) | ((rest + 960u) << 20));
}

// The 32-bit word j of a weight load.
__device__ __forceinline__ unsigned word(const uint4& r, int j) {
  return j == 0 ? r.x : (j == 1 ? r.y : (j == 2 ? r.z : r.w));
}
__device__ __forceinline__ unsigned word(const uint2& r, int j) { return j == 0 ? r.x : r.y; }
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }
__device__ __forceinline__ unsigned word(unsigned short r, int) { return r; }

// CPT consecutive weights of format FMT from one register load, widened to
// fp32.
template <int FMT, int CPT, class R>
__device__ __forceinline__ void unpack_w(const R& r, float (&w)[CPT]) {
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    if constexpr (FMT == 0) {
      const unsigned wd = word(r, i / 2);
      w[i] = __uint_as_float(i % 2 ? (wd & 0xffff0000u) : (wd << 16));
    } else if constexpr (FMT == 1) {
      const unsigned wd = word(r, i / 4);
      w[i] = static_cast<float>(static_cast<int>(wd << (24 - 8 * (i % 4))) >> 24);
    } else if constexpr (FMT == 2) {
      if (i % 2 == 0) {
        const unsigned wd = word(r, i / 4);
        const float2 f = fp8x2(static_cast<unsigned short>((i / 2) % 2 ? wd >> 16 : wd & 0xffffu));
        w[i] = f.x;
        w[i + 1] = f.y;
      }
    } else {
      const unsigned byte = (word(r, i / 4) >> (8 * (i % 4))) & 0xffu;
      w[i] = FMT == 3 ? fp8_f32(byte) : fp8_bits(byte);
    }
  }
}

// CPT weights of format FMT as one register load: 2, 4, 8 or 16 bytes.
template <int FMT, int CPT>
struct WRaw {
  static constexpr int kBytes = CPT * (FMT == 0 ? 2 : 1);
  using T = std::conditional_t<kBytes == 16, uint4,
            std::conditional_t<kBytes == 8, uint2,
            std::conditional_t<kBytes == 4, unsigned, unsigned short>>>;
};

// K6's widening into tensor-core fragments: bytes P and P + 2 of a 32-bit
// word of int8 (FMT 1) or e4m3 (FMT 2) weights (one column at two k rows, as
// ldmatrix.trans over bytes hands them over) as a bf16x2, byte P in the low
// half. Exact: every int8 and e4m3 value is a bf16. int8: the byte, offset
// to unsigned, becomes the low mantissa of 2^23 and the float sum removes
// the offset (an integer of at most 8 bits, so the top half of the float is
// its bf16); e4m3: the card's e4m3x2 -> f16x2 convert, then bf16x2.
template <int FMT, int P>
__device__ __forceinline__ uint32_t frag_pair(uint32_t w) {
  static_assert(FMT == 1 || FMT == 2, "int8 or e4m3 bytes");
  if constexpr (FMT == 1) {
    const uint32_t x = w ^ 0x80808080u;
    const float lo = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + P)) - 8388736.f;
    const float hi = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442 + P)) - 8388736.f;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  } else {
    const float2 f = fp8x2(static_cast<unsigned short>(__byte_perm(w, 0u, 0x20 + 0x11 * P)));
    __nv_bfloat162 v = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}
