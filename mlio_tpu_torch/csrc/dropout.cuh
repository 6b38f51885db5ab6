// The position-hashed dropout of K1's forward (flash_fwd.cuh) that K13b and
// K13c (flash_bwd.cu) regenerate: mlio_tpu/ops/dropmask.py in uint32. The JAX
// int32 products wrap modulo 2^32 and its shifts are logical, which uint32
// arithmetic gives as it is. A probability is kept where drop_u01(query
// position, key position, seed folded with (batch, query head)) >= rate.
#pragma once

#include <stdint.h>

namespace flash {

struct Dropout {
  uint32_t seed;   // the user's seed, as its int32 bit pattern
  float rate;      // drop probability, compared in fp32
  float inv_keep;  // 1 / (1 - rate), rounded to fp32
};

__device__ __forceinline__ uint32_t fold_seed(uint32_t seed, int b, int h) {
  return seed + static_cast<uint32_t>(b) * 131071u + static_cast<uint32_t>(h) * 8191u;
}

__device__ __forceinline__ float drop_u01(uint32_t i, uint32_t j, uint32_t seed) {
  uint32_t h = (i * 0x9E3779B9u) ^ (j * 0x85EBCA6Bu);
  h += seed * 0xC2B2AE35u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return static_cast<float>(h & 0x7FFFFFu) * (1.0f / 8388608.0f);
}

__device__ __forceinline__ bool drop_keep(int row, int col, uint32_t seed, float rate) {
  return drop_u01(static_cast<uint32_t>(row), static_cast<uint32_t>(col), seed) >= rate;
}

// The keep bits of NT 8-column n-tiles of an accumulator in the mma.sync /
// wgmma layout: bit 4n + 2i + e for the element in row r0 + 8i and column
// c0 + 8n + e (c0 = the first column + 2 (lane % 4)). kRowsAreQ: the rows
// are query positions and the columns keys (K1, K13b); otherwise the other
// way round (K13c). The hash always takes (query, key).
template <int NT, bool kRowsAreQ>
__device__ __forceinline__ uint32_t keep_bits(int c0, int r0, uint32_t seed, float rate) {
  static_assert(NT <= 8, "32 bits");
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * i, col = c0 + 8 * n + e;
        bits |= static_cast<uint32_t>(kRowsAreQ ? drop_keep(row, col, seed, rate)
                                                : drop_keep(col, row, seed, rate))
                << (4 * n + 2 * i + e);
      }
  return bits;
}

}  // namespace flash
