// Device helpers shared by the decode megakernels, K4 and K8
// (decode_stack.cuh) and K6 (decode_tiled.cuh): the warp sum, the grid-wide
// barrier of a cooperative launch and the MLP activations in the order of
// the wrappers' _ACTIVATIONS.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid-wide barrier: every block is resident (cooperative launch). bar[0]
// counts arrivals, bar[1] is the generation; the last block to arrive resets
// the count and advances the generation. The fences make every write before
// the barrier visible to every block after it.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // A block that waits ~10 s means a barrier was missed: fail the launch
      // rather than hang the card.
      for (long long spins = 0; *gen == g; ++spins) {
        if (spins > (1ll << 28)) __trap();
        __nanosleep(32);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
}

// _ACTIVATIONS order of the wrapper: gelu_new, gelu_tanh, gelu, relu, swiglu, geglu.
__device__ __forceinline__ float activate(int act, float u, float g) {
  switch (act) {
    case 0:
    case 1: return gelu_tanh(u);
    case 2: return 0.5f * u * (1.f + erff(u * 0.7071067811865476f));
    case 3: return fmaxf(u, 0.f);
    case 4: return g / (1.f + expf(-g)) * u;
    default: return gelu_tanh(g) * u;
  }
}

}  // namespace
