// The cp.async pieces of the shared-memory rings of K1 and K13a
// (flash_fwd.cuh), K13b/K13c (flash_bwd.cu) and K12's shapes off the TMA
// path (ln_matmul.cu): 16- and 4-byte asynchronous copies from device to
// shared memory with zero fill, and their commit groups.
//
// cp.async groups are counted per thread: cp.async.wait_group N makes a
// thread's own copies of all but its N newest groups visible to that thread,
// and a block barrier after it makes them visible to the block. A ring stays
// correct only if every thread commits the same groups, copies or not.
#pragma once

#include "gemm_tile.cuh"

namespace gemm {

// 16 bytes from global to shared memory, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes from global to shared memory, or 4 zero bytes where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace gemm
