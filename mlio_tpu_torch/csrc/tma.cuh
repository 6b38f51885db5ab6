// Hopper's Tensor Memory Accelerator for K12 (ln_matmul.cu) and for K5 and
// K11 (gemm_wgmma.cuh): 2-D tile copies from device memory into shared
// memory, bf16 tiles in wgmma.cuh's 128-byte swizzled layout and byte tiles
// (K5's quantised weights) row by row, whose completion a shared-memory
// barrier (mbarrier) counts in bytes. One thread asks for a whole tile; the hardware computes the
// addresses, swizzles the 16-byte chunks and fills what lies out of bounds
// with zeros, so the copy costs the other threads no instructions.
//
// A tensor map (CUtensorMap) describes the global tensor; it is built on the
// host by the driver's cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint (the libraries link no libcuda), and passed to the
// kernel as a __grid_constant__ parameter.
#pragma once

#include <cuda.h>

#include "gemm_tile.cuh"

namespace tma {

// A barrier waited for by phase: init with one arrival a phase; the thread
// that starts a tile's copies arrives with the bytes they will deliver.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(gemm::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   gemm::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(gemm::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The device's nanosecond clock (%globaltimer).
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// bar_wait for K5 and K11, whose rings run long streams of tiles: a wait of
// 2 s means a copy that never comes (its bytes miscounted), so the launch
// fails rather than hang the card.
__device__ __forceinline__ void bar_wait_bounded(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(gemm::smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) start = now_ns();
    else if ((spins & 255) == 0 && now_ns() - start > 2000000000ull) __trap();
  }
}

// The box of map at (column c, row r) into dst (1 KB aligned), counted on bar.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map, int c, int r,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(gemm::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(gemm::smem_addr(bar))
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &q) == cudaSuccess &&
                    q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A map of a row-major bf16 matrix [rows, cols] with row stride ld elements
// (a multiple of 8, the base 16-byte aligned), in boxes of box_rows rows and
// 64 columns (128 bytes, one swizzle atom wide), zeros out of bounds.
// Returns cudaErrorNotSupported where the driver has no cuTensorMapEncodeTiled
// and cudaErrorInvalidValue where it refuses the map.
inline cudaError_t map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint64_t ld, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A map of a row-major byte matrix [rows, cols] with row stride ld bytes (a
// multiple of 16, the base 16-byte aligned), in boxes of box_rows rows and
// box_cols bytes (a multiple of 16, at most 256), unswizzled: a box lands as
// box_rows rows of box_cols bytes. Zeros out of bounds; errors as map_2d.
inline cudaError_t map_2d_u8(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                             uint64_t ld, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace tma
