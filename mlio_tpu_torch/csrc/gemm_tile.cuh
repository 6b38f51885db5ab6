// Small pieces of the tensor-core kernels: the bf16 alias, shared-memory
// addresses for inline PTX, ldmatrix (plain and transposed) and mma.sync
// m16n8k16 (bf16 inputs, fp32 accumulators), which K10 (flash_stream.cu)
// runs its products on, and load8, a masked 16-byte fetch of a row's 8 bf16
// (K12's row statistics and norm columns, ln_matmul.cu). wgmma.cuh,
// cp_async.cuh and tma.cuh build on it; the Hopper products of K1, K5, K11,
// K12 and K13 are wgmma (wgmma.cuh, gemm_wgmma.cuh).
//
// The accumulator layout of mma.sync is fixed (PTX ISA, "Matrix fragments for
// mma.m16n8k16"): lane l holds rows l/4 and l/4 + 8, columns 2(l%4) and
// 2(l%4) + 1 of each 16 x 8 fragment; wgmma's accumulators follow it a warp
// at a time (wgmma.cuh).
#pragma once

#include "common.cuh"

namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // K12's row-statistics launch: eight warps a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 of row r from column c of a row-major [rows, cols] matrix with row
// stride ld, zeros past its edge. vec: ld and the base allow 16-byte loads
// (c is a multiple of 8 then).
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ base, size_t ld, int r, int c,
                                       int rows, int cols, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r >= rows || c >= cols) return v;
  const bf16* p = base + static_cast<size_t>(r) * ld + c;
  if (vec && c + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  bf16* e = reinterpret_cast<bf16*>(&v);
  for (int i = 0; i < 8 && c + i < cols; ++i) e[i] = p[i];
  return v;
}

}  // namespace gemm
