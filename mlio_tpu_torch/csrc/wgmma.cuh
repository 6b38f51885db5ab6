// Hopper's warpgroup products (wgmma) for K1 and K13a (flash_fwd.cuh), K13b
// and K13c (flash_bwd.cu), K10 (flash_stream.cu), K12 (ln_matmul.cu) and K5
// and K11 (gemm_wgmma.cuh): the shared-memory tile layout and its
// descriptors, the fences and groups, and the bf16 m64nNk16 instructions
// they use, with fp32 accumulators.
//
// Four warps (a warpgroup, 128 threads) issue one product of 64 rows: warp w
// holds rows 16w .. 16w + 15 of A (when A is in registers) and of D, each in
// the layout of mma.sync m16n8k16 (gemm_tile.cuh): lane l holds rows l/4 and
// l/4 + 8, columns 2(l%4) and + 1 of every 8-column block, so d[n][e] is
// column 8n + 2(l%4) + (e & 1) of row l/4 + 8(e >> 1). B (and A when it is in
// shared memory) is read by the tensor cores through a descriptor.
//
// Tile layout: 64 rows of D bf16 (D = 64 or 128), 128-byte swizzle. Each
// 8 x 64 block is an atom of eight 128-byte rows in which the 16-byte chunk c
// of row r sits at chunk c ^ (r % 8); the atoms of one 64-column half follow
// each other down the rows (1 KB apart), the second half 8 KB on. The swizzle
// spreads the eight rows a product reads at once over all banks: without it
// (8 rows of 16 bytes, the rows 16 D bytes apart) the products read eight
// rows from the same banks and ran slower than mma.sync. One layout serves
// both uses of a tile: K-major (the columns are the product's K: S = Q K^T
// reads K that way) and MN-major (the rows are K: dQ = dS K reads it so).
// Atoms must start 1 KB aligned.
//
// The products are asynchronous: registers written by other instructions
// must be fenced (wgmma_fence) before a product reads or accumulates into
// them; a group is committed and waited for before its results are read.
// Shared memory written through the generic proxy (st.shared, cp.async) is
// made visible to the products by fence_proxy_async before the barrier that
// publishes it. fence_regs keeps the compiler from moving reads or writes of
// an accumulator across the asynchronous window.
#pragma once

#include "gemm_tile.cuh"

namespace gemm {

// Byte offset of (row r, column c) in a swizzled tile of 64 rows.
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 6) * 8192 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Element (r, c) of a swizzled tile of 64 rows (or, for a tile 64 columns
// wide, of any number of rows).
template <typename E>
__device__ __forceinline__ E* at_sw128(E* tile, int r, int c) {
  using Byte = std::conditional_t<std::is_const<E>::value, const unsigned char, unsigned char>;
  return reinterpret_cast<E*>(reinterpret_cast<Byte*>(tile) + sw128(r, c));
}

// A descriptor of the 128-byte swizzle layout (type 1) at byte address p,
// LBO and SBO in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// K-major: rows from r0 (a multiple of 8) as M or N, the 16 columns from c0
// (a multiple of 16) as K; the next 8 rows 1 KB on.
__device__ __forceinline__ uint64_t kmajor(const void* tile, int r0, int c0) {
  return wgmma_desc(static_cast<const unsigned char*>(tile) + (c0 >> 6) * 8192 + r0 * 128 +
                        (c0 & 63) * 2,
                    16, 1024);
}
// MN-major: rows [r0, r0 + 16) as K, every column as N; along K the next 8
// rows 1 KB on, along N the next 64 columns 8 KB on.
__device__ __forceinline__ uint64_t mnmajor(const void* tile, int r0) {
  return wgmma_desc(static_cast<const unsigned char*>(tile) + r0 * 128, 8192, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

// Accumulator pairs (n-tiles 2kk and 2kk + 1) rounded to bf16 and repacked
// as the A fragment of the 16 columns 16kk .. 16kk + 15: p of K1 and K10
// becomes the A operand of O += P V.
template <int NT>
__device__ __forceinline__ void repack(uint32_t (&a)[4], const float (&d)[NT][4], int kk) {
  a[0] = pack_bf16(d[2 * kk][0], d[2 * kk][1]);
  a[1] = pack_bf16(d[2 * kk][2], d[2 * kk][3]);
  a[2] = pack_bf16(d[2 * kk + 1][0], d[2 * kk + 1][1]);
  a[3] = pack_bf16(d[2 * kk + 1][2], d[2 * kk + 1][3]);
}

// D[64 x 32] (+)= A (registers) B (32 columns from shared memory).
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 64] (+)= A (registers) B (64 columns from shared memory).
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 128] (+)= A (registers) B (128 columns from shared memory).
template <int TransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x 32] (+)= A (64 rows from shared memory) B (32 columns), both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A (64 rows from shared memory) B (64 columns), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A (64 rows from shared memory, K-major) B (128 columns from
// shared memory); TransB 0 for a K-major B, 1 for an MN-major one.
template <int TransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D[64 x N] (+)= A (registers) B: N = 32, 64 or 128 columns; TransB 0 for a
// K-major B, 1 for an MN-major one.
template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) wgmma_rs_n32<TransB>(d, a, desc_b, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64<TransB>(d, a, desc_b, scale_d);
  else wgmma_rs_n128<TransB>(d, a, desc_b, scale_d);
}

}  // namespace gemm
