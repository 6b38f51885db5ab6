// The bf16 tile loop shared by K5 (quant_matmul.cu), K11 (fused_mlp.cu) and
// K12 (ln_matmul.cu): C[BM, BN] += A[BM, K] @ B[K, BN] with A and B staged in
// shared memory as bf16 tiles of BK = 32 along K, and the products on the
// tensor cores through mma.sync m16n8k16 (bf16 inputs, fp32 accumulators in
// registers).
//
// What each kernel adds is a prologue on the way into shared memory: K12
// normalises x, K5 widens int8 or int4 weights to bf16, K11 reads its second
// product's A operand (the activation tile) from shared memory where the
// first product left it. So the loaders are the kernels' own; this header
// gives the pieces they share:
//
//   - warp_k16: one k16 step of a warp over MI x NI fragments of 16 x 8,
//     operands loaded with ldmatrix (B transposed on the way, so B stays
//     row-major [K, N] in shared memory as it is in device memory);
//   - pipeline: the k loop with a register-staged double buffer: tile t+1 is
//     fetched from device memory into registers while tile t's MMAs run, then
//     written to the other shared-memory stage; one barrier a tile;
//   - load8 / load16b: 16-byte fetches of a row's 8 bf16 or 16 bytes with the
//     ragged edge masked (zeros past the matrix), so every shape runs with no
//     padded copy, and element by element where a row's stride does not allow
//     16-byte accesses;
//   - Frag: where a fragment element sits in the block tile.
//
// The accumulator layout of mma.sync is fixed (PTX ISA, "Matrix fragments for
// mma.m16n8k16"): lane l holds rows l/4 and l/4 + 8, columns 2(l%4) and
// 2(l%4) + 1 of each 16 x 8 fragment. The epilogues rely on it to scale
// columns (K5) and to apply the activation to known (row, column) pairs
// (K11).
//
// A simple loop that is right: wgmma, TMA and a deeper asynchronous ring are
// later work.
#pragma once

#include "common.cuh"

namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int BK = 32;        // K depth of a shared-memory tile (two k16 steps)
constexpr int LDA = BK + 8;   // A tile row pitch in bf16: 80 bytes, ldmatrix without conflicts
constexpr int kThreads = 256; // eight warps a block, arranged 2 (rows) x 4 (columns)

// B tile row pitch for a tile BN columns wide: 16 bytes of padding, so the
// eight rows one ldmatrix reads fall in distinct banks.
template <int BN> struct LdB { static constexpr int value = BN + 8; };

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

// A warp's accumulators: MI x NI fragments of 16 rows x 8 columns, the warp's
// tile starting at (row0, col0) of the block tile.
template <int MI, int NI>
struct Frag {
  float c[MI][NI][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mi][ni][e] = 0.f;
  }
  // Block-tile row and column of element e of fragment (mi, ni).
  static __device__ __forceinline__ int row(int row0, int mi, int e, int lane) {
    return row0 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
  }
  static __device__ __forceinline__ int col(int col0, int ni, int e, int lane) {
    return col0 + ni * 8 + (lane & 3) * 2 + (e & 1);
  }
};

// One k16 step of a warp: rows [row0, row0 + 16 MI) of the A tile (pitch lda,
// columns kk..kk+15) times columns [col0, col0 + 8 NI) of the B tile (pitch
// ldb, rows kk..kk+15), added into f.
template <int MI, int NI>
__device__ __forceinline__ void warp_k16(Frag<MI, NI>& f, const bf16* sA, int lda, int row0,
                                         const bf16* sB, int ldb, int col0, int kk, int lane) {
  static_assert(NI % 2 == 0, "B fragments are loaded in pairs");
  uint32_t a[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    ldmatrix_x4(a[mi], sA + (row0 + mi * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
#pragma unroll
  for (int ni = 0; ni < NI; ni += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, sB + (kk + (lane & 15)) * ldb + col0 + ni * 8 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      mma16816(f.c[mi][ni], a[mi], b[0], b[1]);
      mma16816(f.c[mi][ni + 1], a[mi], b[2], b[3]);
    }
  }
}

// The k loop over nt tiles: fetch(t) loads tile t from device memory into
// the caller's registers, put(s) writes them to shared-memory stage s, and
// compute(t, s) runs tile t's MMAs from stage s. Tile t+1's loads are in
// flight while tile t computes; stage s^1 is written only after the barrier
// that ends the compute which last read it.
template <class Fetch, class Put, class Compute>
__device__ __forceinline__ void pipeline(int nt, Fetch&& fetch, Put&& put, Compute&& compute) {
  if (nt <= 0) return;
  fetch(0);
  put(0);
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) fetch(t + 1);
    compute(t, t & 1);
    if (t + 1 < nt) put((t + 1) & 1);
    __syncthreads();
  }
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

// 16 bytes of row r from byte column c of a row-major [rows, cols] byte
// matrix with row stride ld, zeros past its edge; vec as for load8.
__device__ __forceinline__ uint4 load16b(const int8_t* __restrict__ base, size_t ld, int r, int c,
                                         int rows, int cols, bool vec) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (r >= rows || c >= cols) return v;
  const int8_t* p = base + static_cast<size_t>(r) * ld + c;
  if (vec && c + 16 <= cols) return *reinterpret_cast<const uint4*>(p);
  int8_t* e = reinterpret_cast<int8_t*>(&v);
  for (int i = 0; i < 16 && c + i < cols; ++i) e[i] = p[i];
  return v;
}

__device__ __forceinline__ void store_bf16(bf16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Store an accumulator pair (columns col and col + 1 of one row) as bf16,
// masking col + 1 past n; a 4-byte store where the pair is aligned.
__device__ __forceinline__ void store_pair(bf16* row_ptr, int col, int n, float v0, float v1) {
  if (col + 1 < n && ((reinterpret_cast<uintptr_t>(row_ptr + col) & 3) == 0)) {
    __nv_bfloat162 two;
    two.x = __float2bfloat16(v0);
    two.y = __float2bfloat16(v1);
    *reinterpret_cast<__nv_bfloat162*>(row_ptr + col) = two;
  } else {
    if (col < n) row_ptr[col] = __float2bfloat16(v0);
    if (col + 1 < n) row_ptr[col + 1] = __float2bfloat16(v1);
  }
}

}  // namespace gemm
