// K9: flash attention forward over an INT8 K/V cache (flash_fwd.cu's
// mlio_flash_fwd_kvq), on WMMA. The bf16 forward (K1, K13a) is
// flash_fwd.cuh's wgmma kernel; this body is K1's earlier one kept for the
// int8 cache until it moves onto the new body too.
//
// q [B, Sq, Hq, D] bf16, k/v int8 [B, Skv, Hkv, D] with fp32 scales ks, vs
// [B, Skv, Hkv] per (token, head), out [B, Sq, Hq, D]:
//   out[b, i, h] = softmax_j(q . (k * ks)[b, j, h/G] * scale) @ (v * vs)[b, j, h/G]
// over keys j < kv_len[b] and, when causal, j <= i + q_offset. A row with no
// valid key gives 0.
//
// One block per (q tile of 64 rows, head, batch), four warps of 16 rows
// each; Q, K and V tiles in shared memory; both products on the tensor cores
// through WMMA (bf16 inputs, fp32 accumulate); online softmax in fp32. The kv
// loop stops at min(kv_len[b], q_start + q_offset + 64), the TPU kernel's
// causal early exit, and the ragged edges (q rows past Sq, keys past kv_len)
// are masked or zero-filled in the kernel, with no padded copies of the
// inputs. The heaviest q tiles (the last, under causality) are scheduled
// first.
//
// An int8 value widens to bf16 exactly, so the K/V tiles widen on their way
// into shared memory and both products stay bf16 WMMA; the K scale
// multiplies the fp32 score after the QK product, the V scale multiplies p
// before p is rounded to bf16 for the PV product, and l adds the unscaled
// fp32 p. The scale is folded into q in fp32 and rounded back to bf16; out =
// acc / l.
#pragma once

#include "common.cuh"

#include <math.h>
#include <mma.h>

namespace flash_kvq {

using namespace nvcuda;

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // keys per kv tile
constexpr int kWarps = BQ / 16;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Layout {
  // Row pitches, padded against shared-memory bank conflicts; every WMMA
  // tile pointer stays 32-byte aligned.
  static constexpr int LDH = D + 8;    // Q, K, V tiles (16-bit elements)
  static constexpr int LDS = BKV + 4;  // scores (fp32)
  static constexpr int LDP = BKV + 8;  // probabilities (16-bit elements)
  static constexpr int LDO = D + 4;    // output accumulator (fp32)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + size_t(BQ) * LDH * 2;
  static constexpr size_t kV = kK + size_t(BKV) * LDH * 2;
  static constexpr size_t kS = kV + size_t(BKV) * LDH * 2;
  static constexpr size_t kP = kS + size_t(BQ) * LDS * 4;
  static constexpr size_t kO = kP + size_t(BQ) * LDP * 2;
  static constexpr size_t kBytes = kO + size_t(BQ) * LDO * 4;
};

// Eight int8 values (an 8-byte load) widened to T, as one 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 widen_i8(const uint2 raw) {
  float f[8];
  unpack_i8x8(raw, f);
  uint4 out;
  T* e = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = from_f32<T>(f[i]);
  return out;
}

// The scaled Q tile of rows [q_start, q_start + 64) of head h: q * scale in
// fp32, rounded back to T; rows past Sq are 0.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_q_scaled(T* sQ, const T* q, int b, int h, int q_start, int Sq,
                                              int Hq, float scale) {
  constexpr int V8 = 8, CPR = D / V8;
  const size_t q_row = static_cast<size_t>(Hq) * D;
  for (int c = threadIdx.x; c < BQ * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = c % CPR;
    const int qr = q_start + r;
    float f[V8];
    if (qr < Sq) {
      load_vec(q + (static_cast<size_t>(b) * Sq + qr) * q_row + h * D + cc * V8, f);
#pragma unroll
      for (int i = 0; i < V8; ++i) f[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < V8; ++i) f[i] = 0.f;
    }
    store_vec(sQ + r * LD + cc * V8, f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kvq_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, T* __restrict__ out,
                     const int* __restrict__ kv_len_arr, int kv_len_scalar, int Sq, int Skv,
                     int Hq, int Hkv, int q_offset, float scale, int causal) {
  using L = Layout<D>;
  constexpr int V8 = 8;        // 16-bit elements per 16-byte vector
  constexpr int CPR = D / V8;  // vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  T* sP = reinterpret_cast<T*>(smem + L::kP);
  float* sO = reinterpret_cast<float*>(smem + L::kO);
  __shared__ float sKs[BKV], sVs[BKV];  // the tile's K/V scales

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_start = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int kvl = min(kv_len_arr != nullptr ? kv_len_arr[b] : kv_len_scalar, Skv);
  int tokens = kvl;
  if (causal) tokens = min(tokens, q_start + q_offset + BQ);
  const int n_tiles = tokens > 0 ? (tokens + BKV - 1) / BKV : 0;

  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;

  load_q_scaled<T, D, L::LDH>(sQ, q, b, h, q_start, Sq, Hq, scale);
  for (int i = tid; i < BQ * L::LDO; i += kThreads) sO[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * L::LDH + kk * 16, L::LDH);

  // Lanes 2r and 2r+1 own row r of this warp's 16, half of the columns each.
  const int r = lane / 2;
  const int half = lane % 2;
  const int row = warp * 16 + r;
  const int row_abs = q_start + row + q_offset;
  float m = -INFINITY, l = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    for (int c = tid; c < BKV * CPR; c += kThreads) {
      const int rr = c / CPR, cc = c % CPR;
      const int t = kv0 + rr;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      if (t < kvl) {
        const size_t off = (static_cast<size_t>(b) * Skv + t) * kv_row + hk * D + cc * V8;
        kraw = widen_i8<T>(*reinterpret_cast<const uint2*>(k + off));
        vraw = widen_i8<T>(*reinterpret_cast<const uint2*>(v + off));
      }
      *reinterpret_cast<uint4*>(sK + rr * L::LDH + cc * V8) = kraw;
      *reinterpret_cast<uint4*>(sV + rr * L::LDH + cc * V8) = vraw;
    }
    if (tid < BKV) {
      const int t = kv0 + tid;
      const size_t si = (static_cast<size_t>(b) * Skv + t) * Hkv + hk;
      sKs[tid] = t < kvl ? ks[si] : 0.f;
      sVs[tid] = t < kvl ? vs[si] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, sK + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(sc, qa[kk], kb, sc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, sc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on row r.
    const float* srow = sS + row * L::LDS + half * (BKV / 2);
    float s_loc[BKV / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < BKV / 2; ++c) {
      const int col_abs = kv0 + half * (BKV / 2) + c;
      const bool ok = col_abs < kvl && (!causal || row_abs >= col_abs);
      const float sc = srow[c] * sKs[half * (BKV / 2) + c];
      s_loc[c] = ok ? sc : -INFINITY;
      tmax = fmaxf(tmax, s_loc[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_safe);
    float psum = 0.f;
    T* prow = sP + row * L::LDP + half * (BKV / 2);
#pragma unroll
    for (int c = 0; c < BKV / 2; ++c) {
      const float p = (s_loc[c] == -INFINITY) ? 0.f : expf(s_loc[c] - m_safe);
      psum += p;
      prow[c] = from_f32<T>(p * sVs[half * (BKV / 2) + c]);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = sO + row * L::LDO + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::load_matrix_sync(oc, sO + warp * 16 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, sP + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(vb, sV + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(sO + warp * 16 * L::LDO + n * 16, oc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }
  __syncwarp();

  const int qr = q_start + row;
  if (qr < Sq) {
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* orow_g = out + (static_cast<size_t>(b) * Sq + qr) * q_row + h * D;
#pragma unroll
    for (int cc = half * (CPR / 2); cc < (half + 1) * (CPR / 2); ++cc) {
      float f[V8];
#pragma unroll
      for (int i = 0; i < V8; ++i) f[i] = sO[row * L::LDO + cc * V8 + i] / l_safe;
      store_vec(orow_g + cc * V8, f);
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, void* out, const int* kv_len, int kv_len_scalar, int B,
                     int Sq, int Skv, int Hq, int Hkv, int q_offset, float scale, int causal,
                     cudaStream_t s) {
  constexpr size_t smem = Layout<D>::kBytes;
  auto kernel = flash_fwd_kvq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      ks, vs, static_cast<T*>(out), kv_len, kv_len_scalar, Sq, Skv, Hq, Hkv, q_offset, scale,
      causal);
  return cudaGetLastError();
}

// The instance for head dim D (64 or 128).
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   void* out, const int* kv_len, int kv_len_scalar, int B, int Sq, int Skv,
                   int Hq, int Hkv, int D, int q_offset, float scale, int causal,
                   cudaStream_t s) {
  if (D == 64)
    return launch_d<T, 64>(q, k, v, ks, vs, out, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv,
                           q_offset, scale, causal, s);
  if (D == 128)
    return launch_d<T, 128>(q, k, v, ks, vs, out, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv,
                            q_offset, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace flash_kvq
