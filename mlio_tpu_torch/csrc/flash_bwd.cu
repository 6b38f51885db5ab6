// K13: flash attention for training on Hopper: the forward with the
// log-sum-exp (K13a), then dQ (K13b) and dK/dV (K13c).
//
// Replaces mlio_tpu/ops/flash_attention_grad.py: _fwd_lse_kernel (:49),
// _bwd_dq_kernel (:122) and _bwd_dkv_kernel (:180). q, o, dO [B, Sq, Hq, D],
// k/v [B, Skv, Hkv, D], bf16, bshd; lse and delta = rowsum(dO * O) fp32
// [B, Hq, Sq]. With P = exp(q.k * scale - lse) over the valid keys (j < Skv
// and, when causal, j <= i) and dP = dO V^T:
//   dS = P * (dP - delta),  dQ = scale * dS K,  dV = P~^T dO,  dK = dS^T (q * scale)
// where under dropout dP and P~ = P are kept where the position hash keeps
// them and scaled by 1 / (1 - rate) (the mask of K1's forward, regenerated
// from the seed folded with (batch, query head)).
//
// K13a is K1's kernel (flash_fwd.cuh) with the lse store. K13b: one block per
// (64-row q tile, query head, batch), four warps of 16 rows; the scaled Q tile
// and the dO tile stay in registers as WMMA fragments, dQ accumulates in
// fp32 fragments, and the K/V tiles of 64 keys are looped to the causal
// frontier. K13c: one block per (64-key tile, query head, batch); the K/V
// tile stays in shared memory, the q tiles are looped from the diagonal
// (causal) or from 0, and dK, dV accumulate in fp32 fragments, each warp
// owning 16 keys. In both, the bf16 tiles of the elementwise step (dS, P~)
// are written over the fp32 scores they come from, a row at a time, and
// that step reads a key a lane, free of bank conflicts; each kernel keeps
// under 113 KB of shared memory (D 128), so two blocks share an SM. dK and
// dV come out per query head in fp32 [B, Skv, Hq, D]; the GQA group sum is
// outside, as in the JAX package. Every
// output element has one writer and every sum a fixed order: no atomics, so
// two runs give the same bits (the JAX design, :10-17).
//
// Rounding follows the TPU kernels: q * scale rounded to bf16; P rounded to
// bf16 for the PV product (K13a); dO enters dP as bf16; dS rounded to bf16 for
// dQ and for dK; P~ rounded to bf16 for dV; every sum in fp32.
//
// Bound, at llama3-8b's attention (B 1, S 2048, 32 query heads, 8 KV heads,
// D 128, causal): about 4, 6 and 8 B Hq S^2 D / 2 operations for K13a, K13b
// and K13c, 34.4, 51.5 and 68.7 GFLOP: 35, 52 and 69 us at 989 TFLOP/s,
// against a few tens of MB of q, k, v, o, dO, lse and outputs (a few us at
// ~3.2 TB/s): operations. A simple kernel that is right comes first: WMMA on
// 64 x 64 tiles with the scores staged in shared memory, no pipelining;
// register-resident mma.sync fragments, wgmma, TMA and a K/V ring are later
// work.
#include "flash_fwd.cuh"

namespace {

using namespace nvcuda;
using flash::BKV;
using flash::BQ;
using flash::Dropout;
using flash::kThreads;
using T = __nv_bfloat16;

// Row pitches: 16-bit tiles D + 8 elements, fp32 scores BKV + 4; a bf16
// tile written over an fp32 one keeps its byte pitch (LDP = 2 LDS elements),
// so its row r lies inside the scores' row r.
template <int D>
struct Pitch {
  static constexpr int LDH = D + 8;
  static constexpr int LDS = BKV + 4;
  static constexpr int LDP = 2 * LDS;
  static constexpr int LDO = D + 4;  // the fp32 staging of the outputs
  static constexpr size_t kTile = size_t(64) * LDH * 2;
  static constexpr size_t kScores = size_t(64) * LDS * 4;
};

template <int D>
struct DqLayout : Pitch<D> {
  using P = Pitch<D>;
  // Q, dO, K, V; S (then dS over it); dP; the q tile's lse and delta. dQ is
  // staged over K and V after the loop.
  static constexpr size_t kQ = 0, kdO = P::kTile, kK = 2 * P::kTile, kV = 3 * P::kTile;
  static constexpr size_t kS = 4 * P::kTile, kdP = kS + P::kScores;
  static constexpr size_t kRow = kdP + P::kScores;
  static constexpr size_t kBytes = kRow + size_t(BQ) * 2 * 4;
  static_assert(size_t(BQ) * P::LDO * 4 <= 2 * P::kTile, "dQ staging must fit over K and V");
};

template <int D>
struct DkvLayout : Pitch<D> {
  using P = Pitch<D>;
  // K, V, Q, dO; S (then P~ over it); dP (then dS over it); the q tile's lse
  // and delta. dK and dV are staged over S and dP after the loop.
  static constexpr size_t kK = 0, kV = P::kTile, kQ = 2 * P::kTile, kdO = 3 * P::kTile;
  static constexpr size_t kS = 4 * P::kTile, kdP = kS + P::kScores;
  static constexpr size_t kRow = kdP + P::kScores;
  static constexpr size_t kBytes = kRow + size_t(BQ) * 2 * 4;
  static_assert(size_t(BKV) * P::LDO * 4 <= 2 * P::kScores,
                "dK/dV staging must fit over S and dP");
};

// Rows [r0, r0 + 64) of a [B, S, H, D] bf16 tensor's head h into a tile with
// row pitch LD; rows past S are 0.
template <int D, int LD>
__device__ __forceinline__ void load_tile(T* s, const T* g, int b, int h, int r0, int S, int H) {
  constexpr int V8 = 8, CPR = D / V8;
  const size_t row = static_cast<size_t>(H) * D;
  for (int c = threadIdx.x; c < 64 * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = c % CPR;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      raw = *reinterpret_cast<const uint4*>(g + (static_cast<size_t>(b) * S + r0 + r) * row +
                                            h * D + cc * V8);
    *reinterpret_cast<uint4*>(s + r * LD + cc * V8) = raw;
  }
}

__device__ __forceinline__ float finite_or_zero(float x) { return x == -INFINITY ? 0.f : x; }

// The q tile's lse (-inf read as 0) and delta into shared memory; rows past
// Sq get 0.
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDelta, const float* lse,
                                               const float* delta, int b, int h, int q_start,
                                               int Sq, int Hq) {
  if (threadIdx.x < BQ) {
    const int qr = q_start + threadIdx.x;
    const size_t si = (static_cast<size_t>(b) * Hq + h) * Sq + qr;
    sLse[threadIdx.x] = qr < Sq ? finite_or_zero(lse[si]) : 0.f;
    sDelta[threadIdx.x] = qr < Sq ? delta[si] : 0.f;
  }
}

// The elementwise step for this warp's 16 q rows of a 64-key tile: with
// P = exp(S - lse) over the valid (row, key) pairs, dP kept and scaled under
// dropout, dS = P * (dP - delta) and P~ = P kept and scaled (kPt), written as
// bf16 over S (P~, or dS without kPt) and over dP (dS with kPt). Lane l takes
// keys l and l + 32 of a row; a row's bf16 values overwrite only that row's
// fp32 scores, all read before the warp writes.
template <bool kDrop, bool kPt>
__device__ __forceinline__ void probs_and_ds(float* sS, float* sdP, const float* sLse,
                                             const float* sDelta, int warp, int lane, int q_start,
                                             int kv0, int Sq, int Skv, int causal, uint32_t seed,
                                             const Dropout& drop) {
  constexpr int LDS = BKV + 4, LDP = 2 * LDS;
  T* out_s = reinterpret_cast<T*>(sS);
  T* out_dp = reinterpret_cast<T*>(sdP);
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    const int qr = q_start + row;
    const float lse_r = sLse[row], delta_r = sDelta[row];
    float pt[2], ds[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cl = lane + 32 * i;
      const int col = kv0 + cl;
      const bool ok = qr < Sq && col < Skv && (!causal || qr >= col);
      const float p = ok ? expf(sS[row * LDS + cl] - lse_r) : 0.f;
      float dp = sdP[row * LDS + cl];
      pt[i] = p;
      if constexpr (kDrop) {
        const bool keep = flash::drop_keep(qr, col, seed, drop.rate);
        pt[i] = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      ds[i] = p * (dp - delta_r);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = row * LDP + lane + 32 * i;
      if constexpr (kPt) {
        out_s[at] = __float2bfloat16(pt[i]);
        out_dp[at] = __float2bfloat16(ds[i]);
      } else {
        out_s[at] = __float2bfloat16(ds[i]);
      }
    }
    __syncwarp();
  }
}

// K13b: dQ for rows [64 qt, 64 qt + 64) of query head h.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int Hq,
                    int Hkv, float scale, int causal, Dropout drop) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sdO = reinterpret_cast<T*>(smem + L::kdO);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sdP = reinterpret_cast<float*>(smem + L::kdP);
  const T* sdS = reinterpret_cast<const T*>(sS);  // dS is written over S
  float* sLse = reinterpret_cast<float*>(smem + L::kRow);
  float* sDelta = sLse + BQ;
  float* sO = reinterpret_cast<float*>(smem + L::kK);  // dQ staged over K/V after the loop

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_start = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t seed = kDrop ? flash::fold_seed(drop.seed, b, h) : 0u;

  int tokens = Skv;
  if (causal) tokens = min(tokens, q_start + BQ);
  const int n_tiles = (tokens + BKV - 1) / BKV;

  flash::load_q_scaled<T, D, L::LDH>(sQ, q, b, h, q_start, Sq, Hq, scale);
  load_tile<D, L::LDH>(sdO, dout, b, h, q_start, Sq, Hq);
  load_row_stats(sLse, sDelta, lse, delta, b, h, q_start, Sq, Hq);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa[D / 16], da[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sQ + warp * 16 * L::LDH + kk * 16, L::LDH);
    wmma::load_matrix_sync(da[kk], sdO + warp * 16 * L::LDH + kk * 16, L::LDH);
    wmma::fill_fragment(acc[kk], 0.f);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    load_tile<D, L::LDH>(sK, k, b, hk, kv0, Skv, Hkv);
    load_tile<D, L::LDH>(sV, v, b, hk, kv0, Skv, Hkv);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc, dc;
      wmma::fill_fragment(sc, 0.f);
      wmma::fill_fragment(dc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb, vb;
        wmma::load_matrix_sync(kb, sK + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(sc, qa[kk], kb, sc);
        wmma::load_matrix_sync(vb, sV + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(dc, da[kk], vb, dc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, sc, L::LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(sdP + warp * 16 * L::LDS + n * 16, dc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    probs_and_ds<kDrop, false>(sS, sdP, sLse, sDelta, warp, lane, q_start, kv0, Sq, Skv, causal,
                               seed, drop);

    // dQ += dS K for this warp's 16 rows.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> sa;
      wmma::load_matrix_sync(sa, sdS + warp * 16 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, sK + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc[n], sa, kb, acc[n]);
      }
    }
    __syncthreads();  // K/V tiles and the scores are overwritten next
  }

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sO + warp * 16 * L::LDO + n * 16, acc[n], L::LDO, wmma::mem_row_major);
  __syncwarp();
  // Lanes 2r and 2r+1 write row r of this warp's 16, half of the columns each.
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int qr = q_start + row;
  if (qr < Sq) {
    T* out = dq + (static_cast<size_t>(b) * Sq + qr) * Hq * D + h * D;
    for (int cc = half * (D / 16); cc < (half + 1) * (D / 16); ++cc) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = sO[row * L::LDO + cc * 8 + i] * scale;
      store_vec(out + cc * 8, f);
    }
  }
}

// K13c: dK and dV of keys [64 kt, 64 kt + 64) for query head h, fp32.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, float scale,
                     int causal, Dropout drop) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sdO = reinterpret_cast<T*>(smem + L::kdO);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sdP = reinterpret_cast<float*>(smem + L::kdP);
  const T* sPt = reinterpret_cast<const T*>(sS);   // P~ is written over S
  const T* sdS = reinterpret_cast<const T*>(sdP);  // dS over dP
  float* sLse = reinterpret_cast<float*>(smem + L::kRow);
  float* sDelta = sLse + BQ;

  const int kt = blockIdx.x;  // the first key tiles see the most q tiles under causality
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int kv0 = kt * BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t seed = kDrop ? flash::fold_seed(drop.seed, b, h) : 0u;

  load_tile<D, L::LDH>(sK, k, b, hk, kv0, Skv, Hkv);
  load_tile<D, L::LDH>(sV, v, b, hk, kv0, Skv, Hkv);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int n_qt = (Sq + BQ - 1) / BQ;
  // Causal: q tiles wholly above the diagonal see none of these keys.
  for (int it = causal ? kv0 / BQ : 0; it < n_qt; ++it) {
    const int q_start = it * BQ;
    flash::load_q_scaled<T, D, L::LDH>(sQ, q, b, h, q_start, Sq, Hq, scale);
    load_tile<D, L::LDH>(sdO, dout, b, h, q_start, Sq, Hq);
    load_row_stats(sLse, sDelta, lse, delta, b, h, q_start, Sq, Hq);
    __syncthreads();

    // S = Q K^T, then dP = dO V^T, for this warp's 16 q rows.
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const T* a_tile = pass == 0 ? sQ : sdO;
      const T* b_tile = pass == 0 ? sK : sV;
      float* out = pass == 0 ? sS : sdP;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[BKV / 16];
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(sc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_tile + warp * 16 * L::LDH + kk * 16, L::LDH);
#pragma unroll
        for (int n = 0; n < BKV / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, b_tile + n * 16 * L::LDH + kk * 16, L::LDH);
          wmma::mma_sync(sc[n], a, bt, sc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n)
        wmma::store_matrix_sync(out + warp * 16 * L::LDS + n * 16, sc[n], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();
    probs_and_ds<kDrop, true>(sS, sdP, sLse, sDelta, warp, lane, q_start, kv0, Sq, Skv, causal,
                              seed, drop);
    __syncthreads();  // every warp reads every q row of P~ and dS

    // dV += P~^T dO and dK += dS^T (q * scale) for this warp's 16 keys.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> pa, sa;
      wmma::load_matrix_sync(pa, sPt + kk * 16 * L::LDP + warp * 16, L::LDP);
      wmma::load_matrix_sync(sa, sdS + kk * 16 * L::LDP + warp * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> ob, qb;
        wmma::load_matrix_sync(ob, sdO + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(dv_acc[n], pa, ob, dv_acc[n]);
        wmma::load_matrix_sync(qb, sQ + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(dk_acc[n], sa, qb, dk_acc[n]);
      }
    }
    __syncthreads();  // the q tile, P~ and dS are overwritten next
  }

  // Stage each warp's 16 keys over S/dP and write the rows below Skv.
  float* stage = sS;
  const int key = warp * 16 + lane / 2;
  const int half = lane % 2;
  const size_t grow = static_cast<size_t>(Hq) * D;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(stage + warp * 16 * L::LDO + n * 16,
                              which == 0 ? dk_acc[n] : dv_acc[n], L::LDO, wmma::mem_row_major);
    __syncwarp();
    if (kv0 + key < Skv) {
      float* out = (which == 0 ? dk : dv) + (static_cast<size_t>(b) * Skv + kv0 + key) * grow +
                   h * D;
      for (int c = half * (D / 8); c < (half + 1) * (D / 8); ++c)
        *reinterpret_cast<float4*>(out + c * 4) =
            *reinterpret_cast<const float4*>(stage + key * L::LDO + c * 4);
    }
    __syncwarp();
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, bool kDrop>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                       const float* delta, T* dq, float* dk, float* dv, int B, int Sq, int Skv,
                       int Hq, int Hkv, float scale, int causal, Dropout drop, cudaStream_t s) {
  if (dq != nullptr) {
    auto kernel = flash_bwd_dq_kernel<D, kDrop>;
    cudaError_t err = prepare(kernel, DqLayout<D>::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Sq + BQ - 1) / BQ, Hq, B), kThreads, DqLayout<D>::kBytes, s>>>(
        q, k, v, dout, lse, delta, dq, Sq, Skv, Hq, Hkv, scale, causal, drop);
  } else {
    auto kernel = flash_bwd_dkv_kernel<D, kDrop>;
    cudaError_t err = prepare(kernel, DkvLayout<D>::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Skv + BKV - 1) / BKV, Hq, B), kThreads, DkvLayout<D>::kBytes, s>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, scale, causal, drop);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, float* dk, float* dv,
                         int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
                         Dropout drop, cudaStream_t s) {
#define MLIO_BWD(DD, DROP)                                                                  \
  return launch_bwd<DD, DROP>(static_cast<const T*>(q), static_cast<const T*>(k),           \
                              static_cast<const T*>(v), static_cast<const T*>(dout), lse,   \
                              delta, static_cast<T*>(dq), dk, dv, B, Sq, Skv, Hq, Hkv, scale, \
                              causal, drop, s)
  const bool dropping = drop.rate > 0.f;
  if (D == 64) {
    if (dropping) MLIO_BWD(64, true);
    MLIO_BWD(64, false);
  }
  if (D == 128) {
    if (dropping) MLIO_BWD(128, true);
    MLIO_BWD(128, false);
  }
#undef MLIO_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// K13a: o [B, Sq, Hq, D] bf16 and lse [B, Hq, Sq] fp32 of q [B, Sq, Hq, D],
// k/v [B, Skv, Hkv, D], all contiguous bf16; D in {64, 128}; q_offset 0 and
// no kv_len (the training shapes). drop_rate > 0: dropout with the int32
// seed drop_seed and drop_inv_keep = 1 / (1 - drop_rate).
extern "C" int mlio_flash_fwd_lse(const void* q, const void* k, const void* v, void* out,
                                  float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                  float scale, int causal, int drop_seed, float drop_rate,
                                  float drop_inv_keep, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  return flash::launch<T, T, true>(q, k, v, nullptr, nullptr, out, lse, nullptr, Skv, B, Sq,
                                   Skv, Hq, Hkv, D, 0, scale, causal,
                                   Dropout{static_cast<uint32_t>(drop_seed), drop_rate,
                                           drop_inv_keep},
                                   static_cast<cudaStream_t>(stream));
}

// K13b: dq [B, Sq, Hq, D] bf16 from q, k, v, dout (bf16, as mlio_flash_fwd_lse)
// and lse, delta [B, Hq, Sq] fp32.
extern "C" int mlio_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, float scale, int causal,
                                 int drop_seed, float drop_rate, float drop_inv_keep,
                                 void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0 || Skv == 0) return 0;
  return dispatch_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Skv, Hq, Hkv, D,
                      scale, causal,
                      Dropout{static_cast<uint32_t>(drop_seed), drop_rate, drop_inv_keep},
                      static_cast<cudaStream_t>(stream));
}

// K13c: dk, dv [B, Skv, Hq, D] fp32, per query head, from the same inputs.
extern "C" int mlio_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, float* dk, float* dv,
                                  int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                                  int causal, int drop_seed, float drop_rate,
                                  float drop_inv_keep, void* stream) {
  if (B == 0 || Skv == 0 || Hq == 0) return 0;
  return dispatch_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Skv, Hq, Hkv, D, scale,
                      causal, Dropout{static_cast<uint32_t>(drop_seed), drop_rate, drop_inv_keep},
                      static_cast<cudaStream_t>(stream));
}
