// K13: flash attention for training on Hopper: the forward with the
// log-sum-exp (K13a), then dQ (K13b) and dK/dV (K13c).
//
// Replaces mlio_tpu/ops/flash_attention_grad.py: _fwd_lse_kernel (:49, its
// pallas_call at :285), _bwd_dq_kernel (:122, pallas_call :380) and
// _bwd_dkv_kernel (:180, pallas_call :394). q, o, dO [B, Sq, Hq, D], k/v
// [B, Skv, Hkv, D], bf16, bshd; lse and delta = rowsum(dO * O) fp32
// [B, Hq, Sq]. With P = exp(q.k * scale - lse) over the valid keys (j < Skv
// and, when causal, j <= i) and dP = dO V^T:
//   dS = P * (dP - delta),  dQ = scale * dS K,  dV = P~^T dO,  dK = dS^T (q * scale)
// where under dropout dP and P~ = P are kept where the position hash keeps
// them and scaled by 1 / (1 - rate) (the mask of K1's forward, regenerated
// from the seed folded with (batch, query head)). dq comes out bf16; dK and
// dV fp32 per query head [B, Skv, Hq, D], the GQA group sum outside, as in
// the JAX package (:414-416). Every output element has one writer and every
// sum a fixed order: no atomics, so two runs give the same bits (the JAX
// design, :10-17).
//
// Rounding follows the TPU kernels: q * scale rounded to bf16; P rounded to
// bf16 for the PV product (K13a); dO enters dP as bf16; dS rounded to bf16 for
// dQ and for dK; P~ rounded to bf16 for dV; every sum in fp32. exp is taken
// as exp2 of the score times log2(e), a few fp32 ulps from exp.
//
// Bound, at llama3-8b's attention (B 1, S 2048, 32 query and 8 KV heads of
// 128, causal; pairs = 32 x 128 x 2048 x 2049 / 2 = 8.59e9): K13a does 4,
// K13b 6 (S, dP, dQ) and K13c 8 (S, dP, dV, dK) x pairs operations, 34.4,
// 51.6 and 68.7 GFLOP: 35, 52 and 69 us at 989 TFLOP/s (bf16 tensor
// cores), against 59 MB (K13b: q, dO, k, v, lse, delta read once, dq
// written) and 109 MB (K13c: fp32 dK and dV per query head), 18 and 34 us
// at ~3.2 TB/s: bound by operations. So the tensor cores must do the work
// and everything else keep out of their way.
//
// K13a is K1's kernel (flash_fwd.cuh) with the lse store. K13b and K13c are
// FlashAttention-2's backward layout on Hopper's warpgroup products (wgmma,
// wgmma.cuh; bf16 inputs, fp32 accumulators), with K10's pieces
// (flash_stream.cu) around them:
// - Scores stay in registers. A block is one warpgroup (four warps of 16
//   rows: K13b's q rows, K13c's keys), and S and dP land in its
//   accumulators, whose (row, column) of each element is public, so the
//   mask, the dropout, exp and dS are computed where the products leave them;
//   dS (K13b) or P~ and dS (K13c), rounded to bf16, are repacked in registers
//   as the A operand of the next product, as K10 repacks p. No score passes
//   through shared memory (WMMA hid that layout: the old kernels stored S
//   and dP as fp32 and read them back twice).
// - The tensor cores read the other operand from shared memory themselves:
//   K and V (K13b), q * scale and dO (K13c), and K13c's K and V as A, in
//   wgmma.cuh's 128-byte swizzled layout, which one tile serves both K-major
//   (S = Q K^T) and MN-major (dQ = dS K). No ldmatrix and no operand
//   registers but q and dO's A fragments in K13b.
// - K13c computes the transposed products, S^T = K (q * scale)^T and dP^T =
//   V dO^T, with the keys as rows: P~^T and dS^T then come out of the
//   accumulators already as the A operand of dV += P~^T dO and dK += dS^T
//   (q * scale). No barrier and no shared-memory transposition sit between
//   its steps; lse and delta are per column in this orientation.
// - Overlap: S and dP are two commit groups; exp runs while dP is in the
//   tensor cores, and a pass's dQ (or dV, dK) product runs while the next
//   pass starts. The dropout keep bits are hashed while the products run.
// - Loads are asynchronous: K13b's 64-key K/V tiles come through a
//   three-stage cp.async ring with K and V in separate commit groups (V is
//   waited on after the first S product), K10's protocol; K13c's q and dO
//   tiles, with their lse and delta rows, through a two-stage ring, one
//   commit group a tile (each thread rescales the q chunks it copied once
//   they land: cp.async cannot scale). Tile j + 2 (K13b) or j + 1 (K13c) is
//   copied in while tile j's products run.
// - Interior tiles take no mask: K13b splits its kv loop as K10 does, K13c
//   masks only the diagonal q tile and the ragged tails (Sq or Skv).
// - Tiles and registers: 64-row tiles, each taken in two passes of 32 keys
//   (K13b) or 32 q rows (K13c). K13b holds q * scale and dO as A fragments
//   for the whole kv loop and dQ in fp32, 128 registers a thread at D 128,
//   and a pass's S and dP 32 more; K13c holds dK and dV (128) and a pass's
//   S^T and dP^T (32). A whole tile's scores at once, or the dropout hash
//   beside them, spilled the D 128 instances at 255 registers. At D 128
//   K13b's ring is 96 KB (q and dO are staged in its third slot before the
//   loop) and K13c's K, V and ring 97 KB: two blocks, two warpgroups, an SM,
//   each filling the tensor cores while the other computes its exp and dS.
// - The heaviest blocks start first (K13b: the last q tiles under
//   causality; K13c: the first key tiles), the query heads of one KV head
//   side by side so that their K/V meet in L2. Offsets are 64-bit.
// - The same kernels on mma.sync (ldmatrix, padded rows), the first form of
//   this design, and on wgmma with an unswizzled layout both ran slower on
//   the card; a producer warp feeding the ring by TMA (FlashAttention-3) is
//   the next step.
#include "flash_fwd.cuh"

namespace {

using flash::Dropout;
using gemm::at_sw128;
using flash::kLog2e;
using flash::keep_bits;
using flash::repack;
using gemm::cp_async16;
using gemm::cp_async4;
using gemm::cp_commit;
using gemm::cp_wait;
using gemm::fence_proxy_async;
using gemm::fence_regs;
using gemm::kmajor;
using gemm::ldmatrix_x4;
using gemm::mnmajor;
using gemm::pack_bf16;
using gemm::wgmma_commit;
using gemm::wgmma_fence;
using gemm::wgmma_rs;
using gemm::wgmma_ss_n32;
using gemm::wgmma_wait;
using gemm::zero;
using T = __nv_bfloat16;

constexpr int BT = 64;  // rows of a q tile and of a K/V tile
constexpr int kThreads = 128;  // one warpgroup: four warps of 16 rows
constexpr int kDqStages = 3;   // K13b's K/V ring
constexpr int kDkvStages = 2;  // K13c's q/dO ring
constexpr int SUB = 32;        // keys (K13b) or q rows (K13c) of one pass over a tile
static_assert(SUB == 32, "K13c's S^T and dP^T products are m64n32k16");

template <int D>
struct Tile {
  static constexpr size_t kBytes = size_t(BT) * D * 2;
};

// K13b: the K ring, then the V ring. q * scale and dO are staged in the
// third slots before the loop.
template <int D>
struct DqSmem {
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kDqStages * Tile<D>::kBytes;
  static constexpr size_t kBytes = 2 * kV;
};

// K13c: K, V, the q and dO rings, the lse and delta rows of each q slot.
template <int D>
struct DkvSmem {
  static constexpr size_t kK = 0;
  static constexpr size_t kV = Tile<D>::kBytes;
  static constexpr size_t kQ = 2 * Tile<D>::kBytes;
  static constexpr size_t kdO = kQ + kDkvStages * Tile<D>::kBytes;
  static constexpr size_t kLse = kdO + kDkvStages * Tile<D>::kBytes;
  static constexpr size_t kDelta = kLse + kDkvStages * BT * 4;
  static constexpr size_t kBytes = kDelta + kDkvStages * BT * 4;
};

__device__ __forceinline__ float finite_or_zero(float x) { return x == -INFINITY ? 0.f : x; }

// Start the cp.async copies of rows [r0, r0 + 64) of head h of a [B, S, H, D]
// bf16 tensor into a swizzled tile; rows at or past S are zero-filled.
// Consecutive threads copy consecutive 16-byte chunks of a row; thread t
// copies chunks t + j * kThreads (rescale_own relies on it).
template <int D>
__device__ __forceinline__ void copy_tile(T* s, const T* g, int b, int h, int r0, int S, int H) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  const size_t row = static_cast<size_t>(H) * D;
  const T* base = g + static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
#pragma unroll
  for (int j = 0; j < BT * CPR / kThreads; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int r = c / CPR, cc = c % CPR;
    const bool ok = r0 + r < S;
    cp_async16(at_sw128(s, r, cc * 8), base + (ok ? static_cast<size_t>(r0 + r) * row : 0) + cc * 8,
               ok);
  }
}

// q * scale in fp32, rounded to bf16, in place over the chunks this thread
// copied into the tile (copy_tile's assignment), once they have landed.
template <int D>
__device__ __forceinline__ void rescale_own(T* s, float scale) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int j = 0; j < BT * CPR / kThreads; ++j) {
    const int c = threadIdx.x + j * kThreads;
    T* p = at_sw128(s, c / CPR, (c % CPR) * 8);
    float f[8];
    load_vec(p, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= scale;
    store_vec(p, f);
  }
}

// ---------------------------------------------------------------------------
// K13b: dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* dq;
  int B, Sq, Skv, Hq, Hkv, causal;
  float scale;
  Dropout drop;
};

// The per-warp state of 16 q rows: this thread holds rows g and g + 8 of the
// warp's 16 (g = lane / 4), and in each 8-column n-tile the columns
// 2 * (lane % 4) and + 1 (wgmma.cuh's layout).
template <int D>
struct DqRows {
  uint32_t qa[D / 16][4];  // q * scale as A fragments, one a 16-wide k step
  uint32_t da[D / 16][4];  // dO as A fragments
  float dq[D / 8][4];      // dQ / scale: [n-tile of 8 dims][row g: 0, 1; row g+8: 2, 3]
  float lse2[2];           // lse * log2(e) of rows g, g + 8 (-inf and rows past Sq read as 0)
  float delta[2];
};

// Start the copies of K/V tile j into ring slot j % 3, K and V as two commit
// groups; every thread commits both, copies or not.
template <int D>
__device__ __forceinline__ void dq_load_kv(const DqArgs<D>& a, T* sK, T* sV, int j, int n_tiles,
                                           int b, int hk) {
  const int slot = j % kDqStages;
  if (j < n_tiles) copy_tile<D>(sK + slot * BT * D, a.k, b, hk, j * BT, a.Skv, a.Hkv);
  cp_commit();
  if (j < n_tiles) copy_tile<D>(sV + slot * BT * D, a.v, b, hk, j * BT, a.Skv, a.Hkv);
  cp_commit();
}

// One K/V tile for the block's 64 rows, in two passes of SUB keys: S =
// (q * scale) K^T and dP = dO V^T (64 x 32 each), dS = P * (dP - delta) in
// registers, dQ += dS K. A pass holds 32 fp32 scores a thread where the whole
// tile would hold 64; the passes share the q and dO fragments, and dQ adds
// the keys in the same order.
template <int D, bool kDrop, bool kMasked>
__device__ __forceinline__ void dq_tile(const DqArgs<D>& a, DqRows<D>& st, const T* sK,
                                        const T* sV, int j, int row0, uint32_t seed) {
  const int t4 = threadIdx.x % 4;
  const int slot = j % kDqStages;
  const T* k_t = sK + slot * BT * D;
  const T* v_t = sV + slot * BT * D;

#pragma unroll 1
  for (int hf = 0; hf < BT / SUB; ++hf) {
    const int key0 = hf * SUB;  // the pass's first key in the tile
    float s[SUB / 8][4], dp[SUB / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs<SUB, 0>(s, st.qa[kk], kmajor(k_t, key0, 16 * kk), kk > 0);
    wgmma_commit();
    if (hf == 0) {  // V lands while the first S product runs; wait for it only now
      cp_wait<4>();
      fence_proxy_async();
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs<SUB, 0>(dp, st.da[kk], kmajor(v_t, key0, 16 * kk), kk > 0);
    wgmma_commit();
    const uint32_t keep =
        kDrop ? keep_bits<SUB / 8, true>(j * BT + key0 + 2 * t4, row0, seed, a.drop.rate) : 0u;

    // P over S while dP runs (and the previous pass's dQ is done): rows g
    // (i = 0) and g + 8 (i = 1).
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fmaf(s[n][2 * i + e], kLog2e, -st.lse2[i]));
          if constexpr (kMasked) {
            const int col = j * BT + key0 + n * 8 + 2 * t4 + e;
            if (!(row < a.Sq && col < a.Skv && (!a.causal || row >= col))) p = 0.f;
          }
          s[n][2 * i + e] = p;
        }
      }
    }
    // dS over P.
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float d = dp[n][2 * i + e];
          if constexpr (kDrop) d = (keep >> (4 * n + 2 * i + e)) & 1u ? d * a.drop.inv_keep : 0.f;
          s[n][2 * i + e] *= d - st.delta[i];
        }
      }
    }

    // dQ += dS K: dS rounded to bf16 and repacked as A fragments, one per 16
    // keys; K as B, MN-major (the keys are K).
    uint32_t sa[SUB / 16][4];
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) repack(sa[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk)
      wgmma_rs<D, 1>(st.dq, sa[kk], mnmajor(k_t, key0 + 16 * kk), 1);
    wgmma_commit();  // waited for by the next pass, or below
  }
  wgmma_wait<0>();  // K's slot is refilled after the next tile's barrier
  fence_regs(st.dq);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(const DqArgs<D> a) {
  using S = DqSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + S::kK);
  T* sV = reinterpret_cast<T*>(smem + S::kV);

  // Block -> (q tile, batch, head): heads fastest, the heaviest q tiles first.
  const int n_qt = (a.Sq + BT - 1) / BT;
  const int h = blockIdx.x % a.Hq;
  const int rest = blockIdx.x / a.Hq;
  const int b = rest % a.B;
  const int qt = n_qt - 1 - rest / a.B;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t seed = kDrop ? flash::fold_seed(a.drop.seed, b, h) : 0u;

  int tokens = a.Skv;
  if (a.causal) tokens = min(tokens, q0 + BT);
  const int n_tiles = (tokens + BT - 1) / BT;
  // Interior tiles: every key at or below the tile's first row and inside Skv.
  int n_full = a.causal ? q0 / BT : n_tiles;
  n_full = min(min(n_full, a.Skv / BT), n_tiles);

  // q and dO of the tile, staged in the rings' third slots.
  T* sQ = sK + 2 * BT * D;
  T* sdO = sV + 2 * BT * D;
  copy_tile<D>(sQ, a.q, b, h, q0, a.Sq, a.Hq);
  copy_tile<D>(sdO, a.dout, b, h, q0, a.Sq, a.Hq);
  cp_commit();
  dq_load_kv<D>(a, sK, sV, 0, n_tiles, b, hk);
  dq_load_kv<D>(a, sK, sV, 1, n_tiles, b, hk);

  DqRows<D> st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + warp * 16 + g + 8 * i;
    const size_t si = (static_cast<size_t>(b) * a.Hq + h) * a.Sq + qr;
    st.lse2[i] = qr < a.Sq ? finite_or_zero(a.lse[si]) * kLog2e : 0.f;
    st.delta[i] = qr < a.Sq ? a.delta[si] : 0.f;
  }
  zero(st.dq);
  cp_wait<4>();  // q and dO landed; K_0, V_0, K_1, V_1 may be in flight
  rescale_own<D>(sQ, a.scale);
  __syncthreads();
  {
    // A fragments of the warp's 16 rows: matrices (rows lo, k lo), (rows hi,
    // k lo), (rows lo, k hi), (rows hi, k hi), each one core matrix.
    const int mi = lane / 8, r = lane % 8;
    const int row = warp * 16 + (mi & 1) * 8 + r;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(st.qa[kk], at_sw128(sQ, row, kk * 16 + (mi >> 1) * 8));
      ldmatrix_x4(st.da[kk], at_sw128(sdO, row, kk * 16 + (mi >> 1) * 8));
    }
  }
  const int row0 = q0 + warp * 16 + g;

  // Groups in flight at the top of tile j: K_j, V_j, K_j+1, V_j+1 (and older,
  // complete ones). wait_group 3 leaves V_j, K_j+1, V_j+1 pending.
  int j = 0;
  for (; j < n_full; ++j) {
    cp_wait<3>();
    fence_proxy_async();
    __syncthreads();  // K_j visible to all; every warp is done with slot (j + 2) % 3
    dq_load_kv<D>(a, sK, sV, j + 2, n_tiles, b, hk);
    dq_tile<D, kDrop, false>(a, st, sK, sV, j, row0, seed);
  }
  for (; j < n_tiles; ++j) {
    cp_wait<3>();
    fence_proxy_async();
    __syncthreads();
    dq_load_kv<D>(a, sK, sV, j + 2, n_tiles, b, hk);
    dq_tile<D, kDrop, true>(a, st, sK, sV, j, row0, seed);
  }
  cp_wait<0>();

  // dq = scale * dQ, rounded to bf16; rows past Sq are not stored.
  const size_t q_row = static_cast<size_t>(a.Hq) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = row0 + 8 * i;
    if (qr < a.Sq) {
      T* out = a.dq + (static_cast<size_t>(b) * a.Sq + qr) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) =
            pack_bf16(st.dq[n][2 * i] * a.scale, st.dq[n][2 * i + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K13c: dK and dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  float* dk;
  float* dv;
  int B, Sq, Skv, Hq, Hkv, causal;
  float scale;
  Dropout drop;
};

// Start the copies of q tile it (q and dO rows, lse and delta) into ring slot
// `slot` as one commit group; threads 0-63 copy the lse, 64-127 the delta
// (zero past Sq). Every thread commits, copies or not.
template <int D>
__device__ __forceinline__ void dkv_load_q(const DkvArgs<D>& a, unsigned char* smem, int it,
                                           int n_qt, int slot, int b, int h) {
  using S = DkvSmem<D>;
  if (it < n_qt) {
    const int q0 = it * BT;
    copy_tile<D>(reinterpret_cast<T*>(smem + S::kQ) + slot * BT * D, a.q, b, h, q0, a.Sq, a.Hq);
    copy_tile<D>(reinterpret_cast<T*>(smem + S::kdO) + slot * BT * D, a.dout, b, h, q0, a.Sq,
                 a.Hq);
    const int which = threadIdx.x / BT, rr = threadIdx.x % BT;
    const bool ok = q0 + rr < a.Sq;
    const size_t row0 = (static_cast<size_t>(b) * a.Hq + h) * a.Sq;
    float* dst = reinterpret_cast<float*>(smem + (which == 0 ? S::kLse : S::kDelta)) + slot * BT;
    cp_async4(dst + rr, (which == 0 ? a.lse : a.delta) + row0 + (ok ? q0 + rr : 0), ok);
  }
  cp_commit();
}

// One q tile for the block's 64 keys, in two passes of SUB q rows (as
// dq_tile, for the registers): S^T = K (q * scale)^T and dP^T = V dO^T
// (64 keys x 32 q rows each, K and V as A from shared memory), P~^T and dS^T
// in registers, dV += P~^T dO and dK += dS^T (q * scale). dK and dV add the
// q rows in the same order.
template <int D, bool kDrop, bool kMasked>
__device__ __forceinline__ void dkv_tile(const DkvArgs<D>& a, float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4], const T* sK, const T* sV,
                                         const T* q_t, const T* do_t, const float* lse_t,
                                         const float* delta_t, int q0, int key0,
                                         uint32_t seed) {
  const int t4 = threadIdx.x % 4;

#pragma unroll 1
  for (int hf = 0; hf < BT / SUB; ++hf) {
    const int r0 = hf * SUB;  // the pass's first q row in the tile
    float s[SUB / 8][4], dp[SUB / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(s, kmajor(sK, 0, 16 * kk), kmajor(q_t, r0, 16 * kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(dp, kmajor(sV, 0, 16 * kk), kmajor(do_t, r0, 16 * kk), kk > 0);
    wgmma_commit();
    // the dropout keep bits, hashed while the products run
    const uint32_t keep =
        kDrop ? keep_bits<SUB / 8, false>(q0 + r0 + 2 * t4, key0, seed, a.drop.rate) : 0u;

    // P over S^T while dP^T runs: keys g (i = 0) and g + 8 (i = 1), q rows
    // r0 + n * 8 + 2 * t4 + e of the tile.
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int n = 0; n < SUB / 8; ++n) {
      const int c = r0 + n * 8 + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float lse2[2] = {finite_or_zero(l2.x) * kLog2e, finite_or_zero(l2.y) * kLog2e};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(fmaf(s[n][2 * i + e], kLog2e, -lse2[e]));
          if constexpr (kMasked) {
            const int qr = q0 + c + e, key = key0 + 8 * i;
            if (!(qr < a.Sq && key < a.Skv && (!a.causal || qr >= key))) p = 0.f;
          }
          s[n][2 * i + e] = p;
        }
      }
    }
    // P~^T over P and dS^T over dP^T.
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < SUB / 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + r0 + n * 8 + 2 * t4);
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = s[n][2 * i + e];
          float d = dp[n][2 * i + e];
          float pt = p;
          if constexpr (kDrop) {
            const bool kept = (keep >> (4 * n + 2 * i + e)) & 1u;
            pt = kept ? p * a.drop.inv_keep : 0.f;
            d = kept ? d * a.drop.inv_keep : 0.f;
          }
          s[n][2 * i + e] = pt;
          dp[n][2 * i + e] = p * (d - dl[e]);
        }
      }
    }

    // dV += P~^T dO and dK += dS^T (q * scale): P~^T and dS^T rounded to bf16
    // and repacked as A fragments, one per 16 q rows; dO and q * scale as B,
    // MN-major (the q rows are K).
    uint32_t pa[SUB / 16][4], sa[SUB / 16][4];
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) {
      repack(pa[kk], s, kk);
      repack(sa[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) {
      wgmma_rs<D, 1>(dv, pa[kk], mnmajor(do_t, r0 + 16 * kk), 1);
      wgmma_rs<D, 1>(dk, sa[kk], mnmajor(q_t, r0 + 16 * kk), 1);
    }
    wgmma_commit();  // waited for by the next pass, or below
  }
  wgmma_wait<0>();  // the q/dO slot is refilled after the next tile's barrier
  fence_regs(dv);
  fence_regs(dk);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_kernel(const DkvArgs<D> a) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + S::kK);
  T* sV = reinterpret_cast<T*>(smem + S::kV);

  // Block -> (key tile, batch, head): heads fastest, the first key tiles (the
  // most q tiles under causality) first.
  const int h = blockIdx.x % a.Hq;
  const int rest = blockIdx.x / a.Hq;
  const int b = rest % a.B;
  const int kt = rest / a.B;
  const int hk = h / (a.Hq / a.Hkv);
  const int kv0 = kt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t seed = kDrop ? flash::fold_seed(a.drop.seed, b, h) : 0u;

  const int n_qt = (a.Sq + BT - 1) / BT;
  // Causal: q tiles wholly above the diagonal see none of these keys.
  const int it0 = a.causal ? kv0 / BT : 0;
  const bool keys_ragged = kv0 + BT > a.Skv;

  copy_tile<D>(sK, a.k, b, hk, kv0, a.Skv, a.Hkv);
  copy_tile<D>(sV, a.v, b, hk, kv0, a.Skv, a.Hkv);
  dkv_load_q<D>(a, smem, it0, n_qt, 0, b, h);  // K and V commit with q tile it0

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  const int key0 = kv0 + warp * 16 + g;

  for (int it = it0; it < n_qt; ++it) {
    const int slot = (it - it0) % kDkvStages;
    T* q_t = reinterpret_cast<T*>(smem + S::kQ) + slot * BT * D;
    cp_wait<0>();  // this thread's copies of q tile it have landed
    rescale_own<D>(q_t, a.scale);
    fence_proxy_async();
    __syncthreads();  // tile it visible to all; every warp is done with the other slot
    dkv_load_q<D>(a, smem, it + 1, n_qt, (it + 1 - it0) % kDkvStages, b, h);
    const T* do_t = reinterpret_cast<const T*>(smem + S::kdO) + slot * BT * D;
    const float* lse_t = reinterpret_cast<const float*>(smem + S::kLse) + slot * BT;
    const float* delta_t = reinterpret_cast<const float*>(smem + S::kDelta) + slot * BT;
    const int q0 = it * BT;
    const bool masked = keys_ragged || q0 + BT > a.Sq || (a.causal && q0 < kv0 + BT - 1);
    if (masked)
      dkv_tile<D, kDrop, true>(a, dk, dv, sK, sV, q_t, do_t, lse_t, delta_t, q0, key0, seed);
    else
      dkv_tile<D, kDrop, false>(a, dk, dv, sK, sV, q_t, do_t, lse_t, delta_t, q0, key0, seed);
  }
  cp_wait<0>();

  // The warp's keys below Skv, fp32 per query head.
  const size_t grow = static_cast<size_t>(a.Hq) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key < a.Skv) {
      const size_t off =
          (static_cast<size_t>(b) * a.Skv + key) * grow + static_cast<size_t>(h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(a.dk + off + n * 8 + 2 * t4) =
            make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<float2*>(a.dv + off + n * 8 + 2 * t4) =
            make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

template <typename Kernel, typename Args>
cudaError_t launch_grid(Kernel kernel, const Args& a, size_t smem, long long blocks,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D, bool kDrop>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                       const float* delta, T* dq, float* dk, float* dv, int B, int Sq, int Skv,
                       int Hq, int Hkv, float scale, int causal, Dropout drop, cudaStream_t s) {
  if (dq != nullptr) {
    const DqArgs<D> a{q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, scale, drop};
    const long long blocks = static_cast<long long>((Sq + BT - 1) / BT) * Hq * B;
    return launch_grid(flash_bwd_dq_kernel<D, kDrop>, a, DqSmem<D>::kBytes, blocks, s);
  }
  const DkvArgs<D> a{q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal, scale, drop};
  const long long blocks = static_cast<long long>((Skv + BT - 1) / BT) * Hq * B;
  return launch_grid(flash_bwd_dkv_kernel<D, kDrop>, a, DkvSmem<D>::kBytes, blocks, s);
}

cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dq, float* dk, float* dv,
                         int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
                         Dropout drop, cudaStream_t s) {
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
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
  return flash::launch_fwd<true>(q, k, v, out, lse, nullptr, Skv, B, Sq, Skv, Hq, Hkv, D, 0,
                                 scale, causal,
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
