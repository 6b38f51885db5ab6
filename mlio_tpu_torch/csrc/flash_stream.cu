// K10: the long-context flash attention forward for Hopper.
//
// Replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_stream_kernel (its
// pallas_call at :657), the JAX package's forward once one head's K/V pass
// its VMEM budget. q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] in the bshd layout,
// out [B, Sq, Hq, D]:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale) @ v[b, j, h/G]
// over keys j < kv_len[b] and, when causal, j <= i + q_offset; a row with no
// valid key gives 0. The kLse instance also writes lse[b, h, i] = m + log(l)
// in fp32 [B, Hq, Sq], -inf for a row with no valid key.
//
// Bound, at the long-context path's call (Mistral-7B-Instruct-v0.2: B 1, a
// 32,704-token prompt over a 32,768-slot cache holding 32,704 tokens, 32
// query and 8 KV heads of 128, causal): the causal pairs are 32,704 x 32,705 /
// 2 = 5.35e8 a head, so QK^T and PV take 4 x 128 x 32 x 5.35e8 = 8.76 TFLOP,
// 8.86 ms at 989 TFLOP/s (bf16 tensor cores), against 0.67 GB of q, out and
// the valid K/V rows, about 0.2 ms at the card's memory rate: bound by
// operations, 40 times over. So the tensor cores must do the work, and
// everything else must keep out of their way: the design keeps the softmax
// state and both products' operands in registers, hides the K/V loads behind
// the products, and spends no mask arithmetic where no mask applies.
//
// The design, for Hopper rather than copied from the TPU's blocks:
// - One block per (q tile of 128 rows, query head, batch), eight warps of 16
//   rows each. The TPU kernel takes up to 1024 rows a tile so that K/V are
//   fetched fewer times (:625); here 128 rows are what the registers hold
//   (the fp32 output accumulator of 16 rows x D a warp) and the shared memory
//   allows beside the K/V ring. The heaviest q tiles (the last, under
//   causality) are scheduled first, the query heads of one KV head side by
//   side so that their K/V meet in L2.
// - The K/V stream: 64-key tiles through a three-stage cp.async ring, the
//   counterpart of the TPU kernel's depth-3 DMA slots (:362-397). Tile j + 2
//   is copied in while tile j's products run; K and V are committed as
//   separate groups, and V is waited on only after the QK^T product. At
//   D = 128: Q 34 KB and the two rings 102 KB of shared memory, rows padded
//   by 16 bytes so that ldmatrix reads eight rows on distinct banks.
// - Interior and edge tiles: the kv loop runs in two parts. Interior tiles
//   lie wholly below the causal diagonal of the tile's first row and inside
//   kv_len: no mask and no -inf guards. Edge tiles (the diagonal and the
//   kv_len tail) are masked. At a 32K context nearly every tile is interior.
// - Both products on the tensor cores with mma.sync m16n8k16 (bf16 inputs,
//   fp32 accumulate): Q stays in registers as A fragments for the whole kv
//   loop, the scores land in registers in the accumulator layout, and p,
//   rounded to bf16, is repacked in registers as the A fragments of the PV
//   product (FlashAttention-2's layout); K and V enter through ldmatrix (V
//   transposed). Nothing is staged through shared memory but K and V.
// - Limits: the causal early exit at min(kv_len[b], q_start + q_offset + 128);
//   a per-batch kv_len array or one scalar; keys past kv_len are zero-filled
//   by the copy (never read past the tensor); rows past Sq are zero and not
//   stored. Offsets are 64-bit.
//
// Rounding follows _flash_fwd_stream_kernel: the scale is folded into q in
// fp32 and rounded back to bf16; the online (m, l, acc) state is fp32; p is
// rounded to bf16 for the PV product while l adds the fp32 p; out = acc / l.
// exp is taken as exp2 of the score times log2(e), a few fp32 ulps from exp.
//
// A simple kernel that is right: wgmma and TMA are later work.
#include "cp_async.cuh"

#include <math.h>

namespace stream {

constexpr int BQ = 128;  // query rows a block
constexpr int BKV = 64;  // keys a K/V tile
constexpr int kWarps = BQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;  // the cp.async ring's depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // bf16 elements a row: 16 bytes of pad
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + size_t(BQ) * LD * 2;
  static constexpr size_t kV = kK + size_t(kStages) * BKV * LD * 2;
  static constexpr size_t kBytes = kV + size_t(kStages) * BKV * LD * 2;
};

using gemm::cp_async16;
using gemm::cp_commit;
using gemm::cp_wait;
using gemm::pack_bf16;

template <int D>
struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  float* lse;
  const int* kv_len_arr;
  int kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset, causal;
  float scale;
};

// Start the cp.async copies of K/V tile j (rows kv0..kv0+63 of KV head hk)
// into ring slot j % kStages, K and V as two commit groups. Rows at or past
// kvl are zero-filled. Every thread commits both groups, copies or not, so
// that the group counts stay uniform.
template <int D>
__device__ __forceinline__ void load_tile(const Args<D>& a, __nv_bfloat16* sK,
                                          __nv_bfloat16* sV, int j, int n_tiles, int b, int hk,
                                          int kvl) {
  using S = Smem<D>;
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  const bool live = j < n_tiles;
  const int slot = j % kStages;
  const size_t kv_row = static_cast<size_t>(a.Hkv) * D;
  const size_t base = static_cast<size_t>(b) * a.Skv * kv_row + static_cast<size_t>(hk) * D;
  if (live) {
#pragma unroll
    for (int c = threadIdx.x; c < BKV * CPR; c += kThreads) {
      const int r = c / CPR, cc = c % CPR;
      const int t = j * BKV + r;
      const bool ok = t < kvl;
      const size_t off = base + (ok ? static_cast<size_t>(t) * kv_row : 0) + cc * 8;
      cp_async16(sK + (slot * BKV + r) * S::LD + cc * 8, a.k + off, ok);
    }
  }
  cp_commit();
  if (live) {
#pragma unroll
    for (int c = threadIdx.x; c < BKV * CPR; c += kThreads) {
      const int r = c / CPR, cc = c % CPR;
      const int t = j * BKV + r;
      const bool ok = t < kvl;
      const size_t off = base + (ok ? static_cast<size_t>(t) * kv_row : 0) + cc * 8;
      cp_async16(sV + (slot * BKV + r) * S::LD + cc * 8, a.v + off, ok);
    }
  }
  cp_commit();
}

// The per-warp state of 16 query rows: this thread holds rows g and g + 8 of
// the warp's 16 (g = lane / 4), and in each 8-column n-tile the columns
// 2 * (lane % 4) and + 1.
template <int D>
struct Rows {
  uint32_t qa[D / 16][4];  // q * scale (bf16) as A fragments, one a 16-wide k step
  float o[D / 8][4];       // output accumulator: [n-tile of 8 dims][row g: 0, 1; row g+8: 2, 3]
  float m[2], l[2];        // running max and this thread's part of the row sum
};

// One K/V tile: S = Q K^T (16 x 64 a warp), the online softmax, O += P V.
template <int D, bool kMasked>
__device__ __forceinline__ void tile(const Args<D>& a, Rows<D>& st, const __nv_bfloat16* sK,
                                     const __nv_bfloat16* sV, int j, int row_abs0, int kvl) {
  using S = Smem<D>;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int slot = j % kStages;
  const __nv_bfloat16* k_t = sK + slot * BKV * S::LD;
  const __nv_bfloat16* v_t = sV + slot * BKV * S::LD;

  // S = Q K^T: eight n-tiles of 8 keys. ldmatrix x4 reads two n-tiles' K rows
  // (keys n0 .. n0+15) at one 16-wide k step: matrices (n-tile 0, dims lo),
  // (n-tile 0, dims hi), (n-tile 1, dims lo), (n-tile 1, dims hi).
  float s[BKV / 8][4];
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  {
    const int mi = lane / 8, r = lane % 8;
#pragma unroll
    for (int np = 0; np < BKV / 16; ++np) {
      const __nv_bfloat16* kp = k_t + (np * 16 + (mi >> 1) * 8 + r) * S::LD + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        gemm::ldmatrix_x4(b, kp + kk * 16);
        gemm::mma16816(s[2 * np], st.qa[kk], b[0], b[1]);
        gemm::mma16816(s[2 * np + 1], st.qa[kk], b[2], b[3]);
      }
    }
  }

  // V lands while the QK^T product runs; wait for it only now.
  cp_wait<4>();
  __syncthreads();

  // Online softmax over this tile, rows g (i = 0) and g + 8 (i = 1).
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (kMasked) {
      const int row_abs = row_abs0 + 8 * i;
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * BKV + n * 8 + 2 * t4 + e;
          const bool ok = col < kvl && (!a.causal || row_abs >= col);
          if (!ok) s[n][2 * i + e] = -INFINITY;
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[i], mx);
    float m_safe = m_new;
    if constexpr (kMasked) {
      m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = (st.m[i] == -INFINITY) ? 0.f : exp2f((st.m[i] - m_safe) * kLog2e);
    } else {
      alpha[i] = exp2f((st.m[i] - m_safe) * kLog2e);  // exp(-inf) = 0 on the first tile
    }
    const float mb = m_safe * kLog2e;
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[n][2 * i + e], kLog2e, -mb));  // exp(-inf) = 0
        s[n][2 * i + e] = p;
        psum += p;
      }
    }
    st.l[i] = st.l[i] * alpha[i] + psum;
    st.m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // O += P V: p rounded to bf16 and repacked as A fragments, one per 16 keys
  // (n-tiles 2kk and 2kk+1); V through ldmatrix.trans, matrices (keys lo,
  // dims n0), (keys hi, dims n0), (keys lo, dims n0+8), (keys hi, dims n0+8).
  const int mi = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const __nv_bfloat16* vp = v_t + (kk * 16 + (mi & 1) * 8 + r) * S::LD + (mi >> 1) * 8;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      gemm::ldmatrix_x4_trans(b, vp + np * 16);
      gemm::mma16816(st.o[2 * np], pa, b[0], b[1]);
      gemm::mma16816(st.o[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1) flash_stream_kernel(const Args<D> a) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);

  // Block -> (q tile, batch, head): heads fastest, the heaviest q tiles first.
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int h = blockIdx.x % a.Hq;
  const int rest = blockIdx.x / a.Hq;
  const int b = rest % a.B;
  const int qt = n_qt - 1 - rest / a.B;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_start = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const int kvl = min(a.kv_len_arr != nullptr ? a.kv_len_arr[b] : a.kv_len_scalar, a.Skv);
  int tokens = kvl;
  if (a.causal) tokens = min(tokens, q_start + a.q_offset + BQ);
  const int n_tiles = tokens > 0 ? (tokens + BKV - 1) / BKV : 0;
  // Interior tiles: every key at or below the tile's first row and inside kvl.
  const int first_row = q_start + a.q_offset;
  int n_full = a.causal ? (first_row > 0 ? first_row / BKV : 0) : n_tiles;
  n_full = min(min(n_full, kvl / BKV), n_tiles);

  // The scaled Q tile: q * scale in fp32, rounded to bf16; rows past Sq are 0.
  constexpr int CPR = D / 8;
  const size_t q_row = static_cast<size_t>(a.Hq) * D;
  for (int c = threadIdx.x; c < BQ * CPR; c += kThreads) {
    const int rr = c / CPR, cc = c % CPR;
    const int qr = q_start + rr;
    float f[8];
    if (qr < a.Sq) {
      load_vec(a.q + (static_cast<size_t>(b) * a.Sq + qr) * q_row + static_cast<size_t>(h) * D +
                   cc * 8,
               f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] *= a.scale;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    store_vec(sQ + rr * S::LD + cc * 8, f);
  }
  load_tile<D>(a, sK, sV, 0, n_tiles, b, hk, kvl);
  load_tile<D>(a, sK, sV, 1, n_tiles, b, hk, kvl);
  __syncthreads();

  Rows<D> st;
  {
    // A fragments of the warp's 16 rows: matrices (rows lo, k lo), (rows hi,
    // k lo), (rows lo, k hi), (rows hi, k hi).
    const int mi = lane / 8, r = lane % 8;
    const __nv_bfloat16* qp = sQ + (warp * 16 + (mi & 1) * 8 + r) * S::LD + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) gemm::ldmatrix_x4(st.qa[kk], qp + kk * 16);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
  const int row_abs0 = first_row + warp * 16 + g;

  // Groups in flight at the top of tile j: K_j, V_j, K_j+1, V_j+1 (and
  // older, complete ones). wait_group 3 leaves V_j, K_j+1, V_j+1 pending.
  int j = 0;
  for (; j < n_full; ++j) {
    cp_wait<3>();
    __syncthreads();  // K_j visible to all; every warp is done with slot (j + 2) % 3
    load_tile<D>(a, sK, sV, j + 2, n_tiles, b, hk, kvl);
    tile<D, false>(a, st, sK, sV, j, row_abs0, kvl);
  }
  for (; j < n_tiles; ++j) {
    cp_wait<3>();
    __syncthreads();
    load_tile<D>(a, sK, sV, j + 2, n_tiles, b, hk, kvl);
    tile<D, true>(a, st, sK, sV, j, row_abs0, kvl);
  }
  cp_wait<0>();

  // out = acc / l (0 for a row with no valid key); lse = m + log(l).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f) ? 1.f : l;
    const int qr = q_start + warp * 16 + g + 8 * i;
    if (qr < a.Sq) {
      __nv_bfloat16* orow =
          a.out + (static_cast<size_t>(b) * a.Sq + qr) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
            pack_bf16(st.o[n][2 * i] / l_safe, st.o[n][2 * i + 1] / l_safe);
      if (kLse && t4 == 0)
        a.lse[(static_cast<size_t>(b) * a.Hq + h) * a.Sq + qr] =
            (l == 0.f) ? -INFINITY : (st.m[i] == -INFINITY ? 0.f : st.m[i]) + logf(l_safe);
    }
  }
}

template <int D, bool kLse>
cudaError_t launch_d(const Args<D>& a, cudaStream_t s) {
  constexpr size_t smem = Smem<D>::kBytes;
  auto kernel = flash_stream_kernel<D, kLse>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((a.Sq + BQ - 1) / BQ) * a.Hq * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   const int* kv_len, int kv_len_scalar, int B, int Sq, int Skv, int Hq, int Hkv,
                   int q_offset, float scale, int causal, cudaStream_t s) {
  const Args<D> a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse,
                  kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset, causal, scale};
  return lse != nullptr ? launch_d<D, true>(a, s) : launch_d<D, false>(a, s);
}

}  // namespace stream

// q, out: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D], all contiguous bf16. lse is
// an fp32 [B, Hq, Sq] output, or null for the instance without it. kv_len is
// a [B] int32 device array, or null to use kv_len_scalar for every sequence.
// D in {64, 128}; Hq a multiple of Hkv.
extern "C" int mlio_flash_stream(const void* q, const void* k, const void* v, void* out,
                                 float* lse, const int* kv_len, int kv_len_scalar, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, int q_offset, float scale,
                                 int causal, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return stream::launch<64>(q, k, v, out, lse, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv,
                              q_offset, scale, causal, s);
  if (D == 128)
    return stream::launch<128>(q, k, v, out, lse, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv,
                               q_offset, scale, causal, s);
  return cudaErrorInvalidValue;
}
