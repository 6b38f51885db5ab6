// Single-token decode attention, shared by K3 (decode_attn.cu: the
// contiguous [L, B, Smax, Hkv, D] cache) and K7 (paged_attn.cu: the
// [L, NB, bs, Hkv, D] block-table pools). The two differ only in where a
// sequence's token row lives and how far its context reaches, which the
// Rows policy of each source gives, and in their rounding (kRoundGrouped).
//
// For each sequence b and query head h (kv head h / G):
//   out[b, h] = softmax(q[b, h] . K[b, :n_b, h/G]^T * scale) @ V[b, :n_b, h/G]
// with n_b = rows.count(b, ctx). Slots at or past n_b are never read. A
// sequence with n_b == 0 gives 0.
//
// Bound: bytes. One query token meets n_b cached tokens, so each K/V byte
// read feeds 2 * G flops: ~1 flop per byte at G = 1, far below the H100's
// ~295 flops per byte (SXM data sheet). The design reads every valid K/V byte
// once, with 16-byte loads: one block per (b, kv head) so the G query heads
// of a group share each K/V row; D / 8 lanes (bf16) cover one token's row, so
// a warp reads 32 * 16 contiguous-per-token bytes per step, and each step
// keeps kUnroll tokens of K and V in flight to cover the load latency.
// Softmax is online in fp32, one running (max, sum, acc) per lane group,
// merged across groups by shuffles and across warps in shared memory. B * Hkv
// blocks (96 at GPT-2 batch 8) leave some of the 132 SMs idle; splitting the
// context across blocks is later work.
//
// Rounding: with kRoundGrouped and G > 1 the scaled query and the
// probabilities are rounded to T before their products (K3, as the MXU path
// of _decode_kernel); otherwise everything stays fp32 (K3 at G == 1, K7).
//
// INT8 caches (TC = int8_t): each slot row of a kv head carries an fp32
// scale at element offset / D of the [.., Hkv] scale array beside the
// cache. A lane reads its 8 int8 values with one 8-byte load (the bf16
// cache's 16-byte load covers the same 8 elements, so the lane layout is
// the same), the K scale multiplies the fp32 score after the dot and the V
// scale the probability before the PV product, while l sums the unscaled
// probabilities: the fused dequant of _decode_kernel's kv_quant path. At
// half the bytes a slot, the bound halves.
#pragma once

#include "common.cuh"

#include <math.h>

namespace decode_attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;

// Rows policy: count(b, ctx) is the number of valid slots of sequence b;
// offset(b, hk, t) the element offset of slot t's row of kv head hk.
// ks, vs: the INT8 cache's scales (TC = int8_t), else null.
template <typename T, typename TC, int D, int G, bool kRoundGrouped, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const int* __restrict__ ctx, T* __restrict__ out, Rows rows, int Hkv,
              float scale) {
  constexpr int V = 8;                // elements a lane holds of a row
  constexpr int LPT = D / V;          // lanes per token row
  constexpr int TPI = 32 / LPT;       // tokens per warp step
  constexpr int STEP = kWarps * TPI;  // tokens per block step
  constexpr bool kRound = kRoundGrouped && G > 1;
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static_assert(Vec16<T>::N == V, "q is a 16-bit type");
  static_assert(LPT <= 32 && 32 % LPT == 0, "head_dim must fit one warp");

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPT;  // token slot within the warp step
  const int sub = lane % LPT;  // 16-byte chunk of the row
  const int Hq = Hkv * G;
  const int n = rows.count(b, ctx);

  float qf[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec(q + (static_cast<size_t>(b) * Hq + hk * G + g) * D + sub * V, qf[g]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qf[g][i] *= scale;
      if (kRound) qf[g][i] = round_to<T>(qf[g][i]);
    }
  }

  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[g][i] = 0.f;
  }

  const TC* kp = kc + sub * V;
  const TC* vp = vc + sub * V;

  for (int t0 = warp * TPI; t0 < n; t0 += STEP * kUnroll) {
    Raw8<TC> kraw[kUnroll], vraw[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * STEP + grp;
      ksc[u] = vsc[u] = 1.f;
      if (t < n) {
        const size_t off = rows.offset(b, hk, t);
        kraw[u] = *reinterpret_cast<const Raw8<TC>*>(kp + off);
        vraw[u] = *reinterpret_cast<const Raw8<TC>*>(vp + off);
        if (kQuant) {
          ksc[u] = ks[off / D];
          vsc[u] = vs[off / D];
        }
      } else {
        kraw[u] = zero8<TC>();
        vraw[u] = zero8<TC>();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = t0 + u * STEP + grp < n;
      float kv[V], vv[V];
      unpack8<TC>(kraw[u], kv);
      unpack8<TC>(vraw[u], vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) s += qf[g][i] * kv[i];
        // every lane takes part in the shuffles; invalid slots are dropped below
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (kQuant) s *= ksc[u];
        if (valid) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
          const float pq = kQuant ? p * vsc[u] : p;
          const float pv = kRound ? round_to<T>(pq) : pq;
#pragma unroll
          for (int i = 0; i < V; ++i) acc[g][i] = acc[g][i] * alpha + pv * vv[i];
          m[g] = m_new;
        }
      }
    }
  }

  // Merge the TPI lane groups of this warp: after the xor steps over the
  // group bits every group holds the warp's (max, sum, acc).
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mw = m[g];
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float f = (m[g] == -INFINITY) ? 0.f : expf(m[g] - mw);
    float lw = l[g] * f;
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float a = acc[g][i] * f;
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[g][i] = a;
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) sm_acc[warp][g][sub * V + i] = acc[g][i];
      if (sub == 0) {
        sm_m[warp][g] = mw;
        sm_l[warp][g] = lw;
      }
    }
  }
  __syncthreads();

  // Merge the warps and write [G, D] outputs; l == 0 (no valid token) gives 0.
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = (sm_m[w][g] == -INFINITY) ? 0.f : expf(sm_m[w][g] - mx);
      lt += sm_l[w][g] * f;
      o += sm_acc[w][g][d] * f;
    }
    const float l_safe = (lt == 0.f) ? 1.f : lt;
    out[(static_cast<size_t>(b) * Hq + hk * G + g) * D + d] = from_f32<T>(o / l_safe);
  }
}

// One launch of B * Hkv blocks, the instance picked by (D, G).
template <typename T, typename TC, bool kRoundGrouped, class Rows>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* ctx, void* out, int B, int Hkv, int G, int D,
                      const Rows& rows, float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const TC* kp = static_cast<const TC*>(k);
  const TC* vp = static_cast<const TC*>(v);
  T* op = static_cast<T*>(out);
  const dim3 grid(B * Hkv);
#define MLIO_DECODE_ATTN_CASE(DD, GG)                                                 \
  if (D == DD && G == GG) {                                                           \
    decode_kernel<T, TC, DD, GG, kRoundGrouped, Rows>                                 \
        <<<grid, kThreads, 0, s>>>(qp, kp, vp, ks, vs, ctx, op, rows, Hkv, scale);    \
    return cudaGetLastError();                                                        \
  }
  MLIO_DECODE_ATTN_CASE(64, 1) MLIO_DECODE_ATTN_CASE(64, 2)
  MLIO_DECODE_ATTN_CASE(64, 4) MLIO_DECODE_ATTN_CASE(64, 8)
  MLIO_DECODE_ATTN_CASE(128, 1) MLIO_DECODE_ATTN_CASE(128, 2)
  MLIO_DECODE_ATTN_CASE(128, 4) MLIO_DECODE_ATTN_CASE(128, 8)
#undef MLIO_DECODE_ATTN_CASE
  return cudaErrorInvalidValue;
}

// The bf16 cache's instances, or with scales (ks != null) the int8 cache's.
template <typename T, bool kRoundGrouped, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* ctx, void* out, int B, int Hkv, int G, int D,
                   const Rows& rows, float scale, cudaStream_t s) {
  if (ks != nullptr)
    return launch_tc<T, int8_t, kRoundGrouped, Rows>(q, k, v, ks, vs, ctx, out, B, Hkv, G, D,
                                                     rows, scale, s);
  return launch_tc<T, T, kRoundGrouped, Rows>(q, k, v, nullptr, nullptr, ctx, out, B, Hkv, G,
                                              D, rows, scale, s);
}

}  // namespace decode_attn
