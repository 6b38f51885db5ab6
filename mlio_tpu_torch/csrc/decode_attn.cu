// K3: single-token decode attention over the contiguous KV cache, for Hopper.
//
// Replaces mlio_tpu/ops/decode_attention.py::_decode_kernel. For each
// sequence b and query head h (kv head h / G):
//   out[b, h] = softmax(q[b, h] . K[layer, b, :ctx[b], h/G]^T * scale)
//               @ V[layer, b, :ctx[b], h/G]
// over the [L, B, Smax, Hkv, D] cache, with ctx[b] counting the current
// token. Slots at or past ctx[b] are never read (the TPU kernel's skip of
// blocks past the context). A sequence with ctx[b] == 0 gives 0.
//
// Bound: bytes. One query token meets ctx[b] cached tokens, so each K/V byte
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
// Rounding follows _decode_kernel: with G == 1 everything stays fp32; with
// G > 1 the scaled query and the probabilities are rounded to the cache's
// dtype before their products, as its MXU path does.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ ctx,
              T* __restrict__ out, int B, int Smax, int Hkv, int layer, float scale) {
  constexpr int V = Vec16<T>::N;
  constexpr int LPT = D / V;          // lanes per token row
  constexpr int TPI = 32 / LPT;       // tokens per warp step
  constexpr int STEP = kWarps * TPI;  // tokens per block step
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
  const int n = max(0, min(ctx[b], Smax));

  float qf[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec(q + (static_cast<size_t>(b) * Hq + hk * G + g) * D + sub * V, qf[g]);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qf[g][i] *= scale;
      if (G > 1) qf[g][i] = round_to<T>(qf[g][i]);
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

  const size_t tok_stride = static_cast<size_t>(Hkv) * D;
  const size_t head0 = ((static_cast<size_t>(layer) * B + b) * Smax * Hkv + hk) * D + sub * V;
  const T* kp = kc + head0;
  const T* vp = vc + head0;

  for (int t0 = warp * TPI; t0 < n; t0 += STEP * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * STEP + grp;
      if (t < n) {
        kraw[u] = *reinterpret_cast<const uint4*>(kp + t * tok_stride);
        vraw[u] = *reinterpret_cast<const uint4*>(vp + t * tok_stride);
      } else {
        kraw[u] = make_uint4(0, 0, 0, 0);
        vraw[u] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = t0 + u * STEP + grp < n;
      float kv[V], vv[V];
      unpack_vec<T>(kraw[u], kv);
      unpack_vec<T>(vraw[u], vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) s += qf[g][i] * kv[i];
        // every lane takes part in the shuffles; invalid slots are dropped below
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (valid) {
          const float m_new = fmaxf(m[g], s);
          const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
          const float pv = (G > 1) ? round_to<T>(p) : p;
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

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* ctx, void* out,
                     int B, int Smax, int Hkv, int G, int layer, float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  const dim3 grid(B * Hkv);
  switch (G) {
    case 1: decode_kernel<T, D, 1><<<grid, kThreads, 0, s>>>(qp, kp, vp, ctx, op, B, Smax, Hkv, layer, scale); break;
    case 2: decode_kernel<T, D, 2><<<grid, kThreads, 0, s>>>(qp, kp, vp, ctx, op, B, Smax, Hkv, layer, scale); break;
    case 4: decode_kernel<T, D, 4><<<grid, kThreads, 0, s>>>(qp, kp, vp, ctx, op, B, Smax, Hkv, layer, scale); break;
    case 8: decode_kernel<T, D, 8><<<grid, kThreads, 0, s>>>(qp, kp, vp, ctx, op, B, Smax, Hkv, layer, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* ctx, void* out,
                   int B, int Smax, int Hkv, int G, int D, int layer, float scale,
                   cudaStream_t s) {
  switch (D) {
    case 64: return launch_d<T, 64>(q, k, v, ctx, out, B, Smax, Hkv, G, layer, scale, s);
    case 128: return launch_d<T, 128>(q, k, v, ctx, out, B, Smax, Hkv, G, layer, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, Hkv * G, D] bf16; k_cache, v_cache: [L, B, Smax, Hkv, D] bf16;
// ctx: [B] int32 on the device. G in {1, 2, 4, 8}, D in {64, 128}.
extern "C" int mlio_decode_attn(const void* q, const void* k_cache, const void* v_cache,
                                const int* ctx, void* out, int B, int Smax, int Hkv,
                                int G, int D, int layer, float scale, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  return launch<__nv_bfloat16>(q, k_cache, v_cache, ctx, out, B, Smax, Hkv, G, D, layer, scale,
                               static_cast<cudaStream_t>(stream));
}
