// The decode megakernel's phases, shared by K4 (decode_layer.cu: the
// contiguous [L, B, Smax, Hkv, D] cache, one position for the batch,
// multi-step) and K8 (paged_stack.cu: the [L, NB, bs, Hkv, D] block-table
// pools, a context per sequence, one step). A source includes this header
// once and gives its Cache policy:
//   slot(p, b, s)        the slot sequence b writes at step s, and attends
//                        over up to and including;
//   capacity(p)          slots a sequence can address (a slot at or past it
//                        is neither written nor read);
//   row(p, layer, b, t)  element offset of slot t's [Hkv * D] K/V row;
//   rope_row(b, s)       the row of the [*, rope_dim] cos/sin tables;
//   kPaged               row() reads a table (else it is base + t * row);
//   kLogits              the epilogue may write the logits (p.logits);
//   Elem, kQuant         the cache's element type: bf16, or int8 with fp32
//                        scales (p.k_scale, p.v_scale) at row() / D + head.
// The kernel, its bound and its design are described in decode_layer.cu.
//
// INT8 weights are a runtime branch taken once per GEMV item: a weight whose
// scale pointer is set is int8 [L, in, out], read 8 columns a thread with
// 8-byte loads (the bf16 weight's 16-byte loads cover the same 8 columns,
// so the tiles, items, counters and the fixed-order finisher are the same)
// and widened in registers; the column's fp32 scale multiplies the finished
// sum before the bias or activation, as the JAX kernel's _mm does.
#pragma once

#include "common.cuh"
#include "grid.cuh"

#include <limits.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;          // batch rows in each thread's accumulators
constexpr int kTile = 64;         // GEMV output columns per item
constexpr int kColThreads = kTile / 8;             // threads along a row, 16 bytes each
constexpr int kRowGroups = kThreads / kColThreads;  // rows a block reads at once
constexpr int kMaxChunk = 512;    // GEMV input rows per item
constexpr int kUnroll = 4;        // loads in flight: GEMV rows, attention token steps

}  // namespace

// Mirror of mlio_tpu_torch/ops/decode_layer.py::_Params. K4 leaves the
// paged fields (tables, ctx, bs, max_blocks, num_blocks) unset; K8 leaves
// pos, Smax and pos_embed unset and runs one step.
struct StackParams {
  const bf16* x;
  bf16* x_out;
  void* k_cache;  // Cache::Elem; K8: the k pool
  void* v_cache;  // Cache::Elem; K8: the v pool
  // weights: bf16, or int8 where the scale (sq .. s_down below) is set
  const bf16* ln1_scale;
  const bf16* ln1_bias;
  const void* wq;
  const bf16* bq;
  const void* wk;
  const bf16* bk;
  const void* wv;
  const bf16* bv;
  const void* wo;
  const bf16* bo;
  const bf16* ln2_scale;
  const bf16* ln2_bias;
  const void* w_up;
  const bf16* b_up;
  const void* w_gate;
  const bf16* b_gate;
  const void* w_down;
  const bf16* b_down;
  const float *cos, *sin;
  const bf16 *pos_embed, *final_scale, *final_bias, *lm_head, *lm_bias;
  int* tokens;   // optional with the epilogue: the greedy tokens
  float* work;
  unsigned* sync;
  unsigned long long* stamps;  // optional: block 0's %globaltimer after each barrier
  const int* tables;  // K8: [B, max_blocks] block tables
  const int* ctx;     // K8: [B] past tokens of each sequence
  float* logits;      // optional with the epilogue: the fp32 [B, V] logits
  // int8 weights' per-output-channel scales [L, out] (null: a bf16 weight)
  const float *sq, *sk, *sv, *so, *s_up, *s_gate, *s_down;
  float *k_scale, *v_scale;  // INT8 cache: [L, B, Smax, Hkv] scales
  int B, H, Hq, Hkv, D, I, L, Smax, pos, steps, rope_dim, rmsnorm, activation, epilogue,
      lm_vmajor, V, nblocks, smem, bs, max_blocks, num_blocks;
  float eps, scale, embed_scale;
};

namespace {

// One projection phase: up to three weights [K, n[m]] sharing the input.
// Items are (tile, K-chunk); ``paired`` (up and gate) finishes a column tile
// of both weights together.
struct Gemv {
  const void* w[3];      // bf16, or int8 where wscale is set
  const float* wscale[3];
  const bf16* bias[3];
  int n[3], tiles[3];
  int nm, K, T, KS, KC;
  bool paired;
};

__host__ __device__ inline Gemv plan_gemv(int K, int n0, int n1, int n2, bool paired,
                                          int nblocks) {
  Gemv g{};
  g.K = K;
  g.n[0] = n0;
  g.n[1] = n1;
  g.n[2] = n2;
  g.nm = n2 ? 3 : (n1 ? 2 : 1);
  g.paired = paired;
  for (int m = 0; m < g.nm; ++m) {
    g.tiles[m] = (g.n[m] + kTile - 1) / kTile;
    g.T += g.tiles[m];
  }
  // as many K-chunks as keep the items within one wave of blocks
  int ks = nblocks / g.T;
  if (ks < 1) ks = 1;
  int kc = (K + ks - 1) / ks;
  if (kc > kMaxChunk) kc = kMaxChunk;
  g.KC = kc;
  g.KS = (K + kc - 1) / kc;
  return g;
}

struct Phases {
  Gemv qkv, o, up, down;
};

__host__ __device__ inline Phases plan_phases(const StackParams& p, int nblocks) {
  const int Qd = p.Hq * p.D, KVd = p.Hkv * p.D;
  const bool gated = p.activation >= 4;
  return {plan_gemv(p.H, Qd, KVd, KVd, false, nblocks), plan_gemv(Qd, p.H, 0, 0, false, nblocks),
          plan_gemv(p.H, p.I, gated ? p.I : 0, 0, gated, nblocks),
          plan_gemv(p.I, p.H, 0, 0, false, nblocks)};
}

// Offsets, in floats, of the global workspace.
struct Layout {
  size_t xres, qkv, attn, act, part, emax, eidx, total;
  int counters;
};

__host__ __device__ inline size_t up64(size_t x) { return (x + 63) / 64 * 64; }

__host__ __device__ inline Layout plan_layout(const StackParams& p, int nblocks) {
  const Phases ph = plan_phases(p, nblocks);
  const Gemv* gs[4] = {&ph.qkv, &ph.o, &ph.up, &ph.down};
  size_t part = 0;
  int counters = 0;
  for (int i = 0; i < 4; ++i) {
    const size_t n = static_cast<size_t>(gs[i]->T) * gs[i]->KS * kMaxB * kTile;
    part = n > part ? n : part;
    counters = gs[i]->T > counters ? gs[i]->T : counters;
  }
  const size_t Qd = static_cast<size_t>(p.Hq) * p.D, KVd = static_cast<size_t>(p.Hkv) * p.D;
  Layout lo;
  size_t off = 0;
  lo.xres = off; off += up64(kMaxB * static_cast<size_t>(p.H));
  lo.qkv = off; off += up64(kMaxB * (Qd + 2 * KVd));
  lo.attn = off; off += up64(kMaxB * Qd);
  lo.act = off; off += up64(kMaxB * static_cast<size_t>(p.I));
  lo.part = off; off += up64(part);
  lo.emax = off; off += up64(static_cast<size_t>(nblocks) * kMaxB);
  lo.eidx = off; off += up64(static_cast<size_t>(nblocks) * kMaxB);
  lo.total = off;
  lo.counters = counters;
  return lo;
}

// (m2, i2) beats (m1, i1): a larger logit, or the same logit at a smaller
// index, so any merge order yields the first index of the maximum.
__device__ __forceinline__ bool better(float m2, int i2, float m1, int i1) {
  return m2 > m1 || (m2 == m1 && i2 < i1);
}

// Phase timing (optional): block 0 stamps the global timer (ns) at the
// start and after every barrier, so stamp differences are phase durations.
__device__ __forceinline__ void stamp(const StackParams& p, int& n) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[n] = t;
  }
  ++n;
}

// Mean and reciprocal deviation of each residual row (RMSNorm: mean 0), one
// warp a row, the fp32 statistics of the JAX kernel's _norm.
__device__ void row_stats(const StackParams& p, const float* xres, float* s_mu, float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < p.B) {
    const float* row = xres + static_cast<size_t>(warp) * p.H;
    float mu = 0.f;
    if (!p.rmsnorm) {
      float sum = 0.f;
      for (int i = lane * 4; i < p.H; i += 128) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(row + i));
        sum += (v.x + v.y) + (v.z + v.w);
      }
      mu = warp_sum(sum) / p.H;
    }
    float sq = 0.f;
    for (int i = lane * 4; i < p.H; i += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(row + i));
      const float a = v.x - mu, b = v.y - mu, c = v.z - mu, d = v.w - mu;
      sq += (a * a + b * b) + (c * c + d * d);
    }
    sq = warp_sum(sq);
    if (lane == 0) {
      s_mu[warp] = mu;
      s_rstd[warp] = rsqrtf(sq / p.H + p.eps);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float normed(const StackParams& p, float x, float mu, float rstd,
                                        const bf16* scale, const bf16* bias, int k) {
  float y = (x - mu) * rstd * to_f32(scale[k]);
  if (!p.rmsnorm && bias != nullptr) y += to_f32(bias[k]);
  return y;
}

__device__ __forceinline__ void fma_row(float (&acc)[kMaxB][8], const uint4& raw,
                                        const float* s_act, int r) {
  float w[8];
  unpack_vec<bf16>(raw, w);
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    const float a = s_act[b * kMaxChunk + r];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[b][i] = fmaf(a, w[i], acc[b][i]);
  }
}

__device__ __forceinline__ void fma_row_i8(float (&acc)[kMaxB][8], const uint2& raw,
                                           const float* s_act, int r) {
  float w[8];
  unpack_i8x8(raw, w);
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    const float a = s_act[b * kMaxChunk + r];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[b][i] = fmaf(a, w[i], acc[b][i]);
  }
}

// One projection phase. stage(b, k) gives input element [b, k] (already
// rounded to bf16); fin(m, b, col, sum, sum_gate) consumes the finished
// fp32 sum of column col of weight m (paired: of both weights), an int8
// weight's scale already applied.
template <class Stage, class Fin>
__device__ void gemv_phase(const Gemv& g, int B, float* part, unsigned* counters,
                           unsigned char* smem, Stage stage, Fin fin) {
  float* s_act = reinterpret_cast<float*>(smem);  // [kMaxB][kMaxChunk]
  float* s_red = s_act + kMaxB * kMaxChunk;       // [kRowGroups][kMaxB][kTile]
  __shared__ int s_last;
  // Thread layout of an item: kColThreads threads cover a 64-column row
  // segment (128 bytes, whole cache lines), kRowGroups rows at once.
  const int cg = threadIdx.x % kColThreads, rg = threadIdx.x / kColThreads;
  constexpr int kOut = kMaxB * kTile / kThreads;  // outputs a thread reduces
  const size_t item_floats = kMaxB * kTile;
  const int items = g.T * g.KS;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int t = it / g.KS, j = it % g.KS;
    int m = 0, tt = t;
    while (tt >= g.tiles[m]) tt -= g.tiles[m++];
    const int N = g.n[m];
    const int k0 = j * g.KC, kn = min(g.KC, g.K - k0);
    __syncthreads();  // the previous item is done with s_act and s_red
    for (int e = threadIdx.x; e < kMaxB * kn; e += kThreads) {
      const int b = e / kn, k = e - b * kn;
      s_act[b * kMaxChunk + k] = b < B ? stage(b, k0 + k) : 0.f;
    }
    __syncthreads();

    float acc[kMaxB][8];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[b][i] = 0.f;
    const int col = tt * kTile + cg * 8;
    if (col < N && g.wscale[m] != nullptr) {  // int8 rows, 8 bytes a thread
      const int8_t* wp = static_cast<const int8_t*>(g.w[m]) + static_cast<size_t>(k0) * N + col;
      int r = rg;
      for (; r + (kUnroll - 1) * kRowGroups < kn; r += kUnroll * kRowGroups) {
        uint2 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          raw[u] = __ldg(reinterpret_cast<const uint2*>(
              wp + static_cast<size_t>(r + u * kRowGroups) * N));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fma_row_i8(acc, raw[u], s_act, r + u * kRowGroups);
      }
      for (; r < kn; r += kRowGroups)
        fma_row_i8(acc, __ldg(reinterpret_cast<const uint2*>(wp + static_cast<size_t>(r) * N)),
                   s_act, r);
    } else if (col < N) {
      const bf16* wp = static_cast<const bf16*>(g.w[m]) + static_cast<size_t>(k0) * N + col;
      int r = rg;
      for (; r + (kUnroll - 1) * kRowGroups < kn; r += kUnroll * kRowGroups) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              wp + static_cast<size_t>(r + u * kRowGroups) * N));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fma_row(acc, raw[u], s_act, r + u * kRowGroups);
      }
      for (; r < kn; r += kRowGroups)
        fma_row(acc, __ldg(reinterpret_cast<const uint4*>(wp + static_cast<size_t>(r) * N)),
                s_act, r);
    }
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      float4* dst = reinterpret_cast<float4*>(s_red + (rg * kMaxB + b) * kTile + cg * 8);
      dst[0] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
      dst[1] = make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
    }
    __syncthreads();
    // Sum the row groups in order: output o = (b, c) is b * kTile + c.
    float* P = part + (static_cast<size_t>(t) * g.KS + j) * item_floats;
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int o = threadIdx.x + q * kThreads;
      float s = 0.f;
      for (int w = 0; w < kRowGroups; ++w) s += s_red[w * kMaxB * kTile + o];
      __stcg(P + o, s);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int c = g.paired ? tt : t;
      const unsigned need = g.paired ? 2u * g.KS : static_cast<unsigned>(g.KS);
      const bool last = atomicAdd(counters + c, 1u) == need - 1;
      if (last) atomicExch(counters + c, 0u);
      s_last = last;
    }
    __syncthreads();
    if (!s_last) continue;
    // The last item of this column tile: sum every K-chunk in order, with
    // the loads of four chunks in flight.
    __threadfence();
    const int tu = g.paired ? tt : t, tg = tt + g.tiles[0];
    const float* pu = part + static_cast<size_t>(tu) * g.KS * item_floats;
    const float* pg = part + static_cast<size_t>(tg) * g.KS * item_floats;
    const float* su_scale = g.wscale[g.paired ? 0 : m];
    const float* sg_scale = g.paired ? g.wscale[1] : nullptr;
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int o = threadIdx.x + q * kThreads, b = o / kTile, c = tt * kTile + o % kTile;
      if (b >= B || c >= N) continue;
      float su = 0.f, sg = 0.f;
      int jj = 0;
      for (; jj + 3 < g.KS; jj += 4) {
        float vu[4], vg[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          vu[u] = __ldcg(pu + (jj + u) * item_floats + o);
          vg[u] = g.paired ? __ldcg(pg + (jj + u) * item_floats + o) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          su += vu[u];
          sg += vg[u];
        }
      }
      for (; jj < g.KS; ++jj) {
        su += __ldcg(pu + jj * item_floats + o);
        if (g.paired) sg += __ldcg(pg + jj * item_floats + o);
      }
      if (su_scale != nullptr) su *= su_scale[c];
      if (sg_scale != nullptr) sg *= sg_scale[c];
      fin(g.paired ? 0 : m, b, c, su, sg);
    }
  }
}

// Layer l's [in, out] weight (bf16, or int8 with its [out] scales) in slot m
// of a phase's descriptor.
__device__ __forceinline__ void set_weight(Gemv& g, int m, const void* w, const float* s,
                                           int l, size_t in, size_t out) {
  const size_t bytes = s != nullptr ? 1 : sizeof(bf16);
  g.w[m] = static_cast<const char*>(w) + l * in * out * bytes;
  g.wscale[m] = s != nullptr ? s + l * out : nullptr;
}

// Layer l's weights in the phases' descriptors (and the QKV biases).
__device__ void set_layer(Phases& ph, const StackParams& p, int l) {
  const size_t H = p.H, I = p.I, Qd = static_cast<size_t>(p.Hq) * p.D,
               KVd = static_cast<size_t>(p.Hkv) * p.D;
  set_weight(ph.qkv, 0, p.wq, p.sq, l, H, Qd);
  set_weight(ph.qkv, 1, p.wk, p.sk, l, H, KVd);
  set_weight(ph.qkv, 2, p.wv, p.sv, l, H, KVd);
  ph.qkv.bias[0] = p.bq != nullptr ? p.bq + l * Qd : nullptr;
  ph.qkv.bias[1] = p.bk != nullptr ? p.bk + l * KVd : nullptr;
  ph.qkv.bias[2] = p.bv != nullptr ? p.bv + l * KVd : nullptr;
  set_weight(ph.o, 0, p.wo, p.so, l, Qd, H);
  set_weight(ph.up, 0, p.w_up, p.s_up, l, H, I);
  if (ph.up.paired) set_weight(ph.up, 1, p.w_gate, p.s_gate, l, H, I);
  set_weight(ph.down, 0, p.w_down, p.s_down, l, I, H);
}

// The INT8 cache's write of the current token: warp 0 quantizes the K row of
// D fp32 values in s_kv, warp 1 the V row, as quantize_kv does (scale =
// amax / 127, or 1 where amax is 0; round half to even of a true division;
// clip to +-127), and stores the int8 row at element offset `cur` and its
// scale at cur / D.
template <int D>
__device__ void quantize_current(const StackParams& p, const float* s_kv, size_t cur) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 2) return;
  const float* x = s_kv + warp * D;
  float amax = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(x[d]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = amax == 0.f ? 1.f : amax / 127.f;
  int8_t* row = static_cast<int8_t*>(warp == 0 ? p.k_cache : p.v_cache) + cur;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    row[d] = static_cast<int8_t>(fminf(fmaxf(rintf(x[d] / sc), -127.f), 127.f));
  if (lane == 0) (warp == 0 ? p.k_scale : p.v_scale)[cur / D] = sc;
}

// Phase 2 of a layer: RoPE, the cache write of each sequence's slot and
// attention over slots [0, slot], one item per (sequence, KV head) as K3,
// with K4's rounding. An INT8 cache (Cache::kQuant) gets the current token
// quantized in the kernel and is read with its scales fused into the score
// (K scale) and the probability (V scale; l sums the unscaled ones), the
// probabilities fp32 throughout.
template <int D, int G, class Cache>
__device__ void attention_phase(const StackParams& p, const Layout& lo, int layer, int s,
                                unsigned char* smem) {
  using E = typename Cache::Elem;
  constexpr bool kQuant = Cache::kQuant;
  constexpr int V = 8;                // elements a lane holds of a row
  constexpr int LPT = D / V;          // lanes per token row
  constexpr int TPI = 32 / LPT;       // tokens per warp step
  constexpr int STEP = kWarps * TPI;  // tokens per block step
  float* s_raw = reinterpret_cast<float*>(smem);  // [G + 2][D]: q heads, k, v
  float* s_q = s_raw + (G + 2) * D;               // [G][D]
  float* sm_m = s_q + G * D;                      // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;                // [kWarps][G]
  float* sm_acc = sm_l + kWarps * G;              // [kWarps][G][D]
  float* s_kv = sm_acc + kWarps * G * D;          // [2][D]: the INT8 cache's k, v
  E* const k_cache = static_cast<E*>(p.k_cache);
  E* const v_cache = static_cast<E*>(p.v_cache);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPT, sub = lane % LPT;
  const int Qd = p.Hq * D, KVd = p.Hkv * D, W = Qd + 2 * KVd;
  const int R = p.rope_dim, half = R / 2, cap = Cache::capacity(p);
  const float* qkv = p.work + lo.qkv;
  float* attn = p.work + lo.attn;

  for (int it = blockIdx.x; it < p.B * p.Hkv; it += gridDim.x) {
    const int b = it / p.Hkv, hk = it % p.Hkv;
    const int slot = Cache::slot(p, b, s), n = min(slot + 1, cap);
    const float* cs = p.cos + Cache::rope_row(b, s) * R;
    const float* sn = p.sin + Cache::rope_row(b, s) * R;
    __syncthreads();
    for (int e = threadIdx.x; e < (G + 2) * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int col = r < G ? (hk * G + r) * D + d : (r == G ? Qd : Qd + KVd) + hk * D + d;
      s_raw[e] = __ldcg(qkv + static_cast<size_t>(b) * W + col);
    }
    __syncthreads();
    const size_t cur = slot < cap ? Cache::row(p, layer, b, slot) + hk * D : 0;
    for (int e = threadIdx.x; e < (G + 2) * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float val = s_raw[e];
      if (r <= G && d < R) {
        const float other = d < half ? -s_raw[r * D + d + half] : s_raw[r * D + d - half];
        val = val * cs[d] + other * sn[d];
      }
      if (r < G) s_q[e] = round_to<bf16>(val * p.scale);
      else if (slot >= cap) continue;  // a slot past the table is never written
      else if constexpr (kQuant) s_kv[(r - G) * D + d] = val;
      else (r == G ? k_cache : v_cache)[cur + d] = from_f32<E>(val);
    }
    if (kQuant && slot < cap) {
      __syncthreads();
      quantize_current<D>(p, s_kv, cur);
    }
    __syncthreads();  // the slot just written is visible to the whole block

    float qf[G][V], m[G], l[G], acc[G][V];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        qf[g][i] = s_q[g * D + sub * V + i];
        acc[g][i] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }
    const E* kp = k_cache + hk * D + sub * V;
    const E* vp = v_cache + hk * D + sub * V;
    // contiguous slots: one base and a stride; paged: the table per slot
    const size_t base = Cache::kPaged ? 0 : Cache::row(p, layer, b, 0);
    for (int t0 = warp * TPI; t0 < n; t0 += STEP * kUnroll) {
      Raw8<E> kraw[kUnroll], vraw[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * STEP + grp;
        ksc[u] = vsc[u] = 1.f;
        if (t < n) {
          const size_t off = Cache::kPaged ? Cache::row(p, layer, b, t)
                                           : base + static_cast<size_t>(t) * KVd;
          kraw[u] = __ldcg(reinterpret_cast<const Raw8<E>*>(kp + off));
          vraw[u] = __ldcg(reinterpret_cast<const Raw8<E>*>(vp + off));
          if (kQuant) {
            ksc[u] = __ldcg(p.k_scale + off / D + hk);
            vsc[u] = __ldcg(p.v_scale + off / D + hk);
          }
        } else {
          kraw[u] = zero8<E>();
          vraw[u] = zero8<E>();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool valid = t0 + u * STEP + grp < n;
        float kv[V], vv[V];
        unpack8<E>(kraw[u], kv);
        unpack8<E>(vraw[u], vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float sc = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) sc += qf[g][i] * kv[i];
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
          if (kQuant) sc *= ksc[u];
          if (valid) {
            const float m_new = fmaxf(m[g], sc);
            const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
            const float pr = expf(sc - m_new);
            l[g] = l[g] * alpha + pr;
            // p stays fp32 for PV (the TPU kernel rounds it to bf16 for its
            // MXU; against a running max that rounding is noise of the
            // order of the check's limit, see decode_layer.py)
            const float pv = kQuant ? pr * vsc[u] : pr;
#pragma unroll
            for (int i = 0; i < V; ++i) acc[g][i] = acc[g][i] * alpha + pv * vv[i];
            m[g] = m_new;
          }
        }
      }
    }
    // Merge the lane groups of each warp by shuffles, then the warps.
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
        for (int i = 0; i < V; ++i) sm_acc[(warp * G + g) * D + sub * V + i] = acc[g][i];
        if (sub == 0) {
          sm_m[warp * G + g] = mw;
          sm_l[warp * G + g] = lw;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
      float lt = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = (sm_m[w * G + g] == -INFINITY) ? 0.f : expf(sm_m[w * G + g] - mx);
        lt += sm_l[w * G + g] * f;
        o += sm_acc[(w * G + g) * D + d] * f;
      }
      __stcg(attn + static_cast<size_t>(b) * Qd + (hk * G + g) * D + d,
             round_to<bf16>(o / (lt == 0.f ? 1.f : lt)));
    }
  }
}

// Epilogue, first half: the logits of every vocabulary row spread over all
// warps, each block leaving its (max, first index) per batch row (and, where
// the policy emits them, writing the logits).
template <class Cache>
__device__ void logits_phase(const StackParams& p, const Layout& lo, unsigned char* smem,
                             float* s_mu, float* s_rstd) {
  const int H = p.H;
  bf16* s_hf = reinterpret_cast<bf16*>(smem);  // [kMaxB][H]
  float* s_bm = reinterpret_cast<float*>(smem + up64(kMaxB * static_cast<size_t>(H) * 2));
  int* s_bi = reinterpret_cast<int*>(s_bm + kWarps * kMaxB);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xres = p.work + lo.xres;
  row_stats(p, xres, s_mu, s_rstd);
  for (int e = threadIdx.x; e < kMaxB * H; e += kThreads) {
    const int b = e / H, h = e - b * H;
    s_hf[e] = from_f32<bf16>(b < p.B ? normed(p, __ldcg(xres + e), s_mu[b], s_rstd[b],
                                              p.final_scale, p.final_bias, h) : 0.f);
  }
  __syncthreads();

  float bm[kMaxB];
  int bi[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    bm[b] = -INFINITY;
    bi[b] = INT_MAX;
  }
  if (p.lm_vmajor) {  // tied [V, H]: a warp per row, 16-byte loads along H,
                      // kRows rows' loads in flight
    constexpr int kRows = 4;
    const int nw = gridDim.x * kWarps;
    for (int v0 = blockIdx.x * kWarps + warp; v0 < p.V; v0 += kRows * nw) {
      float acc[kRows][kMaxB];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) acc[u][b] = 0.f;
      for (int c = lane * 8; c < H; c += 256) {
        uint4 raw[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int v = v0 + u * nw;
          raw[u] = v < p.V ? __ldg(reinterpret_cast<const uint4*>(
                                 p.lm_head + static_cast<size_t>(v) * H + c))
                           : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          float h[8];
          unpack_vec<bf16>(*reinterpret_cast<const uint4*>(s_hf + b * H + c), h);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            float w[8];
            unpack_vec<bf16>(raw[u], w);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[u][b] = fmaf(h[i], w[i], acc[u][b]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int v = v0 + u * nw;
        if (v >= p.V) break;
        const float bias = p.lm_bias != nullptr ? to_f32(p.lm_bias[v]) : 0.f;
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          const float sc = warp_sum(acc[u][b]) + bias;
          if (Cache::kLogits && p.logits != nullptr && lane == 0 && b < p.B)
            p.logits[static_cast<size_t>(b) * p.V + v] = sc;
          if (sc > bm[b]) {  // rows come in increasing order: the first index wins ties
            bm[b] = sc;
            bi[b] = v;
          }
        }
      }
    }
  } else {  // untied [H, V]: a thread per column
    for (int v = blockIdx.x * kThreads + threadIdx.x; v < p.V; v += gridDim.x * kThreads) {
      float acc[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
      for (int k = 0; k < H; ++k) {
        const float w = to_f32(p.lm_head[static_cast<size_t>(k) * p.V + v]);
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) acc[b] = fmaf(to_f32(s_hf[b * H + k]), w, acc[b]);
      }
      const float bias = p.lm_bias != nullptr ? to_f32(p.lm_bias[v]) : 0.f;
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        const float sc = acc[b] + bias;
        if (Cache::kLogits && p.logits != nullptr && b < p.B)
          p.logits[static_cast<size_t>(b) * p.V + v] = sc;
        if (sc > bm[b]) {
          bm[b] = sc;
          bi[b] = v;
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, bm[b], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi[b], o);
      if (better(m2, i2, bm[b], bi[b])) {
        bm[b] = m2;
        bi[b] = i2;
      }
    }
    if (lane == 0) {
      s_bm[warp * kMaxB + b] = bm[b];
      s_bi[warp * kMaxB + b] = bi[b];
    }
  }
  __syncthreads();
  if (threadIdx.x < kMaxB) {
    float m = -INFINITY;
    int idx = INT_MAX;
    for (int w = 0; w < kWarps; ++w) {
      if (better(s_bm[w * kMaxB + threadIdx.x], s_bi[w * kMaxB + threadIdx.x], m, idx)) {
        m = s_bm[w * kMaxB + threadIdx.x];
        idx = s_bi[w * kMaxB + threadIdx.x];
      }
    }
    __stcg(p.work + lo.emax + blockIdx.x * kMaxB + threadIdx.x, m);
    __stcg(reinterpret_cast<int*>(p.work + lo.eidx) + blockIdx.x * kMaxB + threadIdx.x, idx);
  }
}

// Epilogue, second half: every block merges the blocks' partials in the same
// order, so all agree on the token; then, for a next step, the residual is
// the token's embedding row * embed_scale + its position, in fp32.
__device__ void token_phase(const StackParams& p, const Layout& lo, int s) {
  __shared__ int s_tok[kMaxB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < p.B) {  // a warp per batch row; the merge is order-independent
    const float* emax = p.work + lo.emax;
    const int* eidx = reinterpret_cast<const int*>(p.work + lo.eidx);
    float m = -INFINITY;
    int idx = INT_MAX;
    for (int k = lane; k < static_cast<int>(gridDim.x); k += 32) {
      const float m2 = __ldcg(emax + k * kMaxB + warp);
      const int i2 = __ldcg(eidx + k * kMaxB + warp);
      if (better(m2, i2, m, idx)) {
        m = m2;
        idx = i2;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
      if (better(m2, i2, m, idx)) {
        m = m2;
        idx = i2;
      }
    }
    if (lane == 0) s_tok[warp] = idx == INT_MAX ? 0 : idx;  // no finite logit: token 0, as the TPU kernel
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < p.B) p.tokens[s * p.B + threadIdx.x] = s_tok[threadIdx.x];
  if (s + 1 == p.steps) return;
  float* xres = p.work + lo.xres;
  const size_t next = static_cast<size_t>(p.pos + s + 1) * p.H;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.B * p.H; e += gridDim.x * kThreads) {
    const int b = e / p.H, h = e - b * p.H;
    float x = to_f32(p.lm_head[static_cast<size_t>(s_tok[b]) * p.H + h]) * p.embed_scale;
    if (p.pos_embed != nullptr) x += to_f32(p.pos_embed[next + h]);
    __stcg(xres + e, x);
  }
}

template <int D, int G, class Cache>
__global__ void __launch_bounds__(kThreads, 1) stack_kernel(const __grid_constant__ StackParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_mu[kMaxB], s_rstd[kMaxB];
  const Layout lo = plan_layout(p, gridDim.x);
  Phases ph = plan_phases(p, gridDim.x);
  float* xres = p.work + lo.xres;
  float* qkv = p.work + lo.qkv;
  float* attn = p.work + lo.attn;
  float* act = p.work + lo.act;
  float* part = p.work + lo.part;
  unsigned* bar = p.sync;
  unsigned* counters = p.sync + 2;
  const int H = p.H, I = p.I, Qd = p.Hq * D, KVd = p.Hkv * D, W = Qd + 2 * KVd;
  const int qkv_off[3] = {0, Qd, Qd + KVd};
  int ns = 0;
  stamp(p, ns);

  // Step 0's residual: x (+ its position), in fp32.
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.B * H; e += gridDim.x * kThreads) {
    float x = to_f32(p.x[e]);
    if (p.pos_embed != nullptr) x += to_f32(p.pos_embed[static_cast<size_t>(p.pos) * H + e % H]);
    __stcg(xres + e, x);
  }
  grid_sync(bar);
  stamp(p, ns);

  for (int s = 0; s < p.steps; ++s) {
    for (int l = 0; l < p.L; ++l) {
      set_layer(ph, p, l);
      // 1. norm1 and the QKV projections
      {
        Gemv& g = ph.qkv;
        const bf16* sc = p.ln1_scale + static_cast<size_t>(l) * H;
        const bf16* bi = p.ln1_bias != nullptr ? p.ln1_bias + static_cast<size_t>(l) * H : nullptr;
        if (blockIdx.x < g.T * g.KS) row_stats(p, xres, s_mu, s_rstd);
        gemv_phase(g, p.B, part, counters, smem,
            [&](int b, int k) {
              return round_to<bf16>(normed(p, __ldcg(xres + b * H + k), s_mu[b], s_rstd[b], sc, bi, k));
            },
            [&](int m, int b, int c, float su, float) {
              const bf16* bias = g.bias[m];
              __stcg(qkv + static_cast<size_t>(b) * W + qkv_off[m] + c,
                     su + (bias != nullptr ? to_f32(bias[c]) : 0.f));
            });
      }
      grid_sync(bar);
      stamp(p, ns);
      // 2. RoPE, cache write, attention
      attention_phase<D, G, Cache>(p, lo, l, s, smem);
      grid_sync(bar);
      stamp(p, ns);
      // 3. out-projection and residual
      {
        Gemv& g = ph.o;
        const bf16* bo = p.bo != nullptr ? p.bo + static_cast<size_t>(l) * H : nullptr;
        gemv_phase(g, p.B, part, counters, smem,
            [&](int b, int k) { return __ldcg(attn + static_cast<size_t>(b) * Qd + k); },
            [&](int, int b, int c, float su, float) {
              float* xp = xres + static_cast<size_t>(b) * H + c;
              __stcg(xp, __ldcg(xp) + (su + (bo != nullptr ? to_f32(bo[c]) : 0.f)));
            });
      }
      grid_sync(bar);
      stamp(p, ns);
      // 4. norm2, up (and gate) projections, activation
      {
        Gemv& g = ph.up;
        const bf16* bu = p.b_up != nullptr ? p.b_up + static_cast<size_t>(l) * I : nullptr;
        const bf16* bg = (g.paired && p.b_gate != nullptr) ? p.b_gate + static_cast<size_t>(l) * I : nullptr;
        const bf16* sc = p.ln2_scale + static_cast<size_t>(l) * H;
        const bf16* bi = p.ln2_bias != nullptr ? p.ln2_bias + static_cast<size_t>(l) * H : nullptr;
        if (blockIdx.x < g.T * g.KS) row_stats(p, xres, s_mu, s_rstd);
        gemv_phase(g, p.B, part, counters, smem,
            [&](int b, int k) {
              return round_to<bf16>(normed(p, __ldcg(xres + b * H + k), s_mu[b], s_rstd[b], sc, bi, k));
            },
            [&](int, int b, int c, float su, float sg) {
              const float u = su + (bu != nullptr ? to_f32(bu[c]) : 0.f);
              const float gv = sg + (bg != nullptr ? to_f32(bg[c]) : 0.f);
              __stcg(act + static_cast<size_t>(b) * I + c, round_to<bf16>(activate(p.activation, u, gv)));
            });
      }
      grid_sync(bar);
      stamp(p, ns);
      // 5. down-projection and residual; the last layer also writes x_out
      {
        Gemv& g = ph.down;
        const bf16* bd = p.b_down != nullptr ? p.b_down + static_cast<size_t>(l) * H : nullptr;
        const bool last = l == p.L - 1;
        gemv_phase(g, p.B, part, counters, smem,
            [&](int b, int k) { return __ldcg(act + static_cast<size_t>(b) * I + k); },
            [&](int, int b, int c, float su, float) {
              float* xp = xres + static_cast<size_t>(b) * H + c;
              const float x = __ldcg(xp) + (su + (bd != nullptr ? to_f32(bd[c]) : 0.f));
              __stcg(xp, x);
              if (last) p.x_out[static_cast<size_t>(b) * H + c] = from_f32<bf16>(x);
            });
      }
      grid_sync(bar);
      stamp(p, ns);
    }
    if (p.epilogue) {
      logits_phase<Cache>(p, lo, smem, s_mu, s_rstd);
      grid_sync(bar);
      stamp(p, ns);
      if (p.tokens != nullptr) token_phase(p, lo, s);
      if (s + 1 < p.steps) {
        grid_sync(bar);
        stamp(p, ns);
      }
    }
  }
}

template <class Cache, int D>
const void* pick_g(int G) {
  switch (G) {
    case 1: return reinterpret_cast<const void*>(stack_kernel<D, 1, Cache>);
    case 2: return reinterpret_cast<const void*>(stack_kernel<D, 2, Cache>);
    case 4: return reinterpret_cast<const void*>(stack_kernel<D, 4, Cache>);
    case 8: return reinterpret_cast<const void*>(stack_kernel<D, 8, Cache>);
    default: return nullptr;
  }
}

template <class Cache>
const void* pick(int D, int G) {
  switch (D) {
    case 64: return pick_g<Cache, 64>(G);
    case 128: return pick_g<Cache, 128>(G);
    default: return nullptr;
  }
}

int smem_bytes(const StackParams& p, int G) {
  const size_t gemv = (kMaxB * kMaxChunk + kRowGroups * kMaxB * kTile) * sizeof(float);
  const size_t att =
      ((G + 2) * p.D + G * p.D + 2 * kWarps * G + kWarps * G * p.D + 2 * p.D) * sizeof(float);
  const size_t epi = p.epilogue ? up64(kMaxB * static_cast<size_t>(p.H) * 2) + kWarps * kMaxB * 8 : 0;
  size_t m = gemv > att ? gemv : att;
  m = m > epi ? m : epi;
  return static_cast<int>(m);
}

// Fills p->nblocks (the blocks that can be resident at once) and p->smem, and
// returns the workspace sizes the wrapper allocates: work (fp32 elements) and
// sync (int32 elements, zeroed: the barrier and the tile counters).
template <class Cache>
int stack_plan(StackParams* p, long long* work_floats, int* sync_ints) {
  const void* k = pick<Cache>(p->D, p->Hq / p->Hkv);
  if (k == nullptr || p->B < 1 || p->B > kMaxB) return cudaErrorInvalidValue;
  const int smem = smem_bytes(*p, p->Hq / p->Hkv);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  p->nblocks = occ * sms;
  p->smem = smem;
  const Layout lo = plan_layout(*p, p->nblocks);
  *work_floats = static_cast<long long>(lo.total);
  *sync_ints = 2 + lo.counters;
  return cudaSuccess;
}

// One cooperative launch on the given stream; a refused launch returns its error.
template <class Cache>
int stack_launch(const StackParams* p, void* stream) {
  const void* k = pick<Cache>(p->D, p->Hq / p->Hkv);
  if (k == nullptr) return cudaErrorInvalidValue;
  void* args[] = {const_cast<StackParams*>(p)};
  const cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(p->nblocks), dim3(kThreads), args,
                                                    p->smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
