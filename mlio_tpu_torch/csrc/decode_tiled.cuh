// K6: the tiled decode megakernel for Hopper. One decode step of every layer
// of a large dense or sparse-MoE model in ONE launch, no head epilogue.
//
// Replaces mlio_tpu/ops/decode_tiled.py::_tiled_kernel (entry
// decode_layer_tiled). For each layer, with the residual x32 kept in fp32
// across all layers (the wrapper's decode_layer_tiled_plain is the function
// in plain PyTorch):
//   h = bf16(norm1(x32)); q, k, v = h @ W (x the int8/fp8 weight's column
//   scale) + b (fp32); RoPE on q, k with bf16-rounded tables; slot pos <- k,
//   v (bf16, or quantized per head as quantize_kv); attention of
//   bf16(q * scale) over slots [0, pos] with the probabilities in fp32;
//   x32 += bf16(attn) @ wo + bo; h2 = bf16(norm2(x32));
//   x32 += bf16(act(h2 @ w_up + b_up [, h2 @ w_gate + b_gate])) @ w_down + b_down.
//   The last layer writes x_out = bf16(x32).
// A sparse-MoE model (E > 0: Mixtral; the JAX kernel's lines 704-795) routes
// at the fold: logits = h2 @ router[l] in fp32, p = exp(logits - max) / sum
// over the E experts, the top_k of p by repeated max (the lowest index on
// ties), comb = p at the picks / their sum (0 elsewhere); then
//   x32 += sum over the experts e some row picks of
//          (bf16(act(h2 @ up_e, h2 @ gate_e)) @ down_e) x s_down_e x comb[:, e]
// with each expert's per-channel scales; expert MLPs have no biases. An
// expert no row picks adds comb 0 x a finite product, so leaving it out is
// exact: it is never read.
//
// Bound: bytes. At llama3-8b's full width and depth, B = 8, context 896 a
// step reads every layer's weights once (14.9 GB of bf16 weights: 4.45 ms at
// the H100's 3.35 TB/s; 7.5 GB of int8 weights and a 0.46 GB INT8 cache:
// about 2.2 ms) for about 2 flops a weight byte at B = 8 (bf16) - far below
// the tensor cores' 295 flops a byte. chip_smoke.py restates the bound with
// the bandwidth its probe (K14, dma_bench.cu) measures.
//
// Design. The TPU kernel walks a sequential grid over layers and, inside a
// layer, loops over head groups and intermediate chunks that share one
// double-buffered VMEM weight pool, carrying the accumulator in VMEM. Hopper
// runs blocks in parallel: the phases run here side by side on all SMs, one
// persistent cooperative launch (one 256-thread block an SM), five grid
// barriers a layer:
//   1. QKV over wq | wk | wv;  2. attention: items of (sequence, head group,
//   context split), the split that holds slot pos applies RoPE and writes
//   (or quantizes) the slot, K/V through an 11-slot cp.async ring, the last
//   split of a (sequence, KV head) to arrive combining the splits in order
//   into bf16(attn);  3. the out-projection into x32;  4. up (and gate) with
//   the activation, into bf16 activations in device memory;  5. down, into
//   x32 (+ b_down).
// The four GEMV phases (1, 3, 4, 5) share one core, each part answering a
// cause of the earlier register-streamed GEMVs' 0.7-1.4 TB/s:
//   - Bytes in flight: a unit is 32 KB of weights, 128 rows of one matrix or
//     64 of up and gate beside each other, each matrix's tile row 256 bytes
//     (two 128-byte TMA boxes, 128-byte swizzled). The units come by TMA
//     (2-D tensor maps over each weight tensor, [L * in, out] or an expert
//     stack's [L * E * in, out], built on the host once per tensor) into a
//     ring of 3-5 slots (by batch tier) over the attention ring's shared
//     memory, each slot also holding the unit's activation rows, copied by
//     cp.async beside the weights. Warps 4-7 issue the boxes, one a warp,
//     so that no thread issues them all; warps 0-3 copy the activations;
//     completion is counted on an mbarrier a slot (a bounded wait: a
//     miscounted copy traps, the card does not hang). On an H100 a 10-slot
//     ring of 16 KB units lost a third of its rate to the ~0.5 us a unit
//     that the barrier and the refill cost; 32 KB units halve that share.
//   - The products: mma.sync m16n8k16 with the weight tile as the 16-row
//     operand (16 output columns x 16 of K) read by ldmatrix.trans from the
//     swizzled tile (bf16 as it is; int8 and e4m3 bytes widened exactly to
//     bf16 in registers, widen.cuh's frag_pair) and the batch rows as n (8
//     a tile: one, two or four n-tiles at B <= 8, 16, 32). Each unit's raw
//     activations go to bf16 (normed where the phase starts from the
//     residual) once, one unit ahead, by every thread; fp32 accumulators;
//     scales, biases, comb and the activation after the sum.
//   - The split: a phase's units, (tile, k rows), in order, are cut into
//     gridDim.x equal runs, one a block (stream-K), so every SM streams the
//     same bytes at every batch and every model. A run's units of one tile
//     form a segment; each segment leaves an fp32 partial [columns][rows] in
//     slot (block + tile), and the segment that brings its tile's (kDown:
//     its column tile's, over the experts) count of arrivals to the total
//     sums the partials in a fixed order (expert, then block, that is k)
//     and applies the epilogue. No float atomics: two runs give the same
//     bits.
//   - MoE: every block routes all B rows itself at the start of phase 4 (a
//     warp a row; one code path and order, so every block holds the same
//     comb and picks, bit for bit) and plans units only for the experts some
//     row picks.
// The kernel keeps nothing across its phases but the layer and the ring's
// unit count (shared memory), and attention's register arrays are sized for
// 4 query heads a KV head where G <= 4: with them sized for 8, or with a
// register-hungry sum in the GEMV phases, ptxas spilled 0.4-1.7 KB in the
// attention phase and it ran 1.5-2.5x slower.
// Attention streams its K/V rows through an 11-slot shared-memory ring of 16
// KB slots filled by cp.async. The INT8 cache's current token is quantized
// as K4 quantizes it (rintf of a true division).
//
// Measured (chip_smoke.py, ab_k6.py; NVIDIA H100 80GB HBM3): PERF.md §5-6.
//
// Limits: bf16 activations; B <= 32; H <= 8192; head dim 64 or 128 and 1-4
// or 5-8 query heads a KV head (template instances), or head dim 256 with 1-4
// query heads a KV head over bf16 weights and a bf16 cache (Gemma); E <= 16
// experts; H and I multiples of 16 (16-byte weight rows for the tensor
// maps). The wrapper raises on anything else. At D 256 a row of K or V is
// 512 bytes: the attention phase's lanes are the whole warp, one slot a warp
// step, and a ring slot holds kTok = 16 slots' K and V rows, exactly its 16
// KB; its buffers are sized for 4 query heads (kAttnBuf).
//
// Sources. This header holds the kernel; decode_tiled_bf16.cu,
// decode_tiled_int8.cu and decode_tiled_fp8.cu each define
// MLIO_TILED_FMT (the weights' format: 0 bf16, 1 int8, 2 fp8 e4m3) and
// include it, so that the three libraries build in parallel, each with its
// format's GEMV instances only; decode_tiled_d256.cu also defines
// MLIO_TILED_D256 and builds the one head-dim-256 instance, so that it
// lengthens no other source's build.
#pragma once

#ifndef MLIO_TILED_FMT
#error "define MLIO_TILED_FMT (0 bf16, 1 int8, 2 fp8) before including decode_tiled.cuh"
#endif

#include <string.h>

#include "common.cuh"
#include "grid.cuh"
#include "tma.cuh"
#include "widen.cuh"

#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 11;            // attention's K/V ring slots: 160 KB in flight a block
constexpr int kStageBytes = 16384;     // one slot
constexpr int kMaxG = 8;               // query heads a KV head
constexpr int kMaxB = 32;
constexpr int kMaxE = 16;              // experts: the router's register array
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kAttnBufBytes = 49152;   // attention's q, k, v and merge buffers after its ring
// Attention's buffers for head dim D and GM query heads a KV head (its
// register arrays' size): q, k, v raw [GM + 2][D], the scaled q [GM][D],
// the warps' (max, sum) [kWarps][GM] and outputs [kWarps][GM][D], an INT8
// cache's k, v [2][D]. 43.5 KB at D 128 with 8 heads; 44.3 KB at D 256 with
// 4, where 8 would take 86.5 KB: D 256 is built for G <= 4 alone.
template <int D, int GM>
constexpr int kAttnBuf = ((2 * GM + 2) * D + 2 * kWarps * GM + kWarps * GM * D + 2 * D) * 4;
static_assert(kAttnBuf<128, kMaxG> <= kAttnBufBytes, "attention's buffers at D 128");
static_assert(kAttnBuf<256, 4> <= kAttnBufBytes, "attention's buffers at D 256");
// The GEMV phases' shared memory, over the attention ring and its buffers:
// ring slots of 32 KB of weights (a unit, by TMA) followed by the unit's
// activations (raw rows by cp.async, their bf16 form, and the norm's scale
// and bias), then, at kGemvBytes, comb, each row's picks and the picked
// experts (these from phase 4 to phase 5 of a layer) and a sum's list of
// partials.
constexpr int kSlotBytes = 32768;                // a unit's weights
constexpr int kBoxBytes = 128;                   // a TMA box row: the 128-byte swizzle's span
constexpr int kTileBytes = 2 * kBoxBytes;        // a matrix's bytes in a tile row
constexpr int kMaxKB = kSlotBytes / kTileBytes;  // rows a unit of one matrix (128)
constexpr int kActRow = kMaxKB + 8;  // a bf16 activation row: B fragments free of bank conflicts
constexpr int kMaxSlots = 8;
constexpr int kGemvBytes = 221184;               // the slots' bytes (216 KB)
constexpr int kComb = kGemvBytes;                // [kMaxB][kMaxE] fp32
constexpr int kRowPick = kComb + kMaxB * kMaxE * 4;  // [kMaxB] bit masks
constexpr int kPicked = kRowPick + kMaxB * 4;        // the count, then the experts in order
constexpr int kSegs = kPicked + (1 + kMaxE) * 4;     // the count, then (slot << 4 | expert rank)
constexpr int kMaxSegs = 1023;
constexpr int kSumOuts = 4;  // outputs a thread of a sum takes at once
static_assert(kSegs + (1 + kMaxSegs) * 4 <= kRingBytes + kAttnBufBytes, "GEMV buffers fit");
constexpr int kAlign = 1024;  // the 128-byte swizzle's period: the ring's alignment
constexpr int kSmemBytes = kRingBytes + kAttnBufBytes + kAlign;

// A ring slot of the tier with MB batch rows: weights; raw fp32 activation
// rows [MB][kMaxKB] (cp.async); their bf16 form [MB][kActRow] (kDown's bf16
// rows land there directly); the norm's scale and bias [kMaxKB] bf16. As
// many slots as kGemvBytes holds, at most kMaxSlots.
template <int MB>
struct Slots {
  static constexpr int kRaw = kSlotBytes;
  static constexpr int kAct = kRaw + MB * kMaxKB * 4;
  static constexpr int kScale = kAct + MB * kActRow * 2;
  static constexpr int kStride = (kScale + 4 * kMaxKB + kAlign - 1) / kAlign * kAlign;
  static constexpr int kCount = kGemvBytes / kStride < kMaxSlots ? kGemvBytes / kStride : kMaxSlots;
};

// The GEMV phases.
enum Kind { kQkv = 0, kOut = 1, kUp = 2, kDown = 3 };

}  // namespace

// Mirror of mlio_tpu_torch/ops/decode_tiled.py::_Params.
struct TiledParams {
  const bf16* x;
  bf16* x_out;
  void* k_cache;  // bf16, or int8 where k_scale is set
  void* v_cache;
  float *k_scale, *v_scale;  // INT8 cache: [L, B, Smax, Hkv]
  const bf16 *ln1_scale, *ln1_bias, *ln2_scale, *ln2_bias;
  const bf16 *bq, *bk, *bv, *bo, *b_up, *b_gate, *b_down;
  // [L, in, out], wfmt; with E > 0 the MLP's are the expert stacks [L, E, in, out]
  const void *wq, *wk, *wv, *wo, *w_up, *w_gate, *w_down;
  const float *sq, *sk, *sv, *so, *s_up, *s_gate, *s_down;  // [L, (E,) out] (int8, fp8)
  const float *cos, *sin;  // [1, rope_dim], bf16-rounded
  float* work;
  unsigned* sync;
  unsigned long long* stamps;  // optional: block 0's %globaltimer at the start and after each barrier
  const bf16* router;          // MoE: [L, H, E]
  float* router_probs;         // optional: block 0 writes each layer's softmax [L, B, E]
  int B, H, Hq, Hkv, D, I, L, Smax, pos, rope_dim, rmsnorm, activation, wfmt, ka, splits,
      nblocks, smem, E, top_k;
  float eps, scale;
};

// The weights' tensor maps, in the order wq, wk, wv, wo, w_up, w_gate,
// w_down (mlio_decode_tiled_maps).
struct TiledMaps {
  CUtensorMap w[7];
};

namespace {

__host__ __device__ inline size_t up64(size_t x) { return (x + 63) / 64 * 64; }

// Batch rows of the GEMV tier for B: the n-tiles of 8 the products take.
__host__ __device__ inline int tier_rows(int B) { return B <= 8 ? 8 : (B <= 16 ? 16 : 32); }

// ---- the item plan of a GEMV phase ------------------------------------------
// (mirrored by mlio_tpu_torch/ops/decode_tiled.py::item_plan for the CPU
// tests; mlio_decode_tiled_items exports it for the card's check)

struct Job {
  int ntiles;  // tiles: (matrix or picked expert, column tile)
  int nk;      // units a tile
  int kb;      // weight rows a unit
  int K;       // rows of the product
  int tc;      // columns a tile of each matrix (256 bytes)
  int ct;      // column tiles of one matrix (one expert's)
  int nm;      // matrices a tile: up and gate side by side, else 1
};

__host__ __device__ inline int col_tiles(int N, int tc) { return (N + tc - 1) / tc; }

__host__ __device__ inline Job make_job(int kind, int H, int Qd, int KVd, int I, int isz,
                                        bool gated, int npicked) {
  Job j;
  j.tc = kTileBytes / isz;
  j.nm = kind == kUp && gated ? 2 : 1;
  j.kb = kSlotBytes / (j.nm * kTileBytes);
  if (kind == kQkv) {
    j.ct = col_tiles(Qd, j.tc);
    j.ntiles = j.ct + 2 * col_tiles(KVd, j.tc);
    j.K = H;
  } else if (kind == kOut) {
    j.ct = j.ntiles = col_tiles(H, j.tc);
    j.K = Qd;
  } else if (kind == kUp) {
    j.ct = col_tiles(I, j.tc);
    j.ntiles = npicked * j.ct;
    j.K = H;
  } else {
    j.ct = col_tiles(H, j.tc);
    j.ntiles = npicked * j.ct;
    j.K = I;
  }
  j.nk = (j.K + j.kb - 1) / j.kb;
  return j;
}

// Block b of nb streams units [unit_begin(b), unit_begin(b + 1)) of the U
// units of a phase; unit_owner(u) is the block that streams unit u. 32-bit:
// the plan function refuses a phase whose U * nb does not fit.
__host__ __device__ inline int unit_begin(int U, int nb, int b) {
  return static_cast<int>(static_cast<unsigned>(U) * b / nb);
}
__host__ __device__ inline int unit_owner(int U, int nb, int u) {
  return static_cast<int>((static_cast<unsigned>(u + 1) * nb + U - 1) / U) - 1;
}
// The blocks that stream tile i: first and last (its segments, in k order,
// are those of the blocks between them whose run is not empty: with fewer
// units than blocks some runs are).
__host__ __device__ inline int seg_first(const Job& j, int nb, int i) {
  return unit_owner(j.ntiles * j.nk, nb, i * j.nk);
}
__host__ __device__ inline int seg_last(const Job& j, int nb, int i) {
  return unit_owner(j.ntiles * j.nk, nb, (i + 1) * j.nk - 1);
}
// The weight rows of unit u (those of the last k block may be fewer).
__host__ __device__ inline int unit_rows(const Job& j, int u) {
  const int k0 = u % j.nk * j.kb;
  return j.K - k0 < j.kb ? j.K - k0 : j.kb;
}
__host__ __device__ inline bool has_units(const Job& j, int nb, int b) {
  const int U = j.ntiles * j.nk;
  return unit_begin(U, nb, b) < unit_begin(U, nb, b + 1);
}
__host__ __device__ inline int tile_segments(const Job& j, int nb, int i) {
  int n = 0;
  for (int b = seg_first(j, nb, i), e = seg_last(j, nb, i); b <= e; ++b) n += has_units(j, nb, b);
  return n;
}

// Offsets, in floats, of the global workspace.
struct Plan {
  int W;           // Qd + 2 KVd: a row of the qkv buffer
  int att_stride;  // floats of one attention split: m[G], l[G], acc[G][D]
  size_t xres, qkv, att, attn, part, act, total;
  int counters;    // the GEMV sums' counters; B * Hkv attention counters follow
};

__host__ __device__ inline Plan make_plan(const TiledParams& p) {
  Plan pl;
  const int G = p.Hq / p.Hkv, Qd = p.Hq * p.D, KVd = p.Hkv * p.D, E = p.E > 0 ? p.E : 1;
  const int isz = p.wfmt == 0 ? 2 : 1;
  const bool gated = p.activation >= 4;
  pl.W = Qd + 2 * KVd;
  pl.att_stride = 2 * G + G * p.D;
  const size_t B = p.B, mb = tier_rows(p.B);
  size_t part = 0;
  pl.counters = 0;
  for (int kind = kQkv; kind <= kDown; ++kind) {  // at most every expert picked
    const Job j = make_job(kind, p.H, Qd, KVd, p.I, isz, gated, E);
    const size_t need = static_cast<size_t>(p.nblocks + j.ntiles) * j.nm * j.tc * mb;
    part = part > need ? part : need;
    const int groups = kind == kDown ? j.ct : j.ntiles;
    pl.counters = pl.counters > groups ? pl.counters : groups;
  }
  size_t off = 0;
  pl.xres = off; off += up64(B * p.H);
  pl.qkv = off; off += up64(B * pl.W);
  pl.att = off; off += up64(B * p.Hkv * p.splits * static_cast<size_t>(pl.att_stride));
  pl.attn = off; off += up64(B * Qd);
  pl.part = off; off += up64(part);
  pl.act = off; off += up64((static_cast<size_t>(E) * B * p.I + 1) / 2);  // bf16 [E][B][I]
  pl.total = off;
  return pl;
}

// Mean and reciprocal deviation of each residual row (RMSNorm: mean 0), a
// warp a row, the fp32 statistics of the JAX kernel's _norm.
__device__ void row_stats(const TiledParams& p, const float* xres, float* s_mu, float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < p.B; r += kWarps) {
    const float* row = xres + static_cast<size_t>(r) * p.H;
    float mu = 0.f;
    if (!p.rmsnorm) {
      float sum = 0.f;
#pragma unroll 8
      for (int i = lane * 4; i < p.H; i += 128) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(row + i));
        sum += (v.x + v.y) + (v.z + v.w);
      }
      mu = warp_sum(sum) / p.H;
    }
    float sq = 0.f;
#pragma unroll 8
    for (int i = lane * 4; i < p.H; i += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(row + i));
      const float a = v.x - mu, b = v.y - mu, c = v.z - mu, d = v.w - mu;
      sq += (a * a + b * b) + (c * c + d * d);
    }
    sq = warp_sum(sq);
    if (lane == 0) {
      s_mu[r] = mu;
      s_rstd[r] = rsqrtf(sq / p.H + p.eps);
    }
  }
  __syncthreads();
}

// The MoE router of layer l for every row: fp32 logits hn @ router[l], hn =
// bf16(norm2(x32)) formed as the staged activations form it; p = exp(logits
// - max) / sum; the top_k of p by repeated max, the lowest index on ties;
// comb [B][kMaxE] in shared memory = p at the picks / their sum, 0
// elsewhere, and rowpick[b] the row's picks as a bit mask. A warp a row, one
// lane the softmax and top-k; every block that calls it computes the same
// bits (one code path, a fixed summation order: each lane's strided sum,
// then the warp's xor butterfly). Block 0 writes p to router_probs when it
// is set.
__device__ __noinline__ void moe_route(const TiledParams& p, int l, const float* xres,
                                       const float* s_mu, const float* s_rstd, const bf16* sc,
                                       const bf16* bi, float* comb, unsigned* rowpick) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, E = p.E, H = p.H;
  const bf16* wr = p.router + static_cast<size_t>(l) * H * E;
  for (int b = warp; b < p.B; b += kWarps) {
    float pe[kMaxE];
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) pe[e] = 0.f;
    for (int k = lane; k < H; k += 32) {
      float v = (__ldcg(xres + static_cast<size_t>(b) * H + k) - s_mu[b]) * s_rstd[b] *
                to_f32(sc[k]);
      if (bi != nullptr) v += to_f32(bi[k]);
      v = round_to<bf16>(v);
      const bf16* row = wr + static_cast<size_t>(k) * E;
#pragma unroll
      for (int e = 0; e < kMaxE; ++e)
        if (e < E) pe[e] = fmaf(v, to_f32(row[e]), pe[e]);
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) pe[e] = warp_sum(pe[e]);
    if (lane != 0) continue;
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      if (e < E) mx = fmaxf(mx, pe[e]);
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      if (e < E) {
        pe[e] = expf(pe[e] - mx);
        sum += pe[e];
      }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      if (e < E) {
        pe[e] = pe[e] / sum;
        if (p.router_probs != nullptr && blockIdx.x == 0)
          p.router_probs[(static_cast<size_t>(l) * p.B + b) * E + e] = pe[e];
      }
    unsigned picked = 0;
    for (int j = 0; j < p.top_k; ++j) {
      int best = -1;
      float bv = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxE; ++e)
        if (e < E && !((picked >> e) & 1u) && (best < 0 || pe[e] > bv)) {
          best = e;
          bv = pe[e];
        }
      picked |= 1u << best;
    }
    float csum = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      if (e < E && ((picked >> e) & 1u)) csum += pe[e];
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      comb[b * kMaxE + e] = (e < E && ((picked >> e) & 1u)) ? pe[e] / csum : 0.f;
    rowpick[b] = picked;
  }
  __syncthreads();
}

// ---- cp.async (the GEMV units' activations, attention's K/V ring) -------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the GEMV core ------------------------------------------------------------

// Where a unit's tile lies: its first column, the first weight row (at k
// row k0) in the tensor map, the matrix width, the map of the tile's first
// matrix and its expert (0 outside an MoE MLP).
struct UnitAt {
  int col0, row0, N, map, e;
};

template <int KIND>
__device__ __forceinline__ UnitAt unit_at(const TiledParams& p, const Job& j, int l,
                                          const int* picked, int tile, int k0) {
  UnitAt a;
  const int Qd = p.Hq * p.D, KVd = p.Hkv * p.D, E = p.E > 0 ? p.E : 1;
  a.e = 0;
  if constexpr (KIND == kQkv) {
    const int tq = col_tiles(Qd, j.tc), tk = col_tiles(KVd, j.tc);
    const int m = tile < tq ? 0 : (tile < tq + tk ? 1 : 2);
    a.map = m;
    a.col0 = (tile - (m == 0 ? 0 : (m == 1 ? tq : tq + tk))) * j.tc;
    a.N = m == 0 ? Qd : KVd;
    a.row0 = l * p.H + k0;
  } else if constexpr (KIND == kOut) {
    a.map = 3;
    a.col0 = tile * j.tc;
    a.N = p.H;
    a.row0 = l * Qd + k0;
  } else {
    const int r = tile / j.ct;
    a.e = picked[1 + r];
    a.col0 = (tile - r * j.ct) * j.tc;
    a.map = KIND == kUp ? 4 : 6;
    a.N = KIND == kUp ? p.I : p.H;
    a.row0 = (l * E + a.e) * (KIND == kUp ? p.H : p.I) + k0;
  }
  return a;
}

// Unit (tile, k rows from k0) into a ring slot. Thread 0 asks the TMA for
// each matrix's two 128-byte boxes of the tile's rows (the second only where
// it starts inside the matrix: its columns are never used otherwise),
// counted on the slot's barrier. Every thread copies its 16-byte chunks of
// the unit's raw activation rows (rows b < B, k rows inside K: the residual
// or the attention output in fp32, kDown's activations in bf16) and, before
// a norm, of the norm's scale and bias, by cp.async; the caller commits them
// as one group.
template <int MB, int FMT, int KIND, bool kDual>
__device__ __forceinline__ void issue_unit(const TiledParams& p, const TiledMaps& maps,
                                           const Plan& pl, const Job& j, int l,
                                           const int* picked, int tile, int k0,
                                           unsigned char* slot, uint64_t* bar) {
  constexpr int isz = FMT == 0 ? 2 : 1, NM = kDual ? 2 : 1;
  constexpr int KB = kSlotBytes / (NM * kTileBytes), half = kBoxBytes / isz;
  const UnitAt a = unit_at<KIND>(p, j, l, picked, tile, k0);
  // Box b (matrix b / 2, half b % 2) from lane 0 of warp 7 - b, so that no
  // one thread issues them all; warp 7 counts the bytes (a box may land
  // before the count: the phase completes only when both are in).
  const int box = kWarps - 1 - static_cast<int>(threadIdx.x / 32);
  if (threadIdx.x % 32 == 0 && box < 2 * NM) {
    const int boxes = a.col0 + half < a.N ? 2 : 1;
    if (box == 0) tma::bar_expect(bar, static_cast<uint32_t>(NM * boxes * KB * kBoxBytes));
    if (box % 2 < boxes)
      tma::load_2d(slot + box * KB * kBoxBytes, &maps.w[a.map + box / 2],
                   a.col0 + (box % 2) * half, a.row0, bar);
  }
  // the activation copies: warps 0-3 (the issuing warps are 4-7)
  constexpr int kCopiers = kThreads / 2;
  const int kn = min(KB, j.K - k0);
  if constexpr (KIND == kDown) {  // bf16 rows straight into the fragment rows
    const int cpr = kn / 8;       // 16-byte chunks a row
    unsigned char* act = slot + Slots<MB>::kAct;
    const bf16* src = reinterpret_cast<const bf16*>(p.work + pl.act) +
                      static_cast<size_t>(a.e) * p.B * p.I + k0;
    for (int c = threadIdx.x; threadIdx.x < kCopiers && c < p.B * cpr; c += kCopiers) {
      const int b = c / cpr, q = c - b * cpr;
      cp_async16(act + (b * kActRow + q * 8) * 2, src + static_cast<size_t>(b) * p.I + q * 8);
    }
  } else {
    const int cpr = kn / 4, ld = KIND == kOut ? p.Hq * p.D : p.H;
    unsigned char* raw = slot + Slots<MB>::kRaw;
    const float* src = p.work + (KIND == kOut ? pl.attn : pl.xres) + k0;
    for (int c = threadIdx.x; threadIdx.x < kCopiers && c < p.B * cpr; c += kCopiers) {
      const int b = c / cpr, q = c - b * cpr;
      cp_async16(raw + (b * kMaxKB + q * 4) * 4, src + static_cast<size_t>(b) * ld + q * 4);
    }
    if constexpr (KIND == kQkv || KIND == kUp) {
      const size_t at = static_cast<size_t>(l) * p.H + k0;
      const bf16* sc = (KIND == kQkv ? p.ln1_scale : p.ln2_scale) + at;
      const bf16* bi = KIND == kQkv ? p.ln1_bias : p.ln2_bias;
      const int cs = kn / 8, parts = bi != nullptr && !p.rmsnorm ? 2 : 1;
      for (int c = threadIdx.x; threadIdx.x < kCopiers && c < parts * cs; c += kCopiers) {
        const int w = c / cs, q = c - w * cs;
        cp_async16(slot + Slots<MB>::kScale + w * kMaxKB * 2 + q * 16,
                   (w ? bi + at : sc) + q * 8);
      }
    }
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kDown: one expert's sum s at (column col, batch row b) times the expert's
// scale and the row's comb.
__device__ __forceinline__ float fold_expert(const TiledParams& p, int l, int E, int e, int col,
                                             int b, const float* comb, float s) {
  if (p.wfmt != 0) s *= p.s_down[(static_cast<size_t>(l) * E + e) * p.H + col];
  if (p.E > 0) s *= comb[b * kMaxE + e];
  return s;
}

// The epilogue of a GEMV sum: group grp (a tile; kDown: a column tile over
// the picked experts) is complete in the partials. Thread 0 lists the
// partials in summation order (expert, then block: k order) into `segs`;
// then each thread takes kSumOuts outputs (column, batch row) at a time,
// their loads of one partial in flight together, sums the partials in that
// order, and applies the scale, bias, activation or residual.
template <int MB, int FMT, int KIND, bool kDual>
__device__ void finish_group(const TiledParams& p, const Plan& pl, const Job& j, int l, int grp,
                             const int* picked, const float* comb, int* segs) {
  constexpr int isz = FMT == 0 ? 2 : 1, NM = kDual ? 2 : 1, TC = kTileBytes / isz;
  constexpr int O = kSumOuts;
  constexpr size_t kSlotFloats = static_cast<size_t>(NM) * TC * MB;
  const int nb = gridDim.x, B = p.B, H = p.H, E = p.E > 0 ? p.E : 1;
  const float* part = p.work + pl.part;
  float* xres = p.work + pl.xres;
  if (threadIdx.x == 0) {
    int n = 0;
    const int nr = KIND == kDown ? picked[0] : 1;
    for (int r = 0; r < nr; ++r) {
      const int i = KIND == kDown ? r * j.ct + grp : grp;
      for (int b = seg_first(j, nb, i), e = seg_last(j, nb, i); b <= e; ++b)
        if (has_units(j, nb, b) && n < kMaxSegs) segs[1 + n++] = ((b + i) << 4) | r;
    }
    segs[0] = n;
  }
  __syncthreads();
  const int nseg = segs[0];
  const UnitAt a = unit_at<KIND>(p, j, l, picked, grp, 0);
  const int col0 = KIND == kDown ? grp * TC : a.col0;
  const int width = min(TC, (KIND == kDown ? H : a.N) - col0);
  const int nout = width * B;
  for (int o0 = threadIdx.x; o0 < nout; o0 += kThreads * O) {
    int cc[O], bb[O];
    float s[O][NM], tot[O];
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const int o = min(o0 + i * kThreads, nout - 1);  // past nout: a repeat, never stored
      cc[i] = o / B;
      bb[i] = o - cc[i] * B;
      tot[i] = 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) s[i][m] = 0.f;
    }
    int rcur = nseg > 0 ? (segs[1] & 15) : 0;
    for (int q = 0; q < nseg; ++q) {
      const int tag = segs[1 + q];
      if (KIND == kDown && (tag & 15) != rcur) {  // the next expert: fold this one's sums
#pragma unroll
        for (int i = 0; i < O; ++i) {
          tot[i] += fold_expert(p, l, E, picked[1 + rcur], col0 + cc[i], bb[i], comb, s[i][0]);
          s[i][0] = 0.f;
        }
        rcur = tag & 15;
      }
      const float* base = part + static_cast<size_t>(tag >> 4) * kSlotFloats;
      float v[O][NM];
#pragma unroll
      for (int i = 0; i < O; ++i)
#pragma unroll
        for (int m = 0; m < NM; ++m) v[i][m] = __ldcg(base + (m * TC + cc[i]) * MB + bb[i]);
#pragma unroll
      for (int i = 0; i < O; ++i)
#pragma unroll
        for (int m = 0; m < NM; ++m) s[i][m] += v[i][m];
    }
#pragma unroll
    for (int i = 0; i < O; ++i) {
      if (o0 + i * kThreads >= nout) break;
      const int b = bb[i], col = col0 + cc[i];
      if constexpr (KIND == kQkv) {
        const float* wsc = a.map == 0 ? p.sq : (a.map == 1 ? p.sk : p.sv);
        const bf16* bias = a.map == 0 ? p.bq : (a.map == 1 ? p.bk : p.bv);
        const int Qd = p.Hq * p.D, KVd = p.Hkv * p.D;
        const int off = a.map == 0 ? 0 : (a.map == 1 ? Qd : Qd + KVd);
        float v = s[i][0];
        if (FMT != 0) v *= wsc[static_cast<size_t>(l) * a.N + col];
        if (bias != nullptr) v += to_f32(bias[static_cast<size_t>(l) * a.N + col]);
        __stcg(p.work + pl.qkv + static_cast<size_t>(b) * pl.W + off + col, v);
      } else if constexpr (KIND == kOut) {
        float v = s[i][0];
        if (FMT != 0) v *= p.so[static_cast<size_t>(l) * H + col];
        if (p.bo != nullptr) v += to_f32(p.bo[static_cast<size_t>(l) * H + col]);
        float* xp = xres + static_cast<size_t>(b) * H + col;
        __stcg(xp, __ldcg(xp) + v);
      } else if constexpr (KIND == kUp) {
        const size_t sc = (static_cast<size_t>(l) * E + a.e) * p.I + col;  // scales
        const size_t bc = static_cast<size_t>(l) * p.I + col;               // biases (dense)
        float u = s[i][0], g = 0.f;
        if (FMT != 0) u *= p.s_up[sc];
        if (p.b_up != nullptr) u += to_f32(p.b_up[bc]);
        if constexpr (kDual) {
          g = s[i][NM - 1];
          if (FMT != 0) g *= p.s_gate[sc];
          if (p.b_gate != nullptr) g += to_f32(p.b_gate[bc]);
        }
        bf16* dst = reinterpret_cast<bf16*>(p.work + pl.act);
        dst[(static_cast<size_t>(a.e) * B + b) * p.I + col] =
            from_f32<bf16>(activate(p.activation, u, g));
      } else {
        if (nseg > 0) tot[i] += fold_expert(p, l, E, picked[1 + rcur], col, b, comb, s[i][0]);
        float* xp = xres + static_cast<size_t>(b) * H + col;
        float x = __ldcg(xp) + tot[i];
        if (p.b_down != nullptr) x += to_f32(p.b_down[static_cast<size_t>(l) * H + col]);
        __stcg(xp, x);
        if (l == p.L - 1) p.x_out[static_cast<size_t>(b) * H + col] = from_f32<bf16>(x);
      }
    }
  }
}

// A unit's raw fp32 activations (its copies complete and visible) into the
// bf16 rows the products read: bf16(norm) of the residual (kQkv, kUp: the
// JAX kernel's _norm, (x - mean) * rstd * scale + bias) or the attention
// output (kOut: bf16 values already). kDown's rows arrive as bf16.
template <int MB, int KIND>
__device__ __forceinline__ void convert_unit(const TiledParams& p, unsigned char* slot, int kn,
                                             const float* s_mu, const float* s_rstd,
                                             bool has_bi) {
  if constexpr (KIND != kDown) {
    const int cpr = kn / 4;
    const float* raw = reinterpret_cast<const float*>(slot + Slots<MB>::kRaw);
    bf16* act = reinterpret_cast<bf16*>(slot + Slots<MB>::kAct);
    const bf16* sc = reinterpret_cast<const bf16*>(slot + Slots<MB>::kScale);
    for (int c = threadIdx.x; c < p.B * cpr; c += kThreads) {
      const int b = c / cpr, k = (c - b * cpr) * 4;
      float4 x = *reinterpret_cast<const float4*>(raw + b * kMaxKB + k);
      if constexpr (KIND != kOut) {
        const float mu = s_mu[b], rs = s_rstd[b];
        const float2 s0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + k));
        const float2 s1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + k + 2));
        float2 c0 = make_float2(0.f, 0.f), c1 = c0;
        if (has_bi) {
          c0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + kMaxKB + k));
          c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + kMaxKB + k + 2));
        }
        x.x = (x.x - mu) * rs * s0.x + c0.x;
        x.y = (x.y - mu) * rs * s0.y + c0.y;
        x.z = (x.z - mu) * rs * s1.x + c1.x;
        x.w = (x.w - mu) * rs * s1.y + c1.y;
      }
      *reinterpret_cast<uint2*>(act + b * kActRow + k) =
          make_uint2(gemm::pack_bf16(x.x, x.y), gemm::pack_bf16(x.z, x.w));
    }
  }
}

// One k-step (16 weight rows) of a unit: the lane's B fragments from the bf16
// activation rows, each matrix's A fragments by ldmatrix.trans (int8 / e4m3
// widened to bf16), the products into acc.
template <int NM, int PM, int NT, int FMT, int KB>
__device__ __forceinline__ void kstep(float (&acc)[NM * PM][NT][4], uint32_t st, const bf16* act,
                                      int s, int g, int t) {
  uint32_t b0[NT], b1[NT];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const bf16* row = act + (8 * jn + g) * kActRow + 16 * s + 2 * t;
    b0[jn] = *reinterpret_cast<const uint32_t*>(row);
    b1[jn] = *reinterpret_cast<const uint32_t*>(row + 8);
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    uint32_t r[4];
    gemm::ldmatrix_x4_trans(r, st + (m * 2 * KB + 16 * s) * kBoxBytes);
    if constexpr (FMT == 0) {
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) gemm::mma16816(acc[m][jn], r, b0[jn], b1[jn]);
    } else {
      const uint32_t a0[4] = {frag_pair<FMT, 0>(r[0]), frag_pair<FMT, 0>(r[1]),
                              frag_pair<FMT, 0>(r[2]), frag_pair<FMT, 0>(r[3])};
      const uint32_t a1[4] = {frag_pair<FMT, 1>(r[0]), frag_pair<FMT, 1>(r[1]),
                              frag_pair<FMT, 1>(r[2]), frag_pair<FMT, 1>(r[3])};
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        gemm::mma16816(acc[2 * m][jn], a0, b0[jn], b1[jn]);
        gemm::mma16816(acc[2 * m + 1][jn], a1, b0[jn], b1[jn]);
      }
    }
  }
}

// A block's run of units in a GEMV phase: the phase's shape, the run's first
// unit and length, and the next unit to issue (tile, k block).
struct Run {
  Job j;
  int u0, n, itile, ikb;
};

// Unit i of the run into its ring slot (where the run has one), then a
// cp.async group.
template <int MB, int FMT, int KIND, bool kDual>
__device__ __forceinline__ void issue_next(const TiledParams& p, const TiledMaps& maps,
                                           const Plan& pl, int l, unsigned char* ring,
                                           uint64_t* full, unsigned seq, Run& r, int i) {
  constexpr int S = Slots<MB>::kCount;
  constexpr int KB = kSlotBytes / ((kDual ? 2 : 1) * kTileBytes);
  if (i < r.n) {
    const unsigned q = (seq + i) % S;
    issue_unit<MB, FMT, KIND, kDual>(p, maps, pl, r.j, l,
                                     reinterpret_cast<const int*>(ring + kPicked), r.itile,
                                     r.ikb * KB, ring + q * Slots<MB>::kStride, &full[q]);
    if (++r.ikb == r.j.nk) {
      r.ikb = 0;
      ++r.itile;
    }
  }
  cp_async_commit();
}

// The block's run of a phase (the picked experts' count in the MLP phases),
// and its first Slots<MB>::kCount units' copies.
template <int MB, int FMT, int KIND, bool kDual>
__device__ __forceinline__ void plan_run(const TiledParams& p, const TiledMaps& maps,
                                         const Plan& pl, int l, unsigned char* ring,
                                         uint64_t* full, unsigned seq, Run& r) {
  const int isz = FMT == 0 ? 2 : 1;
  const int np = KIND == kUp || KIND == kDown ? reinterpret_cast<const int*>(ring + kPicked)[0]
                                              : 1;
  r.j = make_job(KIND, p.H, p.Hq * p.D, p.Hkv * p.D, p.I, isz, kDual, np);
  const int U = r.j.ntiles * r.j.nk, nb = gridDim.x;
  r.u0 = unit_begin(U, nb, blockIdx.x);
  r.n = unit_begin(U, nb, blockIdx.x + 1) - r.u0;
  r.itile = r.u0 / r.j.nk;
  r.ikb = r.u0 - r.itile * r.j.nk;
  for (int i = 0; i < Slots<MB>::kCount; ++i)
    issue_next<MB, FMT, KIND, kDual>(p, maps, pl, l, ring, full, seq, r, i);
}

// One GEMV phase of layer l (see the design note): this block's run of
// units through the ring (weights by TMA, activations by cp.async, both
// Slots<MB>::kCount units ahead), the products on the tensor cores, a
// partial at each segment's end, and the fixed-order sum of every group
// whose last segment this block brings. `seq` counts the units the block
// has passed through the ring (its slots' barrier phases).
template <int MB, int FMT, int KIND, bool kDual>
__device__ __noinline__ void gemv_phase(const TiledParams& p, const TiledMaps& maps, int l,
                                        unsigned char* ring, uint64_t* full, unsigned* s_seq,
                                        float* s_mu, float* s_rstd) {
  constexpr int isz = FMT == 0 ? 2 : 1;
  constexpr int NM = kDual ? 2 : 1;                // matrices a tile
  constexpr int KB = kSlotBytes / (NM * kTileBytes);
  constexpr int TC = kTileBytes / isz;             // columns a tile of each matrix
  constexpr int NT = MB / 8;                       // n-tiles: batch rows
  constexpr int PM = FMT == 0 ? 1 : 2;             // m-tiles a warp a matrix
  constexpr int S = Slots<MB>::kCount, SS = Slots<MB>::kStride;
  constexpr bool kNorm = KIND == kQkv || KIND == kUp;
  constexpr size_t kSlotFloats = static_cast<size_t>(NM) * TC * MB;
  static_assert(KIND == kUp || !kDual, "only up and gate go side by side");
  static_assert(S >= 3, "three ring slots at least: copies complete two units ahead");
  static_assert(S <= kMaxSlots, "a barrier a slot");
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nb = gridDim.x, bid = blockIdx.x, H = p.H;
  const bool moe = p.E > 0;
  const Plan pl = make_plan(p);
  const unsigned seq = *s_seq;  // read before the first barrier; thread 0 advances it at the end
  float* xres = p.work + pl.xres;
  float* comb = reinterpret_cast<float*>(ring + kComb);
  int* picked = reinterpret_cast<int*>(ring + kPicked);
  int* segs = reinterpret_cast<int*>(ring + kSegs);

  if constexpr (KIND == kUp) {
    if (!moe) {  // a dense MLP is one "expert"
      if (tid == 0) {
        picked[0] = 1;
        picked[1] = 0;
      }
      __syncthreads();
    }
  }
  fence_proxy_async();  // the ring's bytes written by attention, before the TMA writes them
  __syncthreads();
  Run r;
  // Weights and raw activations do not depend on the norms: the first units'
  // copies go out first, except where the picks decide them.
  const bool early = !(KIND == kUp && moe);
  if (early) plan_run<MB, FMT, KIND, kDual>(p, maps, pl, l, ring, full, seq, r);
  if constexpr (kNorm) {
    if (early && r.n == 0) return;
    row_stats(p, xres, s_mu, s_rstd);
    if (KIND == kUp && moe) {
      const bf16* sc = p.ln2_scale + static_cast<size_t>(l) * H;
      const bf16* bi = p.ln2_bias != nullptr && !p.rmsnorm
                           ? p.ln2_bias + static_cast<size_t>(l) * H : nullptr;
      unsigned* rowpick = reinterpret_cast<unsigned*>(ring + kRowPick);
      moe_route(p, l, xres, s_mu, s_rstd, sc, bi, comb, rowpick);
      if (tid == 0) {
        unsigned any = 0;
        for (int b = 0; b < p.B; ++b) any |= rowpick[b];
        int np = 0;
        for (int e = 0; e < p.E; ++e)
          if ((any >> e) & 1u) picked[1 + np++] = e;
        picked[0] = np;
      }
      __syncthreads();
    }
  }
  if (!early) plan_run<MB, FMT, KIND, kDual>(p, maps, pl, l, ring, full, seq, r);
  const Job& j = r.j;
  const int u0 = r.u0, n = r.n;
  if (n == 0) {
    cp_async_wait<0>();
    return;
  }
  const bf16* nbias = KIND == kQkv ? p.ln1_bias : p.ln2_bias;
  const bool has_bi = kNorm && nbias != nullptr && !p.rmsnorm;
  // This lane's ldmatrix row address in a box (16 rows a k-step): rows
  // lane % 8 (+ 8 for matrices 2 and 3) at 16-byte chunk 2 (warp % 4) (+ 1
  // for matrices 1 and 3), swizzled; the warp's half of the tile row.
  const uint32_t loff = ((lane & 7) + 8 * (lane >> 4)) * kBoxBytes +
                        (((2 * (warp & 3) + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
  const uint32_t ring_s = gemm::smem_addr(ring) + (warp >> 2) * KB * kBoxBytes + loff;
  float acc[NM * PM][NT][4];
#pragma unroll
  for (int m = 0; m < NM * PM; ++m)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) acc[m][jn][r4] = 0.f;

  int tile = u0 / j.nk, kbi = u0 - tile * j.nk;
  // The activations go to bf16 one unit ahead of their products, by every
  // thread, between the barriers that follow their copies' completion: unit
  // 0 here (copies of units 0 and 1 complete), unit it + 1 in iteration it
  // (copies of units up to it + 1 made visible by the barrier that ended
  // iteration it - 1).
  cp_async_wait<S - 2>();
  __syncthreads();
  convert_unit<MB, KIND>(p, ring + (seq % S) * SS, unit_rows(j, u0), s_mu, s_rstd, has_bi);
  __syncthreads();
  for (int it = 0; it < n; ++it) {
    const unsigned q = (seq + it) % S;
    if (it + 1 < n)
      convert_unit<MB, KIND>(p, ring + ((seq + it + 1) % S) * SS, unit_rows(j, u0 + it + 1),
                             s_mu, s_rstd, has_bi);
    tma::bar_wait_bounded(&full[q], ((seq + it) / S) & 1u);
    const bf16* act = reinterpret_cast<const bf16*>(ring + q * SS + Slots<MB>::kAct);
    const uint32_t st = ring_s + q * SS;
    const int nks = min(KB, j.K - kbi * KB) / 16;
    if (nks == KB / 16) {
#pragma unroll
      for (int s = 0; s < KB / 16; ++s) kstep<NM, PM, NT, FMT, KB>(acc, st, act, s, g, t);
    } else {
      for (int s = 0; s < nks; ++s) kstep<NM, PM, NT, FMT, KB>(acc, st, act, s, g, t);
    }
    if (it + 1 == n || kbi == j.nk - 1) {  // the segment's end: its partial, then maybe the sum
      float* P = p.work + pl.part + static_cast<size_t>(bid + tile) * kSlotFloats;
#pragma unroll
      for (int m = 0; m < NM; ++m)
#pragma unroll
        for (int pm = 0; pm < PM; ++pm) {
          // accumulator rows g and g + 8: the tile columns they hold
          const int c = FMT == 0 ? 16 * warp + g : 32 * warp + 2 * g + pm;
          float* pr = P + static_cast<size_t>(m * TC + c) * MB + 2 * t;
          float* pr8 = pr + (FMT == 0 ? 8 : 16) * MB;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            float(&a)[4] = acc[m * PM + pm][jn];
            __stcg(reinterpret_cast<float2*>(pr + 8 * jn), make_float2(a[0], a[1]));
            __stcg(reinterpret_cast<float2*>(pr8 + 8 * jn), make_float2(a[2], a[3]));
            a[0] = a[1] = a[2] = a[3] = 0.f;
          }
        }
      __threadfence();
      __syncthreads();
      const int grp = KIND == kDown ? tile % j.ct : tile;
      if (tid == 0) {
        int total = 0;
        if (KIND == kDown) {
          for (int r = 0; r < picked[0]; ++r) total += tile_segments(j, nb, r * j.ct + grp);
        } else {
          total = tile_segments(j, nb, grp);
        }
        unsigned* ctr = p.sync + 2 + grp;
        const bool last = atomicAdd(ctr, 1u) == static_cast<unsigned>(total - 1);
        if (last) atomicExch(ctr, 0u);
        s_last = last;
      }
      __syncthreads();
      if (s_last) {
        __threadfence();
        finish_group<MB, FMT, KIND, kDual>(p, pl, j, l, grp, picked, comb, segs);
      }
    }
    if (++kbi == j.nk) {
      kbi = 0;
      ++tile;
    }
    cp_async_wait<S - 3>();  // this thread's copies of units up to it + 2
    __syncthreads();         // ... everyone's, and unit it + 1's bf16 rows; slot q is free
    issue_next<MB, FMT, KIND, kDual>(p, maps, pl, l, ring, full, seq, r, it + S);
  }
  cp_async_wait<0>();
  if (tid == 0) *s_seq = seq + n;
}

// ---- 2. attention ----------------------------------------------------------

// The INT8 cache's write of the current token: warp 0 quantizes the K row of
// D fp32 values in s_kv, warp 1 the V row, as quantize_kv does (scale =
// amax / 127, or 1 where amax is 0; round half to even of a true division;
// clip to +-127), and stores the int8 row at element offset `cur` and its
// scale at cur / D.
template <int D>
__device__ void quantize_slot(const TiledParams& p, const float* s_kv, size_t cur) {
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

// Attention's K/V ring: where a (sequence, KV head) split's cache rows lie.
template <class E>
struct AttnRing {
  unsigned char* ring;
  const E *kb, *vb;                // the K and V rows of slot 0
  const float *k_scale, *v_scale;  // an INT8 cache's scales
  size_t rowb;                     // the (layer, sequence)'s slot 0 element
  int t0, cnt, nsl, KVd, hk;       // the split's first slot and slots; ring slots
};

// The copies of ring slot sl (kTok cache slots: [kTok][K row | V row], then
// [kTok][k, v] scales), one cp.async group (empty past the split). A
// function, not a lambda, so that it is always inlined into the hot loop.
template <int D, bool kQ, class E>
__device__ __forceinline__ void attn_issue(const AttnRing<E>& rg, int sl) {
  constexpr int V = 8, LPT = D / V, TPI = 32 / LPT, STEP = kWarps * TPI;
  constexpr int kRow = D * static_cast<int>(sizeof(E));
  constexpr int kTok = STEP * 2;
  if (sl < rg.nsl) {
    unsigned char* dst = rg.ring + (sl % kStages) * kStageBytes;
    const int j0 = sl * kTok, nt = min(kTok, rg.cnt - j0);
    constexpr int cpr = 2 * kRow / 16;  // 16-byte copies a slot's K and V rows
    for (int c = threadIdx.x; c < nt * cpr; c += kThreads) {
      const int j = c / cpr, q = c - j * cpr, kv = q / (cpr / 2), o = (q % (cpr / 2)) * 16;
      const size_t off = static_cast<size_t>(rg.t0 + j0 + j) * rg.KVd;
      cp_async16(dst + (2 * j + kv) * kRow + o,
                 reinterpret_cast<const unsigned char*>((kv ? rg.vb : rg.kb) + off) + o);
    }
    if constexpr (kQ) {
      float* sd = reinterpret_cast<float*>(dst + kTok * 2 * kRow);
      for (int c = threadIdx.x; c < 2 * nt; c += kThreads) {
        const int j = c / 2, kv = c - 2 * j;
        const size_t si = (rg.rowb + static_cast<size_t>(rg.t0 + j0 + j) * rg.KVd) / D + rg.hk;
        cp_async4(sd + c, (kv ? rg.v_scale : rg.k_scale) + si);
      }
    }
  }
  cp_async_commit();
}

// Items of (sequence b, head group g, context split s): for each KV head of
// the group, the G query heads (RoPE, x scale, bf16) and, in the split that
// holds slot pos, the slot's K/V (RoPE on K; written as bf16 or quantized);
// then an online fp32 softmax over the split's slots, D / 8 lanes a slot and
// 8 elements a lane (K3's layout), and the split's (max, sum, unnormalised
// output) of each query head.
template <int D, bool kQ, int GM>
__device__ __noinline__ void attention_phase(const TiledParams& p, int layer,
                                             unsigned char* ring) {
  const Plan pl = make_plan(p);
  using E = std::conditional_t<kQ, int8_t, bf16>;
  constexpr int V = 8;
  constexpr int LPT = D / V;          // lanes a slot
  constexpr int TPI = 32 / LPT;       // slots a warp step
  constexpr int STEP = kWarps * TPI;  // slots a block step
  // The ring streams the split's K/V rows (and an INT8 cache's scales),
  // kTok slots a ring slot: [kTok][K row | V row], then [kTok][k, v] scales.
  constexpr int kRow = D * static_cast<int>(sizeof(E));  // bytes of a K or V row
  constexpr int kTok = STEP * 2;                          // cache slots a ring slot
  static_assert(kTok * (2 * kRow + (kQ ? 8 : 0)) <= kStageBytes, "a ring slot's K/V");
  static_assert(kAttnBuf<D, GM> <= kAttnBufBytes, "attention's buffers");
  float* s_raw = reinterpret_cast<float*>(ring + kRingBytes);  // [GM + 2][D]: q, k, v
  float* s_q = s_raw + (GM + 2) * D;               // [GM][D]
  float* sm_m = s_q + GM * D;                      // [kWarps][GM]
  float* sm_l = sm_m + kWarps * GM;                // [kWarps][GM]
  float* sm_acc = sm_l + kWarps * GM;              // [kWarps][GM][D]
  float* s_kv = sm_acc + kWarps * GM * D;          // [2][D]: the INT8 cache's k, v
  E* const kc = static_cast<E*>(p.k_cache);
  E* const vc = static_cast<E*>(p.v_cache);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPT, sub = lane % LPT;
  const int G = p.Hq / p.Hkv, S = p.splits, hkvg = p.Hkv / p.ka;
  const int Qd = p.Hq * D, KVd = p.Hkv * D;
  const int R = p.rope_dim, half = R / 2, n = p.pos + 1;
  const float* qkv = p.work + pl.qkv;
  float* att = p.work + pl.att;
  float* attn = p.work + pl.attn;
  const int items = p.B * p.ka * S;
  __shared__ int s_last;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / (p.ka * S), rest = it - b * (p.ka * S), grpi = rest / S, s = rest - grpi * S;
    const int t0 = static_cast<int>(static_cast<long long>(s) * n / S);
    const int t1 = static_cast<int>(static_cast<long long>(s + 1) * n / S);
    const bool cur = t1 == n;  // the split that holds slot pos
    for (int hk = grpi * hkvg; hk < (grpi + 1) * hkvg; ++hk) {
      __syncthreads();
      for (int e = threadIdx.x; e < (G + 2) * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        const int col = r < G ? (hk * G + r) * D + d : (r == G ? Qd : Qd + KVd) + hk * D + d;
        s_raw[e] = __ldcg(qkv + static_cast<size_t>(b) * pl.W + col);
      }
      __syncthreads();
      const size_t rowb = (static_cast<size_t>(layer) * p.B + b) * p.Smax * KVd;  // slot 0
      const size_t slot = rowb + static_cast<size_t>(p.pos) * KVd + hk * D;
      for (int e = threadIdx.x; e < (G + 2) * D; e += kThreads) {
        const int r = e / D, d = e - r * D;
        float val = s_raw[e];
        if (r <= G && d < R) {
          const float other = d < half ? -s_raw[r * D + d + half] : s_raw[r * D + d - half];
          val = val * p.cos[d] + other * p.sin[d];
        }
        if (r < G) s_q[e] = round_to<bf16>(val * p.scale);
        else if (!cur) continue;
        else if constexpr (kQ) s_kv[(r - G) * D + d] = val;
        else (r == G ? kc : vc)[slot + d] = from_f32<bf16>(val);
      }
      if constexpr (kQ) {
        if (cur) {
          __syncthreads();
          quantize_slot<D>(p, s_kv, slot);
        }
      }
      if (cur) __threadfence();  // the slot just written, before the ring reads it
      __syncthreads();  // the slot just written is visible to the whole block

      float qf[GM][V], m[GM], l[GM], acc[GM][V];  // GM >= G query heads
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          qf[g][i] = g < G ? s_q[g * D + sub * V + i] : 0.f;
          acc[g][i] = 0.f;
        }
        m[g] = -INFINITY;
        l[g] = 0.f;
      }
      const E* kb = kc + rowb + hk * D;
      const E* vb = vc + rowb + hk * D;
      const int cnt = t1 - t0, nsl = (cnt + kTok - 1) / kTok;
      const AttnRing<E> rg{ring, kb, vb, p.k_scale, p.v_scale, rowb, t0, cnt, nsl, KVd, hk};
      for (int sl = 0; sl < kStages - 1; ++sl) attn_issue<D, kQ>(rg, sl);
      for (int sl = 0; sl < nsl; ++sl) {
        attn_issue<D, kQ>(rg, sl + kStages - 1);
        cp_async_wait<kStages - 1>();
        __syncthreads();  // slot sl is visible to the block
        const unsigned char* src = ring + (sl % kStages) * kStageBytes;
        const float* ssc = reinterpret_cast<const float*>(src + kTok * 2 * kRow);
        const int nt = min(kTok, cnt - sl * kTok);
#pragma unroll
        for (int u = 0; u < kTok / STEP; ++u) {
          const int j = warp * TPI + grp + u * STEP;
          const bool valid = j < nt;
          float kv[V], vv[V];
          unpack8<E>(*reinterpret_cast<const Raw8<E>*>(src + j * 2 * kRow + sub * V * sizeof(E)),
                     kv);
          unpack8<E>(*reinterpret_cast<const Raw8<E>*>(src + j * 2 * kRow + kRow +
                                                       sub * V * sizeof(E)), vv);
          const float ksc = kQ ? ssc[2 * j] : 1.f, vsc = kQ ? ssc[2 * j + 1] : 1.f;
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g >= G) break;
            float sc = 0.f;
#pragma unroll
            for (int i = 0; i < V; ++i) sc += qf[g][i] * kv[i];
#pragma unroll
            for (int o = LPT / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
            if (kQ) sc *= ksc;
            if (valid) {
              const float m_new = fmaxf(m[g], sc);
              const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
              const float pr = expf(sc - m_new);
              l[g] = l[g] * alpha + pr;
              const float pv = kQ ? pr * vsc : pr;
#pragma unroll
              for (int i = 0; i < V; ++i) acc[g][i] = acc[g][i] * alpha + pv * vv[i];
              m[g] = m_new;
            }
          }
        }
        __syncthreads();  // the slot may be refilled
      }
      cp_async_wait<0>();
      // Merge the lane groups of each warp by shuffles, then the warps.
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
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
          for (int i = 0; i < V; ++i) sm_acc[(warp * GM + g) * D + sub * V + i] = acc[g][i];
          if (sub == 0) {
            sm_m[warp * GM + g] = mw;
            sm_l[warp * GM + g] = lw;
          }
        }
      }
      __syncthreads();
      // One split: the attention itself. Several: this split's (max, sum,
      // output); the last split of (b, hk) to arrive combines them in order.
      float* out = att + ((static_cast<size_t>(b) * p.Hkv + hk) * S + s) * pl.att_stride;
      float* dst = attn + static_cast<size_t>(b) * Qd + hk * G * D;
      for (int e = threadIdx.x; e < G * D; e += kThreads) {
        const int g = e / D, d = e - g * D;
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * GM + g]);
        float lt = 0.f, o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = (sm_m[w * GM + g] == -INFINITY) ? 0.f : expf(sm_m[w * GM + g] - mx);
          lt += sm_l[w * GM + g] * f;
          o += sm_acc[(w * GM + g) * D + d] * f;
        }
        if (S == 1) {
          __stcg(dst + e, round_to<bf16>(o / (lt == 0.f ? 1.f : lt)));
          continue;
        }
        if (d == 0) {
          __stcg(out + g, mx);
          __stcg(out + G + g, lt);
        }
        __stcg(out + 2 * G + g * D + d, o);
      }
      if (S == 1) continue;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned* c = p.sync + 2 + pl.counters + b * p.Hkv + hk;
        const bool last = atomicAdd(c, 1u) == static_cast<unsigned>(S - 1);
        if (last) atomicExch(c, 0u);
        s_last = last;
      }
      __syncthreads();
      if (!s_last) continue;
      __threadfence();
      const float* base = att + (static_cast<size_t>(b) * p.Hkv + hk) * S * pl.att_stride;
      for (int e = threadIdx.x; e < G * D; e += kThreads) {
        const int g = e / D, d = e - g * D;
        float mx = -INFINITY;
        for (int j = 0; j < S; ++j) mx = fmaxf(mx, __ldcg(base + j * pl.att_stride + g));
        float lt = 0.f, o = 0.f;
        for (int j = 0; j < S; ++j) {
          const float* sp = base + j * pl.att_stride;
          const float mj = __ldcg(sp + g);
          const float f = mj == -INFINITY ? 0.f : expf(mj - mx);
          lt += __ldcg(sp + G + g) * f;
          o += __ldcg(sp + 2 * G + g * D + d) * f;
        }
        __stcg(dst + e, round_to<bf16>(o / (lt == 0.f ? 1.f : lt)));
      }
    }
  }
}

// ---- the kernel ------------------------------------------------------------

// Phase timing (optional): block 0 stamps the global timer (ns) at the start
// and after every barrier, so stamp differences are phase durations.
__device__ __forceinline__ void stamp(const TiledParams& p, int& n) {
  if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[n] = t;
  }
  ++n;
}

// The end of a phase: the grid barrier, then a stamp.
__device__ __forceinline__ void sync_phase(const TiledParams& p, int& ns) {
  grid_sync(p.sync);
  stamp(p, ns);
}

#define MLIO_GEMV(KIND, DUAL)                                                              \
  switch (tier) {                                                                         \
    case 0:                                                                               \
      gemv_phase<8, MLIO_TILED_FMT, KIND, DUAL>(p, maps, l, ring, s_full, &s_seq, s_mu,   \
                                                s_rstd);                                  \
      break;                                                                              \
    case 1:                                                                               \
      gemv_phase<16, MLIO_TILED_FMT, KIND, DUAL>(p, maps, l, ring, s_full, &s_seq, s_mu,  \
                                                 s_rstd);                                 \
      break;                                                                              \
    default:                                                                              \
      gemv_phase<32, MLIO_TILED_FMT, KIND, DUAL>(p, maps, l, ring, s_full, &s_seq, s_mu,  \
                                                 s_rstd);                                 \
      break;                                                                              \
  }

// The kernel keeps nothing across its phases but the layer and the ring
// counter (in shared memory): each phase forms its own plan, so that the
// phase functions keep their registers.
template <int D, bool kQ, int GM>
__global__ void __launch_bounds__(kThreads, 1)
    tiled_kernel(const __grid_constant__ TiledParams p, const __grid_constant__ TiledMaps maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_mu[kMaxB], s_rstd[kMaxB];
  __shared__ __align__(8) uint64_t s_full[kMaxSlots];  // the GEMV ring's barriers
  __shared__ unsigned s_seq;  // units the block has passed through the ring
  // the ring 1 KB aligned (the 128-byte swizzle's period), in shared addresses
  unsigned char* ring = smem + (kAlign - gemm::smem_addr(smem) % kAlign) % kAlign;
  const int tier = p.B <= 8 ? 0 : (p.B <= 16 ? 1 : 2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxSlots; ++s) tma::bar_init(&s_full[s]);
    tma::bar_init_fence();
    s_seq = 0;
  }
  int ns = 0;
  stamp(p, ns);
  float* xres = p.work + make_plan(p).xres;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.B * p.H; e += gridDim.x * kThreads)
    __stcg(xres + e, to_f32(p.x[e]));
  sync_phase(p, ns);
  for (int l = 0; l < p.L; ++l) {
    MLIO_GEMV(kQkv, false)
    sync_phase(p, ns);
    attention_phase<D, kQ, GM>(p, l, ring);
    sync_phase(p, ns);
    MLIO_GEMV(kOut, false)
    sync_phase(p, ns);
    if (p.activation >= 4) {
      MLIO_GEMV(kUp, true)
    } else {
      MLIO_GEMV(kUp, false)
    }
    sync_phase(p, ns);
    MLIO_GEMV(kDown, false)
    sync_phase(p, ns);
  }
}

// The instance for head dim D, an INT8 cache (q) and G query heads a KV
// head: attention's register arrays sized for 4 (G <= 4) or kMaxG.
template <int D, bool kQ>
const void* pick_g(int G) {
  return G <= 4 ? reinterpret_cast<const void*>(tiled_kernel<D, kQ, 4>)
                : reinterpret_cast<const void*>(tiled_kernel<D, kQ, kMaxG>);
}

#ifdef MLIO_TILED_D256
// decode_tiled_d256.cu: Gemma's head dim alone, bf16 weights and cache, G <= 4
const void* pick(int D, bool q, int G) {
  return D == 256 && !q && G <= 4 ? reinterpret_cast<const void*>(tiled_kernel<256, false, 4>)
                                  : nullptr;
}
#else
const void* pick(int D, bool q, int G) {
  if (D == 64) return q ? pick_g<64, true>(G) : pick_g<64, false>(G);
  if (D == 128) return q ? pick_g<128, true>(G) : pick_g<128, false>(G);
  return nullptr;
}
#endif

}  // namespace

// Fills p->nblocks (the blocks resident at once), p->smem and the context
// splits, and returns the workspace sizes the wrapper allocates: work (fp32
// elements) and sync (int32 elements, zeroed: the barrier, the GEMV sums'
// and attention's counters).
extern "C" int mlio_decode_tiled_plan(TiledParams* p, long long* work_floats, int* sync_ints) {
  const int G = p->Hkv > 0 ? p->Hq / p->Hkv : 0;
  const void* k = pick(p->D, p->k_scale != nullptr, G);
  if (k == nullptr || p->B < 1 || p->B > kMaxB || G < 1 || G > kMaxG || p->Hq % p->Hkv ||
      p->ka < 1 || p->Hkv % p->ka || p->H % 16 || p->I % 16 || p->pos < 0 ||
      p->pos >= p->Smax || p->wfmt != MLIO_TILED_FMT || p->E < 0 || p->E > kMaxE ||
      (p->E > 0 && (p->top_k < 1 || p->top_k > p->E || p->router == nullptr)))
    return cudaErrorInvalidValue;
  const int smem = kSmemBytes;
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
  const int nb = occ * sms;
  p->nblocks = nb;
  p->smem = smem;
  // context splits: enough (sequence, group, split) items to fill the SMs,
  // at least 64 slots a split, at most 16 splits
  int splits = nb / (p->B * p->ka);
  const int by_len = (p->pos + 1) / 64;
  splits = splits < by_len ? splits : by_len;
  splits = splits < 16 ? splits : 16;
  p->splits = splits < 1 ? 1 : splits;
  // the plan's 32-bit arithmetic (unit_begin, unit_owner) and the sums' lists
  const int isz = p->wfmt == 0 ? 2 : 1, E = p->E > 0 ? p->E : 1;
  for (int kind = kQkv; kind <= kDown; ++kind) {
    const Job j = make_job(kind, p->H, p->Hq * p->D, p->Hkv * p->D, p->I, isz,
                           p->activation >= 4, E);
    // a sum's partials: a segment a block, one more a tile of the group
    if ((static_cast<double>(j.ntiles) * j.nk + 1) * (nb + 1) >= 2147483647.0 ||
        nb + (kind == kDown ? E : 1) > kMaxSegs || (nb + j.ntiles) >= (1 << 27))
      return cudaErrorInvalidValue;
  }
  const Plan pl = make_plan(*p);
  *work_floats = static_cast<long long>(pl.total);
  *sync_ints = 2 + pl.counters + p->B * p->Hkv;
  return cudaSuccess;
}

// The tensor maps of p's weights into out (sizeof(TiledMaps) bytes, no
// alignment asked): each [rows, columns] as the kernel reads it ([L * in,
// out]; an expert stack [L * E * in, out]), 128-byte boxes of a unit's rows
// (64; up and gate of a gated MLP 32), 128-byte swizzled. Errors as
// tma::map_2d's; a missing w_gate leaves its map zero.
extern "C" int mlio_decode_tiled_maps(const TiledParams* p, void* out) {
  TiledMaps m;
  memset(&m, 0, sizeof m);
  const uint64_t L = p->L, H = p->H, I = p->I, Qd = p->Hq * p->D, KVd = p->Hkv * p->D;
  const uint64_t E = p->E > 0 ? p->E : 1;
  const bool gated = p->activation >= 4;
  const uint32_t up_rows = gated ? kMaxKB / 2 : kMaxKB;
  const struct {
    const void* w;
    uint64_t rows, cols;
    uint32_t box_rows;
  } mats[7] = {{p->wq, L * H, Qd, kMaxKB},         {p->wk, L * H, KVd, kMaxKB},
               {p->wv, L * H, KVd, kMaxKB},         {p->wo, L * Qd, H, kMaxKB},
               {p->w_up, L * E * H, I, up_rows},    {gated ? p->w_gate : nullptr, L * E * H, I, up_rows},
               {p->w_down, L * E * I, H, kMaxKB}};
  for (int i = 0; i < 7; ++i) {
    if (mats[i].w == nullptr) {
      if (i == 5 && !gated) continue;
      return cudaErrorInvalidValue;
    }
    const cudaError_t e =
        MLIO_TILED_FMT == 0
            ? tma::map_2d(&m.w[i], mats[i].w, mats[i].rows, mats[i].cols, mats[i].cols,
                          mats[i].box_rows)
            : tma::map_2d_u8(&m.w[i], mats[i].w, mats[i].rows, mats[i].cols, mats[i].cols,
                             kBoxBytes, mats[i].box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
  }
  memcpy(out, &m, sizeof m);
  return cudaSuccess;
}

extern "C" int mlio_decode_tiled_maps_bytes() { return static_cast<int>(sizeof(TiledMaps)); }

// The segments of GEMV phase `kind` (0 QKV, 1 out-projection, 2 up, 3 down)
// as the kernel walks them at p->nblocks blocks, with `npicked` experts
// picked (the MLP phases): (block, tile, first unit, end unit) into out, at
// most cap of them; returns their count (or -1 past cap). p->nblocks comes
// from mlio_decode_tiled_plan.
extern "C" int mlio_decode_tiled_items(const TiledParams* p, int kind, int npicked, int* out,
                                       int cap) {
  const int isz = p->wfmt == 0 ? 2 : 1, nb = p->nblocks;
  if (kind < kQkv || kind > kDown || nb < 1) return -1;
  const Job j = make_job(kind, p->H, p->Hq * p->D, p->Hkv * p->D, p->I, isz,
                         p->activation >= 4, kind >= kUp ? npicked : 1);
  const int U = j.ntiles * j.nk;
  int n = 0;
  for (int b = 0; b < nb; ++b)
    for (int u = unit_begin(U, nb, b), end = unit_begin(U, nb, b + 1); u < end;) {
      const int tile = u / j.nk;
      const int stop = (tile + 1) * j.nk < end ? (tile + 1) * j.nk : end;
      if (n == cap) return -1;
      int* o = out + 4 * n++;
      o[0] = b;
      o[1] = tile;
      o[2] = u;
      o[3] = stop;
      u = stop;
    }
  return n;
}

// One cooperative launch on the given stream with the weights' maps (from
// mlio_decode_tiled_maps); a refused launch returns its error.
extern "C" int mlio_decode_tiled(const TiledParams* p, const void* maps, void* stream) {
  const void* k = pick(p->D, p->k_scale != nullptr, p->Hkv > 0 ? p->Hq / p->Hkv : 0);
  if (k == nullptr) return cudaErrorInvalidValue;
  TiledMaps m;
  memcpy(&m, maps, sizeof m);
  void* args[] = {const_cast<TiledParams*>(p), &m};
  const cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(p->nblocks), dim3(kThreads), args,
                                                    p->smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
