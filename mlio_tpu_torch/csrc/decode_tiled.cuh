// K6: the tiled decode megakernel for Hopper. One decode step of every layer
// of a large dense model in ONE launch, no head epilogue.
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
//   x32 += sum over intermediate chunks of
//          bf16(act(h2 @ w_up[:, chunk] + b_up [, h2 @ w_gate[:, chunk] + b_gate])) @ w_down[chunk]
//   + b_down. The last layer writes x_out = bf16(x32).
// A sparse-MoE model (E > 0: Mixtral; the JAX kernel's lines 704-795) routes
// at the fold: logits = h2 @ router[l] in fp32, p = exp(logits - max) / sum
// over the E experts, the top_k of p by repeated max (the lowest index on
// ties), comb = p at the picks / their sum (0 elsewhere); then
//   x32 += sum over experts e, chunks of
//          (bf16(act(h2 @ up_e[:, chunk], h2 @ gate_e[:, chunk])) @ down_e[chunk])
//          x s_down_e x comb[:, e]
// with each expert's per-channel scales; expert MLPs have no biases.
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
// runs blocks in parallel: the phases that the TPU runs one after another run
// here side by side on all SMs, one persistent cooperative launch (one
// 256-thread block an SM), five grid barriers a layer:
//   1. QKV: items of (256-column tile, K split) over wq | wk | wv; the last
//      item of a tile to arrive (a counter per tile) sums the K splits in a
//      fixed order and adds the scale and bias.
//   2. attention: items of (sequence, head group, context split); the split
//      that holds slot pos applies RoPE and writes (or quantizes) the slot;
//      the split's K/V rows (and INT8 scales) stream through a shared-
//      memory ring, 32 or 64 cache slots a ring slot; each item leaves
//      its (max, sum, unnormalised output) per query head,
//      and the last split of a (sequence, KV head) to arrive combines them in
//      order into bf16(attn).
//   3. out-projection: items of (tile, K split) over wo; the tile's last
//      item adds into x32.
//   4. MLP: one intermediate chunk of ic columns an item (about one chunk an
//      SM): up and gate over all H rows, the activation, then the chunk's
//      rows of w_down, leaving a partial [B, H] for the chunk.
//   5. the chunks' partials summed in chunk order into x32 (+ b_down).
// MoE: in phase 4 every MLP block first routes all B rows itself (a warp a
// row, from the normed rows it stages anyway; B x H x E is 8 x 4096 x 8 at
// Mixtral, 64 KB of router weights): the same code and summation order in
// every block give every block the same comb, bit for bit, with no extra
// grid barrier. An item is still one intermediate chunk: it walks the chunk
// over all E experts in expert order, adding comb[b, e] x each expert's down
// product into the chunk's one partial, so the partials stay km x B x H (at
// Mixtral 128 x 8 x 4096 fp32, 16.8 MB, within L2; one partial an (expert,
// chunk) pair would be 58.7 MB) and phase 5 is unchanged. Every expert is
// streamed, picked by a row or not (an unpicked one adds 0 x its product),
// as the TPU kernel streams them.
// Every GEMV streams its weight slab (rows of whole tiles, up and gate side
// by side, the chunk's w_down rows) straight into registers: each thread
// loads its columns of a row with one streaming load and keeps 8 rows in
// flight, the activations of a run of rows staged once in shared memory, two
// block barriers a run. Each thread keeps MB batch rows x CPT columns of
// fp32 sums (B <= 8: 8 x 8, B <= 16: 16 x 4, B <= 32: 32 x 2) and the row
// groups are summed in a fixed order, so two runs give the same bits; no
// float atomics. Attention streams its K/V rows through an 11-slot
// shared-memory ring of 16 KB slots filled by cp.async. The INT8 cache's
// current token is quantized as K4 quantizes it (rintf of a true division).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): PERF.md §5-6. A
// design that streamed the GEMV slabs through the ring (16-byte cp.async, or
// one bulk copy a row segment) drew about 8 GB/s an SM.
//
// Limits: bf16 activations; B <= 32; H <= 8192; head dim 64 or 128 (template
// instances); 1..8 query heads a KV head; E <= 16 experts; H and I multiples of 16; ic a
// multiple of 16, at most 256 and with the chunk's up and gate columns at
// most 256 x CPT. The
// wrapper raises on anything else. GEMVs use CUDA-core FMAs (wgmma is later
// work).
//
// Sources. This header holds the kernel; decode_tiled_bf16.cu,
// decode_tiled_int8.cu and decode_tiled_fp8.cu each define
// MLIO_TILED_FMT (the weights' format: 0 bf16, 1 int8, 2 fp8 e4m3) and
// include it, so that the three libraries build in parallel, each with its
// format's GEMV instances only.
#pragma once

#ifndef MLIO_TILED_FMT
#error "define MLIO_TILED_FMT (0 bf16, 1 int8, 2 fp8) before including decode_tiled.cuh"
#endif

#include "common.cuh"
#include "grid.cuh"
#include "widen.cuh"

#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 11;            // attention's K/V ring slots: 160 KB in flight a block
constexpr int kStageBytes = 16384;     // one slot
constexpr int kTile = 256;             // QKV and out-projection columns an item
constexpr int kMaxG = 8;               // query heads a KV head
constexpr int kMaxB = 32;
constexpr int kActStageFloats = 4096;  // attention's buffers follow the ring in this region
constexpr int kMaxActBytes = 32768;    // an MLP item's [ic][MB] fp32 activations
// The GEMV phases' shared memory (the ring's, unused outside attention): the
// row groups' sums (64 KB), a run of staged activations, the MLP item's.
constexpr int kRedFloats = kThreads * 64;
constexpr int kActFloats = 24576;      // 96 KB
constexpr int kMlpActOffset = (kRedFloats + kActFloats) * 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kItemRows = 256;         // choose_ks's cost of an item's start, in weight rows
constexpr int kMaxChunk = 256;         // intermediate columns an MLP item, at most
constexpr int kMaxE = 16;              // experts: the router's register array
// The MoE routing weights comb [kMaxB][kMaxE] after the MLP item's activations.
constexpr int kCombOffset = kMlpActOffset + kMaxActBytes;
static_assert(kCombOffset + kMaxB * kMaxE * 4 <=
                  kRingBytes + kActStageFloats * 4 + kMaxActBytes,
              "comb fits the dynamic shared memory");

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
  int B, H, Hq, Hkv, D, I, L, Smax, pos, rope_dim, rmsnorm, activation, wfmt, ka, ic, splits,
      ks_qkv, ks_o, nblocks, smem, E, top_k;
  float eps, scale;
};

namespace {

__host__ __device__ inline size_t up64(size_t x) { return (x + 63) / 64 * 64; }

// Offsets, in floats, of the global workspace, and the GEMV tiles.
struct Plan {
  int W;           // Qd + 2 KVd: a row of the qkv buffer
  int tq[3], Tq;   // QKV tiles of wq, wk, wv
  int To;          // out-projection tiles
  int km;          // intermediate chunks
  int att_stride;  // floats of one attention split: m[G], l[G], acc[G][D]
  size_t xres, qkv, att, attn, part, total;
  int counters;    // tile counters (QKV, out-projection); B * Hkv attention counters follow
};

__host__ __device__ inline Plan make_plan(const TiledParams& p) {
  Plan pl;
  const int G = p.Hq / p.Hkv, Qd = p.Hq * p.D, KVd = p.Hkv * p.D;
  pl.W = Qd + 2 * KVd;
  pl.tq[0] = (Qd + kTile - 1) / kTile;
  pl.tq[1] = pl.tq[2] = (KVd + kTile - 1) / kTile;
  pl.Tq = pl.tq[0] + pl.tq[1] + pl.tq[2];
  pl.To = (p.H + kTile - 1) / kTile;
  pl.km = (p.I + p.ic - 1) / p.ic;
  pl.att_stride = 2 * G + G * p.D;
  const size_t B = p.B;
  size_t part = static_cast<size_t>(pl.Tq) * p.ks_qkv * B * kTile;
  const size_t po = static_cast<size_t>(pl.To) * p.ks_o * B * kTile;
  const size_t pm = static_cast<size_t>(pl.km) * B * p.H;
  part = part > po ? part : po;
  part = part > pm ? part : pm;
  size_t off = 0;
  pl.xres = off; off += up64(B * p.H);
  pl.qkv = off; off += up64(B * pl.W);
  pl.att = off; off += up64(B * p.Hkv * p.splits * static_cast<size_t>(pl.att_stride));
  pl.attn = off; off += up64(B * Qd);
  pl.part = off; off += up64(part);
  pl.total = off;
  pl.counters = pl.Tq > pl.To ? pl.Tq : pl.To;
  return pl;
}

// ---- weight loads into registers: widen.cuh (fp8x2, word, unpack_w, WRaw) ----

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

// A weight slab: `rows` rows of `bytes` bytes (a multiple of 16, 16-byte
// aligned), row r at base + r * ld.
struct Seg {
  const unsigned char* base;
  size_t ld;
  int bytes;
};

// Activation sources of stream_gemv: fill<MB>(r0, nr, dst) writes the
// activations of rows r0 .. r0 + nr - 1 as [nr][MB] fp32 (zero past B) into
// shared memory, once for a run of rows. SmemAct: activations already in
// shared memory as [rows][MB].

// bf16(norm(x32)) of the residual rows k0 + r.
struct NormAct {
  const float *x, *mu, *rstd;
  const bf16 *sc, *bi;
  int H, B, k0;
  template <int MB>
  __device__ __forceinline__ void fill(int r0, int nr, float* dst) const {
    for (int e = threadIdx.x; e < nr * MB; e += kThreads) {
      const int r = e / MB, b = e - r * MB, k = k0 + r0 + r;
      float v = 0.f;
      if (b < B) {
        v = (__ldcg(x + static_cast<size_t>(b) * H + k) - mu[b]) * rstd[b] * to_f32(sc[k]);
        if (bi != nullptr) v += to_f32(bi[k]);
        v = round_to<bf16>(v);
      }
      dst[e] = v;
    }
  }
};

// Elements k0 + r of the rows of a [B][ld] fp32 buffer written earlier in
// the launch.
struct BufAct {
  const float* buf;
  int ld, B, k0;
  template <int MB>
  __device__ __forceinline__ void fill(int r0, int nr, float* dst) const {
    for (int e = threadIdx.x; e < nr * MB; e += kThreads) {
      const int r = e / MB, b = e - r * MB;
      dst[e] = b < B ? __ldcg(buf + static_cast<size_t>(b) * ld + k0 + r0 + r) : 0.f;
    }
  }
};

struct SmemAct {
  const float* act;  // [rows][MB]
};

constexpr int kInFlight = 8;  // weight rows a thread has in flight

// sum_r act[r][b] * W[r][c] over the rows of one or two slabs side by side
// (ncols columns of format FMT in all): returns the sums as [MB][ncols] fp32
// in `red` (valid until the next call), b < MB. Thread t takes column group
// t % ncg (CPT columns, one register load a row) and rows t / ncg, + nrg,
// ..., loading its weights straight into registers with kInFlight rows in
// flight (a streaming load: the weights are read once); the activations of
// up to kActFloats / MB rows at a time are staged in `actbuf`, so a run of
// rows costs two block barriers. The row groups are summed in order at the
// end.
template <int MB, int CPT, int FMT, class Act>
__device__ __forceinline__ const float* stream_gemv(const Seg (&seg)[2], int nseg, int rows,
                                                    int ncols, float* actbuf, float* red,
                                                    const Act& act) {
  using Raw = typename WRaw<FMT, CPT>::T;
  constexpr int isz = FMT == 0 ? 2 : 1;
  constexpr bool kDirect = std::is_same<Act, SmemAct>::value;
  const int ncg = ncols / CPT, nrg = kThreads / ncg;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const int cb = cg * CPT * isz;  // this thread's byte offset in the concatenated row
  const int sg = (nseg > 1 && cb >= seg[0].bytes) ? 1 : 0;
  const unsigned char* wb = seg[sg].base + (sg ? cb - seg[0].bytes : cb);
  const size_t ld = seg[sg].ld;
  const int run = kDirect ? rows : kActFloats / MB;
  if constexpr (kDirect) __syncthreads();  // the activations are visible to the block

  float acc[MB][CPT];
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[b][i] = 0.f;

  auto fma_row = [&](const Raw& raw, const float* ar) {
    float w[CPT];
    unpack_w<FMT, CPT>(raw, w);
#pragma unroll
    for (int b = 0; b < MB; b += 4) {
      const float4 av = *reinterpret_cast<const float4*>(ar + b);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        acc[b][i] = fmaf(av.x, w[i], acc[b][i]);
        acc[b + 1][i] = fmaf(av.y, w[i], acc[b + 1][i]);
        acc[b + 2][i] = fmaf(av.z, w[i], acc[b + 2][i]);
        acc[b + 3][i] = fmaf(av.w, w[i], acc[b + 3][i]);
      }
    }
  };

  for (int r0 = 0; r0 < rows; r0 += run) {
    const int nr = min(run, rows - r0);
    const float* a;
    if constexpr (kDirect) {
      a = act.act;
    } else {
      __syncthreads();  // earlier users of actbuf are done
      act.template fill<MB>(r0, nr, actbuf);
      __syncthreads();
      a = actbuf;
    }
    if (rg < nrg) {
      const unsigned char* wr = wb + static_cast<size_t>(r0) * ld;
      int r = rg;
      for (; r + (kInFlight - 1) * nrg < nr; r += kInFlight * nrg) {
        Raw raw[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
          raw[u] = __ldcs(reinterpret_cast<const Raw*>(wr + static_cast<size_t>(r + u * nrg) * ld));
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) fma_row(raw[u], a + (r + u * nrg) * MB);
      }
      for (; r < nr; r += nrg)
        fma_row(__ldcs(reinterpret_cast<const Raw*>(wr + static_cast<size_t>(r) * ld)),
                a + r * MB);
    }
  }
  __syncthreads();  // red may alias what the block read
  if (rg < nrg) {
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int i = 0; i < CPT; ++i) red[(rg * MB + b) * ncols + cg * CPT + i] = acc[b][i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < MB * ncols; o += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < nrg; ++g) sum += red[g * MB * ncols + o];
    red[o] = sum;  // row group 0's slot: no other thread reads it
  }
  __syncthreads();
  return red;
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
      s_mu[r] = mu;
      s_rstd[r] = rsqrtf(sq / p.H + p.eps);
    }
  }
  __syncthreads();
}

// The K-split count of a phase: the fewest rows a block streams, counting
// kItemRows of overhead an item.
__host__ inline int choose_ks(int T, int K, int nb) {
  int best = 1;
  long long best_cost = -1;
  for (int ks = 1; ks <= 64 && (ks == 1 || K / ks >= 16); ++ks) {
    const long long waves = (static_cast<long long>(T) * ks + nb - 1) / nb;
    const long long cost = waves * ((K + ks - 1) / ks + kItemRows);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = ks;
    }
  }
  return best;
}

// The K splits that rows of K / ks rounded up to a multiple of 8 (the
// kernel's KC) leave non-empty.
__host__ inline int whole_splits(int K, int ks) {
  const int kc = ((K + ks - 1) / ks + 7) / 8 * 8;
  return (K + kc - 1) / kc;
}

// ---- 1. QKV ------------------------------------------------------------------

template <int MB, int CPT, int FMT>
__device__ __noinline__ void qkv_phase(const TiledParams& p, const Plan& pl, int l,
                                       unsigned char* ring, float* s_mu, float* s_rstd) {
  constexpr int isz = FMT == 0 ? 2 : 1;
  __shared__ int s_last;
  const int H = p.H, Qd = p.Hq * p.D, KVd = p.Hkv * p.D;
  const int KS = p.ks_qkv, KC = ((H + KS - 1) / KS + 7) / 8 * 8, items = pl.Tq * KS;
  if (static_cast<int>(blockIdx.x) >= items) return;
  float* xres = p.work + pl.xres;
  float* part = p.work + pl.part;
  unsigned* ctr = p.sync + 2;
  float* red = reinterpret_cast<float*>(ring);
  float* actbuf = red + kRedFloats;
  const bf16* sc = p.ln1_scale + static_cast<size_t>(l) * H;
  const bf16* bi = p.ln1_bias != nullptr && !p.rmsnorm ? p.ln1_bias + static_cast<size_t>(l) * H
                                                       : nullptr;
  row_stats(p, xres, s_mu, s_rstd);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int t = it / KS, j = it % KS;
    int m = 0, tt = t;
    while (tt >= pl.tq[m]) tt -= pl.tq[m++];
    const int N = m == 0 ? Qd : KVd;
    const int col0 = tt * kTile, width = min(kTile, N - col0);
    const int k0 = j * KC, kn = min(KC, H - k0);
    const void* w = m == 0 ? p.wq : (m == 1 ? p.wk : p.wv);
    const Seg seg[2] = {
        {static_cast<const unsigned char*>(w) +
             (static_cast<size_t>(l) * H * N + static_cast<size_t>(k0) * N + col0) * isz,
         static_cast<size_t>(N) * isz, width * isz},
        {nullptr, 0, 0}};
    const NormAct act{xres, s_mu, s_rstd, sc, bi, H, p.B, k0};
    const float* res = stream_gemv<MB, CPT, FMT>(seg, 1, kn, width, actbuf, red, act);
    float* P = part + static_cast<size_t>(it) * p.B * kTile;
    for (int o = threadIdx.x; o < p.B * width; o += kThreads) {
      const int b = o / width, c = o - b * width;
      __stcg(P + b * kTile + c, res[b * width + c]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const bool last = atomicAdd(ctr + t, 1u) == static_cast<unsigned>(KS - 1);
      if (last) atomicExch(ctr + t, 0u);
      s_last = last;
    }
    __syncthreads();
    if (!s_last) continue;
    // The tile's last item: the K splits in order, the scale, the bias.
    __threadfence();
    const float* wsc = m == 0 ? p.sq : (m == 1 ? p.sk : p.sv);
    const bf16* bias = m == 0 ? p.bq : (m == 1 ? p.bk : p.bv);
    const int off = m == 0 ? 0 : (m == 1 ? Qd : Qd + KVd);
    float* qkv = p.work + pl.qkv;
    for (int o = threadIdx.x; o < p.B * width; o += kThreads) {
      const int b = o / width, c = o - b * width, col = col0 + c;
      float s = 0.f;
      for (int jj = 0; jj < KS; ++jj)
        s += __ldcg(part + (static_cast<size_t>(t * KS + jj) * p.B + b) * kTile + c);
      if (FMT != 0) s *= wsc[static_cast<size_t>(l) * N + col];
      if (bias != nullptr) s += to_f32(bias[static_cast<size_t>(l) * N + col]);
      __stcg(qkv + static_cast<size_t>(b) * pl.W + off + col, s);
    }
  }
}

// ---- 3. out-projection -----------------------------------------------------

template <int MB, int CPT, int FMT>
__device__ __noinline__ void o_phase(const TiledParams& p, const Plan& pl, int l,
                                     unsigned char* ring) {
  constexpr int isz = FMT == 0 ? 2 : 1;
  __shared__ int s_last;
  const int H = p.H, Qd = p.Hq * p.D;
  const int KS = p.ks_o, KC = ((Qd + KS - 1) / KS + 7) / 8 * 8, items = pl.To * KS;
  if (static_cast<int>(blockIdx.x) >= items) return;
  float* xres = p.work + pl.xres;
  float* part = p.work + pl.part;
  const float* attn = p.work + pl.attn;
  unsigned* ctr = p.sync + 2;
  float* red = reinterpret_cast<float*>(ring);
  float* actbuf = red + kRedFloats;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int t = it / KS, j = it % KS;
    const int col0 = t * kTile, width = min(kTile, H - col0);
    const int k0 = j * KC, kn = min(KC, Qd - k0);
    const Seg seg[2] = {
        {static_cast<const unsigned char*>(p.wo) +
             (static_cast<size_t>(l) * Qd * H + static_cast<size_t>(k0) * H + col0) * isz,
         static_cast<size_t>(H) * isz, width * isz},
        {nullptr, 0, 0}};
    const BufAct act{attn, Qd, p.B, k0};
    const float* res = stream_gemv<MB, CPT, FMT>(seg, 1, kn, width, actbuf, red, act);
    float* P = part + static_cast<size_t>(it) * p.B * kTile;
    for (int o = threadIdx.x; o < p.B * width; o += kThreads) {
      const int b = o / width, c = o - b * width;
      __stcg(P + b * kTile + c, res[b * width + c]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const bool last = atomicAdd(ctr + t, 1u) == static_cast<unsigned>(KS - 1);
      if (last) atomicExch(ctr + t, 0u);
      s_last = last;
    }
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    for (int o = threadIdx.x; o < p.B * width; o += kThreads) {
      const int b = o / width, c = o - b * width, col = col0 + c;
      float s = 0.f;
      for (int jj = 0; jj < KS; ++jj)
        s += __ldcg(part + (static_cast<size_t>(t * KS + jj) * p.B + b) * kTile + c);
      if (FMT != 0) s *= p.so[static_cast<size_t>(l) * H + col];
      if (p.bo != nullptr) s += to_f32(p.bo[static_cast<size_t>(l) * H + col]);
      float* xp = xres + static_cast<size_t>(b) * H + col;
      __stcg(xp, __ldcg(xp) + s);
    }
  }
}

// ---- 4. MLP by intermediate chunk ------------------------------------------

// The MoE router of layer l for every row: fp32 logits hn @ router[l], hn =
// bf16(norm2(x32)) formed as NormAct forms it; p = exp(logits - max) / sum;
// the top_k of p by repeated max, the lowest index on ties; comb [B][kMaxE]
// in shared memory = p at the picks / their sum, 0 elsewhere. A warp a row,
// one lane the softmax and top-k; every block that calls it computes the same
// bits (one code path, a fixed summation order: each lane's strided sum, then
// the warp's xor butterfly). Block 0 writes p to router_probs when it is set.
__device__ __noinline__ void moe_route(const TiledParams& p, int l, const float* xres,
                                       const float* s_mu, const float* s_rstd, const bf16* sc,
                                       const bf16* bi, float* comb) {
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
  }
  __syncthreads();
}

template <int MB, int CPT, int FMT>
__device__ __noinline__ void mlp_phase(const TiledParams& p, const Plan& pl, int l,
                                       unsigned char* ring, float* s_mu, float* s_rstd) {
  constexpr int isz = FMT == 0 ? 2 : 1;
  const int H = p.H, I = p.I, ic = p.ic;
  if (static_cast<int>(blockIdx.x) >= pl.km) return;
  const bool gated = p.activation >= 4, moe = p.E > 0;
  const int E = moe ? p.E : 1;  // a dense MLP is one "expert"
  float* xres = p.work + pl.xres;
  float* part = p.work + pl.part;
  float* red = reinterpret_cast<float*>(ring);
  float* actbuf = red + kRedFloats;
  float* act = reinterpret_cast<float*>(ring + kMlpActOffset);  // [ic][MB]
  float* comb = reinterpret_cast<float*>(ring + kCombOffset);   // [kMaxB][kMaxE]
  const bf16* sc = p.ln2_scale + static_cast<size_t>(l) * H;
  const bf16* bi = p.ln2_bias != nullptr && !p.rmsnorm ? p.ln2_bias + static_cast<size_t>(l) * H
                                                       : nullptr;
  row_stats(p, xres, s_mu, s_rstd);
  if (moe) moe_route(p, l, xres, s_mu, s_rstd, sc, bi, comb);
  for (int kk = blockIdx.x; kk < pl.km; kk += gridDim.x) {
    const int c0 = kk * ic, icw = min(ic, I - c0);
    const int ncols = gated ? 2 * icw : icw;
    float* P = part + static_cast<size_t>(kk) * p.B * H;
    for (int e = 0; e < E; ++e) {
      const size_t le = static_cast<size_t>(l) * E + e;  // the (layer, expert) matrix
      const size_t lw = le * H * I;                       // its first up / down element
      const Seg up[2] = {
          {static_cast<const unsigned char*>(p.w_up) + (lw + c0) * isz,
           static_cast<size_t>(I) * isz, icw * isz},
          {gated ? static_cast<const unsigned char*>(p.w_gate) + (lw + c0) * isz : nullptr,
           static_cast<size_t>(I) * isz, icw * isz}};
      const NormAct nact{xres, s_mu, s_rstd, sc, bi, H, p.B, 0};
      const float* res = stream_gemv<MB, CPT, FMT>(up, gated ? 2 : 1, H, ncols, actbuf, red,
                                                   nact);
      for (int o = threadIdx.x; o < MB * icw; o += kThreads) {
        const int b = o / icw, c = o - b * icw;
        const size_t col = le * I + c0 + c;                        // scales
        const size_t bcol = static_cast<size_t>(l) * I + c0 + c;  // biases (dense only)
        float v = 0.f;
        if (b < p.B) {
          float u = res[b * ncols + c];
          if (FMT != 0) u *= p.s_up[col];
          if (p.b_up != nullptr) u += to_f32(p.b_up[bcol]);
          float g = 0.f;
          if (gated) {
            g = res[b * ncols + icw + c];
            if (FMT != 0) g *= p.s_gate[col];
            if (p.b_gate != nullptr) g += to_f32(p.b_gate[bcol]);
          }
          v = round_to<bf16>(activate(p.activation, u, g));
        }
        act[c * MB + b] = v;
      }
      // the chunk's rows of w_down, in passes of kThreads * CPT columns; an
      // expert after the first adds comb x its product to the partial
      for (int h0 = 0; h0 < H; h0 += kThreads * CPT) {
        const int w = min(kThreads * CPT, H - h0);
        const Seg down[2] = {
            {static_cast<const unsigned char*>(p.w_down) +
                 (lw + static_cast<size_t>(c0) * H + h0) * isz,
             static_cast<size_t>(H) * isz, w * isz},
            {nullptr, 0, 0}};
        const float* dres = stream_gemv<MB, CPT, FMT>(down, 1, icw, w, actbuf, red,
                                                      SmemAct{act});
        for (int o = threadIdx.x; o < p.B * w; o += kThreads) {
          const int b = o / w, c = o - b * w;
          float* dst = P + static_cast<size_t>(b) * H + h0 + c;
          float d = dres[b * w + c];
          if (FMT != 0) d *= p.s_down[le * H + h0 + c];
          if (moe) {
            d *= comb[b * kMaxE + e];
            if (e > 0) d += __ldcg(dst);
          }
          __stcg(dst, d);
        }
      }
    }
  }
}

// ---- 5. the chunks' sum ----------------------------------------------------

__device__ void reduce_phase(const TiledParams& p, const Plan& pl, int l) {
  float* xres = p.work + pl.xres;
  const float* part = p.work + pl.part;
  const size_t n = static_cast<size_t>(p.B) * p.H;
  const bool last = l == p.L - 1;
  for (size_t e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int kk = 0; kk < pl.km; ++kk) s += __ldcg(part + kk * n + e);
    float x = __ldcg(xres + e) + s;
    if (p.b_down != nullptr) x += to_f32(p.b_down[static_cast<size_t>(l) * p.H + e % p.H]);
    __stcg(xres + e, x);
    if (last) p.x_out[e] = from_f32<bf16>(x);
  }
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

// Items of (sequence b, head group g, context split s): for each KV head of
// the group, the G query heads (RoPE, x scale, bf16) and, in the split that
// holds slot pos, the slot's K/V (RoPE on K; written as bf16 or quantized);
// then an online fp32 softmax over the split's slots, D / 8 lanes a slot and
// 8 elements a lane (K3's layout), and the split's (max, sum, unnormalised
// output) of each query head.
template <int D, bool kQ>
__device__ __noinline__ void attention_phase(const TiledParams& p, const Plan& pl, int layer,
                                             unsigned char* ring) {
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
  float* s_raw = reinterpret_cast<float*>(ring + kRingBytes);  // [kMaxG + 2][D]: q, k, v
  float* s_q = s_raw + (kMaxG + 2) * D;            // [kMaxG][D]
  float* sm_m = s_q + kMaxG * D;                   // [kWarps][kMaxG]
  float* sm_l = sm_m + kWarps * kMaxG;             // [kWarps][kMaxG]
  float* sm_acc = sm_l + kWarps * kMaxG;           // [kWarps][kMaxG][D]
  float* s_kv = sm_acc + kWarps * kMaxG * D;       // [2][D]: the INT8 cache's k, v
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
      if (kQ && cur) {
        __syncthreads();
        quantize_slot<D>(p, s_kv, slot);
      }
      if (cur) __threadfence();  // the slot just written, before the ring reads it
      __syncthreads();  // the slot just written is visible to the whole block

      float qf[kMaxG][V], m[kMaxG], l[kMaxG], acc[kMaxG][V];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
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
      auto issue = [&](int sl) {
        if (sl < nsl) {
          unsigned char* dst = ring + (sl % kStages) * kStageBytes;
          const int j0 = sl * kTok, nt = min(kTok, cnt - j0);
          constexpr int cpr = 2 * kRow / 16;  // 16-byte copies a slot's K and V rows
          for (int c = threadIdx.x; c < nt * cpr; c += kThreads) {
            const int j = c / cpr, q = c - j * cpr, kv = q / (cpr / 2), o = (q % (cpr / 2)) * 16;
            const size_t off = static_cast<size_t>(t0 + j0 + j) * KVd;
            cp_async16(dst + (2 * j + kv) * kRow + o,
                       reinterpret_cast<const unsigned char*>((kv ? vb : kb) + off) + o);
          }
          if constexpr (kQ) {
            float* sd = reinterpret_cast<float*>(dst + kTok * 2 * kRow);
            for (int c = threadIdx.x; c < 2 * nt; c += kThreads) {
              const int j = c / 2, kv = c - 2 * j;
              const size_t si = (rowb + static_cast<size_t>(t0 + j0 + j) * KVd) / D + hk;
              cp_async4(sd + c, (kv ? p.v_scale : p.k_scale) + si);
            }
          }
        }
        cp_async_commit();
      };
      for (int sl = 0; sl < kStages - 1; ++sl) issue(sl);
      for (int sl = 0; sl < nsl; ++sl) {
        issue(sl + kStages - 1);
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
          for (int g = 0; g < kMaxG; ++g) {
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
      for (int g = 0; g < kMaxG; ++g) {
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
          for (int i = 0; i < V; ++i) sm_acc[(warp * kMaxG + g) * D + sub * V + i] = acc[g][i];
          if (sub == 0) {
            sm_m[warp * kMaxG + g] = mw;
            sm_l[warp * kMaxG + g] = lw;
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
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kMaxG + g]);
        float lt = 0.f, o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = (sm_m[w * kMaxG + g] == -INFINITY) ? 0.f : expf(sm_m[w * kMaxG + g] - mx);
          lt += sm_l[w * kMaxG + g] * f;
          o += sm_acc[(w * kMaxG + g) * D + d] * f;
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

#define MLIO_TIERS(fn, ...)                                  \
  switch (tier) {                                            \
    case 0: fn<8, 8, MLIO_TILED_FMT>(__VA_ARGS__); break;    \
    case 1: fn<16, 4, MLIO_TILED_FMT>(__VA_ARGS__); break;   \
    default: fn<32, 2, MLIO_TILED_FMT>(__VA_ARGS__); break;  \
  }

template <int D, bool kQ>
__global__ void __launch_bounds__(kThreads, 1) tiled_kernel(const __grid_constant__ TiledParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_mu[kMaxB], s_rstd[kMaxB];
  unsigned char* ring = smem;
  const Plan pl = make_plan(p);
  float* xres = p.work + pl.xres;
  const int tier = p.B <= 8 ? 0 : (p.B <= 16 ? 1 : 2);
  int ns = 0;
  stamp(p, ns);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.B * p.H; e += gridDim.x * kThreads)
    __stcg(xres + e, to_f32(p.x[e]));
  sync_phase(p, ns);
  for (int l = 0; l < p.L; ++l) {
    MLIO_TIERS(qkv_phase, p, pl, l, ring, s_mu, s_rstd);
    sync_phase(p, ns);
    attention_phase<D, kQ>(p, pl, l, ring);
    sync_phase(p, ns);
    MLIO_TIERS(o_phase, p, pl, l, ring);
    sync_phase(p, ns);
    MLIO_TIERS(mlp_phase, p, pl, l, ring, s_mu, s_rstd);
    sync_phase(p, ns);
    reduce_phase(p, pl, l);
    sync_phase(p, ns);
  }
}

const void* pick(int D, bool q) {
  if (D == 64) return q ? reinterpret_cast<const void*>(tiled_kernel<64, true>)
                        : reinterpret_cast<const void*>(tiled_kernel<64, false>);
  if (D == 128) return q ? reinterpret_cast<const void*>(tiled_kernel<128, true>)
                         : reinterpret_cast<const void*>(tiled_kernel<128, false>);
  return nullptr;
}

}  // namespace

// Fills p->nblocks (the blocks resident at once), p->smem, the context
// splits and the K splits, and returns the workspace sizes the wrapper
// allocates: work (fp32 elements) and sync (int32 elements, zeroed: the
// barrier and the tile counters).
extern "C" int mlio_decode_tiled_plan(TiledParams* p, long long* work_floats, int* sync_ints) {
  const void* k = pick(p->D, p->k_scale != nullptr);
  const int G = p->Hkv > 0 ? p->Hq / p->Hkv : 0;
  if (k == nullptr || p->B < 1 || p->B > kMaxB || G < 1 || G > kMaxG || p->Hq % p->Hkv ||
      p->ka < 1 || p->Hkv % p->ka || p->ic < 16 || p->ic % 16 || p->H % 16 || p->I % 16 ||
      p->pos < 0 || p->pos >= p->Smax || p->wfmt != MLIO_TILED_FMT || p->E < 0 || p->E > kMaxE ||
      (p->E > 0 && (p->top_k < 1 || p->top_k > p->E || p->router == nullptr)))
    return cudaErrorInvalidValue;
  const int mb = p->B <= 8 ? 8 : (p->B <= 16 ? 16 : 32), cpt = 64 / mb;
  const bool gated = p->activation >= 4;
  if (p->ic > kMaxChunk || (gated ? 2 : 1) * p->ic > kThreads * cpt) return cudaErrorInvalidValue;
  if (p->ic * mb * static_cast<int>(sizeof(float)) > kMaxActBytes) return cudaErrorInvalidValue;
  // the ring, a slot's activations and an MLP item's (attention's buffers
  // reuse the last two)
  const int smem = kRingBytes + kActStageFloats * static_cast<int>(sizeof(float)) + kMaxActBytes;
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
  const Plan pre = [&] { TiledParams q = *p; q.ks_qkv = q.ks_o = 1; return make_plan(q); }();
  p->ks_qkv = whole_splits(p->H, choose_ks(pre.Tq, p->H, nb));
  p->ks_o = whole_splits(p->Hq * p->D, choose_ks(pre.To, p->Hq * p->D, nb));
  const Plan pl = make_plan(*p);
  *work_floats = static_cast<long long>(pl.total);
  *sync_ints = 2 + pl.counters + p->B * p->Hkv;
  return cudaSuccess;
}

// One cooperative launch on the given stream; a refused launch returns its error.
extern "C" int mlio_decode_tiled(const TiledParams* p, void* stream) {
  const void* k = pick(p->D, p->k_scale != nullptr);
  if (k == nullptr) return cudaErrorInvalidValue;
  void* args[] = {const_cast<TiledParams*>(p)};
  const cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(p->nblocks), dim3(kThreads), args,
                                                    p->smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
