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
// The function, its bound and the cache policies are described in
// decode_layer.cu and paged_stack.cu.
//
// Design. One persistent cooperative launch, one block an SM, each block a
// producer warp and eight consumer warps.
//   - The weight stream runs ahead of the dependency chain. At launch the
//     plan (make_plan, mirrored by ops/decode_layer.py::stack_plan) fixes
//     every block's weight units in order: for every step, every layer, the
//     four GEMV phases (QKV, out-projection, up [and gate], down). A unit is
//     one 128-byte-wide column box of a weight (64 bf16 or 128 int8
//     columns) by KB rows (128, 64 or 32: the largest that still gives every
//     block units in the phase), 128-byte swizzled. The producer warp issues
//     each unit by TMA into a ring of up to kMaxSlots 16 KB slots as soon as
//     the consumers free a slot, whatever the consumers wait for: across
//     phase, layer and step boundaries. The ring owns its shared memory; the
//     consumers' buffers (activations, attention, the epilogue) lie after it
//     and never alias a slot.
//   - The products run on the tensor cores: mma.sync m16n8k16 with the
//     weight tile as the 16-row operand (ldmatrix.trans from the swizzled
//     box; int8 widened exactly to bf16 by widen.cuh's frag_pair) and the
//     <= 8 batch rows as n, fp32 accumulators. Warps 0-3 take the first half
//     of a unit's rows, warps 4-7 the second; the halves are added in that
//     order. Scales, biases, the activation and the residual come after the
//     sum, in the JAX kernel's order.
//   - The split: a phase's units, (tile, k rows) in order, are cut into one
//     equal run a block (every SM streams the same bytes at every width). A
//     run's units of one tile form a segment, which leaves an fp32 partial
//     [columns][8] in slot (block + tile) of the phase's partial buffer; the
//     segment that brings its tile's (gated up: its column pair's) arrivals
//     to the total sums the partials in block order, which is k order, and
//     applies the epilogue: two runs give the same bits. The split stays in
//     global memory. The card takes the cooperative launch with a cluster
//     dimension that a sum inside a cluster needs (stack_cluster_probe;
//     chip_smoke.py records how many blocks each cluster size keeps), but
//     that sum is not built: at GPT-2 small's out-projection a tile's
//     K-chunks span 11 (bf16) or 22 (int8) blocks when every SM has units.
//   - One GEMV function serves all four phases and both formats (a runtime
//     kind): the code a phase runs once is what paces it at GPT-2's widths
//     (unrolled staging of 8 units, or 8 partials a sum, made whole phases
//     30-50 % slower on an H100; the once-a-phase helpers as separate
//     functions, 8 % slower).
//   - The norms' row statistics come from the sums that wrote the residual:
//     each out or down sum leaves its tile's (mean, M2) of every row, merged
//     by the next norm in a fixed order (Chan et al.); a step's input is
//     read whole.
//   - No grid barrier between phases: each consumer waits only on the
//     producers of what it reads, through monotonic readiness counters in
//     the zeroed sync buffer (red.release.gpu after a block barrier,
//     ld.acquire.gpu, bounded: a wait of 2 s traps rather than hangs):
//       QKV (layer l)      the whole down phase of layer l - 1 (norm of the
//                          full residual rows), or the step's input;
//       attention (b, hk)  the QKV column tiles of hk's q, k and v columns;
//       out K-chunk        attention of its heads for every sequence;
//       up                 the whole out phase (norm of full rows);
//       down K-chunk       the up column tiles of its rows;
//       logits             the whole down phase of the last layer;
//       token              every block's (max, first index).
//     Every writer of a buffer reaches it only through a chain of waits that
//     passes every reader of its previous contents (the CPU tests walk that
//     graph: tests/test_torch_decode_stack_plan.py).
//   - The epilogue's head streams through the same ring onto the tensor
//     cores (its first units issued while the last layer runs), a block a
//     run of whole vocabulary tiles; the (max, first index) merge is a fixed
//     order.
//   - Attention: one item per (sequence, KV head) with K4's rounding, each
//     cut over its context into as many splits as keep the items within the
//     blocks (attention_split: K8's longest sequence no longer paces the
//     phase); the last split of an item to arrive merges the splits' (max,
//     sum, output) in split order.
//
// INT8 weights (bit i of p.wfmt set: projection i, in the order wq, wk, wv,
// wo, w_up, w_gate, w_down, is int8 with per-column fp32 scales; each
// matrix has its own format, a gated up's two the same): one byte an
// element, the same 128-byte boxes (128 columns), the column's fp32 scale
// on the finished sum before the bias, as the JAX kernel's _mm.
#pragma once

#include <string.h>

#include "common.cuh"
#include "grid.cuh"
#include "tma.cuh"
#include "widen.cuh"

#include <limits.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                 // consumer threads: eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = kThreads + 32;  // and the producer warp
constexpr int kMaxB = 8;                      // batch rows: one mma n-tile
constexpr int kBox = 128;                     // bytes of a unit row (one TMA box, swizzled)
constexpr int kSlotBytes = 16384;             // a ring slot: a unit of at most kMaxKB rows
constexpr int kMaxKB = kSlotBytes / kBox;     // 128
constexpr int kMinKB = 32;                    // two halves of one k-step each
constexpr int kMaxSlots = 13;
constexpr int kActUnits = 2;                  // units whose activations are staged at once
constexpr int kActRow = kMaxKB + 8;           // a staged bf16 row: fragments free of bank conflicts
constexpr int kUnroll = 4;                    // attention token steps in flight
constexpr int kSumAhead = 4;                  // partials a sum loads at once
constexpr int kMaxSegs = 2 * 160;             // a group's segments (two tiles of a gated up)
constexpr int kSmemLimit = 232448;            // 227 KB a block
constexpr int kAlign = 1024;                  // the 128-byte swizzle's period
constexpr int kStaticSmem = 4096;             // the kernel's static shared memory, at most

}  // namespace

// Mirror of mlio_tpu_torch/ops/decode_layer.py::_Params. K4 leaves the
// paged fields (tables, ctx, bs, max_blocks, num_blocks) unset; K8 leaves
// pos, Smax and pos_embed unset and runs one step.
struct StackParams {
  const bf16* x;
  bf16* x_out;
  void* k_cache;  // Cache::Elem; K8: the k pool
  void* v_cache;  // Cache::Elem; K8: the v pool
  // weights: bf16, or int8 (its wfmt bit set) with its scale sq .. s_down below
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
  unsigned long long* stamps;  // optional: block 0's %globaltimer at the start and each wait
  const int* tables;  // K8: [B, max_blocks] block tables
  const int* ctx;     // K8: [B] past tokens of each sequence
  float* logits;      // optional with the epilogue: the fp32 [B, V] logits
  // int8 weights' per-output-channel scales [L, out]
  const float *sq, *sk, *sv, *so, *s_up, *s_gate, *s_down;
  float *k_scale, *v_scale;  // INT8 cache: [L, B, Smax, Hkv] scales
  int B, H, Hq, Hkv, D, I, L, Smax, pos, steps, rope_dim, rmsnorm, activation, epilogue,
      lm_vmajor, V, nblocks, smem, bs, max_blocks, num_blocks;
  int wfmt;        // bit i: weight i (wq, wk, wv, wo, w_up, w_gate, w_down) is int8
  int slots;       // ring slots (the plan fills it)
  int hold_block;  // a check's probe: this block spins hold_ns before each wait (0: none)
  int hold_ns;
  int lm_ld;       // the untied [H, V] head's row stride (elements, a multiple of 8)
  float eps, scale, embed_scale;
};

// The weights' tensor maps, in the order wq, wk, wv, wo, w_up, w_gate,
// w_down, lm_head (mlio_*_stack_maps).
struct StackMaps {
  CUtensorMap w[8];
};

namespace {

enum Kind { kQkv = 0, kOut = 1, kUp = 2, kDown = 3 };

// ---- the plan (mirrored by ops/decode_layer.py::stack_plan) ------------------

// One GEMV phase: nm matrices side by side as column tiles (QKV: wq, wk, wv;
// a gated up: w_up, w_gate), matrix m's tiles tcm[m] columns (128 bytes: 64
// bf16 or 128 int8, its format fm[m]), nk units of KB rows over the K rows;
// a tile's partial takes tc (the widest tcm) columns. Sum groups: a tile, or
// (gated up) the column pair (c, c + ct[0]).
struct PhaseShape {
  int K, KB, nk, ntiles, tc, nm, groups;
  int N[3], ct[3], t0[3], map[3], fm[3], tcm[3];
  int arrive, done;  // counter offsets in the sync buffer: [groups] each
  long long part;    // float offset of the partials in the workspace
};

// The epilogue's head: vocabulary tiles of 128 rows of the tied [V, H]
// table (units of 64 of its H columns) or 64 columns of the untied [H, V]
// head (units of 128 of its H rows); a block takes whole tiles, an equal run.
struct HeadShape {
  int tied, tiles, nk;
};

struct Plan {
  PhaseShape ph[4];
  HeadShape head;
  long long xres, qkv, attn, act, att, emax, eidx, total;
  long long stat[2];  // the residual's per-tile row statistics after out (0) and down (1)
  int stat_ld;        // their row stride: the larger phase's tiles
  int att_stride;  // floats of an attention split's partial: m[G], l[G], o[G][D]
  int phase_done, attn_done, att_arrive, init_done, logits_done, token_done, counters;
};

__host__ __device__ inline long long up64(long long x) { return (x + 63) / 64 * 64; }

__host__ __device__ inline int col_tiles(int N, int tc) { return (N + tc - 1) / tc; }

// Block b of nb streams units [unit_begin(b), unit_begin(b + 1)) of the U
// units of a phase; unit_owner(u) is the block whose run holds unit u. 32-bit:
// the plan function refuses a phase whose U * nb does not fit.
__host__ __device__ inline int unit_begin(int U, int nb, int b) {
  return static_cast<int>(static_cast<unsigned>(U) * b / nb);
}
__host__ __device__ inline int unit_owner(int U, int nb, int u) {
  return static_cast<int>((static_cast<unsigned>(u + 1) * nb + U - 1) / U) - 1;
}
__host__ __device__ inline bool has_units(int U, int nb, int b) {
  return unit_begin(U, nb, b) < unit_begin(U, nb, b + 1);
}
// The matrix of tile i.
__host__ __device__ inline int tile_matrix(const PhaseShape& s, int i) {
  return s.nm > 2 && i >= s.t0[2] ? 2 : (s.nm > 1 && i >= s.t0[1] ? 1 : 0);
}

__host__ __device__ inline PhaseShape make_phase(int kind, int H, int Qd, int KVd, int I,
                                                 bool gated, int wfmt, int nb) {
  PhaseShape s{};
  if (kind == kQkv) {
    s.K = H;
    s.nm = 3;
    s.N[0] = Qd; s.N[1] = KVd; s.N[2] = KVd;
    s.map[0] = 0; s.map[1] = 1; s.map[2] = 2;
  } else if (kind == kOut) {
    s.K = Qd;
    s.nm = 1;
    s.N[0] = H;
    s.map[0] = 3;
  } else if (kind == kUp) {
    s.K = H;
    s.nm = gated ? 2 : 1;
    s.N[0] = I; s.N[1] = I;
    s.map[0] = 4; s.map[1] = 5;
  } else {
    s.K = I;
    s.nm = 1;
    s.N[0] = H;
    s.map[0] = 6;
  }
  s.ntiles = 0;
  s.tc = 0;
  for (int m = 0; m < s.nm; ++m) {
    s.fm[m] = (wfmt >> s.map[m]) & 1;
    s.tcm[m] = s.fm[m] ? kBox : kBox / 2;
    s.tc = s.tc > s.tcm[m] ? s.tc : s.tcm[m];
    s.ct[m] = col_tiles(s.N[m], s.tcm[m]);
    s.t0[m] = s.ntiles;
    s.ntiles += s.ct[m];
  }
  s.groups = kind == kUp && gated ? s.ct[0] : s.ntiles;
  // the largest unit that still gives every block units
  s.KB = kMaxKB;
  while (s.KB > kMinKB && s.ntiles * ((s.K + s.KB - 1) / s.KB) < nb) s.KB /= 2;
  s.nk = (s.K + s.KB - 1) / s.KB;
  return s;
}

__host__ __device__ inline Plan make_plan(const StackParams& p, int nb) {
  Plan pl{};
  const int Qd = p.Hq * p.D, KVd = p.Hkv * p.D;
  const bool gated = p.activation >= 4;
  long long off = 0;
  pl.xres = off; off += up64(static_cast<long long>(kMaxB) * p.H);
  pl.qkv = off; off += up64(static_cast<long long>(kMaxB) * (Qd + 2 * KVd));
  pl.attn = off; off += up64(static_cast<long long>(kMaxB) * Qd);
  pl.act = off; off += up64(static_cast<long long>(kMaxB) * p.I);
  int ctr = 0;
  for (int k = kQkv; k <= kDown; ++k) {
    PhaseShape& s = pl.ph[k];
    s = make_phase(k, p.H, Qd, KVd, p.I, gated, p.wfmt, nb);
    s.part = off;
    off += up64(static_cast<long long>(nb + s.ntiles) * s.tc * kMaxB);
    s.arrive = ctr; ctr += s.groups;
    s.done = ctr; ctr += s.groups;
  }
  if (p.epilogue) {
    pl.head.tied = p.lm_vmajor;
    pl.head.tiles = p.lm_vmajor ? (p.V + kMaxKB - 1) / kMaxKB : (p.V + 63) / 64;
    pl.head.nk = p.lm_vmajor ? (p.H + 63) / 64 : (p.H + kMaxKB - 1) / kMaxKB;
  }
  // attention's split partials: at most nb + B * Hkv splits (attention_split)
  const int G = p.Hkv > 0 ? p.Hq / p.Hkv : 1;
  pl.att_stride = 2 * G + G * p.D;
  pl.att = off; off += up64(static_cast<long long>(nb + kMaxB * p.Hkv) * pl.att_stride);
  pl.stat_ld = pl.ph[kOut].ntiles > pl.ph[kDown].ntiles ? pl.ph[kOut].ntiles : pl.ph[kDown].ntiles;
  for (int i = 0; i < 2; ++i) {  // [kMaxB][stat_ld] (mean, M2)
    pl.stat[i] = off;
    off += up64(static_cast<long long>(kMaxB) * pl.stat_ld * 2);
  }
  pl.emax = off; off += up64(static_cast<long long>(nb) * kMaxB);
  pl.eidx = off; off += up64(static_cast<long long>(nb) * kMaxB);
  pl.total = off;
  pl.phase_done = ctr; ctr += 4;
  pl.attn_done = ctr; ctr += p.Hkv;
  pl.att_arrive = ctr; ctr += kMaxB * p.Hkv;
  pl.init_done = ctr++;
  pl.logits_done = ctr++;
  pl.token_done = ctr++;
  pl.counters = ctr;
  return pl;
}

// The epilogue's row of normed bf16 activations: H rounded up to whole units
// (zeros past H) and 8 more, free of bank conflicts.
__host__ __device__ inline int head_row(int H) { return (H + kMaxKB - 1) / kMaxKB * kMaxKB + 8; }

// Shared memory the consumers own (after the ring): the largest of the GEMV
// phases' staged activations and half-sums, attention's buffers and the
// epilogue's normed rows and partial maxima.
__host__ __device__ inline int consumer_bytes(const StackParams& p, int G) {
  const long long gemv = static_cast<long long>(kActUnits) * kMaxB * kActRow * 2 + 4 * 32 * 8 * 4;
  const long long att =
      ((G + 2) * p.D + G * p.D + 2 * kWarps * G + kWarps * G * p.D + 2 * p.D) * 4LL;
  const long long epi = p.epilogue ? up64(kMaxB * static_cast<long long>(head_row(p.H)) * 2) +
                                         4 * 32 * 8 * 4 + kWarps * kMaxB * 8
                                   : 0;
  long long m = gemv > att ? gemv : att;
  m = m > epi ? m : epi;
  return static_cast<int>(up64(m));
}

// ---- the waits on part of a phase (the card's plan check exports them) -----------

// The counters a segment (tile, units [u0, u1)) of an out or down phase waits
// on before its units: out, the attention counters of the KV heads whose
// output columns its k rows are; down, the done counters of the up column
// groups its k rows are. Returns the first counter; *n their count (0 for
// QKV and up, whose waits are on the whole phase before).
__host__ __device__ inline int segment_wait(const StackParams& p, const Plan& pl, int kind,
                                            int tile, int u0, int u1, int* n) {
  const PhaseShape& ph = pl.ph[kind];
  const int k_lo = (u0 - tile * ph.nk) * ph.KB;
  const int k_end = (u1 - tile * ph.nk) * ph.KB, k_hi = (k_end < ph.K ? k_end : ph.K) - 1;
  if (kind == kOut) {
    const int gd = (p.Hq / p.Hkv) * p.D, h0 = k_lo / gd;
    *n = k_hi / gd - h0 + 1;
    return pl.attn_done + h0;
  }
  if (kind == kDown) {
    const PhaseShape& up = pl.ph[kUp];
    const int c0 = k_lo / up.tcm[0];
    *n = k_hi / up.tcm[0] - c0 + 1;
    return up.done + c0;
  }
  *n = 0;
  return 0;
}

// The counters an attention item of KV head hk waits on: the done counters
// of the QKV column tiles of its G query heads', its k and its v columns,
// three ranges (o[i], n[i]).
__host__ __device__ inline void attention_wait(const StackParams& p, const Plan& pl, int hk,
                                               int* o, int* n) {
  const PhaseShape& pq = pl.ph[kQkv];
  const int G = p.Hq / p.Hkv, D = p.D;
  const int q0 = hk * G * D / pq.tcm[0], q1 = ((hk + 1) * G * D - 1) / pq.tcm[0];
  const int k0 = hk * D / pq.tcm[1], k1 = ((hk + 1) * D - 1) / pq.tcm[1];
  const int v0 = hk * D / pq.tcm[2], v1 = ((hk + 1) * D - 1) / pq.tcm[2];
  o[0] = pq.done + q0;
  n[0] = q1 - q0 + 1;
  o[1] = pq.done + pq.t0[1] + k0;
  n[1] = k1 - k0 + 1;
  o[2] = pq.done + pq.t0[2] + v0;
  n[2] = v1 - v0 + 1;
}

// ---- device helpers -------------------------------------------------------------

// The consumers' barrier (named barrier 1, eight warps): the producer warp
// never joins it.
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// (m2, i2) beats (m1, i1): a larger logit, or the same logit at a smaller
// index, so any merge order yields the first index of the maximum.
__device__ __forceinline__ bool better(float m2, int i2, float m1, int i1) {
  return m2 > m1 || (m2 == m1 && i2 < i1);
}

// What the consumers keep in static shared memory.
struct Shared {
  Plan plan;
  float mu[kMaxB], rstd[kMaxB];
  int ns;    // stamps written
  int last;  // this segment's arrival completes its group
  int tok[kMaxB];
  int nseg, nup;           // the group's segments, those of w_up (a gated up)
  // attention's split of the step (attention_split): the split's slots, each
  // sequence's slots to attend, splits and first item
  int att_c, att_items, att_n[kMaxB], att_ns[kMaxB], att_off[kMaxB];
  float tred[kWarps][kMaxB];  // a sum's row statistics, by warp
  int segs[kMaxSegs];      // their partial slots in summation (k) order
};

// Phase timing (optional): block 0 stamps the global timer (ns) at the
// start and after each wait, so stamp differences are phase durations.
__device__ __forceinline__ void stamp(const StackParams& p, Shared& sh) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int n = 2 + p.steps * 5 * p.L + (p.epilogue ? 2 * p.steps - 1 : 0);
    if (p.stamps != nullptr && sh.ns < n) p.stamps[sh.ns] = tma::now_ns();
    ++sh.ns;
  }
}

// Spin until *c reaches target (thread-local); 2 s means a producer that
// never comes, so the launch fails rather than hang the card.
__device__ __forceinline__ void spin_until(const unsigned* c, unsigned target) {
  if (static_cast<int>(ld_acquire(c) - target) >= 0) return;
  const uint64_t start = tma::now_ns();
  for (int spins = 1;; ++spins) {
    if (static_cast<int>(ld_acquire(c) - target) >= 0) return;
    if ((spins & 255) == 0 && tma::now_ns() - start > 2000000000ull) __trap();
  }
}

// Wait until every counter of up to three ranges [o, o + n) reaches target,
// one thread a counter; then the consumers' barrier. The held-back block of
// a check spins hold_ns first.
__device__ void wait_for(const StackParams& p, int o0, int n0, int o1, int n1, int o2, int n2,
                         unsigned target) {
  if (p.hold_ns > 0 && static_cast<int>(blockIdx.x) == p.hold_block && threadIdx.x == 0) {
    const uint64_t start = tma::now_ns();
    while (tma::now_ns() - start < static_cast<uint64_t>(p.hold_ns)) {
    }
  }
  const int n = n0 + n1 + n2;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i < n0 ? o0 + i : (i < n0 + n1 ? o1 + i - n0 : o2 + i - n0 - n1);
    spin_until(p.sync + c, target);
  }
  csync();
}
__device__ __forceinline__ void wait_one(const StackParams& p, int o, unsigned target) {
  wait_for(p, o, 1, 0, 0, 0, 0, target);
}
// After the consumers' writes: one arrival on each counter (thread 0).
__device__ __forceinline__ void release(const StackParams& p, int c0, int c1 = -1) {
  csync();
  if (threadIdx.x == 0) {
    red_release(p.sync + c0, 1u);
    if (c1 >= 0) red_release(p.sync + c1, 1u);
  }
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
      s_mu[warp] = mu;
      s_rstd[warp] = rsqrtf(sq / p.H + p.eps);
    }
  }
  csync();
}

// (n, mean, M2) of a set of values merged with another's (Chan et al.): a
// fixed order of merges gives the same bits.
__device__ __forceinline__ void merge_stats(float& n, float& mean, float& m2, float n2,
                                            float mean2, float m22) {
  const float t = n + n2;
  if (t == 0.f) return;
  const float d = mean2 - mean, r = __frcp_rn(t);  // no division's slow path
  mean += d * (n2 * r);
  m2 += m22 + d * d * (n * n2 * r);
  n = t;
}

// The norm's statistics of each residual row from the per-tile (mean, M2)
// the last sums of the residual left (stat [kMaxB][ld], the nt tiles of tc
// columns of phase `kind`, out or down): a warp a row, each lane merging its
// tiles in order, then the lanes pairwise, the lower lane's first; RMSNorm's
// means are 0.
__device__ void tile_stats(const StackParams& p, const Plan& pl, int kind, float* s_mu,
                           float* s_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = pl.ph[kind].ntiles, tc = pl.ph[kind].tcm[0];
  if (warp < p.B) {
    const float* row = p.work + pl.stat[kind == kOut ? 0 : 1] + static_cast<size_t>(warp) * pl.stat_ld * 2;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int i = lane; i < nt; i += 32) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(row + 2 * i));
      merge_stats(n, mean, m2, static_cast<float>(min(tc, p.H - i * tc)), v.x, v.y);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      float n2 = __shfl_xor_sync(0xffffffffu, n, o), mean2 = __shfl_xor_sync(0xffffffffu, mean, o);
      float m22 = __shfl_xor_sync(0xffffffffu, m2, o);
      if (lane & o) {  // the partner is the lower lane: its state first
        merge_stats(n2, mean2, m22, n, mean, m2);
        n = n2;
        mean = mean2;
        m2 = m22;
      } else {
        merge_stats(n, mean, m2, n2, mean2, m22);
      }
    }
    if (lane == 0) {
      s_mu[warp] = p.rmsnorm ? 0.f : mean;
      s_rstd[warp] = rsqrtf(m2 / p.H + p.eps);
    }
  }
  csync();
}

__device__ __forceinline__ float normed(const StackParams& p, float x, float mu, float rstd,
                                        const bf16* scale, const bf16* bias, int k) {
  float y = (x - mu) * rstd * to_f32(scale[k]);
  if (!p.rmsnorm && bias != nullptr) y += to_f32(bias[k]);
  return y;
}

// ---- the weight stream (the producer warp) ---------------------------------------

// Lane 0 of the producer warp: every unit of the launch in the consumers'
// order, each into ring slot i % S once its previous unit's readers have
// left it (the slot's empty barrier), its bytes counted on the full one.
__device__ __noinline__ void produce(const StackParams& p, const StackMaps& maps, const Plan& pl,
                                     unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const int nb = gridDim.x, S = p.slots;
  unsigned i = 0;
  auto issue = [&](const CUtensorMap* map, int c, int r, int bytes) {
    const unsigned q = i % S;
    if (i >= static_cast<unsigned>(S)) tma::bar_wait_bounded(&empty[q], ((i / S) - 1) & 1u);
    tma::bar_expect(&full[q], static_cast<uint32_t>(bytes));
    tma::load_2d(ring + q * kSlotBytes, map, c, r, &full[q]);
    ++i;
  };
  for (int s = 0; s < p.steps; ++s) {
    for (int l = 0; l < p.L; ++l)
      for (int k = kQkv; k <= kDown; ++k) {
        const PhaseShape& ph = pl.ph[k];
        const int U = ph.ntiles * ph.nk;
        const int u1 = unit_begin(U, nb, blockIdx.x + 1);
        for (int u = unit_begin(U, nb, blockIdx.x); u < u1; ++u) {
          const int tile = u / ph.nk, kc = u - tile * ph.nk, m = tile_matrix(ph, tile);
          issue(&maps.w[ph.map[m]], (tile - ph.t0[m]) * ph.tcm[m], l * ph.K + kc * ph.KB,
                ph.KB * kBox);
        }
      }
    if (!p.epilogue) continue;
    const HeadShape& hd = pl.head;  // the head's tiles, whole, after the last layer
    const int t1 = unit_begin(hd.tiles, nb, blockIdx.x + 1);
    for (int vt = unit_begin(hd.tiles, nb, blockIdx.x); vt < t1; ++vt)
      for (int kc = 0; kc < hd.nk; ++kc)
        issue(&maps.w[7], hd.tied ? kc * 64 : vt * 64, hd.tied ? vt * kMaxKB : kc * kMaxKB,
              kSlotBytes);
  }
}

// ---- a GEMV phase (the consumers) ------------------------------------------------

// ldmatrix (not transposed) from a shared-memory address: the tied head's
// rows as mma16816's A operand.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two bf16 (the low half first) widened to fp32.
__device__ __forceinline__ float2 bf16x2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// The activations of n units of one tile, from k row k0, into the staged
// bf16 rows act[j][b][kActRow] (zeros past B and K): bf16(norm) of the fp32
// residual (kQkv, kUp), the attention output (kOut) or the activation
// (kDown), these two bf16 values already. One pass of loads for all of them.
__device__ __forceinline__ void stage(const StackParams& p, const Plan& pl, const PhaseShape& ph,
                                      int kind, int l, int k0, int n, bf16* act,
                                      const float* s_mu, const float* s_rstd) {
  const bool kNorm = kind == kQkv || kind == kUp;
  const int KB = ph.KB, K = ph.K, per = KB / 4;
  const int sper = __ffs(per) - 1, sunit = sper + 3;  // KB is a power of two, kMaxB 8
  const int ld = kind == kOut ? p.Hq * p.D : (kind == kDown ? p.I : p.H);
  const float* src = p.work + (kind == kOut ? pl.attn : (kind == kDown ? pl.act : pl.xres));
  const bf16* sc = kNorm ? (kind == kQkv ? p.ln1_scale : p.ln2_scale) + static_cast<size_t>(l) * p.H
                         : nullptr;
  const bf16* bi = kind == kQkv ? p.ln1_bias : p.ln2_bias;
  if (bi != nullptr) bi += static_cast<size_t>(l) * p.H;
  const int total = n << sunit;
  float4 v[kActUnits];
  uint2 s4[kActUnits], b4[kActUnits];
#pragma unroll
  for (int r = 0; r < kActUnits; ++r) {
    const int e = threadIdx.x + r * kThreads;
    v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    s4[r] = b4[r] = make_uint2(0, 0);
    if (e < total) {
      const int j = e >> sunit, b = (e >> sper) & (kMaxB - 1), k = k0 + j * KB + (e & (per - 1)) * 4;
      if (b < p.B && k < K) {
        v[r] = __ldcg(reinterpret_cast<const float4*>(src + static_cast<size_t>(b) * ld + k));
        if (kNorm) {
          s4[r] = __ldg(reinterpret_cast<const uint2*>(sc + k));
          if (!p.rmsnorm && bi != nullptr) b4[r] = __ldg(reinterpret_cast<const uint2*>(bi + k));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kActUnits; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (e < total) {
      const int j = e >> sunit, b = (e >> sper) & (kMaxB - 1), kk = (e & (per - 1)) * 4;
      float4 x = v[r];
      if (kNorm && b < p.B && k0 + j * KB + kk < K) {
        const float mu = s_mu[b], rs = s_rstd[b];
        const float2 s0 = bf16x2(s4[r].x), s1 = bf16x2(s4[r].y);
        const float2 c0 = bf16x2(b4[r].x), c1 = bf16x2(b4[r].y);
        x.x = (x.x - mu) * rs * s0.x + c0.x;
        x.y = (x.y - mu) * rs * s0.y + c0.y;
        x.z = (x.z - mu) * rs * s1.x + c1.x;
        x.w = (x.w - mu) * rs * s1.y + c1.y;
      }
      *reinterpret_cast<uint2*>(act + (j * kMaxB + b) * kActRow + kk) =
          make_uint2(gemm::pack_bf16(x.x, x.y), gemm::pack_bf16(x.z, x.w));
    }
  }
}

// The products of one unit in ring slot address st (this lane's ldmatrix
// address in the slot) against its staged activations actj: this warp's
// 16 (bf16) or 32 (int8) columns over its half of the unit's rows.
__device__ __forceinline__ void unit_products(float (&acc)[2][4], uint32_t st, const bf16* actj,
                                              int ld, int rows, int KB, int kh, int g, int t,
                                              int fmt) {
  const int half = KB / 2, mine = min(half, rows - kh * half);
  const int nks = mine > 0 ? (mine + 15) / 16 : 0;
  for (int s = 0; s < nks; ++s) {
    const int kr = kh * half + 16 * s;
    const bf16* row = actj + g * ld + kr + 2 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + 8);
    uint32_t r[4];
    gemm::ldmatrix_x4_trans(r, st + kr * kBox);
    if (fmt == 0) {
      gemm::mma16816(acc[0], r, b0, b1);
    } else {
      const uint32_t a0[4] = {frag_pair<1, 0>(r[0]), frag_pair<1, 0>(r[1]),
                              frag_pair<1, 0>(r[2]), frag_pair<1, 0>(r[3])};
      const uint32_t a1[4] = {frag_pair<1, 1>(r[0]), frag_pair<1, 1>(r[1]),
                              frag_pair<1, 1>(r[2]), frag_pair<1, 1>(r[3])};
      gemm::mma16816(acc[0], a0, b0, b1);
      gemm::mma16816(acc[1], a1, b0, b1);
    }
  }
}

// Warp 0: the partial slots (block + tile) of group gi's segments, in
// summation order (a gated up: w_up's tile, then w_gate's; each in block,
// that is k, order) into sh.segs, their count into sh.nseg.
__device__ void group_segments(const PhaseShape& ph, int gi, Shared& sh) {
  const int lane = threadIdx.x % 32, nb = gridDim.x, U = ph.ntiles * ph.nk;
  const bool pair = ph.groups != ph.ntiles;
  int n = 0;
  for (int side = 0; side < (pair ? 2 : 1); ++side) {
    const int tile = gi + side * ph.ct[0];
    const int first = unit_owner(U, nb, tile * ph.nk), last = unit_owner(U, nb, (tile + 1) * ph.nk - 1);
    for (int b0 = first; b0 <= last; b0 += 32) {
      const int b = b0 + lane;
      const bool seg = b <= last && has_units(U, nb, b);
      const unsigned m = __ballot_sync(0xffffffffu, seg);
      if (seg && n + __popc(m & ((1u << lane) - 1)) < kMaxSegs)
        sh.segs[n + __popc(m & ((1u << lane) - 1))] = b + tile;
      n += __popc(m);
    }
    if (side == 0 && lane == 0) sh.nup = n;
  }
  if (lane == 0) sh.nseg = n < kMaxSegs ? n : kMaxSegs;
}

// The sum of group gi, whose arrivals are complete: each output (column c of
// the tile, batch row b) adds the group's partials in block order (k order;
// a gated up: w_up's and w_gate's apart), then the scale, bias, activation
// or residual. Four outputs a thread, their loads of one partial together.
__device__ void finish_group(const StackParams& p, const Plan& pl, const PhaseShape& ph,
                             int kind, int l, int gi, Shared& sh) {
  const bool pair = ph.groups != ph.ntiles;
  const float* part = p.work + ph.part;
  const int m = tile_matrix(ph, gi), fmt = ph.fm[m], TC = ph.tcm[m];
  const int col0 = (gi - ph.t0[m]) * TC, N = ph.N[m];
  const int nseg = sh.nseg;
  constexpr int O = kMaxKB * kMaxB / kThreads;  // outputs a thread: int8's tile (col, row) / 256
  constexpr int kAhead = kSumAhead;
  float su[O], sg[O];
#pragma unroll
  for (int q = 0; q < O; ++q) su[q] = sg[q] = 0.f;
  for (int i0 = 0; i0 < nseg; i0 += kAhead) {  // kAhead partials' loads in flight
    float v[kAhead][O];
    int slot[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      slot[j] = i0 + j < nseg ? sh.segs[i0 + j] : -1;
      const float* P = part + static_cast<size_t>(slot[j]) * ph.tc * kMaxB;
#pragma unroll
      for (int q = 0; q < O; ++q) {
        const int o = threadIdx.x + q * kThreads;
        v[j][q] = slot[j] >= 0 && o < TC * kMaxB ? __ldcg(P + o) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (slot[j] < 0) break;
      const bool gate = pair && i0 + j >= sh.nup;  // w_gate's segments follow w_up's
#pragma unroll
      for (int q = 0; q < O; ++q) (gate ? sg[q] : su[q]) += v[j][q];
    }
  }

  const int Qd = p.Hq * p.D, KVd = p.Hkv * p.D, W = Qd + 2 * KVd, H = p.H;
  float* xres = p.work + pl.xres;
  float xs[O];  // out, down: the new residual of each output (0 past the tile)
#pragma unroll
  for (int q = 0; q < O; ++q) {
    const int o = threadIdx.x + q * kThreads, c = o / kMaxB, b = o % kMaxB, col = col0 + c;
    xs[q] = 0.f;
    if (c >= TC || col >= N || b >= p.B) continue;
    float v = su[q];
    if (kind == kQkv) {
      const float* ws = m == 0 ? p.sq : (m == 1 ? p.sk : p.sv);
      const bf16* bias = m == 0 ? p.bq : (m == 1 ? p.bk : p.bv);
      if (fmt) v *= ws[static_cast<size_t>(l) * N + col];
      if (bias != nullptr) v += to_f32(bias[static_cast<size_t>(l) * N + col]);
      __stcg(p.work + pl.qkv + static_cast<size_t>(b) * W + (m == 0 ? 0 : (m == 1 ? Qd : Qd + KVd)) + col, v);
    } else if (kind == kOut) {
      if (fmt) v *= p.so[static_cast<size_t>(l) * H + col];
      if (p.bo != nullptr) v += to_f32(p.bo[static_cast<size_t>(l) * H + col]);
      float* xp = xres + static_cast<size_t>(b) * H + col;
      xs[q] = __ldcg(xp) + v;
      __stcg(xp, xs[q]);
    } else if (kind == kUp) {
      const size_t at = static_cast<size_t>(l) * p.I + col;
      float g = 0.f;
      if (fmt) v *= p.s_up[at];
      if (p.b_up != nullptr) v += to_f32(p.b_up[at]);
      if (pair) {
        g = sg[q];
        if (fmt) g *= p.s_gate[at];
        if (p.b_gate != nullptr) g += to_f32(p.b_gate[at]);
      }
      __stcg(p.work + pl.act + static_cast<size_t>(b) * p.I + col,
             round_to<bf16>(activate(p.activation, v, g)));
    } else {
      if (fmt) v *= p.s_down[static_cast<size_t>(l) * H + col];
      float* xp = xres + static_cast<size_t>(b) * H + col;
      float x = __ldcg(xp) + (v + (p.b_down != nullptr ? to_f32(p.b_down[static_cast<size_t>(l) * H + col]) : 0.f));
      __stcg(xp, x);
      xs[q] = x;
      if (l == p.L - 1) p.x_out[static_cast<size_t>(b) * H + col] = from_f32<bf16>(x);
    }
  }
  if (kind == kOut || kind == kDown) {
    // the tile's (mean, M2) of each row of the new residual (RMSNorm: mean
    // 0, M2 the sum of squares), for the next norm: a row's outputs are
    // those of lanes b, b + 8, b + 16, b + 24 of every warp
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, b = lane % kMaxB;
    const float n = static_cast<float>(min(TC, N - col0));
    float t1 = 0.f;
#pragma unroll
    for (int q = 0; q < O; ++q) t1 += xs[q];
    t1 += __shfl_xor_sync(0xffffffffu, t1, 8);
    t1 += __shfl_xor_sync(0xffffffffu, t1, 16);
    if (lane < kMaxB) sh.tred[warp][lane] = t1;
    csync();
    float mean = 0.f;
    if (!p.rmsnorm) {
      for (int w = 0; w < kWarps; ++w) mean += sh.tred[w][b];
      mean /= n;
    }
    csync();
    float t2 = 0.f;
#pragma unroll
    for (int q = 0; q < O; ++q) {
      const int o = threadIdx.x + q * kThreads, c = o / kMaxB;
      const float d = xs[q] - mean;
      if (c < TC && col0 + c < N) t2 += d * d;
    }
    t2 += __shfl_xor_sync(0xffffffffu, t2, 8);
    t2 += __shfl_xor_sync(0xffffffffu, t2, 16);
    if (lane < kMaxB) sh.tred[warp][lane] = t2;
    csync();
    if (threadIdx.x < p.B) {
      float m2 = 0.f;
      for (int w = 0; w < kWarps; ++w) m2 += sh.tred[w][threadIdx.x];
      __stcg(reinterpret_cast<float2*>(p.work + pl.stat[kind == kOut ? 0 : 1]) +
                 static_cast<size_t>(threadIdx.x) * pl.stat_ld + gi,
             make_float2(mean, m2));
    }
  }
}

// One GEMV phase of iteration it (step * L + layer l): this block's run of
// units, a segment (one tile's units) at a time. An out or down segment
// first waits on the producers of its k rows (block 0 stamps after its
// first wait); the activations of up to kActUnits units are staged at once;
// each unit's weights are waited for in the ring (slot seq % S) and its slot
// freed once the warps have read it. At a segment's end the two halves are
// added, the partial goes out, and the segment that completes its group sums
// it. Returns the ring position after the phase.
__device__ __noinline__ unsigned gemv_phase(const StackParams& p, Shared& sh, int kind, int l,
                                            int it, unsigned char* ring, uint64_t* full,
                                            uint64_t* empty, unsigned char* cons, unsigned seq) {
  const Plan& pl = sh.plan;
  const PhaseShape& ph = pl.ph[kind];
  const int nb = gridDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, cg = warp & 3, kh = warp >> 2;
  const int U = ph.ntiles * ph.nk, S = p.slots, KB = ph.KB;
  const int u0 = unit_begin(U, nb, blockIdx.x), u1 = unit_begin(U, nb, blockIdx.x + 1);
  const bool kWaits = kind == kOut || kind == kDown;
  if (u0 == u1) {
    if (kWaits) stamp(p, sh);
    return seq;
  }
  if (kind == kQkv && l == 0) {  // the step's input: whole rows
    row_stats(p, p.work + pl.xres, sh.mu, sh.rstd);
  } else if (kind == kQkv || kind == kUp) {  // from the sums of down (out) that wrote them
    tile_stats(p, pl, kind == kQkv ? kDown : kOut, sh.mu, sh.rstd);
  }
  bf16* act = reinterpret_cast<bf16*>(cons);
  float* red = reinterpret_cast<float*>(cons + kActUnits * kMaxB * kActRow * 2);
  // this lane's ldmatrix.trans address in a slot: rows lane % 8 (+ 8 for
  // matrices 2 and 3) of a k-step, 16-byte chunk 2 cg (+ 1 for matrices 1
  // and 3), swizzled (chunk ^ row % 8)
  const uint32_t loff = ((lane & 7) + 8 * (lane >> 4)) * kBox +
                        (((2 * cg + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
  const uint32_t ring_s = gemm::smem_addr(ring) + loff;
  for (int u = u0; u < u1;) {
    const int tile = u / ph.nk, fmt = ph.fm[tile_matrix(ph, tile)];
    const int send = min(u1, (tile + 1) * ph.nk);
    if (kWaits) {  // out: each attention item releases its head once a sequence
      int n;
      const int o = segment_wait(p, pl, kind, tile, u, send, &n);
      wait_for(p, o, n, 0, 0, 0, 0,
               kind == kOut ? static_cast<unsigned>(it + 1) * p.B : static_cast<unsigned>(it + 1));
      if (u == u0) stamp(p, sh);
    }
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][r] = 0.f;
    for (int c = u; c < send; c += kActUnits) {
      const int n = min(kActUnits, send - c);
      csync();  // the previous chunk's rows are read
      stage(p, pl, ph, kind, l, (c - tile * ph.nk) * KB, n, act, sh.mu, sh.rstd);
      csync();
      for (int j = 0; j < n; ++j, ++seq) {
        const unsigned q = seq % S;
        const int k0 = (c - tile * ph.nk + j) * KB;
        tma::bar_wait_bounded(&full[q], (seq / S) & 1u);
        unit_products(acc, ring_s + q * kSlotBytes, act + j * kMaxB * kActRow, kActRow,
                      min(KB, ph.K - k0), KB, kh, g, t, fmt);
        __syncwarp();
        if (lane == 0) tma::bar_arrive(&empty[q]);
      }
    }
    // the segment's end: warps 4-7 hand their half to warps 0-3, which add
    // it to theirs and write the partial [column][batch row]
    if (kh == 1) {
      float* r = red + (cg * 32 + lane) * 8;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) r[a * 4 + i] = acc[a][i];
    }
    csync();
    if (kh == 0) {
      const float* r = red + (cg * 32 + lane) * 8;
      float* P = p.work + ph.part + static_cast<size_t>(blockIdx.x + tile) * ph.tc * kMaxB;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a == 1 && !fmt) break;  // bf16: one m-tile a warp
        const int col = fmt ? 32 * cg + 2 * g + a : 16 * cg + g;
        float* pr = P + col * kMaxB + 2 * t;
        float* pr8 = pr + (fmt ? 16 : 8) * kMaxB;
        __stcg(reinterpret_cast<float2*>(pr),
               make_float2(acc[a][0] + r[a * 4 + 0], acc[a][1] + r[a * 4 + 1]));
        __stcg(reinterpret_cast<float2*>(pr8),
               make_float2(acc[a][2] + r[a * 4 + 2], acc[a][3] + r[a * 4 + 3]));
      }
    }
    const bool pair = ph.groups != ph.ntiles;
    const int gi = pair && tile >= ph.ct[0] ? tile - ph.ct[0] : tile;
    if (warp == 0) group_segments(ph, gi, sh);
    csync();
    if (tid == 0)
      sh.last = atom_add_acq_rel(p.sync + ph.arrive + gi, 1u) + 1 ==
                static_cast<unsigned>(it + 1) * static_cast<unsigned>(sh.nseg);
    csync();
    if (sh.last) {
      finish_group(p, pl, ph, kind, l, gi, sh);
      release(p, ph.done + gi, pl.phase_done + kind);
    }
    u = send;
  }
  return seq;
}

// ---- 2. attention -----------------------------------------------------------------

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

// Attention's split over nb blocks: sequence b attends over n[b] slots; each
// (sequence, KV head) item is cut into ns[b] = ceil(n[b] / C) splits of C
// slots (a multiple of 128), C the smallest from the slots a block if all
// blocks shared them evenly up for which the splits fit the blocks (or, past
// that, each item whole). Splits are numbered by (sequence, KV head, split)
// from off[b]; block i takes splits i, i + nb, ... Returns the splits in
// all. (The card's plan check calls it on the host: mlio_*_stack_items.)
__host__ __device__ inline int split_contexts(const int* n, int B, int Hkv, int nb, int* ns,
                                              int* off, int* C) {
  long long T = 0;
  int nmax = 1;
  for (int b = 0; b < B; ++b) {
    T += n[b];
    nmax = nmax > n[b] ? nmax : n[b];
  }
  const long long even = (T * Hkv + nb - 1) / nb;
  int c = static_cast<int>((even + 127) / 128 * 128);
  c = c > 128 ? c : 128;
  for (;; c += 128) {
    int items = 0;
    for (int b = 0; b < B; ++b) items += (n[b] + c - 1) / c * Hkv;
    if (items <= nb || c >= nmax) break;
  }
  int o = 0;
  for (int b = 0; b < B; ++b) {
    ns[b] = (n[b] + c - 1) / c;
    off[b] = o;
    o += ns[b] * Hkv;
  }
  *C = c;
  return o;
}

// Attention's split of step s (thread 0, the same in every block).
template <class Cache>
__device__ void attention_split(const StackParams& p, int s, Shared& sh) {
  const int cap = Cache::capacity(p);
  for (int b = 0; b < p.B; ++b) sh.att_n[b] = min(Cache::slot(p, b, s) + 1, cap);
  sh.att_items = split_contexts(sh.att_n, p.B, p.Hkv, gridDim.x, sh.att_ns, sh.att_off, &sh.att_c);
}

// Phase 2 of a layer: RoPE, the cache write of each sequence's slot and
// attention over slots [0, slot], one item per (sequence, KV head) as K3,
// split over the context (attention_split), with K4's rounding. An item
// first waits on the QKV column tiles of its head group's q, k and v columns
// (block 0 stamps after its first wait); the split that holds the current
// slot writes it and reads it back (past slots do not change in the step).
// A whole item writes its output; a split leaves its (max, sum, output)
// partial, and the last split of an item to arrive merges them in split
// order. Either releases the head group's counter. An INT8 cache
// (Cache::kQuant) gets the current token quantized in the kernel and is read
// with its scales fused into the score (K scale) and the probability (V
// scale; l sums the unscaled ones), the probabilities fp32 throughout.
template <int D, int G, class Cache>
__device__ void attention_phase(const StackParams& p, Shared& sh, int layer, int s, int it,
                                unsigned char* smem) {
  using E = typename Cache::Elem;
  constexpr bool kQuant = Cache::kQuant;
  constexpr int V = 8;                // elements a lane holds of a row
  constexpr int LPT = D / V;          // lanes per token row
  constexpr int TPI = 32 / LPT;       // tokens per warp step
  constexpr int STEP = kWarps * TPI;  // tokens per block step
  const Plan& pl = sh.plan;
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
  const float* qkv = p.work + pl.qkv;
  float* attn = p.work + pl.attn;
  const int C = sh.att_c;
  bool first = true;
  for (int idx = blockIdx.x; idx < sh.att_items; idx += gridDim.x) {
    int b = 0;
    while (b + 1 < p.B && sh.att_off[b + 1] <= idx) ++b;
    const int ns = sh.att_ns[b], hk = (idx - sh.att_off[b]) / ns, j = idx - sh.att_off[b] - hk * ns;
    {  // the QKV tiles of this head group's q, k and v columns
      int o[3], n[3];
      attention_wait(p, pl, hk, o, n);
      wait_for(p, o[0], n[0], o[1], n[1], o[2], n[2], it + 1);
      if (first) stamp(p, sh);
      first = false;
    }
    const int slot = Cache::slot(p, b, s), n = min(slot + 1, cap);
    const int t_lo = j * C, t_hi = min(n, t_lo + C);
    const bool writes = j == ns - 1 && slot < cap;  // the split that holds the current slot
    const float* cs = p.cos + Cache::rope_row(b, s) * R;
    const float* sn = p.sin + Cache::rope_row(b, s) * R;
    for (int e = threadIdx.x; e < (G + 2) * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int col = r < G ? (hk * G + r) * D + d : (r == G ? Qd : Qd + KVd) + hk * D + d;
      s_raw[e] = __ldcg(qkv + static_cast<size_t>(b) * W + col);
    }
    csync();
    const size_t cur = slot < cap ? Cache::row(p, layer, b, slot) + hk * D : 0;
    for (int e = threadIdx.x; e < (G + 2) * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float val = s_raw[e];
      if (r <= G && d < R) {
        const float other = d < half ? -s_raw[r * D + d + half] : s_raw[r * D + d - half];
        val = val * cs[d] + other * sn[d];
      }
      if (r < G) s_q[e] = round_to<bf16>(val * p.scale);
      else if (!writes) continue;  // a slot past the table is never written
      else if constexpr (kQuant) s_kv[(r - G) * D + d] = val;
      else (r == G ? k_cache : v_cache)[cur + d] = from_f32<E>(val);
    }
    if (kQuant && writes) {
      csync();
      quantize_current<D>(p, s_kv, cur);
    }
    csync();  // the slot just written is visible to the whole block

    float qf[G][V], m[G], l[G], acc[G][V];
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        qf[gg][i] = s_q[gg * D + sub * V + i];
        acc[gg][i] = 0.f;
      }
      m[gg] = -INFINITY;
      l[gg] = 0.f;
    }
    const E* kp = k_cache + hk * D + sub * V;
    const E* vp = v_cache + hk * D + sub * V;
    // contiguous slots: one base and a stride; paged: the table per slot
    const size_t base = Cache::kPaged ? 0 : Cache::row(p, layer, b, 0);
    for (int t0 = t_lo + warp * TPI; t0 < t_hi; t0 += STEP * kUnroll) {
      Raw8<E> kraw[kUnroll], vraw[kUnroll];
      float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * STEP + grp;
        ksc[u] = vsc[u] = 1.f;
        if (t < t_hi) {
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
        const bool valid = t0 + u * STEP + grp < t_hi;
        float kv[V], vv[V];
        unpack8<E>(kraw[u], kv);
        unpack8<E>(vraw[u], vv);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          float sc = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) sc += qf[gg][i] * kv[i];
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
          if (kQuant) sc *= ksc[u];
          if (valid) {
            const float m_new = fmaxf(m[gg], sc);
            const float alpha = (m[gg] == -INFINITY) ? 0.f : expf(m[gg] - m_new);
            const float pr = expf(sc - m_new);
            l[gg] = l[gg] * alpha + pr;
            // p stays fp32 for PV (the TPU kernel rounds it to bf16 for its
            // MXU; against a running max that rounding is noise of the
            // order of the check's limit, see decode_layer.py)
            const float pv = kQuant ? pr * vsc[u] : pr;
#pragma unroll
            for (int i = 0; i < V; ++i) acc[gg][i] = acc[gg][i] * alpha + pv * vv[i];
            m[gg] = m_new;
          }
        }
      }
    }
    // Merge the lane groups of each warp by shuffles, then the warps.
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      float mw = m[gg];
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
      const float f = (m[gg] == -INFINITY) ? 0.f : expf(m[gg] - mw);
      float lw = l[gg] * f;
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float a = acc[gg][i] * f;
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        acc[gg][i] = a;
      }
      if (grp == 0) {
#pragma unroll
        for (int i = 0; i < V; ++i) sm_acc[(warp * G + gg) * D + sub * V + i] = acc[gg][i];
        if (sub == 0) {
          sm_m[warp * G + gg] = mw;
          sm_l[warp * G + gg] = lw;
        }
      }
    }
    csync();
    float* part = p.work + pl.att + static_cast<size_t>(idx) * pl.att_stride;  // m[G], l[G], o[G][D]
    for (int e = threadIdx.x; e < G * D; e += kThreads) {
      const int gg = e / D, d = e % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + gg]);
      float lt = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = (sm_m[w * G + gg] == -INFINITY) ? 0.f : expf(sm_m[w * G + gg] - mx);
        lt += sm_l[w * G + gg] * f;
        o += sm_acc[(w * G + gg) * D + d] * f;
      }
      if (ns == 1) {
        __stcg(attn + static_cast<size_t>(b) * Qd + (hk * G + gg) * D + d,
               round_to<bf16>(o / (lt == 0.f ? 1.f : lt)));
      } else {
        if (d == 0) {
          __stcg(part + gg, mx);
          __stcg(part + G + gg, lt);
        }
        __stcg(part + 2 * G + e, o);
      }
    }
    if (ns > 1) {  // the last split to arrive merges the item's splits in order
      unsigned* ctr = p.sync + pl.att_arrive + b * p.Hkv + hk;
      csync();
      if (threadIdx.x == 0) {
        sh.last = atom_add_acq_rel(ctr, 1u) + 1 == static_cast<unsigned>(ns);
        if (sh.last) atomicExch(ctr, 0u);  // no split of a later layer arrives before the release
      }
      csync();
      if (!sh.last) continue;
      const float* p0 = p.work + pl.att + static_cast<size_t>(idx - j) * pl.att_stride;
      for (int e = threadIdx.x; e < G * D; e += kThreads) {
        const int gg = e / D;
        float mx = -INFINITY;
        for (int q = 0; q < ns; ++q) mx = fmaxf(mx, __ldcg(p0 + q * pl.att_stride + gg));
        float lt = 0.f, o = 0.f;
        for (int q = 0; q < ns; ++q) {
          const float* pq_ = p0 + q * pl.att_stride;
          const float mq = __ldcg(pq_ + gg);
          const float f = mq == -INFINITY ? 0.f : expf(mq - mx);
          lt += __ldcg(pq_ + G + gg) * f;
          o += __ldcg(pq_ + 2 * G + e) * f;
        }
        __stcg(attn + static_cast<size_t>(b) * Qd + hk * G * D + e,
               round_to<bf16>(o / (lt == 0.f ? 1.f : lt)));
      }
    }
    release(p, pl.attn_done + hk);  // also: this item's buffers are free
  }
  if (first) stamp(p, sh);
}

// Epilogue, first half: the logits of the block's vocabulary tiles on the
// tensor cores, their units taken from the ring as the projections' are, the
// batch as n against bf16(final_norm(x32)) staged [kMaxB][head_row(H)]; each
// block leaves its (max, first index) per batch row (and, where the policy
// emits them, writes the logits). The tied [V, H] table is mma's row-major
// A as it is: a warp takes 16 of a tile's 128 rows over each 64-column unit
// (ldmatrix from the swizzled box). The untied [H, V] head is read as the
// projections' weights: warps 0-3 a 16-column quarter of the tile's 64
// columns over the first half of a unit's 128 rows, warps 4-7 over the
// second, added at the tile's end. Returns the ring position after it.
template <class Cache>
__device__ __noinline__ unsigned logits_phase(const StackParams& p, Shared& sh, unsigned char* ring,
                                              uint64_t* full, uint64_t* empty, unsigned char* cons,
                                              unsigned seq) {
  const Plan& pl = sh.plan;
  const HeadShape& hd = pl.head;
  const int H = p.H, HS = head_row(H), S = p.slots, nb = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int cg = warp & 3, kh = warp >> 2;
  bf16* s_hf = reinterpret_cast<bf16*>(cons);  // [kMaxB][HS]
  float* red = reinterpret_cast<float*>(cons + up64(kMaxB * static_cast<long long>(HS) * 2));
  float* s_bm = red + 4 * 32 * 8;              // [kWarps][kMaxB]
  int* s_bi = reinterpret_cast<int*>(s_bm + kWarps * kMaxB);
  const float* xres = p.work + pl.xres;
  tile_stats(p, pl, kDown, sh.mu, sh.rstd);
  const int Hp = HS - 8;
  for (int e = threadIdx.x; e < kMaxB * Hp; e += kThreads) {
    const int b = e / Hp, h = e - b * Hp;
    s_hf[b * HS + h] = from_f32<bf16>(b < p.B && h < H
        ? normed(p, __ldcg(xres + static_cast<size_t>(b) * H + h), sh.mu[b], sh.rstd[b],
                 p.final_scale, p.final_bias, h)
        : 0.f);
  }
  csync();

  float bm[2] = {-INFINITY, -INFINITY};  // batch rows 2t and 2t + 1
  int bi[2] = {INT_MAX, INT_MAX};
  // tied: this lane's ldmatrix row and chunk parity in a box; untied: K6's
  // ldmatrix.trans address (gemv_phase's)
  const int trow = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t loff = ((lane & 7) + 8 * (lane >> 4)) * kBox +
                        (((2 * cg + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
  const int t1 = unit_begin(hd.tiles, nb, blockIdx.x + 1);
  for (int vt = unit_begin(hd.tiles, nb, blockIdx.x); vt < t1; ++vt) {
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][r] = 0.f;
    for (int kc = 0; kc < hd.nk; ++kc, ++seq) {
      const unsigned q = seq % S;
      tma::bar_wait_bounded(&full[q], (seq / S) & 1u);
      const uint32_t st = gemm::smem_addr(ring + q * kSlotBytes);
      if (hd.tied) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int k = kc * 64 + 16 * ks;
          uint32_t r[4];
          ldsm_x4(r, st + trow * kBox + (((2 * ks + (lane >> 4)) ^ (lane & 7)) << 4));
          const bf16* row = s_hf + g * HS + k + 2 * t;
          gemm::mma16816(acc[0], r, *reinterpret_cast<const uint32_t*>(row),
                         *reinterpret_cast<const uint32_t*>(row + 8));
        }
      } else {
        unit_products(acc, st + loff, s_hf + kc * kMaxKB, HS, kMaxKB, kMaxKB, kh, g, t, 0);
      }
      __syncwarp();
      if (lane == 0) tma::bar_arrive(&empty[q]);
    }
    int v0;  // the vocabulary row of accumulator rows g (and g + 8)
    if (hd.tied) {
      v0 = vt * kMaxKB + 16 * warp + g;
    } else {  // warps 4-7 hand their half to warps 0-3
      if (kh == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) red[(cg * 32 + lane) * 8 + i] = acc[0][i];
      }
      csync();
      if (kh == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[0][i] += red[(cg * 32 + lane) * 8 + i];
      }
      csync();
      v0 = vt * 64 + 16 * cg + g;
    }
    if (hd.tied || kh == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows v0, then v0 + 8: increasing, so > keeps the first
        const int v = v0 + 8 * h;
        if (v >= p.V) continue;
        const float bias = p.lm_bias != nullptr ? to_f32(p.lm_bias[v]) : 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int b = 2 * t + j;
          const float sc = acc[0][2 * h + j] + bias;
          if (Cache::kLogits && p.logits != nullptr && b < p.B)
            p.logits[static_cast<size_t>(b) * p.V + v] = sc;
          if (sc > bm[j]) {
            bm[j] = sc;
            bi[j] = v;
          }
        }
      }
    }
  }
  // merge the lanes of each batch row (those with the same t), then the warps
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, bm[j], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi[j], o);
      if (better(m2, i2, bm[j], bi[j])) {
        bm[j] = m2;
        bi[j] = i2;
      }
    }
    if (g == 0) {
      s_bm[warp * kMaxB + 2 * t + j] = bm[j];
      s_bi[warp * kMaxB + 2 * t + j] = bi[j];
    }
  }
  csync();
  if (threadIdx.x < kMaxB) {
    float m = -INFINITY;
    int idx = INT_MAX;
    for (int w = 0; w < kWarps; ++w) {
      if (better(s_bm[w * kMaxB + threadIdx.x], s_bi[w * kMaxB + threadIdx.x], m, idx)) {
        m = s_bm[w * kMaxB + threadIdx.x];
        idx = s_bi[w * kMaxB + threadIdx.x];
      }
    }
    __stcg(p.work + pl.emax + blockIdx.x * kMaxB + threadIdx.x, m);
    __stcg(reinterpret_cast<int*>(p.work + pl.eidx) + blockIdx.x * kMaxB + threadIdx.x, idx);
  }
  return seq;
}

// Epilogue, second half: every block merges the blocks' partials in the same
// order, so all agree on the token; then, for a next step, the residual is
// the token's embedding row * embed_scale + its position, in fp32.
__device__ void token_phase(const StackParams& p, Shared& sh, int s) {
  const Plan& pl = sh.plan;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < p.B) {  // a warp per batch row; the merge is order-independent
    const float* emax = p.work + pl.emax;
    const int* eidx = reinterpret_cast<const int*>(p.work + pl.eidx);
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
    if (lane == 0) sh.tok[warp] = idx == INT_MAX ? 0 : idx;  // no finite logit: token 0, as the TPU kernel
  }
  csync();
  if (blockIdx.x == 0 && threadIdx.x < p.B) p.tokens[s * p.B + threadIdx.x] = sh.tok[threadIdx.x];
  if (s + 1 == p.steps) return;
  float* xres = p.work + pl.xres;
  const size_t next = static_cast<size_t>(p.pos + s + 1) * p.H;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.B * p.H; e += gridDim.x * kThreads) {
    const int b = e / p.H, h = e - b * p.H;
    float x = to_f32(p.lm_head[static_cast<size_t>(sh.tok[b]) * p.H + h]) * p.embed_scale;
    if (p.pos_embed != nullptr) x += to_f32(p.pos_embed[next + h]);
    __stcg(xres + e, x);
  }
  release(p, pl.token_done);
}

template <int D, int G, class Cache>
__global__ void __launch_bounds__(kBlockThreads, 1)
    stack_kernel(const __grid_constant__ StackParams p, const __grid_constant__ StackMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots];
  __shared__ Shared sh;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) / kAlign * kAlign);
  unsigned char* cons = ring + static_cast<size_t>(p.slots) * kSlotBytes;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kMaxSlots; ++q) {
      tma::bar_init(&full[q], 1);
      tma::bar_init(&empty[q], kWarps);
    }
    tma::bar_init_fence();
    sh.plan = make_plan(p, gridDim.x);
    sh.ns = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kThreads) {  // the producer warp
    if (threadIdx.x == kThreads) produce(p, maps, sh.plan, ring, full, empty);
    return;
  }
  const Plan& pl = sh.plan;
  const int H = p.H, L = p.L, nb = gridDim.x;
  float* xres = p.work + pl.xres;
  stamp(p, sh);
  // Step 0's residual: x (+ its position), in fp32.
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.B * H; e += nb * kThreads) {
    float x = to_f32(p.x[e]);
    if (p.pos_embed != nullptr) x += to_f32(p.pos_embed[static_cast<size_t>(p.pos) * H + e % H]);
    __stcg(xres + e, x);
  }
  release(p, pl.init_done);
  unsigned seq = 0;
  const unsigned down_groups = pl.ph[kDown].groups, out_groups = pl.ph[kOut].groups;
  for (int s = 0; s < p.steps; ++s) {
    for (int l = 0; l < L; ++l) {
      const int it = s * L + l;
      if (l == 0) {  // attention's split of the step (contexts do not change within it)
        if (threadIdx.x == 0) attention_split<Cache>(p, s, sh);
        csync();
      }
      // 1. norm1 and the QKV projections: the whole residual
      if (l > 0) wait_one(p, pl.phase_done + kDown, it * down_groups);
      else if (s == 0) wait_one(p, pl.init_done, nb);
      else wait_one(p, pl.token_done, s * nb);
      stamp(p, sh);
      seq = gemv_phase(p, sh, kQkv, l, it, ring, full, empty, cons, seq);
      // 2. RoPE, cache write, attention
      attention_phase<D, G, Cache>(p, sh, l, s, it, cons);
      // 3. out-projection and residual
      seq = gemv_phase(p, sh, kOut, l, it, ring, full, empty, cons, seq);
      // 4. norm2, up (and gate) projections, activation: the whole residual
      wait_one(p, pl.phase_done + kOut, (it + 1) * out_groups);
      stamp(p, sh);
      seq = gemv_phase(p, sh, kUp, l, it, ring, full, empty, cons, seq);
      // 5. down-projection and residual; the last layer also writes x_out
      seq = gemv_phase(p, sh, kDown, l, it, ring, full, empty, cons, seq);
    }
    wait_one(p, pl.phase_done + kDown, (s + 1) * L * down_groups);
    stamp(p, sh);
    if (!p.epilogue) continue;
    seq = logits_phase<Cache>(p, sh, ring, full, empty, cons, seq);
    release(p, pl.logits_done);
    wait_one(p, pl.logits_done, (s + 1) * nb);
    stamp(p, sh);
    if (p.tokens != nullptr) token_phase(p, sh, s);
    else if (s + 1 < p.steps) release(p, pl.token_done);
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

// Fills p->nblocks (one block an SM, all resident), p->slots (the ring: as
// many 16 KB slots as the shared memory left by the consumers' buffers
// holds) and p->smem, and returns the workspace sizes the wrapper allocates:
// work (fp32 elements) and sync (int32 elements, zeroed: the counters).
template <class Cache>
int stack_plan(StackParams* p, long long* work_floats, int* sync_ints) {
  const int G = p->Hkv > 0 ? p->Hq / p->Hkv : 0;
  const void* k = pick<Cache>(p->D, G);
  // a gated up's w_up and w_gate share their tiles: one format
  const bool pair_mix = p->activation >= 4 && ((p->wfmt >> 4) & 1) != ((p->wfmt >> 5) & 1);
  if (k == nullptr || p->B < 1 || p->B > kMaxB || p->Hq % p->Hkv || p->H % 8 || p->I % 8 ||
      p->wfmt < 0 || p->wfmt > 127 || pair_mix)
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return e;
  if (attr.sharedSizeBytes > static_cast<size_t>(kStaticSmem)) return cudaErrorInvalidConfiguration;
  const int cons = consumer_bytes(*p, G);
  int slots = (kSmemLimit - kStaticSmem - kAlign - cons) / kSlotBytes;
  slots = slots < kMaxSlots ? slots : kMaxSlots;
  if (slots < 2) return cudaErrorInvalidConfiguration;
  const int smem = kAlign + slots * kSlotBytes + cons;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kBlockThreads, smem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  // one block an SM (the ring takes the SM's shared memory); a group's
  // segments fit kMaxSegs, and the plan's unit arithmetic 32 bits
  if (2 * sms > kMaxSegs) return cudaErrorInvalidConfiguration;
  p->nblocks = sms;
  p->slots = slots;
  p->smem = smem;
  const Plan pl = make_plan(*p, p->nblocks);
  for (int k = kQkv; k <= kDown; ++k)
    if (static_cast<double>(pl.ph[k].ntiles) * pl.ph[k].nk * (sms + 1) >= 4294967295.0)
      return cudaErrorInvalidValue;
  *work_floats = pl.total;
  *sync_ints = pl.counters;
  return cudaSuccess;
}

// The tensor maps of p's weights into out (sizeof(StackMaps) bytes): each
// [L * in, out] as the kernel reads it, in boxes of one 128-byte column span
// and its phase's KB rows, 128-byte swizzled. p->nblocks from the plan.
// Errors as tma::map_2d's; a missing w_gate leaves its map zero.
inline int stack_maps(const StackParams* p, void* out) {
  StackMaps m;
  memset(&m, 0, sizeof m);
  const Plan pl = make_plan(*p, p->nblocks);
  const uint64_t L = p->L;
  if (p->epilogue) {  // the head: tied [V, H] or untied [H, V], 64 columns by 128 rows a box
    const cudaError_t e =
        p->lm_vmajor ? tma::map_2d(&m.w[7], p->lm_head, p->V, p->H, p->H, kMaxKB)
                     : tma::map_2d(&m.w[7], p->lm_head, p->H, p->V, p->lm_ld, kMaxKB);
    if (e != cudaSuccess) return e;
  }
  const void* ws[7] = {p->wq, p->wk, p->wv, p->wo, p->w_up, p->w_gate, p->w_down};
  const int kinds[7] = {kQkv, kQkv, kQkv, kOut, kUp, kUp, kDown};
  const int ms[7] = {0, 1, 2, 0, 0, 1, 0};
  for (int i = 0; i < 7; ++i) {
    const PhaseShape& ph = pl.ph[kinds[i]];
    if (ms[i] >= ph.nm) continue;  // an ungated MLP has no w_gate
    if (ws[i] == nullptr) return cudaErrorInvalidValue;
    const uint64_t rows = L * ph.K, cols = ph.N[ms[i]];
    const cudaError_t e =
        ((p->wfmt >> i) & 1) == 0 ? tma::map_2d(&m.w[i], ws[i], rows, cols, cols, ph.KB)
                     : tma::map_2d_u8(&m.w[i], ws[i], rows, cols, cols, kBox, ph.KB,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
  }
  memcpy(out, &m, sizeof m);
  return cudaSuccess;
}

// The plan of GEMV phase `kind` (0 QKV, 1 out, 2 up, 3 down) at p->nblocks
// blocks, for the card's check against the CPU mirror: out[0..3] = KB, nk,
// ntiles, tc, out[4] = p->slots, then (block, tile, first unit, end unit) of
// each segment in block order, at most cap of them. Returns their count
// (-1 past cap). Kind 4: attention's split (split_contexts) of the p->B
// sequences' slot counts given in out[0 .. B): out[0] = C, then ns[B], then
// off[B]; returns the splits in all. Kind 5: the counters an attention item
// waits on (attention_wait), six ints (o0, n0, o1, n1, o2, n2) a KV head;
// returns Hkv. Kind 6 + phase: every segment of the phase in block order,
// (block, tile, first unit, end unit, first counter, counters) of its wait
// (segment_wait); returns their count.
inline int stack_items(const StackParams* p, int kind, int* out, int cap) {
  const int nb = p->nblocks;
  if (kind == 5) {
    if (nb < 1 || cap < 6 * p->Hkv) return -1;
    const Plan pl = make_plan(*p, nb);
    for (int hk = 0; hk < p->Hkv; ++hk) {
      int o[3], n[3];
      attention_wait(*p, pl, hk, o, n);
      for (int i = 0; i < 3; ++i) {
        out[6 * hk + 2 * i] = o[i];
        out[6 * hk + 2 * i + 1] = n[i];
      }
    }
    return p->Hkv;
  }
  if (kind >= 6 && kind <= 9) {
    if (nb < 1) return -1;
    const Plan pl = make_plan(*p, nb);
    const PhaseShape& ph = pl.ph[kind - 6];
    const int U = ph.ntiles * ph.nk;
    int m = 0;
    for (int b = 0; b < nb; ++b)
      for (int u = unit_begin(U, nb, b), end = unit_begin(U, nb, b + 1); u < end;) {
        const int tile = u / ph.nk;
        const int stop = (tile + 1) * ph.nk < end ? (tile + 1) * ph.nk : end;
        if (6 * (m + 1) > cap) return -1;
        int* o = out + 6 * m++;
        o[0] = b;
        o[1] = tile;
        o[2] = u;
        o[3] = stop;
        o[4] = segment_wait(*p, pl, kind - 6, tile, u, stop, &o[5]);
        u = stop;
      }
    return m;
  }
  if (kind == 4) {
    if (p->B < 1 || p->B > kMaxB || cap < 1 + 2 * p->B || nb < 1) return -1;
    int n[kMaxB], ns[kMaxB], off[kMaxB], C = 0;
    for (int b = 0; b < p->B; ++b) n[b] = out[b];
    const int items = split_contexts(n, p->B, p->Hkv, nb, ns, off, &C);
    out[0] = C;
    for (int b = 0; b < p->B; ++b) {
      out[1 + b] = ns[b];
      out[1 + p->B + b] = off[b];
    }
    return items;
  }
  if (kind < kQkv || kind > kDown || nb < 1) return -1;
  const PhaseShape ph = make_plan(*p, nb).ph[kind];
  out[0] = ph.KB;
  out[1] = ph.nk;
  out[2] = ph.ntiles;
  out[3] = ph.tc;
  out[4] = p->slots;
  const int U = ph.ntiles * ph.nk;
  int n = 0;
  for (int b = 0; b < nb; ++b)
    for (int u = unit_begin(U, nb, b), end = unit_begin(U, nb, b + 1); u < end;) {
      const int tile = u / ph.nk;
      const int stop = (tile + 1) * ph.nk < end ? (tile + 1) * ph.nk : end;
      if (n == cap) return -1;
      int* o = out + 5 + 4 * n++;
      o[0] = b;
      o[1] = tile;
      o[2] = u;
      o[3] = stop;
      u = stop;
    }
  return n;
}

// A probe of the launch a cluster split-K would need (the card's answer is
// recorded by chip_smoke.py): every block resident at once, as the
// readiness waits need, and grouped into clusters of `cluster` blocks.
// Kernel cluster_probe (this kernel's block size and p->smem bytes of shared
// memory, so one block an SM as the stack kernel) counts the blocks that see
// every block of the grid arrive within about 100 ms. out[0] = the clusters
// of this size that cudaOccupancyMaxActiveClusters gives the stack kernel
// at p->smem (0, its error in out[1], where the query refuses the size),
// out[1] = the error of a cudaLaunchKernelEx with both the
// cooperative and the cluster-dimension attributes, at out[3] = that many
// clusters' blocks (at most p->nblocks), out[2] = the blocks that saw the
// whole grid (out[3] when co-resident). Returns the first error of the
// queries or of the launch's completion.
__global__ void __launch_bounds__(kBlockThreads, 1) cluster_probe(unsigned* arrived, unsigned* saw) {
  if (threadIdx.x == 0) {
    red_release(arrived, 1u);
    const uint64_t start = tma::now_ns();
    while (static_cast<int>(ld_acquire(arrived) - gridDim.x) < 0 &&
           tma::now_ns() - start < 100000000ull) {
    }
    if (ld_acquire(arrived) >= gridDim.x) atomicAdd(saw, 1u);
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

template <class Cache>
int stack_cluster_probe(const StackParams* p, int cluster, int* out) {
  const void* k = pick<Cache>(p->D, p->Hkv > 0 ? p->Hq / p->Hkv : 0);
  if (k == nullptr || cluster < 1 || p->nblocks < cluster) return cudaErrorInvalidValue;
  const void* probe = reinterpret_cast<const void*>(cluster_probe);
  cudaError_t e;
  const void* fns[2] = {k, probe};
  for (const void* f : fns) {
    if ((e = cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem)) !=
            cudaSuccess)
      return e;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->nblocks / cluster * cluster);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = p->smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  out[2] = out[3] = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg)) != cudaSuccess) {
    cudaGetLastError();  // the size refused: that is the answer
    out[0] = 0;
    out[1] = e;
    return cudaSuccess;
  }
  out[0] = clusters;
  const int grid = clusters * cluster < p->nblocks ? clusters * cluster : p->nblocks / cluster * cluster;
  out[3] = grid;
  if (grid < cluster) {
    out[1] = cudaErrorInvalidConfiguration;
    return cudaSuccess;
  }
  unsigned* buf = nullptr;
  if ((e = cudaMalloc(&buf, 2 * sizeof(unsigned))) != cudaSuccess) return e;
  e = cudaMemset(buf, 0, 2 * sizeof(unsigned));
  if (e == cudaSuccess) {
    cfg.gridDim = dim3(grid);
    cfg.numAttrs = 2;
    out[1] = cudaLaunchKernelEx(&cfg, cluster_probe, buf, buf + 1);
    cudaGetLastError();  // a refused launch is the answer, not a fault
    if (out[1] == cudaSuccess) {
      unsigned saw = 0;
      e = cudaDeviceSynchronize();
      if (e == cudaSuccess) e = cudaMemcpy(&saw, buf + 1, sizeof saw, cudaMemcpyDeviceToHost);
      out[2] = static_cast<int>(saw);
    }
  }
  const cudaError_t f = cudaFree(buf);
  return e != cudaSuccess ? e : f;
}

// One cooperative launch on the given stream with the weights' maps (from
// stack_maps); a refused launch returns its error.
template <class Cache>
int stack_launch(const StackParams* p, const void* maps, void* stream) {
  const void* k = pick<Cache>(p->D, p->Hkv > 0 ? p->Hq / p->Hkv : 0);
  if (k == nullptr) return cudaErrorInvalidValue;
  StackMaps m;
  memcpy(&m, maps, sizeof m);
  void* args[] = {const_cast<StackParams*>(p), &m};
  const cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(p->nblocks), dim3(kBlockThreads),
                                                    args, p->smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
