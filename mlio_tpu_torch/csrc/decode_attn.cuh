// Single-token decode attention over the contiguous [L, B, Smax, Hkv, D]
// cache: K3 (decode_attn.cu). Its Rows policy gives where a sequence's token
// row lives and how far its context reaches. cluster_merge, the split's
// rank-order merge through distributed shared memory, is shared with K7
// (paged_attn.cu), which has its own kernel.
//
// For each sequence b and query head h (kv head h / G):
//   out[b, h] = softmax(q[b, h] . K[b, :n_b, h/G]^T * scale) @ V[b, :n_b, h/G]
// with n_b = rows.count(b, ctx). Slots at or past n_b are never read. A
// sequence with n_b == 0 gives 0.
//
// Bound: bytes. One query token meets n_b cached tokens, so each K/V byte
// read feeds 2 * G flops: ~1 flop per byte at G = 1, far below the H100's
// ~295 flops per byte (SXM data sheet). Every valid K/V byte is read once,
// with 16-byte loads, and the G query heads of a group share each K/V row.
//
// The fp32 pass (G == 1) at D 64, 128 and 256: D / 8 lanes (bf16) cover
// one token's row, so a warp reads 32 * 16 contiguous-per-token bytes per
// step, and each step keeps kUnroll tokens of K and V in flight (32 KB a
// block). Softmax is online in fp32, one running (max, sum, acc) per lane
// group, merged across groups by shuffles and across warps in shared
// memory. At D 256 a row takes the whole warp, one token a warp step.
//
// The fp32 pass at D 80 (Phi-2; decode_tma_kernel) is fed by TMA, because
// a 160-byte row's ten 16-byte chunks fit no power-of-two lane group: read
// by lanes it kept 16 lanes a token with 6 idle, 62.5 % of the lanes
// loading and 320 bytes a load instruction, 1.24 TB/s at phi-2's decode
// (0.05949 ms, 1.82x SDPA; PERF.md). Here one producer thread asks the TMA
// for 32-token stages of K and V (5 KB each) into a three-stage ring, 30 KB
// in flight a block, whatever the lanes do; once a stage lands, each of
// the eight consumer warps takes four of its tokens, eight lanes a token
// and ten dims (five bf16 pairs) a lane: every lane busy. The rows stay
// packed at 160 bytes (the TMA lands a box densely); word e of lane l's
// pairs is word 5 l + e of its warp's four rows, and 5 is odd, so the
// warp's 32 loads of a word fall on 32 banks with no pad. Four stages ran
// no faster than three, six slower (three blocks an SM: phi-2's split
// leaves half its 512 blocks idle in the cluster merge, and all must be
// resident). At phi-2's decode it runs 0.0324 ms against the idle-lane
// pass's 0.0592 (ab_k13.py, NVIDIA H100 80GB HBM3, 700 W), 2.27 TB/s, its
// bound 0.0227 ms (73.4 MB of K/V at K14's rate); SDPA 0.0313.
//
// The tensor-core pass (G > 1, grouped_mma_pass): both products on
// mma.sync, the heads as the rows of 16-row tiles, 16-slot tiles a warp, the
// next block step's rows asked of L2 ahead (prefetch_l2).
//
// The grid. Each sequence's slots are split into n_split chunks of `chunk`
// slots (a multiple of kTokenStep), and a thread-block cluster of n_split
// blocks runs per (sequence, kv head), one chunk a block: B * Hkv blocks
// alone (96 at GPT-2 small's batch 8, 8 at Mistral's decode at batch 1)
// leave most of the 132 SMs idle and keep too few loads in flight to cover
// the memory's latency. A chunk at or past n_b skips the loop (m = -inf,
// l = 0). Each block pushes its merged (m, l, acc[G][D]) through
// distributed shared memory (st.shared::cluster) to the peer whose share of
// the G * D outputs holds each element; after one cluster barrier each
// block merges its share in rank order, in fp32, so two launches give the
// same bits (cluster_merge). ops/
// decode_attention.py::split_plan picks (n_split, chunk) from the shapes
// alone, never from the context lengths on the card.
//
// Rounding: grouped heads (the tensor-core pass) round the scaled query and
// the probabilities to bf16 before their products, as the MXU path of
// _decode_kernel does, p against the running max of its warp's 16-slot
// tiles; the fp32 pass keeps everything in fp32.
//
// INT8 caches (TC = int8_t): each slot row of a kv head carries an fp32
// scale at element offset / D of the [.., Hkv] scale array beside the
// cache. A lane reads its 8 int8 values with one 8-byte load (the bf16
// cache's 16-byte load covers the same 8 elements, so the lane layout is
// the same), the K scale multiplies the fp32 score after the dot and the V
// scale the probability before the PV product, while l sums the unscaled
// probabilities: the fused dequant of _decode_kernel's kv_quant path (the
// tensor-core pass widens the int8 values to bf16 exactly). At half the
// bytes a slot, the bound halves.
#pragma once

#include "tma.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace decode_attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
// The largest cluster: the portable 8. The H100 takes 16 with
// cudaFuncAttributeNonPortableClusterSizeAllowed, but at Mistral's decode
// (8 clusters) 16-block clusters ran 80 us against 66 for 8-block ones, as
// if they ran in two waves (one block an SM; the active clusters were not
// queried).
constexpr int kMaxSplit = 8;
constexpr int kTile = 16;      // the tensor-core pass's tokens a warp step
// The slots a block step covers, and the split's chunk granule: the fp32
// pass's 8 warps x tokens a warp step x kUnroll (128 at D 64, 64 at D 128,
// 32 at D 256; asserted in decode_kernel), the TMA pass's stage
// (kRingTokens, 32 at D 80; asserted in decode_tma_kernel) and the
// tensor-core pass's 8 warps x kTile, all dividing 128.
constexpr int kTokenStep = 128;
// The TMA pass (D 80): tokens of K and of V a ring stage, and the stages.
constexpr int kRingTokens = 32;
constexpr int kRingStages = 3;
constexpr int kTmaThreads = kThreads + 32;  // the consumer warps and a producer warp
// The TMA pass's ring in bytes: each stage's K rows and V rows.
// (and 1 KB, to align its start).
template <int D>
constexpr size_t kRingBytes = size_t(kRingStages) * 2 * kRingTokens * D * 2 + 1024;
// Block steps ahead whose K/V rows the tensor-core pass asks L2 to fetch
// while it computes the current one (Mistral's decode: 57 us against 67
// without; two steps ahead no better; the fp32 pass ran slower with it).
constexpr int kPrefetch = 1;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// A row of 8 bf16 or int8 values as four words of bf16 pairs (int8 widened
// exactly).
template <typename TC>
__device__ __forceinline__ void bf16_words(const Raw8<TC>& raw, uint32_t* w) {
  if constexpr (std::is_same<TC, int8_t>::value) {
    float f[8];
    unpack_i8x8(raw, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = gemm::pack_bf16(f[2 * i], f[2 * i + 1]);
  } else {
    w[0] = raw.x;
    w[1] = raw.y;
    w[2] = raw.z;
    w[3] = raw.w;
  }
}

// K3's grouped heads (G > 1) on the tensor cores, as _decode_kernel's
// MXU path: S = (q * scale rounded to bf16) K^T and O += (p rounded to bf16)
// V by mma.sync m16n8k16 with fp32 sums, the online softmax over tiles of
// kTile slots. The fp32 pass spends about 120 instructions a slot at G 4
// (every lane of a row's group redoes each head's softmax) and ran 3x
// slower than its own loads alone at Mistral's decode; this one about 10.
// Warp w takes the tiles t_begin + 16 w + 128 i below n; the G query heads
// are rows 0 .. G - 1 of the 16-row products (the rest zero). Each lane
// reads its fragments straight from device memory, 16 bytes at a time (8 at
// int8): for S, lane (r = lane / 4, c = lane % 4) loads dims
// [c D/4, (c + 1) D/4) of slots r and 8 + r and holds the same dims of q,
// the k positions of step i being dims c D/4 + 4i + {0, 1} (b0) and
// + {2, 3} (b1) on both operands; for O it loads dims [r D/8, (r + 1) D/8) of
// slots 2c, 2c + 1, 2c + 8 and 2c + 9, so column n of O's n-tile j is dim
// n D/8 + j. The block's 8 warps keep 64 KB of K/V in flight at D 128.
// Leaves each warp's (max, sum, acc) in sm_m, sm_l, sm_acc as the fp32 pass.
template <typename TC, int D, int G, class Rows>
__device__ __forceinline__ void grouped_mma_pass(
    const __nv_bfloat16* __restrict__ qrow0, const TC* __restrict__ kc,
    const TC* __restrict__ vc, const float* __restrict__ ks, const float* __restrict__ vs,
    const Rows& rows, int b, int hk, float scale, int t_begin, int n,
    float (&sm_m)[kWarps][G], float (&sm_l)[kWarps][G], float (&sm_acc)[kWarps][G][D]) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int KW = D / 8;   // words (bf16 pairs) of a lane's K and q dims
  constexpr int VW = D / 16;  // words of a lane's V dims of one slot
  constexpr int NT = D / 8;   // O's n-tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, c = lane % 4;

  uint32_t qa[KW];  // row r of q * scale, rounded to bf16 (zero past G)
#pragma unroll
  for (int i = 0; i < KW / 4; ++i) {
    float f[8];
    if (r < G) {
      load_vec(qrow0 + static_cast<size_t>(r) * D + c * (D / 4) + 8 * i, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qa[4 * i + e] = gemm::pack_bf16(f[2 * e] * scale, f[2 * e + 1] * scale);
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int t0 = t_begin + kTile * warp; t0 < n; t0 += kTile * kWarps) {
    // S's slots t0 + r and t0 + 8 + r; O's (and the scores' columns) t0 + 2c
    // + {0, 1, 8, 9}. Slots at or past n are zero and masked.
    uint32_t kw[2][KW], vw[4][VW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 8 * h + r;
      const TC* p = kc + (t < n ? rows.offset(b, hk, t) : 0) + c * (D / 4);
#pragma unroll
      for (int i = 0; i < KW / 4; ++i)
        bf16_words<TC>(t < n ? *reinterpret_cast<const Raw8<TC>*>(p + 8 * i) : zero8<TC>(),
                       &kw[h][4 * i]);
    }
    if constexpr (kPrefetch > 0) {
      const int tp = t0 + kPrefetch * kTile * kWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (tp + 8 * h + r < n) prefetch_l2(kc + rows.offset(b, hk, tp + 8 * h + r) + c * (D / 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tp + 2 * c + (i & 1) + 8 * (i >> 1);
        if (t < n) prefetch_l2(vc + rows.offset(b, hk, t) + r * (D / 8));
      }
    }
    float ksc[4], vsc[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 2 * c + (i & 1) + 8 * (i >> 1);
      ok[i] = t < n;
      const size_t off = ok[i] ? rows.offset(b, hk, t) : 0;
      const TC* p = vc + off + r * (D / 8);
#pragma unroll
      for (int k = 0; k < VW / 4; ++k)
        bf16_words<TC>(ok[i] ? *reinterpret_cast<const Raw8<TC>*>(p + 8 * k) : zero8<TC>(),
                       &vw[i][4 * k]);
      if constexpr (kQuant) {
        ksc[i] = ok[i] ? ks[off / D] : 1.f;
        vsc[i] = ok[i] ? vs[off / D] : 1.f;
      }
    }

    // S: rows the heads, columns the slots 2c + {0, 1} (n-tile 0) and
    // 8 + 2c + {0, 1} (n-tile 1).
    float sa[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const uint32_t a[4] = {qa[2 * i], 0u, qa[2 * i + 1], 0u};
      gemm::mma16816(sa[0], a, kw[0][2 * i], kw[0][2 * i + 1]);
      gemm::mma16816(sa[1], a, kw[1][2 * i], kw[1][2 * i + 1]);
    }
    float sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = sa[i >> 1][i & 1] * (kQuant ? ksc[i] : 1.f);
      sv[i] = ok[i] ? x : -INFINITY;
    }
    // Row r's online softmax over the tile: its 16 slots lie on the quad.
    float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // slot t0 is valid: finite
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float p[4], psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = expf(sv[i] - m_new);  // exp(-inf) = 0
      psum += p[i];
      if (kQuant) p[i] *= vsc[i];
    }
    l = l * alpha + psum;
    m = m_new;
    // O += P V: p rounded to bf16 as the A fragment (k = the tile's slots),
    // V's B fragments paired from two slots' words.
    const uint32_t pa[4] = {gemm::pack_bf16(p[0], p[1]), 0u, gemm::pack_bf16(p[2], p[3]), 0u};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      gemm::mma16816(o[j], pa, __byte_perm(vw[0][j / 2], vw[1][j / 2], sel),
                     __byte_perm(vw[2][j / 2], vw[3][j / 2], sel));
    }
  }

  // The warp's state of head r: l summed over the quad; O's columns 2c and
  // 2c + 1 of n-tile j are dims (2c + e) D/8 + j.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (r < G) {
    if (c == 0) {
      sm_m[warp][r] = m;
      sm_l[warp][r] = l;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sm_acc[warp][r][(2 * c + e) * (D / 8) + j] = o[j][e];
  }
}

// The split's merge (K3 and K7). A kernel that ends in cluster_merge calls
// cluster_arrive() at its start: the cluster barrier's first phase, whose
// wait in cluster_merge guarantees that every peer block has started before
// its shared memory is written.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Each block of the cluster has its (m, l) of the G heads in blk_m, blk_l
// and its unnormalised acc [G, D] in blk_acc (blk_acc[e] written by thread
// e % kBlockThreads, blk_m[g] and blk_l[g] by the thread of e = g * D).
// Block `rank` of n_split pushes each element into the shared memory of the
// peer whose share of the G * D outputs holds it, and (m, l) to every peer
// (st.shared::cluster); one cluster barrier makes the pushes visible, and
// each block merges its share locally, the ranks in order in fp32 (mx = max
// m_r, f_r = exp(m_r - mx), 0 where m_r = -inf; out = sum f_r acc_r /
// sum f_r l_r, 0 where the sum of l is 0), into out [G, D], the (sequence,
// kv head)'s rows. A merge that reads the peers' memory after a barrier
// needs a round trip of remote loads and a second barrier to keep that
// memory alive; pushing needs one barrier and no remote load.
// Every thread of every block of the cluster calls it.
template <typename T, int G, int D, int kBlockThreads>
__device__ __forceinline__ void cluster_merge(const float* blk_m, const float* blk_l,
                                              const float* blk_acc, int rank, int n_split,
                                              T* __restrict__ out) {
  namespace cg = cooperative_groups;
  // the ranks' states of this block's share: acc [rank][share], m and l [rank][G]
  __shared__ float got_acc[G * D + kMaxSplit], got_m[kMaxSplit * G], got_l[kMaxSplit * G];
  const cg::cluster_group cluster = cg::this_cluster();
  const int share = (G * D + n_split - 1) / n_split;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer started
  for (int e = threadIdx.x; e < G * D; e += kBlockThreads) {
    const int p = e / share;
    *cluster.map_shared_rank(&got_acc[rank * share + e - p * share], p) = blk_acc[e];
    if (e % D == 0) {
      const int g = e / D;
      for (int r = 0; r < n_split; ++r) {
        *cluster.map_shared_rank(&got_m[rank * G + g], r) = blk_m[g];
        *cluster.map_shared_rank(&got_l[rank * G + g], r) = blk_l[g];
      }
    }
  }
  // every push visible; no peer reads this block's memory after it
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const int e0 = rank * share;
  const int cnt = max(0, min(G * D, e0 + share) - e0);
  for (int j = threadIdx.x; j < cnt; j += kBlockThreads) {
    const int g = (e0 + j) / D;
    float mx = -INFINITY;
    for (int r = 0; r < n_split; ++r) mx = fmaxf(mx, got_m[r * G + g]);
    float lt = 0.f, o = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float mr = got_m[r * G + g];
      const float f = (mr == -INFINITY) ? 0.f : expf(mr - mx);
      lt += got_l[r * G + g] * f;
      o += got_acc[r * share + j] * f;
    }
    const float l_safe = (lt == 0.f) ? 1.f : lt;
    out[e0 + j] = from_f32<T>(o / l_safe);
  }
}

// Merge the lane groups of LPT lanes of a warp, each with its running (m,
// l) and its N values of acc (dims sub * N .. sub * N + N - 1 of its row,
// sub = lane % LPT): after the xor steps over the group bits every group
// holds the warp's (max, sum, acc), and group 0 leaves them in the warp's
// row of shared memory.
template <int LPT, int N>
__device__ __forceinline__ void merge_groups(float m, float l, float (&acc)[N], float& sm_m,
                                             float& sm_l, float* sm_acc) {
  const int lane = threadIdx.x % 32, grp = lane / LPT, sub = lane % LPT;
  float mw = m;
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  const float f = (m == -INFINITY) ? 0.f : expf(m - mw);
  float lw = l * f;
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float a = acc[i] * f;
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    acc[i] = a;
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[sub * N + i] = acc[i];
    if (sub == 0) {
      sm_m = mw;
      sm_l = lw;
    }
  }
}

// Merge the warps: the block's (max, sum, acc) of each (g, d), left in
// shared memory for its cluster (blk_acc[e] written by thread e %
// kBlockThreads, blk_m[g] and blk_l[g] by the thread of e = g * D, as
// cluster_merge reads them).
template <int G, int D, int kBlockThreads>
__device__ __forceinline__ void merge_warps(const float (&sm_m)[kWarps][G],
                                            const float (&sm_l)[kWarps][G],
                                            const float (&sm_acc)[kWarps][G][D], float* blk_m,
                                            float* blk_l, float* blk_acc) {
  for (int e = threadIdx.x; e < G * D; e += kBlockThreads) {
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
    blk_acc[e] = o;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = lt;
    }
  }
}

// Rows policy: count(b, ctx) is the number of valid slots of sequence b;
// offset(b, hk, t) the element offset of slot t's row of kv head hk;
// n_split and chunk: the block is rank blockIdx.x % n_split of its cluster
// and takes slots [rank * chunk, (rank + 1) * chunk).
// ks, vs: the INT8 cache's scales (TC = int8_t), else null.
template <typename T, typename TC, int D, int G, class Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const int* __restrict__ ctx, T* __restrict__ out, Rows rows, int Hkv,
              float scale) {
  constexpr int V = 8;                // elements a lane holds of a row
  constexpr int LPT = D / V;          // lanes per token row: its 16-byte chunks
  constexpr int TPI = 32 / LPT;       // tokens per warp step
  constexpr int STEP = kWarps * TPI;  // tokens per block step
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static_assert(Vec16<T>::N == V, "q is a 16-bit type");
  static_assert(LPT * V == D && 32 % LPT == 0, "a token row takes a power-of-two lane group");
  static_assert(kTokenStep % (STEP * kUnroll) == 0, "a split chunk holds whole block steps");

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  cluster_arrive();  // cluster_merge's first barrier phase
  // (sequence, kv head) and the block's rank in its cluster. pair stays
  // unsigned, as blockIdx.x is: with a signed pair (b and hk by signed
  // division) K7's build spilled and ran 1.5 % slower.
  const unsigned pair = blockIdx.x / rows.n_split;
  const int rank = blockIdx.x % rows.n_split;
  const int b = pair / Hkv;
  const int hk = pair % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPT;  // token slot within the warp step
  const int sub = lane % LPT;  // 16-byte chunk of the row
  const int Hq = Hkv * G;
  // this block's slots: [t_begin, n)
  const int t_begin = rank * rows.chunk;
  const int n = min(rows.count(b, ctx), t_begin + rows.chunk);

  if constexpr (G > 1) {
    grouped_mma_pass<TC, D, G>(q + (static_cast<size_t>(b) * Hq + hk * G) * D, kc, vc, ks, vs,
                               rows, b, hk, scale, t_begin, n, sm_m, sm_l, sm_acc);
  } else {
    float qf[G][V];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load_vec(q + (static_cast<size_t>(b) * Hq + hk * G + g) * D + sub * V, qf[g]);
#pragma unroll
      for (int i = 0; i < V; ++i) qf[g][i] *= scale;
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

    for (int t0 = t_begin + warp * TPI; t0 < n; t0 += STEP * kUnroll) {
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
            const float pv = kQuant ? p * vsc[u] : p;
#pragma unroll
            for (int i = 0; i < V; ++i) acc[g][i] = acc[g][i] * alpha + pv * vv[i];
            m[g] = m_new;
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < G; ++g)
      merge_groups<LPT>(m[g], l[g], acc[g], sm_m[warp][g], sm_l[warp][g], sm_acc[warp][g]);
  }
  __syncthreads();

  __shared__ float blk_m[G], blk_l[G], blk_acc[G * D];
  merge_warps<G, D, kThreads>(sm_m, sm_l, sm_acc, blk_m, blk_l, blk_acc);
  cluster_merge<T, G, D, kThreads>(blk_m, blk_l, blk_acc, rank, rows.n_split,
                                   out + (static_cast<size_t>(b) * Hq + hk * G) * D);
}

// The K and V caches as 4-D maps [D, Hkv, Smax, L * B] (the wrapper's
// ops/decode_attention.py::cache_map), in boxes of kRingTokens rows of one
// (layer, sequence, KV head): a box lands its rows packed, 2 D bytes apart;
// rows past Smax read as zeros.
struct CacheMaps {
  CUtensorMap k, v;
};

// The fp32 pass at D 80 (one query head a KV head, a bf16 cache), fed by
// TMA: warp kWarps is the producer (its lane 0 asks for the block's stages
// of K and V through a kRingStages ring, each stage once the consumer warps
// have released it), warps 0 .. kWarps - 1 the consumers (each takes tokens
// 4 w .. 4 w + 3 of every stage, eight lanes a token, W bf16 pairs a lane).
// A stage's slots at or past n land too (stale, NaN, or zeros past Smax):
// their scores and V rows reach neither m, l nor acc. rows.count, n_split
// and chunk as decode_kernel's, and the same merges: every block of the
// cluster ends in cluster_merge, a chunk wholly past n included.
template <typename T, int D, class Rows>
__global__ void __launch_bounds__(kTmaThreads, 4)
decode_tma_kernel(const T* __restrict__ q, const int* __restrict__ ctx, T* __restrict__ out,
                  Rows rows, int Hkv, float scale, const __grid_constant__ CacheMaps maps) {
  constexpr int LPT = 8;                // lanes a token
  constexpr int W = D / (2 * LPT);      // bf16 pairs (4-byte words) a lane: 5 at D 80
  constexpr int TPW = 32 / LPT;         // tokens a warp step
  constexpr int kRowWords = D / 2;      // words a token row
  constexpr int kStageWords = kRingTokens * kRowWords;
  static_assert(Vec16<T>::N == 8 && D == 2 * W * LPT, "a bf16 row of 8 lane groups");
  static_assert(kRingTokens == kWarps * TPW, "a stage is one warp step of each consumer warp");
  static_assert(kTokenStep % kRingTokens == 0, "a split chunk holds whole stages");

  // the ring (dynamic shared memory, placed after the static arrays: its
  // start rounded up to 1 KB): stage s's K rows, then its V rows
  extern __shared__ __align__(16) unsigned char dyn[];
  const uint32_t pad = (1024 - (gemm::smem_addr(dyn) & 1023)) & 1023;
  uint32_t* ring = reinterpret_cast<uint32_t*>(dyn + pad);
  __shared__ uint64_t full[kRingStages], empty[kRingStages];
  __shared__ float sm_m[kWarps][1], sm_l[kWarps][1], sm_acc[kWarps][1][D];
  __shared__ float blk_m[1], blk_l[1], blk_acc[D];

  cluster_arrive();  // cluster_merge's first barrier phase
  const unsigned pair = blockIdx.x / rows.n_split;
  const int rank = blockIdx.x % rows.n_split;
  const int b = pair / Hkv;
  const int hk = pair % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this block's slots [t_begin, n), in stages of kRingTokens from t_begin
  const int t_begin = rank * rows.chunk;
  const int n = min(rows.count(b, ctx), t_begin + rows.chunk);
  const int n_stages = n > t_begin ? (n - t_begin + kRingTokens - 1) / kRingTokens : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      tma::bar_init(&full[i]);
      tma::bar_init(&empty[i], kWarps);
    }
    tma::bar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    if (lane == 0) {
      const int z = rows.layer * rows.B + b;
      for (int i = 0; i < n_stages; ++i) {
        const int st = i % kRingStages;
        if (i >= kRingStages) tma::bar_wait_bounded(&empty[st], ((i / kRingStages) + 1) & 1);
        tma::bar_expect(&full[st], 2 * kStageWords * 4);
        const int t0 = t_begin + i * kRingTokens;
        tma::load_4d(ring + 2 * st * kStageWords, &maps.k, 0, hk, t0, z, &full[st]);
        tma::load_4d(ring + (2 * st + 1) * kStageWords, &maps.v, 0, hk, t0, z, &full[st]);
      }
    }
  } else {
    const int grp = lane / LPT;  // this lane's token of the warp's four
    const int sub = lane % LPT;  // its dims [2 W sub, 2 W sub + 2 W)
    const int r = warp * TPW + grp;  // the token's row in a stage
    float qf[2 * W];
    const uint32_t* qw =
        reinterpret_cast<const uint32_t*>(q + (static_cast<size_t>(b) * Hkv + hk) * D) + sub * W;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const uint32_t x = qw[e];
      qf[2 * e] = __uint_as_float(x << 16) * scale;
      qf[2 * e + 1] = __uint_as_float(x & 0xffff0000u) * scale;
    }
    float m = -INFINITY, l = 0.f, acc[2 * W];
#pragma unroll
    for (int i = 0; i < 2 * W; ++i) acc[i] = 0.f;

    for (int i = 0; i < n_stages; ++i) {
      const int st = i % kRingStages;
      tma::bar_wait_bounded(&full[st], (i / kRingStages) & 1);
      const uint32_t* kr = ring + 2 * st * kStageWords + r * kRowWords + sub * W;
      uint32_t kw[W], vw[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        kw[e] = kr[e];
        vw[e] = kr[kStageWords + e];
      }
      __syncwarp();
      if (lane == 0) tma::bar_arrive(&empty[st]);  // the warp's reads done: the slot is free
      float sc = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        sc += qf[2 * e] * __uint_as_float(kw[e] << 16);
        sc += qf[2 * e + 1] * __uint_as_float(kw[e] & 0xffff0000u);
      }
#pragma unroll
      for (int o = LPT / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (t_begin + i * kRingTokens + r < n) {
        const float m_new = fmaxf(m, sc);
        const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
        const float p = expf(sc - m_new);
        l = l * alpha + p;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          acc[2 * e] = acc[2 * e] * alpha + p * __uint_as_float(vw[e] << 16);
          acc[2 * e + 1] = acc[2 * e + 1] * alpha + p * __uint_as_float(vw[e] & 0xffff0000u);
        }
        m = m_new;
      }
    }
    merge_groups<LPT>(m, l, acc, sm_m[warp][0], sm_l[warp][0], sm_acc[warp][0]);
  }
  __syncthreads();

  merge_warps<1, D, kTmaThreads>(sm_m, sm_l, sm_acc, blk_m, blk_l, blk_acc);
  cluster_merge<T, 1, D, kTmaThreads>(blk_m, blk_l, blk_acc, rank, rows.n_split,
                                      out + (static_cast<size_t>(b) * Hkv + hk) * D);
}

// The instance picked by (D, G): one launch of B * Hkv clusters of n_split
// blocks.
template <typename T, typename TC, class Rows>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* ctx, void* out, int B, int Hkv, int G, int D,
                      const Rows& rows, float scale, const CacheMaps* maps, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const TC* kp = static_cast<const TC*>(k);
  const TC* vp = static_cast<const TC*>(v);
  T* op = static_cast<T*>(out);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(B * Hkv * rows.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = rows.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define MLIO_DECODE_ATTN_CASE(DD, GG)                                                         \
  if (D == DD && G == GG) {                                                                   \
    const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<T, TC, DD, GG, Rows>, qp, \
                                               kp, vp, ks, vs, ctx, op, rows, Hkv, scale);    \
    return err != cudaSuccess ? err : cudaGetLastError();                                     \
  }
  MLIO_DECODE_ATTN_CASE(64, 1) MLIO_DECODE_ATTN_CASE(64, 2)
  MLIO_DECODE_ATTN_CASE(64, 4) MLIO_DECODE_ATTN_CASE(64, 8)
  MLIO_DECODE_ATTN_CASE(128, 1) MLIO_DECODE_ATTN_CASE(128, 2)
  MLIO_DECODE_ATTN_CASE(128, 4) MLIO_DECODE_ATTN_CASE(128, 8)
  // Phi-2's and Gemma's head dims: the fp32 pass over a bf16 cache only,
  // at D 80 fed by TMA through the cache's maps
  if constexpr (!std::is_same<TC, int8_t>::value) {
    MLIO_DECODE_ATTN_CASE(256, 1)
    if (D == 80 && G == 1) {
      if (maps == nullptr) return cudaErrorInvalidValue;
      auto kernel = decode_tma_kernel<T, 80, Rows>;
      cfg.blockDim = dim3(kTmaThreads);
      cfg.dynamicSmemBytes = kRingBytes<80>;
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(cfg.dynamicSmemBytes));
      if (err == cudaSuccess)
        err = cudaLaunchKernelEx(&cfg, kernel, qp, ctx, op, rows, Hkv, scale, *maps);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
  }
#undef MLIO_DECODE_ATTN_CASE
  return cudaErrorInvalidValue;
}

// The bf16 cache's instances, or with scales (ks != null) the int8 cache's;
// maps: the cache's (D 80), else null.
template <typename T, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* ctx, void* out, int B, int Hkv, int G, int D,
                   const Rows& rows, float scale, const CacheMaps* maps, cudaStream_t s) {
  if (ks != nullptr)
    return launch_tc<T, int8_t, Rows>(q, k, v, ks, vs, ctx, out, B, Hkv, G, D, rows, scale,
                                      nullptr, s);
  return launch_tc<T, T, Rows>(q, k, v, nullptr, nullptr, ctx, out, B, Hkv, G, D, rows, scale,
                               maps, s);
}

}  // namespace decode_attn
