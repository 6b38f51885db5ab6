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
// The fp32 pass (G == 1): D / 8 lanes (bf16) cover one token's row, so a
// warp reads 32 * 16 contiguous-per-token bytes per step, and each step
// keeps kUnroll tokens of K and V in flight (32 KB a block). Softmax is
// online in fp32, one running (max, sum, acc) per lane group, merged across
// groups by shuffles and across warps in shared memory. A token's lanes are
// a power of two that divides the warp: at D 80 (Phi-2) a row's 10 chunks
// take 16 lanes, 6 of them idle (no load, zero in the dot's shuffle sum), so
// a warp step reads 2 rows of 160 bytes where 32 busy lanes would read 3.2:
// 62.5 % of the lanes load, and each load instruction moves 320 bytes
// instead of 512. 5-element (10-byte) lanes would keep every lane busy but
// split each row into unaligned 2-byte loads. At D 256 a row takes the
// whole warp, one token a warp step.
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

#include "gemm_tile.cuh"

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
// pass's 8 warps x tokens a warp step x kUnroll (128 at D 64, 64 at D 80 and
// 128, 32 at D 256; asserted in decode_kernel) and the tensor-core pass's 8
// warps x kTile, both dividing 128.
constexpr int kTokenStep = 128;
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
  constexpr int CH = D / V;           // 16-byte chunks of a token row
  constexpr int LPT = CH <= 8 ? 8 : CH <= 16 ? 16 : 32;  // lanes per token row
  constexpr bool kIdle = CH < LPT;    // lanes past the row's chunks (D 80)
  constexpr int TPI = 32 / LPT;       // tokens per warp step
  constexpr int STEP = kWarps * TPI;  // tokens per block step
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  static_assert(Vec16<T>::N == V, "q is a 16-bit type");
  static_assert(CH * V == D && CH <= 32, "head_dim must fit one warp");
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
    const bool busy = !kIdle || sub < CH;  // an idle lane's q, K and V are 0
    float qf[G][V];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (busy) {
        load_vec(q + (static_cast<size_t>(b) * Hq + hk * G + g) * D + sub * V, qf[g]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) qf[g][i] = 0.f;
      }
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
        if (t < n && busy) {
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
      if (grp == 0 && busy) {
#pragma unroll
        for (int i = 0; i < V; ++i) sm_acc[warp][g][sub * V + i] = acc[g][i];
        if (sub == 0) {
          sm_m[warp][g] = mw;
          sm_l[warp][g] = lw;
        }
      }
    }
  }
  __syncthreads();

  // Merge the warps: the block's (max, sum, acc) of each (g, d), left in
  // shared memory for its cluster.
  __shared__ float blk_m[G], blk_l[G], blk_acc[G * D];
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
    blk_acc[e] = o;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = lt;
    }
  }
  cluster_merge<T, G, D, kThreads>(blk_m, blk_l, blk_acc, rank, rows.n_split,
                                   out + (static_cast<size_t>(b) * Hq + hk * G) * D);
}

// The instance picked by (D, G): one launch of B * Hkv clusters of n_split
// blocks.
template <typename T, typename TC, class Rows>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* ctx, void* out, int B, int Hkv, int G, int D,
                      const Rows& rows, float scale, cudaStream_t s) {
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
  // Phi-2's and Gemma's head dims: the fp32 pass over a bf16 cache only
  if constexpr (!std::is_same<TC, int8_t>::value) {
    MLIO_DECODE_ATTN_CASE(80, 1) MLIO_DECODE_ATTN_CASE(256, 1)
  }
#undef MLIO_DECODE_ATTN_CASE
  return cudaErrorInvalidValue;
}

// The bf16 cache's instances, or with scales (ks != null) the int8 cache's.
template <typename T, class Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* ctx, void* out, int B, int Hkv, int G, int D,
                   const Rows& rows, float scale, cudaStream_t s) {
  if (ks != nullptr)
    return launch_tc<T, int8_t, Rows>(q, k, v, ks, vs, ctx, out, B, Hkv, G, D, rows, scale, s);
  return launch_tc<T, T, Rows>(q, k, v, nullptr, nullptr, ctx, out, B, Hkv, G, D, rows, scale,
                               s);
}

}  // namespace decode_attn
