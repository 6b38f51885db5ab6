// K7: single-token decode attention over the paged KV pools, for Hopper.
//
// Replaces mlio_tpu/ops/paged_attention.py::_paged_attn_kernel (:177, its
// pallas_call at :291). For each sequence b and query head h (kv head h / G):
//   out[b, h] = softmax(q[b, h] . K[b, :ctx[b], h/G]^T * scale) @ V[b, :ctx[b], h/G]
// where slot s of sequence b is row s % bs of physical block
// block_tables[b, s / bs] of layer `layer` of the [L, NB, bs, Hkv, D] pools,
// and ctx[b] counts the current token. Slots at or past ctx[b] are never
// read, nor the pool blocks named by table entries past ceil(ctx[b] / bs).
// A sequence with ctx[b] == 0 gives 0. Everything is fp32 between the loads
// and the output, as in the TPU kernel (which runs it on the VPU), grouped
// heads included. INT8 pools (int8 rows, fp32 scale pools [L, NB, bs, Hkv])
// take the int8 instances: the K scale on the fp32 score, the V scale on the
// probability (l sums the unscaled ones), as _paged_attn_kernel's kv_quant
// path (which dequantizes K and V in fp32 before both products: the same
// values, summed in another order).
//
// Bound: bytes, as K3: at GPT-2 small, B = 8 and a context of 896 one layer
// reads 8 * 896 * 768 * 2 * 2 B = 22 MB of K/V, 6.6 us at 3.35 TB/s; at the
// engine's ragged contexts (2,712 slots in all) 8.3 MB, 2.6 us. One query
// token a sequence leaves each block little work, so what costs is latency:
// the chain from the launch through the table to the rows, and the longest
// sequence's walk. The earlier kernel (K3's fp32 pass, one block of 8 warps
// a (sequence, KV head)) ran 7.4x its bound: 96 blocks at GPT-2's B 8, one
// of them walking the longest sequence's 1,023 slots alone, and every lane
// paying a dependent chain a slot (a table load, a division by bs, the
// row's address, then the row). Here:
// - The context is split across a thread-block cluster, as K3's: n_split
//   blocks a (sequence, KV head), block r over the chunk of `pages` whole
//   pages from page r * pages of the table; each block's (m, l, acc) is
//   merged in rank order through distributed shared memory
//   (decode_attn.cuh's cluster_merge). A chunk at or past ctx[b] skips its
//   walk (m = -inf, l = 0). ops/paged_attention.py::paged_split_plan picks
//   (n_split, pages) from the shapes alone.
// - The table is read once a block: its chunk's entries go to shared memory
//   at the start, in the same round trip as ctx[b] and q. A slot's row is
//   then its page's base plus its row within the page times Hkv * D: no
//   division and no dependent load in the walk.
// - Pages are streamed: the block walks 64-slot tiles (several whole pages
//   at bs <= 64, a piece of one page above), each copied by cp.async (16
//   bytes a thread, the K and V rows of one KV head: a strided box of the
//   [bs, Hkv, D] slab) into a three-stage ring, tile k + 2 in flight while
//   tile k computes from shared memory. Slots past ctx[b] are zero-filled,
//   rows and scales, so nothing past the context is read.
// - A tile takes one block barrier (its copies landed), fp32 at every G:
//   each thread takes 8 dims of a few slots for all G heads (q in
//   registers), each row's 8 dims one 16-byte (int8: 8-byte) load from
//   shared memory; a slot's score is summed over its row's lanes by
//   shuffles; each warp keeps its own online softmax over its slots (the
//   tile's max over the warp by shuffles, alpha, p) and each thread O's 8
//   dims over its slots. A softmax step shared by the block cost two more
//   barriers a tile and one warp's chain of shuffles and exps while seven
//   waited (PERF.md §6). The warps' states are merged once, at the end, in
//   a fixed order, so two launches give the same bits.
#include "cp_async.cuh"
#include "decode_attn.cuh"

namespace paged_attn {

using bf16 = __nv_bfloat16;
using gemm::cp_async16;
using gemm::cp_async4;
using gemm::cp_commit;
using gemm::cp_wait;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int TS = 64;       // slots a tile
constexpr int kStages = 3;   // the tile ring
constexpr int kMaxSplit = decode_attn::kMaxSplit;

struct Args {
  const bf16* q;      // [B, Hkv * G, D]
  const void* k;      // [L, NB, bs, Hkv, D] bf16, or int8 with ks, vs
  const void* v;
  const float* ks;    // [L, NB, bs, Hkv], or null
  const float* vs;
  const int* tables;  // [B, max_blocks]
  const int* ctx;     // [B]
  bf16* out;          // [B, Hkv * G, D]
  int max_blocks, num_blocks, bs, Hkv, layer;
  int n_split, pages;  // the clusters' blocks, and each block's pages of the table
  float scale;
};

// The shapes of a tile for pool element E at head dim D.
template <typename E, int D>
struct Tile {
  static constexpr bool kQuant = std::is_same<E, int8_t>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(E));
  static constexpr int CPR = kRowBytes / 16;            // 16-byte chunks a row
  static constexpr int CPT = TS * CPR / kThreads;       // a thread's chunks of a K (or V) tile
  static constexpr int EPC = 16 / static_cast<int>(sizeof(E));  // elements a chunk
  static constexpr size_t kKV = size_t(TS) * kRowBytes;  // the K (or V) rows of a tile
  static constexpr size_t kScales = 2 * kKV;             // then TS K scales, TS V scales
  static constexpr size_t kStage = 2 * kKV + (kQuant ? 2 * TS * sizeof(float) : 0);
  static constexpr size_t kRing = kStages * kStage;
  static constexpr int NDG = D / 8;          // a row's groups of 8 dims: a thread's share
  static constexpr int SP = kThreads / NDG;  // slots a tile's step covers
  static constexpr int SPT = TS / SP;        // slots a thread takes a tile
  static_assert(CPT >= 1 && TS * CPR % kThreads == 0, "whole chunks a thread");
};

// Where a tile of a block lies. bs <= TS: ppt whole pages a tile; else one
// piece of TS slots of a page (its last piece may hold fewer). first: the
// tile's first slot, counted from the chunk's; page, row: where that slot
// is; valid: the tile's slots below ctx (a prefix).
struct TileAt {
  int first, page, row, valid;
};

// The walk over a chunk whose first rem slots lie below ctx: the tile count
// (divided once), then tile after tile by advance(), with no division.
struct Walk {
  int bs, ppt, ppp, tslots, rem;
  __device__ Walk(int bs_, int rem_) : bs(bs_), rem(rem_) {
    const bool by_page = bs <= TS;
    ppt = by_page ? TS / bs : 1;
    ppp = by_page ? 1 : (bs + TS - 1) / TS;
    tslots = by_page ? ppt * bs : TS;
  }
  __device__ int tiles() const {
    if (bs <= TS) return (rem + tslots - 1) / tslots;
    return (rem / bs) * ppp + (rem % bs + TS - 1) / TS;
  }
  __device__ TileAt start() const {
    return TileAt{0, 0, 0, min(bs <= TS ? tslots : min(TS, bs), rem)};
  }
  __device__ void advance(TileAt& t) const {
    int len = tslots;
    if (bs <= TS) {
      t.page += ppt;
    } else {
      t.row += TS;
      if (t.row >= bs) {
        t.row = 0;
        ++t.page;
      }
      len = min(TS, bs - t.row);
    }
    t.first = t.page * bs + t.row;
    t.valid = min(len, rem - t.first);
  }
};

// Where a thread's copies come from: the pools at the layer (the KV head's
// offset in each chunk's), a row of Hkv * D elements a slot; and its
// copies: chunk c = tid + kThreads * i of the tile's K (and V) rows is row
// pos = c / CPR of the tile, chunk c % CPR; with bs <= TS its page within
// the tile and its row within the page, divided once. The thread copies
// the K scale (tid < TS) or the V scale of slot tid % TS.
template <typename E, int D>
struct Copies {
  using Tl = Tile<E, D>;
  const E* k;
  const E* v;
  const float* sc;  // int8: the K or the V scales at the layer, offset to the KV head
  int bs, row_elems;
  bool by_page;
  int pos[Tl::CPT], pdiv[Tl::CPT], pmod[Tl::CPT], off[Tl::CPT];
  int spos, sdiv, smod;
  __device__ Copies(const Args& a, int hk) {
    const size_t layer_slots = static_cast<size_t>(a.layer) * a.num_blocks * a.bs;
    bs = a.bs;
    row_elems = a.Hkv * D;
    by_page = bs <= TS;
    k = static_cast<const E*>(a.k) + layer_slots * row_elems;
    v = static_cast<const E*>(a.v) + layer_slots * row_elems;
    sc = Tl::kQuant ? (threadIdx.x < TS ? a.ks : a.vs) + layer_slots * a.Hkv + hk : nullptr;
#pragma unroll
    for (int i = 0; i < Tl::CPT; ++i) {
      const int c = threadIdx.x + kThreads * i;
      pos[i] = c / Tl::CPR;
      pdiv[i] = pos[i] / bs;
      pmod[i] = pos[i] % bs;
      off[i] = hk * D + c % Tl::CPR * Tl::EPC;
    }
    spos = threadIdx.x % TS;
    sdiv = spos / bs;
    smod = spos % bs;
  }
  // the slot (counted from the layer's first) of tile position p
  __device__ int slot(const int* table, const TileAt& t, int p, int pdv, int pmd) const {
    return table[by_page ? t.page + pdv : t.page] * bs + (by_page ? pmd : t.row + p);
  }
};

// Start the copies of tile t into ring stage `stage` as one commit group
// (live: the tile exists): the K and V rows (and, int8, the scales) of its
// slots below ctx, zeros for the rest. Every thread commits, copies or not.
template <typename E, int D>
__device__ __forceinline__ void load_tile(unsigned char* ring, const int* table,
                                          const Copies<E, D>& cp, const TileAt& t, int stage,
                                          bool live) {
  using Tl = Tile<E, D>;
  if (live) {
    unsigned char* st = ring + stage * Tl::kStage;
#pragma unroll
    for (int i = 0; i < Tl::CPT; ++i) {
      const int c = threadIdx.x + kThreads * i;
      const bool ok = cp.pos[i] < t.valid;
      size_t o = 0;
      if (ok)
        o = static_cast<size_t>(cp.slot(table, t, cp.pos[i], cp.pdiv[i], cp.pmod[i])) *
                cp.row_elems + cp.off[i];
      cp_async16(st + c * 16, cp.k + o, ok);
      cp_async16(st + Tl::kKV + c * 16, cp.v + o, ok);
    }
    if constexpr (Tl::kQuant) {
      if (threadIdx.x < 2 * TS) {
        const bool ok = cp.spos < t.valid;
        const size_t si = ok ? static_cast<size_t>(cp.slot(table, t, cp.spos, cp.sdiv, cp.smod)) *
                                   (cp.row_elems / D)
                             : 0;
        cp_async4(st + Tl::kScales + threadIdx.x * 4, cp.sc + si, ok);
      }
    }
  }
  cp_commit();
}

template <typename E, int D, int G>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args a) {
  using Tl = Tile<E, D>;
  constexpr int NDG = Tl::NDG, SP = Tl::SP;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  int* table = reinterpret_cast<int*>(smem + Tl::kRing);  // the chunk's table entries
  __shared__ float blk_m[G], blk_l[G], blk_acc[G * D];

  decode_attn::cluster_arrive();  // cluster_merge's first barrier phase
  // (sequence, kv head) and the block's rank; pair stays unsigned, as
  // blockIdx.x is (a signed pair made the earlier K7 spill).
  const unsigned pair = blockIdx.x / a.n_split;
  const int rank = blockIdx.x % a.n_split;
  const int b = pair / a.Hkv;
  const int hk = pair % a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dg = threadIdx.x % NDG;  // this thread's 8 dims: dg * 8 ..
  const int sl = threadIdx.x / NDG;  // and its slots: sl + SP j of each tile
  const int Hq = a.Hkv * G;

  // One round trip for the chunk's table entries (in bounds of the table's
  // row; only those below ceil(ctx / bs) are used), the context and q.
  const int page0 = rank * a.pages;
  const int chunk_pages = max(0, min(a.pages, a.max_blocks - page0));
  const int* trow = a.tables + static_cast<size_t>(b) * a.max_blocks + page0;
  for (int i = threadIdx.x; i < chunk_pages; i += kThreads) table[i] = __ldg(trow + i);
  const int n = max(0, min(__ldg(a.ctx + b), a.max_blocks * a.bs));
  // Only rank 0's chunk holds slots below ctx (short contexts: the engine's
  // decode): its own state is the merge's result, bit for bit (f = exp(0) =
  // 1 for it, 0 for every other rank), so no block merges and the other
  // ranks have nothing to do.
  const bool alone = n <= a.pages * a.bs;
  if (alone && rank > 0) return;
  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec(a.q + (static_cast<size_t>(b) * Hq + hk * G + g) * D + dg * 8, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= a.scale;
  }
  const int c0 = page0 * a.bs;  // the chunk's first slot
  const Walk w(a.bs, max(0, min(n, c0 + chunk_pages * a.bs) - c0));
  const int n_tiles = w.tiles();
  const Copies<E, D> cp(a, hk);
  __syncthreads();  // the table entries visible

  TileAt ahead = w.start();  // the next tile to copy
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    load_tile<E, D>(ring, table, cp, ahead, k, k < n_tiles);
    w.advance(ahead);
  }
  TileAt cur = w.start();

  // The warp's running max of each head over its slots so far (the same in
  // every lane), and this thread's sums over its own slots: l, and O's 8
  // dims of each head.
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  for (int k = 0; k < n_tiles; ++k) {
    cp_wait<kStages - 2>();
    // tile k visible to all; every thread is done with the stage of tile k - 1
    __syncthreads();
    load_tile<E, D>(ring, table, cp, ahead, (k + kStages - 1) % kStages,
                    k + kStages - 1 < n_tiles);
    w.advance(ahead);
    const unsigned char* st = ring + (k % kStages) * Tl::kStage;
    const float* scales = reinterpret_cast<const float*>(st + Tl::kScales);
    const int valid = cur.valid;
    w.advance(cur);

    // Scores of this thread's slots: its 8 dims for all G heads, summed over
    // the row's NDG lanes; slots past the context are -inf.
    float s[Tl::SPT][G];
#pragma unroll
    for (int j = 0; j < Tl::SPT; ++j) {
      const int pos = sl + SP * j;
      // one 16- (8-) byte load into a register: unpack8 given the shared
      // memory by reference read it back 2 bytes at a time (8 LDS.U16)
      const Raw8<E> kraw = *reinterpret_cast<const Raw8<E>*>(
          st + pos * Tl::kRowBytes + dg * 8 * static_cast<int>(sizeof(E)));
      float kf[8];
      unpack8<E>(kraw, kf);
      const float ksc = Tl::kQuant ? scales[pos] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) x = fmaf(qf[g][i], kf[i], x);
#pragma unroll
        for (int o = NDG / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        s[j][g] = pos < valid ? x * ksc : -INFINITY;
      }
    }
    // The warp's online softmax, a head at a time: the tile's max over the
    // warp's slots (its slot lanes by shuffles), alpha, p; no block barrier.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int j = 1; j < Tl::SPT; ++j) mx = fmaxf(mx, s[j][g]);
#pragma unroll
      for (int o = NDG; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_safe);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int j = 0; j < Tl::SPT; ++j) {
        s[j][g] = expf(s[j][g] - m_safe);  // p; exp(-inf) = 0
        l[g] += s[j][g];
      }
    }
    // O += P V over this thread's slots, its 8 dims of all G heads.
#pragma unroll
    for (int j = 0; j < Tl::SPT; ++j) {
      const int pos = sl + SP * j;
      const Raw8<E> vraw = *reinterpret_cast<const Raw8<E>*>(
          st + Tl::kKV + pos * Tl::kRowBytes + dg * 8 * static_cast<int>(sizeof(E)));
      float vf[8];
      unpack8<E>(vraw, vf);
      const float vsc = Tl::kQuant ? scales[TS + pos] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pv = s[j][g] * vsc;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
      }
    }
  }
  cp_wait<0>();

  // The warp's sums over its slot lanes (one running max a warp: plain
  // sums, by shuffles), then the warps merged in order through shared memory
  // (the ring's): the block's max, l and O.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = NDG; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    }
  }
  __syncthreads();  // every thread is done with the ring
  float* red = reinterpret_cast<float*>(ring);  // [kWarps][G][D], then m and l [kWarps][G]
  float* red_m = red + kWarps * G * D;
  float* red_l = red_m + kWarps * G;
  if (lane < NDG) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(red + (warp * G + g) * D + dg * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red_m[warp * G + g] = m[g];
      red_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, red_m[v * G + g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float mv = red_m[v * G + g];
      const float f = (mv == -INFINITY) ? 0.f : expf(mv - mx);
      lt += red_l[v * G + g] * f;
      o += red[v * G * D + e] * f;
    }
    if (alone) {
      a.out[(static_cast<size_t>(b) * Hq + hk * G) * D + e] =
          from_f32<bf16>(o / (lt == 0.f ? 1.f : lt));
    } else {
      blk_acc[e] = o;
      if (e % D == 0) {
        blk_m[g] = mx;
        blk_l[g] = lt;
      }
    }
  }
  if (!alone)
    decode_attn::cluster_merge<bf16, G, D, kThreads>(
        blk_m, blk_l, blk_acc, rank, a.n_split,
        a.out + (static_cast<size_t>(b) * Hq + hk * G) * D);
}

// The dynamic shared memory of an instance: the ring, then the chunk's
// table entries.
template <typename E, int D>
size_t smem_bytes(int pages) {
  return Tile<E, D>::kRing + (static_cast<size_t>(pages) * 4 + 15) / 16 * 16;
}

template <typename E, int D, int G>
cudaError_t launch_g(const Args& a, int B, cudaStream_t s) {
  auto kernel = paged_attn_kernel<E, D, G>;
  const size_t smem = smem_bytes<E, D>(a.pages);
  // the block's state (static) beside the ring and the table
  if (smem + (2 * G + G * D) * sizeof(float) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(static_cast<unsigned>(B) * a.Hkv * a.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_d(const Args& a, int B, int G, cudaStream_t s) {
  if (G == 1) return launch_g<E, D, 1>(a, B, s);
  if (G == 2) return launch_g<E, D, 2>(a, B, s);
  if (G == 4) return launch_g<E, D, 4>(a, B, s);
  if (G == 8) return launch_g<E, D, 8>(a, B, s);
  return cudaErrorInvalidValue;
}

template <typename E>
cudaError_t launch_e(const Args& a, int B, int G, int D, cudaStream_t s) {
  if (D == 64) return launch_d<E, 64>(a, B, G, s);
  if (D == 128) return launch_d<E, 128>(a, B, G, s);
  return cudaErrorInvalidValue;
}

}  // namespace paged_attn

// q, out: [B, Hkv * G, D] bf16; k_pool, v_pool: [L, NB, bs, Hkv, D] bf16, or
// int8 with fp32 k_scale, v_scale [L, NB, bs, Hkv] (null for bf16);
// tables: [B, max_blocks] int32 and ctx: [B] int32 on the device.
// G in {1, 2, 4, 8}, D in {64, 128}. Each (sequence, kv head) takes a
// cluster of n_split blocks (1 to 8), block r the `pages` table entries from
// r * pages; n_split * pages must cover max_blocks.
extern "C" int mlio_paged_attn(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale, const int* tables,
                               const int* ctx, void* out, int B, int max_blocks, int num_blocks,
                               int bs, int Hkv, int G, int D, int layer, float scale, int n_split,
                               int pages, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (n_split < 1 || n_split > paged_attn::kMaxSplit || pages < 1 || bs < 1 || max_blocks < 1 ||
      static_cast<long long>(n_split) * pages < max_blocks)
    return cudaErrorInvalidValue;
  const paged_attn::Args a{static_cast<const __nv_bfloat16*>(q), k_pool, v_pool, k_scale,
                           v_scale, tables, ctx, static_cast<__nv_bfloat16*>(out), max_blocks,
                           num_blocks, bs, Hkv, layer, n_split, pages, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_scale != nullptr) return paged_attn::launch_e<int8_t>(a, B, G, D, s);
  return paged_attn::launch_e<__nv_bfloat16>(a, B, G, D, s);
}
