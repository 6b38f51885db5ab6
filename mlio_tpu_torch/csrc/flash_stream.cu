// K10: the long-context flash attention forward for Hopper.
//
// Replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_stream_kernel (its
// pallas_call at :657), the JAX package's forward once one head's K/V pass
// its VMEM budget. q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] in the bshd layout,
// out [B, Sq, Hq, D] in the bshd or the bhsd layout (out_layout, :690-696):
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
// operations, 40 times over. The tensor cores must run without a pause, and
// the softmax (a 128 x 128 tile's 16K exponentials take about half as long
// on the SM's 16 MUFU lanes as the tile's two products on its tensor
// cores), the loads and the barriers must stay out of their way.
//
// The design (FlashAttention-3's shape, written for this kernel; its pieces
// in flash_ws.cuh, shared with K1 at head dim 256, flash_fwd_d256.cu):
// - One block per (q tile of 128 rows, query head, batch), the heaviest q
//   tiles (the last, under causality) first and the query heads of one KV
//   head side by side, so that their K/V meet in L2. Three warpgroups a
//   block, one block an SM: a producer and two consumers of 64 q rows each.
//   setmaxnreg gives the producer 24 registers a thread and the consumers
//   240: a consumer holds S (64 fp32 at 128 keys), O (64 at D 128) and p
//   (32 packed bf16) at once.
// - The producer: one thread asks the TMA (tma.cuh) for every tile. Q once,
//   each consumer's 64 rows on its own barrier; K and V in 128-key tiles
//   (wgmma.cuh's 128-byte swizzle, K K-major and V MN-major as K1 reads
//   them) into a ring of as many stages as shared memory holds (three at
//   D 128: 32 KB of Q and 3 x 64 KB of K/V). K and V have their own full
//   and empty mbarriers a stage, so a K slot is refilled as soon as both
//   consumers' S products have read it, and V one tile later. K/V come
//   through a 3-D map [B, Skv, Hkv * D]: rows past Skv read as zeros and a
//   tile never runs into the next sequence. Rows between kv_len[b] and Skv
//   arrive as the cache holds them; the masked scores ignore K there, and
//   the producer warp zeroes those rows of the last V tile before handing it
//   over (p = 0 there, and 0 * NaN is NaN), as the earlier kernel's copies
//   zero-filled them.
// - The consumers: the Q tile is scaled in place, q * scale in fp32 rounded
//   back to bf16 (fence.proxy.async before the products read it), then each
//   K/V tile j takes S(j) = Q K(j)^T issued together with O += P(j-1)
//   V(j-1), the softmax of S(j) while O's product runs, O rescaled once it
//   lands, and p rounded to bf16 and repacked in registers as the next PV
//   product's A operand (wgmma.cuh's repack). O stays in registers. The two
//   consumers run unordered: named barriers that handed the tensor cores
//   from one to the other at each issue (ping-pong) measured no faster at
//   Mistral's 32K call (ab_k10.py's `turns`; PERF.md). No block-wide
//   barrier runs after the set-up; every mbarrier wait is bounded
//   (tma::bar_wait_bounded), so a miscounted copy fails the launch instead
//   of hanging the card.
// - Interior tiles (every key at or below the warpgroup's first row and
//   inside kv_len) take no mask; the diagonal tile and the kv_len tail do.
//   The causal early exit stops at min(kv_len[b], q_start + q_offset + 128).
//   q rows past Sq are computed from whatever the map reads there and not
//   stored. Offsets are 64-bit. Every output has one writer: two launches
//   give the same bits.
//
// Rounding follows _flash_fwd_stream_kernel: the scale is folded into q in
// fp32 and rounded back to bf16; the online (m, l, acc) state is fp32; p is
// rounded to bf16 for the PV product while l adds the fp32 p, p taken
// against the running max of the 128-key tiles seen; out = acc / l. exp is
// taken as exp2 of the score times log2(e), a few fp32 ulps from exp.
#include "flash_ws.cuh"

namespace stream {

using bf16 = __nv_bfloat16;
using gemm::fence_regs;
using gemm::repack;
using gemm::wgmma_commit;
using gemm::wgmma_fence;
using gemm::wgmma_wait;
using gemm::zero;
using tma::bar_arrive;
using tma::bar_wait_bounded;
using ws::kThreads;
using ws::kWg;

constexpr int BQ = 128;   // q rows a block: two consumer warpgroups of 64
constexpr int BKV = 128;  // keys a K/V tile

template <int D>
struct Smem {
  static constexpr size_t kQTile = size_t(64) * D * 2;    // one consumer's q rows
  static constexpr size_t kKvTile = size_t(BKV) * D * 2;  // one K or V tile
  static constexpr int kStages =
      (ws::kSmemLimit - 1024 - 2 * kQTile) / (2 * kKvTile) < 4
          ? static_cast<int>((ws::kSmemLimit - 1024 - 2 * kQTile) / (2 * kKvTile))
          : 4;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = 2 * kQTile;
  static constexpr size_t kV = kK + kStages * kKvTile;
  static constexpr size_t kBars = kV + kStages * kKvTile;
  static constexpr size_t kBytes = kBars + ws::Bars<kStages>::kCount * 8;
  static_assert(kStages >= 2 && kBytes <= ws::kSmemLimit, "the ring must fit");
};

struct Args {
  bf16* out;
  float* lse;
  const int* kv_len_arr;
  int kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset, causal;
  float scale;
  long long out_b, out_s, out_h;  // out's batch, row and head strides (bshd or bhsd)
};

// q as [B * Sq, Hq * D] in [64 x 64] boxes; k and v as [B, Skv, Hkv * D] in
// [BKV x 64] boxes.
struct Maps {
  CUtensorMap q, k, v;
};

// The producer warp: lane 0 asks for Q, then K(0), and for each tile j
// K(j + 1) before V(j), the order the consumers need them in; each slot
// once both consumers have released it. The last V tile, where it holds
// rows past kv_len, lands on its own barrier and the warp zeroes those rows
// before it hands the tile over.
template <int D>
__device__ __forceinline__ void produce(const Maps& maps, bf16* sQ, bf16* sK, bf16* sV,
                                        const ws::Bars<Smem<D>::kStages>& bar, int b, int h, int hk,
                                        int q_row0, int n_tiles, int kvl) {
  using S = Smem<D>;
  constexpr int kS = S::kStages;
  constexpr int kHalves = D / 64;
  const int lane = threadIdx.x % 32;
  const bool tail = n_tiles * BKV > kvl;

  auto load_k = [&](int i) {
    const int slot = i % kS;
    if (i >= kS) bar_wait_bounded(&bar.empty_k[slot], ((i / kS) + 1) & 1);
    tma::bar_expect(&bar.full_k[slot], static_cast<uint32_t>(S::kKvTile));
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
      tma::load_3d(sK + slot * BKV * D + c * BKV * 64, &maps.k, hk * D + c * 64, i * BKV, b,
                   &bar.full_k[slot]);
  };
  auto load_v = [&](int i, uint64_t* full) {
    const int slot = i % kS;
    if (i >= kS) bar_wait_bounded(&bar.empty_v[slot], ((i / kS) + 1) & 1);
    tma::bar_expect(full, static_cast<uint32_t>(S::kKvTile));
#pragma unroll
    for (int c = 0; c < kHalves; ++c)
      tma::load_3d(sV + slot * BKV * D + c * BKV * 64, &maps.v, hk * D + c * 64, i * BKV, b,
                   full);
  };

  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      tma::bar_expect(&bar.q[w], static_cast<uint32_t>(S::kQTile));
#pragma unroll
      for (int c = 0; c < kHalves; ++c)
        tma::load_2d(sQ + w * 64 * D + c * 64 * 64, &maps.q, h * D + c * 64, q_row0 + 64 * w,
                     &bar.q[w]);
    }
    load_k(0);
    for (int j = 0; j < n_tiles; ++j) {
      if (j + 1 < n_tiles) load_k(j + 1);
      if (!(tail && j == n_tiles - 1)) load_v(j, &bar.full_v[j % kS]);
    }
  }
  __syncwarp();
  if (tail) {
    const int j = n_tiles - 1, slot = j % kS;
    if (lane == 0) load_v(j, bar.tail);
    bar_wait_bounded(bar.tail, 0);
    ws::zero_rows<D, BKV>(sV + slot * BKV * D, kvl - j * BKV);
    if (lane == 0) bar_arrive(&bar.full_v[slot]);
  }
}

// A consumer warpgroup (w = 0, 1): q rows [q_start + 64w, q_start + 64w + 64).
template <int D, bool kLse>
__device__ __forceinline__ void consume(const Args& a, bf16* sQ, const bf16* sK, const bf16* sV,
                                        const ws::Bars<Smem<D>::kStages>& bar, int w, int b, int h,
                                        int q_start, int n_tiles, int kvl) {
  constexpr int kS = Smem<D>::kStages;
  const int tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4;
  const int row0 = q_start + 64 * w;
  const int first_row = row0 + a.q_offset;
  // Interior tiles: every key at or below this warpgroup's first row and inside kvl.
  int n_full = a.causal ? (first_row > 0 ? first_row / BKV : 0) : n_tiles;
  n_full = min(min(n_full, kvl / BKV), n_tiles);
  const int row_abs0 = first_row + warp * 16 + g;

  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n_tiles > 0) {
    bf16* q_t = sQ + w * 64 * D;
    bar_wait_bounded(&bar.q[w], 0);
    ws::scale_q<D>(q_t, a.scale, w);

    float s[BKV / 8][4];
    uint32_t pa[BKV / 16][4];
    float alpha[2];

    // Tile 0: S(0) and its softmax.
    bar_wait_bounded(&bar.full_k[0], 0);
    wgmma_fence();
    ws::s_product<D, BKV>(s, q_t, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) bar_arrive(&bar.empty_k[0]);
    ws::softmax<BKV>(s, m, l, alpha, 0 >= n_full, 0, row_abs0, kvl, a.causal);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) repack(pa[kk], s, kk);

    // Tile j: S(j) issued with O += P(j-1) V(j-1); the softmax of S(j) while
    // the PV product runs; O rescaled once it has landed.
    for (int j = 1; j < n_tiles; ++j) {
      const int sk = j % kS, sv = (j - 1) % kS;
      bar_wait_bounded(&bar.full_k[sk], (j / kS) & 1);
      bar_wait_bounded(&bar.full_v[sv], ((j - 1) / kS) & 1);
      wgmma_fence();
      ws::s_product<D, BKV>(s, q_t, sK + sk * BKV * D);
      wgmma_commit();
      ws::pv_product<D, BKV>(o, pa, sV + sv * BKV * D);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) bar_arrive(&bar.empty_k[sk]);
      ws::softmax<BKV>(s, m, l, alpha, j >= n_full, j * BKV, row_abs0, kvl, a.causal);
      wgmma_wait<0>();
      fence_regs(o);
      ws::fence_pa(pa);
      if (lane == 0) bar_arrive(&bar.empty_v[sv]);
      ws::rescale(o, alpha);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) repack(pa[kk], s, kk);
    }

    // The last PV product.
    const int sv = (n_tiles - 1) % kS;
    bar_wait_bounded(&bar.full_v[sv], ((n_tiles - 1) / kS) & 1);
    wgmma_fence();
    ws::pv_product<D, BKV>(o, pa, sV + sv * BKV * D);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  // out = O / l and lse = m + log(l); rows past Sq are not stored.
  bf16* out_bh = a.out + b * a.out_b + h * a.out_h;
  ws::store_rows<D>(o, m, l, row0, a.Sq,
                    [&](int qr) { return out_bh + qr * a.out_s; },
                    kLse ? a.lse + (static_cast<size_t>(b) * a.Hq + h) * a.Sq : nullptr);
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_stream_kernel(const Args a, const __grid_constant__ Maps maps) {
  using S = Smem<D>;
  constexpr int kS = S::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + S::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::kV);
  const ws::Bars<kS> bar(reinterpret_cast<uint64_t*>(smem + S::kBars));

  // Block -> (q tile, batch, head): heads fastest, the heaviest q tiles first.
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int h = blockIdx.x % a.Hq;
  const int rest = blockIdx.x / a.Hq;
  const int b = rest % a.B;
  const int qt = n_qt - 1 - rest / a.B;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_start = qt * BQ;

  const int kvl = min(a.kv_len_arr != nullptr ? a.kv_len_arr[b] : a.kv_len_scalar, a.Skv);
  int tokens = kvl;
  if (a.causal) tokens = min(tokens, q_start + a.q_offset + BQ);
  const int n_tiles = tokens > 0 ? (tokens + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) bar.init();
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    ws::setmaxnreg_dec<ws::kProducerRegs>();
    if (threadIdx.x < 32 && n_tiles > 0)
      produce<D>(maps, sQ, sK, sV, bar, b, h, hk, b * a.Sq + q_start, n_tiles, kvl);
    return;
  }
  ws::setmaxnreg_inc<ws::kConsumerRegs>();
  consume<D, kLse>(a, sQ, sK, sV, bar, wg - 1, b, h, q_start, n_tiles, kvl);
}

template <int D, bool kLse>
cudaError_t launch_d(const Args& a, const Maps& maps, cudaStream_t s) {
  constexpr size_t smem = Smem<D>::kBytes;
  auto kernel = flash_stream_kernel<D, kLse>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((a.Sq + BQ - 1) / BQ) * a.Hq * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a, maps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const Args& a, cudaStream_t s) {
  Maps maps{};  // with no key (Skv 0) no block loads a tile
  const uint64_t q_cols = static_cast<uint64_t>(a.Hq) * D, kv_cols = uint64_t(a.Hkv) * D;
  cudaError_t err = tma::map_2d(&maps.q, q, static_cast<uint64_t>(a.B) * a.Sq, q_cols, q_cols, 64);
  if (err == cudaSuccess && a.Skv > 0)
    err = tma::map_3d(&maps.k, k, a.B, a.Skv, kv_cols, kv_cols, kv_cols * a.Skv, BKV);
  if (err == cudaSuccess && a.Skv > 0)
    err = tma::map_3d(&maps.v, v, a.B, a.Skv, kv_cols, kv_cols, kv_cols * a.Skv, BKV);
  if (err != cudaSuccess) return err;
  return a.lse != nullptr ? launch_d<D, true>(a, maps, s) : launch_d<D, false>(a, maps, s);
}

}  // namespace stream

// q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D], all contiguous bf16. out: bf16
// [B, Sq, Hq, D] in either layout, its batch, row and head strides (in
// elements) out_b, out_s, out_h: bhsd ([B, Hq, Sq, D]) is the one ring
// attention merges, head-major. lse is an fp32 [B, Hq, Sq] output, or null
// for the instance without it. kv_len is a [B] int32 device array, or null
// to use kv_len_scalar for every sequence. D in {64, 128}; Hq a multiple of
// Hkv. A negative q_offset or a kv_len of 0 leaves a block no tile: its rows
// give 0 and lse -inf.
extern "C" int mlio_flash_stream(const void* q, const void* k, const void* v, void* out,
                                 float* lse, const int* kv_len, int kv_len_scalar, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, int q_offset, float scale,
                                 int causal, long long out_b, long long out_s, long long out_h,
                                 void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Skv < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const stream::Args a{static_cast<__nv_bfloat16*>(out), lse, kv_len, kv_len_scalar, B, Sq, Skv,
                       Hq, Hkv, q_offset, causal, scale, out_b, out_s, out_h};
  if (D == 64) return stream::launch<64>(q, k, v, a, s);
  if (D == 128) return stream::launch<128>(q, k, v, a, s);
  return cudaErrorInvalidValue;
}
