// K1 at head dim 256 (Gemma): the causal/kv_len flash attention forward on
// K10's warp-specialised body (flash_ws.cuh), for Hopper.
//
// Replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel (:37, its
// pallas_call at :867) at head dim 256, the call gemma-7b's prefill makes
// through ops.flash_attention: no user mask, dropout, lse or INT8 cache
// (those raise at this head dim before any launch). q [B, Sq, Hq, 256],
// k/v [B, Skv, Hkv, 256] and out [B, Sq, Hq, 256], each in the bshd or the
// bhsd layout by its strides:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale) @ v[b, j, h/G]
// over keys j < kv_len[b] and, when causal, j <= i + q_offset; a row with no
// valid key gives 0.
//
// Bound, at gemma-7b's prefill (8 x 704 queries into a 1024-slot cache
// holding 704 tokens, 16 heads of 256, causal): 4 x 256 x 16 x 8 x 248,160
// causal pairs = 32.5 GFLOP, 33 us at 989 TFLOP/s, against 185 MB of q,
// out and the valid K/V rows, 59 us at K14's ~3.1 TB/s: bytes, by less
// than 2x. So the kernel has to keep both near their peaks at once, with
// each K/V byte coming from device memory about once.
//
// The earlier instance (flash_fwd.cuh's one warpgroup of 64 q rows
// stretched to 256 columns) ran 0.3026 ms, 107 TFLOP/s, 3.1x SDPA: its q
// tile and three-stage K/V ring took 224 of the SM's 227 KB, so one block
// of four warps held an SM, spilled at 255 registers, and nothing
// overlapped its softmax, copies and barriers with its products. Here:
// - One block per (128-row q tile, query head, batch): a TMA producer warp
//   and two consumer warpgroups of 64 rows (setmaxnreg 24 / 240: a
//   consumer holds O, 128 fp32 registers a thread, S at 64 keys 32, p 16
//   packed). Both consumers read one K/V ring, so each tile is fetched once
//   for 128 q rows.
// - Shared memory: Q 2 x 32 KB, then 64-key K and V tiles, four 64-column
//   panels of the 128-byte swizzle a tile (one TMA box each), 32 KB each,
//   two stages: 192 KB. K and V have their own full and empty mbarriers
//   and their own producer lane, each refilling its ring's slots as soon
//   as both consumers have released them.
// - The product loop is K10's: S(j) issued with O += P(j-1) V(j-1) (two
//   n128 products), the softmax of S(j) while the PV product runs; every
//   mbarrier wait bounded (tma::bar_wait_bounded).
// - Blocks run in groups of (batch, KV head) pairs, about as many blocks a
//   group as the card has SMs: a group's heaviest q tiles first, then its
//   lighter ones, its pairs next to each other and the query heads of a KV
//   head side by side. The blocks on the card at once share their K/V rows
//   in L2, and the blocks that read one tile of a pair run apart.
// - The maps are 4-D, [D, S, H, B], built on the host from each tensor's
//   byte strides (ops/flash_attention.py::tma_map, which raises on what
//   TMA refuses), so the bhsd layouts need no relayout and a box never
//   runs past a sequence or a batch: rows past Sq or Skv read as zeros.
// - Each consumer stops at its own last row's causal limit and releases the
//   tiles past it unread, so the lighter half of a q tile does no masked
//   tile of the heavier one; a consumer with no row (the ragged last tile:
//   704 is 5.5 tiles of 128) loads no Q, computes and stores nothing, and
//   only releases each tile.
// - Rows between kv_len and Skv arrive as the cache holds them (stale, or
//   NaN): the masked scores ignore K there, and the producer warp zeroes
//   those rows of the last V tile before it hands it over (0 * NaN is NaN).
// - The epilogue divides O by l with one reciprocal a row and an exact
//   correction an element (flash_ws.cuh's div_rn: IEEE division's bits);
//   the 128 divisions a thread cost several percent of the launch.
// On the card (ab_k13.py, NVIDIA H100 80GB HBM3, 700 W) it runs gemma-7b's
// prefill call in 0.126 ms against the earlier 0.300 (2.4x; 258 TFLOP/s),
// 1.30x SDPA's 0.097. At 704 keys a block holds its SM for 2-11 tiles,
// and its Q load, first tiles and output stores leave the SM's tensor
// cores idle, with no second block to fill them (Q and the ring take 192
// of the 227 KB). A persistent grid, a third ring stage, 80- or 32-key
// tiles, stores through the TMA, L2 eviction hints and an L2 prefetch of
// the next wave's Q measured no faster (PERF.md).
//
// Rounding is K1's, so its limits hold unchanged: q * scale in fp32
// rounded to bf16; p rounded to bf16 against the running max of the 64-key
// tiles seen, while l adds the fp32 p; out = O / l. Every output has one
// writer and every sum a fixed order: two launches give the same bits.
#include "flash_ws.cuh"

namespace fwd256 {

using bf16 = __nv_bfloat16;
using gemm::fence_regs;
using gemm::repack;
using gemm::wgmma_commit;
using gemm::wgmma_fence;
using gemm::wgmma_wait;
using gemm::zero;
using tma::bar_arrive;
using tma::bar_wait_bounded;
using ws::kWg;

constexpr int D = 256;
constexpr int BQ = 128;        // q rows a block: two consumers of 64
constexpr int BKV = 64;        // keys a K/V tile
constexpr int kKStages = 2;    // the K ring
constexpr int kVStages = 2;    // the V ring
constexpr int kPanels = D / 64;

using Bars = ws::Bars<kKStages, kVStages>;

struct Smem {
  static constexpr size_t kQTile = size_t(64) * D * 2;    // one consumer's q rows
  static constexpr size_t kKvTile = size_t(BKV) * D * 2;  // one K or V tile
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = 2 * kQTile;
  static constexpr size_t kV = kK + kKStages * kKvTile;
  static constexpr size_t kBars = kV + kVStages * kKvTile;
  static constexpr size_t kBytes = kBars + ws::Bars<kKStages, kVStages>::kCount * 8;
  static_assert(kBytes <= ws::kSmemLimit, "the ring must fit");
};

struct Args {
  bf16* out;
  const int* kv_len_arr;
  int kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset, causal;
  int group;  // (batch, KV head) pairs whose blocks run as one group
  float scale;
  long long out_b, out_s, out_h;  // out's batch, row and head strides (bshd or bhsd)
};

// q, k and v as 4-D maps [D, S, H, B]: q in [64 x 64] boxes, k and v in
// [64 x BKV] boxes, the 128-byte swizzle.
struct Maps {
  CUtensorMap q, k, v;
};

// The tiles consumer rows [row0, row0 + 64) need: the keys below kv_len
// and, under causality, at or below its last row + q_offset; -1 for a
// consumer with no row below Sq. Mirrored by ops/flash_attention.py::
// d256_consumer.
__device__ __forceinline__ int consumer_tiles(const Args& a, int kvl, int row0) {
  const int rows = min(64, a.Sq - row0);
  if (rows <= 0) return -1;
  int tokens = kvl;
  if (a.causal) tokens = min(tokens, row0 + rows + a.q_offset);
  return tokens > 0 ? (tokens + BKV - 1) / BKV : 0;
}

// The producer warp: lane 0 asks for the Q of each consumer that has
// tiles, then the K tiles; lane 1 the V tiles. Each lane refills a slot of
// its ring as soon as both consumers have released it, neither waiting on
// the other's ring. The last V tile, where it holds rows past kv_len, lands
// on its own barrier and the warp zeroes those rows before it hands the
// tile over.
__device__ __forceinline__ void produce(const Maps& maps, bf16* sQ, bf16* sK, bf16* sV,
                                        const Bars& bar, int b, int h, int hk, int q_start,
                                        int n0, int n1, int n_tiles, int kvl) {
  const int lane = threadIdx.x % 32;
  const bool tail = n_tiles * BKV > kvl;

  auto load_kv = [&](const CUtensorMap* map, bf16* ring, int stages, uint64_t* empty, int i,
                     uint64_t* full) {
    const int slot = i % stages;
    if (i >= stages) bar_wait_bounded(&empty[slot], ((i / stages) + 1) & 1);
    tma::bar_expect(full, static_cast<uint32_t>(Smem::kKvTile));
#pragma unroll
    for (int c = 0; c < kPanels; ++c)
      tma::load_4d(ring + slot * BKV * D + c * BKV * 64, map, c * 64, i * BKV, hk, b, full);
  };

  if (lane == 0) {  // Q, then the K ring
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      if ((w ? n1 : n0) <= 0) continue;
      tma::bar_expect(&bar.q[w], static_cast<uint32_t>(Smem::kQTile));
#pragma unroll
      for (int c = 0; c < kPanels; ++c)
        tma::load_4d(sQ + w * 64 * D + c * 64 * 64, &maps.q, c * 64, q_start + 64 * w, h, b,
                     &bar.q[w]);
    }
    for (int j = 0; j < n_tiles; ++j)
      load_kv(&maps.k, sK, kKStages, bar.empty_k, j, &bar.full_k[j % kKStages]);
  } else if (lane == 1) {  // the V ring: each ring's slots refilled as soon as they are free
    for (int j = 0; j < n_tiles - (tail ? 1 : 0); ++j)
      load_kv(&maps.v, sV, kVStages, bar.empty_v, j, &bar.full_v[j % kVStages]);
  }
  __syncwarp();
  if (tail) {
    const int j = n_tiles - 1, slot = j % kVStages;
    if (lane == 1) load_kv(&maps.v, sV, kVStages, bar.empty_v, j, bar.tail);
    bar_wait_bounded(bar.tail, 0);
    ws::zero_rows<D, BKV>(sV + slot * BKV * D, kvl - j * BKV);
    if (lane == 1) bar_arrive(&bar.full_v[slot]);
  }
}

// Consumer w (0, 1): q rows [row0, row0 + 64), its n tiles of the block's
// n_tiles (n < 0: no row). Every tile of the block is released by every
// consumer warp, read or not, so each slot's empty barrier counts its eight
// releases a tile.
__device__ __forceinline__ void consume(const Args& a, bf16* sQ, const bf16* sK, const bf16* sV,
                                        const Bars& bar, int w, int b, int h, int row0, int n,
                                        int n_tiles, int kvl) {
  const int tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4;
  const int first_row = row0 + a.q_offset;
  // Interior tiles: every key at or below this warpgroup's first row and inside kvl.
  int n_full = a.causal ? (first_row > 0 ? first_row / BKV : 0) : n;
  n_full = min(min(n_full, kvl / BKV), n);
  const int row_abs0 = first_row + warp * 16 + g;

  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n > 0) {
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
    for (int j = 1; j < n; ++j) {
      const int sk = j % kKStages, sv = (j - 1) % kVStages;
      bar_wait_bounded(&bar.full_k[sk], (j / kKStages) & 1);
      bar_wait_bounded(&bar.full_v[sv], ((j - 1) / kVStages) & 1);
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
    const int sv = (n - 1) % kVStages;
    bar_wait_bounded(&bar.full_v[sv], ((n - 1) / kVStages) & 1);
    wgmma_fence();
    ws::pv_product<D, BKV>(o, pa, sV + sv * BKV * D);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) bar_arrive(&bar.empty_v[sv]);
  }
  // The tiles past this consumer's rows: released unread, each once it has
  // landed (a release before would count towards the slot's previous tile).
  for (int j = max(n, 0); j < n_tiles; ++j) {
    bar_wait_bounded(&bar.full_k[j % kKStages], (j / kKStages) & 1);
    if (lane == 0) bar_arrive(&bar.empty_k[j % kKStages]);
    bar_wait_bounded(&bar.full_v[j % kVStages], (j / kVStages) & 1);
    if (lane == 0) bar_arrive(&bar.empty_v[j % kVStages]);
  }

  // out = O / l; rows past Sq are not stored, a consumer with no row stores nothing.
  if (n < 0) return;
  bf16* out_bh = a.out + b * a.out_b + h * a.out_h;
  ws::store_rows<D>(o, m, l, row0, a.Sq, [&](int qr) { return out_bh + qr * a.out_s; },
                    nullptr);
}

__global__ void __launch_bounds__(ws::kThreads, 1)
flash_fwd_d256_kernel(const Args a, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + Smem::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + Smem::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + Smem::kV);
  const Bars bar(reinterpret_cast<uint64_t*>(smem + Smem::kBars));

  // Block -> a group of a.group (batch, KV head) pairs slowest, then the q
  // tiles heaviest first, then the group's pairs, the G query heads of a
  // KV head fastest (ops/flash_attention.py::d256_blocks).
  const int n_qt = (a.Sq + BQ - 1) / BQ, G = a.Hq / a.Hkv, per = G * n_qt;
  const int grp = blockIdx.x / (a.group * per);
  const int pairs = min(a.group, a.B * a.Hkv - grp * a.group);  // the group's
  const int r = blockIdx.x - grp * a.group * per;
  const int pair = grp * a.group + r % (pairs * G) / G;
  const int hk = pair % a.Hkv, b = pair / a.Hkv;
  const int h = hk * G + r % G;
  const int q_start = (n_qt - 1 - r / (pairs * G)) * BQ;

  const int kvl = min(a.kv_len_arr != nullptr ? a.kv_len_arr[b] : a.kv_len_scalar, a.Skv);
  const int n0 = consumer_tiles(a, kvl, q_start), n1 = consumer_tiles(a, kvl, q_start + 64);
  const int n_tiles = max(n0, n1);  // consumer 0 always has a row

  if (threadIdx.x == 0) bar.init();
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    ws::setmaxnreg_dec<ws::kProducerRegs>();
    if (threadIdx.x < 32 && n_tiles > 0)
      produce(maps, sQ, sK, sV, bar, b, h, hk, q_start, n0, n1, n_tiles, kvl);
    return;
  }
  ws::setmaxnreg_inc<ws::kConsumerRegs>();
  consume(a, sQ, sK, sV, bar, wg - 1, b, h, q_start + 64 * (wg - 1), wg == 1 ? n0 : n1, n_tiles,
          kvl);
}

}  // namespace fwd256

// q [B, Sq, Hq, 256], k/v [B, Skv, Hkv, 256], out [B, Sq, Hq, 256], bf16,
// each by its strides. geo (a host array of 33) holds the maps of q, k and
// v, 11 values each: the dims [D, S, H, B], the byte strides of S, H and B,
// and the box (ops/flash_attention.py::tma_map); out_strides (3) out's
// batch, row and head strides in elements. kv_len a [B] int32 device array,
// or null to use kv_len_scalar for every sequence. Hq a multiple of Hkv. A
// negative q_offset or a kv_len of 0 leaves a row no key: it gives 0.
extern "C" int mlio_flash_fwd_d256(const void* q, const void* k, const void* v, void* out,
                                   const int* kv_len, const long long* geo,
                                   const long long* out_strides, int kv_len_scalar, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int q_offset, float scale,
                                   int causal, void* stream) {
  using namespace fwd256;
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Skv < 0) return cudaErrorInvalidValue;
  Maps maps{};  // with no key (Skv 0) no block loads a K/V tile
  cudaError_t err = tma::map_4d(&maps.q, q, geo, geo + 4, geo + 7, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && Skv > 0)
    err = tma::map_4d(&maps.k, k, geo + 11, geo + 15, geo + 18, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && Skv > 0)
    err = tma::map_4d(&maps.v, v, geo + 22, geo + 26, geo + 29, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // a group's blocks about the SMs' number: its pairs' K/V in L2 together
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int per = (Sq + BQ - 1) / BQ * (Hq / Hkv);
  const Args a{static_cast<bf16*>(out), kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset,
               causal, sms / per > 1 ? sms / per : 1, scale, out_strides[0], out_strides[1],
               out_strides[2]};
  auto kernel = flash_fwd_d256_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem::kBytes));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * Hq * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), ws::kThreads, Smem::kBytes,
           static_cast<cudaStream_t>(stream)>>>(a, maps);
  return cudaGetLastError();
}
