// K12: fused norm + matmul (the fused LayerNorm/RMSNorm + QKV projection),
// for Hopper.
//
// Replaces mlio_tpu/ops/ln_qkv.py::_ln_matmul_kernel (:25, its pallas_call at
// :88). x [M, H] bf16, W = [W1 | W2 | W3] [H, N] bf16 given as up to three
// row-major matrices (Wq, Wk, Wv; GQA by their widths), out [M, N] bf16:
//   xn  = ((x - mean) * rsqrt(var + eps)) * scale (+ bias)     layernorm
//   xn  = (x * rsqrt(mean(x^2) + eps)) * scale (+ bias)        rmsnorm
//   out = round(round(xn) @ W)
// with fp32 statistics (two-pass variance), xn rounded to bf16 before the
// product (ln_qkv.py:43) and an fp32 sum.
//
// Bound: operations. At GPT-2's QKV (M 5,632, H 768, N 2,304) 19.9 GFLOP
// (20 us at 989 TFLOP/s, H100 SXM) against 38 MB (12 us at ~3.1 TB/s); at
// llama3-8b's (M 2,048, H 4,096, N 6,144) 103 GFLOP (104 us) against 92 MB
// (29 us). So the tensor cores must run near their rate, and the norm and
// the loads must stay out of their way. The earlier kernel (mma.sync
// on gemm_tile.cuh's loop) ran 66 TFLOP/s at GPT-2's QKV. What held it
// back, and what this design does about each:
// - Little work between barriers (32-deep K tiles, two k16 steps a warp a
//   barrier): here the K tiles are 64 deep, one 128-byte swizzle atom of x,
//   and a block's 128 x 256 output tile makes each barrier enclose four k16
//   steps of two m64n128 products a warpgroup.
// - A double buffer staged through registers, with the norm on the critical
//   path after each tile's products and scale and bias re-read from device
//   memory for every chunk: here the x and W tiles come through a four-stage
//   ring (three tiles in flight) and tile t + 1 is normalised while tile t's
//   products run. Scale and bias are staged in shared memory once a block
//   where their 4 H bytes fit beside the ring (H up to 8,952), else read from
//   device memory; either way each thread fetches its 8 columns a step ahead
//   of their use.
// - mma.sync through ldmatrix: here the products are wgmma (wgmma.cuh), two
//   consumer warpgroups each owning 64 rows of the 128-row block tile, A
//   and B both read by the tensor cores from the swizzled slots. W, [H, N]
//   row-major, is the MN-major B (gemm::mnmajor). x lands raw and each
//   thread normalises the chunks of it that it is assigned in place,
//   (x - mean) * rstd * scale (+ bias) in fp32, rounded to bf16, before the
//   fence and barrier that hand the slot to the products; each row's mean
//   and rstd stay in registers.
// - The loads: where x's rows are a multiple of 8 elements and every part
//   of W is a multiple of 64 columns wide (GPT-2's and Llama's QKV), one
//   thread asks the TMA (tma.cuh) for each tile, x as one [128 x 64] box and
//   W as [64 x 64] boxes, each inside one part, swizzled by the hardware and
//   zero-filled past M, N and H, counted on the slot's barrier. On the card
//   (NVIDIA H100 80GB HBM3, 700 W) the same kernel with every thread copying
//   16-byte chunks by cp.async took about twice as long (PERF.md, Findings):
//   the copies, not the products, set its pace. Other shapes take that
//   cp.async path, filling the slots element by element from registers
//   where a row does not allow 16-byte copies. The shape alone chooses the
//   path: a tensor map that the driver refuses is returned as an error.
// - Two launches: a first launch computes every row's fp32 statistics
//   (mean and rstd, a warp a row, 8 bytes a row), a few microseconds at
//   GPT-2's shape. It stays: the TPU kernel normalises a row tile once into
//   scratch at its first column step, relying on its grid running in order;
//   blocks here run in parallel, and recomputing a row tile's statistics in
//   each of its column blocks cost more (an earlier version: 0.43 ms).
// The output tile goes out through shared memory in 16-byte row chunks.
// Blocks walk the row tiles fastest, so that the blocks in flight share one
// band of W's columns in L2. Every output element has one writer: no
// atomics. The columns of W come from whichever of the three matrices holds
// them (each part read in place, never concatenated).
#include "cp_async.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using gemm::at_sw128;
using gemm::bf16;
using gemm::cp_async16;
using gemm::cp_commit;
using gemm::cp_wait;
using gemm::fence_proxy_async;
using gemm::fence_regs;
using gemm::kmajor;
using gemm::load8;
using gemm::mnmajor;
using gemm::pack_bf16;
using gemm::wgmma_commit;
using gemm::wgmma_fence;
using gemm::wgmma_ss_n128;
using gemm::wgmma_wait;
using gemm::zero;

constexpr int kStatThreads = gemm::kThreads;  // row_stats_kernel: a warp a row
constexpr int BM = 128;        // rows a block: two consumer warpgroups of 64
constexpr int BN = 256;        // columns a block (128 ran 1.4-1.5x slower: PERF.md)
constexpr int BKT = 64;        // K depth of a tile
constexpr int kStages = 4;     // the ring
constexpr int kThreads = 256;  // two warpgroups
constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory a block may have (227 KB)

// A stage: the x tile [128 x 64] (raw, then normalised in place) and the W
// tile [64 x BN]; each 1 KB aligned. Then the TMA path's barriers, a slot
// each, and where they fit (norm_bytes), the staged scale and bias.
struct Smem {
  static constexpr size_t kXTile = size_t(BM) * BKT * 2;
  static constexpr size_t kWTile = size_t(BKT) * BN * 2;
  static constexpr size_t kX = 0;
  static constexpr size_t kW = kX + kStages * kXTile;
  static constexpr size_t kBars = kW + kStages * kWTile;
  static constexpr size_t kBytes = kBars + kStages * sizeof(uint64_t);
};
constexpr int kOutPitch = BN + 8;  // the output tile's row pitch in shared memory (bf16)
static_assert(size_t(BM) * kOutPitch * 2 <= Smem::kBars, "the output tile fits in the ring");

struct Weights {
  const bf16* w[3];
  int n1, n12, N;  // column where W2 starts, where W3 starts, and the width
  bool vec;        // every part's rows allow 16-byte copies, chunks never straddle parts

  // The part holding column n, its first column and its width.
  __device__ __forceinline__ int part(int n, int& base, int& width) const {
    const int p = n < n1 ? 0 : (n < n12 ? 1 : 2);
    base = p == 0 ? 0 : (p == 1 ? n1 : n12);
    width = p == 0 ? n1 : (p == 1 ? n12 - n1 : N - n12);
    return p;
  }

  // 8 columns of row k from column n into a 16-byte slot, element by element
  // through registers (where the parts' widths allow no 16-byte copies),
  // zeros past the edges.
  __device__ __forceinline__ void fill8(bf16* dst, int k, int n, int H) const {
    uint4 v = make_uint4(0, 0, 0, 0);
    bf16* e = reinterpret_cast<bf16*>(&v);
    for (int i = 0; k < H && i < 8 && n + i < N; ++i) {
      int base, width;
      const int p = part(n + i, base, width);
      e[i] = w[p][static_cast<size_t>(k) * width + n + i - base];
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

// Start the copy of 8 elements of a row from column c into a 16-byte slot,
// zeros past the row's end (cols) or where !row_ok: one cp.async where vec
// allows it, else element by element through registers. `any` is a valid
// address for the zero fill.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* row, int c, int cols, bool row_ok,
                                      bool vec, const bf16* any) {
  const bool ok = row_ok && c < cols;
  if (!ok || (vec && c + 8 <= cols)) {
    cp_async16(dst, ok ? row + c : any, ok);
    return;
  }
  uint4 v = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&v);
  for (int i = 0; i < 8 && c + i < cols; ++i) e[i] = row[c + i];
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row statistics, a warp a row: stats[2m] = mean (0 for RMSNorm), stats[2m + 1]
// = rsqrt(var + eps) with the two-pass variance (or rsqrt(mean(x^2) + eps)).
__global__ void __launch_bounds__(kStatThreads)
row_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int M, int H, int rms,
                 float eps, int vec_x) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (kStatThreads / 32) + (threadIdx.x >> 5);
  if (m >= M) return;
  float mean = 0.f;
  if (!rms) {
    float s = 0.f;
#pragma unroll 4
    for (int c = lane * 8; c < H; c += 32 * 8) {
      float f[8];
      unpack_vec<bf16>(load8(x, H, m, c, M, H, vec_x), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    mean = warp_sum(s) / static_cast<float>(H);
  }
  float sq = 0.f;
#pragma unroll 4
  for (int c = lane * 8; c < H; c += 32 * 8) {
    float f[8];
    unpack_vec<bf16>(load8(x, H, m, c, M, H, vec_x), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = c + i < H ? f[i] - mean : 0.f;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(H) + eps);
  if (lane == 0) {
    stats[2 * static_cast<size_t>(m)] = mean;
    stats[2 * static_cast<size_t>(m) + 1] = rstd;
  }
}

struct MmArgs {
  const bf16* x;
  const bf16* scale;
  const bf16* bias;  // null: no norm bias
  Weights W;
  const float* stats;
  bf16* out;
  int M, H, vec_x;
  int stage_norm;  // scale and bias are staged in shared memory at Smem::kBytes (norm_bytes)
};

// Bytes of the staged scale and bias: H rounded up to 8, twice.
__host__ __device__ inline size_t norm_bytes(int H) { return 2 * size_t((H + 7) / 8 * 8) * 2; }

// What a thread copies and normalises, fixed for the whole k loop: x chunk
// (row tid / 8 + 32 i, column chunk tid % 8) for i < 4 and W chunk (row
// tid / 32 + 8 i, column chunk tid % 32) for i < 8 of every tile, so each
// thread's W columns, and so its part of W, never change.
struct Lanes {
  const bf16* x_row[BM * BKT / 8 / kThreads];  // its x rows (row 0 past M)
  bool x_ok[BM * BKT / 8 / kThreads];
  const bf16* w_col;  // its W part at its first column (vec), or null past N
  int w_width;        // that part's row length
  float mean[BM * BKT / 8 / kThreads], rstd[BM * BKT / 8 / kThreads];
};

// The TMA path's tensor maps: x in boxes of [128 rows, 64 columns], each
// part of W in boxes of [64 rows, 64 columns].
struct Maps {
  CUtensorMap x, w[3];
};

// Start the copies of K tile t (x columns and W rows 64t .. 64t + 63) into
// ring slot t % kStages. kTma: thread 0 asks the TMA for the x box and the
// W boxes inside N, counted on the slot's barrier (each W box lies in one
// part: the parts' widths are multiples of 64). Otherwise every thread
// copies its chunks with cp.async as one commit group (and commits, copies
// or not).
template <bool kTma>
__device__ __forceinline__ void load_tile(const MmArgs& a, const Maps& maps, const Lanes& ln,
                                          unsigned char* smem, uint64_t* bars, int t, int nt,
                                          int m0, int n0) {
  if constexpr (kTma) {
    if (threadIdx.x == 0 && t < nt) {
      const int slot = t % kStages, k0 = t * BKT;
      unsigned char* sw = smem + Smem::kW + slot * Smem::kWTile;
      const int boxes = min(BN / 64, (a.W.N - n0 + 63) / 64);
      tma::bar_expect(&bars[slot], static_cast<uint32_t>(Smem::kXTile + boxes * 64 * 64 * 2));
      tma::load_2d(smem + Smem::kX + slot * Smem::kXTile, &maps.x, k0, m0, &bars[slot]);
      for (int j = 0; j < boxes; ++j) {
        int base, width;
        const int p = a.W.part(n0 + 64 * j, base, width);
        tma::load_2d(sw + j * 64 * 64 * 2, &maps.w[p], n0 + 64 * j - base, k0, &bars[slot]);
      }
    }
    return;
  }
  if (t < nt) {
    const int slot = t % kStages, k0 = t * BKT, tid = threadIdx.x;
    bf16* sx = reinterpret_cast<bf16*>(smem + Smem::kX + slot * Smem::kXTile);
    bf16* sw = reinterpret_cast<bf16*>(smem + Smem::kW + slot * Smem::kWTile);
    const int xc = tid % 8;
#pragma unroll
    for (int i = 0; i < BM * BKT / 8 / kThreads; ++i)
      copy8(at_sw128(sx, tid / 8 + 32 * i, xc * 8), ln.x_row[i], k0 + xc * 8, a.H, ln.x_ok[i],
            a.vec_x, a.x);
    const int wc = tid % (BN / 8);
#pragma unroll
    for (int i = 0; i < BKT * BN / 8 / kThreads; ++i) {
      const int r = tid / (BN / 8) + (kThreads / (BN / 8)) * i, k = k0 + r;
      bf16* dst = at_sw128(sw, r, wc * 8);
      if (a.W.vec) {
        const bool ok = ln.w_col != nullptr && k < a.H;
        cp_async16(dst, ok ? ln.w_col + static_cast<size_t>(k) * ln.w_width : a.W.w[0], ok);
      } else {
        a.W.fill8(dst, k, n0 + wc * 8, a.H);
      }
    }
  }
  cp_commit();
}

// The scale and bias of this thread's 8 columns of K tile t (zeros past
// cols), fetched a step before normalise needs them: from their copy in
// shared memory (zero-padded to a multiple of 8) where one was staged, else
// from device memory.
struct NormCols {
  const bf16* scale_src;
  const bf16* bias_src;  // null: no bias
  int cols, vec;
  uint4 scale, bias;

  __device__ __forceinline__ void fetch(int t) {
    const int c0 = t * BKT + (threadIdx.x % 8) * 8;
    scale = load8(scale_src, 0, 0, c0, 1, cols, vec);
    bias = bias_src != nullptr ? load8(bias_src, 0, 0, c0, 1, cols, vec) : make_uint4(0, 0, 0, 0);
  }
};

// Normalise in place the x chunks of tile t this thread copied (they have
// landed): (x - mean) * rstd * scale (+ bias) in fp32, rounded to bf16, the
// order of the plain version. Columns past H have zero scale and bias.
__device__ __forceinline__ void normalise(const Lanes& ln, const NormCols& cols,
                                          unsigned char* smem, int t) {
  const int tid = threadIdx.x;
  bf16* sx = reinterpret_cast<bf16*>(smem + Smem::kX + (t % kStages) * Smem::kXTile);
  float sc[8], bi[8];
  unpack_vec<bf16>(cols.scale, sc);
  unpack_vec<bf16>(cols.bias, bi);
#pragma unroll
  for (int i = 0; i < BM * BKT / 8 / kThreads; ++i) {
    bf16* p = at_sw128(sx, tid / 8 + 32 * i, (tid % 8) * 8);
    float f[8];
    load_vec(p, f);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], ln.mean[i]), ln.rstd[i]), sc[e]),
                       bi[e]);
    store_vec(p, f);
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_kernel(const MmArgs a, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Smem::kBars);  // kTma: one a ring slot
  // Block -> (row tile, column block): row tiles fastest.
  const int n_mb = (a.M + BM - 1) / BM;
  const int m0 = (blockIdx.x % n_mb) * BM, n0 = (blockIdx.x / n_mb) * BN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nt = (a.H + BKT - 1) / BKT;

  Lanes ln;
#pragma unroll
  for (int i = 0; i < BM * BKT / 8 / kThreads; ++i) {  // rows past M normalise to 0 * scale + bias
    const int m = m0 + tid / 8 + 32 * i;
    ln.x_ok[i] = m < a.M;
    ln.x_row[i] = a.x + static_cast<size_t>(ln.x_ok[i] ? m : 0) * a.H;
    ln.mean[i] = ln.x_ok[i] ? a.stats[2 * static_cast<size_t>(m)] : 0.f;
    ln.rstd[i] = ln.x_ok[i] ? a.stats[2 * static_cast<size_t>(m) + 1] : 0.f;
  }
  {
    const int n = n0 + (tid % (BN / 8)) * 8;
    int base = 0, width = 0;
    const int p = n < a.W.N ? a.W.part(n, base, width) : 0;
    ln.w_col = n < a.W.N ? a.W.w[p] + (n - base) : nullptr;
    ln.w_width = width;
  }

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) tma::bar_init(&bars[s]);
      tma::bar_init_fence();
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_tile<kTma>(a, maps, ln, smem, bars, t, nt, m0, n0);
  float acc[BN / 128][16][4];  // [128-column half][n-tile of 8][row g: 0, 1; row g+8: 2, 3]
#pragma unroll
  for (int hf = 0; hf < BN / 128; ++hf) zero(acc[hf]);
  NormCols cols{a.scale, a.bias, a.H, a.vec_x};
  if (a.stage_norm) {  // scale and bias once a block, zero-padded to a multiple of 8
    const int hp = (a.H + 7) / 8 * 8;
    bf16* ss = reinterpret_cast<bf16*>(smem + Smem::kBytes);
    for (int c = tid * 8; c < hp; c += kThreads * 8) {
      *reinterpret_cast<uint4*>(ss + c) = load8(a.scale, 0, 0, c, 1, a.H, a.vec_x);
      *reinterpret_cast<uint4*>(ss + hp + c) =
          a.bias != nullptr ? load8(a.bias, 0, 0, c, 1, a.H, a.vec_x) : make_uint4(0, 0, 0, 0);
    }
    cols = NormCols{ss, a.bias != nullptr ? ss + hp : nullptr, hp, 1};
    __syncthreads();
  }
  cols.fetch(0);
  // tile 0 landed; the later ones may be in flight
  if constexpr (kTma) {
    if (nt > 0) tma::bar_wait(&bars[0], 0);
  } else {
    cp_wait<kStages - 2>();
  }
  if (nt > 0) normalise(ln, cols, smem, 0);
  cols.fetch(1);
  fence_proxy_async();
  __syncthreads();

  // Step t: tile t's products run while tile t + 1 lands and is normalised.
  // Groups in flight before its wait: tiles t + 1 .. t + kStages - 2, of
  // which it leaves all but t + 1. The slot of tile t - 1 is refilled (with
  // tile t + kStages - 1) once every warp's products of tile t - 1 are done.
  for (int t = 0; t < nt; ++t) {
    const unsigned char* sx = smem + Smem::kX + (t % kStages) * Smem::kXTile;
    const bf16* sw = reinterpret_cast<const bf16*>(smem + Smem::kW + (t % kStages) * Smem::kWTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < BN / 128; ++hf)
        wgmma_ss_n128<1>(acc[hf], kmajor(sx, wg * 64, 16 * kk),
                         mnmajor(sw + hf * 64 * 128, 16 * kk), 1);
    wgmma_commit();
    if constexpr (kTma) {
      if (t + 1 < nt) tma::bar_wait(&bars[(t + 1) % kStages], ((t + 1) / kStages) & 1);
    } else {
      cp_wait<kStages - 3>();
    }
    if (t + 1 < nt) normalise(ln, cols, smem, t + 1);
    cols.fetch(t + 2);
    fence_proxy_async();
    wgmma_wait<1>();  // tile t - 1's products, which read slot (t - 1) % kStages
    __syncthreads();
    load_tile<kTma>(a, maps, ln, smem, bars, t + kStages - 1, nt, m0, n0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int hf = 0; hf < BN / 128; ++hf) fence_regs(acc[hf]);
  cp_wait<0>();

  // The output tile, rounded to bf16, through shared memory (the ring is
  // free once every warp is here), then written a 16-byte chunk of a row a
  // thread: accumulator pairs stored straight from registers cover 16 bytes
  // of 8 rows a warp instruction. The rows are padded by 16 bytes so that
  // those 8 rows fall in distinct banks.
  __syncthreads();
  bf16* so = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = so + (wg * 64 + warp * 16 + g + 8 * i) * kOutPitch;
#pragma unroll
    for (int hf = 0; hf < BN / 128; ++hf)
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<uint32_t*>(row + hf * 128 + n * 8 + 2 * t4) =
            pack_bf16(acc[hf][n][2 * i], acc[hf][n][2 * i + 1]);
  }
  __syncthreads();
  const int N = a.W.N;
  const bool vec_out = N % 8 == 0;
#pragma unroll 4
  for (int c = tid; c < BM * BN / 8; c += kThreads) {
    const int r = c / (BN / 8), n = n0 + (c % (BN / 8)) * 8;
    if (m0 + r >= a.M || n >= N) continue;
    const bf16* src = so + r * kOutPitch + (c % (BN / 8)) * 8;
    bf16* dst = a.out + static_cast<size_t>(m0 + r) * N + n;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

}  // namespace

// x: [M, H] bf16; scale, bias: [H] bf16 (bias may be null); w1, w2, w3:
// [H, n1], [H, n2], [H, n3] bf16 (w2, w3 null where n2, n3 are 0); stats:
// [M, 2] fp32 scratch; out: [M, n1 + n2 + n3] bf16. Pointers 16-byte aligned
// (the wrapper checks); any M, H and widths.
extern "C" int mlio_ln_matmul(const void* x, const void* scale, const void* bias,
                              const void* w1, const void* w2, const void* w3, void* stats,
                              void* out, int M, int H, int n1, int n2, int n3, int rms, float eps,
                              void* stream) {
  const int N = n1 + n2 + n3;
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kStatThreads / 32;
  row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block, kStatThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<float*>(stats), M, H, rms, eps, H % 8 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Weights W;
  W.w[0] = static_cast<const bf16*>(w1);
  W.w[1] = static_cast<const bf16*>(w2);
  W.w[2] = static_cast<const bf16*>(w3);
  W.n1 = n1;
  W.n12 = n1 + n2;
  W.N = N;
  W.vec = n1 % 8 == 0 && n2 % 8 == 0 && n3 % 8 == 0;
  // scale and bias are staged in shared memory where they fit beside the ring
  const size_t staged = Smem::kBytes + norm_bytes(H);
  const bool stage_norm = staged <= kMaxSmem;
  const size_t smem = stage_norm ? staged : Smem::kBytes;
  const MmArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
                 static_cast<const bf16*>(bias), W, static_cast<const float*>(stats),
                 static_cast<bf16*>(out), M, H, H % 8 == 0, stage_norm};
  const long long blocks =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  // The TMA path where every box lies in one part and the rows allow it: x
  // rows of a multiple of 8 elements, part widths multiples of 64.
  const bool tma = H % 8 == 0 && n1 % 64 == 0 && n2 % 64 == 0 && n3 % 64 == 0;
  Maps maps{};
  if (tma) {
    err = tma::map_2d(&maps.x, x, M, H, H, BM);
    const int widths[3] = {n1, n2, n3};
    for (int p = 0; p < 3 && err == cudaSuccess; ++p)
      if (widths[p] > 0) err = tma::map_2d(&maps.w[p], W.w[p], H, widths[p], widths[p], BKT);
    if (err != cudaSuccess) return err;
  }
  auto kernel = tma ? ln_matmul_kernel<true> : ln_matmul_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(a, maps);
  return cudaGetLastError();
}
