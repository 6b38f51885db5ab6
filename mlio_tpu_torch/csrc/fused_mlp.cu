// K11: the fused MLP, for Hopper.
//
// Replaces mlio_tpu/ops/fused_mlp.py::_fused_mlp_kernel (:45, its
// pallas_call at :139). x [M, H], w_up (and w_gate) [H, I], w_down [I, H],
// all bf16:
//   h = x @ w_up (+ b_up), g = x @ w_gate (+ b_gate)       fp32 sums
//   a = act(h[, g]) in fp32, rounded to bf16                (fused_mlp.py:67)
//   out = round(a @ w_down) (+ b_down, added in bf16 after the rounding)
// act: tanh-GELU (gelu_new, gelu_tanh), erf-GELU (gelu), ReLU, SwiGLU
// silu(g) * h, GeGLU tanh-gelu(g) * h.
//
// Bound: operations. At GPT-2's widths (M 5,632, H 768, I 3,072) the two
// products are 53.2 GFLOP, 54 us at 989 TFLOP/s (H100 SXM data sheet),
// against 26.7 MB of inputs and output (8 us at ~3.2 TB/s); at llama3-8b's
// (M 2,048, H 4,096, I 14,336, SwiGLU) 722 GFLOP, 0.73 ms.
//
// What the TPU kernel guarantees, and this one keeps, is that the [M, I]
// activation never goes to device memory: the TPU kernel carries a [bm, H]
// fp32 sum in VMEM across a sequential I axis. That sum does not fit a
// Hopper block at H = 4096, and Hopper's blocks run in parallel, so a block
// here takes one 128-row tile and one chunk of BI columns of I. The earlier
// kernel (64-row tiles, mma.sync on gemm_tile.cuh's loop) ran at about 100
// TFLOP/s at both widths, 7.1x its library call at llama3-8b's. What held it
// back, and what this design does about each:
// - 32-deep K tiles through a register-staged double buffer, every thread
//   copying 16-byte chunks: here 64-deep K tiles come through the ring of
//   gemm_wgmma.cuh, one thread asking the TMA (tma.cuh) for each tile, x as
//   a [128 x 64] box and the weights as [64 x 64] boxes, swizzled by the
//   hardware and zero-filled past M, H and I. Where a row is not a multiple
//   of 8 elements, every thread copies by cp.async (element by element
//   where a row allows no 16-byte copies); the shape alone chooses, and a
//   tensor map the driver refuses is returned as an error.
// - mma.sync through ldmatrix: here wgmma (wgmma.cuh) from shared memory,
//   two consumer warpgroups of 64 rows. Phase 1 (up and gate products) walks
//   H with A the x box and B the weight tile MN-major, a block's pass 256
//   columns of w_up wide (128 of w_up and 128 of w_gate when gated), so each
//   barrier encloses four k16 steps of two m64n128 products a warpgroup. The
//   biases are added in fp32 and the activation applied on the accumulators;
//   the result, rounded to bf16, goes into the warpgroup's activation tile
//   [64 x BI] in shared memory in the swizzled K-major layout that phase 2
//   reads as wgmma's A operand. Phase 2 (the down product) walks H in
//   256-column tiles, w_down's [64 x 256] tiles MN-major through the same
//   ring, each warpgroup summing a 64 x 256 fp32 tile in registers.
// - fp32 atomics for the sum over I chunks (28 an output element at
//   I = 14,336), in whichever order the blocks finished, so that the bf16
//   output could change in its last bit from run to run, then a second
//   launch to round it: here a serial split-K with no atomics, in a fixed
//   order. An fp32 workspace (a 128 x 256 tile per (row tile, H tile), in
//   the accumulators' own order so that a warp moves 512 contiguous bytes;
//   it stays in L2 where it fits) and one int32 ticket per tile, zeroed by
//   the wrapper: chunk c waits until its ticket reads c, adds its partial
//   into the workspace (chunk 0 writes without reading) and sets the ticket
//   to c + 1; the last chunk rounds to bf16, adds b_down in bf16 after the
//   rounding (the JAX order) and writes the output. The chunk index is the
//   slowest part of the block index, so a block waits only on blocks
//   dispatched before it (CUTLASS's serial split-K relies on the same), and
//   its products run before it waits. The output goes from registers
//   straight to device memory: the ring is in use then, and what shared
//   memory is left does not hold a tile.
// - Its activation behind a runtime switch: here the activation is a
//   template parameter (ten instances), and the biases are staged in shared
//   memory once a block. On the card (NVIDIA H100 80GB HBM3, 700 W) the
//   switch made the phase-1 epilogue cost a quarter of the kernel, and a
//   workspace read as [M, H] rows (8 bytes a lane) half of it (PERF.md,
//   Findings).
// Shared memory: the activation tiles take 128 x BI x 2 bytes (64 KB at
// BI 256), a ring stage 48 KB (x's box and a [64 x 256] weight tile): three
// stages. At BI 512 (two stages, half the workspace passes) it ran slower
// at both widths (PERF.md).
#include "gemm_wgmma.cuh"

#include <math.h>

namespace {

using namespace gemm;

constexpr int BI = 256;              // I columns of a block's chunk
constexpr int BH = 256;              // output columns of a down-product tile
constexpr int kPass = 256;           // B columns a phase-1 step (w_up, or w_up | w_gate)
constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory a block may have (227 KB)

// The two warpgroups' activation tiles [64 x BI] bf16, then the ring: a
// stage holds x's box [128 x 64] and a weight tile [64 x 256] (w_up; or
// w_up's 128 columns then w_gate's; or w_down's); each 1 KB aligned. Then
// the TMA path's barriers.
struct Smem {
  static constexpr size_t kAct = size_t(64) * BI * 2;  // a warpgroup's
  static constexpr size_t kXBox = size_t(kBM) * kBK * 2;
  static constexpr size_t kWTile = size_t(kBK) * kPass * 2;
  static constexpr size_t kStage = kXBox + kWTile;
  static constexpr size_t kRing = 2 * kAct;
  // as many stages as fit, up to 4: 3 at BI 256 (2 at 512, 4 at 128)
  static constexpr int kStages = (kMaxSmem - kRing - 64 - 4 * BI) / kStage < 4
                                     ? int((kMaxSmem - kRing - 64 - 4 * BI) / kStage)
                                     : 4;
  static constexpr size_t kBars = kRing + Smem::kStages * kStage;
  static_assert(BI % kPass == 0, "a chunk is whole phase-1 passes");
  static constexpr size_t kBias = kBars + 64;  // b_up's and b_gate's chunk (zeros past I)
  static constexpr size_t kBytes = kBias + 2 * BI * 2;
  static_assert(kBytes <= kMaxSmem, "the activation tiles and the ring fit in shared memory");
};

enum Act { kGeluTanh = 0, kGeluErf = 1, kRelu = 2, kSwiglu = 3, kGeglu = 4 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

// The activation is a template parameter of the kernel: one activation's
// code unrolled over a thread's 128 accumulators is what its epilogue runs
// (with all five behind a runtime switch the epilogue cost more than the
// products of a pass: PERF.md, Findings).
template <int kAct>
__device__ __forceinline__ float activate(float h, float g) {
  if constexpr (kAct == kGeluTanh) return gelu_tanh(h);
  else if constexpr (kAct == kGeluErf) return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
  else if constexpr (kAct == kRelu) return fmaxf(h, 0.f);
  else if constexpr (kAct == kSwiglu) return g / (1.f + expf(-g)) * h;
  else return gelu_tanh(g) * h;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

struct MlpArgs {
  const bf16 *x, *w_up, *w_gate, *w_down, *b_up, *b_gate, *b_down;
  float* ws;     // the sum over the chunks so far: a 128 x 256 fp32 tile a ticket
  int* tickets;  // [row tiles x H tiles], zero at launch
  bf16* out;
  int M, H, I;
};

struct Maps {
  CUtensorMap x, up, gate, down;
};

// A block's stream of tiles: for each phase-1 pass (kPass B columns), the
// H / 64 K tiles of x and the weights; then for each 256-column tile of H,
// the chunk's I / 64 K tiles of w_down.
struct Stream {
  int i0, passes, nk1, nk2, nh, n1, n;
  __device__ __forceinline__ Stream(const MlpArgs& a, int c, bool gated) {
    i0 = c * BI;
    const int width = min(BI, a.I - i0), pw = gated ? kPass / 2 : kPass;
    passes = (width + pw - 1) / pw;
    nk1 = (a.H + kBK - 1) / kBK;
    nk2 = (width + kBK - 1) / kBK;
    nh = (a.H + BH - 1) / BH;
    n1 = passes * nk1;
    n = n1 + nh * nk2;
  }
};

template <bool kTma, int kAct>
__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_kernel(const MlpArgs a, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool kGated = kAct == kSwiglu || kAct == kGeglu;
  constexpr int PW = kGated ? kPass / 2 : kPass;  // I columns a pass
  const int tid = threadIdx.x, wg = tid / 128;
  const int n_mb = (a.M + kBM - 1) / kBM;
  const int mt = blockIdx.x % n_mb, c = blockIdx.x / n_mb;  // the chunk slowest
  const int m0 = mt * kBM;
  const int n_chunks = (a.I + BI - 1) / BI;
  const Stream s(a, c, kGated);
  bf16* act = reinterpret_cast<bf16*>(smem + wg * Smem::kAct);  // this warpgroup's [64 x BI]

  bf16* bias = reinterpret_cast<bf16*>(smem + Smem::kBias);  // [b_up | b_gate] of the chunk
  for (int i = tid; i < BI; i += kWgThreads) {
    const bool in = s.i0 + i < a.I;
    bias[i] = in && a.b_up != nullptr ? a.b_up[s.i0 + i] : __float2bfloat16(0.f);
    bias[BI + i] = in && a.b_gate != nullptr ? a.b_gate[s.i0 + i] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const Ring<Smem::kStages, kTma, false> ring{reinterpret_cast<uint64_t*>(smem + Smem::kBars), s.n};
  ring.init();

  // Tile g into slot g % Smem::kStages: x's box at the stage's start, the weight
  // tile 16 KB on, as 64-column blocks of 8 KB (wholly outside the matrix:
  // not copied; their columns are masked).
  auto load = [&](int g) {
    unsigned char* st = smem + Smem::kRing + (g % Smem::kStages) * Smem::kStage;
    unsigned char* sw = st + Smem::kXBox;
    if constexpr (kTma) {
      if (tid != 0 || g >= s.n) return;
      uint64_t* bar = ring.bars + g % Smem::kStages;
      if (g < s.n1) {
        const int ib = s.i0 + (g / s.nk1) * PW, k0 = (g % s.nk1) * kBK;
        const int boxes = min(PW / 64, (a.I - ib + 63) / 64);
        tma::bar_expect(
            bar, static_cast<uint32_t>(Smem::kXBox + (kGated ? 2 : 1) * boxes * 64 * 64 * 2));
        tma::load_2d(st, &maps.x, k0, m0, bar);
        for (int j = 0; j < boxes; ++j) {
          tma::load_2d(sw + j * 8192, &maps.up, ib + 64 * j, k0, bar);
          if constexpr (kGated)
            tma::load_2d(sw + 16384 + j * 8192, &maps.gate, ib + 64 * j, k0, bar);
        }
      } else {
        const int h0 = ((g - s.n1) / s.nk2) * BH, k0 = s.i0 + ((g - s.n1) % s.nk2) * kBK;
        const int boxes = min(BH / 64, (a.H - h0 + 63) / 64);
        tma::bar_expect(bar, static_cast<uint32_t>(boxes * 64 * 64 * 2));
        for (int j = 0; j < boxes; ++j)
          tma::load_2d(sw + j * 8192, &maps.down, h0 + 64 * j, k0, bar);
      }
      return;
    }
    if (g < s.n) {
      // B tile chunk cc: row cc / 32, columns 8 (cc % 32); its source by phase
      const bf16* src;
      int r0, c0, ld, rows, cols;
      if (g < s.n1) {
        const int ib = s.i0 + (g / s.nk1) * PW, k0 = (g % s.nk1) * kBK;
        // the copy loops not unrolled: the accumulators take the registers
#pragma unroll 1
        for (int i = 0; i < kBM * kBK / 8 / kWgThreads; ++i) {
          const int cc = tid + i * kWgThreads, r = cc / 8, m = m0 + r;
          copy8(at_sw128(reinterpret_cast<bf16*>(st), r, (cc % 8) * 8),
                a.x + static_cast<size_t>(m < a.M ? m : 0) * a.H, k0 + (cc % 8) * 8, a.H, m < a.M,
                a.H % 8 == 0, a.x);
        }
        src = a.w_up;
        r0 = k0;
        c0 = ib;
        ld = a.I;
        rows = a.H;
        cols = a.I;
      } else {
        src = a.w_down;
        r0 = s.i0 + ((g - s.n1) % s.nk2) * kBK;
        c0 = ((g - s.n1) / s.nk2) * BH;
        ld = a.H;
        rows = a.I;
        cols = a.H;
      }
#pragma unroll 1
      for (int i = 0; i < kBK * kPass / 8 / kWgThreads; ++i) {
        const int cc = tid + i * kWgThreads, r = cc / 32, col = (cc % 32) * 8, k = r0 + r;
        // gated phase 1: columns 128.. of the tile are w_gate's
        const bool gate = kGated && g < s.n1 && col >= 128;
        const bf16* m = gate ? a.w_gate : src;
        const int cw = gate ? col - 128 : col;
        copy8(at_sw128(reinterpret_cast<bf16*>(sw), r, col),
              m + static_cast<size_t>(k < rows ? k : 0) * ld, c0 + cw, cols, k < rows, ld % 8 == 0,
              a.x);
      }
    }
    cp_commit();
  };

  float acc[2][16][4];  // phase 1: [w_up, w_gate] or w_up's two 128-column halves; phase 2: H's
  zero(acc[0]);
  zero(acc[1]);
  ring.start(load, [](int) {});
  for (int g = 0; g < s.n; ++g) {
    ring.before(g);
    const unsigned char* st = smem + Smem::kRing + (g % Smem::kStages) * Smem::kStage;
    const unsigned char* sw = st + Smem::kXBox;
    const bool phase1 = g < s.n1;
    const int kt = phase1 ? g % s.nk1 : (g - s.n1) % s.nk2;
    // One issue path for both phases (A: x's box, or the activation tile's
    // columns of this K tile): a branch around the products would let the
    // compiler copy accumulators in flight, and ptxas then waits for them.
    const void* a_tile = phase1 ? static_cast<const void*>(st) : static_cast<const void*>(act);
    const int a_r0 = phase1 ? wg * 64 : 0, a_c0 = phase1 ? 0 : kt * kBK;
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) mma_k64(acc[hf], a_tile, a_r0, a_c0, sw + hf * 16384);
    wgmma_commit();
    bool drained = false;
    if (phase1 && kt == s.nk1 - 1) {
      // The pass ends: bias (staged in shared memory), activation, bf16,
      // into the activation tile.
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      drained = true;
      const int p = g / s.nk1;
#pragma unroll
      for (int hf = 0; hf < (kGated ? 1 : 2); ++hf)
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int col = p * PW + hf * 128 + acc_col(n, 0), i = s.i0 + col;  // an even column pair
          const float2 bu =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
          const float2 bg =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + BI + col));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float h0 = acc[hf][n][2 * r] + bu.x, h1 = acc[hf][n][2 * r + 1] + bu.y;
            const float g0 = kGated ? acc[1][n][2 * r] + bg.x : 0.f;
            const float g1 = kGated ? acc[1][n][2 * r + 1] + bg.y : 0.f;
            *reinterpret_cast<uint32_t*>(at_sw128(act, acc_row(2 * r), col)) =
                pack_bf16(i < a.I ? activate<kAct>(h0, g0) : 0.f,
                          i + 1 < a.I ? activate<kAct>(h1, g1) : 0.f);
          }
        }
      zero(acc[0]);
      zero(acc[1]);
    } else if (!phase1 && kt == s.nk2 - 1) {
      // An H tile ends: the serial split-K over the chunks.
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      drained = true;
      const int h = (g - s.n1) / s.nk2, h0 = h * BH;
      int* ticket = a.tickets + mt * s.nh + h;
      const bool last = c == n_chunks - 1;
      if (c > 0) {  // wait for chunk c - 1's partial of this tile
        if (tid == 0) {
          const uint64_t start = tma::now_ns();
          while (ld_acquire(ticket) != c) {
            if (tma::now_ns() - start > 2000000000ull) __trap();  // 2 s: a chunk never came
            __nanosleep(64);
          }
        }
        __syncthreads();
      }
      // The workspace holds each block tile in the accumulators' own order,
      // a thread's 128 values as 32 float4 vectors, vector v of thread t at
      // (v * 256 + t) * 16 bytes: a warp's access is 512 contiguous bytes, and
      // rows and columns past M and H need no mask. A quarter of the vectors
      // at a time, loads before stores: the stores then keep the next
      // quarter's loads from being hoisted into registers the accumulators
      // hold.
      float4* tile =
          reinterpret_cast<float4*>(a.ws) + size_t(mt * s.nh + h) * (kBM * BH / 4) + tid;
      const bool pairs = a.H % 2 == 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int hf = q / 2, n0 = (q % 2) * 8;
        if (c > 0) {
#pragma unroll
          for (int n = n0; n < n0 + 8; ++n) {
            const float4 w = __ldcg(tile + (hf * 16 + n) * kWgThreads);
            acc[hf][n][0] += w.x;
            acc[hf][n][1] += w.y;
            acc[hf][n][2] += w.z;
            acc[hf][n][3] += w.w;
          }
        }
        if (!last) {
#pragma unroll
          for (int n = n0; n < n0 + 8; ++n)
            __stcg(tile + (hf * 16 + n) * kWgThreads,
                   make_float4(acc[hf][n][0], acc[hf][n][1], acc[hf][n][2], acc[hf][n][3]));
          continue;
        }
        // the output: rounded to bf16, b_down added in bf16 after the rounding
#pragma unroll
        for (int n = n0; n < n0 + 8; ++n) {
          const int col = h0 + hf * 128 + acc_col(n, 0);
          float bd[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (a.b_down != nullptr && col + e < a.H) bd[e] = to_f32(a.b_down[col + e]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = round_to<bf16>(acc[hf][n][e]);
            acc[hf][n][e] = a.b_down != nullptr ? round_to<bf16>(y + bd[e & 1]) : y;
          }
        }
#pragma unroll
        for (int n = n0; n < n0 + 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int m = m0 + wg * 64 + acc_row(2 * r), col = h0 + hf * 128 + acc_col(n, 0);
            if (m >= a.M || col >= a.H) continue;
            const size_t off = static_cast<size_t>(m) * a.H + col;
            const float v0 = acc[hf][n][2 * r], v1 = acc[hf][n][2 * r + 1];
            if (pairs) {
              *reinterpret_cast<uint32_t*>(a.out + off) = pack_bf16(v0, v1);
            } else {
              a.out[off] = __float2bfloat16(v0);
              if (col + 1 < a.H) a.out[off + 1] = __float2bfloat16(v1);
            }
          }
      }
      if (!last) {  // publish this chunk's partial, then pass the tile on
        __threadfence();
        __syncthreads();
        if (tid == 0) st_release(ticket, c + 1);
      }
      zero(acc[0]);
      zero(acc[1]);
    }
    ring.after(g, drained, load);
  }
  ring.finish();
}

}  // namespace

// x: [M, H]; w_up, w_gate: [H, I] (w_gate null unless SwiGLU/GeGLU); w_down:
// [I, H]; b_up, b_gate: [I] or null; b_down: [H] or null; ws: fp32 scratch,
// 128 x 256 floats a ticket; tickets: ceil(M / 128) x ceil(H / 256) int32,
// zeroed by the caller; out: [M, H]. act: 0 tanh-GELU, 1 erf-GELU, 2 ReLU, 3 SwiGLU,
// 4 GeGLU. bf16 throughout, pointers 16-byte aligned (the wrapper checks);
// any M, H, I. The TMA path where H and I are multiples of 8; cp.async
// otherwise.
extern "C" int mlio_fused_mlp(const void* x, const void* w_up, const void* w_gate,
                              const void* w_down, const void* b_up, const void* b_gate,
                              const void* b_down, void* ws, void* tickets, void* out, int M,
                              int H, int I, int act, void* stream) {
  if (M == 0 || H == 0 || I == 0) return 0;
  const MlpArgs a{static_cast<const bf16*>(x),      static_cast<const bf16*>(w_up),
                  static_cast<const bf16*>(w_gate), static_cast<const bf16*>(w_down),
                  static_cast<const bf16*>(b_up),   static_cast<const bf16*>(b_gate),
                  static_cast<const bf16*>(b_down), static_cast<float*>(ws),
                  static_cast<int*>(tickets),       static_cast<bf16*>(out),
                  M, H, I};
  const bool gated = w_gate != nullptr;
  if (act < kGeluTanh || act > kGeglu || gated != (act >= kSwiglu))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tma = H % 8 == 0 && I % 8 == 0;
  Maps maps{};
  if (tma) {
    cudaError_t err = tma::map_2d(&maps.x, x, M, H, H, kBM);
    if (err == cudaSuccess) err = tma::map_2d(&maps.up, w_up, H, I, I, kBK);
    if (err == cudaSuccess && gated) err = tma::map_2d(&maps.gate, w_gate, H, I, I, kBK);
    if (err == cudaSuccess) err = tma::map_2d(&maps.down, w_down, I, H, H, kBK);
    if (err != cudaSuccess) return err;
  }
  using Kernel = void (*)(const MlpArgs, const Maps);
  static const Kernel kKernels[2][5] = {
      {fused_mlp_kernel<false, 0>, fused_mlp_kernel<false, 1>, fused_mlp_kernel<false, 2>,
       fused_mlp_kernel<false, 3>, fused_mlp_kernel<false, 4>},
      {fused_mlp_kernel<true, 0>, fused_mlp_kernel<true, 1>, fused_mlp_kernel<true, 2>,
       fused_mlp_kernel<true, 3>, fused_mlp_kernel<true, 4>}};
  const Kernel kernel = kKernels[tma][act];
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Smem::kBytes));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((M + kBM - 1) / kBM) * ((I + BI - 1) / BI);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, Smem::kBytes,
           static_cast<cudaStream_t>(stream)>>>(a, maps);
  return cudaGetLastError();
}
