// K11: the fused MLP, for Hopper.
//
// Replaces mlio_tpu/ops/fused_mlp.py::_fused_mlp_kernel. x [M, H],
// w_up (and w_gate) [H, I], w_down [I, H], all bf16:
//   h = x @ w_up (+ b_up), g = x @ w_gate (+ b_gate)       fp32 sums
//   a = act(h[, g]) in fp32, rounded to bf16                (fused_mlp.py:67)
//   out = round(a @ w_down) (+ b_down, added in bf16 after the rounding)
// act: tanh-GELU (gelu_new, gelu_tanh), erf-GELU (gelu), ReLU, SwiGLU
// silu(g) * h, GeGLU tanh-gelu(g) * h.
//
// Bound: operations. At GPT-2's widths (M = 5632, H 768, I 3072) the two
// products are 53.2 GFLOP (0.054 ms at 989 TFLOP/s) against 26.7 MB of
// inputs and output (0.008 ms at 3.35 TB/s), H100 SXM data sheet.
//
// What the TPU kernel guarantees, and this one keeps, is that the [M, I]
// activation never goes to device memory. The TPU kernel carries a [bm, H]
// fp32 sum in VMEM across a sequential I axis; that does not fit a Hopper
// block at H = 4096 (64 x 4096 x 4 B = 1 MB), and Hopper's blocks run in
// parallel. Of the two ways to cut it, this kernel takes a block per (64-row
// tile, 512-wide chunk of I): it computes its activation tile with the shared
// tile loop of gemm_tile.cuh (up and gate products in 128-column quarters,
// the bias and activation applied in registers to the fp32 fragments), keeps
// it in shared memory as bf16 (64 KB), then multiplies it by w_down's 512
// rows in 128-column tiles of H, adding each fp32 partial product into an fp32
// [M, H] sum in device memory with atomics. A second launch rounds the sum to
// bf16 and adds b_down. The other way, a block per (row tile, column tile of
// H) looping over all of I, keeps the sum in registers and needs no atomics,
// but recomputes the up product H / BN times: at llama3-8b's widths (H 4096,
// SwiGLU) that multiplies the work by about 11, where the atomics here cost
// I / 512 fp32 additions an output element (28 at I = 14336, 6 at 3072; a
// 256-wide chunk, twice the additions, measured slower at both widths).
//
// The atomics add a block's partial sums in whichever order the blocks
// finish, so the fp32 sum, and after rounding the bf16 output, can differ in
// its last bit from run to run; the check against the plain version holds a
// bf16 tolerance. Ragged M, H and I are masked in the loads and stores.
#include "gemm_tile.cuh"

#include <math.h>

namespace {

using namespace gemm;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;     // rows of a block
constexpr int BI = 512;    // intermediate columns of a block
constexpr int BNU = 128;   // up-product columns a pass (BI / BNU passes)
constexpr int BND = 128;   // output columns a down-product tile
constexpr int LDB = LdB<128>::value;
constexpr int LDACT = BI + 8;  // activation tile pitch: 1040 bytes, ldmatrix without conflicts
constexpr int MI = BM / 32, NI = 4;  // warp tile 32 x 32

struct Smem {
  bf16 a[2][BM * LDA];     // x tiles
  bf16 b[2][BK * LDB];     // w_up, then w_down tiles
  bf16 g[2][BK * LDB];     // w_gate tiles
  bf16 act[BM * LDACT];    // the activation tile, [BM, BI]
};

enum Act { kGeluTanh = 0, kGeluErf = 1, kRelu = 2, kSwiglu = 3, kGeglu = 4 };

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float activate(int act, float h, float g) {
  switch (act) {
    case kGeluTanh: return gelu_tanh(h);
    case kGeluErf: return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
    case kRelu: return fmaxf(h, 0.f);
    case kSwiglu: return g / (1.f + expf(-g)) * h;
    default: return gelu_tanh(g) * h;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_up,
                 const bf16* __restrict__ w_gate, const bf16* __restrict__ w_down,
                 const bf16* __restrict__ b_up, const bf16* __restrict__ b_gate,
                 float* __restrict__ acc_out, int M, int H, int I, int act, int vec_x,
                 int vec_i, int vec_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * BI, m0 = blockIdx.y * BM;
  const int wrow = (warp >> 2) * (BM / 2), wcol = (warp & 3) * 32;
  const bool gated = w_gate != nullptr;

  // Phase 1: the activation tile, in BI / BNU 128-column passes over I.
  uint4 rx, ru[2], rg[2];
  for (int pass = 0; pass < BI / BNU; ++pass) {
    const int ib = i0 + pass * BNU;
    auto fetch = [&](int t) {
      rx = load8(x, H, m0 + tid / 4, t * BK + (tid % 4) * 8, M, H, vec_x);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + j * kThreads, k = t * BK + c / 16, n = ib + (c % 16) * 8;
        ru[j] = load8(w_up, I, k, n, H, I, vec_i);
        if (gated) rg[j] = load8(w_gate, I, k, n, H, I, vec_i);
      }
    };
    auto put = [&](int s) {
      store_bf16(&sm.a[s][(tid / 4) * LDA + (tid % 4) * 8], rx);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + j * kThreads;
        store_bf16(&sm.b[s][(c / 16) * LDB + (c % 16) * 8], ru[j]);
        if (gated) store_bf16(&sm.g[s][(c / 16) * LDB + (c % 16) * 8], rg[j]);
      }
    };
    Frag<MI, NI> fh, fg;
    fh.zero();
    fg.zero();
    pipeline((H + BK - 1) / BK, fetch, put, [&](int, int s) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        warp_k16(fh, sm.a[s], LDA, wrow, sm.b[s], LDB, wcol, kk, lane);
        if (gated) warp_k16(fg, sm.a[s], LDA, wrow, sm.g[s], LDB, wcol, kk, lane);
      }
    });
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = Frag<MI, NI>::col(wcol, ni, e, lane), i = ib + c;
        const float bu = (b_up != nullptr && i < I) ? to_f32(b_up[i]) : 0.f;
        const float bg = (b_gate != nullptr && i < I) ? to_f32(b_gate[i]) : 0.f;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = Frag<MI, NI>::row(wrow, mi, e, lane);
          const float a = i < I ? activate(act, fh.c[mi][ni][e] + bu, fg.c[mi][ni][e] + bg)
                                : 0.f;
          sm.act[r * LDACT + pass * BNU + c] = __float2bfloat16(a);
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: act [BM, BI] @ w_down[i0 : i0 + BI, :], a 128-column tile of H
  // at a time, each partial product added into the fp32 sum.
  uint4 rd[2];
  for (int n0 = 0; n0 < H; n0 += BND) {
    auto fetch = [&](int t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + j * kThreads;
        rd[j] = load8(w_down, H, i0 + t * BK + c / 16, n0 + (c % 16) * 8, I, H, vec_h);
      }
    };
    auto put = [&](int s) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tid + j * kThreads;
        store_bf16(&sm.b[s][(c / 16) * LDB + (c % 16) * 8], rd[j]);
      }
    };
    Frag<MI, NI> fo;
    fo.zero();
    const int nt = (min(BI, I - i0) + BK - 1) / BK;
    pipeline(nt, fetch, put, [&](int t, int s) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)  // A: the activation tile's columns from t * BK
        warp_k16(fo, sm.act + t * BK, LDACT, wrow, sm.b[s], LDB, wcol, kk, lane);
    });
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + Frag<MI, NI>::row(wrow, mi, e, lane);
          const int n = n0 + Frag<MI, NI>::col(wcol, ni, e, lane);
          if (m < M && n < H) atomicAdd(acc_out + static_cast<size_t>(m) * H + n, fo.c[mi][ni][e]);
        }
      }
    }
  }
}

// out = round(acc) (+ b_down, added in bf16 after the rounding).
__global__ void finish_kernel(const float* __restrict__ acc, const bf16* __restrict__ b_down,
                              bf16* __restrict__ out, size_t total, int H) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    bf16 y = __float2bfloat16(acc[i]);
    if (b_down != nullptr) y = __float2bfloat16(to_f32(y) + to_f32(b_down[i % H]));
    out[i] = y;
  }
}

}  // namespace

// x: [M, H]; w_up, w_gate: [H, I] (w_gate null unless SwiGLU/GeGLU); w_down:
// [I, H]; b_up, b_gate: [I] or null; acc: [M, H] fp32, zeroed by the caller.
// act: 0 tanh-GELU, 1 erf-GELU, 2 ReLU, 3 SwiGLU, 4 GeGLU. bf16 throughout,
// pointers 16-byte aligned (the wrapper checks); any M, H, I.
extern "C" int mlio_fused_mlp(const void* x, const void* w_up, const void* w_gate,
                              const void* w_down, const void* b_up, const void* b_gate,
                              void* acc, int M, int H, int I, int act, void* stream) {
  if (M == 0 || H == 0 || I == 0) return 0;
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((I + BI - 1) / BI, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_mlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_up),
      static_cast<const bf16*>(w_gate), static_cast<const bf16*>(w_down),
      static_cast<const bf16*>(b_up), static_cast<const bf16*>(b_gate),
      static_cast<float*>(acc), M, H, I, act, H % 8 == 0, I % 8 == 0, H % 8 == 0);
  return cudaGetLastError();
}

// out [M, H] bf16 from the fp32 sum acc [M, H]; b_down [H] bf16 or null.
extern "C" int mlio_fused_mlp_finish(const void* acc, const void* b_down, void* out, int M, int H,
                                     void* stream) {
  const size_t total = static_cast<size_t>(M) * H;
  if (total == 0) return 0;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  finish_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const bf16*>(b_down), static_cast<bf16*>(out),
      total, H);
  return cudaGetLastError();
}
