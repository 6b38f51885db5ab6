// K12: fused norm + matmul (the fused LayerNorm/RMSNorm + QKV projection),
// for Hopper.
//
// Replaces mlio_tpu/ops/ln_qkv.py::_ln_matmul_kernel. x [M, H] bf16,
// W = [W1 | W2 | W3] [H, N] bf16 given as up to three row-major matrices
// (Wq, Wk, Wv; GQA by their widths), out [M, N] bf16:
//   xn  = ((x - mean) * rsqrt(var + eps)) * scale (+ bias)     layernorm
//   xn  = (x * rsqrt(mean(x^2) + eps)) * scale (+ bias)        rmsnorm
//   out = round(round(xn) @ W)
// with fp32 statistics (two-pass variance), xn rounded to bf16 before the
// product (ln_qkv.py:43) and an fp32 sum.
//
// Bound: operations. At GPT-2's QKV (M = 5632, H 768, N 2304) it is 19.9
// GFLOP (0.020 ms at 989 TFLOP/s) against 38 MB (0.011 ms at 3.35 TB/s),
// H100 SXM data sheet. The design keeps xn out of device memory: the TPU
// kernel normalises a row tile once into scratch at the first column step,
// which relies on its grid running in order. Blocks here run in parallel, so
// a first launch computes every row's fp32 statistics (mean and rstd, a warp
// a row, 8 bytes a row to device memory), and each block of the second (128
// rows x 128 columns) loads its rows' statistics and normalises each 32-deep
// K tile of x as it stages it into shared memory as bf16, feeding the tensor
// cores through the shared tile loop of gemm_tile.cuh. (A first version
// computed the statistics in each block's prologue, a warp walking 16 rows
// one after another: every column block of a row tile redid them, and at
// GPT-2's QKV the kernel took 0.43 ms, PERF.md.) The columns of W come from
// whichever of the three matrices holds them, so the wrapper never
// concatenates the weights. Ragged edges are masked in the kernel.
#include "gemm_tile.cuh"

namespace {

using namespace gemm;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128;
constexpr int LDB = LdB<BN>::value;
constexpr int MI = BM / 32, NI = 4;
constexpr int A_CHUNKS = BM * BK / 8 / kThreads;  // x chunks of 8 a thread
constexpr int B_CHUNKS = BK * BN / 8 / kThreads;  // W chunks of 8 a thread

struct Weights {
  const bf16* w[3];
  int n1, n12, N;  // column where W2 starts, where W3 starts, and the width
  bool vec;        // every part's rows allow 16-byte loads, chunks never straddle parts

  // 8 columns of row k from column n (a multiple of 8), zeros past the edge.
  __device__ __forceinline__ uint4 load(int k, int n, int H) const {
    if (vec && k < H && n < N) {
      const int p = n < n1 ? 0 : (n < n12 ? 1 : 2);
      const int base = p == 0 ? 0 : (p == 1 ? n1 : n12);
      const int width = p == 0 ? n1 : (p == 1 ? n12 - n1 : N - n12);
      return load8(w[p], width, k, n - base, H, width, true);
    }
    uint4 v = make_uint4(0, 0, 0, 0);
    bf16* e = reinterpret_cast<bf16*>(&v);
    if (k >= H) return v;
    for (int i = 0; i < 8 && n + i < N; ++i) {
      const int c = n + i;
      const int p = c < n1 ? 0 : (c < n12 ? 1 : 2);
      const int base = p == 0 ? 0 : (p == 1 ? n1 : n12);
      const int width = p == 0 ? n1 : (p == 1 ? n12 - n1 : N - n12);
      e[i] = w[p][static_cast<size_t>(k) * width + c - base];
    }
    return v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row statistics, a warp a row: stats[2m] = mean (0 for RMSNorm), stats[2m + 1]
// = rsqrt(var + eps) with the two-pass variance (or rsqrt(mean(x^2) + eps)).
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int M, int H, int rms,
                 float eps, int vec_x) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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

__global__ void __launch_bounds__(kThreads, 2)
ln_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                 const bf16* __restrict__ bias, Weights W, const float* __restrict__ stats,
                 bf16* __restrict__ out, int M, int H, int rms, int vec_x) {
  __shared__ __align__(16) bf16 sA[2][BM * LDA];
  __shared__ __align__(16) bf16 sB[2][BK * LDB];
  __shared__ float s_mean[BM], s_rstd[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wrow = (warp >> 2) * (BM / 2), wcol = (warp & 3) * 32;
  const int N = W.N;

  for (int r = tid; r < BM; r += kThreads) {  // rows past M normalise to 0 * scale + bias
    const bool in = m0 + r < M;
    s_mean[r] = in ? stats[2 * static_cast<size_t>(m0 + r)] : 0.f;
    s_rstd[r] = in ? stats[2 * static_cast<size_t>(m0 + r) + 1] : 0.f;
  }
  __syncthreads();

  uint4 rx[A_CHUNKS], rw[B_CHUNKS];
  int tile = 0;  // the tile rx holds, for the scale and bias columns in put
  auto fetch = [&](int t) {
    tile = t;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      rx[i] = load8(x, H, m0 + c / 4, t * BK + (c % 4) * 8, M, H, vec_x);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      rw[i] = W.load(t * BK + c / (BN / 8), n0 + (c % (BN / 8)) * 8, H);
    }
  };
  auto put = [&](int s) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads, r = c / 4, col = tile * BK + (c % 4) * 8;
      float f[8], sc[8], b[8];
      unpack_vec<bf16>(rx[i], f);
      unpack_vec<bf16>(load8(scale, 0, 0, col, 1, H, vec_x), sc);
      unpack_vec<bf16>(bias != nullptr ? load8(bias, 0, 0, col, 1, H, vec_x)
                                       : make_uint4(0, 0, 0, 0), b);
      const float mean = s_mean[r], rstd = s_rstd[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float y = rms ? f[e] * rstd : (f[e] - mean) * rstd;
        y = y * sc[e];
        if (bias != nullptr) y = y + b[e];
        f[e] = y;
      }
      store_vec(&sA[s][r * LDA + (c % 4) * 8], f);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      store_bf16(&sB[s][(c / (BN / 8)) * LDB + (c % (BN / 8)) * 8], rw[i]);
    }
  };

  Frag<MI, NI> acc;
  acc.zero();
  pipeline((H + BK - 1) / BK, fetch, put, [&](int, int s) {
    warp_k16(acc, sA[s], LDA, wrow, sB[s], LDB, wcol, 0, lane);
    warp_k16(acc, sA[s], LDA, wrow, sB[s], LDB, wcol, 16, lane);
  });

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + Frag<MI, NI>::row(wrow, mi, h * 2, lane);
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + Frag<MI, NI>::col(wcol, ni, 0, lane);
        store_pair(out + static_cast<size_t>(m) * N, n, N, acc.c[mi][ni][h * 2],
                   acc.c[mi][ni][h * 2 + 1]);
      }
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
  const int rows_per_block = kThreads / 32;
  row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<float*>(stats), M, H, rms, eps, H % 8 == 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Weights W;
  W.w[0] = static_cast<const bf16*>(w1);
  W.w[1] = static_cast<const bf16*>(w2);
  W.w[2] = static_cast<const bf16*>(w3);
  W.n1 = n1;
  W.n12 = n1 + n2;
  W.N = N;
  W.vec = n1 % 8 == 0 && n2 % 8 == 0 && n3 % 8 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  ln_matmul_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), W, static_cast<const float*>(stats),
      static_cast<bf16*>(out), M, H, rms, H % 8 == 0);
  return cudaGetLastError();
}
