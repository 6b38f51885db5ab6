// K5: the dequant-fused matmul, for Hopper.
//
// Replaces mlio_tpu/ops/quant.py::_quant_matmul_kernel (int8),
// _int4_matmul_kernel (int4, per-channel scales) and
// _int4_group_matmul_kernel (int4, group scales). x [M, K] bf16, out [M, N]
// bf16:
//   int8          out = (x @ q) * scale[n]                    q [K, N] int8
//   int4          out = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale[n]
//   int4 grouped  out = sum_g (x_lo,g @ lo_g) * scale[g, n] + (x_hi,g @ hi_g) * scale[K/2g + g, n]
// where q [K/2, N] packs row i (low nibble, "lo") with row i + K/2 (high
// nibble, "hi"), each sign-extended from 4 bits; the sums are fp32.
//
// Bound: bytes at decode-sized M, operations at prefill-sized M. The weight
// crosses device memory quantized (1 byte an element, or half) and is widened
// to bf16 on its way into shared memory, exactly for |q| <= 127, so the
// tensor cores see bf16 and no dequantised copy is ever written. At GPT-2's
// up projection (K 768, N 3072) M = 5632 is 26.6 GFLOP (0.027 ms at 989
// TFLOP/s) and M = 8 is 2.4 MB (0.7 us at 3.35 TB/s), H100 SXM data sheet.
//
// Design: the shared bf16 tile loop of gemm_tile.cuh, a block per
// 128 x 128 (64 x 128 for group scales) output tile, eight warps. Tiles are
// 32 deep along K: for int8 32 rows of q; for int4 16 packed rows, whose low
// nibbles meet x's columns [16t, 16t + 16) and high nibbles x's columns
// [K/2 + 16t, K/2 + 16t + 16), staged as one 32-deep tile. Scales follow the
// JAX kernels: per-channel scales multiply the fp32 sum in the epilogue
// (scaling the weights before the MMA would add a bf16 rounding the TPU
// kernel does not have); with group scales each group's lo and hi partial
// sums are kept apart in fp32 registers and added as lo * s_lo + hi * s_hi
// when the group ends. Ragged M, N and K are masked in the loads and stores,
// so every shape runs with no padding and no fallback. The JAX package sends
// M <= 32 to an XLA dot, a split measured on the TPU; here every M runs this
// kernel, whose M = 8 time PERF.md keeps beside the library's.
#include "gemm_tile.cuh"

namespace {

using namespace gemm;
using bf16 = __nv_bfloat16;

constexpr int BN = 128;
constexpr int LDB = LdB<BN>::value;

enum Kind { kInt8 = 0, kInt4 = 1, kInt4Group = 2 };

__device__ __forceinline__ int nib_lo(int b) { return ((b & 0x0F) ^ 8) - 8; }
__device__ __forceinline__ int nib_hi(int b) { return (((b >> 4) & 0x0F) ^ 8) - 8; }

// Bytes e[i0 .. i0 + 8) through f (an integer in [-127, 127]) as 8 bf16,
// exact, packed for one 16-byte store.
template <class F>
__device__ __forceinline__ uint4 widen8(const int8_t* e, int i0, F f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(static_cast<float>(f(e[i0 + 2 * i])),
                                                   static_cast<float>(f(e[i0 + 2 * i + 1])));
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// BM: rows of the block tile (128, or 64 where group scales need a second
// pair of partial accumulators). vec_x: x's rows allow 16-byte loads in every
// column the tile reads; vec_q likewise for q's rows.
template <int BM, int KIND>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, bf16* __restrict__ out, int M, int N, int K,
                    int group, int vec_x, int vec_q) {
  constexpr int MI = BM / 32;  // warp tile (BM / 2) x 32
  constexpr int NI = 4;
  constexpr int A_CHUNKS = BM * BK / 8 / kThreads;  // 16-byte x chunks a thread
  __shared__ __align__(16) bf16 sA[2][BM * LDA];
  __shared__ __align__(16) bf16 sB[2][BK * LDB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wrow = (warp >> 2) * (BM / 2), wcol = (warp & 3) * 32;
  const int Kh = K / 2;
  const bool int4 = KIND != kInt8;
  const int nt = int4 ? (Kh + 15) / 16 : (K + BK - 1) / BK;

  uint4 ra[A_CHUNKS];
  uint4 rb;
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads, r = c / 4, j = c % 4;
      if (!int4) {
        ra[i] = load8(x, K, m0 + r, t * BK + j * 8, M, K, vec_x);
      } else if (j < 2) {  // columns meeting the low nibbles: [16t, 16t + 16) of [0, K/2)
        ra[i] = load8(x, K, m0 + r, t * 16 + j * 8, M, Kh, vec_x);
      } else {             // columns meeting the high nibbles: K/2 + [16t, 16t + 16)
        ra[i] = load8(x + Kh, K, m0 + r, t * 16 + (j - 2) * 8, M, Kh, vec_x);
      }
    }
    if (!int4) {  // 32 rows x 128 bytes: one chunk a thread
      rb = load16b(q, N, t * BK + tid / 8, n0 + (tid % 8) * 16, K, N, vec_q);
    } else if (tid < 128) {  // 16 packed rows x 128 bytes
      rb = load16b(q, N, t * 16 + tid / 8, n0 + (tid % 8) * 16, Kh, N, vec_q);
    }
  };
  auto put = [&](int s) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      store_bf16(&sA[s][(c / 4) * LDA + (c % 4) * 8], ra[i]);
    }
    const int8_t* e = reinterpret_cast<const int8_t*>(&rb);
    const int col = (tid % 8) * 16;
    if (!int4) {
      bf16* dst = &sB[s][(tid / 8) * LDB + col];
      store_bf16(dst, widen8(e, 0, [](int b) { return b; }));
      store_bf16(dst + 8, widen8(e, 8, [](int b) { return b; }));
    } else if (tid < 128) {
      bf16* lo = &sB[s][(tid / 8) * LDB + col];
      bf16* hi = &sB[s][(16 + tid / 8) * LDB + col];
      const auto lo_f = [](int b) { return nib_lo(b); };
      const auto hi_f = [](int b) { return nib_hi(b); };
      store_bf16(lo, widen8(e, 0, lo_f));
      store_bf16(lo + 8, widen8(e, 8, lo_f));
      store_bf16(hi, widen8(e, 0, hi_f));
      store_bf16(hi + 8, widen8(e, 8, hi_f));
    }
  };

  Frag<MI, NI> acc;
  acc.zero();
  if constexpr (KIND != kInt4Group) {
    pipeline(nt, fetch, put, [&](int, int s) {
      warp_k16(acc, sA[s], LDA, wrow, sB[s], LDB, wcol, 0, lane);
      warp_k16(acc, sA[s], LDA, wrow, sB[s], LDB, wcol, 16, lane);
    });
  } else {
    Frag<MI, NI> plo, phi;  // the current group's lo and hi partial sums
    plo.zero();
    phi.zero();
    const int groups_half = Kh / group;
    pipeline(nt, fetch, put, [&](int t, int s) {
      warp_k16(plo, sA[s], LDA, wrow, sB[s], LDB, wcol, 0, lane);
      warp_k16(phi, sA[s], LDA, wrow, sB[s], LDB, wcol, 16, lane);
      if ((t + 1) * 16 % group == 0 || t == nt - 1) {
        const int g = t * 16 / group;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + Frag<MI, NI>::col(wcol, ni, e, lane);
            const float slo = n < N ? scale[static_cast<size_t>(g) * N + n] : 0.f;
            const float shi = n < N ? scale[static_cast<size_t>(groups_half + g) * N + n] : 0.f;
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k = h * 2 + e;
                acc.c[mi][ni][k] += plo.c[mi][ni][k] * slo + phi.c[mi][ni][k] * shi;
                plo.c[mi][ni][k] = 0.f;
                phi.c[mi][ni][k] = 0.f;
              }
            }
          }
        }
      }
    });
  }

#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int n = n0 + Frag<MI, NI>::col(wcol, ni, 0, lane);
    float s0 = 1.f, s1 = 1.f;
    if (KIND != kInt4Group) {
      s0 = n < N ? scale[n] : 0.f;
      s1 = n + 1 < N ? scale[n + 1] : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + Frag<MI, NI>::row(wrow, mi, h * 2, lane);
        if (m < M)
          store_pair(out + static_cast<size_t>(m) * N, n, N, acc.c[mi][ni][h * 2] * s0,
                     acc.c[mi][ni][h * 2 + 1] * s1);
      }
    }
  }
}

template <int BM, int KIND>
cudaError_t launch(const void* x, const void* q, const float* scale, void* out, int M, int N,
                   int K, int group, int vec_x, int vec_q, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  quant_matmul_kernel<BM, KIND><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q), scale,
      static_cast<bf16*>(out), M, N, K, group, vec_x, vec_q);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16; q: [K, N] int8 (kind 0) or [K/2, N] packed int4 (kind 1);
// scale: fp32 [N], or [K/group, N] when group > 0 (kind 1 only, group a
// divisor of K/2 and a multiple of 16); out: [M, N] bf16. Pointers 16-byte
// aligned (the wrapper checks); any M, N, K (K even for int4).
extern "C" int mlio_quant_matmul(const void* x, const void* q, const void* scale, void* out,
                                 int M, int N, int K, int kind, int group, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (kind == 0)
    return launch<128, kInt8>(x, q, sc, out, M, N, K, 0, K % 8 == 0, N % 16 == 0, s);
  if (kind != 1 || K % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_x = K % 16 == 0;  // the high half starts at K/2: a multiple of 8 too
  if (group == 0) return launch<128, kInt4>(x, q, sc, out, M, N, K, 0, vec_x, N % 16 == 0, s);
  if (group % 16 || (K / 2) % group) return static_cast<int>(cudaErrorInvalidValue);
  return launch<64, kInt4Group>(x, q, sc, out, M, N, K, group, vec_x, N % 16 == 0, s);
}
