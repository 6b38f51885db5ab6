// K15: the weight-widening probe for Hopper. out [8, C] = sum over n chunks
// j of x [8, R] @ widen(w_j) [R, C] in fp32, w int8 or fp8 e4m3.
//
// Replaces exp_fp8_convert.py::_kernel, which streams [256, 2048, 2048]
// int8 or e4m3 chunks through VMEM, converts each to bf16 by one of four
// methods (_convert) and sums x @ chunk. The variants here (widen.cuh):
// int8 (shift and convert), fp8 (the e4m3x2 -> f16x2 convert, K6's), fp8-f32
// (one e4m3 at a time through the fp8 type's float conversion) and fp8-bits
// (integer bit assembly, right for zero and the normals, which the probe's
// data holds). Every int8 and e4m3 value is a
// bf16, so each widened weight equals _convert's bf16 result and no rounding
// instruction is spent on it.
//
// The probe exists to measure what K6 (decode_tiled.cuh) pays for its int8
// and fp8 GEMVs at batch 8, so its product loop is K6's own: each thread
// loads its 8 columns of a weight row (one 8-byte streaming load) straight
// into registers, 8 rows in flight, widens them with K6's unpack_w and keeps
// 8 batch rows x 8 columns of fp32 sums with CUDA-core FMAs, x staged once
// in shared memory as [R][8] fp32.
//
// Bound. At the timed shape (1 GB: 256 chunks of 2048 x 2048) the bytes take
// 0.331 ms at 3,240 GB/s (the probe K14's best checked stream on the H100,
// PERF.md) and the 8.6 G FMAs (8 a weight) 0.257 ms at the data sheet's 67
// TFLOP/s of CUDA-core fp32: bytes bound it, by a margin of 1.3x, so the
// widening's instructions beside the FMAs decide how close the loop comes.
//
// Design. The reduction over chunks and rows is split over every SM: block g
// of G (blocks an SM x SMs) takes the flattened rows [g N / G, (g + 1) N /
// G) of the n R rows, writes its [8, C] partial, and a second kernel sums the
// G partials in block order: two runs give the same bits, no atomics.
//
// Limits: 8 rows of x (bf16); C a multiple of 8, at most 2048 (a thread's
// 8 columns, one block across C); R at most 2048 (x in 64 KB of shared
// memory, so that 3 blocks fit an SM at C = 2048) and more than the rows a
// block has in flight.

#include "common.cuh"
#include "widen.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 8;      // rows of x: the batch
constexpr int kCpt = 8;       // columns a thread: one 8-byte load a weight row
constexpr int kInFlight = 8;  // weight rows a thread has in flight (K6's kInFlight)
constexpr int kMaxR = 2048;

template <int FMT>
__global__ void __launch_bounds__(kThreads, 2)
    widen_kernel(const unsigned char* __restrict__ w, long long nrows, int R, int C,
                 const bf16* __restrict__ x, float* __restrict__ part) {
  using Raw = typename WRaw<FMT, kCpt>::T;
  extern __shared__ __align__(16) float xs[];  // [R][8], then the row groups' sums
  for (int e = threadIdx.x; e < R * kRows; e += kThreads) {
    const int r = e / kRows, b = e - r * kRows;
    xs[e] = to_f32(x[static_cast<size_t>(b) * R + r]);
  }
  __syncthreads();
  const int ncg = C / kCpt, nrg = kThreads / ncg;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const long long g = blockIdx.x, G = gridDim.x;
  const long long r0 = g * nrows / G, r1 = (g + 1) * nrows / G;

  float acc[kRows][kCpt];
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int i = 0; i < kCpt; ++i) acc[b][i] = 0.f;

  auto fma_row = [&](const Raw& raw, const float* ar) {
    float wv[kCpt];
    unpack_w<FMT, kCpt>(raw, wv);
#pragma unroll
    for (int b = 0; b < kRows; b += 4) {
      const float4 av = *reinterpret_cast<const float4*>(ar + b);
#pragma unroll
      for (int i = 0; i < kCpt; ++i) {
        acc[b][i] = fmaf(av.x, wv[i], acc[b][i]);
        acc[b + 1][i] = fmaf(av.y, wv[i], acc[b + 1][i]);
        acc[b + 2][i] = fmaf(av.z, wv[i], acc[b + 2][i]);
        acc[b + 3][i] = fmaf(av.w, wv[i], acc[b + 3][i]);
      }
    }
  };

  if (rg < nrg) {
    const unsigned char* base = w + static_cast<size_t>(cg) * kCpt;
    const int step = kInFlight * nrg;
    long long r = r0 + rg;
    int xr = static_cast<int>(r % R);  // the row of x that weight row r meets
    for (; r + (kInFlight - 1) * nrg < r1; r += step) {
      Raw raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        raw[u] = __ldcs(reinterpret_cast<const Raw*>(base + static_cast<size_t>(r + u * nrg) * C));
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        int xu = xr + u * nrg;
        if (xu >= R) xu -= R;
        fma_row(raw[u], xs + xu * kRows);
      }
      xr += step;
      if (xr >= R) xr -= R;
    }
    for (; r < r1; r += nrg) {
      fma_row(__ldcs(reinterpret_cast<const Raw*>(base + static_cast<size_t>(r) * C)),
              xs + xr * kRows);
      xr += nrg;
      if (xr >= R) xr -= R;
    }
  }
  // the block's partial [8][C]: a thread's sums (one row group), or the row
  // groups' sums in order
  float* P = part + g * kRows * C;
  if (nrg == 1) {
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      float4* dst = reinterpret_cast<float4*>(P + b * C + cg * kCpt);
      __stcg(dst, make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]));
      __stcg(dst + 1, make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]));
    }
    return;
  }
  float* red = xs + R * kRows;
  if (rg < nrg) {
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int i = 0; i < kCpt; ++i) red[(rg * kRows + b) * C + cg * kCpt + i] = acc[b][i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kRows * C; o += kThreads) {
    float s = 0.f;
    for (int q = 0; q < nrg; ++q) s += red[q * kRows * C + o];
    __stcg(P + o, s);
  }
}

// out[o] = the G partials summed in block order.
__global__ void finish_kernel(const float* __restrict__ part, int G, int n, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += __ldcg(part + static_cast<size_t>(g) * n + o);
  out[o] = s;
}

template <int FMT>
cudaError_t launch(const void* w, long long nrows, int R, int C, const void* x, float* out,
                   float* part, int blocks, cudaStream_t stream) {
  const int nrg = kThreads / (C / kCpt);
  const int smem = (R + (nrg > 1 ? nrg * C : 0)) * kRows * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(widen_kernel<FMT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  widen_kernel<FMT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(w), nrows, R, C, static_cast<const bf16*>(x), part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n = kRows * C;
  finish_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, blocks, n, out);
  return cudaGetLastError();
}

}  // namespace

// variant: 1 int8, 2 fp8 (e4m3x2 convert), 3 fp8 through fp32, 4 fp8 bit
// assembly. w: nrows = n R rows of C bytes; x [8, R] bf16; out [8, C] fp32;
// part: blocks x 8 x C fp32 of scratch. Returns the launches' error.
extern "C" int mlio_fp8_convert(int variant, const void* w, long long nrows, int R, int C,
                                const void* x, float* out, float* part, int blocks,
                                void* stream) {
  if (C < kCpt || C % kCpt || C > kThreads * kCpt || R < 1 || R > kMaxR || nrows < 1 ||
      nrows % R || blocks < 1 || kInFlight * (kThreads / (C / kCpt)) >= R)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return launch<1>(w, nrows, R, C, x, out, part, blocks, s);
    case 2: return launch<2>(w, nrows, R, C, x, out, part, blocks, s);
    case 3: return launch<3>(w, nrows, R, C, x, out, part, blocks, s);
    case 4: return launch<4>(w, nrows, R, C, x, out, part, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}
