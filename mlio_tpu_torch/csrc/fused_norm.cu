// K2: fused LayerNorm / RMSNorm with an optional residual, for Hopper.
//
// Replaces mlio_tpu/ops/norms.py::_norm_kernel. Per row of x [M, H]:
//   x' = x + alpha * residual        (added in fp32, as _norm_kernel does)
//   y  = (x' - mean) * rsqrt(var + eps)     layernorm, two-pass variance
//   y  = x' * rsqrt(mean(x'^2) + eps)       rmsnorm
//   out = y * scale (+ bias), cast to the input dtype.
//
// Bound: bytes. Each row is read once and written once (plus the residual);
// there are ~8 flops per element against 2-4 bytes, far below the H100's ~295
// flops per byte balance point (SXM data sheet: 989 TFLOP/s bf16 over 3.35
// TB/s). The design keeps the row in registers between the statistics pass
// and the normalise pass, so device memory sees exactly one read and one
// write per element, with 16-byte vector accesses on neighbouring addresses.
// A warp owns a row when H <= 2048 (8 rows per 256-thread block, no shared
// memory, shuffles only); a whole block owns a row when H is larger (up to
// 16384), with a shared-memory step to combine the warps' partial sums.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFloats = 64;  // row elements one thread keeps in registers

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if constexpr (TPR == 32) {
    return x;
  } else {
    __shared__ float part[TPR / 32];
    __syncthreads();  // earlier readers of part[] are done
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = x;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) t += part[i];
    return t;
  }
}

// TPR: threads per row, 32 (a warp) or kThreads (the block).
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const T* __restrict__ scale, const T* __restrict__ bias,
            T* __restrict__ out, int M, int H, int rms, float eps, float alpha) {
  constexpr int V = Vec16<T>::N;
  constexpr int MAXC = kMaxFloats / V;  // 16-byte chunks per thread
  constexpr int ROWS = kThreads / TPR;
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  if (row >= M) return;  // uniform across the block when TPR == kThreads
  const int nchunk = H / V;
  const size_t base = static_cast<size_t>(row) * H;

  float v[MAXC][V];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int ch = t + c * TPR;
    if (ch < nchunk) {
      load_vec(x + base + ch * V, v[c]);
      if (res != nullptr) {
        float r[V];
        load_vec(res + base + ch * V, r);
#pragma unroll
        for (int i = 0; i < V; ++i) v[c][i] += alpha * r[i];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) sum += v[c][i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[c][i] = 0.f;
    }
  }
  const float h = static_cast<float>(H);
  const float mean = rms ? 0.f : group_sum<TPR>(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (t + c * TPR < nchunk) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[c][i] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(group_sum<TPR>(sq) / h + eps);
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int ch = t + c * TPR;
    if (ch < nchunk) {
      float s[V], y[V];
      load_vec(scale + ch * V, s);
#pragma unroll
      for (int i = 0; i < V; ++i) y[i] = (v[c][i] - mean) * inv * s[i];
      if (bias != nullptr) {
        float b[V];
        load_vec(bias + ch * V, b);
#pragma unroll
        for (int i = 0; i < V; ++i) y[i] += b[i];
      }
      store_vec(out + base + ch * V, y);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* scale, const void* bias,
                   void* out, int M, int H, int rms, float eps, float alpha,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const T* sp = static_cast<const T*>(scale);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (H <= 32 * kMaxFloats) {
    const int rows = kThreads / 32;
    norm_kernel<T, 32><<<(M + rows - 1) / rows, kThreads, 0, stream>>>(
        xp, rp, sp, bp, op, M, H, rms, eps, alpha);
  } else {
    norm_kernel<T, kThreads><<<M, kThreads, 0, stream>>>(
        xp, rp, sp, bp, op, M, H, rms, eps, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

// x, res, out: [M, H] bf16; scale, bias: [H] bf16; res and bias may be null.
// The wrapper guarantees H % 8 == 0, H <= 16384 and 16-byte aligned pointers.
extern "C" int mlio_fused_norm(const void* x, const void* res, const void* scale,
                               const void* bias, void* out, int M, int H, int rms,
                               float eps, float alpha, void* stream) {
  if (M == 0) return 0;
  return launch<__nv_bfloat16>(x, res, scale, bias, out, M, H, rms, eps, alpha,
                               static_cast<cudaStream_t>(stream));
}
