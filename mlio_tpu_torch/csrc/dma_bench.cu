// K14: the H100's bandwidth probe, two streams over w [n, 512, C] bf16
// chunks, each giving o [8, 128] fp32 and a checksum of every word read.
//
// Replaces dma_bench.py::_auto_kernel (the automatic pipeline: o = sum over
// chunks of w[i, :8, :128] + x, x added once a chunk) and _manual_kernel
// (manual depth-N DMA: o = sum over chunks of w[i, :8, :128] + x, x once).
//
// Both streams compute their result from the bytes they stream: each block
// adds the corner of every chunk it reads (from its own loads, or from the
// ring slot that holds it) into a [8, 128] fp32 partial in shared memory, in
// chunk order, and a small second launch sums the blocks' partials in block
// order and adds x. Besides, every block sums word_j * (j + 1) mod 2^32 over
// the 32-bit words j of w that it read (j the word's index in w), and the
// second launch adds the blocks' sums: a stream that skips, repeats or
// misplaces a slice gives another checksum than utils/dma_bench.py's plain
// one.
//
// Bound: bytes, n * 512 * C * 2 read once; the probe exists to measure the
// rate at which the card delivers them (the spec sheet's 3.35 TB/s is the
// published peak).
//
// Design. Auto: the TPU's grid walks the chunks one after another, its
// pipeline fetching the next while the body runs. Here `streams` blocks an
// SM take chunks b, b + grid, ..., and their 256 threads read each with
// 16-byte loads, U in flight a thread (ld.global.cs through inline asm).
// Manual: the TPU kernel keeps depth - 1 async copies in flight a stream;
// here one thread of each block keeps `depth` cp.async.bulk copies of
// `slice` bytes in flight into a ring of shared-memory slots, each slot with
// an mbarrier that the copy completes (expect_tx), walking the block's
// slices of the stream; the block's threads read a slot once it is full and
// the slot is refilled after a block barrier; `streams` blocks share an SM.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8, kCols = 128;  // the [8, 128] corner of a chunk
constexpr int kCorner = kRows * kCols;
constexpr int kChunkRows = 512;

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The checksum's terms of the 16-byte vector g of w: its words 4g..4g+3
// times their indices plus one, mod 2^32.
__device__ __forceinline__ unsigned mix(const uint4& a, size_t g) {
  const unsigned base = static_cast<unsigned>(g) * 4u;
  return base * (a.x + a.y + a.z + a.w) + a.x + 2u * a.y + 3u * a.z + 4u * a.w;
}

// Vector `within` of a chunk (C / 8 vectors a row): where it lies in the
// [8, 128] corner, add its 8 bf16 values to acc.
__device__ __forceinline__ void corner_add(float* acc, size_t within, int C, const uint4& a) {
  const int rowvecs = C / 8;
  if (within >= static_cast<size_t>(C) || static_cast<int>(within % rowvecs) >= kCols / 8) return;
  const int r = static_cast<int>(within / rowvecs), c = static_cast<int>(within % rowvecs) * 8;
  const unsigned words[4] = {a.x, a.y, a.z, a.w};
  float* o = acc + r * kCols + c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] += __uint_as_float(words[j] << 16);
    o[2 * j + 1] += __uint_as_float(words[j] & 0xffff0000u);
  }
}

// The block's corner partial and checksum into its row of the work buffer:
// part [grid][kCorner] fp32, then sums [grid] u32.
__device__ void block_out(const float* acc, unsigned h, float* part, unsigned* sums,
                          unsigned* red) {
  for (int o = 16; o; o >>= 1) h += __shfl_xor_sync(0xffffffffu, h, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = h;
  __syncthreads();
  for (int e = threadIdx.x; e < kCorner; e += kThreads)
    part[static_cast<size_t>(blockIdx.x) * kCorner + e] = acc[e];
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int k = 0; k < kThreads / 32; ++k) s += red[k];
    sums[blockIdx.x] = s;
  }
}

// Each thread handles the vectors v = threadIdx.x + k * kThreads of a chunk;
// a chunk holds 64 * C vectors, a multiple of U * kThreads (C % 128 == 0),
// so the thread that adds a corner position is the same in every chunk and
// adds it in chunk order.
template <int U>
__global__ void __launch_bounds__(kThreads) auto_kernel(const __nv_bfloat16* w, int n, int C,
                                                        float* part, unsigned* sums) {
  __shared__ float acc[kCorner];
  __shared__ unsigned red[kThreads / 32];
  for (int e = threadIdx.x; e < kCorner; e += kThreads) acc[e] = 0.f;
  __syncthreads();
  const size_t vecs = static_cast<size_t>(kChunkRows) * C * 2 / 16;  // 16-byte vectors a chunk
  unsigned h = 0;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t g0 = static_cast<size_t>(i) * vecs;
    const uint4* base = reinterpret_cast<const uint4*>(w) + g0;
    for (size_t v = threadIdx.x; v < vecs; v += U * kThreads) {
      uint4 a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = ld_stream(base + v + u * kThreads);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t vv = v + u * kThreads;
        h += mix(a[u], g0 + vv);
        corner_add(acc, vv, C, a[u]);
      }
    }
  }
  __syncthreads();
  block_out(acc, h, part, sums, red);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The block's slices are k = 0, 1, ... at byte offset (blockIdx.x + k *
// grid) * slice; a slice (at most a chunk, a multiple of 256 bytes) holds a
// corner row's 256 bytes whole or not at all. The block barrier after each
// slot orders the corner additions across slots, so each position is added
// in chunk order.
__global__ void __launch_bounds__(kThreads) manual_kernel(const __nv_bfloat16* w, int n, int C,
                                                          float* part, unsigned* sums, int depth,
                                                          int slice) {
  // [depth][slice] ring, then acc [kCorner] fp32, red, and depth mbarriers
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* acc = reinterpret_cast<float*>(smem + static_cast<size_t>(depth) * slice);
  unsigned* red = reinterpret_cast<unsigned*>(acc + kCorner);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + kThreads / 32);
  for (int e = threadIdx.x; e < kCorner; e += kThreads) acc[e] = 0.f;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(w);
  const size_t vecs = static_cast<size_t>(kChunkRows) * C * 2 / 16;
  const size_t total = static_cast<size_t>(n) * kChunkRows * C * 2;
  const size_t slices = total / slice;  // the wrapper makes the stream a whole number of slices
  const size_t mine = slices > blockIdx.x ? (slices - blockIdx.x - 1) / gridDim.x + 1 : 0;
  const int svecs = slice / 16;
  auto issue = [&](size_t k, int d) {
    const unsigned char* g = src + (blockIdx.x + k * gridDim.x) * static_cast<size_t>(slice);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_u32(bars + d)), "r"(slice) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(ring + static_cast<size_t>(d) * slice)), "l"(g), "r"(slice),
        "r"(smem_u32(bars + d))
        : "memory");
  };
  if (threadIdx.x == 0) {
    for (int d = 0; d < depth; ++d)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bars + d)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (size_t k = 0; k < mine && k < static_cast<size_t>(depth); ++k)
      issue(k, static_cast<int>(k));
  }
  __syncthreads();
  unsigned h = 0;
  for (size_t k = 0; k < mine; ++k) {
    const int d = static_cast<int>(k % depth);
    const unsigned phase = static_cast<unsigned>((k / depth) & 1);
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n"
        "}\n" ::"r"(smem_u32(bars + d)),
        "r"(phase)
        : "memory");
    const uint4* slot = reinterpret_cast<const uint4*>(ring + static_cast<size_t>(d) * slice);
    const size_t g0 = (blockIdx.x + k * gridDim.x) * static_cast<size_t>(svecs);
    for (int v = threadIdx.x; v < svecs; v += kThreads) {
      const uint4 a = slot[v];
      h += mix(a, g0 + v);
      corner_add(acc, (g0 + v) % vecs, C, a);
    }
    __syncthreads();  // slot d is read; it may be refilled
    if (threadIdx.x == 0 && k + depth < mine) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(k + depth, d);
    }
  }
  block_out(acc, h, part, sums, red);
}

// out = the blocks' corner partials summed in block order + x * x_times;
// checksum = the blocks' sums.
__global__ void finish_kernel(const float* part, const unsigned* sums, int blocks,
                              const float* x, float x_times, float* out, unsigned* checksum) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < kCorner) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part[static_cast<size_t>(b) * kCorner + e];
    out[e] = s + x[0] * x_times;
  }
  if (e == 0) {
    unsigned c = 0;
    for (int b = 0; b < blocks; ++b) c += sums[b];
    checksum[0] = c;
  }
}

}  // namespace

// kind 0: the auto stream, `streams` blocks an SM with `depth` (4 or 8)
// loads in flight a thread; kind 1: the manual stream, `depth` slots of
// `slice` bytes a block, `streams` blocks an SM. `work` holds the blocks'
// partials: grid * (kCorner + 1) 32-bit words, grid = SMs * streams.
extern "C" int mlio_dma_bench(int kind, const void* w, int n, int C, const float* x, float* out,
                              unsigned* checksum, void* work, int depth, int slice, int streams,
                              void* stream) {
  if (n < 1 || C % 128 || streams < 1 ||
      (kind == 0 && depth != 4 && depth != 8) ||
      (kind == 1 && (depth < 1 || slice < 256 || slice % 256 ||
                     static_cast<size_t>(slice) > static_cast<size_t>(kChunkRows) * C * 2)))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const int grid = sms * streams;
  float* part = static_cast<float*>(work);
  unsigned* sums = reinterpret_cast<unsigned*>(part + static_cast<size_t>(grid) * kCorner);
  if (kind == 0) {
    if (depth == 4)
      auto_kernel<4><<<grid, kThreads, 0, s>>>(wp, n, C, part, sums);
    else
      auto_kernel<8><<<grid, kThreads, 0, s>>>(wp, n, C, part, sums);
  } else {
    const size_t total = static_cast<size_t>(n) * kChunkRows * C * 2;
    if (total % slice) return cudaErrorInvalidValue;
    const int smem = depth * slice + kCorner * 4 + (kThreads / 32) * 4 + depth * 8;
    if ((e = cudaFuncSetAttribute(manual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
      return e;
    manual_kernel<<<grid, kThreads, smem, s>>>(wp, n, C, part, sums, depth, slice);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  finish_kernel<<<kCorner / kThreads, kThreads, 0, s>>>(
      part, sums, grid, x, kind == 0 ? static_cast<float>(n) : 1.f, out, checksum);
  return cudaGetLastError();
}
