// The warpgroup-product mainloop shared by K5 (quant_matmul.cu) and K11
// (fused_mlp.cu), on the structure K12 (ln_matmul.cu) proved on the card:
// two consumer warpgroups of 64 rows each own half of a 128-row block tile;
// 64-deep K tiles come through a ring of S stages in shared memory; the
// products are wgmma (wgmma.cuh) with A and B both read by the tensor cores
// from 128-byte swizzled tiles, B MN-major (a row-major [K, N] weight as it
// lies in device memory).
//
// A block runs a stream of n tiles, each filling one ring slot (g % S):
// load(g) starts its copies, by one thread's TMA requests (tma.cuh) counted
// in bytes on the slot's mbarrier, or by every thread's cp.async (with
// element-wise fills where a row allows no 16-byte copies) as one commit
// group, which every thread commits, copies or not. A kernel loop over the
// stream is:
//
//   ring.start(load, prep);
//   for g < n:
//     ring.before(g);                 // (no prep) tile g has landed
//     wgmma_fence(); ...products of tile g...; wgmma_commit();
//     ring.during(g, prep);           // (prep) tile g + 1 landed and prepared
//     drained = <g ends an epilogue> ? (wgmma_wait<0>(), epilogue, true) : false;
//     ring.after(g, drained, load);   // slot of tile g - 1 refilled with g + S - 1
//   ring.finish();
//
// The products and the epilogues stay in the kernel, so its accumulators
// never pass through a callable. prep(g) is K5's: it widens the raw
// quantised tile of slot g into bf16 B tiles while tile g - 1's products run,
// as K12 normalises x in place, and needs S >= 3 (tile g + 1 must have been
// asked for a step before it is prepared). Without prep (K11) S >= 2 does:
// tile g is waited for while tile g - 1's products run. after() waits for
// tile g - 1's products (unless the caller drained every product), makes
// what the threads wrote to shared memory visible to the tensor cores and
// the TMA (fence.proxy.async, then the block barrier), and refills the slot
// tile g - 1 read. On the cp.async path a thread sees only its own copies
// before a barrier: prep reads only the chunks the same thread copied, and
// before() adds a barrier for the products.
#pragma once

#include "cp_async.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace gemm {

constexpr int kWgThreads = 256;  // two consumer warpgroups
constexpr int kBM = 128;         // rows of a block tile
constexpr int kBK = 64;          // K depth of a tile: one 128-byte swizzle atom of bf16

template <int S, bool kTma, bool kPrep>
struct Ring {
  static_assert(S >= (kPrep ? 3 : 2), "a prepared tile is asked for two steps ahead");
  uint64_t* bars;  // kTma: one a slot
  int n;           // tiles in the stream

  // Thread 0 sets up the barriers (TMA path); every thread must call it.
  __device__ __forceinline__ void init() const {
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) tma::bar_init(&bars[s]);
        tma::bar_init_fence();
      }
      __syncthreads();
    }
  }

  // Tile g has landed: its slot's barrier phase, or this thread's own
  // copies with kNewer later groups still in flight.
  template <int kNewer>
  __device__ __forceinline__ void landed(int g) const {
    if constexpr (kTma) {
      tma::bar_wait_bounded(&bars[g % S], (g / S) & 1);
    } else {
      cp_wait<kNewer>();
    }
  }

  // The first S - 1 tiles asked for; with prep, tile 0 landed and prepared.
  template <class Load, class Prep>
  __device__ __forceinline__ void start(Load&& load, Prep&& prep) const {
    for (int g = 0; g < S - 1; ++g) load(g);
    if constexpr (kPrep) {
      if (n > 0) {
        landed<S - 2>(0);
        prep(0);
      }
      fence_proxy_async();
      __syncthreads();
    }
  }

  // Before tile g's products (no prep): wait for it; on the cp.async path
  // every thread's copies are published to the products.
  __device__ __forceinline__ void before(int g) const {
    if constexpr (!kPrep) {
      landed<S - 2>(g);
      if constexpr (!kTma) {
        fence_proxy_async();
        __syncthreads();
      }
    }
  }

  // While tile g's products run (prep): tile g + 1 landed and prepared.
  template <class Prep>
  __device__ __forceinline__ void during(int g, Prep&& prep) const {
    if constexpr (kPrep) {
      if (g + 1 < n) {
        landed<S - 3>(g + 1);
        prep(g + 1);
      }
    }
  }

  // After tile g's products were issued (and any epilogue ran): tile g - 1's
  // products done in both warpgroups, shared-memory writes published, and
  // the slot g - 1 read refilled with tile g + S - 1.
  template <class Load>
  __device__ __forceinline__ void after(int g, bool drained, Load&& load) const {
    if (!drained) wgmma_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load(g + S - 1);
  }

  // Every product done and no copy in flight: the ring may be reused.
  __device__ __forceinline__ void finish() const {
    wgmma_wait<0>();
    if constexpr (!kTma) cp_wait<0>();
    __syncthreads();
  }
};

// acc[64 x 128] += A (64 rows of a swizzled K-major tile from row r0,
// columns c0 .. c0 + 63) x B (a [64 x 128] MN-major tile): four k16 steps,
// kk < kk_end.
__device__ __forceinline__ void mma_k64(float (&acc)[16][4], const void* a, int r0, int c0,
                                        const void* b, int kk_end = 4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < kk_end) wgmma_ss_n128<1>(acc, kmajor(a, r0, c0 + 16 * kk), mnmajor(b, 16 * kk), 1);
}

// Start the copy of 8 elements of a row (row points at its column 0) from
// column c into a 16-byte shared slot, zeros past cols or where !ok: one
// cp.async where vec allows it, else element by element through registers.
// `any` is a valid address for the zero fill.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* row, int c, int cols, bool ok,
                                      bool vec, const void* any) {
  ok = ok && c < cols;
  if (!ok || (vec && c + 8 <= cols)) {
    cp_async16(dst, ok ? row + c : any, ok);
    return;
  }
  uint4 v = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&v);
  for (int i = 0; i < 8 && c + i < cols; ++i) e[i] = row[c + i];
  *reinterpret_cast<uint4*>(dst) = v;
}

// A warpgroup's accumulator element (n-tile n, e) as (row, column) in its
// 64 x 128 tile: lane l holds rows l/4 and l/4 + 8 of its warp's 16,
// columns 2(l%4) and + 1 of every 8 (wgmma.cuh).
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x % 128) / 32) * 16 + (threadIdx.x % 32) / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int n, int e) {
  return 8 * n + 2 * (threadIdx.x % 4) + (e & 1);
}

}  // namespace gemm
