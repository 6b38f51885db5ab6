// The warp-specialised flash attention body shared by K10 (flash_stream.cu)
// and K1 at head dim 256 (flash_fwd_d256.cu): a TMA producer warp and two
// consumer warpgroups of 64 q rows on wgmma, with their register budgets,
// named barriers, the K/V tile descriptors and products, the online
// softmax on the accumulators, the zeroing of V rows past kv_len and the
// output's epilogue.
//
// A K or V tile is BKV keys x D columns in the 128-byte swizzle
// (wgmma.cuh), as D / 64 panels of BKV rows x 128 bytes, one TMA box each:
// K is read K-major by S = Q K^T, V MN-major by O += P V. A consumer's
// state: this thread holds rows g and g + 8 of its warp's 16 (g = lane / 4),
// and in each 8-column n-tile the columns 2 (lane % 4) and + 1.
#pragma once

#include "tma.cuh"
#include "wgmma.cuh"

#include <math.h>

namespace ws {

using bf16 = __nv_bfloat16;
using gemm::kmajor;
using gemm::wgmma_desc;

constexpr int kWg = 128;           // threads a warpgroup
constexpr int kThreads = 3 * kWg;  // the producer and two consumers
constexpr int kConsumerWarps = 8;  // arrivals that release a K or V slot
// setmaxnreg moves registers within the block: launched at 168 a thread
// (65,536 / 384, rounded down to a multiple of 8), the producer gives up
// 128 x (168 - 24) = 18,432, exactly what the consumers take to reach 240;
// a producer left at 32 would give 1,024 too few, and the consumers' request
// would wait forever.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr float kLog2e = 1.4426950408889634f;

// Named barriers (0 is __syncthreads): consumer w publishes its scaled Q
// tile to its own four warps at kQReady + w.
constexpr int kQReady = 1;

// A block's mbarriers: the full and empty barriers of the SK stages of K's
// ring and of the SV stages of V's apart (a K slot is refilled as soon as
// both consumers' S products have read it, V one tile later), Q's of each
// consumer, and the tail V tile's (the one whose rows past kv_len the
// producer zeroes).
template <int SK, int SV = SK>
struct Bars {
  uint64_t* full_k;
  uint64_t* empty_k;
  uint64_t* full_v;
  uint64_t* empty_v;
  uint64_t* q;
  uint64_t* tail;
  static constexpr int kCount = 2 * SK + 2 * SV + 3;
  __device__ explicit Bars(uint64_t* b)
      : full_k(b), empty_k(b + SK), full_v(b + 2 * SK), empty_v(b + 2 * SK + SV),
        q(b + 2 * SK + 2 * SV), tail(b + 2 * SK + 2 * SV + 2) {}
  // Thread 0, before the block's first barrier: the full barriers count
  // one arrival (the producer's, with the bytes), the empty ones a release
  // by every consumer warp.
  __device__ void init() const {
    for (int i = 0; i < SK; ++i) {
      tma::bar_init(&full_k[i]);
      tma::bar_init(&empty_k[i], kConsumerWarps);
    }
    for (int i = 0; i < SV; ++i) {
      tma::bar_init(&full_v[i]);
      tma::bar_init(&empty_v[i], kConsumerWarps);
    }
    tma::bar_init(&q[0]);
    tma::bar_init(&q[1]);
    tma::bar_init(tail);
    tma::bar_init_fence();
  }
};

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The registers of p (the A operand of an asynchronous PV product) kept
// live, unchanged, up to here: the product reads them until its group is
// waited for.
template <int KK>
__device__ __forceinline__ void fence_pa(uint32_t (&pa)[KK][4]) {
#pragma unroll
  for (int k = 0; k < KK; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[k][e])::"memory");
}

// A K tile (BKV rows as N, columns c0 .. c0 + 15 as K): each 64-column panel
// of the tile is BKV rows of 128 bytes, the next panel BKV x 128 bytes on.
template <int BKV>
__device__ __forceinline__ uint64_t k_desc(const bf16* k_t, int c0) {
  return wgmma_desc(reinterpret_cast<const unsigned char*>(k_t) + (c0 >> 6) * (BKV * 128) +
                        (c0 & 63) * 2,
                    16, 1024);
}
// A V tile MN-major: keys [r0, r0 + 16) as K, every column as N; along N the
// next 64 columns BKV x 128 bytes on.
template <int BKV>
__device__ __forceinline__ uint64_t v_desc(const bf16* v_t, int r0) {
  return wgmma_desc(reinterpret_cast<const unsigned char*>(v_t) + r0 * 128, BKV * 128, 1024);
}

// S[64 x BKV] = (q * scale) K^T: q (64 rows, K-major) and K from shared memory.
template <int D, int BKV>
__device__ __forceinline__ void s_product(float (&s)[BKV / 8][4], const bf16* q_t,
                                          const bf16* k_t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (BKV == 128)
      gemm::wgmma_ss_n128<0>(s, kmajor(q_t, 0, 16 * kk), k_desc<BKV>(k_t, 16 * kk), kk > 0);
    else if constexpr (BKV == 64)
      gemm::wgmma_ss_n64(s, kmajor(q_t, 0, 16 * kk), k_desc<BKV>(k_t, 16 * kk), kk > 0);
    else
      gemm::wgmma_ss_n32(s, kmajor(q_t, 0, 16 * kk), k_desc<BKV>(k_t, 16 * kk), kk > 0);
  }
}

// O[64 x D] += P V: p from registers, V MN-major from shared memory; past
// 128 columns (D 256) two n128 products, each over two panels of V and
// into its half of O.
template <int D, int BKV>
__device__ __forceinline__ void pv_product(float (&o)[D / 8][4],
                                           const uint32_t (&pa)[BKV / 16][4], const bf16* v_t) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    if constexpr (D <= 128) {
      gemm::wgmma_rs<D, 1>(o, pa[kk], v_desc<BKV>(v_t, 16 * kk), 1);
    } else {
#pragma unroll
      for (int h = 0; h < D / 128; ++h)
        gemm::wgmma_rs<128, 1>(*reinterpret_cast<float(*)[16][4]>(&o[16 * h]), pa[kk],
                               v_desc<BKV>(v_t + h * 2 * BKV * 64, 16 * kk), 1);
    }
  }
}

// The online softmax of one tile's scores, rows g (i = 0) and g + 8 (i = 1)
// of this thread's warp: masked (the diagonal tile, the kv_len tail) or not;
// s becomes p (fp32), m and l move on, alpha rescales O.
template <int BKV>
__device__ __forceinline__ void softmax(float (&s)[BKV / 8][4], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], bool masked, int kv0, int row_abs0,
                                        int kvl, int causal) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (masked) {
      const int row_abs = row_abs0 + 8 * i;
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + n * 8 + 2 * t4 + e;
          if (!(col < kvl && (!causal || row_abs >= col))) s[n][2 * i + e] = -INFINITY;
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[i] = (m[i] == -INFINITY) ? 0.f : exp2f((m[i] - m_safe) * kLog2e);
    const float mb = m_safe * kLog2e;
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[n][2 * i + e], kLog2e, -mb));  // exp(-inf) = 0
        s[n][2 * i + e] = p;
        psum += p;
      }
    }
    l[i] = l[i] * alpha[i] + psum;
    m[i] = m_new;
  }
}

// O rescaled by alpha once its PV product has landed.
template <int NT>
__device__ __forceinline__ void rescale(float (&o)[NT][4], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// A consumer's q tile (64 rows of D) scaled in place: q * scale in fp32,
// rounded to bf16, element by element, so the swizzle does not matter; then
// made visible to the products (fence.proxy.async) and published to the
// consumer's four warps (named barrier kQReady + w).
template <int D>
__device__ __forceinline__ void scale_q(bf16* q_t, float scale, int w) {
  for (int c = threadIdx.x % kWg; c < 64 * D / 8; c += kWg) {
    float f[8];
    uint4* p = reinterpret_cast<uint4*>(q_t) + c;
    unpack_vec<bf16>(*p, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= scale;
    store_vec(reinterpret_cast<bf16*>(p), f);
  }
  gemm::fence_proxy_async();
  named_sync(kQReady + w, kWg);
}

// Rows [r0, BKV) of a V tile (0 < r0 < BKV) zeroed by one warp, where the
// tile reaches past kv_len: those rows arrive as the cache holds them
// (stale, or NaN), p is 0 there, and 0 * NaN is NaN. The swizzle moves
// chunks within a row only, so whole rows are zeroed in place. Made
// visible to the products.
template <int D, int BKV>
__device__ __forceinline__ void zero_rows(bf16* v_t, int r0) {
  constexpr int kPanels = D / 64;
  const int lane = threadIdx.x % 32, chunks = (BKV - r0) * 8;
  unsigned char* t = reinterpret_cast<unsigned char*>(v_t);
  for (int c = lane; c < chunks * kPanels; c += 32) {
    const int panel = c / chunks, rest = c % chunks;
    *reinterpret_cast<uint4*>(t + panel * BKV * 128 + (r0 + rest / 8) * 128 + (rest % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  gemm::fence_proxy_async();
  __syncwarp();
}

// a / b, correctly rounded, given y = 1 / b correctly rounded: a product
// and the remainder's correction (two FMAs), the same bits as IEEE
// division for the operands here (normal, no overflow), where division
// takes a reciprocal and its range checks an element (a 256-wide row's
// 128 divisions a thread cost K1 at D 256 several percent).
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return fmaf(fmaf(-q, b, a), y, q);
}

// out = O / l, rounded to bf16 (0 for a row with no valid key), for the
// consumer's rows row0 + 16 warp + g (+ 8) below Sq; orow(qr) is row qr's
// output (its head's D values). With lse (non-null at (b, h)'s row 0),
// lse = m + log(l), -inf for a row with no valid key.
template <int D, class Out>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], const float (&m)[2],
                                           const float (&l)[2], int row0, int Sq, Out orow,
                                           float* lse) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % kWg) / 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qr = row0 + warp * 16 + g + 8 * i;
    if (qr < Sq) {
      const float l_safe = (lt == 0.f) ? 1.f : lt, y = __frcp_rn(l_safe);
      bf16* out = orow(qr);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) = gemm::pack_bf16(
            div_rn(o[n][2 * i], l_safe, y), div_rn(o[n][2 * i + 1], l_safe, y));
      if (lse != nullptr && t4 == 0)
        lse[qr] = (lt == 0.f) ? -INFINITY : (m[i] == -INFINITY ? 0.f : m[i]) + logf(l_safe);
    }
  }
}

}  // namespace ws
