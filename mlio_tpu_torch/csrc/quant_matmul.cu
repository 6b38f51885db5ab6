// K5: the dequant-fused matmul, for Hopper.
//
// Replaces mlio_tpu/ops/quant.py::_quant_matmul_kernel (:221, int8),
// _int4_matmul_kernel (:240, int4, per-channel scales) and
// _int4_group_matmul_kernel (:263, int4, group scales), with their
// pallas_calls at :386 and :426. x [M, K] bf16, out [M, N] bf16:
//   int8          out = (x @ q) * scale[n]                    q [K, N] int8
//   int4          out = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale[n]
//   int4 grouped  out = sum_g (x_lo,g @ lo_g) * scale[g, n] + (x_hi,g @ hi_g) * scale[K/2g + g, n]
// where q [K/2, N] packs row i (low nibble, "lo") with row i + K/2 (high
// nibble, "hi"), each sign-extended from 4 bits; the sums are fp32.
//
// Bound: operations at prefill-sized M, bytes at decode-sized M. At GPT-2's
// up projection (M 5,632, K 768, N 3,072) 26.6 GFLOP, 27 us at 989 TFLOP/s
// (H100 SXM data sheet), against 13.4 MB (4 us at ~3.2 TB/s); at llama3-8b's
// (M 2,048, K 4,096, N 14,336) 240 GFLOP, 0.243 ms. At M 8 the 2.4 MB of
// int8 weights, 0.75 us. The weight crosses device memory quantised and is
// widened to bf16 in shared memory, exactly for |q| <= 127, so the tensor
// cores see bf16 and no dequantised copy is ever written.
//
// The earlier kernel (mma.sync on gemm_tile.cuh's loop, 128 x 128 tiles)
// ran 0.163 ms at GPT-2's shape, 2.4x its library call (x @ dequantize(q)).
// What held it back, and what this design does about each:
// - 32-deep K tiles through a double buffer staged in registers, every
//   thread loading and widening 16 bytes of q and 16 of x a tile, and one
//   barrier per two k16 steps: here a block takes a 128 x 256 output tile
//   (128 x 128 for int4) with 64-deep K tiles (64 rows of q; for int4, 64
//   packed rows whose low nibbles meet x's columns [64t, 64t + 64) and high
//   nibbles K/2 + [64t, 64t + 64)) through the three-stage ring of
//   gemm_wgmma.cuh, so each barrier encloses four k16 steps of two m64n128
//   products a warpgroup.
// - The loads: one thread asks the TMA (tma.cuh) for x's [128 x 64] box (two
//   for int4, one a half) swizzled by the hardware, and for q's raw
//   [64 x 256] bytes (64 x 128 for int4), which land unswizzled; zeros past
//   M, N and K (K/2). Where x's rows are not a multiple of 8 elements (16
//   for int4, whose second half starts at K/2) or q's rows not a multiple of
//   16 bytes, every thread copies by cp.async, element by element where a
//   row allows no 16-byte copies. The shape alone chooses the path: a tensor
//   map that the driver refuses is returned as an error.
// - The widening: while tile t's products run, the threads widen tile t + 1's
//   raw bytes into the slot's bf16 B tile in the 128-byte swizzled layout
//   (int8 through fp32 by the 2^23 bias, int4 through bf16 by the 128 bias,
//   both exact), then fence and hand it to the products at the step's
//   barrier, as K12 normalises x in place. The scales are not applied here:
//   scaling the weights before the product would add a bf16 rounding the
//   JAX kernels do not have.
// - mma.sync through ldmatrix: here wgmma (wgmma.cuh) from shared memory,
//   A the swizzled x box, B the widened tile read MN-major.
// Per-channel scales multiply the fp32 accumulators in the epilogue. With
// group scales (g a multiple of 16) each group's lo and hi partial sums run
// in their own fp32 accumulators and are added as plo * s_lo + phi * s_hi
// when the group ends, as the JAX kernel does; three accumulator sets of
// 64 x 128 a warpgroup are why int4 takes 128-column tiles. A group of 16 or
// 32 ends inside a 64-deep tile, so its scaling drains the products after
// the k16 step that ends it. The output tile goes out through shared memory
// in 16-byte row chunks; every output element has one writer. Blocks walk
// the row tiles fastest, so that the blocks in flight share a band of q's
// columns in L2. The JAX package sends M <= 32 to an XLA dot, a split
// measured on the TPU; here every M runs this kernel, whose M = 8 time
// PERF.md keeps beside the library's.
#include "gemm_wgmma.cuh"

namespace {

using namespace gemm;

enum Kind { kInt8 = 0, kInt4 = 1, kInt4Group = 2 };

constexpr int kStages = 3;
constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory a block may have (227 KB)

// A stage: the x box(es) [128 x 64] bf16 (lo, then hi for int4), q's raw
// tile [64 x BN] bytes, and its widened bf16 B tile(s) [64 x BN] (lo, then
// hi for int4); each 1 KB aligned. Then the TMA path's barriers.
template <int BN, bool kI4>
struct Smem {
  static constexpr size_t kXBox = size_t(kBM) * kBK * 2;
  static constexpr size_t kRaw = size_t(kBK) * BN;
  static constexpr size_t kW = size_t(kBK) * BN * 2;
  static constexpr size_t kXOff = 0;
  static constexpr size_t kRawOff = (kI4 ? 2 : 1) * kXBox;
  static constexpr size_t kWOff = kRawOff + (kRaw + 1023) / 1024 * 1024;
  static constexpr size_t kStage = kWOff + (kI4 ? 2 : 1) * kW;
  static constexpr size_t kBars = kStages * kStage;
  static constexpr size_t kBytes = kBars + kStages * sizeof(uint64_t);
  static_assert(size_t(kBM) * (BN + 8) * 2 <= kBars, "the output tile fits in the ring");
  static_assert(kBytes <= kMaxSmem, "the ring fits in shared memory");
};

struct QmArgs {
  const bf16* x;
  const int8_t* q;
  const float* scale;
  bf16* out;
  int M, N, K;
  int group;  // kInt4Group: rows a group (a multiple of 16 dividing K/2)
  int vec_x;  // cp.async path: x's rows allow 16-byte copies (K % 8, int4 K % 16)
  int vec_q;  // cp.async path: q's rows allow 16-byte copies (N % 16)
};

struct QMaps {
  CUtensorMap xlo, xhi, q;  // xhi: int4's second half of x's columns
};

// 16 int8 (one 16-byte raw chunk) as 16 bf16 in two 16-byte vectors, exact:
// u = q + 128 in the low byte of 2^23's mantissa, less 2^23 + 128, in fp32.
__device__ __forceinline__ void widen_i8(const uint4& raw, uint4& lo8, uint4& hi8) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u + b)) - 8388736.f;
    o[2 * i] = pack_bf16(f[0], f[1]);
    o[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  lo8 = make_uint4(o[0], o[1], o[2], o[3]);
  hi8 = make_uint4(o[4], o[5], o[6], o[7]);
}

// Four columns' packed bytes (one word) as their low and high nibbles, each
// sign-extended, as two bf16 pairs each: u = nibble + 8 in the low bits of
// 128's bf16 mantissa, less 136 in bf16 (exact).
__device__ __forceinline__ void widen_i4(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const uint32_t in[4] = {
      __byte_perm(l, 0x43434343u, 0x4140u), __byte_perm(l, 0x43434343u, 0x4342u),
      __byte_perm(h, 0x43434343u, 0x4140u), __byte_perm(h, 0x43434343u, 0x4342u)};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&in[i]), bias);
    out[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  lo[0] = out[0];
  lo[1] = out[1];
  hi[0] = out[2];
  hi[1] = out[3];
}

// The block's output tile [128 x 128 NH] from the two warpgroups'
// accumulators, rounded to bf16, through shared memory so (rows padded by 16
// bytes so that the eight rows a warp instruction stores fall in distinct
// banks), then written a 16-byte chunk of a row a thread, masked past M and
// N. The caller has made so free (Ring::finish).
template <int NH>
__device__ __forceinline__ void store_tile(float (&acc)[NH][16][4], bf16* so, bf16* out, int m0,
                                           int n0, int M, int N) {
  constexpr int BN = 128 * NH, kPitch = BN + 8;
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = so + (wg * 64 + acc_row(2 * i)) * kPitch;
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<uint32_t*>(row + hf * 128 + acc_col(n, 0)) =
            pack_bf16(acc[hf][n][2 * i], acc[hf][n][2 * i + 1]);
  }
  __syncthreads();
  const bool vec = N % 8 == 0;
#pragma unroll 4
  for (int c = threadIdx.x; c < kBM * BN / 8; c += kWgThreads) {
    const int r = c / (BN / 8), n = n0 + (c % (BN / 8)) * 8;
    if (m0 + r >= M || n >= N) continue;
    const bf16* src = so + r * kPitch + (c % (BN / 8)) * 8;
    bf16* dst = out + static_cast<size_t>(m0 + r) * N + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

// BN: 256 for int8 (one accumulator set of 64 x 256 a warpgroup), 128 for
// int4 (the grouped instance keeps three sets of 64 x 128).
template <int BN, int KIND, bool kTma>
__global__ void __launch_bounds__(kWgThreads, 1)
quant_matmul_kernel(const QmArgs a, const __grid_constant__ QMaps maps) {
  constexpr bool kI4 = KIND != kInt8;
  constexpr bool kGroup = KIND == kInt4Group;
  constexpr int NH = BN / 128;
  using L = Smem<BN, kI4>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int n_mb = (a.M + kBM - 1) / kBM;
  const int m0 = (blockIdx.x % n_mb) * kBM, n0 = (blockIdx.x / n_mb) * BN;
  const int rows = kI4 ? a.K / 2 : a.K;  // q's rows
  const int Kh = a.K / 2;

  const Ring<kStages, kTma, true> ring{reinterpret_cast<uint64_t*>(smem + L::kBars),
                                       (rows + kBK - 1) / kBK};
  ring.init();

  // Tile t: x's columns [64t, 64t + 64) (and K/2 + that for int4) and q's
  // rows [64t, 64t + 64) of columns [n0, n0 + BN).
  auto load = [&](int t) {
    unsigned char* st = smem + (t % kStages) * L::kStage;
    if constexpr (kTma) {
      if (tid == 0 && t < ring.n) {
        uint64_t* bar = ring.bars + t % kStages;
        tma::bar_expect(bar, static_cast<uint32_t>((kI4 ? 2 : 1) * L::kXBox + L::kRaw));
        tma::load_2d(st + L::kXOff, &maps.xlo, t * kBK, m0, bar);
        if constexpr (kI4) tma::load_2d(st + L::kXOff + L::kXBox, &maps.xhi, t * kBK, m0, bar);
        tma::load_2d(st + L::kRawOff, &maps.q, n0, t * kBK, bar);
      }
      return;
    }
    if (t < ring.n) {
      constexpr int kXChunks = (kI4 ? 2 : 1) * kBM * kBK / 8;
      // not unrolled: the grouped instance's accumulators take the registers
#pragma unroll 1
      for (int i = 0; i < kXChunks / kWgThreads; ++i) {
        const int c = tid + i * kWgThreads, half = c / (kBM * kBK / 8), cc = c % (kBM * kBK / 8);
        const int r = cc / 8, m = m0 + r;
        const bf16* row = a.x + static_cast<size_t>(m < a.M ? m : 0) * a.K + half * Kh;
        copy8(at_sw128(reinterpret_cast<bf16*>(st + L::kXOff + half * L::kXBox), r, (cc % 8) * 8),
              row, t * kBK + (cc % 8) * 8, kI4 ? Kh : a.K, m < a.M, a.vec_x, a.x);
      }
      // q's raw chunks: chunk c is row c / (BN / 16), bytes (c % (BN / 16)) * 16;
      // prep widens the chunks the same thread copied
#pragma unroll 1
      for (int i = 0; i < kBK * BN / 16 / kWgThreads; ++i) {
        const int c = tid + i * kWgThreads, r = c / (BN / 16), nb = (c % (BN / 16)) * 16;
        const int k = t * kBK + r, n = n0 + nb;
        unsigned char* dst = st + L::kRawOff + r * BN + nb;
        const bool ok = k < rows && n < a.N;
        const int8_t* src = a.q + static_cast<size_t>(k) * a.N + n;
        if (!ok || (a.vec_q && n + 16 <= a.N)) {
          cp_async16(dst, ok ? src : a.q, ok);
        } else {
          uint4 v = make_uint4(0, 0, 0, 0);
          int8_t* e = reinterpret_cast<int8_t*>(&v);
          for (int j = 0; j < 16 && n + j < a.N; ++j) e[j] = src[j];
          *reinterpret_cast<uint4*>(dst) = v;
        }
      }
    }
    cp_commit();
  };

  // Widen tile t's raw q into its bf16 B tile(s), MN-major swizzled:
  // element (k, n) at at_sw128(W, k, n).
  auto prep = [&](int t) {
    unsigned char* st = smem + (t % kStages) * L::kStage;
    bf16* w = reinterpret_cast<bf16*>(st + L::kWOff);
#pragma unroll
    for (int i = 0; i < kBK * BN / 16 / kWgThreads; ++i) {
      const int c = tid + i * kWgThreads, r = c / (BN / 16), nb = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + L::kRawOff + r * BN + nb);
      if constexpr (!kI4) {
        uint4 lo8, hi8;
        widen_i8(raw, lo8, hi8);
        *reinterpret_cast<uint4*>(at_sw128(w, r, nb)) = lo8;
        *reinterpret_cast<uint4*>(at_sw128(w, r, nb + 8)) = hi8;
      } else {
        bf16* whi = reinterpret_cast<bf16*>(st + L::kWOff + L::kW);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t l2[2], h2[2];
          widen_i4(words[j], l2, h2);
          lo[2 * j] = l2[0];
          lo[2 * j + 1] = l2[1];
          hi[2 * j] = h2[0];
          hi[2 * j + 1] = h2[1];
        }
        *reinterpret_cast<uint4*>(at_sw128(w, r, nb)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(at_sw128(w, r, nb + 8)) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        *reinterpret_cast<uint4*>(at_sw128(whi, r, nb)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(at_sw128(whi, r, nb + 8)) =
            make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
  };

  float acc[NH][16][4];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) zero(acc[hf]);
  // kGroup: the current group's lo and hi partial sums (unused otherwise)
  float plo[kGroup ? 16 : 1][4], phi[kGroup ? 16 : 1][4];
  if constexpr (kGroup) {
    zero(plo);
    zero(phi);
  }
  // Group gi ends: acc += plo * s_lo + phi * s_hi, by this thread's columns
  // (the next group's first products overwrite plo and phi: scale_d 0).
  auto scale_group = [&](int gi) {
    if constexpr (kGroup) {
      const float* slo = a.scale + static_cast<size_t>(gi) * a.N;
      const float* shi = a.scale + static_cast<size_t>(Kh / a.group + gi) * a.N;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + acc_col(n, e);
          const float sl = col < a.N ? slo[col] : 0.f, sh = col < a.N ? shi[col] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            acc[0][n][2 * h + e] += plo[n][2 * h + e] * sl + phi[n][2 * h + e] * sh;
        }
      }
    }
  };

  ring.start(load, prep);
  for (int t = 0; t < ring.n; ++t) {
    ring.before(t);
    const unsigned char* st = smem + (t % kStages) * L::kStage;
    const unsigned char* sx = st + L::kXOff;
    const unsigned char* w = st + L::kWOff;
    const int kk_end = min(4, (rows - t * kBK + 15) / 16);  // k16 steps inside q's rows
    bool drained = false;
    wgmma_fence();
    if constexpr (!kI4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hf = 0; hf < NH; ++hf)
          wgmma_ss_n128<1>(acc[hf], kmajor(sx, wg * 64, 16 * kk),
                           mnmajor(w + hf * 64 * 128 * 2, 16 * kk), 1);
      wgmma_commit();
      ring.during(t, prep);
    } else if constexpr (!kGroup) {
      mma_k64(acc[0], sx, wg * 64, 0, w, kk_end);
      mma_k64(acc[0], sx + L::kXBox, wg * 64, 0, w + L::kW, kk_end);
      wgmma_commit();
      ring.during(t, prep);
    } else {
      // k16 step by step: a group of 16 or 32 ends inside the tile. A group's
      // first products start its sums (scale_d 0): no other instruction
      // writes plo or phi, which would serialise the products.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < kk_end) {
          const int keep = (t * kBK + 16 * kk) % a.group != 0;
          wgmma_ss_n128<1>(plo, kmajor(sx, wg * 64, 16 * kk), mnmajor(w, 16 * kk), keep);
          wgmma_ss_n128<1>(phi, kmajor(sx + L::kXBox, wg * 64, 16 * kk),
                           mnmajor(w + L::kW, 16 * kk), keep);
          const int k_end = t * kBK + 16 * (kk + 1);
          if (kk + 1 < kk_end && k_end % a.group == 0) {
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(plo);
            fence_regs(phi);
            fence_regs(acc[0]);
            scale_group(k_end / a.group - 1);
            wgmma_fence();
          }
        }
      }
      wgmma_commit();
      ring.during(t, prep);
      const int k_end = t * kBK + 16 * kk_end;
      if (k_end % a.group == 0) {  // the group ends with the tile (always at q's last row)
        wgmma_wait<0>();
        fence_regs(plo);
        fence_regs(phi);
        fence_regs(acc[0]);
        scale_group(k_end / a.group - 1);
        drained = true;
      }
    }
    ring.after(t, drained, load);
  }
  ring.finish();
#pragma unroll
  for (int hf = 0; hf < NH; ++hf) fence_regs(acc[hf]);

  if constexpr (!kGroup) {  // per-channel scales on the fp32 sums
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + hf * 128 + acc_col(n, e);
          const float s = col < a.N ? a.scale[col] : 0.f;
          acc[hf][n][e] *= s;
          acc[hf][n][2 + e] *= s;
        }
  }
  store_tile<NH>(acc, reinterpret_cast<bf16*>(smem), a.out, m0, n0, a.M, a.N);
}

template <int BN, int KIND>
cudaError_t launch(const QmArgs& a, int tma, cudaStream_t stream) {
  using L = Smem<BN, KIND != kInt8>;
  QMaps maps{};
  cudaError_t err = cudaSuccess;
  if (tma) {
    const int Kq = KIND == kInt8 ? a.K : a.K / 2;  // columns of each x map, rows of q
    err = tma::map_2d(&maps.xlo, a.x, a.M, Kq, a.K, kBM);
    if (err == cudaSuccess && KIND != kInt8)
      err = tma::map_2d(&maps.xhi, a.x + a.K / 2, a.M, Kq, a.K, kBM);
    if (err == cudaSuccess) err = tma::map_2d_u8(&maps.q, a.q, Kq, a.N, a.N, BN, kBK);
    if (err != cudaSuccess) return err;
  }
  auto kernel = tma ? quant_matmul_kernel<BN, KIND, true> : quant_matmul_kernel<BN, KIND, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((a.M + kBM - 1) / kBM) * ((a.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, L::kBytes, stream>>>(a, maps);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16; q: [K, N] int8 (kind 0) or [K/2, N] packed int4 (kind 1);
// scale: fp32 [N], or [K/group, N] when group > 0 (kind 1 only, group a
// divisor of K/2 and a multiple of 16); out: [M, N] bf16. Pointers 16-byte
// aligned (the wrapper checks); any M, N, K (K even for int4). The TMA path
// where x's rows are a multiple of 8 elements (int4: 16, so that K/2 is one
// of 8) and q's rows a multiple of 16 bytes; cp.async otherwise.
extern "C" int mlio_quant_matmul(const void* x, const void* q, const void* scale, void* out,
                                 int M, int N, int K, int kind, int group, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  QmArgs a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
           static_cast<const float*>(scale), static_cast<bf16*>(out), M, N, K, group, 0,
           N % 16 == 0};
  if (kind == 0) {
    a.vec_x = K % 8 == 0;
    return launch<256, kInt8>(a, K % 8 == 0 && N % 16 == 0, s);
  }
  if (kind != 1 || K % 2) return static_cast<int>(cudaErrorInvalidValue);
  a.vec_x = K % 16 == 0;  // the high half starts at K/2: a multiple of 8 too
  const int tma = K % 16 == 0 && N % 16 == 0;
  if (group == 0) return launch<128, kInt4>(a, tma, s);
  if (group % 16 || (K / 2) % group) return static_cast<int>(cudaErrorInvalidValue);
  return launch<128, kInt4Group>(a, tma, s);
}
