// The bf16 flash attention forward on Hopper's warpgroup products: K1
// (flash_fwd.cu: mlio_flash_fwd, with a user mask, dropout and the
// log-sum-exp, alone or together), K13a, its instance with the log-sum-exp
// (flash_bwd.cu: mlio_flash_fwd_lse), and K9, its instance over an INT8 K/V
// cache (mlio_flash_fwd with scales; a key mask, the lse). Also the tile
// helpers that K13b and K13c (flash_bwd.cu) share with it.
//
// Replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel (:37, its
// pallas_call at :867), mlio_tpu/ops/flash_attention_grad.py::
// _fwd_lse_kernel (:49, pallas_call :285) and mlio_tpu/ops/
// flash_attention.py::_flash_fwd_kernel_kvq (:199, pallas_call :837). q
// [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] bf16, out [B, Sq, Hq, D], each read
// or written by its (batch, row, head) strides (FwdArgs' Strides), so the
// bshd and bhsd layouts take the same code and no relayout:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale) @ v[b, j, h/G]
// over keys j < kv_len[b], when causal j <= i + q_offset, and where the user
// mask (if any) is nonzero. A row with no valid key gives 0 (and lse -inf):
// a negative q_offset or a kv_len of 0 leaves a block no tile at all. kLse
// also writes lse[b, h, i] = m + log(l) fp32. kDrop: post-softmax dropout
// (dropout.cuh): the kept p are scaled by 1 / (1 - rate) in the PV product
// only, and l keeps the true sum, so kLse's lse under dropout is the
// undropped one (_flash_fwd_kernel :140-150).
// kQuant (K9): k/v int8 with fp32 scales ks, vs [B, Skv, Hkv] per (token,
// head): s = (q * scale) . k_int8 in fp32, times ks[j]; the PV product takes
// p * vs[j] rounded to bf16 while l adds the unscaled p. The K scale goes on
// the fp32 score, never into a bf16 K.
//
// Rounding follows _flash_fwd_kernel: q * scale in fp32 rounded back to
// bf16; p rounded to bf16 for the PV product while l adds the fp32 p, p
// taken against the running max; out = acc / l, lse = m + log(l). exp is
// taken as exp2 of the score times log2(e), a few fp32 ulps from exp.
//
// Bound, on the H100 SXM (989 TFLOP/s bf16, K14's measured ~3.1 TB/s):
// at llama3-8b's training attention (B 1, S 2048, 32/8 heads of 128, causal)
// 4 x pairs = 34.4 GFLOP, 35 us, against 42 MB, 13 us: operations; at GPT-2
// small's prefill (8 x 704 queries, 704 valid keys, 12 heads of 64) 6.1
// GFLOP, 6.2 us, against 35 MB of q, out and the valid K/V rows, 11 us:
// bytes, barely. Either way the tensor cores must do the work with the
// softmax, the loads and the barriers out of their way. The earlier kernel
// (WMMA) ran 44 TFLOP/s at llama3-8b. What held it back, and what this
// design does about each:
// - Scores round-tripped through shared memory (WMMA hides its fragment
//   layout): S went out as fp32, came back half a row a lane, p went out as
//   bf16 and came back as a WMMA fragment, and O lived in shared memory as
//   fp32, rescaled, loaded and stored every tile (103 KB a block at D 128).
//   Here S = Q K^T lands in wgmma accumulators, whose (row, column) of each
//   element is public: the mask, the running max (a row spreads over a quad
//   of lanes: two __shfl_xor), exp, the dropout hash and l are computed on
//   them; p is rounded to bf16 and repacked in registers as the A operand of
//   O += P V, and O stays in registers, rescaled there by alpha. No score
//   and no output passes through shared memory.
// - Nothing was pipelined: K/V tiles were loaded through registers between
//   two block barriers. Here the 64-key K/V tiles come through a three-stage
//   cp.async ring (tile j + 2 copied while tile j computes), one barrier a
//   tile, and the tensor cores read Q, K and V from shared memory themselves
//   (wgmma.cuh's 128-byte swizzled layout: Q and K K-major, V MN-major),
//   so no operand passes through registers but p.
// - One block of four warps with 16 rows each: here a block is one
//   warpgroup owning 64 q rows, and two blocks (D 128) or three (D 64) share
//   an SM, so one block's softmax runs while another's products fill the
//   tensor cores.
// - Interior tiles take no mask (without a user mask): the mask applies on
//   the diagonal tile, at the kv_len tail, and nowhere else (K10's split). The kv loop stops at
//   min(kv_len, first row + q_offset + 64), the TPU kernel's causal early
//   exit; keys past kv_len are zero-filled by the copies, q
//   rows past Sq are zero and not stored, so nothing is padded.
// Head dim 80 (Phi-2) takes the causal/kv_len instance alone (no user
// mask, dropout, lse or INT8 cache), its tiles padded to 128 columns
// (kPadD). Head dim 256 (Gemma) has its own kernel, on K10's
// warp-specialised body (flash_fwd_d256.cu).
// The heaviest q tiles (the last, under causality) start first, the query
// heads of one KV head side by side so that their K/V meet in L2. Every
// output has one writer and every sum a fixed order: two runs give the same
// bits.
//
// The user mask (_flash_fwd_kernel's mask_kind, :124-130): a key mask
// [B, Skv] or a full one [B, Hm, Sq, Skv] of bytes, by strides (no row or
// head stride where it has none), ANDed into the causal and kv_len tests.
// Staging a tile of it in shared memory would cost K1 its second block an
// SM at D 128 (two blocks fill 224 of the 227 KB), so each thread turns the
// bytes of its own 32 elements into a 32-bit word (mask_bits' layout). Read
// there, byte by byte while S's product runs, the mask costs more than the
// masked softmax, so at D 128 the wide modes read a warp's bytes in full
// 16-bit or 16-byte words one tile ahead, under the PV product, and spread
// them by warp votes or quad shuffles (mask_word); at D 64 their registers
// would cost the fourth block an SM, so it reads bytes (mask_bits). No byte
// at or past Skv or past Sq is read. Under a mask every
// tile takes the masked path (no interior shortcut: the TPU kernel's
// full_limit = 0), whose -inf guards give a row that sees no key 0 and lse
// -inf; the tile loop is built twice, with and without a mask, so that the
// unmasked calls keep their registers. The mask is a runtime argument: one
// set of instances serves calls with and without it.
//
// K9 (kQuant) kept the WMMA body above until it moved here; at GPT-2's
// prefill it ran 5.3x K1. Its int8 tiles are half the bytes of K1's, but
// the tensor cores take bf16, so they are widened on the way: a three-stage
// cp.async ring of raw tiles (64 keys of int8 K and V, 4 KB each at D 64, 8
// KB at D 128, and their 64 + 64 fp32 scales), and one widened bf16 K slot
// and one V slot in the swizzled layout. A thread widens exactly the 16-byte
// chunks it copied (its own cp.async.wait_group makes them visible to it, no
// barrier), int8 to bf16 exactly (widen_i8x4), into the slot whose product
// has finished: V of tile j while S_j = Q K_j^T runs, K of tile j + 1 while
// O += P_j V_j runs, so each widening hides under a product. Two barriers a
// tile publish the widened slot to the tensor cores (after
// fence.proxy.async) and free the other. Keys past kv_len are zero-filled,
// values and scales alike, so a V row past the valid keys is 0 and a scale
// there is never read. 97.5 KB a block at D 128 (q 16, K and V slots 16
// each, the raw ring 3 x 16.5): two blocks an SM, as K1; 49.5 KB at D 64.
#pragma once

#include "cp_async.cuh"
#include "dropout.cuh"
#include "wgmma.cuh"

#include <math.h>

#include <type_traits>

namespace flash {

using bf16 = __nv_bfloat16;
using gemm::at_sw128;
using gemm::cp_async16;
using gemm::cp_async4;
using gemm::cp_commit;
using gemm::cp_wait;
using gemm::fence_proxy_async;
using gemm::fence_regs;
using gemm::kmajor;
using gemm::mnmajor;
using gemm::pack_bf16;
using gemm::repack;
using gemm::wgmma_commit;
using gemm::wgmma_fence;
using gemm::wgmma_rs;
using gemm::wgmma_ss_n64;
using gemm::wgmma_wait;
using gemm::zero;

constexpr int BT = 64;          // q rows of a warpgroup; keys of a K/V tile
constexpr int kWgThreads = 128;  // a warpgroup: four warps of 16 rows
constexpr int kStages = 3;       // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

// Blocks an SM, by head dim; a block is one warpgroup. Two warpgroups a
// block sharing one K/V ring (half the K/V traffic) measured no faster at
// llama3-8b's attention and slower at GPT-2's prefill and with dropout
// (PERF.md, Findings).
template <int D> constexpr int kMinBlocks = D == 64 ? 3 : 2;

// The width of a head's tiles in shared memory and of O in registers. Head
// dim 80 (Phi-2) is a 160-byte row, which the 128-byte swizzle's 64-column
// panels do not divide: its tiles are laid out 128 columns wide, and only
// the first 80 are copied. S = Q K^T takes the 5 k-steps of the real
// columns (no padded column is read); O += P V is one n128 product over V's
// whole tile, whose columns 80-127 are zeroed once at the kernel's start
// (the copies never write them), so O's padded columns stay 0 and are never
// stored. The PV product does 128 / 80 = 1.6x the work, S none extra: 1.3x
// the tensor-core work of an unpadded kernel. The 64-byte swizzle at a
// 96-column pad would cost 1.2x on PV, but needs another descriptor layout
// (PERF.md, Findings).
template <int D> constexpr int kPadD = D == 80 ? 128 : D;

// The element strides of a [B, S, H, D] tensor's batch, row (sequence
// position) and head, in whatever layout it lies (bshd, or bhsd: [B, H, S,
// D]); of a [B, S, H] scale array likewise. The head dim is contiguous.
struct Strides {
  long long b, s, h;
};

struct FwdArgs {
  const bf16* q;
  const void* k;  // bf16, or int8 for kQuant
  const void* v;
  bf16* out;
  float* lse;
  const float* ks;  // kQuant: the K and V scales [B, Skv, Hkv]; else null
  const float* vs;
  const int* kv_len_arr;  // [B], or null for kv_len_scalar
  // The user mask (nonzero = attend), or null: a key mask [B, Skv] (no row
  // or head stride) or a full mask [B, Hm, Sq, Skv] (no head stride where
  // Hm is 1); its keys contiguous.
  const unsigned char* mask;
  Strides qs, kvs, ss, os, ms;  // q, k and v, the scales, out, the mask
  int kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset, causal;
  int mask_mode;  // MaskMode: how the mask's bytes are read (launch_fwd_args sets it)
  float scale;
  Dropout drop;
};

// The q tile, then the K ring and the V ring; every tile 8 or 16 KB, so each
// starts 1 KB aligned. kQuant: one widened K slot and one V slot, then the
// raw ring: a raw tile is the int8 K rows, the int8 V rows (64 x D bytes
// each), then the 64 K scales and the 64 V scales.
template <int D, bool kQuant = false>
struct FwdSmem {
  static constexpr size_t kTile = size_t(BT) * kPadD<D> * 2;
  static constexpr int kSlots = kQuant ? 1 : kStages;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kTile;
  static constexpr size_t kV = kK + kSlots * kTile;
  static constexpr size_t kRaw = kV + kSlots * kTile;
  static constexpr size_t kRawScales = size_t(2) * BT * D;
  static constexpr size_t kRawTile = kRawScales + 2 * BT * sizeof(float);
  static constexpr size_t kBytes = kRaw + (kQuant ? kStages * kRawTile : 0);
};

// The scaled q tile of rows [q_start, q_start + 64) of head h: q * scale in
// fp32, rounded to bf16, into the swizzled tile; rows past Sq are 0.
template <int D>
__device__ __forceinline__ void load_q(const FwdArgs& a, bf16* sQ, int b, int h, int q_start) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  const bf16* head = a.q + b * a.qs.b + h * a.qs.h;
#pragma unroll
  for (int i = 0; i < BT * CPR / kWgThreads; ++i) {
    const int c = threadIdx.x + i * kWgThreads;
    const int r = c / CPR, cc = c % CPR;
    const int qr = q_start + r;
    float f[8];
    if (qr < a.Sq) {
      load_vec(head + qr * a.qs.s + cc * 8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    store_vec(at_sw128(sQ, r, cc * 8), f);
  }
}

// Start the copies of K/V tile j (keys 64j .. 64j + 63 of KV head hk) into
// ring slot j % kStages as one commit group; keys at or past kvl are
// zero-filled (a V row past the valid keys must not be NaN: p = 0 there, and
// 0 * NaN is NaN). Every thread commits, copies or not.
template <int D>
__device__ __forceinline__ void load_kv(const FwdArgs& a, bf16* sK, bf16* sV, int j, int n_tiles,
                                        int b, int hk, int kvl) {
  constexpr int CPR = D / 8;
  if (j < n_tiles) {
    const long long base = b * a.kvs.b + hk * a.kvs.h;
    bf16* k_t = sK + (j % kStages) * BT * kPadD<D>;
    bf16* v_t = sV + (j % kStages) * BT * kPadD<D>;
#pragma unroll
    for (int i = 0; i < BT * CPR / kWgThreads; ++i) {
      const int c = threadIdx.x + i * kWgThreads;
      const int r = c / CPR, cc = c % CPR;
      const int t = j * BT + r;
      const bool ok = t < kvl;
      const long long off = base + (ok ? t * a.kvs.s : 0) + cc * 8;
      cp_async16(at_sw128(k_t, r, cc * 8), static_cast<const bf16*>(a.k) + off, ok);
      cp_async16(at_sw128(v_t, r, cc * 8), static_cast<const bf16*>(a.v) + off, ok);
    }
  }
  cp_commit();
}

// kQuant: start the copies of raw tile j (the int8 K and V rows of keys 64j
// .. 64j + 63 of KV head hk, and their scales) into raw slot j % kStages as
// one commit group; keys at or past kvl are zero-filled, values and scales.
// Thread t copies the 16-byte chunks t + 128 i of the K and of the V rows
// (widen_raw widens the same ones) and the K scale (t < 64) or the V scale
// of key t % 64. Every thread commits, copies or not.
template <int D>
__device__ __forceinline__ void load_raw(const FwdArgs& a, unsigned char* raw, int j, int n_tiles,
                                         int b, int hk, int kvl) {
  using S = FwdSmem<D, true>;
  constexpr int CPR = D / 16;  // 16-byte chunks of an int8 row
  if (j < n_tiles) {
    unsigned char* t_ = raw + (j % kStages) * S::kRawTile;
    const long long base = b * a.kvs.b + hk * a.kvs.h;
#pragma unroll
    for (int i = 0; i < BT * CPR / kWgThreads; ++i) {
      const int c = threadIdx.x + i * kWgThreads;
      const int r = c / CPR, cc = c % CPR;
      const int t = j * BT + r;
      const bool ok = t < kvl;
      const long long off = base + (ok ? t * a.kvs.s : 0) + cc * 16;
      cp_async16(t_ + c * 16, static_cast<const int8_t*>(a.k) + off, ok);
      cp_async16(t_ + BT * D + c * 16, static_cast<const int8_t*>(a.v) + off, ok);
    }
    const int t = j * BT + threadIdx.x % BT;
    const bool ok = t < kvl;
    const long long si = ok ? b * a.ss.b + t * a.ss.s + hk * a.ss.h : 0;
    cp_async4(t_ + S::kRawScales + threadIdx.x * 4, (threadIdx.x < BT ? a.ks : a.vs) + si, ok);
  }
  cp_commit();
}

// Four int8 values (one 32-bit word, element e in byte e) widened exactly to
// four bf16 (two words, element 0 in the low half): each byte, offset to
// unsigned, becomes the low mantissa of 2^23 and the fp32 subtraction
// removes the offset; an integer of 8 bits is its own bf16, the float's top
// half.
__device__ __forceinline__ uint2 widen_i8x4(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + e)) -
                           8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// kQuant: widen this thread's chunks of the int8 rows at `rows` (64 x D
// bytes of a raw tile) into the swizzled bf16 tile `dst`: chunk c of row r
// (columns 16c .. 16c + 15) becomes the 8-column chunks 2c and 2c + 1. At
// D 128 the threads of a row's second half store their chunks in the other
// order, so the eight stores of a quarter warp fall on eight bank groups.
template <int D>
__device__ __forceinline__ void widen_raw(const unsigned char* rows, bf16* dst) {
  constexpr int CPR = D / 16;
#pragma unroll
  for (int i = 0; i < BT * CPR / kWgThreads; ++i) {
    const int c = threadIdx.x + i * kWgThreads;
    const int r = c / CPR, cc = c % CPR;
    const uint4 raw = *reinterpret_cast<const uint4*>(rows + c * 16);
    const uint2 w0 = widen_i8x4(raw.x), w1 = widen_i8x4(raw.y);
    const uint2 w2 = widen_i8x4(raw.z), w3 = widen_i8x4(raw.w);
    const uint4 lo = make_uint4(w0.x, w0.y, w1.x, w1.y), hi = make_uint4(w2.x, w2.y, w3.x, w3.y);
    const bool swap = (cc & 4) != 0;
    *reinterpret_cast<uint4*>(at_sw128(dst, r, 16 * cc + (swap ? 8 : 0))) = swap ? hi : lo;
    *reinterpret_cast<uint4*>(at_sw128(dst, r, 16 * cc + (swap ? 0 : 8))) = swap ? lo : hi;
  }
}

// kQuant's view of tile j in fwd_tile: its raw slot (the V rows to widen
// while S runs, the scales), the raw slot of tile j + 1 (its K rows to widen
// while O += P V runs; null past the last tile) and the widened slots.
struct QuantTile {
  const unsigned char* raw;
  const unsigned char* next;
  bf16* k;
  bf16* v;
};

// A warpgroup's state of 64 q rows: this thread holds rows g and g + 8 of
// its warp's 16 (g = lane / 4), and in each 8-column n-tile the columns
// 2 * (lane % 4) and + 1 (wgmma.cuh's layout).
template <int D>
struct FwdRows {
  float o[kPadD<D> / 8][4];  // output accumulator: [n-tile of 8 dims][row g: 0, 1; row g+8: 2, 3]
  float m[2], l[2];   // running max, and this thread's part of the row sum
};

// How a tile's mask bytes are read. kMaskKey: the mask has no row stride (a
// key mask), and its address, batch and head strides and Skv are even: lane
// l of a warp reads the 16-bit word of columns 2l and 2l + 1, and two warp
// votes spread the tile's 64 columns to every thread. kMaskFull: the
// address, the strides and Skv are multiples of 16: thread t4 of a quad
// reads 16 bytes of each of its two rows (columns 16 t4 .. 16 t4 + 15), and
// four shuffles within the quad spread them. Both read a tile ahead
// (kMaskAhead). Otherwise, and at D 64, each thread reads the bytes of its
// own columns while S runs (mask_bits).
enum MaskMode : int { kMaskBytes = 0, kMaskKey = 1, kMaskFull = 2 };

// Whether the wide modes read a tile ahead. At D 64 their code took K1 from
// 128 registers a thread (four blocks an SM) to over 150 (three), and its
// unmasked calls with it: there every mask takes mask_bits.
template <int D> constexpr bool kMaskAhead = D == 128;

// The user mask as this thread reads it: its rows g and g + 8 of its warp's
// 16 (null where a row lies past Sq, so that no byte past the mask is read;
// one pointer for both rows under a key mask), and the row-independent base
// of a key mask.
struct MaskRows {
  const unsigned char* key;
  const unsigned char* r0;
  const unsigned char* r1;
};

// The user mask's bits of this thread's elements of a tile, as keep_bits
// lays them out: bit 4n + 2i + e for row g + 8i and column c0 + 8n + e (c0 =
// the tile's first key + 2 (lane % 4)). A column at or past kvl gets 0 and
// its byte is not read (kvl <= Skv).
template <int NT>
__device__ __forceinline__ uint32_t mask_bits(const MaskRows& mr, int c0, int kvl) {
  static_assert(NT <= 8, "32 bits");
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const unsigned char* r = i ? mr.r1 : mr.r0;
    if (i == 1 && r == mr.r0) {  // a key mask: row g + 8 sees row g's keys
      bits |= (bits & 0x33333333u) << 2;
      break;
    }
    if (r == nullptr) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c0 + 8 * n;
      if (col >= kvl) continue;
      const uint32_t two =
          (__ldg(r + col) != 0) | ((col + 1 < kvl && __ldg(r + col + 1) != 0) << 1);
      bits |= two << (4 * n + 2 * i);
    }
  }
  return bits;
}

// A tile's mask bytes in flight (the wide modes): kMaskKey the 16-bit word
// in raw0.x, kMaskFull the 16 bytes of each row.
struct MaskRaw {
  uint4 raw0, raw1;
};

// Start reading the mask bytes of the tile at column c0 (kMaskKey,
// kMaskFull). No byte at or past Skv is read: Skv is even (kMaskKey) or a
// multiple of 16 (kMaskFull), so a word that starts below it ends below it.
__device__ __forceinline__ MaskRaw mask_load(const FwdArgs& a, const MaskRows& mr, int c0) {
  const int lane = threadIdx.x % 32;
  MaskRaw m{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (a.mask_mode == kMaskKey) {
    const int col = c0 + 2 * lane;
    if (col < a.Skv) m.raw0.x = __ldg(reinterpret_cast<const unsigned short*>(mr.key + col));
  } else {
    const int col = c0 + 16 * (lane % 4);
    if (col < a.Skv) {
      if (mr.r0 != nullptr) m.raw0 = __ldg(reinterpret_cast<const uint4*>(mr.r0 + col));
      if (mr.r1 != nullptr) m.raw1 = __ldg(reinterpret_cast<const uint4*>(mr.r1 + col));
    }
  }
  return m;
}

// Bit b of the result: byte b of the 16 is nonzero. Each byte's 0 or 1
// multiplied into bits 24-27 of its word (no two partial products meet
// there, and none carries into them).
__device__ __forceinline__ uint32_t kept16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    bits |= (((__vcmpne4(w[k], 0u) & 0x01010101u) * 0x01020408u) >> 24) << (4 * k);
  return bits;
}

// mask_bits' word from the bytes m of a wide mode (every lane of the warp
// takes part). Columns at or past kvl may hold anything: the kv_len test
// masks them.
__device__ __forceinline__ uint32_t mask_word(const FwdArgs& a, const MaskRaw& m) {
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  if (a.mask_mode == kMaskKey) {
    // lane t4 + 4n holds columns 2 t4 + 8n + {0, 1}: bit t4 + 4n of each vote
    const uint32_t v0 = __ballot_sync(0xffffffffu, (m.raw0.x & 0xffu) != 0);
    const uint32_t v1 = __ballot_sync(0xffffffffu, (m.raw0.x & 0xff00u) != 0);
    const uint32_t x = ((v0 >> t4) & 0x11111111u) | (((v1 >> t4) & 0x11111111u) << 1);
    return x | (x << 2);  // row g + 8 sees row g's keys
  }
  // column 16 o + b of the quad's rows lies with thread o, as bit b (row g)
  // and 16 + b (row g + 8) of its word
  const uint32_t own = kept16(m.raw0) | (kept16(m.raw1) << 16);
  uint32_t w[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) w[o] = __shfl_sync(0xffffffffu, own, (lane & ~3) | o);
  uint32_t bits = 0;
#pragma unroll
  for (int n = 0; n < BT / 8; ++n) {
    const uint32_t x = w[n >> 1] >> (8 * (n & 1) + 2 * t4);
    bits |= ((x & 3u) << (4 * n)) | (((x >> 16) & 3u) << (4 * n + 2));
  }
  return bits;
}

// O += P V for the 16 keys kk of a tile: one product over V's whole padded
// width.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[kPadD<D> / 8][4], const uint32_t (&pa)[4],
                                           const bf16* v_t, int kk) {
  wgmma_rs<kPadD<D>, 1>(o, pa, mnmajor(v_t, 16 * kk), 1);
}

// One K/V tile for the warpgroup's 64 rows: S = (q * scale) K^T (64 x 64, q
// and K from shared memory), the online softmax on the accumulators, O += P V
// with p repacked in registers and V MN-major from shared memory. kQuant
// (qt): V of this tile is widened while S runs and K of the next while
// O += P V runs; S takes the K scales, the PV operand p the V scales.
// kMasked: the causal and kv_len tests. kUser (a user mask, every tile
// kMasked): the mask's bits of this tile, while S runs. In a wide mode at D
// 128 its bytes were read a tile earlier (m): those of the tile at column
// next_c0 (none if negative) are started while O += P V runs, so that m
// lives outside the softmax, where the registers are fullest.
template <int D, bool kDrop, bool kQuant, bool kMasked, bool kUser>
__device__ __forceinline__ void fwd_tile(const FwdArgs& a, FwdRows<D>& st, const bf16* q_t,
                                         const bf16* k_t, const bf16* v_t, int kv0, int row_abs0,
                                         int kvl, uint32_t seed, const QuantTile& qt,
                                         const MaskRows& mr, MaskRaw& m, int next_c0) {
  using Sm = FwdSmem<D, kQuant>;
  const int t4 = threadIdx.x % 4;
  float s[BT / 8][4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kmajor(q_t, 0, 16 * kk), kmajor(k_t, 0, 16 * kk), kk > 0);
  wgmma_commit();
  // the dropout keep bits, the user mask's bits, or V's widening, while the
  // product runs
  const uint32_t keep =
      kDrop ? keep_bits<BT / 8, true>(kv0 + 2 * t4, row_abs0, seed, a.drop.rate) : 0u;
  uint32_t user = ~0u;
  if constexpr (kUser) {
    if (kMaskAhead<D> && a.mask_mode >= kMaskKey)
      user = mask_word(a, m);
    else
      user = mask_bits<BT / 8>(mr, kv0 + 2 * t4, kvl);
  }
  if constexpr (kQuant) widen_raw<D>(qt.raw + BT * D, qt.v);
  wgmma_wait<0>();
  fence_regs(s);
  // the K scales of this thread's columns 8n + 2 t4 + {0, 1}, on the fp32 score
  const float* scales = nullptr;  // kQuant: the tile's K scales, then its V scales
  if constexpr (kQuant) {
    scales = reinterpret_cast<const float*>(qt.raw + Sm::kRawScales);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const float2 k2 = *reinterpret_cast<const float2*>(scales + n * 8 + 2 * t4);
      s[n][0] *= k2.x;
      s[n][1] *= k2.y;
      s[n][2] *= k2.x;
      s[n][3] *= k2.y;
    }
  }

  // Online softmax, rows g (i = 0) and g + 8 (i = 1).
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (kMasked) {
      const int row_abs = row_abs0 + 8 * i;
#pragma unroll
      for (int n = 0; n < BT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kv0 + n * 8 + 2 * t4 + e;
          if (!(col < kvl && (!a.causal || row_abs >= col) &&
                ((user >> (4 * n + 2 * i + e)) & 1u)))
            s[n][2 * i + e] = -INFINITY;
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[i], mx);
    float m_safe = m_new;
    if constexpr (kMasked) {
      m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = (st.m[i] == -INFINITY) ? 0.f : exp2f((st.m[i] - m_safe) * kLog2e);
    } else {
      alpha[i] = exp2f((st.m[i] - m_safe) * kLog2e);  // exp(-inf) = 0 on the first tile
    }
    const float mb = m_safe * kLog2e;
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      float2 v2 = make_float2(1.f, 1.f);  // kQuant: the V scales of the pair's columns
      if constexpr (kQuant)
        v2 = *reinterpret_cast<const float2*>(scales + BT + n * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(fmaf(s[n][2 * i + e], kLog2e, -mb));  // exp(-inf) = 0
        psum += p;
        if constexpr (kDrop)
          s[n][2 * i + e] = (keep >> (4 * n + 2 * i + e)) & 1u ? p * a.drop.inv_keep : 0.f;
        else if constexpr (kQuant)
          s[n][2 * i + e] = p * (e ? v2.y : v2.x);
        else
          s[n][2 * i + e] = p;
      }
    }
    st.l[i] = st.l[i] * alpha[i] + psum;
    st.m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < kPadD<D> / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // O += P V: p rounded to bf16 and repacked as A fragments, one per 16 keys;
  // V as B, MN-major (the keys are K).
  uint32_t pa[BT / 16][4];
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) repack(pa[kk], s, kk);
  if constexpr (kQuant) {
    // V's widened slot visible to the tensor cores; every warp past S, so
    // the K slot is free
    fence_proxy_async();
    __syncthreads();
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) pv_product<D>(st.o, pa[kk], v_t, kk);
  wgmma_commit();
  if constexpr (kUser && kMaskAhead<D>) {
    if (a.mask_mode >= kMaskKey && next_c0 >= 0) m = mask_load(a, mr, next_c0);
  }
  if constexpr (kQuant) {
    if (qt.next != nullptr) {
      cp_wait<kStages - 2>();  // this thread's copies of the next raw tile landed
      widen_raw<D>(qt.next, qt.k);
    }
  }
  wgmma_wait<0>();  // the slot is refilled after the next tile's barrier
  fence_regs(st.o);
  if constexpr (kQuant) {
    // the next K visible to the tensor cores; the V slot and this raw slot free
    fence_proxy_async();
    __syncthreads();
  }
}

template <int D, bool kDrop, bool kLse, bool kQuant>
__global__ void __launch_bounds__(kWgThreads, kMinBlocks<D>)
flash_fwd_kernel(const FwdArgs a) {
  using S = FwdSmem<D, kQuant>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + S::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::kV);
  unsigned char* raw = smem + S::kRaw;

  // Block -> (q tile, batch, head): heads fastest, the heaviest q tiles first.
  const int n_qt = (a.Sq + BT - 1) / BT;
  const int h = blockIdx.x % a.Hq;
  const int rest = blockIdx.x / a.Hq;
  const int b = rest % a.B;
  const int qt = n_qt - 1 - rest / a.B;
  const int hk = h / (a.Hq / a.Hkv);
  const int q_start = qt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t seed = kDrop ? fold_seed(a.drop.seed, b, h) : 0u;

  const int kvl = min(a.kv_len_arr != nullptr ? a.kv_len_arr[b] : a.kv_len_scalar, a.Skv);
  // The block's tiles (up to its last row's causal limit), and its interior
  // ones (every key at or below its first row and inside kvl).
  const int first_row = q_start + a.q_offset;
  int tokens = kvl;
  if (a.causal) tokens = min(tokens, first_row + BT);
  const int n_tiles = tokens > 0 ? (tokens + BT - 1) / BT : 0;
  int n_full = a.causal ? (first_row > 0 ? first_row / BT : 0) : n_tiles;
  n_full = min(min(n_full, kvl / BT), n_tiles);

  load_q<D>(a, sQ, b, h, q_start);
  if constexpr (kPadD<D> != D) {
    // V's padded columns [D, kPadD), zero once: the copies never write them,
    // and the PV product reads them (fenced with the first tile's copies)
    constexpr int PC = (kPadD<D> - D) / 8;
    for (int c = threadIdx.x; c < kStages * BT * PC; c += kWgThreads) {
      const int slot = c / (BT * PC), r = c / PC % BT, cc = D / 8 + c % PC;
      *reinterpret_cast<uint4*>(at_sw128(sV + slot * BT * kPadD<D>, r, cc * 8)) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if constexpr (kQuant) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) load_raw<D>(a, raw, j, n_tiles, b, hk, kvl);
    cp_wait<kStages - 1>();
    if (n_tiles > 0) widen_raw<D>(raw, sK);  // K of tile 0; V is widened under S_0
    fence_proxy_async();
    __syncthreads();  // q, K_0 and tile 0's scales visible to all
  } else {
    load_kv<D>(a, sK, sV, 0, n_tiles, b, hk, kvl);
    load_kv<D>(a, sK, sV, 1, n_tiles, b, hk, kvl);
  }

  FwdRows<D> st;
  zero(st.o);
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
  const int row_abs0 = first_row + warp * 16 + g;
  // Groups in flight at the top of tile j: tile j and tile j + 1 (and older,
  // complete ones). wait_group 1 leaves tile j + 1 pending.
  // kQuant: the raw groups in flight at the top of tile j are tiles j + 1
  // and j + 2; fwd_tile widens K_{j + 1} after wait_group 1, and raw tile
  // j + 3 goes into tile j's slot once fwd_tile's last barrier has passed.
  // The loop is built twice: with a user mask (every tile masked: no
  // interior shortcut, the TPU kernel's full_limit = 0; its bytes read a
  // tile ahead) and without, whose registers the mask's do not touch.
  MaskRows mr{nullptr, nullptr, nullptr};
  MaskRaw mraw{};
  auto tiles = [&](auto user_tag) {
    constexpr bool kUser = decltype(user_tag)::value;
    for (int j = 0; j < n_tiles; ++j) {
      const bf16* k_t = sK;
      const bf16* v_t = sV;
      QuantTile qt{};
      if constexpr (kQuant) {
        qt = QuantTile{raw + (j % kStages) * S::kRawTile,
                       j + 1 < n_tiles ? raw + ((j + 1) % kStages) * S::kRawTile : nullptr, sK,
                       sV};
      } else {
        cp_wait<1>();
        fence_proxy_async();
        // tile j (and the q tile) visible to all; every warp is done with slot (j + 2) % 3
        __syncthreads();
        load_kv<D>(a, sK, sV, j + 2, n_tiles, b, hk, kvl);
        k_t = sK + (j % kStages) * BT * kPadD<D>;
        v_t = sV + (j % kStages) * BT * kPadD<D>;
      }
      const int next_c0 = j + 1 < n_tiles ? (j + 1) * BT : -1;
      if (!kUser && j < n_full)
        fwd_tile<D, kDrop, kQuant, false, false>(a, st, sQ, k_t, v_t, j * BT, row_abs0, kvl, seed,
                                                 qt, mr, mraw, next_c0);
      else
        fwd_tile<D, kDrop, kQuant, true, kUser>(a, st, sQ, k_t, v_t, j * BT, row_abs0, kvl, seed,
                                                qt, mr, mraw, next_c0);
      if constexpr (kQuant) load_raw<D>(a, raw, j + kStages, n_tiles, b, hk, kvl);
    }
  };
  // The user mask's loop is built at D 64 and 128 only: D 80 takes no mask
  // (launch_fwd_args).
  if constexpr (D == 64 || D == 128) {
    if (a.mask != nullptr) {
      const int qr0 = q_start + warp * 16 + g;
      mr.key = a.mask + b * a.ms.b + h * a.ms.h;
      mr.r0 = qr0 < a.Sq ? mr.key + qr0 * a.ms.s : nullptr;
      mr.r1 = qr0 + 8 < a.Sq ? mr.key + (qr0 + 8) * a.ms.s : nullptr;
      if (kMaskAhead<D> && a.mask_mode >= kMaskKey && n_tiles > 0) mraw = mask_load(a, mr, 0);
      tiles(std::true_type{});
    } else {
      tiles(std::false_type{});
    }
  } else {
    tiles(std::false_type{});
  }
  cp_wait<0>();

  // out = O / l, rounded to bf16, and lse = m + log(l); rows past Sq are not
  // stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = st.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qr = q_start + warp * 16 + g + 8 * i;
    if (qr < a.Sq) {
      const float l_safe = (l == 0.f) ? 1.f : l;
      bf16* orow = a.out + b * a.os.b + qr * a.os.s + h * a.os.h;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
            pack_bf16(st.o[n][2 * i] / l_safe, st.o[n][2 * i + 1] / l_safe);
      if (kLse && t4 == 0)
        a.lse[(static_cast<size_t>(b) * a.Hq + h) * a.Sq + qr] =
            (st.m[i] == -INFINITY) ? -INFINITY : st.m[i] + logf(l_safe);
    }
  }
}

template <int D, bool kDrop, bool kLse, bool kQuant = false>
cudaError_t launch_fwd_d(const FwdArgs& a, cudaStream_t s) {
  constexpr size_t smem = FwdSmem<D, kQuant>::kBytes;
  auto kernel = flash_fwd_kernel<D, kDrop, kLse, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((a.Sq + BT - 1) / BT) * a.Hq * a.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The instance for head dim D of the call a: kQuant where a.ks is set, kLse
// where a.lse is, kDrop where a.drop.rate > 0 (not with kQuant).
template <int D>
cudaError_t launch_fwd_instance(const FwdArgs& a, cudaStream_t s) {
  const bool lse = a.lse != nullptr, dropping = a.drop.rate > 0.f;
  if (a.ks != nullptr) {
    if (dropping) return cudaErrorInvalidValue;
    return lse ? launch_fwd_d<D, false, true, true>(a, s)
               : launch_fwd_d<D, false, false, true>(a, s);
  }
  if (dropping) return lse ? launch_fwd_d<D, true, true>(a, s) : launch_fwd_d<D, true, false>(a, s);
  return lse ? launch_fwd_d<D, false, true>(a, s) : launch_fwd_d<D, false, false>(a, s);
}

// Any call of K1 or K9 (a's tensors by their strides): D 64 or 128, or K1's
// instance without a user mask, dropout, lse or INT8 cache at D 80
// (Phi-2), the only one built there. D 256 is flash_fwd_d256.cu's.
inline cudaError_t launch_fwd_args(FwdArgs a, int D, cudaStream_t s) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv || a.Skv < 0) return cudaErrorInvalidValue;
  const long long at = reinterpret_cast<uintptr_t>(a.mask) | a.ms.b | a.ms.h | a.ms.s | a.Skv;
  a.mask_mode = (at & 1) != 0    ? kMaskBytes
                : a.ms.s == 0    ? kMaskKey
                : (at & 15) == 0 ? kMaskFull
                                 : kMaskBytes;
  if (D == 64) return launch_fwd_instance<64>(a, s);
  if (D == 128) return launch_fwd_instance<128>(a, s);
  if (D != 80 || a.ks != nullptr || a.lse != nullptr || a.drop.rate > 0.f || a.mask != nullptr)
    return cudaErrorInvalidValue;
  return launch_fwd_d<80, false, false>(a, s);
}

// K13a's call (flash_bwd.cu): q, out [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D],
// contiguous bf16; kv_len a [B] int32 device array, or null to use
// kv_len_scalar for every sequence; lse [B, Hq, Sq] fp32; no user mask. Only
// the bf16 instances with the lse are built where it is called.
template <bool kLse>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                       const int* kv_len, int kv_len_scalar, int B, int Sq, int Skv, int Hq,
                       int Hkv, int D, int q_offset, float scale, int causal, Dropout drop,
                       cudaStream_t s) {
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  const Strides qs{static_cast<long long>(Sq) * Hq * D, static_cast<long long>(Hq) * D, D};
  const Strides kvs{static_cast<long long>(Skv) * Hkv * D, static_cast<long long>(Hkv) * D, D};
  const FwdArgs a{static_cast<const bf16*>(q), k, v, static_cast<bf16*>(out), lse, nullptr,
                  nullptr, kv_len, nullptr, qs, kvs, Strides{0, 0, 0}, qs, Strides{0, 0, 0},
                  kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset, causal, 0, scale, drop};
  const bool dropping = drop.rate > 0.f;
  if (D == 64) {
    if (dropping) return launch_fwd_d<64, true, kLse>(a, s);
    return launch_fwd_d<64, false, kLse>(a, s);
  }
  if (D == 128) {
    if (dropping) return launch_fwd_d<128, true, kLse>(a, s);
    return launch_fwd_d<128, false, kLse>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace flash
