// K1: flash attention forward (prefill) for Hopper.
//
// Replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel (the path
// without user mask or LSE output), dropout included. q [B, Sq, Hq, D], k/v
// [B, Skv, Hkv, D] in the bshd layout, out [B, Sq, Hq, D]:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale) @ v[b, j, h/G]
// over keys j < kv_len[b] and, when causal, j <= i + q_offset. A row with no
// valid key gives 0.
//
// Bound: at the prefill shapes of GPT-2 small (q 704 rows against a
// 1024-slot cache holding 704 tokens, D = 64) the causal work is ~6 GFLOP
// against ~35 MB of q, k, v and out that the function must move, so it sits
// near the H100's flops-per-byte balance point (~295, SXM data sheet); at
// longer prompts it is bound by operations. The design: one block per (q tile of 64 rows, head,
// batch), four warps of 16 rows each; Q, K and V tiles in shared memory;
// both products on the tensor cores through WMMA (bf16 inputs, fp32
// accumulate); online softmax in fp32. The kv loop stops at
// min(kv_len[b], q_start + q_offset + 64), the TPU kernel's causal early
// exit, and the ragged edges (q rows past Sq, keys past kv_len) are masked
// or zero-filled in the kernel, with no padded copies of the inputs. The
// heaviest q tiles (the last, under causality) are scheduled first.
//
// Rounding follows _flash_fwd_kernel: the scale is folded into q in fp32 and
// rounded back to the input dtype; p is rounded to V's dtype before the PV
// product while the row sum l adds the fp32 p; out = acc / l.
//
// A simple kernel that is right: wgmma, TMA and a pipelined K/V ring are
// later work. The kernel itself lives in flash_fwd.cuh, which K13a's
// forward with the log-sum-exp (flash_bwd.cu) shares. Dropout is a second
// instance (kDrop), so the prefill's instance keeps its code.
//
// K9, the same kernel over an INT8 cache (TK = int8_t), replaces
// mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel_kvq: k/v are int8
// [B, Skv, Hkv, D] with fp32 scales [B, Skv, Hkv] per (token, head). An int8
// value widens to bf16 exactly (|v| <= 127 fits bf16's 8-bit significand),
// so the K/V tiles widen on their way into shared memory and both products
// stay bf16 WMMA with fp32 accumulation; the tile's scales are staged beside
// them. As in the TPU kernel the dequant is fused: the K scale multiplies
// the fp32 score column after the QK product, the V scale multiplies p
// before p is rounded to bf16 for the PV product, and the row sum l adds the
// unscaled fp32 p. Nothing is padded or copied. Bound at GPT-2 small's
// prefill (8 x 704 queries, 704 valid int8 K/V rows of 12 heads): 26.5 MB of
// q, out, K/V and scales, 7.9 us at 3.35 TB/s, and 6.09 GFLOP, 6.2 us at 989
// TFLOP/s: bytes, by a little (K1's bf16 bound is 10.3 us).
#include "flash_fwd.cuh"

// q, out: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D], all contiguous bf16. kv_len
// is a [B] int32 device array, or null to use kv_len_scalar for every
// sequence. D in {64, 128}; Hq a multiple of Hkv. drop_rate > 0 takes the
// dropout instance, with the seed drop_seed (an int32) and drop_inv_keep =
// 1 / (1 - drop_rate).
extern "C" int mlio_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              const int* kv_len, int kv_len_scalar, int B, int Sq, int Skv,
                              int Hq, int Hkv, int D, int q_offset, float scale, int causal,
                              int drop_seed, float drop_rate, float drop_inv_keep,
                              void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  const flash::Dropout drop{static_cast<uint32_t>(drop_seed), drop_rate, drop_inv_keep};
  return flash::launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, v, nullptr, nullptr, out, nullptr, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv, D,
      q_offset, scale, causal, drop, static_cast<cudaStream_t>(stream));
}

// K9: as mlio_flash_fwd with k, v int8 [B, Skv, Hkv, D] and their fp32
// scales k_scale, v_scale [B, Skv, Hkv], contiguous; no dropout.
extern "C" int mlio_flash_fwd_kvq(const void* q, const void* k, const void* v,
                                  const float* k_scale, const float* v_scale, void* out,
                                  const int* kv_len, int kv_len_scalar, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int D, int q_offset, float scale, int causal,
                                  void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  return flash::launch<__nv_bfloat16, int8_t, false>(
      q, k, v, k_scale, v_scale, out, nullptr, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv, D,
      q_offset, scale, causal, flash::Dropout{0u, 0.f, 1.f}, static_cast<cudaStream_t>(stream));
}

// K1 with the log-sum-exp: as mlio_flash_fwd without dropout, and also
// lse[b, h, i] = m + log(l) fp32 [B, Hq, Sq] (-inf for a row with no valid
// key), the kLse instance K13a runs (flash_bwd.cu), here with kv_len and
// q_offset: flash_attention(..., return_stats=True) on K1's route.
extern "C" int mlio_flash_fwd_stats(const void* q, const void* k, const void* v, void* out,
                                    float* lse, const int* kv_len, int kv_len_scalar, int B,
                                    int Sq, int Skv, int Hq, int Hkv, int D, int q_offset,
                                    float scale, int causal, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  return flash::launch<__nv_bfloat16, __nv_bfloat16, true>(
      q, k, v, nullptr, nullptr, out, lse, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv, D,
      q_offset, scale, causal, flash::Dropout{0u, 0.f, 1.f}, static_cast<cudaStream_t>(stream));
}
