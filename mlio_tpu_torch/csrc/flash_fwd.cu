// K1: flash attention forward (prefill) for Hopper, with dropout and with the
// log-sum-exp; and K9, the same function over an INT8 K/V cache.
//
// K1 replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel (:37, its
// pallas_call at :867): the path without a user mask, dropout (:140-150) and
// the lse output (return_stats, :531-535) included. q [B, Sq, Hq, D], k/v
// [B, Skv, Hkv, D] in the bshd layout, out [B, Sq, Hq, D]:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale) @ v[b, j, h/G]
// over keys j < kv_len[b] and, when causal, j <= i + q_offset. A row with no
// valid key gives 0.
//
// Bound, on the H100 SXM: at GPT-2 small's prefill (8 x 704 queries against
// a 1024-slot cache holding 704 tokens, 12 heads of 64, causal) 6.1 GFLOP
// (6.2 us at 989 TFLOP/s) against 35 MB of q, out and the valid K/V rows (11
// us at K14's ~3.1 TB/s): bytes, barely; at llama3-8b's training attention
// (B 1, S 2048, 32/8 heads of 128) 34.4 GFLOP, 35 us: operations. The kernel
// is flash_fwd.cuh's, which K13a (flash_bwd.cu) shares; its note gives the
// design: wgmma products with the scores, p and the output in registers, a
// three-stage cp.async K/V ring, interior tiles unmasked. The earlier kernel
// (WMMA through shared memory) ran 5.3x SDPA at GPT-2's prefill.
//
// K9 replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel_kvq (:199,
// pallas_call :837): k/v int8 [B, Skv, Hkv, D] with fp32 scales [B, Skv, Hkv]
// per (token, head). It is the kQuant instance of the same kernel
// (flash_fwd.cuh): int8 tiles through a ring of raw tiles, widened exactly
// to bf16 into the swizzled K and V slots under the products, the K scale
// on the fp32 score and the V scale on p before its bf16 rounding, as the
// TPU kernel fuses the dequant. Bound at GPT-2 small's prefill: 26.5 MB of
// q, out, K/V and scales (7.9 us at 3.35 TB/s) against 6.09 GFLOP (6.2 us):
// bytes, by a little.
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
  return flash::launch_fwd<false>(q, k, v, out, nullptr, kv_len, kv_len_scalar, B, Sq, Skv, Hq,
                                  Hkv, D, q_offset, scale, causal, drop,
                                  static_cast<cudaStream_t>(stream));
}

// K9: as mlio_flash_fwd with k, v int8 [B, Skv, Hkv, D] and their fp32
// scales k_scale, v_scale [B, Skv, Hkv], contiguous; no dropout.
extern "C" int mlio_flash_fwd_kvq(const void* q, const void* k, const void* v,
                                  const float* k_scale, const float* v_scale, void* out,
                                  const int* kv_len, int kv_len_scalar, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int D, int q_offset, float scale, int causal,
                                  void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  return flash::launch_fwd_kvq(q, k, v, k_scale, v_scale, out, kv_len, kv_len_scalar, B, Sq, Skv,
                               Hq, Hkv, D, q_offset, scale, causal,
                               static_cast<cudaStream_t>(stream));
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
  return flash::launch_fwd<true>(q, k, v, out, lse, kv_len, kv_len_scalar, B, Sq, Skv, Hq, Hkv,
                                 D, q_offset, scale, causal, flash::Dropout{0u, 0.f, 1.f},
                                 static_cast<cudaStream_t>(stream));
}
