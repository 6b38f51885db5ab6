// K1: flash attention forward (prefill) for Hopper, with a user mask, with
// dropout and with the log-sum-exp; and K9, the same function over an INT8
// K/V cache, with a key mask and the log-sum-exp.
//
// K1 replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel (:37, its
// pallas_call at :867): the key and full user masks (mask_kind, :124-130),
// dropout (:140-150) and the lse output (return_stats, :531-535), alone or
// together, and the q, kv and out layouts (:541-548, :881-887). q
// [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (bshd, or bhsd by strides), out
// [B, Sq, Hq, D]:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] * scale) @ v[b, j, h/G]
// over keys j < kv_len[b], when causal j <= i + q_offset, and where the mask
// is nonzero. A row with no valid key gives 0 (and lse -inf).
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
// At head dim 256 (Gemma) K1 is flash_fwd_d256.cu's kernel, on K10's
// warp-specialised body; D 64, 80 and 128 are flash_fwd.cuh's.
//
// K9 replaces mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel_kvq (:199,
// pallas_call :837; its key mask :271-273 and with_stats :297-301): k/v
// int8 [B, Skv, Hkv, D] with fp32 scales [B, Skv, Hkv] per (token, head),
// in either layout by strides. It is the kQuant instance of the same kernel
// (flash_fwd.cuh): int8 tiles through a ring of raw tiles, widened exactly
// to bf16 into the swizzled K and V slots under the products, the K scale
// on the fp32 score and the V scale on p before its bf16 rounding, as the
// TPU kernel fuses the dequant. Bound at GPT-2 small's prefill: 26.5 MB of
// q, out, K/V and scales (7.9 us at 3.35 TB/s) against 6.09 GFLOP (6.2 us):
// bytes, by a little.
#include "flash_fwd.cuh"

// K1 and K9, every instance. q [B, Sq, Hq, D] bf16; k, v [B, Skv, Hkv, D]
// bf16, or int8 with fp32 scales k_scale, v_scale [B, Skv, Hkv] (K9; else
// null); out [B, Sq, Hq, D] bf16; lse [B, Hq, Sq] fp32, or null for the
// instances without it; kv_len a [B] int32 device array, or null to use
// kv_len_scalar for every sequence; mask the user mask (nonzero = attend), or
// null: [B, Skv] or [B, Hm, Sq, Skv] bytes. Every tensor may lie in either
// layout: strides (a host array of 15) gives the batch, row and head strides
// in elements of q, of k and v (the same), of the scales, of out and of the
// mask (no row or head stride for a key mask, no head stride where Hm is 1).
// The head dim is contiguous; q, k and v start 16-byte aligned and their
// other strides are multiples of 16 bytes. D in {64, 128}, or 80 without
// k_scale, lse, dropout or mask (D 256: flash_fwd_d256.cu); Hq a multiple
// of Hkv. drop_rate > 0
// takes the dropout instance (not over an INT8 cache), with the seed
// drop_seed (an int32) and drop_inv_keep = 1 / (1 - drop_rate).
extern "C" int mlio_flash_fwd(const void* q, const void* k, const void* v, const float* k_scale,
                              const float* v_scale, const unsigned char* mask, void* out,
                              float* lse, const int* kv_len, const long long* strides,
                              int kv_len_scalar, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                              int q_offset, float scale, int causal, int drop_seed,
                              float drop_rate, float drop_inv_keep, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  using flash::Strides;
  const long long* t = strides;
  const flash::FwdArgs a{static_cast<const __nv_bfloat16*>(q), k, v,
                         static_cast<__nv_bfloat16*>(out), lse, k_scale, v_scale, kv_len, mask,
                         Strides{t[0], t[1], t[2]}, Strides{t[3], t[4], t[5]},
                         Strides{t[6], t[7], t[8]}, Strides{t[9], t[10], t[11]},
                         Strides{t[12], t[13], t[14]}, kv_len_scalar, B, Sq, Skv, Hq, Hkv,
                         q_offset, causal, 0, scale,
                         flash::Dropout{static_cast<uint32_t>(drop_seed), drop_rate,
                                        drop_inv_keep}};
  return flash::launch_fwd_args(a, D, static_cast<cudaStream_t>(stream));
}
