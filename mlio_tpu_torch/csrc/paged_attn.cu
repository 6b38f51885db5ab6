// K7: single-token decode attention over the paged KV pools, for Hopper.
//
// Replaces mlio_tpu/ops/paged_attention.py::_paged_attn_kernel (entry
// paged_attention). For each sequence b and query head h (kv head h / G):
//   out[b, h] = softmax(q[b, h] . K[b, :ctx[b], h/G]^T * scale) @ V[b, :ctx[b], h/G]
// where slot s of sequence b is row s % bs of physical block
// block_tables[b, s / bs] of layer `layer` of the [L, NB, bs, Hkv, D] pools,
// and ctx[b] counts the current token. Slots at or past ctx[b] are never read,
// nor table entries past ceil(ctx[b] / bs). A sequence with ctx[b] == 0
// gives 0. Everything is fp32 between the bf16 loads and the output, as in
// the TPU kernel, grouped heads included.
//
// Bound: bytes, as K3: at GPT-2 small, B = 8 and a context of 896 one layer
// reads 8 * 896 * 768 * 2 * 2 B = 22 MB of K/V, 6.6 us at 3.35 TB/s. The
// kernel is K3's (decode_attn.cuh): one block per (sequence, kv head), D / 8
// lanes a token row, 16-byte loads, an online fp32 softmax. The pools only
// change where a slot's row is: each token's row offset reads its table
// entry (one 4-byte load, from L1 after the first lane of the block asks)
// and divides by bs. The TPU kernel streams one whole block per grid step;
// here the slots of a block are spread over the warps like K3's slots.
//
// INT8 pools (int8 rows, fp32 scale pools [L, NB, bs, Hkv]) take the int8
// instances: the K scale on the fp32 score, the V scale on the probability,
// everything fp32 as _paged_attn_kernel's kv_quant path (which dequantizes
// K and V in fp32 before both products: the same values, summed in another
// order).
#include "decode_attn.cuh"

namespace {

// Slot t of sequence b at layer `layer` of the [L, NB, bs, Hkv, D] pools.
struct PagedRows {
  const int* tables;  // [B, max_blocks]
  int max_blocks, bs, num_blocks, Hkv, D, layer;
  __device__ int count(int b, const int* ctx) const {
    return max(0, min(ctx[b], max_blocks * bs));
  }
  __device__ size_t offset(int b, int hk, int t) const {
    const int blk = __ldg(tables + static_cast<size_t>(b) * max_blocks + t / bs);
    return ((static_cast<size_t>(layer) * num_blocks + blk) * bs + t % bs) * Hkv * D
           + static_cast<size_t>(hk) * D;
  }
};

}  // namespace

// q, out: [B, Hkv * G, D] bf16; k_pool, v_pool: [L, NB, bs, Hkv, D] bf16, or
// int8 with fp32 k_scale, v_scale [L, NB, bs, Hkv] (null for bf16);
// tables: [B, max_blocks] int32 and ctx: [B] int32 on the device.
// G in {1, 2, 4, 8}, D in {64, 128}.
extern "C" int mlio_paged_attn(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale, const int* tables,
                               const int* ctx, void* out, int B, int max_blocks, int num_blocks,
                               int bs, int Hkv, int G, int D, int layer, float scale,
                               void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  const PagedRows rows{tables, max_blocks, bs, num_blocks, Hkv, D, layer};
  return decode_attn::launch<__nv_bfloat16, false>(q, k_pool, v_pool, k_scale, v_scale, ctx,
                                                   out, B, Hkv, G, D, rows, scale,
                                                   static_cast<cudaStream_t>(stream));
}
