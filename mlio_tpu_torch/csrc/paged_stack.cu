// K8: the paged decode megakernel for Hopper. Every layer of one decode step
// of every sequence over the engine's block-table KV pools, and the greedy
// or logits epilogue, in ONE launch.
//
// Replaces mlio_tpu/ops/decode_paged_stack.py::_paged_stack_kernel (entry
// decode_paged_stack). It computes K4's function (decode_layer.cu) with
// three changes:
//   - the cache is the [L, NB, bs, Hkv, D] pool pair: slot t of sequence b is
//     row t % bs of physical block tables[b, t / bs];
//   - the context is per sequence: ctx[b] counts b's past tokens, so b
//     writes its current K/V into slot ctx[b] and attends over slots
//     [0, ctx[b]] (a slot at or past max_blocks * bs is neither written nor
//     read);
//   - RoPE is per sequence: row b of [B, rope_dim] cos/sin tables built from
//     each sequence's position, rounded to bf16 as K4's.
// The epilogue gives the first-index argmax token (greedy), or writes the
// fp32 [B, V] logits (emit logits), or both. One step a launch; the learned
// position is added to x by the caller, as the engine does.
//
// Bound: bytes, as K4's. At GPT-2 small, B = 8 and ragged past contexts
// [1, 15, 16, 127, 128, 500, 895, 1022] one step reads 247.3 MB of weights,
// biases, norms and the tied lm_head and 100.0 MB of K/V (2712 slots x 12
// layers x 768 x 2 x 2 B): 0.1037 ms at 3.35 TB/s.
//
// int8 weights: K4's int8 weight path (decode_stack.cuh), the bf16 pools
// unchanged (the JAX K8 has no INT8 KV path). Bound at the ragged contexts
// with int8 weights: 162 MB of weights, norms and the tied lm_head and the
// same K/V, 0.078 ms.
//
// Design: K4's phases (decode_stack.cuh: weights streamed by TMA ahead of
// every wait, tensor-core GEMVs, readiness counters in place of grid
// barriers), with the cache addressed through the policy below. The current token's K/V are written by the attention
// item of (sequence, kv head) and read back by that same item after a block
// barrier, as in K4; no other item reads that row. Inactive engine slots
// all point at scratch block 0 and write its row 0; the items of different
// sequences race there, and only those rows' results, which the engine
// drops, see it.
#include "decode_stack.cuh"

namespace {

// Slot ctx[b] of sequence b in the [L, NB, bs, Hkv, D] pools; RoPE row b.
struct PagedCache {
  using Elem = bf16;
  static constexpr bool kQuant = false;
  static constexpr bool kPaged = true;
  static constexpr bool kLogits = true;
  __device__ static int slot(const StackParams& p, int b, int) { return max(p.ctx[b], 0); }
  __device__ static int capacity(const StackParams& p) { return p.max_blocks * p.bs; }
  __device__ static size_t row(const StackParams& p, int layer, int b, int t) {
    const int blk = __ldg(p.tables + static_cast<size_t>(b) * p.max_blocks + t / p.bs);
    return ((static_cast<size_t>(layer) * p.num_blocks + blk) * p.bs + t % p.bs) *
           (p.Hkv * p.D);
  }
  __device__ static int rope_row(int b, int) { return b; }
};

}  // namespace

extern "C" int mlio_paged_stack_plan(StackParams* p, long long* work_floats, int* sync_ints) {
  return stack_plan<PagedCache>(p, work_floats, sync_ints);
}

extern "C" int mlio_paged_stack_maps(const StackParams* p, void* out) {
  return stack_maps(p, out);
}

extern "C" int mlio_paged_stack_maps_bytes() { return static_cast<int>(sizeof(StackMaps)); }

extern "C" int mlio_paged_stack_items(const StackParams* p, int kind, int* out, int cap) {
  return stack_items(p, kind, out, cap);
}

extern "C" int mlio_paged_stack_cluster_probe(const StackParams* p, int cluster, int* out) {
  return stack_cluster_probe<PagedCache>(p, cluster, out);
}

extern "C" int mlio_paged_stack(const StackParams* p, const void* maps, void* stream) {
  return stack_launch<PagedCache>(p, maps, stream);
}
