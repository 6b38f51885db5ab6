// K4: the decode megakernel for Hopper. Every layer of a decode step, the
// greedy epilogue and multi-step decoding in ONE launch.
//
// Replaces mlio_tpu/ops/decode_layer.py::_decode_stack_kernel and its body
// _decode_layer_body (entry decode_layer_stack). For each step s (position
// p = pos + s, shared by the batch) and layer l, with the residual x32 kept
// in fp32 across all layers:
//   h = norm1(x32) -> bf16; q, k, v = h @ W + b (fp32); RoPE on q, k with
//   bf16-rounded tables; slot p of layer l <- k, v (bf16); attention of
//   bf16(q * scale) over slots [0, p] with an online fp32 softmax (the
//   probabilities stay fp32 for the PV product);
//   x32 += bf16(attn) @ wo + bo; h2 = norm2(x32) -> bf16;
//   x32 += bf16(act(h2 @ w_up + b_up [, h2 @ w_gate + b_gate])) @ w_down + b_down.
// The epilogue takes bf16(final_norm(x32)), the fp32 logits against the tied
// [V, H] table (or an untied [H, V] head) plus the head bias, and the first
// index of each row's maximum. With steps > 1, step s+1 starts from the
// winning token's embedding row * embed_scale + pos_embed[p + 1], in fp32.
//
// Bound: bytes. At GPT-2 small, B = 8, context 896 a step reads 511.5 MB
// (170 MB of layer weights, 0.24 MB of biases and norms, the 77 MB tied
// lm_head, 264 MB of K and V) for 1.98 GFLOP: 0.1527 ms at the H100's
// 3.35 TB/s against 2 us of bf16 tensor-core time. Every phase is a GEMV at
// M = B or attention over the cache, about 1 flop per byte.
//
// Design. The TPU kernel walks a sequential grid (steps, layers + vocab
// chunks) and carries the residual in VMEM. Hopper runs blocks in parallel,
// so this is one persistent cooperative launch, one block an SM, whose
// phases are
//   1. norm1, QKV projections; 2. RoPE, cache write, attention;
//   3. out-projection + residual; 4. norm2, up/gate + activation;
//   5. down-projection + residual; then per step the logits with a
//   per-block (max, first index), and the token with the next step's input.
// The residual lives in a global fp32 [B, H] buffer; each block recomputes
// the norm statistics it needs from it. A producer warp streams every
// block's weight units by TMA into a shared-memory ring ahead of the
// consumers' waits, across phases, layers and steps; the GEMVs run on the
// tensor cores (mma.sync, the batch as n); each phase's K-split is summed
// in a fixed order by the last segment of a tile to arrive, so two runs give
// the same bits; and no grid barrier separates the phases: each consumer
// waits on readiness counters of the producers of what it reads
// (decode_stack.cuh has the details). Attention uses K3's split: one item
// per (sequence, KV head), D/8 lanes per token row, 16-byte loads of the
// valid slots only. Buffers written inside the launch are read with
// ld.global.cg (L2), never through a possibly stale L1. The vocabulary is
// spread over all warps, each keeping a running (max, first index);
// partials are merged in a fixed order by every block, so all blocks agree
// on the token.
//
// The phases live in decode_stack.cuh, shared with K8 (paged_stack.cu); this
// source gives the contiguous cache: slot pos + s of [layer, b] for every
// sequence, the RoPE row of step s.
//
// INT8 (the quantization slice, as the JAX kernel's int8 paths): int8
// weights stream at one byte an element, widened in registers, each column's
// fp32 scale applied to the finished sum before the bias; an INT8 cache
// (ContiguousCache<true>) is read as 8-byte rows with fp32 scales fused into
// the score and the probability, and the current token's K/V are quantized
// in the kernel exactly as quantize_kv does (decode_stack.cuh). Bound at the
// shapes above: int8 weights and INT8 KV 303 MB, 0.090 ms (85 MB of int8
// weights, the 77 MB bf16 lm_head, 132 MB of int8 K/V, 8 MB of scales); int8
// weights alone 0.127 ms; INT8 KV alone 0.116 ms.
//
// Limits: bf16 activations; B <= 8 (one mma n-tile); H <= 8192 (the
// epilogue keeps [8, H] bf16 in shared memory); head dim 64 or 128 and
// groups 1, 2, 4, 8 (template instances); every width a multiple of 8 (the
// int8 weights' widths of 16, the tensor maps' row stride); each projection
// weight bf16 or int8, a gated MLP's w_up and w_gate the same. The wrapper
// raises on anything else.
//
// Measured (chip_smoke.py, ab_k6.py; NVIDIA H100 80GB HBM3): PERF.md.
#include "decode_stack.cuh"

namespace {

// Slot pos + s of sequence b in the [L, B, Smax, Hkv, D] cache; RoPE row s.
// kQ: an INT8 cache with fp32 scales [L, B, Smax, Hkv].
template <bool kQ>
struct ContiguousCache {
  using Elem = std::conditional_t<kQ, int8_t, bf16>;
  static constexpr bool kQuant = kQ;
  static constexpr bool kPaged = false;
  static constexpr bool kLogits = false;
  __device__ static int slot(const StackParams& p, int, int s) { return p.pos + s; }
  __device__ static int capacity(const StackParams& p) { return p.Smax; }
  __device__ static size_t row(const StackParams& p, int layer, int b, int t) {
    return ((static_cast<size_t>(layer) * p.B + b) * p.Smax + t) * (p.Hkv * p.D);
  }
  __device__ static int rope_row(int, int s) { return s; }
};

}  // namespace

// The bf16 cache's instances (decode_layer_kv8.cu: the INT8 cache's, so the
// two build in parallel).
#ifndef MLIO_STACK_KV8
#define MLIO_STACK_KV8 false
#endif
using Cache = ContiguousCache<MLIO_STACK_KV8>;

extern "C" int mlio_decode_stack_plan(StackParams* p, long long* work_floats, int* sync_ints) {
  return (p->k_scale != nullptr) == MLIO_STACK_KV8 ? stack_plan<Cache>(p, work_floats, sync_ints)
                                                   : cudaErrorInvalidValue;
}

extern "C" int mlio_decode_stack_maps(const StackParams* p, void* out) {
  return stack_maps(p, out);
}

extern "C" int mlio_decode_stack_maps_bytes() { return static_cast<int>(sizeof(StackMaps)); }

extern "C" int mlio_decode_stack_items(const StackParams* p, int kind, int* out, int cap) {
  return stack_items(p, kind, out, cap);
}

extern "C" int mlio_decode_stack_cluster_probe(const StackParams* p, int cluster, int* out) {
  return stack_cluster_probe<Cache>(p, cluster, out);
}

extern "C" int mlio_decode_stack(const StackParams* p, const void* maps, void* stream) {
  return stack_launch<Cache>(p, maps, stream);
}
