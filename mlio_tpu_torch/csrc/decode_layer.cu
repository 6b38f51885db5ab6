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
// so this is one persistent cooperative launch (as many 256-thread blocks as
// can be resident, every SM busy) whose phases are separated by grid-wide
// barriers on a counter with a generation word:
//   1. norm1, QKV projections; 2. RoPE, cache write, attention;
//   3. out-projection + residual; 4. norm2, up/gate + activation;
//   5. down-projection + residual; then per step the logits with a
//   per-block (max, first index), and the token with the next step's input.
// The residual lives in a global fp32 [B, H] buffer; each block recomputes
// the norm statistics it needs from it instead of paying another barrier.
// A projection phase splits its weight [K, N] into 64-column tiles and
// K-chunks so that every SM streams weights: 8 threads read a 128-byte row
// segment (16 bytes each, rows of the [in, out] layout), 32 rows at once and
// four rows in flight a thread, each thread keeping B x 8 fp32 sums in
// registers. Each item writes its
// partial sums to a global buffer; the last item of a tile to arrive (an
// atomic counter per tile) sums the partials in a fixed order and applies
// the bias, activation or residual, so two runs give the same bits and no
// float atomics are used. Attention uses K3's split: one item per
// (sequence, KV head), D/8 lanes per token row, 16-byte loads of the valid
// slots only. Buffers written inside the launch are read with ld.global.cg
// (L2), never through a possibly stale L1. The vocabulary is spread over all
// warps, each keeping a running (max, first index); partials are merged in
// a fixed order by every block, so all blocks agree on the token.
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
// Limits: bf16 activations; B <= 8 (the register accumulators); H <= 8192 (the
// epilogue keeps [8, H] bf16 in shared memory); head dim 64 or 128 and
// groups 1, 2, 4, 8 (template instances); every width a multiple of 8. The
// wrapper raises on anything else. GEMVs use CUDA-core FMAs.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 0.945 ms a step at
// the shapes above, 6.2x the bound. Each phase is a chain of dependent L2
// round trips (norm statistics, staging, weight rows, partial sums, the
// tile counter, the barrier) of 10-18 us, against 4.2 us for a layer's
// weight bytes; fewer phases and deeper load pipelines are later work.
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

// A bf16 cache, or an INT8 one where p->k_scale is set.
extern "C" int mlio_decode_stack_plan(StackParams* p, long long* work_floats, int* sync_ints) {
  return p->k_scale != nullptr ? stack_plan<ContiguousCache<true>>(p, work_floats, sync_ints)
                               : stack_plan<ContiguousCache<false>>(p, work_floats, sync_ints);
}

extern "C" int mlio_decode_stack(const StackParams* p, void* stream) {
  return p->k_scale != nullptr ? stack_launch<ContiguousCache<true>>(p, stream)
                               : stack_launch<ContiguousCache<false>>(p, stream);
}
