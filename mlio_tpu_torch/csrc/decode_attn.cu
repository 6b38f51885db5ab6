// K3: single-token decode attention over the contiguous KV cache, for Hopper.
//
// Replaces mlio_tpu/ops/decode_attention.py::_decode_kernel. For each
// sequence b and query head h (kv head h / G):
//   out[b, h] = softmax(q[b, h] . K[layer, b, :ctx[b], h/G]^T * scale)
//               @ V[layer, b, :ctx[b], h/G]
// over the [L, B, Smax, Hkv, D] cache, with ctx[b] counting the current
// token. Slots at or past ctx[b] are never read (the TPU kernel's skip of
// blocks past the context). A sequence with ctx[b] == 0 gives 0.
//
// The kernel, its bound and its design are in decode_attn.cuh (its merge
// shared with K7); this source gives the contiguous cache's rows and
// launches it: a cluster of n_split blocks a (sequence, kv head), each over one
// chunk of the cache's slots, their softmax states merged in rank order.
// Rounding follows _decode_kernel: with G == 1 everything stays fp32; with
// G > 1 the scaled query and the probabilities are rounded to the cache's
// dtype before their products (on the tensor cores), as its MXU path does.
// An INT8 cache (int8 rows, fp32 scales [L, B, Smax, Hkv]) takes the int8
// instances: the K scale on the fp32 score, the V scale on the probability;
// with G > 1 the scaled query and the scaled probabilities are rounded to
// bf16, as _decode_kernel's kv_quant path. Bound at GPT-2 small, B = 8,
// context 896: 11.0 MB of int8 K/V and 0.69 MB of scales a layer, 3.5 us at
// 3.35 TB/s (bf16: 6.6 us); at Mistral-7B-Instruct-v0.2's decode (B 1, 8 KV
// heads of 128, context 32,704): 134 MB of bf16 K/V a layer, 40 us.
#include "decode_attn.cuh"

namespace {

// Slot t of sequence b at layer `layer` of the [L, B, Smax, Hkv, D] cache;
// the split: n_split blocks a (sequence, kv head), `chunk` slots each.
struct ContiguousRows {
  int B, Smax, Hkv, D, layer, n_split, chunk;
  __device__ int count(int b, const int* ctx) const { return max(0, min(ctx[b], Smax)); }
  __device__ size_t offset(int b, int hk, int t) const {
    return ((static_cast<size_t>(layer) * B + b) * Smax + t) * Hkv * D + static_cast<size_t>(hk) * D;
  }
};

}  // namespace

// The caches' tensor maps for the TMA pass (D 80), into out (a
// CacheMaps, sizeof 256 bytes): geo (a host array of 11) gives the dims
// [D, Hkv, Smax, L * B], the byte strides of dims 1-3 and the box
// (ops/decode_attention.py::cache_map, which checks TMA's rules). Built
// once per cache, not per launch.
extern "C" int mlio_decode_attn_maps(const void* k_cache, const void* v_cache,
                                     const long long* geo, void* out) {
  auto* maps = static_cast<decode_attn::CacheMaps*>(out);
  cudaError_t err =
      tma::map_4d(&maps->k, k_cache, geo, geo + 4, geo + 7, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = tma::map_4d(&maps->v, v_cache, geo, geo + 4, geo + 7, CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

extern "C" int mlio_decode_attn_maps_bytes() { return sizeof(decode_attn::CacheMaps); }

// q, out: [B, Hkv * G, D] bf16; k_cache, v_cache: [L, B, Smax, Hkv, D] bf16,
// or int8 with fp32 k_scale, v_scale [L, B, Smax, Hkv] (null for bf16);
// ctx: [B] int32 on the device. G in {1, 2, 4, 8}, D in {64, 128}; or G 1
// over a bf16 cache at D 80 or 256. maps: the caches' maps
// (mlio_decode_attn_maps) at D 80, else null. Each
// (sequence, kv head) takes a cluster of n_split blocks (1 to 8), each
// block `chunk` slots (a multiple of kTokenStep, 128) from rank * chunk;
// n_split * chunk must cover Smax.
extern "C" int mlio_decode_attn(const void* q, const void* k_cache, const void* v_cache,
                                const float* k_scale, const float* v_scale, const int* ctx,
                                void* out, int B, int Smax, int Hkv, int G, int D, int layer,
                                float scale, int n_split, int chunk, const void* maps,
                                void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (n_split < 1 || n_split > decode_attn::kMaxSplit ||
      (D != 64 && D != 128 && D != 80 && D != 256) || chunk <= 0 ||
      chunk % decode_attn::kTokenStep || static_cast<long long>(n_split) * chunk < Smax)
    return cudaErrorInvalidValue;
  const ContiguousRows rows{B, Smax, Hkv, D, layer, n_split, chunk};
  return decode_attn::launch<__nv_bfloat16>(q, k_cache, v_cache, k_scale, v_scale, ctx, out, B,
                                            Hkv, G, D, rows, scale,
                                            static_cast<const decode_attn::CacheMaps*>(maps),
                                            static_cast<cudaStream_t>(stream));
}
