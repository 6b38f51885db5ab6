"""Functional decoder-only transformer (``mlio_tpu/models/transformer.py``).

The model is a plain function over a nested dict of tensors with the JAX
package's layout: per-layer weights stacked on a leading ``num_layers``
axis, matmul weights stored [in, out]. The JAX ``lax.scan`` over layers
becomes a Python loop. :class:`Impl` keeps the JAX package's fields and
picks the kernels: ``attention="flash"`` takes K1 for prefill and, for
single-token decode, the megakernel K4 (``decode_stack`` "mega", or "auto"
where :func:`~mlio_tpu_torch.ops.decode_layer.supports_decode_stack` accepts
the model) or the per-layer scan through K3 (``"scan"``, or "auto"
otherwise); ``norm="fused"`` takes K2; ``mlp="fused"`` the fused MLP K11;
``fused_ln_qkv`` the fused norm+QKV K12. Quantized weights
(:class:`~mlio_tpu_torch.ops.quant.QTensor` leaves from
:func:`~mlio_tpu_torch.runtime.quantization.quantize_params`) take the
dequant-fused matmul K5 in every projection, and the fused ``wqkv`` and
``w_upgate`` layouts of ``fuse_projections`` run as in the JAX package.

Not ported yet, and raising ``NotImplementedError`` when asked for: the
tiled big-model decode (``decode_stack="tiled"``, K6), ring attention, MoE
layers and INT8 KV caches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from mlio_tpu_torch import ops
from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops import decode_attention as _decode
from mlio_tpu_torch.ops import decode_layer as _stack
from mlio_tpu_torch.ops import fused_mlp as _fused_mlp
from mlio_tpu_torch.ops.quant import QTensor

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Impl:
    """Implementation choices, with the JAX package's fields.

    ``block_q``, ``block_kv`` and ``interpret`` are the TPU kernels' tile
    and interpreter knobs; the CUDA kernels choose their own tiles and the
    port ignores them. ``ring_chunk``, ``moe`` and ``moe_capacity_factor``
    belong to paths not ported yet.
    """

    attention: str = "dense"  # "dense" | "flash" | "ring"
    mlp: str = "dense"  # "dense" | "fused"
    norm: str = "dense"  # "dense" | "fused"
    fused_ln_qkv: bool = False
    # Decode-step layer iteration: "mega" runs every layer in one K4 launch;
    # "scan" runs layer by layer with K3; "auto" takes mega where
    # supports_decode_stack accepts the model, else scan; "tiled" (K6) raises.
    decode_stack: str = "auto"
    block_q: Optional[int] = None
    block_kv: Optional[int] = None
    ring_chunk: int = 512
    interpret: Optional[bool] = None
    moe: str = "ragged"
    moe_capacity_factor: float = 2.0


def _check_supported(spec: ModelSpec, impl: Impl) -> None:
    if spec.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32, *,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random-init the stacked-layer parameter dict on ``device`` from
    ``generator`` (which must live on that device): the JAX package's
    shapes, fan-in scaled normal weights, unit norm scales, zero biases."""
    spec.validate()
    if spec.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    dev = resolve_device(device)
    h, i, l = spec.hidden_size, spec.intermediate_size, spec.num_layers
    qd, kvd = spec.q_dim, spec.kv_dim
    gated = spec.activation in ("swiglu", "geglu")

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def w(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(shape, cond):
        return torch.zeros(shape, dtype=dtype, device=dev) if cond else None

    layernorm = spec.norm == "layernorm"
    blocks = {
        "ln1_scale": ones((l, h)),
        "ln1_bias": zeros((l, h), layernorm),
        "wq": w((l, h, qd), h),
        "bq": zeros((l, qd), spec.use_qkv_bias),
        "wk": w((l, h, kvd), h),
        "bk": zeros((l, kvd), spec.use_qkv_bias),
        "wv": w((l, h, kvd), h),
        "bv": zeros((l, kvd), spec.use_qkv_bias),
        "wo": w((l, qd, h), qd),
        "bo": zeros((l, h), spec.use_out_bias),
        "ln2_scale": ones((l, h)),
        "ln2_bias": zeros((l, h), layernorm),
        "w_up": w((l, h, i), h),
        "b_up": zeros((l, i), spec.use_mlp_bias),
        "w_gate": w((l, h, i), h) if gated else None,
        "b_gate": zeros((l, i), spec.use_mlp_bias and gated),
        "w_down": w((l, i, h), i),
        "b_down": zeros((l, h), spec.use_mlp_bias),
    }
    return {
        "tok_embed": normal((spec.vocab_size, h), 0.02),
        "pos_embed": (normal((spec.max_seq_len, h), 0.01)
                      if spec.positional == "learned" else None),
        "blocks": blocks,
        "final_scale": ones((h,)),
        "final_bias": zeros((h,), layernorm),
        "lm_head": None if spec.tie_embeddings else w((h, spec.vocab_size), h),
        "lm_head_bias": zeros((spec.vocab_size,), spec.use_head_bias),
    }


# ---------------------------------------------------------------------------
# RoPE (HF Llama convention: half-split rotate, not interleaved)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions ([...] -> [..., head_dim])."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, R] or [S, R] with R <= D (partial
    rotary when R < D: the tail passes through)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    rot = cos.shape[-1]
    xr = x[..., :rot]
    half = rot // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    out = (xr * cos + rotated * sin).to(x.dtype)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(blocks: Params, layer: int) -> Params:
    """One layer's weights. A QTensor is indexed field by field (indexing
    the NamedTuple itself would pick a field, not a layer)."""
    def one(v):
        if v is None:
            return None
        return v.select(layer) if isinstance(v, QTensor) else v[layer]

    return {k: one(v) for k, v in blocks.items()}


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, num_heads, -1)


def _qkv_proj(h_norm, x, bp, spec, impl):
    """(q, k, v) flat [B, S, *_dim]: the fused norm+QKV (K12) from x; a
    fused ``wqkv`` weight (one product, split by widths); or wq/wk/wv."""
    if impl.fused_ln_qkv:
        return ops.fused_ln_qkv(x, bp["ln1_scale"], bp["ln1_bias"], bp["wq"], bp["bq"],
                                bp["wk"], bp["bk"], bp["wv"], bp["bv"], kind=spec.norm,
                                eps=spec.norm_eps, impl=impl)
    if bp.get("wqkv") is not None:
        y = ops.linear(h_norm, bp["wqkv"], bp.get("bqkv"))
        qd, kvd = spec.q_dim, spec.kv_dim
        return y[..., :qd], y[..., qd:qd + kvd], y[..., qd + kvd:]
    return (ops.linear(h_norm, bp["wq"], bp["bq"]), ops.linear(h_norm, bp["wk"], bp["bk"]),
            ops.linear(h_norm, bp["wv"], bp["bv"]))


def _attn_in(x, bp, spec, impl, cos, sin):
    """(ln1(x), q, k, v) with the heads split and RoPE applied. With
    ``fused_ln_qkv`` the norm runs inside K12, and ln1(x) is computed apart
    (and returned) only where a parallel residual shares it (Phi); XLA drops
    that unused norm in the JAX package, eager PyTorch would run it."""
    h_norm = None
    if not impl.fused_ln_qkv or (spec.parallel_residual and spec.shared_ln):
        h_norm = _norm(x, bp["ln1_scale"], bp["ln1_bias"], spec, impl)
    q, k, v = _qkv_proj(h_norm, x, bp, spec, impl)
    q = _split_heads(q, spec.num_heads)
    k = _split_heads(k, spec.num_kv_heads)
    v = _split_heads(v, spec.num_kv_heads)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return h_norm, q, k, v


def _norm(x, scale, bias, spec, impl):
    return ops.norm(x, scale, bias, kind=spec.norm, eps=spec.norm_eps, impl=impl)


def _run_mlp(h, bp, spec, impl):
    """The MLP sublayer, in the per-projection layout or the fused
    ``w_upgate`` one ([up | gate] in one product, activation in fp32)."""
    if bp.get("w_upgate") is not None:
        y = ops.linear(h, bp["w_upgate"], bp.get("b_upgate"))
        i = spec.intermediate_size
        gated = y.shape[-1] == 2 * i
        act = _fused_mlp.activate(y[..., :i] if gated else y, y[..., i:] if gated else None,
                                  spec.activation)
        return ops.linear(act.to(h.dtype), bp["w_down"], bp["b_down"])
    return ops.mlp(h, bp["w_up"], bp["w_down"], b_up=bp["b_up"], b_down=bp["b_down"],
                   w_gate=bp["w_gate"], b_gate=bp["b_gate"], activation=spec.activation,
                   impl=impl)


def _residual_tail(x, attn_out, h_norm1, bp, spec, impl):
    """Sequential (GPT-2/Llama) or parallel (GPT-NeoX; Phi shares one LN)
    residual combination."""
    if spec.parallel_residual:
        h2 = h_norm1 if spec.shared_ln else _norm(x, bp["ln2_scale"], bp["ln2_bias"],
                                                  spec, impl)
        return x + attn_out + _run_mlp(h2, bp, spec, impl)
    x = x + attn_out
    return x + _run_mlp(_norm(x, bp["ln2_scale"], bp["ln2_bias"], spec, impl), bp, spec, impl)


def _head(x, params, spec, impl):
    """Final norm, lm_head (tied: x @ tok_embed.T, plain matmul) and softcap."""
    x = _norm(x, params["final_scale"], params["final_bias"], spec, impl)
    if params.get("lm_head") is not None:
        logits = ops.linear(x, params["lm_head"], params.get("lm_head_bias"))
    else:
        logits = x @ params["tok_embed"].T.to(x.dtype)
    if spec.logits_softcap is not None:
        logits = spec.logits_softcap * torch.tanh(logits / spec.logits_softcap)
    return logits


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: torch.Tensor,
    *,
    impl: Impl = Impl(),
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the model on ``input_ids`` [B, S].

    Without a cache this is a full (prefill/scoring) forward. With a cache
    (:func:`mlio_tpu_torch.runtime.kv_cache.init_cache`) the S new tokens'
    K/V are written at ``cache["pos"]`` and attention runs over the whole
    static cache with ``q_offset``/``kv_len`` masking. Unlike the JAX
    package, the cache tensors are updated in place: the returned cache
    holds the same ``k``/``v`` tensors and the advanced ``pos``.

    Returns (logits [B, S, V], cache or None).
    """
    _check_supported(spec, impl)
    B, S = input_ids.shape
    x = params["tok_embed"][input_ids]
    if spec.embed_scale is not None:  # the scale is rounded to x's dtype first, as in JAX
        x = x * torch.tensor(spec.embed_scale, dtype=x.dtype).item()
    dtype = x.dtype

    pos = cache["pos"] if cache is not None else 0
    if cache is not None and "k_scale" in cache:
        raise NotImplementedError("INT8 KV caches are not ported yet")
    positions = (torch.arange(S, device=x.device) + pos)[None].expand(B, S)
    if spec.positional == "learned":
        x = x + params["pos_embed"][positions].to(dtype)
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(positions, spec.rope_dim, spec.rope_theta)

    if cache is not None and S == 1 and impl.attention != "dense":
        return _decode_forward(params, spec, x, cache, impl, cos, sin)

    blocks = params["blocks"]
    for layer in range(spec.num_layers):
        bp = _layer(blocks, layer)
        h_norm, q, k, v = _attn_in(x, bp, spec, impl, cos, sin)
        if cache is not None:
            # Write the S new tokens into the caller's cache in place, then
            # attend over the whole static cache with a kv_len mask.
            ck, cv = cache["k"][layer], cache["v"][layer]
            ck[:, pos:pos + S] = k.to(ck.dtype)
            cv[:, pos:pos + S] = v.to(cv.dtype)
            attn = ops.attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                                 q_offset=pos, kv_len=pos + S, impl=impl)
        else:
            attn = ops.attention(q, k, v, causal=True, impl=impl)
        attn_out = ops.linear(attn.reshape(B, S, spec.q_dim), bp["wo"], bp["bo"])
        x = _residual_tail(x, attn_out, h_norm, bp, spec, impl)

    new_cache = None if cache is None else {"k": cache["k"], "v": cache["v"],
                                            "pos": pos + S}
    return _head(x, params, spec, impl), new_cache


def use_decode_stack(spec: ModelSpec, impl: Impl, blocks) -> bool:
    """Whether single-token decode runs K4 (the JAX package's ``use_mega``).
    ``"mega"`` on a model K4 does not run raises; ``"tiled"`` raises until
    K6 is ported."""
    if impl.decode_stack == "tiled":
        raise NotImplementedError(
            "decode_stack='tiled' needs the tiled decode kernel (K6, "
            "mlio_tpu/ops/decode_tiled.py::_tiled_kernel), not ported yet")
    if impl.decode_stack not in ("auto", "scan", "mega"):
        raise ValueError(f"unknown decode_stack {impl.decode_stack!r}")
    supported = _stack.supports_decode_stack(spec, blocks=blocks)
    if impl.decode_stack == "mega" and not supported:
        raise ValueError(f"decode_stack='mega': K4 does not run {spec.name} "
                         "(parallel residual, experts or activation)")
    return impl.decode_stack == "mega" or (impl.decode_stack == "auto" and supported)


def _decode_forward(params, spec, x, cache, impl, cos, sin):
    """Single-token decode (the JAX package's ``_decode_forward``): one K4
    launch for every layer, then the head; or layer by layer through K3.
    Either writes the token's K/V into the cache in place."""
    B = x.shape[0]
    pos = cache["pos"]
    ck, cv = cache["k"], cache["v"]
    blocks = params["blocks"]
    if use_decode_stack(spec, impl, blocks):
        # One position for the whole batch: the rope table collapses to [1, R].
        cs = (cos[:1, 0], sin[:1, 0]) if cos is not None else (None, None)
        h, _ = _stack.decode_layer_stack(x[:, 0], blocks, ck, cv, pos, cs[0], cs[1],
                                         spec=spec)
        return _head(h[:, None], params, spec, impl), {"k": ck, "v": cv, "pos": pos + 1}
    ctx = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    for layer in range(spec.num_layers):
        bp = _layer(blocks, layer)
        h_norm, q, k, v = _attn_in(x, bp, spec, impl, cos, sin)
        ck[layer, :, pos] = k[:, 0].to(ck.dtype)
        cv[layer, :, pos] = v[:, 0].to(cv.dtype)
        attn = _decode.decode_attention(q[:, 0], ck, cv, ctx, layer=layer)
        attn = attn.reshape(B, 1, spec.q_dim).to(x.dtype)
        x = _residual_tail(x, ops.linear(attn, bp["wo"], bp["bo"]), h_norm, bp, spec, impl)
    return _head(x, params, spec, impl), {"k": ck, "v": cv, "pos": pos + 1}
