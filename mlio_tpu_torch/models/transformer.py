"""Functional decoder-only transformer (``mlio_tpu/models/transformer.py``).

The model is a plain function over a nested dict of tensors with the JAX
package's layout: per-layer weights stacked on a leading ``num_layers``
axis, matmul weights stored [in, out]. The JAX ``lax.scan`` over layers
becomes a Python loop. :class:`Impl` keeps the JAX package's fields and
picks the kernels: ``attention="flash"`` takes K1 for prefill (K10 once the
K/V pass the JAX package's budget, ``ops.flash_attention.stream_route``: a
cached prefill over more than 12,288 slots at head dim 128) and, for
single-token decode, the megakernel K4 (``decode_stack="mega"``), the tiled
megakernel K6 with the head after it (``"tiled"``) or the per-layer scan
through K3 (``"scan"``); ``"auto"`` chooses by :func:`decode_route`;
``norm="fused"`` takes K2; ``mlp="fused"`` the fused MLP K11;
``fused_ln_qkv`` the fused norm+QKV K12. Quantized weights
(:class:`~mlio_tpu_torch.ops.quant.QTensor` leaves from
:func:`~mlio_tpu_torch.runtime.quantization.quantize_params`) take the
dequant-fused matmul K5 in every projection, and the fused ``wqkv`` and
``w_upgate`` layouts of ``fuse_projections`` run as in the JAX package.

An INT8 KV cache (``init_cache(quant="int8")``) is written with
``quantize_kv`` and read with its scales: K9 in prefill, K4's INT8 path or
K3's int8 instances in decode, as in the JAX package; K6 takes int8 or fp8
weights over a bf16 or an INT8 cache.

Sparse-MoE models (Mixtral: a router ``[L, H, E]`` and expert stacks
``moe_up``/``moe_gate`` ``[L, E, H, I]``, ``moe_down`` ``[L, E, I, H]``) run
their MLP through ``ops.moe_mlp`` by ``Impl.moe`` in prefill and on the scan
decode; K4 refuses experts, so ``"auto"`` decodes them on K6, whose MoE
phases route in the kernel.

Training: the cache-free path (:func:`run_layer_stack`) writes nothing in
place, so autograd follows it; ``Impl(attention="flash")`` attends through
``ops.attention``'s training route (K1 forward, K13 backward), and the
kernels without a backward (K2, K5, K11, K12, the decode kernels) raise
under autograd, as the JAX package cannot differentiate them either
(``runtime/train.py``).

Speculative decoding (``runtime/speculative.py``) runs both forms: a
verify window of gamma + 1 tokens is a cached forward (K1 at ``q_offset``
over the whole cache, K2 with ``norm="fused"``), a draft step a
single-token decode on ``decode_route``'s route (K4 at B <= 8).

``Impl(attention="ring")`` attends through ``ops.attention``'s ring route
(``ops/ring_attention.py``, chunks of ``ring_chunk`` keys): on the card its
single-device fold is one ``flash_attention`` call, the flash route's own
(K1, or K10 past its threshold), so a ring prefill gives the flash route's
bits; on the CPU the fp32 chunk walk. As in the JAX package, every route
but "dense" decodes a single token on the decode kernels (``decode_route``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from mlio_tpu_torch import ops
from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops import decode_attention as _decode
from mlio_tpu_torch.ops import decode_layer as _stack
from mlio_tpu_torch.ops import decode_tiled as _tiled
from mlio_tpu_torch.ops import fused_mlp as _fused_mlp
from mlio_tpu_torch.ops.quant import QTensor, quantize_kv

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Impl:
    """Implementation choices, with the JAX package's fields.

    ``block_q``, ``block_kv`` and ``interpret`` are the TPU kernels' tile
    and interpreter knobs; the CUDA kernels choose their own tiles and the
    port ignores them. ``ring_chunk`` is ring attention's chunk of keys
    (``ops/ring_attention.py``). ``moe`` picks the MoE method ("ragged",
    "dense" or "dispatch", ``ops/moe.py``) of the prefill and the scan
    decode, and ``moe_capacity_factor`` the dispatch's capacity.
    """

    attention: str = "dense"  # "dense" | "flash" | "ring"
    mlp: str = "dense"  # "dense" | "fused"
    norm: str = "dense"  # "dense" | "fused"
    fused_ln_qkv: bool = False
    # Decode-step layer iteration: "mega" runs every layer in one K4 launch;
    # "tiled" in one K6 launch, the head after it; "scan" layer by layer
    # with K3; "auto" as decode_route decides.
    decode_stack: str = "auto"
    block_q: Optional[int] = None
    block_kv: Optional[int] = None
    ring_chunk: int = 512
    interpret: Optional[bool] = None
    moe: str = "ragged"
    moe_capacity_factor: float = 2.0


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(spec: ModelSpec, generator: torch.Generator, dtype=torch.float32, *,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random-init the stacked-layer parameter dict on ``device`` from
    ``generator`` (which must live on that device): the JAX package's
    shapes, fan-in scaled normal weights, unit norm scales, zero biases."""
    spec.validate()
    return _init_params(spec, generator, dtype, resolve_device(device), lambda name, w: w)


def _init_params(spec: ModelSpec, generator: torch.Generator, dtype, dev,
                 finish: Callable[[str, torch.Tensor], Any]) -> Params:
    """:func:`init_params` with each projection weight handed to
    ``finish(name, stack)`` as soon as it is drawn, before the next draw
    (``streamed_quantized_init`` quantizes it there)."""
    h, i, l = spec.hidden_size, spec.intermediate_size, spec.num_layers
    qd, kvd = spec.q_dim, spec.kv_dim
    gated = spec.activation in ("swiglu", "geglu")

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def w(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def proj(name, shape, fan_in):
        return finish(name, w(shape, fan_in))

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(shape, cond):
        return torch.zeros(shape, dtype=dtype, device=dev) if cond else None

    layernorm = spec.norm == "layernorm"
    blocks = {
        "ln1_scale": ones((l, h)),
        "ln1_bias": zeros((l, h), layernorm),
        "wq": proj("wq", (l, h, qd), h),
        "bq": zeros((l, qd), spec.use_qkv_bias),
        "wk": proj("wk", (l, h, kvd), h),
        "bk": zeros((l, kvd), spec.use_qkv_bias),
        "wv": proj("wv", (l, h, kvd), h),
        "bv": zeros((l, kvd), spec.use_qkv_bias),
        "wo": proj("wo", (l, qd, h), qd),
        "bo": zeros((l, h), spec.use_out_bias),
        "ln2_scale": ones((l, h)),
        "ln2_bias": zeros((l, h), layernorm),
    }
    if spec.num_experts:  # sparse MoE: a router and expert-stacked MLPs, no dense MLP
        E = spec.num_experts
        blocks.update({
            "w_up": None, "b_up": None, "w_gate": None, "b_gate": None,
            "w_down": None, "b_down": None,
            "router": w((l, h, E), h),
            "moe_up": proj("moe_up", (l, E, h, i), h),
            "moe_gate": proj("moe_gate", (l, E, h, i), h) if gated else None,
            "moe_down": proj("moe_down", (l, E, i, h), i),
        })
    else:
        blocks.update({
            "w_up": proj("w_up", (l, h, i), h),
            "b_up": zeros((l, i), spec.use_mlp_bias),
            "w_gate": proj("w_gate", (l, h, i), h) if gated else None,
            "b_gate": zeros((l, i), spec.use_mlp_bias and gated),
            "w_down": proj("w_down", (l, i, h), i),
            "b_down": zeros((l, h), spec.use_mlp_bias),
        })
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


def _layers(blocks: Params):
    """Every layer's weights, the stacked tensors unbound along the layer
    axis: unbind's backward stacks the layers' gradients once, where taking
    one layer at a time would scatter each layer's into a zero tensor of the
    whole stack."""
    L = blocks["ln1_scale"].shape[0]
    cols = {}
    for k, v in blocks.items():
        if v is None:
            cols[k] = [None] * L
        elif isinstance(v, QTensor):
            cols[k] = [v.select(i) for i in range(L)]
        else:
            cols[k] = v.unbind(0)
    return [{k: c[i] for k, c in cols.items()} for i in range(L)]


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
    """The MLP sublayer: sparse MoE (``ops.moe_mlp`` by ``impl.moe``), the
    per-projection layout, or the fused ``w_upgate`` one ([up | gate] in one
    product, activation in fp32)."""
    if bp.get("router") is not None:
        return ops.moe_mlp(h, bp["router"], bp.get("moe_gate"), bp["moe_up"], bp["moe_down"],
                           top_k=spec.num_experts_per_tok, activation=spec.activation,
                           method=impl.moe,
                           capacity_factor=impl.moe_capacity_factor).to(h.dtype)
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


def _head(x, params, spec, impl, return_hidden=False):
    """Final norm, lm_head (tied: x @ tok_embed.T, plain matmul) and softcap;
    the normed x alone with ``return_hidden``."""
    x = _norm(x, params["final_scale"], params["final_bias"], spec, impl)
    if return_hidden:
        return x
    if params.get("lm_head") is not None:
        logits = ops.linear(x, params["lm_head"], params.get("lm_head_bias"))
    else:
        logits = x @ params["tok_embed"].T.to(x.dtype)
    if spec.logits_softcap is not None:
        logits = spec.logits_softcap * torch.tanh(logits / spec.logits_softcap)
    return logits


def run_layer_stack(x: torch.Tensor, blocks: Params, spec: ModelSpec, impl: Impl,
                    cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None, attend=None) -> torch.Tensor:
    """Run a stack of transformer blocks over x [B, S, H]: every layer of
    ``blocks`` (stacked on the leading axis, as many as it holds, so a
    pipeline stage may pass its slice). ``attend(layer, q, k, v)`` gives a
    layer's attention output; by default causal attention over the S tokens
    alone (no KV cache), which autograd can follow (``ops.attention``'s
    training route; nothing is written in place)."""
    B, S, _ = x.shape
    if attend is None:
        def attend(layer, q, k, v):
            return ops.attention(q, k, v, causal=True, impl=impl)
    for layer, bp in enumerate(_layers(blocks)):
        h_norm, q, k, v = _attn_in(x, bp, spec, impl, cos, sin)
        attn = attend(layer, q, k, v)
        attn_out = ops.linear(attn.reshape(B, S, spec.q_dim), bp["wo"], bp["bo"])
        x = _residual_tail(x, attn_out, h_norm, bp, spec, impl)
    return x


def forward(
    params: Params,
    spec: ModelSpec,
    input_ids: torch.Tensor,
    *,
    impl: Impl = Impl(),
    cache: Optional[Dict[str, Any]] = None,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the model on ``input_ids`` [B, S].

    ``positions`` ([B, S] or [1, S]; by default the cache's position onward)
    index the learned position table or the RoPE tables. ``return_hidden``
    returns the final-normed hidden states [B, S, H] in place of the logits.

    Without a cache this is a full (prefill/scoring) forward. With a cache
    (:func:`mlio_tpu_torch.runtime.kv_cache.init_cache`) the S new tokens'
    K/V are written at ``cache["pos"]`` and attention runs over the whole
    static cache with ``q_offset``/``kv_len`` masking. An INT8 cache (with
    ``k_scale``/``v_scale``) gets ``quantize_kv`` of the new K/V and is
    attended with its scales. Unlike the JAX package, the cache tensors are
    updated in place: the returned cache holds the same tensors and the
    advanced ``pos``.

    Returns (logits [B, S, V], cache or None).
    """
    B, S = input_ids.shape
    x = params["tok_embed"][input_ids]
    if spec.embed_scale is not None:  # the scale is rounded to x's dtype first, as in JAX
        x = x * torch.tensor(spec.embed_scale, dtype=x.dtype).item()
    dtype = x.dtype

    pos = cache["pos"] if cache is not None else 0
    quant = cache is not None and "k_scale" in cache
    if positions is None:
        positions = (torch.arange(S, device=x.device) + pos)[None].expand(B, S)
    if spec.positional == "learned":
        x = x + params["pos_embed"][positions].to(dtype)
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(positions, spec.rope_dim, spec.rope_theta)

    if cache is not None and S == 1 and impl.attention != "dense" and not return_hidden:
        return _decode_forward(params, spec, x, cache, impl, cos, sin)

    if cache is None:
        x = run_layer_stack(x, params["blocks"], spec, impl, cos, sin)
        return _head(x, params, spec, impl, return_hidden), None

    def attend(layer, q, k, v):
        ck, cv = cache["k"][layer], cache["v"][layer]
        if quant:
            # The INT8 cache: quantize the new K/V per (token, head), write
            # values and scales, attend over the int8 cache with its scales.
            cks, cvs = cache["k_scale"][layer], cache["v_scale"][layer]
            ck[:, pos:pos + S], cks[:, pos:pos + S] = quantize_kv(k)
            cv[:, pos:pos + S], cvs[:, pos:pos + S] = quantize_kv(v)
            return ops.attention(q, ck, cv, causal=True, q_offset=pos, kv_len=pos + S,
                                 k_scale=cks, v_scale=cvs, impl=impl)
        # Write the S new tokens into the caller's cache in place, then
        # attend over the whole static cache with a kv_len mask.
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        return ops.attention(q, ck.to(dtype), cv.to(dtype), causal=True,
                             q_offset=pos, kv_len=pos + S, impl=impl)

    x = run_layer_stack(x, params["blocks"], spec, impl, cos, sin, attend)
    return _head(x, params, spec, impl, return_hidden), dict(cache, pos=pos + S)


_ROUTES = ("auto", "scan", "mega", "tiled")


def decode_route(spec: ModelSpec, impl: Impl, blocks, B: int, cache_quant: bool = False,
                 smax: Optional[int] = None, on_card: bool = True) -> str:
    """The single-token decode route for a batch of B: ``"mega"`` (K4),
    ``"tiled"`` (K6, the head after it) or ``"scan"`` (layer by layer through
    K3); asked with the cache's quantization and length, as ``generate``
    asks, before any launch.

    ``"auto"`` takes K4 where K4 runs the model at this batch
    (``supports_decode_stack``) and the port's K4-or-K6 rule
    (``decode_tiled.prefer_mega``, which replaces the JAX package's VMEM
    rule) picks it, else K6 where ``supports_decode_tiled`` accepts, else
    the scan. ``"mega"`` and ``"tiled"`` raise a ValueError on what their
    kernel does not run. ``on_card``: the kernels' head and width limits
    apply (the CPU's plain versions take any head geometry; the batch
    limits apply everywhere)."""
    mode = impl.decode_stack
    if mode not in _ROUTES:
        raise ValueError(f"unknown decode_stack {mode!r}")
    if mode == "scan":
        return "scan"
    mega = _stack.supports_decode_stack(spec, cache_quant=cache_quant, blocks=blocks, smax=smax,
                                        B=B, on_card=on_card)
    if mode == "mega":
        if spec.num_experts:
            raise ValueError(f"decode_stack='mega': K4 does not run {spec.name}'s "
                             f"{spec.num_experts} experts (its MLP phase is dense); "
                             "decode_stack='tiled' runs them on K6")
        if not mega:
            limit = _stack.route_limit(spec, B, on_card)
            raise ValueError(
                f"decode_stack='mega': K4 does not run {spec.name} at batch {B} with these "
                "weights and this cache (" + (limit or "parallel residual, experts, activation, "
                "int4 or fp8 weights, or an INT8 cache not a multiple of 128 long") + ")")
        return "mega"
    tiled = _tiled.supports_decode_tiled(spec, B, cache_quant=cache_quant, blocks=blocks,
                                         smax=smax, on_card=on_card)
    if mode == "tiled":
        if not tiled:
            limit = _tiled.tiled_route_limit(spec, B, on_card, cache_quant, blocks)
            raise ValueError(
                f"decode_stack='tiled': K6 does not run {spec.name} at batch {B} with these "
                "weights and this cache (" + (limit or "parallel residual, activation, int4 "
                "weights, the fused layout, experts without a router or stored otherwise than "
                "the attention weights, or an INT8 cache not a multiple of 128 long")
                + ")")
        return "tiled"
    if mega and (not tiled or _tiled.prefer_mega(spec, _tiled._weight_itemsize(blocks) or 2)):
        return "mega"
    return "tiled" if tiled else "scan"


def _decode_forward(params, spec, x, cache, impl, cos, sin):
    """Single-token decode (the JAX package's ``_decode_forward``): one K4
    launch for every layer, then the head; one K6 launch, then the head; or
    layer by layer through K3. Each writes the token's K/V into the cache in
    place."""
    B = x.shape[0]
    pos = cache["pos"]
    ck, cv = cache["k"], cache["v"]
    cks, cvs = cache.get("k_scale"), cache.get("v_scale")
    quant = cks is not None
    blocks = params["blocks"]
    new_cache = dict(cache, pos=pos + 1)
    route = decode_route(spec, impl, blocks, B, cache_quant=quant, smax=ck.shape[2],
                         on_card=x.device.type == "cuda")
    if route != "scan":
        # One position for the whole batch: the rope table collapses to [1, R].
        cs = (cos[:1, 0], sin[:1, 0]) if cos is not None else (None, None)
        if route == "mega":
            h, _ = _stack.decode_layer_stack(x[:, 0], blocks, ck, cv, pos, cs[0], cs[1],
                                             spec=spec, k_scales=cks, v_scales=cvs)
        else:
            h = _tiled.decode_layer_tiled(x[:, 0], blocks, ck, cv, pos, cs[0], cs[1], spec=spec,
                                          k_scales=cks, v_scales=cvs)
        return _head(h[:, None], params, spec, impl), new_cache
    ctx = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    for layer in range(spec.num_layers):
        bp = _layer(blocks, layer)
        h_norm, q, k, v = _attn_in(x, bp, spec, impl, cos, sin)
        if quant:
            ck[layer, :, pos], cks[layer, :, pos] = quantize_kv(k[:, 0])
            cv[layer, :, pos], cvs[layer, :, pos] = quantize_kv(v[:, 0])
        else:
            ck[layer, :, pos] = k[:, 0].to(ck.dtype)
            cv[layer, :, pos] = v[:, 0].to(cv.dtype)
        attn = _decode.decode_attention(q[:, 0], ck, cv, ctx, layer=layer, k_scales=cks,
                                        v_scales=cvs)
        attn = attn.reshape(B, 1, spec.q_dim).to(x.dtype)
        x = _residual_tail(x, ops.linear(attn, bp["wo"], bp["bo"]), h_norm, bp, spec, impl)
    return _head(x, params, spec, impl), new_cache
