"""Weight quantization of a parameter dict (``mlio_tpu/runtime/quantization.py``).

:func:`quantize_params` replaces the projection weights with
:class:`~mlio_tpu_torch.ops.quant.QTensor` leaves, quantizing each layer's
matrix on its own as the JAX package's ``vmap`` does, and bit for bit as it
does; the forward then takes the dequant-fused matmul (K5) through
``ops.linear``. An MoE model's expert stacks (``QUANTIZABLE_MOE``) get
per-expert per-output-channel scales ``[L, E, out]``.
:func:`fuse_projections` concatenates wq|wk|wv and w_up|w_gate, and
:func:`quantized_size_bytes` counts the bytes.

:func:`init_quantized_params` draws random weights directly as int8 or fp8
payloads, a layer at a time on the card (or the CPU when the caller asks
for it), so that a model whose
bf16 weights would not fit (Mixtral-8x7B: 93 GB in bf16, 47 GB in int8) is
never widened; :func:`streamed_quantized_init` draws each bf16 stack of
:func:`~mlio_tpu_torch.models.transformer.init_params` in turn and quantizes
it before the next, equal to ``quantize_params(init_params(...))`` with the
same generator state.

W8A8: :func:`calibrate_activation_scales` takes each layer's activation
amax at the inputs of the quantizable products in one forward, and
:func:`apply_activation_scales` attaches ``act_scale = amax / 127`` to the
int8 weights of each site (``_W8A8_SITES``), so that ``ops.linear`` takes
``w8a8_matmul``. :func:`transcode_fp8_to_int8` requantizes fp8 weights to
per-output-channel int8, one matrix at a time.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Sequence, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.utils import get_model_size
from mlio_tpu_torch.ops.quant import (FP8, QTensor, dequantize, divided, quantize,
                                      quantize_int8)

QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
# MoE expert stacks carry an expert axis: [L, E, K, N]
QUANTIZABLE_MOE = ("moe_up", "moe_gate", "moe_down")


def _quantize_stack(w: torch.Tensor, fmt: str) -> QTensor:
    """Quantize each layer of a [L, ..., K, N] stack (each [K, N] matrix
    on its own) into preallocated outputs, so that one layer's fp32
    temporaries are alive at a time."""
    first = quantize(w[0], fmt)
    q = torch.empty((w.shape[0], *first.q.shape), dtype=first.q.dtype, device=w.device)
    scale = torch.empty((w.shape[0], *first.scale.shape), dtype=first.scale.dtype,
                        device=w.device)
    q[0], scale[0] = first.q, first.scale
    for layer in range(1, w.shape[0]):
        t = quantize(w[layer], fmt)
        q[layer], scale[layer] = t.q, t.scale
    return QTensor(q, scale, fmt)


def quantize_params(
    params: Dict[str, Any],
    spec: ModelSpec,
    weights: str = "int8",
    *,
    quantize_lm_head: bool = False,
    skip: Sequence[str] = (),
    donate: bool = False,
) -> Dict[str, Any]:
    """Quantize every projection weight, expert stacks included, to
    ``weights`` ∈ {int8, int4, fp8}; embeddings, norms and the router stay
    as they are.

    ``donate=True`` consumes ``params``: its ``blocks`` dict loses each
    full-precision stack as that stack's QTensor is built, so the caller
    holds no reference to it and its memory is freed before the next one is
    quantized. With ``quantize_lm_head`` the untied lm_head is quantized too,
    at int8 when the body is int4 (the JAX package's head-precision floor).
    """
    if weights in (None, "none"):
        return params
    out = dict(params)
    blocks = params["blocks"] if donate else dict(params["blocks"])
    for name in QUANTIZABLE + QUANTIZABLE_MOE:
        w = blocks.get(name)
        if w is None or name in skip:
            continue
        if donate:
            del blocks[name]
        blocks[name] = _quantize_stack(w, weights)
        del w
    out["blocks"] = blocks
    if quantize_lm_head and params.get("lm_head") is not None:
        lm = params["lm_head"]
        if donate:
            params["lm_head"] = None
        out["lm_head"] = quantize(lm, "int8" if weights == "int4" else weights)
    return out


def _same_act_scale(ws: Sequence[QTensor]):
    """The one ``act_scale`` of the parts (None when none has one); raises
    when they differ, since one product quantizes x once."""
    first = ws[0].act_scale
    for w in ws[1:]:
        a = w.act_scale
        if (a is None) != (first is None) or (a is not None and not torch.equal(a, first)):
            raise ValueError("fuse_projections: the parts' W8A8 act_scales differ (the fused "
                             "product quantizes its input once)")
    return first


def _concat_weights(ws: Sequence[Any]) -> Any:
    """Concatenate weights (tensors, or QTensors of one format) along the
    output axis, scales with them. W8A8 parts keep their ``act_scale``,
    which must be the same for all of them (one site feeds wq, wk and wv,
    and w_up and w_gate). The JAX package drops it here, which turns a W8A8
    model back into weight-only int8."""
    ws = [w for w in ws if w is not None]
    if isinstance(ws[0], QTensor):
        if not all(isinstance(w, QTensor) and w.fmt == ws[0].fmt for w in ws):
            raise ValueError("fuse_projections: weights of mixed formats")
        return QTensor(torch.cat([w.q for w in ws], dim=-1),
                       torch.cat([w.scale for w in ws], dim=-1), ws[0].fmt,
                       _same_act_scale(ws))
    return torch.cat(ws, dim=-1)


def fuse_projections(params: Dict[str, Any], spec: ModelSpec) -> Dict[str, Any]:
    """Fuse each layer's wq|wk|wv into ``wqkv`` and, for gated MLPs,
    w_up|w_gate into ``w_upgate`` (one product each, split by widths in the
    forward). Works on tensors and on QTensors. The fused layout does not
    run the decode megakernel, which reads the separate weights."""
    blocks = dict(params["blocks"])
    blocks["wqkv"] = _concat_weights([blocks.pop("wq"), blocks.pop("wk"), blocks.pop("wv")])
    bqkv = [blocks.pop(n, None) for n in ("bq", "bk", "bv")]
    blocks["bqkv"] = torch.cat(bqkv, dim=-1) if all(b is not None for b in bqkv) else None
    if blocks.get("w_gate") is not None:
        blocks["w_upgate"] = _concat_weights([blocks.pop("w_up"), blocks.pop("w_gate")])
        b_up, b_gate = blocks.pop("b_up", None), blocks.pop("b_gate", None)
        blocks["b_upgate"] = (torch.cat([b_up, b_gate], dim=-1)
                              if b_up is not None and b_gate is not None else None)
    return {**params, "blocks": blocks}


def _transcode(t: QTensor) -> QTensor:
    """An fp8 QTensor requantized to per-output-channel int8, one [K, N]
    matrix (one layer, one expert) at a time into preallocated outputs: the
    fp32 dequantization of one matrix is the widest temporary."""
    q = torch.empty(t.q.shape, dtype=torch.int8, device=t.q.device)
    scale = torch.empty(t.scale.shape, dtype=torch.float32, device=t.q.device)
    for idx in itertools.product(*map(range, t.q.shape[:-2])):
        m = quantize_int8(dequantize(QTensor(t.q[idx], t.scale[idx], "fp8"), torch.float32))
        q[idx], scale[idx] = m.q, m.scale
    return QTensor(q, scale, "int8")


def transcode_fp8_to_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every fp8 QTensor of the blocks (expert stacks included) and an fp8
    lm_head requantized to per-output-channel int8: the quantizer of
    ``quantize_params(..., "int8")`` applied to the fp32 dequantization, as
    in the JAX package. The same bytes an element, and the decode kernels'
    int8 paths; the other leaves are shared with ``params``. One matrix is
    widened at a time, so no whole fp32 stack is ever materialised."""
    def tc(leaf):
        return _transcode(leaf) if isinstance(leaf, QTensor) and leaf.fmt == "fp8" else leaf

    out = dict(params)
    out["blocks"] = {k: tc(v) for k, v in params["blocks"].items()}
    out["lm_head"] = tc(params.get("lm_head"))
    return out


# site -> the weights that consume that activation
_W8A8_SITES = {
    "attn_in": ("wq", "wk", "wv"),
    "attn_out_in": ("wo",),
    "mlp_in": ("w_up", "w_gate"),
    "mlp_down_in": ("w_down",),
}


def _calibration_batch(params, spec: ModelSpec, ids: torch.Tensor):
    """The four sites' amax a layer ([L] fp32 each) over one [B, S] batch."""
    from mlio_tpu_torch import ops
    from mlio_tpu_torch.models.transformer import (Impl, _layers, _qkv_proj, _split_heads,
                                                   apply_rope, rope_cos_sin)
    from mlio_tpu_torch.ops.fused_mlp import activate

    impl = Impl()
    B, S = ids.shape
    x = params["tok_embed"][ids]
    if spec.positional == "learned":
        x = x + params["pos_embed"][:S][None].to(x.dtype)
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(torch.arange(S, device=ids.device)[None], spec.rope_dim,
                                spec.rope_theta)

    def amax(t):
        return t.float().abs().max()

    def norm(x, scale, bias):
        return ops.norm(x, scale, bias, kind=spec.norm, eps=spec.norm_eps, impl=impl)

    stats = []
    for bp in _layers(params["blocks"]):
        h1 = norm(x, bp["ln1_scale"], bp["ln1_bias"])
        q, k, v = _qkv_proj(h1, x, bp, spec, impl)
        q = _split_heads(q, spec.num_heads)
        k = _split_heads(k, spec.num_kv_heads)
        v = _split_heads(v, spec.num_kv_heads)
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn = ops.attention(q, k, v, causal=True, impl=impl).reshape(B, S, spec.q_dim)
        x = x + ops.linear(attn, bp["wo"], bp["bo"])
        h2 = norm(x, bp["ln2_scale"], bp["ln2_bias"])
        u = ops.linear(h2, bp["w_up"], bp["b_up"])
        g = ops.linear(h2, bp["w_gate"], bp["b_gate"]) if bp.get("w_gate") is not None else None
        act = activate(u, g, spec.activation)
        x = x + ops.linear(act.to(x.dtype), bp["w_down"], bp["b_down"])
        stats.append(torch.stack([amax(h1), amax(attn), amax(h2), amax(act)]))
    return torch.stack(stats, dim=1)  # [4 sites, L]


def calibrate_activation_scales(params, spec: ModelSpec, sample_ids, *,
                                num_batches: int = 1) -> Dict[str, torch.Tensor]:
    """Each layer's activation amax at the inputs of the quantizable
    products, in one forward a batch (the JAX package's calibration):

      attn_in      -> wq/wk/wv input (post-ln1)
      attn_out_in  -> wo input (attention output)
      mlp_in       -> w_up/w_gate input (post-ln2)
      mlp_down_in  -> w_down input (post-activation, fp32)

    Returns {site: [num_layers] fp32 amax} on the parameters' device.
    ``sample_ids`` is [B, S] or [num_batches, B, S]; the stats take the max
    over batches. The walk is the JAX package's: the dense ``Impl()``, the
    sequential residual of the dense-path models W8A8 serves, no embedding
    scale. ``num_batches`` is the JAX signature's and unused there too."""
    dev = params["tok_embed"].device
    ids = torch.as_tensor(sample_ids, device=dev)
    if ids.ndim == 2:
        ids = ids[None]
    acc = None
    with torch.inference_mode():
        for b in range(ids.shape[0]):
            stats = _calibration_batch(params, spec, ids[b])
            acc = stats if acc is None else torch.maximum(acc, stats)
    return dict(zip(_W8A8_SITES, acc.clone().unbind(0)))


def apply_activation_scales(params: Dict[str, Any], act_stats: Dict[str, torch.Tensor], *,
                            margin: float = 1.0) -> Dict[str, Any]:
    """Attach static activation scales to the int8 weights → W8A8: each
    projection of a site gets ``act_scale = site_amax / 127 * margin`` ([L];
    1 where the amax is 0), so that ``ops.linear`` takes
    ``ops.quant.w8a8_matmul``. Other formats and missing sites stay as they
    are. The decode megakernels (K4, K6, K8) ignore ``act_scale`` and decode
    with weight-only int8, as the JAX package's do."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for site, names in _W8A8_SITES.items():
        if site not in act_stats:
            continue
        sc = divided(act_stats[site].float(), 127.0) * margin
        sc = torch.where(sc == 0, torch.ones_like(sc), sc)
        for name in names:
            w = blocks.get(name)
            if isinstance(w, QTensor) and w.fmt == "int8":
                blocks[name] = QTensor(w.q, w.scale, w.fmt, sc.to(w.q.device))
    out["blocks"] = blocks
    return out


def quantized_size_bytes(params) -> int:
    """Total parameter bytes, quantized payloads and scales included."""
    return get_model_size(params)["total_bytes"]


def _draw_payload(shape, weights: str, generator: torch.Generator, dev) -> torch.Tensor:
    """A random payload [L, ...] of int8 uniform in [-127, 127] (cast to
    e4m3 for fp8, as the JAX package casts its int8 draw), drawn a layer at
    a time into the stack: no wider temporary than one layer's."""
    q = torch.empty(shape, dtype=torch.int8 if weights == "int8" else FP8, device=dev)
    for layer in range(shape[0]):
        if weights == "int8":
            q[layer].random_(-127, 128, generator=generator)
        else:
            t = torch.empty(shape[1:], dtype=torch.int8, device=dev)
            q[layer] = t.random_(-127, 128, generator=generator).to(FP8)
            del t
    return q


def _generator_device(generator: torch.Generator, device) -> torch.device:
    """``resolve_device(device)``, which ``generator`` must live on."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the parameters on {dev}: "
                         f"pass torch.Generator(device={dev.type!r})")
    return dev


def init_quantized_params(spec: ModelSpec, generator: torch.Generator, weights: str = "int8",
                          dtype=torch.bfloat16, quantize_lm_head: bool = False, *,
                          device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random parameters whose projection weights (expert stacks included)
    are quantized from the start: int8 or fp8 payloads uniform over the int8
    range, per-output-channel scales ``fan_in ** -0.5 / 64`` (the JAX
    package's constants, so that the dequantized weights have about the
    fan-in init's size), the router, embedding and norms in ``dtype``. With
    ``quantize_lm_head`` an untied head is an int8/fp8 payload too.

    Nothing is ever materialized in full precision: the payloads are drawn
    on ``device`` from ``generator`` (which must live there) a layer at a
    time. The values are
    random, and the JAX package's draw is not reproduced (its keys are not
    torch's); decode speed does not depend on them."""
    if weights not in ("int8", "fp8"):
        raise ValueError(f"init_quantized_params: weights must be int8 or fp8, got {weights!r}")
    spec.validate()
    dev = _generator_device(generator, device)
    h, i, l = spec.hidden_size, spec.intermediate_size, spec.num_layers
    qd, kvd = spec.q_dim, spec.kv_dim
    gated = spec.activation in ("swiglu", "geglu")
    E = spec.num_experts

    def qweight(kin, kout, experts=0):
        lead = (l, experts) if experts else (l,)
        scale = torch.full(lead + (kout,), (kin ** -0.5) / 64.0, dtype=torch.float32,
                           device=dev)
        return QTensor(_draw_payload(lead + (kin, kout), weights, generator, dev), scale,
                       weights)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def zeros(shape, cond):
        return torch.zeros(shape, dtype=dtype, device=dev) if cond else None

    layernorm = spec.norm == "layernorm"
    blocks = {
        "ln1_scale": torch.ones((l, h), dtype=dtype, device=dev),
        "ln1_bias": zeros((l, h), layernorm),
        "wq": qweight(h, qd), "bq": zeros((l, qd), spec.use_qkv_bias),
        "wk": qweight(h, kvd), "bk": zeros((l, kvd), spec.use_qkv_bias),
        "wv": qweight(h, kvd), "bv": zeros((l, kvd), spec.use_qkv_bias),
        "wo": qweight(qd, h), "bo": zeros((l, h), spec.use_out_bias),
        "ln2_scale": torch.ones((l, h), dtype=dtype, device=dev),
        "ln2_bias": zeros((l, h), layernorm),
    }
    if E:  # sparse MoE: quantized expert stacks and a router in dtype
        blocks.update({
            "w_up": None, "b_up": None, "w_gate": None, "b_gate": None,
            "w_down": None, "b_down": None,
            "router": normal((l, h, E), h ** -0.5),
            "moe_up": qweight(h, i, E),
            "moe_gate": qweight(h, i, E) if gated else None,
            "moe_down": qweight(i, h, E),
        })
    else:
        blocks.update({
            "w_up": qweight(h, i), "b_up": zeros((l, i), spec.use_mlp_bias),
            "w_gate": qweight(h, i) if gated else None,
            "b_gate": zeros((l, i), spec.use_mlp_bias and gated),
            "w_down": qweight(i, h), "b_down": zeros((l, h), spec.use_mlp_bias),
        })
    lm_head = None
    if not spec.tie_embeddings:
        if quantize_lm_head:
            lm_head = QTensor(_draw_payload((h, spec.vocab_size), weights, generator, dev),
                              torch.full((spec.vocab_size,), (h ** -0.5) / 64.0,
                                         dtype=torch.float32, device=dev), weights)
        else:
            lm_head = normal((h, spec.vocab_size), h ** -0.5)
    return {
        "tok_embed": normal((spec.vocab_size, h), 0.02),
        "pos_embed": zeros((spec.max_seq_len, h), spec.positional == "learned"),
        "blocks": blocks,
        "final_scale": torch.ones((h,), dtype=dtype, device=dev),
        "final_bias": zeros((h,), layernorm),
        "lm_head": lm_head,
        "lm_head_bias": zeros((spec.vocab_size,), spec.use_head_bias),
    }


def streamed_quantized_init(spec: ModelSpec, generator: torch.Generator, weights: str = "int8",
                            dtype=torch.bfloat16, *,
                            device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """``quantize_params(init_params(spec, generator, dtype), spec,
    weights)``, equal to it bit for bit from the same generator state, but
    with one full-precision stack alive at a time: each is drawn in
    ``init_params``' order on ``device``, quantized a layer at a
    time and dropped before the next is drawn. Peak memory is the quantized
    tree plus one stack in ``dtype`` and its fp32 draw (90 GB for a
    Mixtral-8x7B expert stack), so the card's Mixtral runs use
    :func:`init_quantized_params`."""
    from mlio_tpu_torch.models.transformer import _init_params

    spec.validate()
    names = QUANTIZABLE + QUANTIZABLE_MOE
    return _init_params(spec, generator, dtype, _generator_device(generator, device),
                        lambda name, w: _quantize_stack(w, weights) if name in names else w)
