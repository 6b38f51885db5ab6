"""Weight quantization of a parameter dict (``mlio_tpu/runtime/quantization.py``).

:func:`quantize_params` replaces the projection weights with
:class:`~mlio_tpu_torch.ops.quant.QTensor` leaves, quantizing each layer's
matrix on its own as the JAX package's ``vmap`` does, and bit for bit as it
does; the forward then takes the dequant-fused matmul (K5) through
``ops.linear``. :func:`fuse_projections` concatenates wq|wk|wv and
w_up|w_gate, and :func:`quantized_size_bytes` counts the bytes.

Not ported yet (ROADMAP.md, queue 1, item 6): ``transcode_fp8_to_int8``,
``init_quantized_params``, ``streamed_quantized_init`` and the W8A8
calibration (``calibrate_activation_scales``, ``apply_activation_scales``).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.utils import get_model_size
from mlio_tpu_torch.ops.quant import QTensor, quantize

QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")


def _quantize_stack(w: torch.Tensor, fmt: str) -> QTensor:
    """Quantize each [K, N] layer of a [L, K, N] stack into preallocated
    outputs, so that one layer's fp32 temporaries are alive at a time."""
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
    """Quantize every projection weight to ``weights`` ∈ {int8, int4, fp8};
    embeddings and norms stay as they are.

    ``donate=True`` consumes ``params``: its ``blocks`` dict loses each
    full-precision stack as that stack's QTensor is built, so the caller
    holds no reference to it and its memory is freed before the next one is
    quantized. With ``quantize_lm_head`` the untied lm_head is quantized too,
    at int8 when the body is int4 (the JAX package's head-precision floor).
    """
    if weights in (None, "none"):
        return params
    if spec.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    out = dict(params)
    blocks = params["blocks"] if donate else dict(params["blocks"])
    for name in QUANTIZABLE:
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


def _concat_weights(ws: Sequence[Any]) -> Any:
    """Concatenate weights (tensors, or QTensors of one format) along the
    output axis, scales with them."""
    ws = [w for w in ws if w is not None]
    if isinstance(ws[0], QTensor):
        if not all(isinstance(w, QTensor) and w.fmt == ws[0].fmt for w in ws):
            raise ValueError("fuse_projections: weights of mixed formats")
        return QTensor(torch.cat([w.q for w in ws], dim=-1),
                       torch.cat([w.scale for w in ws], dim=-1), ws[0].fmt)
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


def quantized_size_bytes(params) -> int:
    """Total parameter bytes, quantized payloads and scales included."""
    return get_model_size(params)["total_bytes"]
