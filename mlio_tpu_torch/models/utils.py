"""Model utilities: size and FLOP accounting, summaries, precision, partial
load (``mlio_tpu/models/utils.py``).

Parameter trees are the port's nested dicts of tensors with
:class:`~mlio_tpu_torch.ops.quant.QTensor` leaves. Paths name dict keys
joined by "/", and a QTensor's fields by their index (``q`` 0, ``scale`` 1,
``act_scale`` 2), as the JAX package's pytree paths name them. dtype names
are the JAX package's (``"bfloat16"``, not ``"torch.bfloat16"``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops.quant import QTensor


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in the tree, in order; None skipped."""
    if tree is None:
        return
    if isinstance(tree, QTensor):
        for i, t in enumerate((tree.q, tree.scale, tree.act_scale)):
            if t is not None:
                yield f"{prefix}/{i}" if prefix else str(i), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree
    else:
        raise TypeError(f"unexpected parameter leaf {type(tree)} at {prefix!r}")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def get_model_size(params) -> Dict[str, Any]:
    """Parameter count and bytes, in all and by dtype."""
    count, total_bytes = 0, 0
    by_dtype: Dict[str, int] = {}
    for _, t in _leaves(params):
        b = t.numel() * t.element_size()
        count += t.numel()
        total_bytes += b
        by_dtype[_dtype_name(t.dtype)] = by_dtype.get(_dtype_name(t.dtype), 0) + b
    return {"num_params": count, "total_bytes": total_bytes, "bytes_by_dtype": by_dtype,
            "total_gb": total_bytes / 1e9}


def find_params(params, predicate: Callable[[str], bool]) -> Dict[str, Any]:
    """The tensors whose path satisfies ``predicate``."""
    return {name: t for name, t in _leaves(params) if predicate(name)}


def get_attention_params(params) -> Dict[str, Any]:
    return find_params(params, lambda n: any(
        k in n for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo")))


def get_mlp_params(params) -> Dict[str, Any]:
    return find_params(params, lambda n: any(
        k in n for k in ("w_up", "w_down", "w_gate", "b_up", "b_down")))


def convert_precision(params, dtype: torch.dtype) -> Any:
    """Cast every floating tensor to ``dtype``; a QTensor stays whole (its
    payload and its fp32 scales). Tensors already in ``dtype`` are kept, not
    copied."""
    if params is None or isinstance(params, QTensor):
        return params
    if isinstance(params, dict):
        return {k: convert_precision(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def theoretical_flops(spec: ModelSpec, batch: int, seq_len: int,
                      *, decode: bool = False) -> Dict[str, float]:
    """Analytic FLOPs of a forward (or of one decode step at context
    ``seq_len``)."""
    h, i, L = spec.hidden_size, spec.intermediate_size, spec.num_layers
    tokens = batch * (1 if decode else seq_len)
    ctx = seq_len
    proj = 2 * tokens * h * (spec.q_dim + 2 * spec.kv_dim + spec.q_dim)
    attn = 4 * tokens * ctx * spec.q_dim * (0.5 if not decode else 1.0)
    mlp = 2 * tokens * h * i * (3 if spec.activation == "swiglu" else 2)
    head = 2 * tokens * h * spec.vocab_size
    total = L * (proj + attn + mlp) + head
    return {"projection_flops": L * proj, "attention_flops": L * attn,
            "mlp_flops": L * mlp, "lm_head_flops": head, "total_flops": total}


def count_macs(spec: ModelSpec, batch: int, seq_len: int) -> float:
    return theoretical_flops(spec, batch, seq_len)["total_flops"] / 2


def model_summary(spec: ModelSpec, params=None) -> str:
    lines = [
        f"Model: {spec.name}",
        f"  layers={spec.num_layers} hidden={spec.hidden_size} "
        f"heads={spec.num_heads} kv_heads={spec.num_kv_heads} "
        f"head_dim={spec.head_size}",
        f"  intermediate={spec.intermediate_size} act={spec.activation} "
        f"norm={spec.norm} pos={spec.positional}",
        f"  vocab={spec.vocab_size} max_seq={spec.max_seq_len} "
        f"params≈{spec.num_params() / 1e6:.1f}M",
    ]
    if params is not None:
        size = get_model_size(params)
        lines.append(f"  materialized: {size['num_params'] / 1e6:.1f}M params, "
                     f"{size['total_gb']:.2f} GB "
                     f"({', '.join(f'{k}:{v/1e6:.0f}MB' for k, v in size['bytes_by_dtype'].items())})")
    return "\n".join(lines)


def load_partial_state(params, updates: Dict[str, Any],
                       strict: bool = False) -> Tuple[Any, List[str], List[str]]:
    """Load ``updates`` (path → array or tensor) into a copy of ``params``,
    each cast to its leaf's dtype and device. Returns (new params, loaded
    paths, missing paths): a shape mismatch is missing (or, with
    ``strict``, raises), as is an unknown path."""
    loaded, missing = [], []

    def walk(tree, prefix):
        if tree is None:
            return None
        if isinstance(tree, QTensor):
            fields = [walk(t, f"{prefix}/{i}") for i, t in
                      enumerate((tree.q, tree.scale, tree.act_scale))]
            return QTensor(fields[0], fields[1], tree.fmt, fields[2])
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if prefix not in updates:
            return tree
        new = torch.as_tensor(updates[prefix])
        if tuple(new.shape) != tuple(tree.shape):
            if strict:
                raise ValueError(f"shape mismatch for {prefix}: {tuple(new.shape)} vs "
                                 f"{tuple(tree.shape)}")
            missing.append(prefix)
            return tree
        loaded.append(prefix)
        return new.to(device=tree.device, dtype=tree.dtype)

    new_params = walk(params, "")
    unknown = [k for k in updates if k not in loaded and k not in missing]
    if strict and unknown:
        raise ValueError(f"unknown parameter paths: {unknown}")
    return new_params, loaded, missing + unknown
