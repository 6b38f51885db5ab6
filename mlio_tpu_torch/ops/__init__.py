"""Op dispatch: one call site per op, the implementation chosen by ``Impl``
(``mlio_tpu/ops/__init__.py``).

``attention`` and ``norm`` route to the hand-written kernels (K1, K2) or to
the dense references. ``linear`` and ``mlp`` stay plain ``torch.matmul``,
as the JAX package leaves them to XLA; the fused MLP kernel (K11) is not
ported yet. The decode kernels are called through their modules
(``ops.decode_attention`` for K3, ``ops.decode_layer`` for K4), as in the
JAX package, whose ``ops`` exports neither. Importing this package builds
nothing.
"""
from __future__ import annotations

from mlio_tpu_torch.ops import flash_attention as _flash
from mlio_tpu_torch.ops import norms as _norms
from mlio_tpu_torch.ops.reference import (
    attention_reference,
    layernorm_reference,
    mlp_reference,
    rmsnorm_reference,
)


def attention(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None, impl=None):
    """Multi-head attention. q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D] → [B,Sq,Hq,D]."""
    kind = impl.attention if impl is not None else "dense"
    if kind == "flash":
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                      q_offset=q_offset, kv_len=kv_len)
    if kind != "dense":
        raise NotImplementedError(f"attention={kind!r} is not ported yet")
    return attention_reference(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                               kv_len=kv_len)


def linear(x, w, bias=None):
    """x @ w (+ bias)."""
    y = x @ w
    return y if bias is None else y + bias


def mlp(x, w_up, w_down, *, b_up=None, b_down=None, w_gate=None, b_gate=None,
        activation="gelu_new", impl=None):
    """Dense MLP; ``Impl(mlp="fused")`` needs K11, not ported yet."""
    if impl is not None and impl.mlp != "dense":
        raise NotImplementedError(
            f"mlp={impl.mlp!r} needs the fused MLP kernel (K11, "
            "mlio_tpu/ops/fused_mlp.py::_fused_mlp_kernel), not ported yet")
    return mlp_reference(x, w_up, w_down, b_up=b_up, b_down=b_down, w_gate=w_gate,
                         b_gate=b_gate, activation=activation)


def norm(x, scale, bias=None, *, kind="layernorm", eps=1e-5, residual=None, impl=None):
    """LayerNorm or RMSNorm; ``Impl(norm="fused")`` takes the K2 kernel."""
    if impl is not None and impl.norm == "fused":
        return _norms.fused_norm(x, scale, bias, kind=kind, eps=eps, residual=residual)
    if kind == "rmsnorm":
        return rmsnorm_reference(x, scale, eps=eps, residual=residual)
    return layernorm_reference(x, scale, bias, eps=eps, residual=residual)


__all__ = [
    "attention",
    "linear",
    "mlp",
    "norm",
    "attention_reference",
    "mlp_reference",
    "layernorm_reference",
    "rmsnorm_reference",
]
