"""Op dispatch: one call site per op, the implementation chosen by ``Impl``
(``mlio_tpu/ops/__init__.py``).

``attention`` and ``norm`` route to the hand-written kernels (K1, K2) or to
the dense references; ``mlp`` to the fused MLP kernel (K11) or the dense
reference, and with quantized weights to the dequant-fused matmul (K5) for
each projection; ``fused_ln_qkv`` to the fused norm+QKV kernel (K12), or
with quantized weights to a norm and K5 three times. ``linear`` is plain
``torch.matmul`` for a tensor weight, as the JAX package leaves it to XLA,
and K5 for an int8 or int4 :class:`~mlio_tpu_torch.ops.quant.QTensor`. The
decode kernels are called through their modules (``ops.decode_attention``
for K3, ``ops.decode_layer`` for K4), as in the JAX package, whose ``ops``
exports neither. Importing this package builds nothing.
"""
from __future__ import annotations

from mlio_tpu_torch.ops import flash_attention as _flash
from mlio_tpu_torch.ops import fused_mlp as _fused_mlp
from mlio_tpu_torch.ops import ln_qkv as _ln_qkv
from mlio_tpu_torch.ops import norms as _norms
from mlio_tpu_torch.ops import quant as _quant
from mlio_tpu_torch.ops.quant import QTensor, dequantize
from mlio_tpu_torch.ops.reference import (
    activate,
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
    """x @ w (+ bias); w may be a QTensor (K5 for int8 and int4)."""
    return _quant.linear(x, w, bias)


def mlp(x, w_up, w_down, *, b_up=None, b_down=None, w_gate=None, b_gate=None,
        activation="gelu_new", impl=None):
    """MLP: quantized weights take K5 for each projection with the
    activation in plain PyTorch in the projections' dtype, as the JAX
    package computes it; ``Impl(mlp="fused")`` takes K11; otherwise
    the dense reference."""
    if isinstance(w_up, QTensor):
        h = _quant.linear(x, w_up, b_up)
        g = _quant.linear(x, w_gate, b_gate) if activation in ("swiglu", "geglu") else None
        return _quant.linear(activate(h, g, activation), w_down, b_down)
    kind = impl.mlp if impl is not None else "dense"
    if kind == "fused":
        return _fused_mlp.fused_mlp(x, w_up, w_down, b_up=b_up, b_down=b_down, w_gate=w_gate,
                                    b_gate=b_gate, activation=activation)
    if kind != "dense":
        raise ValueError(f"unknown mlp implementation {kind!r}")
    return mlp_reference(x, w_up, w_down, b_up=b_up, b_down=b_down, w_gate=w_gate,
                         b_gate=b_gate, activation=activation)


def norm(x, scale, bias=None, *, kind="layernorm", eps=1e-5, residual=None, impl=None):
    """LayerNorm or RMSNorm; ``Impl(norm="fused")`` takes the K2 kernel."""
    if impl is not None and impl.norm == "fused":
        return _norms.fused_norm(x, scale, bias, kind=kind, eps=eps, residual=residual)
    if kind == "rmsnorm":
        return rmsnorm_reference(x, scale, eps=eps, residual=residual)
    return layernorm_reference(x, scale, bias, eps=eps, residual=residual)


def fused_ln_qkv(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, *, kind="layernorm", eps=1e-5,
                 impl=None):
    """Norm + Q/K/V projections: K12 for tensor weights; for quantized
    weights the norm once (as ``impl`` picks it), then K5 three times."""
    if isinstance(wq, QTensor):
        h = norm(x, ln_scale, ln_bias, kind=kind, eps=eps, impl=impl)
        return (_quant.linear(h, wq, bq), _quant.linear(h, wk, bk), _quant.linear(h, wv, bv))
    return _ln_qkv.fused_ln_qkv(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, kind=kind,
                                eps=eps)


__all__ = [
    "attention",
    "linear",
    "mlp",
    "norm",
    "fused_ln_qkv",
    "QTensor",
    "dequantize",
    "attention_reference",
    "mlp_reference",
    "layernorm_reference",
    "rmsnorm_reference",
]
