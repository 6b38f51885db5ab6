"""Op dispatch: one call site per op, the implementation chosen by ``Impl``
(``mlio_tpu/ops/__init__.py``).

``attention`` and ``norm`` route to the hand-written kernels (K1, K10 for
long K/V, or K9 over an INT8 cache; for a training-shaped call K1 or K10
with K13 as its backward; ring attention's chunk walk, on the card one K1
or K10 call; K2) or to the dense references; ``mlp`` to the fused
MLP kernel (K11) or the dense reference, and with quantized weights to the
dequant-fused matmul (K5) for each projection; ``fused_ln_qkv`` to the fused norm+QKV kernel (K12), or
with quantized weights to a norm and K5 three times; ``moe_mlp`` to the
Mixture-of-Experts methods of ``ops/moe.py`` (plain PyTorch products, as the
JAX package leaves them to XLA). ``linear`` is plain
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
from mlio_tpu_torch.ops import moe as _moe
from mlio_tpu_torch.ops import norms as _norms
from mlio_tpu_torch.ops import quant as _quant
from mlio_tpu_torch.ops import ring_attention as _ring
from mlio_tpu_torch.ops.flash_attention_grad import flash_attention_diff, flash_attention_vjp
from mlio_tpu_torch.ops.quant import QTensor, dequantize, dequantize_kv
from mlio_tpu_torch.ops.reference import (
    activate,
    attention_reference,
    layernorm_reference,
    mlp_reference,
    rmsnorm_reference,
)


def attention(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None, mask=None, bias=None,
              k_scale=None, v_scale=None, impl=None, kv_layout="bshd", dropout_rate=0.0,
              dropout_seed=0, return_probs=False):
    """Multi-head attention. q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D] → [B,Sq,Hq,D].
    With ``k_scale``/``v_scale`` [B,Skv,Hkv] k/v are an INT8 cache: K9 on
    the flash route, a dense fp32 dequantize on the dense one.
    ``kv_layout="bhsd"``: k/v (and scales) arrive as [B,Hkv,Skv,D] and
    [B,Hkv,Skv]. ``mask``: a user mask (nonzero = attend; the shapes of
    ``reference.canonicalize_mask``). ``bias``: added to the scores (the
    dense reference only).

    ``Impl(attention="flash")``: a training-shaped call (no mask, no
    ``kv_len``, ``q_offset`` 0, no INT8 cache, the bshd layout: the JAX
    package's condition) goes through :func:`flash_attention_diff`: K1
    forward (K10 for long K/V), K13 backward, so autograd flows through it;
    the rest take K1, K10 or K9, which have no backward.
    ``Impl(attention="ring")``: :func:`~mlio_tpu_torch.ops.ring_attention.
    chunked_ring_attention` with ``impl.ring_chunk``, an INT8 cache
    dequantized to q's dtype first; dropout raises there, and a masked call
    takes the dense reference, as in the JAX package.
    ``dropout_rate``/``dropout_seed``: position-hashed attention dropout
    (``ops/dropmask.py``), the same mask on every path. ``return_probs``
    takes the dense reference on every route and also returns the
    [B,Hq,Sq,Skv] softmax.

    Where the JAX package drops ``bias`` (its flash route, and its ring
    route without a mask) the port raises ``ValueError``; where it returns
    the ring's output alone for ``return_probs`` the port returns the dense
    reference and the probabilities, as the docstring there promises."""
    kind = impl.attention if impl is not None else "dense"
    if kind not in ("dense", "flash", "ring"):
        raise ValueError(f"unknown attention implementation {kind!r}")
    if not return_probs and bias is not None and (kind == "flash"
                                                  or (kind == "ring" and mask is None)):
        raise ValueError(f"attention: bias is not applied on the {kind} route (the JAX "
                         "package drops it there); use Impl(attention='dense')")
    if kind == "flash" and not return_probs:
        if (mask is None and kv_len is None and q_offset == 0 and k_scale is None
                and kv_layout == "bshd"):
            return flash_attention_diff(q, k, v, dropout_seed, causal=causal, scale=scale,
                                        dropout_rate=dropout_rate)
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                      kv_len=kv_len, mask=mask, k_scale=k_scale,
                                      v_scale=v_scale, kv_layout=kv_layout,
                                      dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if kind == "ring" and mask is None and not return_probs:
        if dropout_rate > 0.0:
            raise NotImplementedError(
                "attention dropout is not plumbed through the ring chunk schedule; use the "
                "flash or dense route for dropout")
        if k_scale is not None:
            k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
        return _ring.chunked_ring_attention(q, k, v, causal=causal, scale=scale,
                                            q_offset=q_offset, kv_len=kv_len,
                                            chunk_size=impl.ring_chunk, kv_layout=kv_layout)
    if kv_layout == "bhsd":  # the dense reference takes [B,Skv,Hkv,D]
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if k_scale is not None:
            k_scale, v_scale = k_scale.transpose(1, 2), v_scale.transpose(1, 2)
    return attention_reference(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                               kv_len=kv_len, mask=mask, bias=bias, k_scale=k_scale,
                               v_scale=v_scale, dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed, return_probs=return_probs)


def linear(x, w, bias=None):
    """x @ w (+ bias); w may be a QTensor (K5 for int8 and int4; W8A8, an
    int8 QTensor with ``act_scale``, through ``quant.w8a8_matmul``)."""
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


def moe_mlp(x, w_router, w_gate, w_up, w_down, *, top_k, activation="swiglu", method="ragged",
            capacity_factor=2.0):
    """Mixture-of-Experts MLP by ``method`` ("dense", "ragged" or
    "dispatch"; see ``ops/moe.py``)."""
    return _moe.moe_mlp(x, w_router, w_gate, w_up, w_down, top_k=top_k, activation=activation,
                        method=method, capacity_factor=capacity_factor)


__all__ = [
    "attention",
    "flash_attention_diff",
    "flash_attention_vjp",
    "linear",
    "mlp",
    "moe_mlp",
    "norm",
    "fused_ln_qkv",
    "QTensor",
    "dequantize",
    "attention_reference",
    "mlp_reference",
    "layernorm_reference",
    "rmsnorm_reference",
]
