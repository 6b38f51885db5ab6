"""Differentiable flash attention: K13 (``mlio_tpu/ops/flash_attention_grad.py``).

Three kernels, CUDA C++ in ``mlio_tpu_torch/csrc/flash_bwd.cu``, each with a
plain PyTorch version and a launch counter:

- K13a :func:`flash_fwd_lse` (``_fwd_lse_kernel``): o and the rows'
  log-sum-exp lse = m + log(l) in fp32 [B, Hq, Sq], -inf for a row with no
  valid key;
- K13b :func:`flash_bwd_dq` (``_bwd_dq_kernel``): dq = scale * dS K with
  dS = P * (dP - delta), P = exp(s - lse), dP = dO V^T (masked and scaled
  under dropout);
- K13c :func:`flash_bwd_dkv` (``_bwd_dkv_kernel``): dV = P~^T dO and
  dK = dS^T (q * scale) per query head, fp32 [B, Skv, Hq, D].

K13a is K1's kernel with the lse store. K13b and K13c run on Hopper's
warpgroup products (``wgmma``) with the scores in registers: dS (and P~) are
rounded to bf16 and repacked as the next product's operands without passing
through shared memory, K13c computing the transposed products (keys as
rows). Their tiles come through ``cp.async`` rings (K13b K and V, K13c q,
dO, lse and delta) into a swizzled layout the tensor cores read directly,
and only the diagonal and ragged tiles are masked. Every output element has
one writer: no atomics, and two runs give the same bits.

The glue stays in plain PyTorch, as it lies outside the Pallas kernels in
the JAX package too: delta = rowsum(dO * O) and the GQA group sum
(:func:`group_sum`). :func:`flash_attention_vjp` is an autograd function
whose forward is K13a; :func:`flash_attention_diff`'s forward is
``flash_attention``'s route (K1, or K10 for long K/V: what inference runs,
as the JAX primal is ``flash_attention`` itself) and its backward recomputes
(o, lse) with K13a before K13b and K13c, as ``flash_attention_diff`` does in
JAX. One autograd function
serves both devices: on CPU tensors every wrapper runs its plain version.
The dropout seed carries no gradient.

The plain versions round where the TPU kernels round: q * scale to q's
dtype; p to v's dtype for PV; dO to v's dtype for dP; dS to k's dtype for dq
and to q's dtype for dk; P~ to dO's dtype for dV; dK and dV summed over the
group in fp32, then cast to k's dtype. The kernels take bf16 and head dims
64 and 128, causal or not, any group size and ragged lengths, the training
shapes only (no ``q_offset``, ``kv_len`` or mask), as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops import flash_attention as _flash
from mlio_tpu_torch.ops.dropmask import dense_keep_mask
from mlio_tpu_torch.ops.flash_attention import dropout_args, scaled_q_and_kv
from mlio_tpu_torch.ops.reference import attention_mask

Tensor = torch.Tensor


def _scale(q: Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_fwd_lse_plain(q, k, v, *, causal=True, scale=None, dropout_rate=0.0, dropout_seed=0):
    """K13a's function in plain PyTorch: (o [B, Sq, Hq, D] in q's dtype,
    lse fp32 [B, Hq, Sq])."""
    return _flash.flash_plain_lse(q, k, v, causal=causal, scale=scale,
                                  dropout_rate=dropout_rate, dropout_seed=dropout_seed)


def _probs(q, k, v, do, lse, causal, scale, dropout_rate, dropout_seed):
    """What both backward kernels recompute, in fp32: (q * scale rounded,
    k and v repeated over the groups, P [B, Hq, Sq, Skv], dP = dO V^T and the
    keep mask or None)."""
    B, Sq, Hq, _ = q.shape
    Skv = k.shape[1]
    qs, kf, vf = scaled_q_and_kv(q, k, v, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    lse_safe = torch.where(lse.isneginf(), 0.0, lse)[..., None]
    p = torch.exp(s - lse_safe)
    valid = attention_mask(B, Sq, Skv, causal=causal, q_offset=0, kv_len=None, device=q.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(v.dtype).float(), vf)
    keep = None
    if dropout_rate > 0.0:
        keep = dense_keep_mask(B, Hq, Sq, Skv, dropout_seed, dropout_rate, device=q.device)
        dp = torch.where(keep, dp, 0.0) * (1.0 / (1.0 - dropout_rate))
    return qs, kf, p, dp, keep


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True, scale=None, dropout_rate=0.0,
                       dropout_seed=0):
    """K13b's function in plain PyTorch: dq [B, Sq, Hq, D] in q's dtype from
    dO (``do``) [B, Sq, Hq, D] and lse, delta fp32 [B, Hq, Sq]."""
    scale = _scale(q, scale)
    _, kf, p, dp, _ = _probs(q, k, v, do, lse, causal, scale, dropout_rate, dropout_seed)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True, scale=None, dropout_rate=0.0,
                        dropout_seed=0):
    """K13c's function in plain PyTorch: (dk, dv) per query head, fp32
    [B, Skv, Hq, D]."""
    scale = _scale(q, scale)
    qs, _, p, dp, keep = _probs(q, k, v, do, lse, causal, scale, dropout_rate, dropout_seed)
    pt = p if keep is None else torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    dv = torch.einsum("bhqk,bqhd->bkhd", pt.to(do.dtype).float(), do.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs)
    return dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_ENTRIES = {  # entry point: pointer arguments before the shared int/float tail
    "mlio_flash_fwd_lse": 5, "mlio_flash_bwd_dq": 7, "mlio_flash_bwd_dkv": 8}


def _entry(name: str):
    lib = _build.library("flash_bwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * _ENTRIES[name] + [i] * 6 + [f, i, i, f, f, p]
        fn.restype = i
    return lib, fn


def _check(what, q, k, v, *more):
    """The kernels' limits on a CUDA call; returns the device."""
    _flash._check_shapes(what, q, k, v)
    dev = _build.require_cuda(what, q, k, v, *more)
    _build.require_bf16(what, q=q, k=k, v=v)
    if q.shape[-1] not in _flash._HEAD_DIMS:
        raise _flash.head_dim_error(what, q.shape[-1])
    return dev


def _tail(q, k, causal, scale, dropout_rate, dropout_seed, dev):
    B, Sq, Hq, D = q.shape
    return (B, Sq, k.shape[1], Hq, k.shape[2], D, _scale(q, scale), int(causal),
            *dropout_args(dropout_rate, dropout_seed), _build.stream_handle(dev))


def flash_fwd_lse(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  scale: Optional[float] = None, dropout_rate: float = 0.0,
                  dropout_seed=0) -> Tuple[Tensor, Tensor]:
    """K13a: (o [B, Sq, Hq, D] in q's dtype, lse fp32 [B, Hq, Sq]) of
    q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]."""
    _build.refuse_grad("flash_fwd_lse (K13a)", q, k, v, hint="use flash_attention_vjp")
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, causal=causal, scale=scale,
                                   dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    dev = _check("flash_fwd_lse", q, k, v)
    _build.require_contiguous_aligned("flash_fwd_lse", q=q, k=k, v=v)
    B, Sq, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    lib, fn = _entry("mlio_flash_fwd_lse")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 *_tail(q, k, causal, scale, dropout_rate, dropout_seed, dev))
    _build.check(lib, err, "flash_fwd_lse")
    flash_fwd_lse.launches += 1
    return out, lse


flash_fwd_lse.launches = 0


def _bwd_inputs(what, q, k, v, do, lse, delta):
    dev = _check(what, q, k, v, do, lse, delta)
    B, Sq, Hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: dO must be {q.dtype} {tuple(q.shape)}")
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {arg} must be fp32 [{B}, {Hq}, {Sq}]")
    _build.require_contiguous_aligned(what, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    return dev


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor, *,
                 causal: bool = True, scale: Optional[float] = None, dropout_rate: float = 0.0,
                 dropout_seed=0) -> Tensor:
    """K13b: dq [B, Sq, Hq, D] in q's dtype."""
    _build.refuse_grad("flash_bwd_dq (K13b)", q, k, v, do, hint="double backward is not ported")
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dev = _bwd_inputs("flash_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.zeros_like(q) if k.shape[1] == 0 else torch.empty_like(q)
    lib, fn = _entry("mlio_flash_bwd_dq")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), *_tail(q, k, dev=dev, **kw))
    _build.check(lib, err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor, delta: Tensor, *,
                  causal: bool = True, scale: Optional[float] = None, dropout_rate: float = 0.0,
                  dropout_seed=0) -> Tuple[Tensor, Tensor]:
    """K13c: (dk, dv) per query head, fp32 [B, Skv, Hq, D]."""
    _build.refuse_grad("flash_bwd_dkv (K13c)", q, k, v, do, hint="double backward is not ported")
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    dev = _bwd_inputs("flash_bwd_dkv", q, k, v, do, lse, delta)
    B, Sq, Hq, D = q.shape
    dk = torch.empty((B, k.shape[1], Hq, D), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    lib, fn = _entry("mlio_flash_bwd_dkv")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_tail(q, k, dev=dev, **kw))
    _build.check(lib, err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# The glue and the autograd functions
# ---------------------------------------------------------------------------

def group_sum(t: Tensor, num_kv_heads: int) -> Tensor:
    """Per-query-head [B, S, Hq, D] fp32 → [B, S, Hkv, D]: the sum over each
    KV head's group of query heads (``_vjp_bwd``'s reshape-sum, :414-416)."""
    B, S, Hq, D = t.shape
    return t.view(B, S, num_kv_heads, Hq // num_kv_heads, D).sum(3)


def attention_backward(q, k, v, o, lse, do, *, causal=True, scale=None, dropout_rate=0.0,
                       dropout_seed=0):
    """(dq, dk, dv) from the forward's (o, lse) and dO: delta, K13b, K13c
    and the group sum (``_vjp_bwd``, :320-430)."""
    kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()  # [B, Hq, Sq]
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    Hkv = k.shape[2]
    return dq, group_sum(dk, Hkv).to(k.dtype), group_sum(dv, Hkv).to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward ``flash_attention``'s route (``recompute``: K1, or K10 for long
    K/V) or K13a; backward K13a (when recomputing),
    K13b, K13c and the glue. Wrappers are looked up at call time, so a
    caller may swap a module's wrapper for its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, seed, causal, scale, dropout_rate, recompute):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kw = dict(causal=causal, scale=scale, dropout_rate=dropout_rate, dropout_seed=seed)
        if recompute:
            out = _flash.flash_attention(q, k, v, **kw)
            ctx.save_for_backward(q, k, v)
        else:
            out, lse = flash_fwd_lse(q, k, v, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if len(saved) == 3:
            q, k, v = saved
            o, lse = flash_fwd_lse(q, k, v, **ctx.kw)
        else:
            q, k, v, o, lse = saved
        dq, dk, dv = attention_backward(q, k, v, o, lse, g, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def _seed(dropout_seed) -> int:
    return int(dropout_seed.item() if isinstance(dropout_seed, torch.Tensor) else dropout_seed)


def flash_attention_vjp(q: Tensor, k: Tensor, v: Tensor, dropout_seed=0, *, causal: bool = True,
                        scale: Optional[float] = None, dropout_rate: float = 0.0) -> Tensor:
    """Differentiable flash attention whose forward is K13a: q [B, Sq, Hq, D],
    k/v [B, Skv, Hkv, D] → [B, Sq, Hq, D]. ``dropout_rate``/``dropout_seed``:
    the position-hashed dropout, forward and backward regenerating one mask;
    the seed carries no gradient."""
    return _FlashAttention.apply(q, k, v, _seed(dropout_seed), causal, scale, dropout_rate,
                                 False)


def flash_attention_diff(q: Tensor, k: Tensor, v: Tensor, dropout_seed=0, *, causal: bool = True,
                         scale: Optional[float] = None, dropout_rate: float = 0.0) -> Tensor:
    """Differentiable flash attention whose forward is ``flash_attention``'s
    route (K1, or K10 for long K/V), so wrapping costs inference nothing; the
    backward recomputes (o, lse) with K13a, then runs K13b and K13c.
    ``ops.attention``'s training-shaped flash route."""
    return _FlashAttention.apply(q, k, v, _seed(dropout_seed), causal, scale, dropout_rate,
                                 True)
