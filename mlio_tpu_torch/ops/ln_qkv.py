"""Fused norm + matmul, and the fused norm + QKV projection on it (K12).

Replaces ``mlio_tpu/ops/ln_qkv.py::_ln_matmul_kernel``. The kernel is CUDA
C++ in ``mlio_tpu_torch/csrc/ln_matmul.cu``: a first launch computes each
row's fp32 statistics (8 bytes a row), then each block normalises each
K-tile of x into shared memory as x's dtype on the way to the tensor cores,
so the normalised activations never go to device memory (see the source's
note for the H100 bound and design).

The function is the JAX kernel's: LayerNorm (two-pass fp32 mean and
variance) or RMSNorm, times the scale, plus the bias when one is given
(for either kind), rounded to x's dtype; then the product with W in fp32,
rounded to x's dtype. :func:`fused_ln_qkv` hands the kernel Wq, Wk and Wv
as they are (the kernel reads each column from its own matrix, so no
concatenated copy is made) and adds the q/k/v biases after the split, in
x's dtype, as the JAX wrapper does.

On CPU tensors :func:`fused_norm_matmul` runs :func:`fused_norm_matmul_plain`;
on CUDA tensors it launches the kernel or raises. The kernel takes bf16 only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mlio_tpu_torch.ops import _build


def _normalize(x, scale, bias, kind, eps):
    xf = x.float()
    if kind == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
    else:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _check(x, ws, scale, bias, kind):
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"fused_norm_matmul: unknown kind {kind!r}")
    H = x.shape[-1]
    for w in ws:
        if w.ndim != 2 or w.shape[0] != H:
            raise ValueError(f"fused_norm_matmul: weights must be [{H}, N], got "
                             f"{tuple(w.shape)}")
    if scale.shape != (H,) or (bias is not None and bias.shape != (H,)):
        raise ValueError(f"fused_norm_matmul: scale and bias must be [{H}]")
    return H


def fused_norm_matmul_plain(x, w, scale, bias=None, *, kind: str = "layernorm",
                            eps: float = 1e-5, parts: Sequence[torch.Tensor] = ()):
    """The kernel's function in plain PyTorch: norm(x) in x's dtype @ W with
    an fp32 sum. W is ``w`` or, when ``w`` is None, the column-wise
    concatenation of ``parts``."""
    ws = [w] if w is not None else list(parts)
    _check(x, ws, scale, bias, kind)
    wf = torch.cat([t.float() for t in ws], dim=1)
    return (_normalize(x, scale, bias, kind, eps).float() @ wf).to(x.dtype)


def _entry():
    lib = _build.library("ln_matmul")
    fn = lib.mlio_ln_matmul
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
        fn.restype = i
    return lib, fn


def fused_norm_matmul(x, w, scale, bias=None, *, kind: str = "layernorm",
                      eps: float = 1e-5, parts: Sequence[torch.Tensor] = ()):
    """norm(x) @ W in one kernel. x [..., H], W [H, N] (``w``, or the
    concatenation of up to three ``parts`` [H, N_i] when ``w`` is None) →
    [..., N] in x's dtype."""
    if x.device.type == "cpu":
        return fused_norm_matmul_plain(x, w, scale, bias, kind=kind, eps=eps, parts=parts)
    ws = [w] if w is not None else list(parts)
    if not 1 <= len(ws) <= 3:
        raise ValueError("fused_norm_matmul: one to three weight parts")
    H = _check(x, ws, scale, bias, kind)
    dev = _build.require_cuda("fused_norm_matmul", x, scale, *ws,
                              *([bias] if bias is not None else []))
    _build.require_bf16("fused_norm_matmul", x=x, scale=scale, bias=bias,
                        **{f"w{i}": t for i, t in enumerate(ws)})
    x2 = x.reshape(-1, H)
    _build.require_contiguous_aligned("fused_norm_matmul", x=x2, scale=scale, bias=bias,
                                      **{f"w{i}": t for i, t in enumerate(ws)})
    widths = [t.shape[1] for t in ws] + [0] * (3 - len(ws))
    ptrs = [t.data_ptr() for t in ws] + [None] * (3 - len(ws))
    N = sum(widths)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    stats = torch.empty((M, 2), dtype=torch.float32, device=dev)  # mean, rstd a row
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
                 *ptrs, stats.data_ptr(), out.data_ptr(), M, H, *widths,
                 int(kind == "rmsnorm"), eps, _build.stream_handle(dev))
    _build.check(lib, err, "fused_norm_matmul")
    fused_norm_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


fused_norm_matmul.launches = 0


def fused_ln_qkv(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, *, kind: str = "layernorm",
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused norm + Q/K/V projections: norm(x) @ [Wq|Wk|Wv] in one K12
    launch, split by widths (GQA), then the biases added in x's dtype."""
    qd, kvd = wq.shape[1], wk.shape[1]
    out = fused_norm_matmul(x, None, ln_scale, ln_bias, kind=kind, eps=eps,
                            parts=(wq, wk, wv))
    q, k, v = out[..., :qd], out[..., qd:qd + kvd], out[..., qd + kvd:]
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    return q, k, v
