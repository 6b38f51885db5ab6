"""Fused LayerNorm / RMSNorm with an optional residual (K2).

Replaces ``mlio_tpu/ops/norms.py::_norm_kernel``. The kernel is CUDA C++ in
``mlio_tpu_torch/csrc/fused_norm.cu``: a memory-bound row reduction that
reads each row once and writes it once, keeping the row in registers between
the fp32 statistics and the normalise pass (see the source's note for the
H100 bound and design). CUDA rather than Triton keeps one build and binding
route for all of the slice's kernels.

On CPU tensors :func:`fused_norm` runs :func:`fused_norm_plain`; on CUDA
tensors it launches the kernel or raises. The kernel takes bf16 only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlio_tpu_torch.ops import _build, cost

_MAX_H = 16384  # the kernel keeps up to 64 fp32 values per thread, 256 threads per row


def fused_norm_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    kind: str = "layernorm",
    eps: float = 1e-5,
    residual: Optional[torch.Tensor] = None,
    residual_alpha: float = 1.0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch.

    Follows ``_norm_kernel``, not ``layernorm_reference``: the residual is
    added after the cast to fp32 (``x + alpha * res`` in fp32), where the
    reference adds it in x's dtype first. Bias applies to either kind.
    """
    xf = x.float()
    if residual is not None:
        xf = xf + residual_alpha * residual.float()
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


def _entry():
    lib = _build.library("fused_norm")
    fn = lib.mlio_fused_norm
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, f, f, p]
        fn.restype = i
    return lib, fn


def norm_work(x, scale, bias=None, *, residual=None, **_):
    """(FLOPs, bytes) for the profiler's count (``ops/cost.py``): no
    products; x, the residual, scale and bias read once, the output written
    once."""
    return 0, cost.tensor_bytes(x, scale, bias, residual) + x.numel() * x.element_size()


@cost.counts(norm_work)
def fused_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    kind: str = "layernorm",
    eps: float = 1e-5,
    residual: Optional[torch.Tensor] = None,
    residual_alpha: float = 1.0,
) -> torch.Tensor:
    """Norm over the last axis, x [..., H] → [..., H] in x's dtype."""
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"fused_norm: unknown kind {kind!r}")
    _build.refuse_grad("fused_norm (K2)", x, scale, bias, residual)
    if x.device.type == "cpu":
        return fused_norm_plain(x, scale, bias, kind=kind, eps=eps, residual=residual,
                                residual_alpha=residual_alpha)
    extra = [t for t in (bias, residual) if t is not None]
    dev = _build.require_cuda("fused_norm", x, scale, *extra)
    H = x.shape[-1]
    if scale.shape != (H,) or (bias is not None and bias.shape != (H,)):
        raise ValueError(f"fused_norm: scale and bias must be [{H}]")
    if residual is not None and residual.shape != x.shape:
        raise ValueError("fused_norm: residual must have x's shape")
    _build.require_bf16("fused_norm", x=x, scale=scale, bias=bias, residual=residual)
    if H % 8 or H > _MAX_H:
        raise ValueError(f"fused_norm: H={H} must be a multiple of 8 and <= {_MAX_H}")
    _build.require_contiguous_aligned("fused_norm", x=x, scale=scale, bias=bias,
                                      residual=residual)
    out = torch.empty_like(x)
    M = x.numel() // H if H else 0
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), residual.data_ptr() if residual is not None else None,
                 scale.data_ptr(), bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), M, H, int(kind == "rmsnorm"), eps, residual_alpha,
                 _build.stream_handle(dev))
    _build.check(lib, err, "fused_norm")
    fused_norm.launches += 1
    return out


fused_norm.launches = 0
