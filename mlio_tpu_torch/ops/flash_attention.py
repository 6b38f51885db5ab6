"""Flash attention forward for prefill (K1).

Replaces ``mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel``. The kernel
is CUDA C++ in ``mlio_tpu_torch/csrc/flash_fwd.cu``: one block per (64-row
q tile, head, batch), Q/K/V tiles in shared memory, both products on the
tensor cores (WMMA, fp32 accumulate), online softmax in fp32, a kv loop that
stops at the causal frontier and at ``kv_len``. Its source note gives the
H100 bound at the main path's shapes and what the design does about it.

On CPU tensors :func:`flash_attention` runs :func:`flash_attention_plain`;
on CUDA tensors it launches the kernel or raises. The kernel takes bf16 and
head dims 64 and 128; user masks, dropout and the LSE output
(``return_stats``) are not ported yet and raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops.reference import attention_mask

_HEAD_DIMS = (64, 128)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding: the scale is
    folded into q in fp32 and rounded back to q's dtype, p is rounded to v's
    dtype before the PV product while the row sum uses fp32 p, and a row
    with no valid key gives 0."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    group = Hq // Hkv
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    valid = attention_mask(B, Sq, Skv, causal=causal, q_offset=q_offset, kv_len=kv_len,
                           device=q.device)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m.isneginf(), 0.0, m))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf)
    o = o / torch.where(l == 0, 1.0, l)
    return o.transpose(1, 2).to(q.dtype)


def _entry():
    lib = _build.library("flash_fwd")
    fn = lib.mlio_flash_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, p]
        fn.restype = i
    return lib, fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
    mask=None,
    dropout_rate: float = 0.0,
    return_stats: bool = False,
) -> torch.Tensor:
    """Attention forward in the bshd layout: q [B, Sq, Hq, D], k/v
    [B, Skv, Hkv, D] → [B, Sq, Hq, D] in q's dtype.

    ``q_offset``: absolute position of q[:, 0]. ``kv_len``: int or [B];
    cache slots at or past it are masked out.
    """
    if mask is not None or dropout_rate or return_stats:
        raise NotImplementedError(
            "flash_attention: user masks, dropout and return_stats are not "
            "ported yet")
    B, Sq, Hq, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v must be [B, Skv, Hkv, {D}] alike, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError("flash_attention: query heads must be a multiple of KV heads")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len)
    dev = _build.require_cuda("flash_attention", q, k, v)
    _build.require_bf16("flash_attention", q=q, k=k, v=v)
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    kv_ptr, kv_scalar = None, Skv
    if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
        if kv_len.shape != (B,):
            raise ValueError(f"flash_attention: kv_len must be an int or [{B}]")
        kv_len = kv_len.to(device=dev, dtype=torch.int32).contiguous()
        kv_ptr = kv_len.data_ptr()
    elif kv_len is not None:
        kv_scalar = int(kv_len)
    _build.require_contiguous_aligned("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_ptr,
                 kv_scalar, B, Sq, Skv, Hq, Hkv, D, int(q_offset),
                 D ** -0.5 if scale is None else scale, int(causal),
                 _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
