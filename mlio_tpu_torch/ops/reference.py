"""Plain PyTorch references of the optimized ops (``mlio_tpu/ops/reference.py``).

Dense, fp32-internal versions that the kernels' plain twins and the tests
are held against. Shapes follow the JAX package, head dim last:
q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], Hkv dividing Hq (GQA/MQA).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from mlio_tpu_torch.ops.dropmask import dense_keep_mask


def attention_mask(B: int, Sq: int, Skv: int, *, causal: bool, q_offset: int,
                   kv_len: Union[None, int, torch.Tensor],
                   device: torch.device) -> Optional[torch.Tensor]:
    """Boolean [B|1, 1, Sq, Skv] mask (True = attend) from causality (query i
    sits at absolute position i + q_offset) and ``kv_len`` (int or [B]);
    None when nothing is masked."""
    mask = None
    if causal:
        q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
        mask = (q_pos >= torch.arange(Skv, device=device)[None, :])[None, None]
    if kv_len is not None:
        cols = torch.arange(Skv, device=device)
        if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
            valid = (cols[None, :] < kv_len.to(device)[:, None])[:, None, None, :]
        else:
            valid = (cols < int(kv_len))[None, None, None, :]
        mask = valid if mask is None else mask & valid
    return mask


def canonicalize_mask(mask, B: int, Hq: int, Sq: int, Skv: int):
    """A user attention mask (nonzero = attend) in canonical form, as
    ``mlio_tpu/ops/flash_attention.py::canonicalize_mask`` gives it:

      [B, Skv] or [B, 1, Skv]      a key (padding) mask → ("key", [B, Skv] int8)
      [B, Sq, Skv]                 a per-query mask      → ("full", [B, 1, Sq, Skv] int8)
      [B, 1 or Hq, Sq, Skv]        a per-head mask       → ("full", [B, Hm, Sq, Skv] int8)

    Any other shape or rank raises ``ValueError``. An int8 mask comes back
    as itself (a view), so canonicalizing twice copies nothing."""
    m = torch.as_tensor(mask)
    if m.ndim == 2:
        if tuple(m.shape) != (B, Skv):
            raise ValueError(f"2D mask must be [batch, kv_len]; got {tuple(m.shape)} for "
                             f"B={B}, Skv={Skv}")
        return "key", m.to(torch.int8)
    if m.ndim == 3:
        if m.shape[1] == 1 and tuple(m.shape) == (B, 1, Skv):
            return "key", m[:, 0].to(torch.int8)
        if tuple(m.shape) != (B, Sq, Skv):
            raise ValueError(f"3D mask must be [B, Sq, Skv]; got {tuple(m.shape)}")
        return "full", m[:, None].to(torch.int8)
    if m.ndim == 4:
        if m.shape[0] != B or m.shape[1] not in (1, Hq) or tuple(m.shape[2:]) != (Sq, Skv):
            raise ValueError(f"4D mask must be [B, 1|Hq, Sq, Skv]; got {tuple(m.shape)}")
        return "full", m.to(torch.int8)
    raise ValueError(f"unsupported mask rank {m.ndim}")


def user_mask(mask, B: int, Hq: int, Sq: int, Skv: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """The user mask as a boolean [B, 1 or Hq, 1 or Sq, Skv] (True =
    attend), or None without one."""
    if mask is None:
        return None
    kind, m = canonicalize_mask(mask, B, Hq, Sq, Skv)
    return (m[:, None, None, :] if kind == "key" else m).to(device) != 0


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len=None,
    mask=None,
    bias=None,
    k_scale=None,
    v_scale=None,
    dropout_rate: float = 0.0,
    dropout_seed=0,
    return_probs: bool = False,
):
    """Dense softmax attention with GQA, causal and KV-length masking.

    Computation in fp32, output in q's dtype; rows with no valid key give 0.
    With ``k_scale``/``v_scale`` [B, Skv, Hkv] the K/V are an INT8 cache,
    dequantized densely in fp32 first. ``dropout_rate``/``dropout_seed``:
    post-softmax dropout over ``dropmask.dense_keep_mask`` (query rows at
    ``q_offset``), the kept probabilities scaled by 1/(1 - rate).
    ``return_probs`` also returns the [B, Hq, Sq, Skv] softmax (before
    dropout). ``mask``: a user mask (nonzero = attend; the shapes of
    :func:`canonicalize_mask`), combined with the causal and ``kv_len``
    masks. ``bias``: added to the masked scores before the softmax
    (broadcast against [B, Hq, Sq, Skv]).
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    group = Hq // Hkv
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    valid = attention_mask(B, Sq, Skv, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, device=q.device)
    um = user_mask(mask, B, Hq, Sq, Skv, q.device)
    if um is not None:
        valid = um if valid is None else valid & um
    if valid is not None:
        scores = scores.masked_fill(~valid, float("-inf"))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(probs.isnan(), 0.0, probs)  # fully masked rows
    pv_probs = probs
    if dropout_rate > 0.0:
        keep = dense_keep_mask(B, Hq, Sq, Skv, dropout_seed, dropout_rate, q_offset=q_offset,
                               device=q.device)
        pv_probs = torch.where(keep, probs, 0.0) / (1.0 - dropout_rate)
    out = torch.einsum("bhqk,bkhd->bqhd", pv_probs, vf).to(q.dtype)
    return (out, probs) if return_probs else out


def activate(u: torch.Tensor, g: Optional[torch.Tensor], activation: str) -> torch.Tensor:
    """The MLP activation of the up projection ``u`` (gated by ``g`` for
    SwiGLU/GeGLU)."""
    if activation == "swiglu":
        return F.silu(g) * u
    if activation == "geglu":
        return F.gelu(g, approximate="tanh") * u
    if activation in ("gelu_new", "gelu_tanh"):
        return F.gelu(u, approximate="tanh")
    if activation == "gelu":
        return F.gelu(u)
    if activation == "relu":
        return F.relu(u)
    raise ValueError(f"unknown activation {activation}")


def mlp_reference(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    b_up: Optional[torch.Tensor] = None,
    b_down: Optional[torch.Tensor] = None,
    w_gate: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,
    activation: str = "gelu_new",
) -> torch.Tensor:
    """Dense MLP: up-proj → activation (→ gate for SwiGLU/GeGLU) → down-proj."""
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    g = None
    if activation in ("swiglu", "geglu"):
        g = x @ w_gate
        if b_gate is not None:
            g = g + b_gate
    out = activate(h, g, activation) @ w_down
    if b_down is not None:
        out = out + b_down
    return out


def layernorm_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    residual: Optional[torch.Tensor] = None,
    residual_alpha: float = 1.0,
) -> torch.Tensor:
    """LayerNorm with optional residual ``LN(x + alpha * residual)``; the
    residual is added in x's dtype, the statistics are fp32."""
    if residual is not None:
        x = x + residual_alpha * residual
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rmsnorm_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    *,
    eps: float = 1e-5,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RMSNorm, fp32 statistics, optional residual added in x's dtype."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)
