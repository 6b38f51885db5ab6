"""Ring (chunked) attention with the online-softmax merge
(``mlio_tpu/ops/ring_attention.py``).

K/V are walked a chunk at a time and every chunk's scores are folded into a
running (m, l, acc) state, the flash kernels' blockwise recurrence applied
across chunks:

    m'   = max(m, max_j s_j)
    acc' = acc * exp(m - m') + exp(s - m') v
    l'   = l * exp(m - m') + sum_j exp(s_j - m')

:func:`chunk_step` takes a chunk in plain fp32 PyTorch (the CPU path and
the tests' oracle); :func:`chunk_step_flash` runs the chunk's attention
through :func:`~mlio_tpu_torch.ops.flash_attention.flash_attention` with
the lse (K1, or K10 for a chunk past its route threshold, on the card) and
merges (o, lse) as a normalised partial. :func:`chunked_ring_attention` on
CUDA tensors is the single-device fold: every chunk is local and
contiguous, so the whole walk is one ``flash_attention`` call, the call the
flash route makes. The distributed ring (K/V rotating between devices)
would merge with :func:`chunk_step_flash` between its steps; the port has
no sequence-parallel module yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mlio_tpu_torch.ops import flash_attention as _flash

NEG_INF = float("-inf")


def chunk_step(q, k, v, m, l, acc, *, scale: float, q_positions: torch.Tensor,
               k_positions: torch.Tensor, causal: bool, kv_len=None):
    """One (m, l, acc) step against a K/V chunk, in fp32: q [B, Sq, Hq, D]
    (fp32), k/v [B, C, Hkv, D], m/l [B, Hq, Sq, 1], acc [B, Hq, Sq, D];
    ``q_positions`` [Sq] and ``k_positions`` [C] the rows' and keys'
    absolute positions; keys at or past ``kv_len`` (int or [B]) are masked."""
    Hq, Hkv = q.shape[2], k.shape[2]
    group = Hq // Hkv
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale  # [B, Hq, Sq, C]
    mask = None
    if causal:
        mask = (q_positions[:, None] >= k_positions[None, :])[None, None]
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=k_positions.device).reshape(-1, 1)
        valid = (k_positions[None, :] < kvl)[:, None, None, :]  # [B|1, 1, 1, C]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    m_safe = torch.where(m_new.isneginf(), 0.0, m_new)
    alpha = torch.where(m.isneginf(), 0.0, torch.exp(m - m_safe))
    p = torch.exp(s - m_safe)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, vf)
    return m_new, l_new, acc_new


def finalize(m, l, acc, dtype) -> torch.Tensor:
    """(m, l, acc) → the attention output [B, Sq, Hq, D] in ``dtype``; a row
    with no valid key gives 0."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe).transpose(1, 2).to(dtype)


def chunk_step_flash(q, k, v, m, l, acc, *, scale: float, q_offset, k_offset, causal: bool,
                     kv_len=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`chunk_step` for contiguous positions, the chunk's attention
    through ``flash_attention(..., return_stats=True, out_layout="bhsd")``:
    q [B, Sq, Hq, D] at absolute ``q_offset``, the chunk k/v [B, C, Hkv, D]
    at absolute ``k_offset``, ``kv_len`` the absolute count of valid keys
    (int or [B]). The kernel sees the chunk-relative ``q_offset - k_offset``
    (negative for a chunk past the queries) and ``kv_len`` (0 for a chunk
    past the context); a row that sees no key of the chunk has lse -inf and
    the merge leaves it as it was. (o, lse) merge as a normalised partial:
    (m_c, l_c, acc_c) = (lse, 1, o)."""
    C = k.shape[1]
    kv_local = None
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor):
            kv_local = (kv_len - k_offset).clamp(0, C)
        else:
            kv_local = min(max(int(kv_len) - k_offset, 0), C)
    # head-major out: the running state's layout, no relayout a chunk
    o_t, lse = _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                      q_offset=q_offset - k_offset, kv_len=kv_local,
                                      return_stats=True, out_layout="bhsd")
    lse = lse[..., None]  # [B, Hq, Sq, 1]
    o_t = o_t.float()     # [B, Hq, Sq, D]
    m_new = torch.maximum(m, lse)
    m_safe = torch.where(m_new.isneginf(), 0.0, m_new)
    alpha = torch.where(m.isneginf(), 0.0, torch.exp(m - m_safe))
    beta = torch.where(lse.isneginf(), 0.0, torch.exp(lse - m_safe))
    return m_new, l * alpha + beta, acc * alpha + o_t * beta


def init_stats(B: int, Hq: int, Sq: int, D: int, device=None):
    """The empty (m, l, acc): -inf, 0 and 0, fp32."""
    return (torch.full((B, Hq, Sq, 1), NEG_INF, device=device),
            torch.zeros((B, Hq, Sq, 1), device=device),
            torch.zeros((B, Hq, Sq, D), device=device))


def chunked_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, scale: Optional[float] = None, q_offset=0,
                           kv_len=None, chunk_size: int = 512,
                           use_flash: Optional[bool] = None,
                           kv_layout: str = "bshd") -> torch.Tensor:
    """Single-device chunked attention: q [B, Sq, Hq, D], k/v [B, Skv, Hkv,
    D] (``kv_layout="bhsd"``: [B, Hkv, Skv, D]) → [B, Sq, Hq, D] in q's
    dtype, K/V walked ``chunk_size`` keys at a time with the online merge:
    O(Sq x chunk) score memory whatever Skv.

    ``use_flash`` (by default: for CUDA tensors) is the single-device fold:
    one :func:`~mlio_tpu_torch.ops.flash_attention.flash_attention` call
    over the whole K/V (K1 or K10 by its route), which is the chunk loop
    with the carry in the kernel; the JAX package pads K/V to a multiple of
    the chunk first, which changes nothing the kernel computes (``kv_len``
    masks the padding), so the fold takes K/V as they are. Otherwise the
    fp32 :func:`chunk_step` walk over zero-padded chunks."""
    B, Sq, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if use_flash:
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                      kv_len=kv_len, kv_layout=kv_layout)
    k, v = _flash.as_bshd(k, kv_layout), _flash.as_bshd(v, kv_layout)
    Skv = k.shape[1]
    C = min(chunk_size, Skv)
    pad = (-Skv) % C
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_len = Skv if kv_len is None else kv_len  # the padded tail masked by kv_len
    qf = q.float()
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m, l, acc = init_stats(B, Hq, Sq, D, device=q.device)
    for c0 in range(0, Skv + pad, C):
        m, l, acc = chunk_step(qf, k[:, c0:c0 + C], v[:, c0:c0 + C], m, l, acc, scale=scale,
                               q_positions=q_pos,
                               k_positions=torch.arange(c0, c0 + C, device=q.device),
                               causal=causal, kv_len=kv_len)
    return finalize(m, l, acc, q.dtype)


def ring_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: Optional[float] = None, kv_len=None,
                         chunk_size: int = 512) -> torch.Tensor:
    """Cross attention (queries over another sequence's K/V): chunked K/V
    with the exact online merge, no causal mask."""
    return chunked_ring_attention(q, k, v, causal=False, scale=scale, kv_len=kv_len,
                                  chunk_size=chunk_size)


def ring_attention_memory_model(batch, heads, sq, skv, d, world_size, dtype_bytes=2):
    """Per-device K/V bytes: Skv / world_size keys a device, against the
    whole Skv for dense attention."""
    kv_local = 2 * batch * (skv // max(1, world_size)) * heads * d * dtype_bytes
    kv_full = 2 * batch * skv * heads * d * dtype_bytes
    return {"kv_bytes_per_device": kv_local, "kv_bytes_dense": kv_full,
            "savings_factor": world_size}
