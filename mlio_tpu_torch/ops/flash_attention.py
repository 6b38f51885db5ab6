"""Flash attention forward for prefill (K1, and K10 for long K/V).

Replaces ``mlio_tpu/ops/flash_attention.py::_flash_fwd_kernel``. The kernel
is CUDA C++ in ``mlio_tpu_torch/csrc/flash_fwd.cu``: one block per (64-row
q tile, head, batch), Q/K/V tiles in shared memory, both products on the
tensor cores (wgmma, fp32 accumulate), online softmax in fp32, a kv loop that
stops at the causal frontier and at ``kv_len``. Its source note gives the
H100 bound at the main path's shapes and what the design does about it.

K10 replaces ``_flash_fwd_stream_kernel``, the JAX package's long-context
forward: CUDA C++ in ``mlio_tpu_torch/csrc/flash_stream.cu``, 128-row q
tiles, a producer warp streaming 128-key K/V tiles by TMA into a ring of
shared memory and two consumer warpgroups taking turns at the tensor cores
(``wgmma``), the unmasked interior tiles apart from the masked edge tiles,
the softmax state and O in registers (:func:`flash_attention_stream`; its
plain version is :func:`flash_stream_plain`). :func:`flash_attention` sends
a call to K10 exactly where the JAX package takes its stream kernel
(:func:`stream_route`): the K/V of one head need more than one chunk of
``kv_vmem_budget`` (the JAX package's VMEM budget, 6 MiB, so bf16 K/V at
head dim 128 past 12,288 keys), there is no user mask, no INT8 cache and no
dropout. The threshold is the JAX package's rule, kept so that both packages
run the same kernel at a given shape; it is not a Hopper measurement, and
``PERF.md`` records K1's and K10's times on both sides of it.

``return_stats=True`` also returns the rows' log-sum-exp of the scaled
scores, fp32 [B, Hq, Sq] (-inf for a row with no valid key): K10's lse
instance on its route, K1's (the ``kLse`` instance K13a shares) on K1's.

K9 replaces ``_flash_fwd_kernel_kvq``: the same CUDA kernel instanced for
an INT8 cache (int8 K/V, fp32 per-(token, head) scales), the dequant fused
into both products. :func:`flash_attention` with ``k_scale``/``v_scale``
takes it through :func:`flash_attention_kvq`; its plain version is
:func:`flash_attention_kvq_plain`. As in the JAX package, a full
``[.., Sq, Skv]`` mask and dropout are refused with an INT8 cache.

``dropout_rate``/``dropout_seed`` take K1's dropout instance: the
position-hashed mask of :mod:`~mlio_tpu_torch.ops.dropmask` over (query
position, key position) with the seed folded with (batch, query head), the
kept probabilities scaled by 1/(1 - rate) in the PV product only, as in
``_flash_fwd_kernel``'s dropout branch.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernel or raise. The kernels take bf16 queries and head dims 64
and 128; user masks are not ported yet and raise, as does ``return_stats``
with dropout or an INT8 cache. The kernels have no backward: the wrappers
raise when asked for a gradient (``_build.refuse_grad``); training goes
through ``ops.attention``, whose training-shaped flash route is
:func:`~mlio_tpu_torch.ops.flash_attention_grad.flash_attention_diff`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops.dropmask import dense_keep_mask
from mlio_tpu_torch.ops.reference import attention_mask

_HEAD_DIMS = (64, 128)
# The JAX package's VMEM budget for one head's K and V (flash_attention's
# ``kv_vmem_budget``), read at call time so that a test may move the route.
KV_VMEM_BUDGET = 6 << 20
STREAM_BLOCK_KV = 128  # K10's K/V tile: the block of keys its plain version steps by


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_route(Skv: int, D: int, itemsize: int, *,
                 kv_vmem_budget: Optional[int] = None) -> bool:
    """Whether K/V of ``Skv`` keys, head dim ``D`` and ``itemsize`` bytes an
    element need more than one chunk of the budget: the JAX package's
    ``n_kv_chunks > 1`` (``flash_attention.py:557-559``, ``:592-604``), where
    it takes ``_flash_fwd_stream_kernel`` for a call without mask, INT8 cache
    or dropout (``:634-636``). The chunks are counted in the TPU kernel's
    default K/V tile, 1024 keys once the budget is passed (512 before), as
    the JAX package's callers leave it (its autotune table's entries move no
    call across the rule)."""
    budget = KV_VMEM_BUDGET if kv_vmem_budget is None else kv_vmem_budget
    lanes = _round_up(D, 128)
    needed = 2 * _round_up(Skv, 128) * lanes * itemsize > budget
    bkv = min(1024 if needed else 512, _round_up(Skv, 128))
    padded = _round_up(Skv, bkv)
    return 2 * padded * lanes * itemsize > budget and padded > bkv


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=0,
    return_stats: bool = False,
    kv_vmem_budget: Optional[int] = None,
):
    """:func:`flash_attention`'s function in plain PyTorch, on the route it
    takes: K10's (:func:`flash_stream_plain`) where :func:`stream_route`
    sends the call there, K9's (:func:`flash_attention_kvq_plain`) with
    ``k_scale``/``v_scale``, else K1's, with its rounding: the scale is
    folded into q in fp32 and rounded back to q's dtype, p is rounded to v's
    dtype before the PV product while the row sum uses fp32 p, and a row
    with no valid key gives 0. Under dropout the kept p are scaled by
    1/(1 - rate) before that rounding and the dropped ones are 0."""
    if k_scale is not None:
        return flash_attention_kvq_plain(q, k, v, k_scale, v_scale, causal=causal, scale=scale,
                                         q_offset=q_offset, kv_len=kv_len)
    if dropout_rate == 0.0 and stream_route(k.shape[1], q.shape[3], k.element_size(),
                                            kv_vmem_budget=kv_vmem_budget):
        return flash_stream_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                  kv_len=kv_len, return_stats=return_stats)
    o, lse = flash_plain_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                             kv_len=kv_len, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    return (o, lse) if return_stats else o


def flash_stream_plain(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None,
                       return_stats=False):
    """K10's function in plain PyTorch, over K/V streamed in blocks of
    :data:`STREAM_BLOCK_KV` keys, with ``_flash_fwd_stream_kernel``'s
    rounding: q * scale in fp32 rounded to q's dtype; the online (m, l, acc)
    state in fp32; p rounded to v's dtype for the PV product while l adds
    the fp32 p; o = acc / l, 0 for a row with no valid key; lse = m + log l,
    -inf there. In bf16 the block is part of the function: p is rounded
    against the running max of the blocks seen. The blocks run in ascending
    order: a q tile's unmasked interior blocks are its lower ones and the
    masked edge blocks (the causal diagonal, the kv_len tail) follow them;
    the mask and the -inf guards change no value of an interior block, so
    every block is masked here. A block's scores are [B, Hq, rows, 64] for
    the rows that see one of its keys: no [B, Hq, Sq, Skv] tensor is
    formed. Returns o [B, Sq, Hq, D] in q's dtype, and with
    ``return_stats`` also lse fp32 [B, Hq, Sq]."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    qs = (q.float() * scale).to(q.dtype).float()
    qs = qs.view(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, Sq, D]
    if kv_len is None:
        kvl = torch.full((B,), Skv, dtype=torch.int64, device=dev)
    else:
        kvl = torch.as_tensor(kv_len, device=dev).to(torch.int64).expand(B)
    kvl = kvl.clamp(max=Skv)
    m = torch.full((B, Hkv, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=dev)
    rows = torch.arange(Sq, device=dev) + q_offset  # absolute positions
    tokens = int(kvl.max()) if B else 0
    if causal:
        tokens = min(tokens, q_offset + Sq)
    for j0 in range(0, max(tokens, 0), STREAM_BLOCK_KV):
        r0 = min(max(j0 - q_offset, 0), Sq) if causal else 0  # rows before r0 see no key here
        j1 = j0 + STREAM_BLOCK_KV
        kb = k[:, j0:j1].float().permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, n, D]
        vb = v[:, j0:j1].float().permute(0, 2, 1, 3)[:, :, None]
        cols = torch.arange(j0, j0 + kb.shape[3], device=dev)
        valid = (cols < kvl[:, None])[:, None, :]  # [B, 1, n]
        if causal:
            valid = valid & (rows[r0:, None] >= cols)[None]
        s = (qs[..., r0:, :] @ kb.transpose(-1, -2)).masked_fill(~valid[:, None, None],
                                                                  float("-inf"))
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, s.amax(-1))
        m_safe = torch.where(m_new.isneginf(), 0.0, m_new)
        alpha = torch.where(m_old.isneginf(), 0.0, torch.exp(m_old - m_safe))
        p = torch.exp(s - m_safe[..., None])
        l[..., r0:] = l[..., r0:] * alpha + p.sum(-1)
        acc[..., r0:, :] = acc[..., r0:, :] * alpha[..., None] + p.to(v.dtype).float() @ vb
        m[..., r0:] = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    o = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_stats:
        return o
    lse = torch.where(l == 0, float("-inf"), torch.where(m.isneginf(), 0.0, m) + torch.log(l_safe))
    return o, lse.reshape(B, Hq, Sq)


def scaled_q_and_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """(q * scale rounded to q's dtype, k, v) in fp32, k and v repeated over
    each KV head's group of query heads: what the kernels' products see."""
    group = q.shape[2] // k.shape[2]
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    return qs, kf, vf


def flash_plain_lse(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None,
                    dropout_rate=0.0, dropout_seed=0):
    """:func:`flash_attention_plain` (bf16 K/V) and the rows' log-sum-exp of
    the scaled scores, fp32 [B, Hq, Sq], -inf for a row with no valid key."""
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    qs, kf, vf = scaled_q_and_kv(q, k, v, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    valid = attention_mask(B, Sq, Skv, causal=causal, q_offset=q_offset, kv_len=kv_len,
                           device=q.device)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m.isneginf(), 0.0, m))
    l = p.sum(-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = dense_keep_mask(B, Hq, Sq, Skv, dropout_seed, dropout_rate, q_offset=q_offset,
                               device=q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    l_safe = torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf) / l_safe
    lse = torch.where(m.isneginf(), float("-inf"), m + torch.log(l_safe))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def dropout_args(rate: float, seed) -> tuple:
    """The C entries' dropout arguments: (seed as an int32, rate in fp32,
    1/(1 - rate) in fp32); rate 0 takes the instance without dropout."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {rate}")
    s = int(seed) & 0xFFFFFFFF
    return (s - (1 << 32) if s >= 1 << 31 else s, float(rate),
            1.0 / (1.0 - rate) if rate > 0.0 else 1.0)


def flash_attention_kvq_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
) -> torch.Tensor:
    """K9's function in plain PyTorch, with ``_flash_fwd_kernel_kvq``'s
    rounding: ``q * scale`` rounded to bf16 (whatever q's dtype); the K
    scale on the fp32 score after the product; ``p * v_scale`` rounded to
    bf16 for the PV product while l sums the fp32 p. k/v int8
    [B, Skv, Hkv, D], scales fp32 [B, Skv, Hkv]."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    group = Hq // Hkv
    qs = (q.float() * scale).to(torch.bfloat16).float()
    kf, vf = k.float(), v.float()
    ks, vs = k_scale.float(), v_scale.float()
    if group > 1:
        kf, vf = kf.repeat_interleave(group, dim=2), vf.repeat_interleave(group, dim=2)
        ks, vs = ks.repeat_interleave(group, dim=2), vs.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf) * ks.permute(0, 2, 1)[:, :, None, :]
    valid = attention_mask(B, Sq, Skv, causal=causal, q_offset=q_offset, kv_len=kv_len,
                           device=q.device)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m.isneginf(), 0.0, m))
    l = p.sum(-1, keepdim=True)
    pv = (p * vs.permute(0, 2, 1)[:, :, None, :]).to(torch.bfloat16).float()
    o = torch.einsum("bhqk,bkhd->bhqd", pv, vf)
    o = o / torch.where(l == 0, 1.0, l)
    return o.transpose(1, 2).to(q.dtype)


# C entry points: (library, pointer arguments before the shared tail of
# kv_len_scalar, B, Sq, Skv, Hq, Hkv, D, q_offset, scale, causal, whether
# the dropout arguments follow).
_ENTRIES = {"mlio_flash_fwd": ("flash_fwd", 5, True), "mlio_flash_fwd_kvq": ("flash_fwd", 7, False),
            "mlio_flash_fwd_stats": ("flash_fwd", 6, False),
            "mlio_flash_stream": ("flash_stream", 6, False)}


def _entry(name="mlio_flash_fwd"):
    source, pointers, drop = _ENTRIES[name]
    lib = _build.library(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * pointers + [i] * 8 + [f, i] + [i, f, f] * drop + [p]
        fn.restype = i
    return lib, fn


def _check_shapes(what, q, k, v):
    B, Sq, Hq, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"{what}: k/v must be [B, Skv, Hkv, {D}] alike, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{what}: query heads must be a multiple of KV heads")


def _kv_len_arg(what, kv_len, B, Skv, dev):
    """The kernels' kv_len arguments: (an int32 [B] tensor on ``dev`` or
    None, the scalar used where it is None)."""
    if isinstance(kv_len, torch.Tensor) and kv_len.ndim == 1:
        if kv_len.shape != (B,):
            raise ValueError(f"{what}: kv_len must be an int or [{B}]")
        return kv_len.to(device=dev, dtype=torch.int32).contiguous(), Skv
    return None, Skv if kv_len is None else int(kv_len)


def flash_attention_kvq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over an INT8 cache (K9): q [B, Sq, Hq, D], k/v int8
    [B, Skv, Hkv, D] with fp32 ``k_scale``/``v_scale`` [B, Skv, Hkv] →
    [B, Sq, Hq, D] in q's dtype; ``q_offset`` and ``kv_len`` as
    :func:`flash_attention`."""
    _check_shapes("flash_attention_kvq", q, k, v)
    _build.check_kv_scales("flash_attention_kvq", k, v, k_scale, v_scale)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _build.refuse_grad("flash_attention_kvq (K9)", q, k, v, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_attention_kvq_plain(q, k, v, k_scale, v_scale, causal=causal, scale=scale,
                                         q_offset=q_offset, kv_len=kv_len)
    dev = _build.require_cuda("flash_attention_kvq", q, k, v, k_scale, v_scale)
    _build.require_bf16("flash_attention_kvq", q=q)
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_kvq: head dim {D} not in {_HEAD_DIMS}")
    kv_arr, kv_scalar = _kv_len_arg("flash_attention_kvq", kv_len, B, Skv, dev)
    _build.require_contiguous_aligned("flash_attention_kvq", q=q, k=k, v=v, k_scale=k_scale,
                                      v_scale=v_scale)
    out = torch.empty_like(q)
    lib, fn = _entry("mlio_flash_fwd_kvq")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), out.data_ptr(), _build.ptr(kv_arr), kv_scalar, B, Sq, Skv,
                 Hq, Hkv, D, int(q_offset), D ** -0.5 if scale is None else scale, int(causal),
                 _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention_kvq")
    flash_attention_kvq.launches += 1
    return out


flash_attention_kvq.launches = 0


def flash_attention_stream(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
    return_stats: bool = False,
):
    """K10, the long-context forward: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]
    → [B, Sq, Hq, D] in q's dtype, and with ``return_stats`` also the lse
    fp32 [B, Hq, Sq]; ``q_offset`` and ``kv_len`` as :func:`flash_attention`,
    which sends long K/V here (:func:`stream_route`)."""
    _check_shapes("flash_attention_stream", q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _build.refuse_grad("flash_attention_stream (K10)", q, k, v,
                       hint="ops.attention without kv_len or q_offset, whose backward is K13")
    if q.device.type == "cpu":
        return flash_stream_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                  kv_len=kv_len, return_stats=return_stats)
    dev = _build.require_cuda("flash_attention_stream", q, k, v)
    _build.require_bf16("flash_attention_stream", q=q, k=k, v=v)
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_stream: head dim {D} not in {_HEAD_DIMS}")
    kv_arr, kv_scalar = _kv_len_arg("flash_attention_stream", kv_len, B, Skv, dev)
    _build.require_contiguous_aligned("flash_attention_stream", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev) if return_stats else None
    lib, fn = _entry("mlio_flash_stream")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
                 _build.ptr(kv_arr), kv_scalar, B, Sq, Skv, Hq, Hkv, D, int(q_offset),
                 D ** -0.5 if scale is None else scale, int(causal), _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention_stream")
    flash_attention_stream.launches += 1
    return (out, lse) if return_stats else out


flash_attention_stream.launches = 0


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
    dropout_seed=0,
    return_stats: bool = False,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    kv_vmem_budget: Optional[int] = None,
):
    """Attention forward in the bshd layout: q [B, Sq, Hq, D], k/v
    [B, Skv, Hkv, D] → [B, Sq, Hq, D] in q's dtype.

    ``q_offset``: absolute position of q[:, 0]. ``kv_len``: int or [B];
    cache slots at or past it are masked out. With ``k_scale``/``v_scale``
    [B, Skv, Hkv] (fp32) k/v are an INT8 cache and K9 runs
    (:func:`flash_attention_kvq`). ``dropout_rate``/``dropout_seed``:
    post-softmax dropout (the module's note). ``return_stats``: also return
    the lse fp32 [B, Hq, Sq]. Long K/V go to K10
    (:func:`flash_attention_stream`) by the JAX package's rule
    (:func:`stream_route`, with ``kv_vmem_budget``, by default
    :data:`KV_VMEM_BUDGET`); the rest to K1.
    """
    if k_scale is not None or v_scale is not None:
        if mask is not None and mask.ndim >= 3 and mask.shape[-2] > 1:
            raise NotImplementedError(
                "full [.., Sq, Skv] masks are not supported with an INT8 KV cache; use a "
                "key/padding mask or a bf16 cache")
        if dropout_rate:
            raise NotImplementedError(
                "attention dropout with an INT8 KV cache is not supported (dropout is a "
                "training feature; quantized caches are serving)")
    if mask is not None:
        raise NotImplementedError("flash_attention: user masks are not ported yet")
    if return_stats and (k_scale is not None or v_scale is not None or dropout_rate):
        raise NotImplementedError(
            "flash_attention: return_stats with an INT8 KV cache or dropout is not ported yet")
    if k_scale is not None or v_scale is not None:
        return flash_attention_kvq(q, k, v, k_scale, v_scale, causal=causal, scale=scale,
                                   q_offset=q_offset, kv_len=kv_len)
    _check_shapes("flash_attention", q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if dropout_rate == 0.0 and stream_route(Skv, D, k.element_size(),
                                            kv_vmem_budget=kv_vmem_budget):
        return flash_attention_stream(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                      kv_len=kv_len, return_stats=return_stats)
    drop = dropout_args(dropout_rate, dropout_seed)
    _build.refuse_grad("flash_attention (K1)", q, k, v,
                       hint="ops.attention without kv_len or q_offset, whose backward is K13")
    if q.device.type == "cpu":
        o, lse = flash_plain_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                 kv_len=kv_len, dropout_rate=dropout_rate,
                                 dropout_seed=dropout_seed)
        return (o, lse) if return_stats else o
    dev = _build.require_cuda("flash_attention", q, k, v)
    _build.require_bf16("flash_attention", q=q, k=k, v=v)
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    kv_arr, kv_scalar = _kv_len_arg("flash_attention", kv_len, B, Skv, dev)
    _build.require_contiguous_aligned("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    shape = (kv_scalar, B, Sq, Skv, Hq, Hkv, D, int(q_offset),
             D ** -0.5 if scale is None else scale, int(causal))
    with torch.cuda.device(dev):
        if return_stats:  # K1's kLse instance, the one K13a runs
            lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
            lib, fn = _entry("mlio_flash_fwd_stats")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     _build.ptr(kv_arr), *shape, _build.stream_handle(dev))
        else:
            lib, fn = _entry()
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _build.ptr(kv_arr), *shape, *drop, _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_stats else out


flash_attention.launches = 0
