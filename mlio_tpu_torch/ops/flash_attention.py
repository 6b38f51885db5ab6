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
instance on its route, K1's (the ``kLse`` instance K13a shares, with
dropout too) on K1's, K9's over an INT8 cache.

``mask``: a user mask (nonzero = attend; ``_flash_fwd_kernel``'s
``mask_kind`` "key" [B, Skv] or "full" [B, 1|Hq, Sq, Skv], canonicalized by
:func:`~mlio_tpu_torch.ops.reference.canonicalize_mask`). K1 (and K9, key
masks only, as in the JAX package) read the mask's bytes of each tile while
its S product runs and take every tile through the masked path; a masked
call never goes to K10, whatever its length. ``q_layout``, ``kv_layout``
and ``out_layout`` "bhsd" ([B, H, S, D], the scales [B, Hkv, Skv]) reach
K1 and K9 as strides: nothing is relaid. K10 writes either output layout
and relays a bhsd q or K/V (or any other strided view) once.

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
and 128; K1 also takes head dims 80 (Phi-2) and 256 (Gemma), without a
user mask, dropout or the lse (:data:`K1_ONLY_HEAD_DIMS`), which K9, K10
and K13 do not (``ROADMAP.md`` A4). Head dim 256 has a kernel of its own,
``csrc/flash_fwd_d256.cu``: K10's warp-specialised body (a TMA producer
warp, two consumer warpgroups of 64 rows sharing one K/V ring) over 4-D
tensor maps built from each tensor's strides (:func:`tma_map`), its
blocks and tiles mirrored by :func:`d256_blocks` and
:func:`d256_consumer`. The kernels have no backward: the wrappers raise when asked for a
gradient (``_build.refuse_grad``); training goes through ``ops.attention``,
whose training-shaped flash route (no mask) is
:func:`~mlio_tpu_torch.ops.flash_attention_grad.flash_attention_diff`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from mlio_tpu_torch.ops import _build, cost
from mlio_tpu_torch.ops.dropmask import dense_keep_mask
from mlio_tpu_torch.ops.reference import attention_mask, canonicalize_mask, user_mask

_HEAD_DIMS = (64, 128)
# Head dims of K1's instance without a user mask, dropout, lse or INT8 cache
# alone: the prefill of Phi-2 (80) and Gemma (256). K9, K10 and K13 refuse
# them.
K1_ONLY_HEAD_DIMS = (80, 256)
_LAYOUTS = ("bshd", "bhsd")
# The JAX package's VMEM budget for one head's K and V (flash_attention's
# ``kv_vmem_budget``), read at call time so that a test may move the route.
KV_VMEM_BUDGET = 6 << 20
STREAM_BLOCK_KV = 128  # K10's K/V tile: the block of keys its plain version steps by
# K1 at head dim 256 (csrc/flash_fwd_d256.cu): q rows a block (two
# consumers of 64) and keys a K/V tile
D256, D256_BQ, D256_BKV = 256, 128, 64


def head_dim_error(what: str, D: int, runs: str = "") -> ValueError:
    """The error of a kernel call at a head dim its instances do not take;
    ``runs`` names what the head dim's own instance does take, where it has
    one."""
    if runs:
        return ValueError(f"{what}: head dim {D} runs {runs} only (the rest is not built: "
                          "ROADMAP.md A4)")
    return ValueError(f"{what}: head dim {D} not in {_HEAD_DIMS} (other head dims are not "
                      "built: ROADMAP.md A4)")


def k1_instance_error(what: str, D: int, *, quant: bool, lse: bool, dropout: bool,
                      mask: bool) -> Optional[ValueError]:
    """The error of a K1 or K9 call (``quant``: over an INT8 cache) at head
    dim ``D`` with these options where no instance is built, else None."""
    if D in _HEAD_DIMS:
        return None
    if D not in K1_ONLY_HEAD_DIMS or quant:
        return head_dim_error(what, D)
    if lse or dropout or mask:
        return head_dim_error(what, D, "without a user mask, the lse or dropout")
    return None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tma_map(t: torch.Tensor, layout: str, box_rows: int, what: str = "flash_attention",
            arg: str = "q") -> tuple:
    """The TMA map of a [B, S, H, D] tensor in ``layout`` ("bshd" or
    "bhsd") as (dims, byte strides, box): a 4-D map [D, S, H, B] (innermost
    first), the byte strides of S, H and B as the tensor has them (a dim of
    size 1 takes D's row bytes: its coordinate is always 0), in boxes of 64
    columns (the 128-byte swizzle's width) and ``box_rows`` rows. Rows past
    S read as zeros, so a box never runs into the next head or sequence.
    Raises ``ValueError`` where TMA would refuse the map: the head dim not
    contiguous or its row not a multiple of 16 bytes, a stride not a
    multiple of 16 bytes or past 2**40, or a start not 16-byte aligned."""
    B, S, H, D = as_bshd(t, layout).shape
    esz, row = t.element_size(), D * t.element_size()
    sb, ss, sh = strides(t, layout)
    byte = tuple(x * esz if n > 1 else row for x, n in ((ss, S), (sh, H), (sb, B)))
    if t.stride(-1) != 1 or row % 16 or t.data_ptr() % 16 or any(
            x % 16 or x >= 1 << 40 for x in byte):
        raise ValueError(f"{what}: {arg} breaks TMA's rules at head dim {D} (a contiguous head "
                         "dim, byte strides that are multiples of 16 below 2**40, a 16-byte "
                         f"aligned start); got strides {t.stride()}")
    return (D, S, H, B), byte, (64, box_rows, 1, 1)


def d256_blocks(B: int, Sq: int, Hq: int, Hkv: int, sms: int = 132) -> list:
    """K1's blocks at head dim 256 in launch order, as (b, h, q_start): the
    (batch, KV head) pairs in groups of about as many blocks as the card
    has SMs (``sms``, the H100 SXM's 132), a group's 128-row q tiles from
    the last (the heaviest under causality) to the first, its pairs next,
    the G query heads of a KV head fastest: the blocks on the card at once
    share their K/V rows in L2, and each tile of a pair is read by blocks
    that run apart. Mirrors csrc/flash_fwd_d256.cu's block map."""
    n_qt, G = -(-Sq // D256_BQ), Hq // Hkv
    group, npairs = max(1, sms // (G * n_qt)), B * Hkv
    out = []
    for first in range(0, npairs, group):
        pairs = range(first, min(first + group, npairs))
        out += [(p // Hkv, p % Hkv * G + g, qt * D256_BQ) for qt in reversed(range(n_qt))
                for p in pairs for g in range(G)]
    return out


def d256_consumer(row0: int, Sq: int, kvl: int, causal: bool, q_offset: int):
    """(n, n_full) of the consumer of q rows [row0, row0 + 64) at head dim
    256: the 64-key tiles it computes (those below kvl and, under
    causality, holding a key at or below its last row + q_offset) and the
    interior ones among them, which take no mask (every key at or below its
    first row + q_offset and below kvl); None where it has no row below Sq
    (it then computes and stores nothing). kvl is min(kv_len, Skv). Mirrors
    csrc/flash_fwd_d256.cu's consumer_tiles and consume."""
    rows = min(64, Sq - row0)
    if rows <= 0:
        return None
    tokens = min(kvl, row0 + rows + q_offset) if causal else kvl
    n = -(-tokens // D256_BKV) if tokens > 0 else 0
    first = row0 + q_offset
    n_full = (first // D256_BKV if first > 0 else 0) if causal else n
    return n, min(n_full, kvl // D256_BKV, n)


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


def _dims(q: torch.Tensor, k: torch.Tensor, q_layout: str, kv_layout: str):
    """(B, Sq, Hq, D, Skv, Hkv) of q and k in their layouts ("bshd", or
    "bhsd": [B, H, S, D])."""
    for name, layout in (("q_layout", q_layout), ("kv_layout", kv_layout)):
        if layout not in _LAYOUTS:
            raise ValueError(f"flash_attention: {name} must be one of {_LAYOUTS}, got {layout!r}")
    B, Sq, Hq, D = as_bshd(q, q_layout).shape
    _, Skv, Hkv, _ = as_bshd(k, kv_layout).shape
    return B, Sq, Hq, D, Skv, Hkv


def as_bshd(t, layout: str):
    """A [B, S, H, D] view of a tensor in ``layout``; a scale [B, H, S] in
    "bhsd" becomes a [B, S, H] view. None stays None. Nothing is copied."""
    return t.transpose(1, 2) if t is not None and layout == "bhsd" else t


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Union[None, int, torch.Tensor] = None,
    mask=None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed=0,
    return_stats: bool = False,
    kv_vmem_budget: Optional[int] = None,
    q_layout: str = "bshd",
    kv_layout: str = "bshd",
    out_layout: str = "bshd",
):
    """:func:`flash_attention`'s function in plain PyTorch, on the route it
    takes: K10's (:func:`flash_stream_plain`) where :func:`stream_route`
    sends the call there, K9's (:func:`flash_attention_kvq_plain`) with
    ``k_scale``/``v_scale``, else K1's, with its rounding: the scale is
    folded into q in fp32 and rounded back to q's dtype, p is rounded to v's
    dtype before the PV product while the row sum uses fp32 p, and a row
    with no valid key gives 0. Under dropout the kept p are scaled by
    1/(1 - rate) before that rounding and the dropped ones are 0."""
    lay = dict(q_layout=q_layout, kv_layout=kv_layout, out_layout=out_layout)
    if k_scale is not None:
        return flash_attention_kvq_plain(q, k, v, k_scale, v_scale, causal=causal, scale=scale,
                                         q_offset=q_offset, kv_len=kv_len, mask=mask,
                                         return_stats=return_stats, **lay)
    B, Sq, Hq, D, Skv, Hkv = _dims(q, k, q_layout, kv_layout)
    if mask is None and dropout_rate == 0.0 and stream_route(Skv, D, k.element_size(),
                                                             kv_vmem_budget=kv_vmem_budget):
        return flash_stream_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                  kv_len=kv_len, return_stats=return_stats, **lay)
    o, lse = flash_plain_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                             kv_len=kv_len, mask=mask, dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed, **lay)
    return (o, lse) if return_stats else o


def flash_stream_plain(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None,
                       return_stats=False, q_layout="bshd", kv_layout="bshd", out_layout="bshd"):
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
    formed. Returns o [B, Sq, Hq, D] in q's dtype (in ``out_layout``), and
    with ``return_stats`` also lse fp32 [B, Hq, Sq]."""
    q, k, v = as_bshd(q, q_layout), as_bshd(k, kv_layout), as_bshd(v, kv_layout)
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
    o = as_bshd(o, out_layout)
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


def valid_mask(B, Hq, Sq, Skv, *, causal, q_offset, kv_len, mask, device):
    """The boolean mask (True = attend) of causality, ``kv_len`` and the
    user mask together, broadcast against [B, Hq, Sq, Skv]; None when
    nothing is masked. The plain versions apply it; it is also the
    ``attn_mask`` a library call of the same function takes."""
    valid = attention_mask(B, Sq, Skv, causal=causal, q_offset=q_offset, kv_len=kv_len,
                           device=device)
    um = user_mask(mask, B, Hq, Sq, Skv, device)
    if um is not None:
        valid = um if valid is None else valid & um
    return valid


def _lse(m: torch.Tensor, l_safe: torch.Tensor) -> torch.Tensor:
    """m + log(l) of the rows [..., 1], -inf for a row with no valid key."""
    return torch.where(m.isneginf(), float("-inf"), m + torch.log(l_safe))[..., 0]


def flash_plain_lse(q, k, v, *, causal=True, scale=None, q_offset=0, kv_len=None, mask=None,
                    dropout_rate=0.0, dropout_seed=0, q_layout="bshd", kv_layout="bshd",
                    out_layout="bshd"):
    """:func:`flash_attention_plain` on K1's route (bf16 K/V) and the rows'
    log-sum-exp of the scaled scores, fp32 [B, Hq, Sq], -inf for a row with
    no valid key (the user mask included). Under dropout l sums p before
    the drop, as ``_flash_fwd_kernel`` does, so the lse is the undropped
    one."""
    q, k, v = as_bshd(q, q_layout), as_bshd(k, kv_layout), as_bshd(v, kv_layout)
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    qs, kf, vf = scaled_q_and_kv(q, k, v, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    valid = valid_mask(B, Hq, Sq, Skv, causal=causal, q_offset=q_offset, kv_len=kv_len, mask=mask,
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
    return as_bshd(o.transpose(1, 2).to(q.dtype), out_layout), _lse(m, l_safe)


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
    mask=None,
    return_stats: bool = False,
    q_layout: str = "bshd",
    kv_layout: str = "bshd",
    out_layout: str = "bshd",
):
    """K9's function in plain PyTorch, with ``_flash_fwd_kernel_kvq``'s
    rounding: ``q * scale`` rounded to bf16 (whatever q's dtype); the K
    scale on the fp32 score after the product; ``p * v_scale`` rounded to
    bf16 for the PV product while l sums the fp32 p. k/v int8
    [B, Skv, Hkv, D], scales fp32 [B, Skv, Hkv] (in "bhsd" [B, Hkv, Skv, D]
    and [B, Hkv, Skv]). A key mask combines with the causal and ``kv_len``
    masks; ``return_stats`` also gives the lse as :func:`flash_plain_lse`."""
    q = as_bshd(q, q_layout)
    k, v, k_scale, v_scale = (as_bshd(t, kv_layout) for t in (k, v, k_scale, v_scale))
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
    valid = valid_mask(B, Hq, Sq, Skv, causal=causal, q_offset=q_offset, kv_len=kv_len, mask=mask,
                   device=q.device)
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m.isneginf(), 0.0, m))
    l = p.sum(-1, keepdim=True)
    pv = (p * vs.permute(0, 2, 1)[:, :, None, :]).to(torch.bfloat16).float()
    l_safe = torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bhqd", pv, vf) / l_safe
    o = as_bshd(o.transpose(1, 2).to(q.dtype), out_layout)
    return (o, _lse(m, l_safe)) if return_stats else o


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: (library, argument types before the stream). mlio_flash_fwd
# (K1 and K9, every instance): q, k, v, k_scale, v_scale, mask, out, lse,
# kv_len, the host array of 15 strides; kv_len_scalar, B, Sq, Skv, Hq, Hkv,
# D, q_offset; scale; causal; the dropout seed, rate and 1 / (1 - rate).
# mlio_flash_stream (K10): q, k, v, out, lse, kv_len; kv_len_scalar .. causal
# as above; out's batch, row and head strides.
# mlio_flash_fwd_d256 (K1 at head dim 256): q, k, v, out, kv_len, the host
# array of the three maps' 33 values (tma_map's, flattened), out's 3
# strides; kv_len_scalar, B, Sq, Skv, Hq, Hkv, q_offset; scale; causal.
_ENTRIES = {"mlio_flash_fwd": ("flash_fwd", [_P] * 10 + [_I] * 8 + [_F, _I, _I, _F, _F]),
            "mlio_flash_fwd_d256": ("flash_fwd_d256", [_P] * 7 + [_I] * 7 + [_F, _I]),
            "mlio_flash_stream": ("flash_stream", [_P] * 6 + [_I] * 8 + [_F, _I] + [_LL] * 3)}


def _entry(name):
    source, types = _ENTRIES[name]
    lib = _build.library(source)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = types + [_P]
        fn.restype = _I
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


def strides(t: torch.Tensor, layout: str) -> tuple:
    """The (batch, row, head) element strides of a [B, S, H, D] tensor, or
    of a [B, S, H] scale, in ``layout`` ("bhsd": [B, H, S, D] and [B, H, S])."""
    return ((t.stride(0), t.stride(2), t.stride(1)) if layout == "bhsd"
            else (t.stride(0), t.stride(1), t.stride(2)))


def _require_rows(what: str, align: int, **tensors) -> None:
    """Each tensor's head dim contiguous, its other strides (of dims longer
    than 1) multiples of ``align`` elements and its start 16-byte aligned:
    the kernels copy a row's head dim in 16-byte chunks, whatever the
    layout."""
    for arg, t in tensors.items():
        odd = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1 and st % align]
        if t.stride(-1) != 1 or odd or t.data_ptr() % 16:
            raise ValueError(f"{what}: {arg} must have a contiguous head dim, its other strides "
                             f"multiples of {align} elements and a 16-byte aligned start; got "
                             f"strides {t.stride()}")


def _mask_strides(kind: str, m: torch.Tensor) -> tuple:
    """A canonical mask's (batch, row, head) strides: a key mask has no row
    or head stride, a full mask of one head no head stride."""
    if kind == "key":
        return m.stride(0), 0, 0
    return m.stride(0), m.stride(2), m.stride(1) if m.shape[1] > 1 else 0


def _launch(what, q, k, v, k_scale, v_scale, kind, m, *, causal, scale, q_offset, kv_len, drop,
            return_stats, q_layout, kv_layout, out_layout):
    """K1 or K9 (k_scale given) on the card: the instance for the head dim,
    dropout (drop's rate > 0), the lse (return_stats) and an INT8 cache,
    with the user mask m ("key" or "full", canonical) where given. Every
    tensor goes by its strides in its layout: nothing is copied or relaid."""
    B, Sq, Hq, D, Skv, Hkv = _dims(q, k, q_layout, kv_layout)
    quant = k_scale is not None
    dev = _build.require_cuda(what, *(t for t in (q, k, v, k_scale, v_scale, m) if t is not None))
    _build.require_bf16(what, q=q, **({} if quant else dict(k=k, v=v)))
    err = k1_instance_error(what, D, quant=quant, lse=return_stats, dropout=drop[1] > 0.0,
                            mask=m is not None)
    if err is not None:
        raise err
    if k.stride() != v.stride() or (quant and k_scale.stride() != v_scale.stride()):
        raise ValueError(f"{what}: k and v (and their scales) must have the same strides")
    if D == D256:
        return _launch_d256(what, q, k, v, dev, causal=causal, scale=scale, q_offset=q_offset,
                            kv_len=kv_len, q_layout=q_layout, kv_layout=kv_layout,
                            out_layout=out_layout)
    _require_rows(what, 8, q=q)
    _require_rows(what, 16 if quant else 8, k=k, v=v)
    if m is not None and Skv > 1 and m.stride(-1) != 1:
        raise ValueError(f"{what}: the mask's key dim must be contiguous")
    kv_arr, kv_scalar = _kv_len_arg(what, kv_len, B, Skv, dev)
    out = torch.empty((B, Hq, Sq, D) if out_layout == "bhsd" else (B, Sq, Hq, D), dtype=q.dtype,
                      device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev) if return_stats else None
    st = (ctypes.c_longlong * 15)(
        *strides(q, q_layout), *strides(k, kv_layout),
        *(strides(k_scale, kv_layout) if quant else (0, 0, 0)), *strides(out, out_layout),
        *(_mask_strides(kind, m) if m is not None else (0, 0, 0)))
    lib, fn = _entry("mlio_flash_fwd")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scale),
                 _build.ptr(v_scale), _build.ptr(m), out.data_ptr(), _build.ptr(lse),
                 _build.ptr(kv_arr), ctypes.addressof(st), kv_scalar, B, Sq, Skv, Hq, Hkv, D,
                 int(q_offset), D ** -0.5 if scale is None else scale, int(causal), *drop,
                 _build.stream_handle(dev))
    _build.check(lib, err, what)
    return (out, lse) if return_stats else out


def _launch_d256(what, q, k, v, dev, *, causal, scale, q_offset, kv_len, q_layout, kv_layout,
                 out_layout):
    """K1 at head dim 256 (csrc/flash_fwd_d256.cu): q, k and v through their
    TMA maps (tma_map raises on what TMA refuses, before any launch), out
    written by its strides."""
    B, Sq, Hq, D, Skv, Hkv = _dims(q, k, q_layout, kv_layout)
    geo = (ctypes.c_longlong * 33)(*(
        x for t, layout, rows, arg in ((q, q_layout, 64, "q"), (k, kv_layout, D256_BKV, "k"),
                                       (v, kv_layout, D256_BKV, "v"))
        for part in tma_map(t, layout, rows, what, arg) for x in part))
    kv_arr, kv_scalar = _kv_len_arg(what, kv_len, B, Skv, dev)
    out = torch.empty((B, Hq, Sq, D) if out_layout == "bhsd" else (B, Sq, Hq, D), dtype=q.dtype,
                      device=dev)
    out_st = (ctypes.c_longlong * 3)(*strides(out, out_layout))
    lib, fn = _entry("mlio_flash_fwd_d256")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(kv_arr),
                 ctypes.addressof(geo), ctypes.addressof(out_st), kv_scalar, B, Sq, Skv, Hq, Hkv,
                 int(q_offset), D ** -0.5 if scale is None else scale, int(causal),
                 _build.stream_handle(dev))
    _build.check(lib, err, what)
    return out


def _canonical(mask, B, Hq, Sq, Skv):
    return canonicalize_mask(mask, B, Hq, Sq, Skv) if mask is not None else (None, None)


def attention_work(q, k, v, k_scale=None, v_scale=None, *, mask=None, return_stats=False,
                   q_layout="bshd", kv_layout="bshd", **_):
    """(FLOPs, bytes) of an attention call for the profiler's count
    (``ops/cost.py``): the two products over every (query, key) pair, as the
    dense reference computes them; q, k, v, their scales and the mask read
    once, the output (and the lse) written once."""
    B, Sq, Hq, D, Skv, _ = _dims(q, k, q_layout, kv_layout)
    nbytes = cost.tensor_bytes(q, k, v, k_scale, v_scale, mask) + q.numel() * q.element_size()
    return 4 * B * Hq * Sq * Skv * D, nbytes + (4 * B * Hq * Sq if return_stats else 0)


@cost.counts(attention_work)
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
    mask=None,
    return_stats: bool = False,
    q_layout: str = "bshd",
    kv_layout: str = "bshd",
    out_layout: str = "bshd",
):
    """Attention over an INT8 cache (K9): q [B, Sq, Hq, D], k/v int8
    [B, Skv, Hkv, D] with fp32 ``k_scale``/``v_scale`` [B, Skv, Hkv] →
    [B, Sq, Hq, D] in q's dtype; ``q_offset``, ``kv_len``, a key ``mask``,
    ``return_stats`` and the layouts as :func:`flash_attention` (in "bhsd"
    the scales are [B, Hkv, Skv]). A full mask raises, as in the JAX
    package."""
    B, Sq, Hq, D, Skv, Hkv = _dims(q, k, q_layout, kv_layout)
    _check_shapes("flash_attention_kvq", as_bshd(q, q_layout), as_bshd(k, kv_layout),
                  as_bshd(v, kv_layout))
    _build.check_kv_scales("flash_attention_kvq", k, v, k_scale, v_scale)
    kind, m = _canonical(mask, B, Hq, Sq, Skv)
    if kind == "full":
        raise NotImplementedError("full [.., Sq, Skv] masks are not supported with an INT8 KV "
                                  "cache; use a key/padding mask or a bf16 cache")
    _build.refuse_grad("flash_attention_kvq (K9)", q, k, v, k_scale, v_scale)
    lay = dict(q_layout=q_layout, kv_layout=kv_layout, out_layout=out_layout)
    if q.device.type == "cpu":
        return flash_attention_kvq_plain(q, k, v, k_scale, v_scale, causal=causal, scale=scale,
                                         q_offset=q_offset, kv_len=kv_len, mask=m,
                                         return_stats=return_stats, **lay)
    out = _launch("flash_attention_kvq", q, k, v, k_scale, v_scale, kind, m, causal=causal,
                  scale=scale, q_offset=q_offset, kv_len=kv_len, drop=dropout_args(0.0, 0),
                  return_stats=return_stats, **lay)
    flash_attention_kvq.launches += 1
    return out


flash_attention_kvq.launches = 0


@cost.counts(attention_work)
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
    q_layout: str = "bshd",
    kv_layout: str = "bshd",
    out_layout: str = "bshd",
):
    """K10, the long-context forward: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]
    → [B, Sq, Hq, D] in q's dtype, and with ``return_stats`` also the lse
    fp32 [B, Hq, Sq]; ``q_offset``, ``kv_len`` and the layouts as
    :func:`flash_attention`, which sends long K/V here (:func:`stream_route`).
    K10 writes ``out_layout`` itself; it reads q and K/V through TMA maps of
    the bshd layout, so a "bhsd" q or K/V, or any other strided view, is
    relaid (copied) once here."""
    _dims(q, k, q_layout, kv_layout)
    _check_shapes("flash_attention_stream", as_bshd(q, q_layout), as_bshd(k, kv_layout),
                  as_bshd(v, kv_layout))
    _build.refuse_grad("flash_attention_stream (K10)", q, k, v,
                       hint="ops.attention without kv_len or q_offset, whose backward is K13")
    if q.device.type == "cpu":
        return flash_stream_plain(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                  kv_len=kv_len, return_stats=return_stats, q_layout=q_layout,
                                  kv_layout=kv_layout, out_layout=out_layout)
    q = as_bshd(q, q_layout)
    k, v = as_bshd(k, kv_layout), as_bshd(v, kv_layout)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev = _build.require_cuda("flash_attention_stream", q, k, v)
    _build.require_bf16("flash_attention_stream", q=q, k=k, v=v)
    if D not in _HEAD_DIMS:
        raise head_dim_error("flash_attention_stream", D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_arr, kv_scalar = _kv_len_arg("flash_attention_stream", kv_len, B, Skv, dev)
    _build.require_contiguous_aligned("flash_attention_stream", q=q, k=k, v=v)
    out = torch.empty((B, Hq, Sq, D) if out_layout == "bhsd" else (B, Sq, Hq, D), dtype=q.dtype,
                      device=dev)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev) if return_stats else None
    lib, fn = _entry("mlio_flash_stream")
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.ptr(lse),
                 _build.ptr(kv_arr), kv_scalar, B, Sq, Skv, Hq, Hkv, D, int(q_offset),
                 D ** -0.5 if scale is None else scale, int(causal), *strides(out, out_layout),
                 _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention_stream")
    flash_attention_stream.launches += 1
    return (out, lse) if return_stats else out


flash_attention_stream.launches = 0


@cost.counts(attention_work)
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
    q_layout: str = "bshd",
    kv_layout: str = "bshd",
    out_layout: str = "bshd",
):
    """Attention forward: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] →
    [B, Sq, Hq, D] in q's dtype.

    ``q_offset``: absolute position of q[:, 0] (negative puts the queries
    before the keys). ``kv_len``: int or [B]; cache slots at or past it are
    masked out. ``mask``: a user mask (nonzero = attend) of the shapes of
    :func:`~mlio_tpu_torch.ops.reference.canonicalize_mask`, combined with
    the causal and ``kv_len`` masks; on the card it lies on q's device. With
    ``k_scale``/``v_scale`` [B, Skv, Hkv] (fp32) k/v are an INT8 cache and
    K9 runs (:func:`flash_attention_kvq`; a full mask or dropout raises).
    ``dropout_rate``/``dropout_seed``: post-softmax dropout (the module's
    note). ``return_stats``: also return the lse fp32 [B, Hq, Sq].
    ``q_layout``/``kv_layout``/``out_layout`` "bhsd": q, k/v (with their
    scales [B, Hkv, Skv]) or the output in [B, H, S, D]; K1 and K9 read and
    write them by their strides. Long K/V without a mask, an INT8 cache or
    dropout go to K10 (:func:`flash_attention_stream`) by the JAX package's
    rule (:func:`stream_route`, with ``kv_vmem_budget``, by default
    :data:`KV_VMEM_BUDGET`); the rest to K1, at any length.
    """
    lay = dict(q_layout=q_layout, kv_layout=kv_layout, out_layout=out_layout)
    B, Sq, Hq, D, Skv, Hkv = _dims(q, k, q_layout, kv_layout)
    if out_layout not in _LAYOUTS:
        raise ValueError(f"flash_attention: out_layout must be one of {_LAYOUTS}, "
                         f"got {out_layout!r}")
    kind, m = _canonical(mask, B, Hq, Sq, Skv)
    if k_scale is not None or v_scale is not None:
        if dropout_rate:
            raise NotImplementedError(
                "attention dropout with an INT8 KV cache is not supported (dropout is a "
                "training feature; quantized caches are serving)")
        return flash_attention_kvq(q, k, v, k_scale, v_scale, causal=causal, scale=scale,
                                   q_offset=q_offset, kv_len=kv_len, mask=m,
                                   return_stats=return_stats, **lay)
    _check_shapes("flash_attention", as_bshd(q, q_layout), as_bshd(k, kv_layout),
                  as_bshd(v, kv_layout))
    if m is None and dropout_rate == 0.0 and stream_route(Skv, D, k.element_size(),
                                                          kv_vmem_budget=kv_vmem_budget):
        return flash_attention_stream(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                      kv_len=kv_len, return_stats=return_stats, **lay)
    drop = dropout_args(dropout_rate, dropout_seed)
    _build.refuse_grad("flash_attention (K1)", q, k, v,
                       hint="ops.attention without a mask, kv_len or q_offset, whose backward "
                            "is K13")
    if q.device.type == "cpu":
        o, lse = flash_plain_lse(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                                 kv_len=kv_len, mask=m, dropout_rate=dropout_rate,
                                 dropout_seed=dropout_seed, **lay)
        return (o, lse) if return_stats else o
    out = _launch("flash_attention", q, k, v, None, None, kind, m, causal=causal, scale=scale,
                  q_offset=q_offset, kv_len=kv_len, drop=drop, return_stats=return_stats, **lay)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
