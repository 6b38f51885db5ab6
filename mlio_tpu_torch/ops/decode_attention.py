"""Single-token decode attention over the contiguous KV cache (K3).

Replaces ``mlio_tpu/ops/decode_attention.py::_decode_kernel``. The kernel is
CUDA C++ in ``mlio_tpu_torch/csrc/decode_attn.cu``: a thread-block cluster
per (sequence, KV head), so the G query heads of a group share each K/V
read, whose blocks each take one chunk of the cache's slots (16-byte loads
of only the ``context_lens[b]`` valid slots of ``[layer, b]``, an online
softmax; grouped heads' products on the tensor cores) and merge their
softmax states in rank order through distributed shared memory.
:func:`split_plan` picks the chunks from the shapes alone, so a call stays
one launch with no synchronisation. It is bound by bytes; its
source note gives the H100 bound at the main path's shapes and what the
design does about it.

An INT8 cache (``init_cache(quant="int8")``) comes with per-(slot, head)
fp32 scales [L, B, Smax, Hkv]: the kernel's int8 instances read 8-byte rows
and fuse the K scale into the score and the V scale into the probability,
as ``_decode_kernel``'s ``kv_quant`` path does.

On CPU tensors :func:`decode_attention` runs :func:`decode_attention_plain`;
on CUDA tensors it launches the kernel or raises: q must be bf16, the cache
bf16 or int8. Head dims 80 (Phi-2) and 256 (Gemma) run the fp32 pass alone:
one query head a KV head over a bf16 cache (:data:`FP32_ONLY_HEAD_DIMS`).
At head dim 80 that pass is fed by TMA: a producer thread copies each
block's slots in stages of :data:`RING_TOKENS` through the cache's tensor
maps (:func:`cache_map`, encoded once per cache tensor and kept in
``_build``'s map cache, never per launch); :func:`ring_stages` mirrors the
stages a block takes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops.flash_attention import head_dim_error

_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (64, 128)
FP32_ONLY_HEAD_DIMS = (80, 256)  # G 1 over a bf16 cache only (ROADMAP.md A4, A5)
# The kernel's split (csrc/decode_attn.cuh): a chunk is a multiple of the
# slots a block step covers, and a cluster holds at most 8 blocks.
TOKEN_STEP, MAX_SPLIT = 128, 8
# Blocks the split aims at: two for each of the H100's 132 SMs.
BLOCK_TARGET = 2 * 132
# The TMA pass (head dim 80): the slots of K and of V a ring stage
# (csrc/decode_attn.cuh's kRingTokens), a divisor of TOKEN_STEP.
TMA_HEAD_DIMS, RING_TOKENS = (80,), 32


def split_plan(B: int, Hkv: int, Smax: int) -> tuple:
    """(n_split, chunk): each (sequence, KV head) runs as a cluster of
    n_split blocks, block r over slots [r * chunk, (r + 1) * chunk) of the
    cache. From the shapes alone: the fewest blocks that reach
    ``BLOCK_TARGET`` (about two for each SM), or, where ``MAX_SPLIT`` chunks
    do not reach it, the most; a chunk a multiple of ``TOKEN_STEP``, and no
    chunk wholly past Smax."""
    Smax = max(Smax, 1)
    want = -(-BLOCK_TARGET // max(1, B * Hkv))
    capped = -(-Smax // MAX_SPLIT // TOKEN_STEP) * TOKEN_STEP  # the smallest chunk allowed
    if want <= 1:
        chunk = -(-Smax // TOKEN_STEP) * TOKEN_STEP
    else:  # the largest chunk that still gives at least `want` of them
        chunk = max(capped, (Smax - 1) // (want - 1) // TOKEN_STEP * TOKEN_STEP)
    return -(-Smax // chunk), chunk


def ring_stages(n_b: int, rank: int, chunk: int) -> list:
    """The stages block ``rank`` of a (sequence, KV head)'s cluster takes
    in the TMA pass, as (first slot, slots below n_b) pairs: its chunk's
    slots [rank * chunk, min(n_b, (rank + 1) * chunk)) in stages of
    RING_TOKENS from the chunk's start; none where the chunk lies wholly at
    or past n_b. A stage's slots at or past n_b are copied but not used."""
    t_begin = rank * chunk
    n = min(max(n_b, 0), t_begin + chunk)
    return [(t0, min(RING_TOKENS, n - t0)) for t0 in range(t_begin, n, RING_TOKENS)]


def cache_map(cache: torch.Tensor, what: str = "decode_attention") -> tuple:
    """The TMA map of a [L, B, Smax, Hkv, D] bf16 cache as (dims, byte
    strides, box): a 4-D map [D, Hkv, Smax, L * B] (innermost first) whose
    box (D, 1, RING_TOKENS, 1) lands a stage of one (layer, sequence, KV
    head)'s rows packed; the layer and sequence are a box coordinate. Raises
    ``ValueError`` where TMA would refuse it: the head dim not contiguous,
    a row not a multiple of 16 bytes, L and B not one stride apart, a
    stride not a multiple of 16 bytes or past 2**40, or a start not 16-byte
    aligned."""
    L, B, Smax, Hkv, D = cache.shape
    esz = cache.element_size()
    st = [x * esz for x in cache.stride()]
    if st[4] != esz or (D * esz) % 16 or (L > 1 and B > 1 and st[0] != B * st[1]):
        raise ValueError(f"{what}: the cache's TMA map needs a contiguous head dim of a "
                         f"multiple of 16 bytes and its layers and sequences one stride apart; "
                         f"got shape {tuple(cache.shape)}, strides {cache.stride()}")
    # L and B as one dim (a size-1 dim takes the other's stride)
    lb = st[1] if B > 1 or L == 1 else st[0]
    strides = (st[3] if Hkv > 1 else D * esz, st[2] if Smax > 1 else Hkv * D * esz, lb)
    dims = (D, Hkv, Smax, L * B)
    if any(x % 16 or x >= 1 << 40 for x in strides) or cache.data_ptr() % 16:
        raise ValueError(f"{what}: TMA needs byte strides that are multiples of 16 below 2**40 "
                         f"and a 16-byte aligned start; got byte strides {tuple(st)}")
    return dims, strides, (D, 1, RING_TOKENS, 1)


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    layer: int,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch. With one query head per KV
    head everything stays fp32, as ``_decode_kernel``'s G == 1 path; with
    G > 1 the scaled query and the probabilities are rounded to the cache's
    dtype before their products, as its MXU path. With an INT8 cache the K
    scale multiplies the fp32 score and the V scale the probability (l sums
    the unscaled ones); at G > 1 the rounding dtype is bf16, as in the TPU
    kernel, whatever q's dtype. A sequence with no valid slot gives 0."""
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[2], k_cache.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    quant = k_scales is not None
    rdt = torch.bfloat16 if quant else k_cache.dtype
    qs = q.float() * scale
    if G > 1:
        qs = qs.to(rdt).float()
    s = torch.einsum("bkgd,bskd->bkgs", qs.reshape(B, Hkv, G, D), k_cache[layer].float())
    if quant:
        s = s * k_scales[layer].float().permute(0, 2, 1)[:, :, None, :]
    valid = torch.arange(Smax, device=q.device)[None, :] < context_lens.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m.isneginf(), 0.0, m))
    l = p.sum(-1, keepdim=True)
    if quant:
        p = p * v_scales[layer].float().permute(0, 2, 1)[:, :, None, :]
    if G > 1:
        p = p.to(rdt if quant else v_cache.dtype).float()
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache[layer].float())
    o = o / torch.where(l == 0, 1.0, l)
    return o.reshape(B, Hq, D).to(q.dtype)


def _entry():
    lib = _build.library("decode_attn")
    fn = lib.mlio_decode_attn
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, p, p]
        fn.restype = i
        lib.mlio_decode_attn_maps.argtypes = [p, p, p, p]
        lib.mlio_decode_attn_maps.restype = i
        lib.mlio_decode_attn_maps_bytes.argtypes = []
        lib.mlio_decode_attn_maps_bytes.restype = i
    return lib, fn


def _maps(lib, k_cache, v_cache):
    """The caches' TMA maps (the TMA pass), encoded once per pair of cache
    tensors (their addresses, shape and strides) and cached."""
    dims, strides, box = cache_map(k_cache)
    if cache_map(v_cache)[1] != strides:
        raise ValueError("decode_attention: k_cache and v_cache must have the same strides")
    geo = (ctypes.c_longlong * 11)(*dims, *strides, *box)
    key = ("decode_attn", k_cache.data_ptr(), v_cache.data_ptr(), dims, strides, box)
    return _build.tensor_maps(
        key, lib.mlio_decode_attn_maps_bytes(),
        lambda buf: lib.mlio_decode_attn_maps(k_cache.data_ptr(), v_cache.data_ptr(), geo, buf),
        lib, "decode_attention (tensor maps)")


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    layer: int,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention → [B, Hq, D] in q's dtype.

    q [B, Hq, D] is one token per sequence; k_cache/v_cache are
    [L, B, Smax, Hkv, D]; ``context_lens`` [B] counts the valid slots of each
    sequence, the current token included; ``layer`` is the cache's layer
    index. An int8 cache takes its fp32 ``k_scales``/``v_scales``
    [L, B, Smax, Hkv].
    """
    B, Hq, D = q.shape
    if k_cache.ndim != 5 or k_cache.shape[1] != B or k_cache.shape[4] != D \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches must be [L, {B}, Smax, Hkv, {D}] "
                         f"alike, got {tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    L, _, Smax, Hkv, _ = k_cache.shape
    if Hq % Hkv:
        raise ValueError("decode_attention: query heads must be a multiple of KV heads")
    if not 0 <= layer < L:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {L})")
    if context_lens.shape != (B,):
        raise ValueError(f"decode_attention: context_lens must be [{B}]")
    quant = _build.check_kv_scales("decode_attention", k_cache, v_cache, k_scales, v_scales)
    _build.refuse_grad("decode_attention (K3)", q, k_cache, v_cache, k_scales, v_scales)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, context_lens, layer=layer,
                                      scale=scale, k_scales=k_scales, v_scales=v_scales)
    dev = _build.require_cuda("decode_attention", q, k_cache, v_cache, context_lens,
                              *([k_scales, v_scales] if quant else []))
    _build.require_bf16("decode_attention", q=q,
                        **({} if quant else dict(k_cache=k_cache, v_cache=v_cache)))
    G = Hq // Hkv
    if G not in _GROUPS:
        raise ValueError(f"decode_attention: group {G} not in {_GROUPS}")
    if D not in _HEAD_DIMS and (D not in FP32_ONLY_HEAD_DIMS or G > 1 or quant):
        raise head_dim_error("decode_attention", D, "with one query head a KV head over a "
                             "bf16 cache" if D in FP32_ONLY_HEAD_DIMS else "")
    if context_lens.dtype != torch.int32 or not context_lens.is_contiguous():
        raise ValueError("decode_attention: context_lens must be contiguous int32")
    _build.require_contiguous_aligned("decode_attention", q=q, k_cache=k_cache,
                                      v_cache=v_cache, k_scales=k_scales, v_scales=v_scales)
    out = torch.empty_like(q)
    n_split, chunk = split_plan(B, Hkv, Smax)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        maps = _maps(lib, k_cache, v_cache) if D in TMA_HEAD_DIMS else None
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _build.ptr(k_scales),
                 _build.ptr(v_scales), context_lens.data_ptr(), out.data_ptr(), B, Smax, Hkv, G,
                 D, layer, D ** -0.5 if scale is None else scale, n_split, chunk, maps,
                 _build.stream_handle(dev))
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
