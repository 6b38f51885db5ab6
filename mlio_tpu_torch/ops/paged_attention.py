"""Paged KV pools, their writes, and decode attention over them (K7).

Mirrors ``mlio_tpu/ops/paged_attention.py``. The pools are
``[L, NB, bs, Hkv, D]``: one physical block is a contiguous
``[bs, Hkv * D]`` slab, and a sequence's slot ``s`` is row ``s % bs`` of
physical block ``block_tables[b, s // bs]``.

:func:`reshape_and_cache` and :func:`reshape_and_cache_flat` are XLA
scatters in the JAX package; here they are PyTorch advanced indexing, which
writes the pools in place. :func:`paged_attention` launches K7, CUDA C++ in
``mlio_tpu_torch/csrc/paged_attn.cu`` (replacing ``_paged_attn_kernel``),
whose source note gives its H100 bound and design: a thread-block cluster
per (sequence, KV head) whose blocks each take a chunk of whole pages of the
table (:func:`paged_split_plan`, from the shapes alone), read their chunk's
table entries once, stream the pages' rows through a ring of shared memory
and merge their softmax states in rank order; fp32 throughout, grouped heads
included. On CPU tensors it runs :func:`paged_attention_plain`. INT8 pools
(``init_kv_pools(quant="int8")``) carry per-(slot, head) fp32 scale pools
``[L, NB, bs, Hkv]``, written by :func:`reshape_and_cache_quant` and read by
K7's int8 instances.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops.decode_attention import MAX_SPLIT, TOKEN_STEP
from mlio_tpu_torch.ops.quant import quantize_kv
from mlio_tpu_torch.ops.reference import attention_reference

_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (64, 128)
# Blocks the split aims at: about one and a half for each of the H100's 132
# SMs. At B 8 over tables of 8 blocks of 128 (NVIDIA H100 80GB HBM3, 700 W)
# clusters of 8 ran slower than of 2-4, for GPT-2's 12 heads of 64 and
# llama3-8b's 8 of 128; K3's target, 264, would give llama3-8b's heads 8.
BLOCK_TARGET = 192
# The most table entries a block's chunk may hold: they sit in its shared
# memory beside the ring of tiles (64 KB).
MAX_CHUNK_PAGES = 16384


def paged_split_plan(B: int, Hkv: int, max_blocks: int, bs: int) -> tuple:
    """(n_split, chunk): each (sequence, KV head) runs as a cluster of
    n_split blocks, block r over the table's pages [r * chunk / bs,
    (r + 1) * chunk / bs), so a chunk is a whole number of pages. From the
    shapes alone: ``BLOCK_TARGET`` blocks over the B * Hkv clusters, at most
    ``MAX_SPLIT`` a cluster, the table cut into chunks of equal whole pages
    (the last may hold fewer) of at least ``TOKEN_STEP`` slots unless the
    table is shorter, and no chunk wholly past the table."""
    pages = max(max_blocks, 1)
    least = min(pages, -(-TOKEN_STEP // bs))
    want = min(MAX_SPLIT, -(-BLOCK_TARGET // max(1, B * Hkv)))
    per = max(least, -(-pages // want))
    return -(-pages // per), per * bs


def init_kv_pools(num_layers: int, num_blocks: int, num_kv_heads: int, block_size: int,
                  head_dim: int, dtype=torch.bfloat16, quant: Optional[str] = None, *,
                  device: Union[str, torch.device] = "cuda") -> Tuple[torch.Tensor, ...]:
    """Zeroed K/V pools [L, NB, bs, Hkv, D] on ``device``. ``quant="int8"``
    returns (k, v, k_scale, v_scale): int8 pools and per-(slot, head) fp32
    scale pools [L, NB, bs, Hkv] of ones."""
    if quant not in (None, "none", "int8"):
        raise ValueError(f"init_kv_pools: unsupported quant {quant!r}")
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    dev = resolve_device(device)
    if quant == "int8":
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:-1], dtype=torch.float32, device=dev),
                torch.ones(shape[:-1], dtype=torch.float32, device=dev))
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _slots(block_tables, write_pos, S_new, bs):
    """(physical block, row) [B, S_new] of positions write_pos[b] + i."""
    pos = write_pos.long()[:, None] + torch.arange(S_new, device=write_pos.device)[None, :]
    physical = torch.gather(block_tables.long(), 1, pos // bs)
    return physical, pos % bs


def reshape_and_cache(k_pool: torch.Tensor, v_pool: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, block_tables: torch.Tensor, write_pos: torch.Tensor,
                      layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new [B, S_new, Hkv, D] at positions ``write_pos[b] + i``
    of each sequence into layer ``layer`` of the pools, in place. Returns the
    pools (the same tensors)."""
    physical, offset = _slots(block_tables, write_pos, k_new.shape[1], k_pool.shape[2])
    k_pool[layer, physical, offset] = k_new.to(k_pool.dtype)
    v_pool[layer, physical, offset] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def reshape_and_cache_quant(k_pool, v_pool, ks_pool, vs_pool, k_new, v_new, block_tables,
                            write_pos, layer):
    """The INT8 twin of :func:`reshape_and_cache`: k_new/v_new quantized per
    (token, head) with :func:`~mlio_tpu_torch.ops.quant.quantize_kv`, the
    int8 rows and their scales written in place. Returns the four pools."""
    physical, offset = _slots(block_tables, write_pos, k_new.shape[1], k_pool.shape[2])
    for pool, spool, new in ((k_pool, ks_pool, k_new), (v_pool, vs_pool, v_new)):
        q, sc = quantize_kv(new)
        pool[layer, physical, offset] = q
        spool[layer, physical, offset] = sc
    return k_pool, v_pool, ks_pool, vs_pool


def reshape_and_cache_flat(pool: torch.Tensor, new: torch.Tensor, block_tables: torch.Tensor,
                           write_pos: torch.Tensor, layer: int) -> torch.Tensor:
    """The flat-row twin of :func:`reshape_and_cache` for one pool
    [L, NB, bs, W] and rows new [B, S_new, W], in place. The port's engine
    keeps ``[L, NB, bs, Hkv, D]`` pools, the same memory as the JAX
    package's flat ``[L, NB, bs, Hkv*D]`` ones; this serves callers that
    hold the flat view."""
    physical, offset = _slots(block_tables, write_pos, new.shape[1], pool.shape[2])
    pool[layer, physical, offset] = new.to(pool.dtype)
    return pool


def gather_blocks(pool, layer, block_tables):
    """[B, max_blocks * bs, ...]: every table entry's block of ``layer``
    (K/V pools [.., Hkv, D], scale pools [.., Hkv])."""
    B, nb = block_tables.shape
    g = pool[layer][block_tables.long()]  # [B, max_blocks, bs, Hkv, D]
    return g.reshape(B, nb * pool.shape[2], *pool.shape[3:])


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                          layer: int, scale: Optional[float] = None,
                          k_scale_pool: Optional[torch.Tensor] = None,
                          v_scale_pool: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 throughout, as the TPU
    kernel; INT8 pools are dequantized in fp32 before both products, as
    ``_paged_attn_kernel`` does. Slots at or past ``context_lens[b]`` are
    masked out before either product, so whatever they hold never reaches
    the output; a sequence with no valid slot gives 0."""
    B, Hq, D = q.shape
    Hkv = k_pool.shape[3]
    if scale is None:
        scale = D ** -0.5
    keys = gather_blocks(k_pool, layer, block_tables).float()
    vals = gather_blocks(v_pool, layer, block_tables).float()
    if k_scale_pool is not None:
        keys = keys * gather_blocks(k_scale_pool, layer, block_tables)[..., None]
        vals = vals * gather_blocks(v_scale_pool, layer, block_tables)[..., None]
    T = keys.shape[1]
    valid = torch.arange(T, device=q.device)[None, :] < context_lens.to(q.device).long()[:, None]
    keys = keys.masked_fill(~valid[:, :, None, None], 0)
    vals = vals.masked_fill(~valid[:, :, None, None], 0)
    s = torch.einsum("bkgd,btkd->bkgt", q.float().reshape(B, Hkv, Hq // Hkv, D) * scale, keys)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(m.isneginf(), 0.0, m))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", p, vals) / torch.where(l == 0, 1.0, l)
    return o.reshape(B, Hq, D).to(q.dtype)


def paged_attention_reference(q, k_pool, v_pool, block_tables, context_lens, *, layer,
                              scale=None):
    """Gather the pools densely and run the masked dense attention (the JAX
    package's ``paged_attention_reference``)."""
    B, Hq, D = q.shape
    k = gather_blocks(k_pool, layer, block_tables)
    v = gather_blocks(v_pool, layer, block_tables)
    out = attention_reference(q.reshape(B, 1, Hq, D), k, v, causal=False, scale=scale,
                              kv_len=context_lens)
    return out[:, 0]


def _entry():
    lib = _build.library("paged_attn")
    fn = lib.mlio_paged_attn
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, i, p]
        fn.restype = i
    return lib, fn


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    layer: int,
    scale: Optional[float] = None,
    k_scale_pool: Optional[torch.Tensor] = None,
    v_scale_pool: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over the paged pools → [B, Hq, D] in q's dtype.

    q [B, Hq, D] is one token per sequence; k_pool/v_pool are
    [L, NB, bs, Hkv, D]; block_tables [B, max_blocks] int32 names each
    sequence's physical blocks; ``context_lens`` [B] int32 counts its valid
    slots, the current token included; ``layer`` is the pools' layer index.
    INT8 pools take their fp32 scale pools ``k_scale_pool``/``v_scale_pool``
    [L, NB, bs, Hkv].
    """
    B, Hq, D = q.shape
    if k_pool.ndim != 5 or k_pool.shape[4] != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention: pools must be [L, NB, bs, Hkv, {D}] alike, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    L, NB, bs, Hkv, _ = k_pool.shape
    if Hq % Hkv:
        raise ValueError("paged_attention: query heads must be a multiple of KV heads")
    if not 0 <= layer < L:
        raise ValueError(f"paged_attention: layer {layer} outside [0, {L})")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(f"paged_attention: block_tables must be [{B}, max_blocks] and "
                         f"context_lens [{B}]")
    quant = _build.check_kv_scales("paged_attention", k_pool, v_pool, k_scale_pool,
                                   v_scale_pool)
    _build.refuse_grad("paged_attention (K7)", q, k_pool, v_pool, k_scale_pool, v_scale_pool)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables, context_lens,
                                     layer=layer, scale=scale, k_scale_pool=k_scale_pool,
                                     v_scale_pool=v_scale_pool)
    dev = _build.require_cuda("paged_attention", q, k_pool, v_pool, block_tables,
                              context_lens, *([k_scale_pool, v_scale_pool] if quant else []))
    _build.require_bf16("paged_attention", q=q, **({} if quant else dict(k_pool=k_pool,
                                                                         v_pool=v_pool)))
    G = Hq // Hkv
    if G not in _GROUPS or D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention: group {G} not in {_GROUPS} or head dim {D} "
                         f"not in {_HEAD_DIMS} (other head dims are not built: ROADMAP.md A4)")
    for name, t in (("block_tables", block_tables), ("context_lens", context_lens)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous int32")
    _build.require_contiguous_aligned("paged_attention", q=q, k_pool=k_pool, v_pool=v_pool,
                                      k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    max_blocks = block_tables.shape[1]
    n_split, chunk = paged_split_plan(B, Hkv, max_blocks, bs)
    if chunk // bs > MAX_CHUNK_PAGES:
        raise ValueError(f"paged_attention: a block's chunk of {chunk // bs} table entries "
                         f"exceeds {MAX_CHUNK_PAGES} (max_blocks {max_blocks} over at most "
                         f"{MAX_SPLIT} blocks); use larger blocks")
    out = torch.empty_like(q)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _build.ptr(k_scale_pool), _build.ptr(v_scale_pool), block_tables.data_ptr(),
                 context_lens.data_ptr(), out.data_ptr(), B, max_blocks, NB, bs, Hkv, G, D,
                 layer, D ** -0.5 if scale is None else scale, n_split, chunk // bs,
                 _build.stream_handle(dev))
    _build.check(lib, err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
