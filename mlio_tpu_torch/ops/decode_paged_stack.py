"""The paged decode megakernel (K8): one decode step of every sequence over
the engine's block-table pools, in one launch.

Replaces ``mlio_tpu/ops/decode_paged_stack.py::_paged_stack_kernel`` (entry
``decode_paged_stack``). The kernel is CUDA C++ in
``mlio_tpu_torch/csrc/paged_stack.cu``; its phases are K4's
(``csrc/decode_stack.cuh``, shared with ``csrc/decode_layer.cu``) with the
cache read and written through each sequence's block table at its own
context, and RoPE per sequence. The epilogue gives the greedy token ids or
the fp32 logits. Its source note gives the H100 bound and the design.

On CPU tensors :func:`decode_paged_stack` runs
:func:`decode_paged_stack_plain`; on CUDA tensors it launches the kernel or
raises. The pools are the port's ``[L, NB, bs, Hkv, D]`` (the JAX package's
flat ``[L, NB, bs, Hkv*D]`` is the same memory) and are written in place.
The TPU's layout and tuning (``kv_combined`` lanes, ``kv_depth``, the 8-row
slab read-modify-write, lane-tiled RoPE tables with rotate-half matrices,
``vocab_chunk``, a padded lm_head) have no counterpart here. int8 QTensor
weights take the int8 weight path K4 has (``_paged_stack_kernel``'s, as
``decode_paged_stack.py:468-474`` has it in the JAX package); the JAX K8 has
no INT8 KV path and neither has the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops import decode_layer as _k4
from mlio_tpu_torch.ops.paged_attention import gather_blocks

_EMITS = ("greedy", "logits")


def supports_paged_stack(spec, blocks=None, B: Optional[int] = None,
                         on_card: bool = True) -> bool:
    """Whether K8 runs this model for ``B`` engine slots: K4's conditions
    (:func:`~mlio_tpu_torch.ops.decode_layer.supports_decode_stack`, its
    shape limits included), as in the JAX package."""
    return _k4.supports_decode_stack(spec, blocks=blocks, B=B, on_card=on_card)


def decode_paged_stack_plain(
    x: torch.Tensor,
    blocks,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    *,
    spec,
    scale: Optional[float] = None,
    head_norm=None,
    lm_head: Optional[torch.Tensor] = None,
    lm_head_bias: Optional[torch.Tensor] = None,
    lm_vmajor: bool = True,
    vocab_size: Optional[int] = None,
    emit: str = "greedy",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch, with K4's rounding points
    (:func:`~mlio_tpu_torch.ops.decode_layer.layer_plain`). Sequence b
    writes its K/V into slot ``context_lens[b]`` of every layer of the pools
    in place (no write when that slot is past the table) and attends over
    slots ``0 .. context_lens[b]``; slots past it are masked out before
    either product."""
    cd = x.dtype
    B = x.shape[0]
    L, _, bs, _, D = k_pool.shape
    cap = block_tables.shape[1] * bs
    if scale is None:
        scale = D ** -0.5
    slot = context_lens.to(x.device).long().clamp(min=0)
    ok = slot < cap
    rows = ok.nonzero()[:, 0]
    phys = torch.gather(block_tables.long(), 1, (slot.clamp(max=cap - 1) // bs)[:, None])[:, 0]
    phys, off = phys[rows], (slot % bs)[rows]
    valid = torch.arange(cap, device=x.device)[None, :] <= slot[:, None]
    if cos is not None:  # [B, rope_dim] rows, rounded to the compute dtype first
        cos, sin = cos.to(cd).float()[:, None], sin.to(cd).float()[:, None]

    def attend(layer, qs, k, v):
        k_pool[layer, phys, off] = k[rows].to(k_pool.dtype)
        v_pool[layer, phys, off] = v[rows].to(v_pool.dtype)
        return _k4._attend_plain(qs, gather_blocks(k_pool, layer, block_tables),
                                 gather_blocks(v_pool, layer, block_tables), valid)

    rope = None if cos is None else (lambda t: _k4._rope(t, cos, sin, D))
    x32 = x.float()
    for layer in range(L):
        x32 = _k4.layer_plain(x32, blocks, layer, spec=spec, dtype=cd, scale=scale, rope=rope,
                              attend=attend)
    if lm_head is None:
        return x32.to(cd), None
    logits = _k4.logits_plain(x32, head_norm, lm_head, lm_head_bias, spec=spec,
                              lm_vmajor=lm_vmajor, vocab_size=vocab_size, dtype=cd)
    out = logits if emit == "logits" else logits.argmax(-1).to(torch.int32)
    return x32.to(cd), out


def decode_paged_stack(
    x: torch.Tensor,
    blocks,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    *,
    spec,
    scale: Optional[float] = None,
    head_norm=None,
    lm_head: Optional[torch.Tensor] = None,
    lm_head_bias: Optional[torch.Tensor] = None,
    lm_vmajor: bool = True,
    vocab_size: Optional[int] = None,
    emit: str = "greedy",
    phase_times: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decode step of every sequence → ``(x_out [B, H], out)``.

    x [B, H] is each sequence's current-token hidden state, its learned
    position already added; blocks hold the stacked ``[L, in, out]``
    weights; k_pool/v_pool are ``[L, NB, bs, Hkv, D]``; block_tables
    [B, max_blocks] int32 name each sequence's physical blocks;
    ``context_lens`` [B] int32 counts each sequence's PAST tokens: sequence
    b writes slot ``context_lens[b]`` of every layer in place and attends
    over slots ``0 .. context_lens[b]``. cos/sin are ``[B, rope_dim]``
    tables at each sequence's position, for RoPE models.

    With ``head_norm`` = (final_scale, final_bias) and ``lm_head`` (a tied,
    vocab-major ``[V, H]`` table, or ``[H, V]`` with ``lm_vmajor=False``),
    ``out`` is the first-index argmax token ids [B] int32
    (``emit="greedy"``) or the fp32 logits [B, V] (``emit="logits"``);
    without them it is None. ``phase_times`` is K4's phase probe
    (:func:`~mlio_tpu_torch.ops.decode_layer.phase_stamps` elements).
    """
    _k4.check_weights("decode_paged_stack", "K8", blocks, spec)
    if emit not in _EMITS:
        raise ValueError(f"decode_paged_stack: emit must be one of {_EMITS}, got {emit!r}")
    B, H = x.shape
    if k_pool.ndim != 5 or v_pool.shape != k_pool.shape:
        raise ValueError(f"decode_paged_stack: pools must be [L, NB, bs, Hkv, D] alike, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    L, NB, bs, Hkv, D = k_pool.shape
    if (L, Hkv, D) != (spec.num_layers, spec.num_kv_heads, spec.head_size) \
            or H != spec.hidden_size:
        raise ValueError("decode_paged_stack: x and the pools do not match the spec")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(f"decode_paged_stack: block_tables must be [{B}, max_blocks] and "
                         f"context_lens [{B}]")
    epilogue = lm_head is not None
    if epilogue and head_norm is None:
        raise ValueError("decode_paged_stack: the epilogue needs head_norm")
    if (cos is None) != (spec.positional == "learned"):
        raise ValueError("decode_paged_stack: cos/sin are given for RoPE models, and only them")
    if cos is not None and (cos.ndim != 2 or cos.shape[0] != B or sin.shape != cos.shape):
        raise ValueError(f"decode_paged_stack: cos/sin must be [{B}, rope_dim]")
    V = (vocab_size or (lm_head.shape[0] if lm_vmajor else lm_head.shape[1])) if epilogue else 0
    kw = dict(spec=spec, scale=scale, head_norm=head_norm, lm_head=lm_head,
              lm_head_bias=lm_head_bias, lm_vmajor=lm_vmajor, vocab_size=vocab_size, emit=emit)
    _build.refuse_grad("decode_paged_stack (K8)", x, blocks, k_pool, v_pool, cos, sin,
                       head_norm, lm_head, lm_head_bias)
    if x.device.type == "cpu":
        return decode_paged_stack_plain(x, blocks, k_pool, v_pool, block_tables, context_lens,
                                        cos, sin, **kw)

    tensors, qt = _k4.stack_tensors(blocks, spec, head_norm, lm_head, lm_head_bias)
    tensors.update(x=x, k_cache=k_pool, v_cache=v_pool)
    index = dict(tables=block_tables, ctx=context_lens)
    dev = _build.require_cuda("decode_paged_stack", *[t for t in (
        *tensors.values(), *qt.values(), *index.values()) if t is not None])
    for name, t in index.items():
        if t.dtype != torch.int32:
            raise ValueError(f"decode_paged_stack: {name} must be int32")
    _build.require_contiguous_aligned("decode_paged_stack", **index)
    _k4.kernel_shapes("decode_paged_stack", spec, B, H)
    if epilogue:
        _k4.check_head("decode_paged_stack", lm_head, lm_vmajor, V, H)
    _k4.check_operands("decode_paged_stack", tensors, qt)
    lm_ld = 0
    if epilogue:
        tensors["lm_head"], lm_ld = _k4.head_operand(lm_head, lm_vmajor, V)
    if cos is not None:
        # the tables are rounded to the compute dtype first, as K4's are
        cos = cos.to(dev, x.dtype).float().contiguous()
        sin = sin.to(dev, x.dtype).float().contiguous()
    x_out = torch.empty_like(x)
    out = None
    if epilogue:
        out = torch.empty((B, V) if emit == "logits" else (B,),
                          dtype=torch.float32 if emit == "logits" else torch.int32, device=dev)
    n_stamps = _k4.phase_stamps(spec, 1, epilogue)
    if phase_times is not None and (phase_times.dtype != torch.int64
                                    or phase_times.device != dev
                                    or phase_times.numel() < n_stamps):
        raise ValueError("decode_paged_stack: phase_times must be int64 on the card, "
                         f"with {n_stamps} elements")
    prm = _k4._Params(
        **{n: _build.ptr(t) for n, t in (*tensors.items(), *qt.items(), *index.items())},
        stamps=_build.ptr(phase_times),
        x_out=x_out.data_ptr(), cos=_build.ptr(cos), sin=_build.ptr(sin),
        tokens=_build.ptr(out) if emit == "greedy" else None,
        logits=_build.ptr(out) if emit == "logits" else None,
        steps=1, bs=bs, max_blocks=block_tables.shape[1], num_blocks=NB,
        wfmt=_k4.weight_format(blocks), lm_ld=lm_ld,
        **_k4.base_params(spec, B, H, L, V, lm_vmajor, scale,
                          0 if cos is None else cos.shape[1], epilogue))
    _k4.launch("paged_stack", prm, dev, "decode_paged_stack")
    decode_paged_stack.launches += 1
    return x_out, out


decode_paged_stack.launches = 0
