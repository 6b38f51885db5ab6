"""Model forward passes over the paged KV pools
(``mlio_tpu/runtime/paged_forward.py``).

Prefill computes each layer's K/V, writes them into the pools
(``reshape_and_cache``) and attends over the prompt through ``ops.attention``
with per-sequence ``kv_len`` (K1 with ``Impl(attention="flash")``). The
per-op decode writes the current token's K/V and reads each sequence's
context through its block table with K7 (``ops/paged_attention.py``). Both
run on the model's own ``forward`` helpers, so they compute what
``forward`` computes for every model the port runs; the layer loop is a
Python loop and the pools are written in place.

The JAX package's paged forward leaves out the parallel residual, the
embedding scale, the head bias, the logit softcap and partial rotary (its
``_embed``, its layer body and its head); for GPT-2 and Llama the two
compute the same function.
"""
from __future__ import annotations

import torch

from mlio_tpu_torch import ops
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import (Impl, _attn_in, _head, _layer,
                                               _residual_tail, rope_cos_sin)
from mlio_tpu_torch.ops.paged_attention import paged_attention, reshape_and_cache


def embed(params, spec: ModelSpec, ids: torch.Tensor, positions: torch.Tensor):
    """Token embeddings (times ``embed_scale``) plus learned positions, or
    the RoPE tables of ``positions`` → (x, cos, sin)."""
    x = params["tok_embed"][ids]
    if spec.embed_scale is not None:  # the scale is rounded to x's dtype first, as in JAX
        x = x * torch.tensor(spec.embed_scale, dtype=x.dtype).item()
    if spec.positional == "learned":
        return x + params["pos_embed"][positions].to(x.dtype), None, None
    cos, sin = rope_cos_sin(positions, spec.rope_dim, spec.rope_theta)
    return x, cos, sin


@torch.inference_mode()
def prefill_paged(params, spec: ModelSpec, ids: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, block_tables: torch.Tensor, seq_lens: torch.Tensor,
                  write_pos: torch.Tensor, *, impl: Impl = Impl()) -> torch.Tensor:
    """Prefill ids [B, S] (padded; true lengths ``seq_lens`` [B]) written at
    positions ``write_pos[b] + i``: every position's K/V goes into the
    pools in place, padding included (into the sequence's own blocks or,
    past them, the scratch block its table is padded with). Returns the
    logits [B, V] of each sequence's last true token."""
    B, S = ids.shape
    positions = write_pos.long()[:, None] + torch.arange(S, device=ids.device)[None, :]
    x, cos, sin = embed(params, spec, ids, positions)
    for layer in range(spec.num_layers):
        bp = _layer(params["blocks"], layer)
        h, q, k, v = _attn_in(x, bp, spec, impl, cos, sin)
        reshape_and_cache(k_pool, v_pool, k, v, block_tables, write_pos, layer)
        attn = ops.attention(q, k, v, causal=True, q_offset=0, kv_len=seq_lens, impl=impl)
        attn_out = ops.linear(attn.reshape(B, S, spec.q_dim), bp["wo"], bp["bo"])
        x = _residual_tail(x, attn_out, h, bp, spec, impl)
    last = (seq_lens.long() - 1).clamp(0, S - 1)
    x_last = x[torch.arange(B, device=x.device), last]
    return _head(x_last[:, None], params, spec, impl)[:, 0]


@torch.inference_mode()
def decode_paged(params, spec: ModelSpec, tokens: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, block_tables: torch.Tensor,
                 context_lens: torch.Tensor, *, impl: Impl = Impl()) -> torch.Tensor:
    """One per-op decode step for every sequence: tokens [B] at positions
    ``context_lens - 1`` (``context_lens`` counts the current token). Per
    layer: norm, QKV, the K/V write, K7 over the block table,
    out-projection, norm, MLP; then the head. Inactive engine slots point at
    the scratch block with a context of 1, so their writes land there.
    Returns the logits [B, V]."""
    B = tokens.shape[0]
    positions = context_lens.long() - 1
    x, cos, sin = embed(params, spec, tokens[:, None], positions[:, None])
    for layer in range(spec.num_layers):
        bp = _layer(params["blocks"], layer)
        h, q, k, v = _attn_in(x, bp, spec, impl, cos, sin)
        reshape_and_cache(k_pool, v_pool, k, v, block_tables, positions, layer)
        attn = paged_attention(q[:, 0], k_pool, v_pool, block_tables, context_lens, layer=layer)
        attn_out = ops.linear(attn.reshape(B, 1, spec.q_dim).to(x.dtype), bp["wo"], bp["bo"])
        x = _residual_tail(x, attn_out, h, bp, spec, impl)
    return _head(x, params, spec, impl)[:, 0]
