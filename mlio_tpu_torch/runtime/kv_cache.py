"""Contiguous KV cache (``mlio_tpu/runtime/kv_cache.py``).

Layout [L, B, S_max, H_kv, D], layer-major with head_dim last, as in the
JAX package. The cache is a dict ``{"k", "v", "pos"}`` whose ``pos`` is a
Python int: the decode loop runs in Python and knows it. ``forward`` writes
into ``k``/``v`` in place. The INT8 cache, the paged pool and the block
manager are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec


def init_cache(
    spec: ModelSpec,
    batch_size: int,
    max_seq_len: Optional[int] = None,
    dtype=torch.bfloat16,
    quant: Optional[str] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Allocate a zeroed contiguous cache on ``device``."""
    if quant not in (None, "none"):
        raise NotImplementedError(f"cache quant {quant!r} is not ported yet")
    dev = resolve_device(device)
    S = max_seq_len or spec.max_seq_len
    shape = (spec.num_layers, batch_size, S, spec.num_kv_heads, spec.head_size)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": 0,
    }


def cache_memory_bytes(spec: ModelSpec, batch_size: int, max_seq_len: int,
                       dtype=torch.bfloat16) -> int:
    """Bytes of the K and V tensors of :func:`init_cache`."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (2 * spec.num_layers * batch_size * max_seq_len
            * spec.num_kv_heads * spec.head_size * itemsize)
