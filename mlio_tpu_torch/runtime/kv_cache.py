"""KV caches (``mlio_tpu/runtime/kv_cache.py``): contiguous and paged.

The contiguous cache is [L, B, S_max, H_kv, D], layer-major with head_dim
last, as in the JAX package: a dict ``{"k", "v", "pos"}`` whose ``pos`` is
a Python int, since the decode loop runs in Python and knows it.
``forward`` writes into ``k``/``v`` in place.

The paged half (``BlockManager``, ``SequenceMetadata``, ``PagedKVCache``,
``calculate_num_blocks``) keeps the JAX package's host-side accounting in
plain Python; ``PagedKVCache``'s device arrays are tensors on an explicit
device. The engine's pools and scheduler are
``ops/paged_attention.py::init_kv_pools`` and ``runtime/scheduler.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def init_cache(
    spec: ModelSpec,
    batch_size: int,
    max_seq_len: Optional[int] = None,
    dtype=torch.bfloat16,
    quant: Optional[str] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Allocate a zeroed contiguous cache on ``device``.

    ``quant="int8"`` allocates int8 K/V plus per-(token, head) fp32 scales
    ``k_scale``/``v_scale`` [L, B, S_max, H_kv] (ones), as the JAX package
    does; K9 (prefill), K3 and K4 (decode) read the scales beside the
    int8 rows."""
    if quant not in (None, "none", "int8"):
        raise ValueError(f"unsupported cache quant {quant!r}")
    dev = resolve_device(device)
    S = max_seq_len or spec.max_seq_len
    shape = (spec.num_layers, batch_size, S, spec.num_kv_heads, spec.head_size)
    if quant == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            "pos": 0,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": 0,
    }


def cache_memory_bytes(spec: ModelSpec, batch_size: int, max_seq_len: int,
                       dtype=torch.bfloat16, quant: Optional[str] = None) -> int:
    """Bytes of the K and V tensors of :func:`init_cache`; with
    ``quant="int8"`` the int8 K/V and their fp32 scales."""
    rows = 2 * spec.num_layers * batch_size * max_seq_len * spec.num_kv_heads
    if quant == "int8":
        return rows * (spec.head_size + 4)
    return rows * spec.head_size * _itemsize(dtype)


# ---------------------------------------------------------------------------
# Block manager and paged cache
# ---------------------------------------------------------------------------

class BlockManager:
    """Host-side physical block pool with refcounts for prefix sharing:
    integer accounting only (free list, refcounts), no device memory."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.free_blocks: List[int] = list(range(num_blocks))
        self.refcounts = np.zeros(num_blocks, dtype=np.int32)

    @property
    def num_free(self) -> int:
        return len(self.free_blocks)

    def allocate(self) -> int:
        if not self.free_blocks:
            raise MemoryError("out of KV-cache blocks")
        block = self.free_blocks.pop()
        self.refcounts[block] = 1
        return block

    def fork(self, block: int) -> int:
        """Share a block (copy-on-write prefix sharing)."""
        self.refcounts[block] += 1
        return block

    def free(self, block: int) -> None:
        self.refcounts[block] -= 1
        if self.refcounts[block] == 0:
            self.free_blocks.append(block)
        elif self.refcounts[block] < 0:
            raise ValueError(f"double free of block {block}")


@dataclasses.dataclass
class SequenceMetadata:
    """Per-sequence logical→physical block mapping."""

    seq_id: int
    block_ids: List[int] = dataclasses.field(default_factory=list)
    length: int = 0


class PagedKVCache:
    """Paged KV cache: pools on ``device`` plus the host block table.

    Device state: ``k_pool``, ``v_pool`` [num_blocks, L, block_size, H_kv, D]
    (the JAX class's layout). Tables for kernels come from
    :meth:`block_table_array` and :meth:`context_lens_array`.
    """

    def __init__(self, spec: ModelSpec, num_blocks: int, block_size: int = 16,
                 max_seqs: int = 64, max_seq_len: Optional[int] = None,
                 dtype=torch.bfloat16, *, device: Union[str, torch.device] = "cuda"):
        self.spec = spec
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len or spec.max_seq_len
        self.max_blocks_per_seq = -(-self.max_seq_len // block_size)
        self.dtype = dtype
        self.device = resolve_device(device)
        pool_shape = (num_blocks, spec.num_layers, block_size, spec.num_kv_heads,
                      spec.head_size)
        self.k_pool = torch.zeros(pool_shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(pool_shape, dtype=dtype, device=self.device)
        self.manager = BlockManager(num_blocks, block_size)
        self.sequences: Dict[int, SequenceMetadata] = {}

    def allocate_sequence(self, seq_id: int, prompt_len: int) -> SequenceMetadata:
        if seq_id in self.sequences:
            raise ValueError(f"sequence {seq_id} already allocated")
        num_blocks = -(-prompt_len // self.block_size) if prompt_len else 0
        meta = SequenceMetadata(seq_id=seq_id)
        for _ in range(num_blocks):
            meta.block_ids.append(self.manager.allocate())
        meta.length = prompt_len
        self.sequences[seq_id] = meta
        return meta

    def append_token(self, seq_id: int) -> None:
        """Account for one generated token, growing the block list on a
        block boundary."""
        meta = self.sequences[seq_id]
        if meta.length == len(meta.block_ids) * self.block_size:
            meta.block_ids.append(self.manager.allocate())
        meta.length += 1

    def free_sequence(self, seq_id: int) -> None:
        meta = self.sequences.pop(seq_id)
        for b in meta.block_ids:
            self.manager.free(b)

    def fork_sequence(self, src_id: int, dst_id: int) -> None:
        """Share all blocks of src with dst (prefix sharing / beam search)."""
        src = self.sequences[src_id]
        self.sequences[dst_id] = SequenceMetadata(
            seq_id=dst_id, block_ids=[self.manager.fork(b) for b in src.block_ids],
            length=src.length)

    def block_table_array(self, seq_ids: List[int]) -> torch.Tensor:
        """Dense [len(seq_ids), max_blocks_per_seq] int32 table (0-padded)."""
        table = np.zeros((len(seq_ids), self.max_blocks_per_seq), dtype=np.int32)
        for row, sid in enumerate(seq_ids):
            ids = self.sequences[sid].block_ids
            table[row, :len(ids)] = ids
        return torch.from_numpy(table).to(self.device)

    def context_lens_array(self, seq_ids: List[int]) -> torch.Tensor:
        return torch.tensor([self.sequences[s].length for s in seq_ids], dtype=torch.int32,
                            device=self.device)

    def memory_stats(self) -> Dict[str, float]:
        block_bytes = (2 * self.spec.num_layers * self.block_size * self.spec.num_kv_heads
                       * self.spec.head_size * _itemsize(self.dtype))
        used = self.manager.num_blocks - self.manager.num_free
        return {
            "num_blocks": self.manager.num_blocks,
            "used_blocks": used,
            "free_blocks": self.manager.num_free,
            "block_bytes": block_bytes,
            "used_bytes": used * block_bytes,
            "total_bytes": self.manager.num_blocks * block_bytes,
            "utilization": used / max(1, self.manager.num_blocks),
        }


def calculate_num_blocks(spec: ModelSpec, free_hbm_bytes: int, block_size: int = 16,
                         dtype=torch.bfloat16, memory_fraction: float = 0.9) -> int:
    """Block budget from the device memory that is free."""
    block_bytes = (2 * spec.num_layers * block_size * spec.num_kv_heads * spec.head_size
                   * _itemsize(dtype))
    return max(1, int(free_hbm_bytes * memory_fraction) // block_bytes)
