"""Position-hashed attention dropout (``mlio_tpu/ops/dropmask.py``).

The keep/drop decision is a stateless integer hash of the absolute (query
position, key position) and a seed that folds in (batch, query head), so the
forward kernel (K1 with dropout), the backward kernels (K13) and the dense
reference regenerate the same mask however they tile the scores, and tests
compare them exactly. The masks equal the JAX package's bit for bit.

The JAX hash runs in int32 with wrapping products and logical right shifts.
Here every value is carried as its uint32 bit pattern in int64: each product
is taken in 16-bit halves so that nothing exceeds int64, and reduced modulo
2^32, and a right shift of a non-negative value is logical. The CUDA kernels
compute the same hash in uint32 (``csrc/dropout.cuh``, ``drop_u01``).
"""
from __future__ import annotations

from typing import Union

import torch

_M32 = 0xFFFFFFFF
_GOLDEN, _ROW_MIX, _SEED_MIX = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_FIN1, _FIN2 = 0x7FEB352D, 0x846CA68B
# fold_seed's multipliers of the batch and head indices
B_FOLD, H_FOLD = 131071, 8191

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike) -> torch.Tensor:
    """x as its uint32 bit pattern (two's complement of an int32), in int64."""
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for a in [0, 2^32) and a constant c in [0, 2^32)."""
    lo, hi = a & 0xFFFF, a >> 16
    return ((lo * c) + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, _FIN1)
    h = h ^ (h >> 15)
    h = _mul(h, _FIN2)
    return h ^ (h >> 16)


def keep_u01(i: IntLike, j: IntLike, seed: IntLike) -> torch.Tensor:
    """Uniform [0, 1) fp32 from broadcastable integer grids ``i`` (query
    position), ``j`` (key position) and ``seed`` (already folded with batch
    and head): a multiple of 2^-23, as the JAX function gives it."""
    h = _mul(_u32(i), _GOLDEN) ^ _mul(_u32(j), _ROW_MIX)
    h = (h + _mul(_u32(seed), _SEED_MIX)) & _M32
    return (_mix(h) & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))


def fold_seed(seed: IntLike, b: IntLike, h: IntLike) -> torch.Tensor:
    """The seed folded with the batch and (query) head indices, as the int32
    bit pattern the JAX function gives (int64 holding the wrapped value)."""
    s = (_u32(seed) + _u32(b) * B_FOLD + _u32(h) * H_FOLD) & _M32
    return torch.where(s >= 1 << 31, s - (1 << 32), s)


def keep_mask(i: IntLike, j: IntLike, seed: IntLike, rate: float) -> torch.Tensor:
    """Boolean keep mask over broadcastable position grids: u >= rate in fp32."""
    return keep_u01(i, j, seed) >= torch.tensor(rate, dtype=torch.float32)


def dense_keep_mask(B: int, Hq: int, Sq: int, Skv: int, seed: IntLike, rate: float,
                    q_offset: int = 0, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """[B, Hq, Sq, Skv] keep mask; query row i sits at position i + q_offset."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    i = (ar(Sq) + q_offset)[None, None, :, None]
    j = ar(Skv)[None, None, None, :]
    seeds = fold_seed(torch.as_tensor(seed, dtype=torch.int64, device=device),
                      ar(B)[:, None, None, None], ar(Hq)[None, :, None, None])
    return keep_mask(i, j, seeds, rate)
