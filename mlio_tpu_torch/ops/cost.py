"""The work a forward does: FLOPs and bytes, for the profiler's ``cost``.

The JAX package reads XLA's ``cost_analysis()``. The port counts one run of
the function instead: :func:`counting` counts the aten ops with
``torch.utils.flop_counter.FlopCounterMode`` (the FLOPs of matrix products,
two a multiply-add) and the bytes of each op's tensors (every operand and
result once; views move nothing). The hand-written kernels launch through
``ctypes``, so neither counter sees them: each kernel wrapper is decorated
with :func:`counts`, which adds the wrapper's own count, the products'
FLOPs as its plain version computes them (a causal attention counts the
dense products, as the aten counter counts the plain version's) and the
bytes of its inputs read once and its outputs written once. Inside a
wrapper that has counted itself the aten counting is suspended: on the CPU
the wrappers run their plain versions, which are aten ops, and would
otherwise count twice. So a forward counts the same FLOPs whatever ``Impl``
implements it.

``counts`` costs one list test a call when nothing is counting.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

# The counts being taken, innermost last: module state, as the launch
# counters are, because the wrappers run deep inside a forward and take no
# counter argument.
_ACTIVE: list = []

# aten ops that move no bytes (allocations, metadata, detaching)
_FREE = ("empty", "empty_like", "empty_strided", "new_empty", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "resize_", "set_", "zeros_like", "ones_like", "full_like")


@dataclasses.dataclass
class WorkCount:
    """FLOPs and bytes of one counted run; ``kernels`` the hand-written
    kernels' share by wrapper name, [FLOPs, bytes]. ``inside``: a counted
    wrapper is running (a wrapper it calls counts nothing)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    kernels: Dict[str, list] = dataclasses.field(default_factory=dict)
    inside: bool = False

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        cell = self.kernels.setdefault(name, [0.0, 0.0])
        cell[0] += flops
        cell[1] += nbytes

    def as_cost(self) -> Dict[str, float]:
        """The JAX package's cost keys."""
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed)}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (nested lists, tuples, dicts and
    QTensors included)."""
    return sum(_nbytes(t) for t in tree_leaves(list(objs)))


class _BytesMode(TorchDispatchMode):
    def __init__(self, count: WorkCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in _FREE:
            self.count.bytes_accessed += tensor_bytes(args, kwargs or {}, out)
        return out


@contextlib.contextmanager
def counting():
    """Count the work of the code run inside: yields a :class:`WorkCount`
    filled when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode

    count = WorkCount()
    flop_mode = FlopCounterMode(display=False)
    _ACTIVE.append(count)
    try:
        with flop_mode, _BytesMode(count):
            yield count
    finally:
        _ACTIVE.remove(count)
        count.flops += flop_mode.get_total_flops()


def counts(work: Callable[..., Tuple[float, float]]):
    """Decorate a kernel wrapper: while :func:`counting` is active each
    outermost call adds ``work(*args, **kwargs)`` = (FLOPs, bytes) under the
    wrapper's name and runs with the aten counter suspended."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE or _ACTIVE[-1].inside:
                return fn(*args, **kwargs)
            count = _ACTIVE[-1]
            count.add(fn.__name__, *work(*args, **kwargs))
            count.inside = True
            try:
                with _disable_current_modes():
                    return fn(*args, **kwargs)
            finally:
                count.inside = False
        return wrapper
    return deco
