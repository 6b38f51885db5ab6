"""Device memory tracking: a sampled time series, per-layer footprint, leak
detection, the largest batch that fits (``mlio_tpu/profiling/memory.py``).

The counts are ``torch.cuda``'s allocator stats (:func:`device_memory_stats`:
bytes of live tensors and their peak); on the CPU they are zeros.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from mlio_tpu_torch.profiling.profiler import device_memory_stats, synchronize


class DeviceMemoryTracker:
    """Start/stop tracker with a sampled time series of one device's memory
    (``device`` None: the current card when there is one)."""

    def __init__(self, device=None):
        self.device = device
        self.samples: List[Dict[str, Any]] = []
        self._active = False

    def start(self) -> None:
        self.samples = []
        self._active = True
        self.sample("start")

    def sample(self, label: str = "") -> Dict[str, Any]:
        s = {"t": time.time(), "label": label, **device_memory_stats(self.device)}
        if self._active:
            self.samples.append(s)
        return s

    def stop(self) -> Dict[str, Any]:
        self.sample("stop")
        self._active = False
        in_use = [s["bytes_in_use"] for s in self.samples]
        return {
            "peak_bytes": max((s["peak_bytes_in_use"] for s in self.samples), default=0),
            "min_bytes": min(in_use, default=0),
            "max_bytes": max(in_use, default=0),
            "num_samples": len(self.samples),
        }


def per_layer_memory(spec, batch_size: int = 1, seq_len: int = 128,
                     dtype=torch.bfloat16) -> Dict[str, int]:
    """Analytic per-layer memory (weights and activations), the JAX
    package's formula: the MLP counts three matrices for ``"swiglu"`` only,
    two for every other activation (GeGLU included), as there."""
    h, i = spec.hidden_size, spec.intermediate_size
    bytes_per = torch.empty((), dtype=dtype).element_size()
    attn_w = spec.q_dim * h * 2 + spec.kv_dim * h * 2
    mlp_w = h * i * (3 if spec.activation == "swiglu" else 2)
    act = batch_size * seq_len * (h * 4 + i)
    return {
        "attention_weights_bytes": attn_w * bytes_per,
        "mlp_weights_bytes": mlp_w * bytes_per,
        "activation_bytes": act * bytes_per,
        "kv_per_token_bytes": 2 * spec.kv_dim * bytes_per,
        "total_layer_bytes": (attn_w + mlp_w + act) * bytes_per,
    }


def detect_memory_leak(fn: Callable, *args, iterations: int = 5,
                       tolerance_bytes: int = 1 << 20) -> Dict[str, Any]:
    """Run ``fn(*args)`` repeatedly, dropping its output each time, and flag
    live bytes (the current card's; zeros without one) that grow past
    ``tolerance_bytes`` after every call but the first."""
    readings = []
    for _ in range(iterations):
        out = fn(*args)
        synchronize(out)
        del out
        readings.append(device_memory_stats()["bytes_in_use"])
    growth = np.diff(readings)
    leaking = bool(len(growth) > 1 and (growth[1:] > tolerance_bytes).all())
    return {"readings": readings, "leaking": leaking,
            "total_growth_bytes": int(readings[-1] - readings[0])}


# What a workload raises when its batch does not fit: the card's allocator,
# and the host's (the JAX package's tests stand an OOM in by a MemoryError).
OUT_OF_MEMORY = (torch.cuda.OutOfMemoryError, MemoryError)


def find_max_batch_size(make_fn: Callable[[int], Callable[[], Any]], low: int = 1,
                        high: int = 1024) -> int:
    """Binary-search the largest batch in [low, high] whose workload runs
    without running out of memory (0 when ``low`` does not fit).
    ``make_fn(b)`` returns a thunk running the workload at batch b. Only
    :data:`OUT_OF_MEMORY` counts as not fitting; any other error is
    raised."""
    def fits(b: int) -> bool:
        try:
            synchronize(make_fn(b)())
            return True
        except OUT_OF_MEMORY:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            return False

    if not fits(low):
        return 0
    while low < high:
        mid = (low + high + 1) // 2
        if fits(mid):
            low = mid
        else:
            high = mid - 1
    return low
