"""Device memory utilities (``mlio_tpu/utils/tpu_utils.py``).

The JAX package's dict keys, filled from ``torch.cuda.memory_stats`` (the
caching allocator's bytes of live tensors, current and peak) and
``torch.cuda.mem_get_info`` (the card's total memory). On the CPU every
count is 0, as the JAX package reports for a backend without memory stats.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional, Union

import torch

Device = Union[str, torch.device, None]


def _cuda(device: Device) -> Optional[torch.device]:
    """The CUDA device meant, or None for the CPU (None means the current
    card when there is one)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def get_device_memory_usage(device: Device = None) -> Dict[str, float]:
    """Bytes in use, peak bytes in use and the card's total, with gigabytes
    in use and free and the fraction used."""
    dev = _cuda(device)
    in_use = peak = limit = 0
    if dev is not None:
        stats = torch.cuda.memory_stats(dev)
        in_use = stats.get("allocated_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", 0)
        limit = torch.cuda.mem_get_info(dev)[1]
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": peak,
        "bytes_limit": limit,
        "gb_in_use": in_use / 1e9,
        "gb_free": max(0, limit - in_use) / 1e9,
        "utilization": in_use / limit if limit else 0.0,
    }


def clear_device_memory() -> None:
    """Collect unreachable tensors and return the caching allocator's free
    blocks to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def calculate_memory_needed(
    num_params: int,
    batch_size: int = 1,
    seq_len: int = 1024,
    hidden_size: int = 768,
    num_layers: int = 12,
    kv_dim: Optional[int] = None,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    """Analytic memory need: parameters, KV cache and activations."""
    params_bytes = num_params * dtype_bytes
    kv = 2 * num_layers * batch_size * seq_len * (kv_dim or hidden_size) * dtype_bytes
    act = batch_size * seq_len * hidden_size * dtype_bytes * 8
    total = params_bytes + kv + act
    return {"params_bytes": params_bytes, "kv_cache_bytes": kv, "activation_bytes": act,
            "total_bytes": total, "total_gb": total / 1e9}


def device_info_string() -> str:
    """One line a card: index, name, gigabytes in use and total."""
    if not torch.cuda.is_available():
        return "no devices"
    lines = []
    for i in range(torch.cuda.device_count()):
        mem = get_device_memory_usage(torch.device("cuda", i))
        lines.append(f"{i}: {torch.cuda.get_device_name(i)} (gpu) — "
                     f"{mem['gb_in_use']:.2f} GB in use / {mem['bytes_limit'] / 1e9:.1f} GB")
    return "\n".join(lines)


def is_enough_device_memory(required_bytes: int, device: Device = None,
                            safety_factor: float = 1.1) -> bool:
    """Whether the card has ``required_bytes`` times ``safety_factor`` free;
    True where the limit is unknown (the CPU)."""
    mem = get_device_memory_usage(device)
    limit = mem["bytes_limit"]
    if not limit:
        return True
    return limit - mem["bytes_in_use"] >= required_bytes * safety_factor
