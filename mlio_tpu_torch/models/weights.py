"""Parameters handed over from the JAX package."""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.ops.quant import FP8, QTensor


def from_jax_params(tree: Any, device: Union[str, torch.device] = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Turn the JAX package's parameter pytree, given as numpy arrays (the
    tree after ``jax.tree.map(np.asarray, params)``), into the port's nested
    dict of tensors on ``device``. Keys map one to one and ``None`` leaves
    stay ``None``; floating arrays are cast to ``dtype`` when it is given.
    bfloat16 arrays (numpy cannot hand those to torch) pass through fp32,
    which holds them exactly. A quantized weight (the JAX package's
    ``QTensor``, recognised by its ``q``, ``scale`` and ``fmt`` fields)
    becomes the port's :class:`QTensor` with its payload and scales
    unchanged: ``dtype`` does not touch it, and an fp8 payload (``ml_dtypes``
    float8_e4m3fn) crosses as its bytes."""
    dev = resolve_device(device)

    def array(node, cast=True):
        if not isinstance(node, (np.ndarray, np.generic)):
            raise TypeError(f"from_jax_params: expected numpy arrays, got {type(node)}")
        name = node.dtype.name
        if name == "float8_e4m3fn":
            t = torch.from_numpy(np.array(node).view(np.uint8)).view(FP8)
        else:
            bf16 = name == "bfloat16"
            t = torch.from_numpy(np.array(node, dtype=np.float32 if bf16 else None))  # a copy
            if bf16:
                t = t.to(torch.bfloat16)
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def convert(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if all(hasattr(node, f) for f in ("q", "scale", "fmt")):
            act = getattr(node, "act_scale", None)
            return QTensor(array(node.q, False), array(node.scale, False), str(node.fmt),
                           None if act is None else array(act, False))
        return array(node)

    return convert(tree)


def from_jax_cache(cache: Any, device: Union[str, torch.device] = "cuda") -> Any:
    """The JAX package's contiguous cache (``init_cache``'s dict with numpy
    leaves: ``k``/``v`` [L, B, S, Hkv, D] and, for an INT8 cache, fp32
    ``k_scale``/``v_scale`` [L, B, S, Hkv]; ``pos``) as the port's: the
    arrays on ``device`` in their dtypes (int8 stays int8), ``pos`` a
    Python int."""
    out = from_jax_params({k: v for k, v in cache.items() if k != "pos"}, device)
    out["pos"] = int(cache["pos"])
    return out
