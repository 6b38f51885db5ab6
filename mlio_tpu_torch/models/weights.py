"""Parameters handed over from the JAX package."""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from mlio_tpu_torch.device import resolve_device


def from_jax_params(tree: Any, device: Union[str, torch.device] = "cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Turn the JAX package's parameter pytree, given as numpy arrays (the
    tree after ``jax.tree.map(np.asarray, params)``), into the port's nested
    dict of tensors on ``device``. Keys map one to one and ``None`` leaves
    stay ``None``; floating arrays are cast to ``dtype`` when it is given.
    bfloat16 arrays (numpy cannot hand those to torch) pass through fp32,
    which holds them exactly."""
    dev = resolve_device(device)

    def convert(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if not isinstance(node, (np.ndarray, np.generic)):
            raise TypeError(f"from_jax_params: expected numpy arrays, got {type(node)}")
        bf16 = node.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(node, dtype=np.float32 if bf16 else None))  # a copy
        if bf16:
            t = t.to(torch.bfloat16)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree)
