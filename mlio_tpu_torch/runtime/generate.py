"""Autoregressive generation: prefill, then one forward per new token
(``mlio_tpu/runtime/generate.py``).

The JAX package runs the decode loop as one ``lax.scan`` inside jit; here it
is a Python loop over :func:`forward` on a cache updated in place. With
``Impl(attention="flash", norm="fused")`` the prefill goes through K1 and
K2, each decode step through K3 and K2.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl, forward
from mlio_tpu_torch.runtime import sampling
from mlio_tpu_torch.runtime.kv_cache import init_cache


@torch.inference_mode()
def generate(
    params,
    spec: ModelSpec,
    input_ids,
    *,
    max_new_tokens: int = 16,
    impl: Impl = Impl(),
    method: Optional[sampling.SamplingMethod] = None,
    generator: Optional[torch.Generator] = None,
    cache_len: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Generate ``max_new_tokens`` tokens for each row of ``input_ids``
    [B, S]. Returns [B, S + T] token ids on ``device``, where ``params``
    must already lie."""
    dev = resolve_device(device)
    if params["tok_embed"].device.type != dev.type:
        raise ValueError(f"generate: params lie on {params['tok_embed'].device}, not {dev}")
    if method is None:
        method = sampling.SamplingMethod()  # greedy
    input_ids = torch.as_tensor(input_ids, device=dev)
    B, S = input_ids.shape
    if cache_len is None:
        cache_len = min(spec.max_seq_len, S + max_new_tokens)
    if S + max_new_tokens > cache_len:
        raise ValueError("generate: cache too small for the requested generation")
    cache = init_cache(spec, B, cache_len, dtype=params["tok_embed"].dtype, device=dev)

    logits, cache = forward(params, spec, input_ids, impl=impl, cache=cache)
    token = sampling.sample(logits[:, -1, :], generator, method)
    new = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward(params, spec, token[:, None], impl=impl, cache=cache)
        token = sampling.sample(logits[:, -1, :], generator, method)
        new.append(token)
    return torch.cat([input_ids, torch.stack(new, dim=1).to(input_ids.dtype)], dim=1)


def greedy_generate(params, spec, input_ids, *, max_new_tokens=16, impl: Impl = Impl(),
                    device: Union[str, torch.device] = "cuda"):
    """Greedy decode."""
    return generate(params, spec, input_ids, max_new_tokens=max_new_tokens, impl=impl,
                    method=sampling.SamplingMethod(temperature=0.0), device=device)
