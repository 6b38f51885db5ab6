"""Autoregressive generation: prefill, then one forward per new token
(``mlio_tpu/runtime/generate.py``).

The prefill is one :func:`forward` (K1 and K2 with
``Impl(attention="flash", norm="fused")``). The decode is routed as the JAX
package's ``_generate_impl`` routes it. Where the decode megakernel K4 runs
the model (``decode_stack`` "auto" or "mega") and decoding is greedy with
``attention != "dense"``, K4 runs the greedy epilogue itself: with a tied
lm_head the whole decode is ONE launch of ``max_new_tokens - 1`` steps,
with an untied one a launch per token. Otherwise each token is a
:func:`forward` on the cache, updated in place: K4 with the head after it,
or the per-layer scan through K3.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl, forward, rope_cos_sin, use_decode_stack
from mlio_tpu_torch.ops import decode_layer as _stack
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
    cache_quant: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Generate ``max_new_tokens`` tokens for each row of ``input_ids``
    [B, S]. Returns [B, S + T] token ids on ``device``, where ``params``
    must already lie. ``cache_quant="int8"`` (an INT8 KV cache) is not
    ported yet and raises."""
    if cache_quant not in (None, "none"):
        raise NotImplementedError(
            f"generate(cache_quant={cache_quant!r}): INT8 KV caches come with the int8 decode "
            "slice (K9 and the INT8 paths of K3, K4, K7, K8), not ported yet; see ROADMAP.md")
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
    if method.temperature == 0.0 and impl.attention != "dense" \
            and use_decode_stack(spec, impl, params["blocks"]):
        new += _greedy_decode_stack(params, spec, token, cache, max_new_tokens - 1)
    else:
        for _ in range(max_new_tokens - 1):
            logits, cache = forward(params, spec, token[:, None], impl=impl, cache=cache)
            token = sampling.sample(logits[:, -1, :], generator, method)
            new.append(token)
    return torch.cat([input_ids, torch.stack(new, dim=1).to(input_ids.dtype)], dim=1)


def _greedy_decode_stack(params, spec, token, cache, steps):
    """``steps`` greedy tokens after ``token`` through K4's fused epilogue;
    advances ``cache["pos"]`` by ``steps``. A tied lm_head runs them all in
    one multi-step launch, an untied one launches once per token."""
    if steps < 1:
        return []
    tied = params["lm_head"] is None
    learned = spec.positional == "learned"
    kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
              lm_head=params["tok_embed"] if tied else params["lm_head"],
              lm_head_bias=params.get("lm_head_bias"), lm_vmajor=tied,
              pos_embed=params["pos_embed"] if learned else None)

    def embed(tok):
        x = params["tok_embed"][tok]
        if spec.embed_scale is not None:  # rounded to x's dtype first, as in JAX
            x = x * torch.tensor(spec.embed_scale, dtype=x.dtype).item()
        return x

    def rope(pos, n):
        if learned:
            return None, None
        positions = torch.arange(pos, pos + n, device=token.device)
        return rope_cos_sin(positions, spec.rope_dim, spec.rope_theta)

    pos, dtype = cache["pos"], token.dtype
    if tied:
        cos, sin = rope(pos, steps)
        _, toks = _stack.decode_layer_stack(embed(token), params["blocks"], cache["k"],
                                            cache["v"], pos, cos, sin, steps=steps, **kw)
        cache["pos"] = pos + steps
        return list(toks.reshape(steps, -1).to(dtype).unbind(0))
    new = []
    for s in range(steps):
        cos, sin = rope(pos + s, 1)
        _, token = _stack.decode_layer_stack(embed(token), params["blocks"], cache["k"],
                                             cache["v"], pos + s, cos, sin, **kw)
        new.append(token.to(dtype))
    cache["pos"] = pos + steps
    return new


def greedy_generate(params, spec, input_ids, *, max_new_tokens=16, impl: Impl = Impl(),
                    device: Union[str, torch.device] = "cuda"):
    """Greedy decode."""
    return generate(params, spec, input_ids, max_new_tokens=max_new_tokens, impl=impl,
                    method=sampling.SamplingMethod(temperature=0.0), device=device)
