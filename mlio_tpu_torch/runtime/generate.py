"""Autoregressive generation: prefill, then one forward per new token
(``mlio_tpu/runtime/generate.py``).

The prefill is one :func:`forward` (K1 and K2 with
``Impl(attention="flash", norm="fused")``). The decode is routed as the JAX
package's ``_generate_impl`` routes it, by
:func:`~mlio_tpu_torch.models.transformer.decode_route` asked with the
batch, before any launch. On the K4 route (``decode_stack`` "mega", or
"auto" where K4 runs the batch and the K4-or-K6 rule picks it), greedy
decoding with ``attention != "dense"`` runs K4's greedy epilogue itself:
with a tied lm_head the whole decode is ONE launch of ``max_new_tokens -
1`` steps, with an untied one a launch per token. Otherwise each token is a
:func:`forward` on the cache, updated in place: K4 or the tiled megakernel
K6 with the head after it, or the per-layer scan through K3 (as the JAX
step scan runs the tiled route).

``cache_quant="int8"`` allocates an INT8 KV cache: the prefill writes it
through ``quantize_kv`` and attends through K9, and the decode takes K4's
or K6's INT8 path where the cache's length is a multiple of 128, else the
scan decode through K3's int8 instances. The JAX package launches its
megakernel once a token over an INT8 cache (its multi-step launch needs the
TPU's combined bf16 k|v buffer); the port keeps its one multi-step launch
for a tied head there too.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl, decode_route, forward, rope_cos_sin
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
    must already lie. ``cache_quant="int8"`` decodes over an INT8 KV
    cache."""
    if cache_quant not in (None, "none", "int8"):
        raise ValueError(f"generate: unsupported cache_quant {cache_quant!r}")
    quantized = cache_quant == "int8"
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
    cache = init_cache(spec, B, cache_len, dtype=params["tok_embed"].dtype,
                       quant="int8" if quantized else None, device=dev)

    logits, cache = forward(params, spec, input_ids, impl=impl, cache=cache)
    token = sampling.sample(logits[:, -1, :], generator, method)
    new = [token]
    route = "scan" if impl.attention == "dense" else decode_route(
        spec, impl, params["blocks"], B, cache_quant=quantized, smax=cache_len,
        on_card=dev.type == "cuda")
    if method.temperature == 0.0 and route == "mega":
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
              pos_embed=params["pos_embed"] if learned else None,
              k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"))

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
