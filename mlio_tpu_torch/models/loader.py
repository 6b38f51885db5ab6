"""Model loading: presets and HF GPT-2 conversion (``mlio_tpu/models/loader.py``).

A preset name random-inits from a seed; an in-memory ``transformers`` GPT-2
model is converted once into the stacked-layer parameter dict. ``transformers``
is never imported here: the caller hands over the model. The Llama, Mixtral
and other family converters, and loading a checkpoint directory, are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec, get_spec
from mlio_tpu_torch.models.transformer import init_params

StateDict = Dict[str, torch.Tensor]


def state_dict_from_torch(model) -> StateDict:
    """The module's state dict, detached (the model is not kept)."""
    return {k: v.detach() for k, v in model.state_dict().items()}


def spec_from_hf_config(cfg: Any, name: str = "custom") -> ModelSpec:
    """Derive a ModelSpec from an HF GPT-2 config object or dict."""
    get = (lambda k, d=None: cfg.get(k, d)) if isinstance(cfg, dict) else (
        lambda k, d=None: getattr(cfg, k, d))
    model_type = get("model_type", "gpt2")
    if model_type != "gpt2":
        raise NotImplementedError(
            f"HF model_type {model_type!r} is not ported yet; the port converts GPT-2")
    h = get("n_embd")
    return ModelSpec(
        name=name, vocab_size=get("vocab_size"), hidden_size=h,
        num_layers=get("n_layer"), num_heads=get("n_head"),
        num_kv_heads=get("n_head"),
        intermediate_size=get("n_inner") or 4 * h,
        max_seq_len=get("n_positions", 1024),
        activation="gelu_new", norm="layernorm",
        norm_eps=get("layer_norm_epsilon", 1e-5),
        positional="learned", tie_embeddings=True)


def convert_gpt2(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                 device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """GPT-2 state dict → parameter dict. HF GPT-2's Conv1D weights are
    already [in, out]; the fused c_attn [H, 3H] is split into q/k/v."""
    dev = resolve_device(device)
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    L = spec.num_layers

    def g(key):
        return torch.as_tensor(sd[prefix + key])

    def stack(fmt):
        return torch.stack([g(fmt.format(i)) for i in range(L)])

    def T(x):
        return x.to(device=dev, dtype=dtype).contiguous()

    wq, wk, wv = stack("h.{}.attn.c_attn.weight").chunk(3, dim=2)
    bq, bk, bv = stack("h.{}.attn.c_attn.bias").chunk(3, dim=1)
    blocks = {
        "ln1_scale": T(stack("h.{}.ln_1.weight")),
        "ln1_bias": T(stack("h.{}.ln_1.bias")),
        "wq": T(wq), "bq": T(bq), "wk": T(wk), "bk": T(bk), "wv": T(wv), "bv": T(bv),
        "wo": T(stack("h.{}.attn.c_proj.weight")),
        "bo": T(stack("h.{}.attn.c_proj.bias")),
        "ln2_scale": T(stack("h.{}.ln_2.weight")),
        "ln2_bias": T(stack("h.{}.ln_2.bias")),
        "w_up": T(stack("h.{}.mlp.c_fc.weight")),
        "b_up": T(stack("h.{}.mlp.c_fc.bias")),
        "w_gate": None, "b_gate": None,
        "w_down": T(stack("h.{}.mlp.c_proj.weight")),
        "b_down": T(stack("h.{}.mlp.c_proj.bias")),
    }
    return {
        "tok_embed": T(g("wte.weight")),
        "pos_embed": T(g("wpe.weight")),
        "blocks": blocks,
        "final_scale": T(g("ln_f.weight")),
        "final_bias": T(g("ln_f.bias")),
        "lm_head": None,  # GPT-2 ties lm_head to wte
    }


def load_model(
    name: str,
    *,
    dtype=torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
    torch_model=None,
    spec: Optional[ModelSpec] = None,
    seed: int = 0,
):
    """Load a model by preset name (random init from ``seed``) or from an
    in-memory HF GPT-2 module. Returns ``(spec, params)`` on ``device``."""
    dev = resolve_device(device)
    if torch_model is not None:
        if spec is None:
            spec = spec_from_hf_config(torch_model.config, name=name)
        return spec, convert_gpt2(state_dict_from_torch(torch_model), spec, dtype=dtype,
                                  device=dev)
    spec = spec or get_spec(name)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return spec, init_params(spec, generator, dtype=dtype, device=dev)
