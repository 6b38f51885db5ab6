"""Model loading: presets, HF configs, and HF GPT-2 and Mixtral conversion
(``mlio_tpu/models/loader.py``).

A preset name random-inits from a seed; an in-memory ``transformers`` GPT-2
or Mixtral model is converted once into the stacked-layer parameter dict
(Mixtral's experts stacked on an expert axis). :func:`spec_from_hf_config`
also reads Llama, Mistral and Qwen2 configs. ``transformers`` is never
imported here: the caller hands over the model. The Llama and other family
converters, and loading a checkpoint directory, are not ported yet
(ROADMAP.md, queue 1, item 3).
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
    """Derive a ModelSpec from an HF GPT-2, Mixtral, Llama, Mistral or Qwen2
    config object or dict (the JAX package's branches for these families;
    ``sliding_window`` is not read, as there)."""
    get = (lambda k, d=None: cfg.get(k, d)) if isinstance(cfg, dict) else (
        lambda k, d=None: getattr(cfg, k, d))
    model_type = get("model_type", "gpt2")
    if model_type == "mixtral":
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"), num_heads=heads,
            num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 8192),
            activation="swiglu", norm="rmsnorm", norm_eps=get("rms_norm_eps", 1e-5),
            positional="rope", rope_theta=get("rope_theta", 1000000.0),
            use_qkv_bias=False, use_mlp_bias=False, use_out_bias=False,
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            num_experts=get("num_local_experts", 8),
            num_experts_per_tok=get("num_experts_per_tok", 2))
    if model_type in ("llama", "mistral", "qwen2"):
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"), num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 4096),
            activation="swiglu", norm="rmsnorm",
            norm_eps=get("rms_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rope_theta", 10000.0),
            # Qwen2 carries biases on Q/K/V only
            use_qkv_bias=(model_type == "qwen2"),
            use_mlp_bias=False, use_out_bias=False,
            tie_embeddings=bool(get("tie_word_embeddings", False)))
    if model_type != "gpt2":
        raise NotImplementedError(
            f"HF model_type {model_type!r} is not ported yet; the port reads GPT-2, Mixtral, "
            "Llama, Mistral and Qwen2 configs")
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


def convert_llama_attention_only(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                                 device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The Llama layout's embedding, norms, attention and head, without the
    dense MLP (for MoE models whose other weights are Llama's). HF's
    ``[out, in]`` linear weights are transposed to ``[in, out]``."""
    dev = resolve_device(device)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    L = spec.num_layers

    def g(key):
        return torch.as_tensor(sd[prefix + key])

    def T(x):
        return x.to(device=dev, dtype=dtype).contiguous()

    def lin(fmt):
        return T(torch.stack([g(fmt.format(i)).T for i in range(L)]))

    def ln(fmt):
        return T(torch.stack([g(fmt.format(i)) for i in range(L)]))

    blocks = {
        "ln1_scale": ln("layers.{}.input_layernorm.weight"), "ln1_bias": None,
        "wq": lin("layers.{}.self_attn.q_proj.weight"), "bq": None,
        "wk": lin("layers.{}.self_attn.k_proj.weight"), "bk": None,
        "wv": lin("layers.{}.self_attn.v_proj.weight"), "bv": None,
        "wo": lin("layers.{}.self_attn.o_proj.weight"), "bo": None,
        "ln2_scale": ln("layers.{}.post_attention_layernorm.weight"), "ln2_bias": None,
    }
    lm_head = (None if spec.tie_embeddings or "lm_head.weight" not in sd
               else T(torch.as_tensor(sd["lm_head.weight"]).T))
    return {
        "tok_embed": T(g("embed_tokens.weight")),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": T(g("norm.weight")),
        "final_bias": None,
        "lm_head": lm_head,
    }


def convert_mixtral(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                    device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Mixtral state dict → parameter dict: Llama attention and a sparse-MoE
    MLP. HF keeps a router ``block_sparse_moe.gate.weight`` [E, h] and each
    expert's ``experts.{e}.w1/w3/w2.weight`` (w1 the SwiGLU gate, w3 the up
    projection, w2 the down one) a layer; they stack to ``router`` [L, h, E],
    ``moe_gate``/``moe_up`` [L, E, h, i] and ``moe_down`` [L, E, i, h]."""
    dev = resolve_device(device)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    L, E = spec.num_layers, spec.num_experts

    def g(key):
        return torch.as_tensor(sd[prefix + key])

    def T(x):
        return x.to(device=dev, dtype=dtype).contiguous()

    def expert_stack(w):
        return T(torch.stack([torch.stack([
            g(f"layers.{i}.block_sparse_moe.experts.{e}.{w}.weight").T for e in range(E)])
            for i in range(L)]))

    params = convert_llama_attention_only(sd, spec, dtype, device=dev)
    params["blocks"].update({
        "w_up": None, "b_up": None, "w_gate": None, "b_gate": None,
        "w_down": None, "b_down": None,
        "router": T(torch.stack([g(f"layers.{i}.block_sparse_moe.gate.weight").T
                                 for i in range(L)])),
        "moe_gate": expert_stack("w1"),
        "moe_up": expert_stack("w3"),
        "moe_down": expert_stack("w2"),
    })
    return params


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
    in-memory HF GPT-2 or Mixtral module. Returns ``(spec, params)`` on
    ``device``."""
    dev = resolve_device(device)
    if torch_model is not None:
        model_type = getattr(torch_model.config, "model_type", "gpt2")
        if model_type not in ("gpt2", "mixtral"):
            raise NotImplementedError(
                f"load_model: the {model_type!r} converter is not ported yet; the port "
                "converts GPT-2 and Mixtral")
        if spec is None:
            spec = spec_from_hf_config(torch_model.config, name=name)
        convert = convert_mixtral if spec.num_experts else convert_gpt2
        return spec, convert(state_dict_from_torch(torch_model), spec, dtype=dtype, device=dev)
    spec = spec or get_spec(name)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return spec, init_params(spec, generator, dtype=dtype, device=dev)
