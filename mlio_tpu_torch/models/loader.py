"""Model loading: presets, HF configs, HF state dicts of every family the
JAX package converts, and local checkpoint directories
(``mlio_tpu/models/loader.py``).

A preset name random-inits from a seed. An in-memory ``transformers``
model, or a local HF checkpoint directory (``config.json`` beside
``*.safetensors``, or ``pytorch_model*.bin`` / ``*.pt``), is converted once
into the stacked-layer parameter dict: GPT-2, Llama, Mistral, Qwen2 (Q/K/V
biases), Gemma (the ``(1 + w)`` norms folded), GPT-NeoX/Pythia (the fused
per-head QKV unpacked), Phi (one shared LayerNorm, a head bias), OPT (the
position table's +2 offset dropped) and Mixtral (experts stacked on an
expert axis). The config's ``model_type`` picks the converter; without a
config, :data:`model_registry` picks it by name with the JAX package's nine
patterns, else the architecture does. Neither ``transformers``
nor ``safetensors`` is imported: the caller hands over a live model, and
safetensors files are read by :func:`read_safetensors`, the format's own
layout (an 8-byte little-endian header length, a JSON header, raw bytes).
"""
from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec, get_spec
from mlio_tpu_torch.models.transformer import init_params

StateDict = Dict[str, torch.Tensor]
Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# State dicts (offline)
# ---------------------------------------------------------------------------

def state_dict_from_torch(model) -> StateDict:
    """The module's state dict, detached (the model is not kept)."""
    return {k: v.detach() for k, v in model.state_dict().items()}


# The safetensors dtype names and their torch dtypes.
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


def read_safetensors(path: Union[str, Path]) -> StateDict:
    """The tensors of one ``.safetensors`` file, on the CPU in their stored
    dtypes (BF16 as ``torch.bfloat16``): an 8-byte little-endian header
    length n, n bytes of JSON giving each tensor's ``dtype``, ``shape`` and
    ``data_offsets`` (from the end of the header), then the raw bytes,
    little-endian. The file is read once into one buffer that the tensors
    view."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(Path(path).stat().st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"read_safetensors: {path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, which the port does not read")
        dt = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dt)
        else:
            out[name] = torch.frombuffer(data, dtype=dt, offset=start,
                                         count=(end - start) // dt.itemsize).view(info["shape"])
    return out


def state_dict_from_dir(path: Union[str, Path]) -> StateDict:
    """Every weight of a local HF checkpoint directory: its ``*.safetensors``
    files if it has any (:func:`read_safetensors`), else its
    ``pytorch_model*.bin`` and ``*.pt`` files (``torch.load`` with
    ``weights_only=True``), in sorted order."""
    path = Path(path)
    sd: StateDict = {}
    safetensor_files = sorted(path.glob("*.safetensors"))
    if safetensor_files:
        for f in safetensor_files:
            sd.update(read_safetensors(f))
        return sd
    bin_files = sorted(path.glob("pytorch_model*.bin")) + sorted(path.glob("*.pt"))
    if bin_files:
        for f in bin_files:
            loaded = torch.load(f, map_location="cpu", weights_only=True)
            if hasattr(loaded, "state_dict"):
                loaded = loaded.state_dict()
            sd.update(loaded)
        return sd
    raise FileNotFoundError(f"no weights (*.safetensors / pytorch_model*.bin) in {path}")


# ---------------------------------------------------------------------------
# Specs from HF configs
# ---------------------------------------------------------------------------

def spec_from_hf_config(cfg: Any, name: str = "custom") -> ModelSpec:
    """Derive a ModelSpec from an HF config object or dict: the JAX package's
    branches (GPT-2, Mixtral, Llama, Mistral, Qwen2, Gemma, GPT-NeoX, Phi,
    OPT), field for field. ``sliding_window`` is not read, as there."""
    get = (lambda k, d=None: cfg.get(k, d)) if isinstance(cfg, dict) else (
        lambda k, d=None: getattr(cfg, k, d))
    model_type = get("model_type", "gpt2")
    if model_type == "gpt2":
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
    if model_type == "gemma":
        heads = get("num_attention_heads")
        h = get("hidden_size")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"), hidden_size=h,
            num_layers=get("num_hidden_layers"), num_heads=heads,
            num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 8192),
            head_dim=get("head_dim"),
            activation="geglu", norm="rmsnorm",
            norm_eps=get("rms_norm_eps", 1e-6), positional="rope",
            rope_theta=get("rope_theta", 10000.0),
            use_qkv_bias=False, use_mlp_bias=False, use_out_bias=False,
            tie_embeddings=True, embed_scale=float(h) ** 0.5)
    if model_type == "gpt_neox":
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"), num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            activation="gelu", norm="layernorm",
            norm_eps=get("layer_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rotary_emb_base", 10000.0),
            rope_fraction=get("rotary_pct", 0.25),
            use_qkv_bias=True, use_mlp_bias=True, use_out_bias=True,
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            parallel_residual=bool(get("use_parallel_residual", True)))
    if model_type == "phi":
        heads = get("num_attention_heads")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"), num_layers=get("num_hidden_layers"),
            num_heads=heads, num_kv_heads=get("num_key_value_heads") or heads,
            intermediate_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            activation="gelu_new", norm="layernorm",
            norm_eps=get("layer_norm_eps", 1e-5), positional="rope",
            rope_theta=get("rope_theta", 10000.0),
            rope_fraction=get("partial_rotary_factor", 0.5),
            use_qkv_bias=True, use_mlp_bias=True, use_out_bias=True,
            tie_embeddings=False, use_head_bias=True,
            parallel_residual=True, shared_ln=True)
    if model_type == "opt":
        h = get("hidden_size")
        return ModelSpec(
            name=name, vocab_size=get("vocab_size"), hidden_size=h,
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_attention_heads"),
            intermediate_size=get("ffn_dim", 4 * h),
            max_seq_len=get("max_position_embeddings", 2048),
            activation="relu", norm="layernorm", norm_eps=1e-5,
            positional="learned", tie_embeddings=True)
    raise ValueError(f"unsupported HF model_type '{model_type}'")


# ---------------------------------------------------------------------------
# Conversion (per family)
# ---------------------------------------------------------------------------

class _Reader:
    """A family's view of a state dict: keys under ``prefix``, each layer's
    tensors stacked on a leading [L] axis, HF's ``[out, in]`` linear weights
    transposed to ``[in, out]``, every result cast to ``dtype`` and moved,
    contiguous, to ``device``."""

    def __init__(self, sd: StateDict, prefix: str, L: int, dtype, device: Device):
        self.sd, self.prefix, self.L = sd, prefix, L
        self.dtype, self.dev = dtype, resolve_device(device)

    def raw(self, key: str) -> torch.Tensor:
        return torch.as_tensor(self.sd[self.prefix + key])

    def has(self, fmt: str) -> bool:
        return self.prefix + fmt.format(0) in self.sd

    def put(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(device=self.dev, dtype=self.dtype).contiguous()

    def get(self, key: str) -> torch.Tensor:
        return self.put(self.raw(key))

    def vec(self, fmt: str, offset: float = 0.0) -> torch.Tensor:
        """Each layer's vector (a norm's weight with ``offset`` added in
        fp32, Gemma's folded ``1 + w``)."""
        x = torch.stack([self.raw(fmt.format(i)) for i in range(self.L)])
        return self.put(x.float() + offset if offset else x)

    def lin(self, fmt: str) -> torch.Tensor:
        return self.put(torch.stack([self.raw(fmt.format(i)).T for i in range(self.L)]))

    def opt_vec(self, fmt: str) -> Optional[torch.Tensor]:
        return self.vec(fmt) if self.has(fmt) else None

    def head(self, spec: ModelSpec) -> Optional[torch.Tensor]:
        """An untied ``lm_head.weight`` (kept at the state dict's top
        level) as ``[H, V]``; None where the embeddings are tied."""
        if spec.tie_embeddings or "lm_head.weight" not in self.sd:
            return None
        return self.put(torch.as_tensor(self.sd["lm_head.weight"]).T)


def _prefix(sd: StateDict, *candidates: str) -> str:
    return next((p for p in candidates if any(k.startswith(p) for k in sd)), "")


def convert_gpt2(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                 device: Device = "cuda") -> Dict[str, Any]:
    """GPT-2 state dict → parameter dict. HF GPT-2's Conv1D weights are
    already [in, out]; the fused c_attn [H, 3H] is split into q/k/v."""
    r = _Reader(sd, _prefix(sd, "transformer."), spec.num_layers, dtype, device)

    def stack(fmt):
        return torch.stack([r.raw(fmt.format(i)) for i in range(r.L)])

    wq, wk, wv = stack("h.{}.attn.c_attn.weight").chunk(3, dim=2)
    bq, bk, bv = stack("h.{}.attn.c_attn.bias").chunk(3, dim=1)
    blocks = {
        "ln1_scale": r.vec("h.{}.ln_1.weight"), "ln1_bias": r.vec("h.{}.ln_1.bias"),
        "wq": r.put(wq), "bq": r.put(bq), "wk": r.put(wk), "bk": r.put(bk),
        "wv": r.put(wv), "bv": r.put(bv),
        "wo": r.put(stack("h.{}.attn.c_proj.weight")), "bo": r.vec("h.{}.attn.c_proj.bias"),
        "ln2_scale": r.vec("h.{}.ln_2.weight"), "ln2_bias": r.vec("h.{}.ln_2.bias"),
        "w_up": r.put(stack("h.{}.mlp.c_fc.weight")), "b_up": r.vec("h.{}.mlp.c_fc.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": r.put(stack("h.{}.mlp.c_proj.weight")),
        "b_down": r.vec("h.{}.mlp.c_proj.bias"),
    }
    return {
        "tok_embed": r.get("wte.weight"),
        "pos_embed": r.get("wpe.weight"),
        "blocks": blocks,
        "final_scale": r.get("ln_f.weight"),
        "final_bias": r.get("ln_f.bias"),
        "lm_head": None,  # GPT-2 ties lm_head to wte
    }


def _llama_params(sd: StateDict, spec: ModelSpec, dtype, norm_offset: float, device: Device,
                  mlp: bool) -> Dict[str, Any]:
    """The Llama layout (``model.`` prefix): embedding, norms (``+
    norm_offset``), attention with the Q/K/V biases where the state dict has
    them, and, with ``mlp``, the dense gated MLP."""
    r = _Reader(sd, _prefix(sd, "model."), spec.num_layers, dtype, device)
    attn = "layers.{}.self_attn."
    blocks = {
        "ln1_scale": r.vec("layers.{}.input_layernorm.weight", norm_offset), "ln1_bias": None,
        "wq": r.lin(attn + "q_proj.weight"), "bq": r.opt_vec(attn + "q_proj.bias"),
        "wk": r.lin(attn + "k_proj.weight"), "bk": r.opt_vec(attn + "k_proj.bias"),
        "wv": r.lin(attn + "v_proj.weight"), "bv": r.opt_vec(attn + "v_proj.bias"),
        "wo": r.lin(attn + "o_proj.weight"), "bo": None,
        "ln2_scale": r.vec("layers.{}.post_attention_layernorm.weight", norm_offset),
        "ln2_bias": None,
    }
    if mlp:
        blocks.update({
            "w_up": r.lin("layers.{}.mlp.up_proj.weight"), "b_up": None,
            "w_gate": r.lin("layers.{}.mlp.gate_proj.weight"), "b_gate": None,
            "w_down": r.lin("layers.{}.mlp.down_proj.weight"), "b_down": None,
        })
    final = r.raw("norm.weight")
    return {
        "tok_embed": r.get("embed_tokens.weight"),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": r.put(final.float() + norm_offset if norm_offset else final),
        "final_bias": None,
        "lm_head": r.head(spec),
    }


def convert_llama(sd: StateDict, spec: ModelSpec, dtype=torch.float32, norm_offset: float = 0.0,
                  *, device: Device = "cuda") -> Dict[str, Any]:
    """Llama/Mistral/Qwen2/Gemma state dict → parameter dict. HF's ``[out,
    in]`` linear weights are transposed to ``[in, out]`` once here; Q/K/V
    biases (Qwen2) are picked up where present; ``norm_offset=1`` folds
    Gemma's ``(1 + w)`` RMSNorm weights."""
    return _llama_params(sd, spec, dtype, norm_offset, device, mlp=True)


def convert_llama_attention_only(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                                 device: Device = "cuda") -> Dict[str, Any]:
    """The Llama layout's embedding, norms, attention and head, without the
    dense MLP (for MoE models whose other weights are Llama's)."""
    return _llama_params(sd, spec, dtype, 0.0, device, mlp=False)


def convert_mixtral(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                    device: Device = "cuda") -> Dict[str, Any]:
    """Mixtral state dict → parameter dict: Llama attention and a sparse-MoE
    MLP. HF keeps a router ``block_sparse_moe.gate.weight`` [E, h] and each
    expert's ``experts.{e}.w1/w3/w2.weight`` (w1 the SwiGLU gate, w3 the up
    projection, w2 the down one) a layer; they stack to ``router`` [L, h, E],
    ``moe_gate``/``moe_up`` [L, E, h, i] and ``moe_down`` [L, E, i, h]."""
    r = _Reader(sd, _prefix(sd, "model."), spec.num_layers, dtype, device)
    moe = "layers.{}.block_sparse_moe."

    def expert_stack(w):
        return r.put(torch.stack([torch.stack([
            r.raw((moe + "experts.{}.{}.weight").format(i, e, w)).T
            for e in range(spec.num_experts)]) for i in range(r.L)]))

    params = convert_llama_attention_only(sd, spec, dtype, device=device)
    params["blocks"].update({
        "w_up": None, "b_up": None, "w_gate": None, "b_gate": None,
        "w_down": None, "b_down": None,
        "router": r.lin(moe + "gate.weight"),
        "moe_gate": expert_stack("w1"),
        "moe_up": expert_stack("w3"),
        "moe_down": expert_stack("w2"),
    })
    return params


def convert_gemma(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                  device: Device = "cuda") -> Dict[str, Any]:
    """Gemma = the Llama layout with ``(1 + w)`` RMSNorm weights (folded
    here), GeGLU and a sqrt(hidden) embedding scale (a spec field, not a
    weight transform)."""
    return convert_llama(sd, spec, dtype, norm_offset=1.0, device=device)


def convert_gpt_neox(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                     device: Device = "cuda") -> Dict[str, Any]:
    """GPT-NeoX/Pythia state dict → parameter dict: the fused QKV, whose rows
    are ordered ``[heads, (q|k|v), head_dim]``, is unpacked here; parallel
    residual and partial rotary are spec fields."""
    r = _Reader(sd, _prefix(sd, "gpt_neox."), spec.num_layers, dtype, device)
    heads, hd, H = spec.num_heads, spec.head_size, spec.hidden_size
    w = torch.stack([r.raw(f"layers.{i}.attention.query_key_value.weight").reshape(heads, 3, hd, H)
                     for i in range(r.L)])  # [L, heads, 3, hd, H]
    b = torch.stack([r.raw(f"layers.{i}.attention.query_key_value.bias").reshape(heads, 3, hd)
                     for i in range(r.L)])
    proj = [r.put(w[:, :, j].reshape(r.L, heads * hd, H).transpose(1, 2)) for j in range(3)]
    bias = [r.put(b[:, :, j].reshape(r.L, heads * hd)) for j in range(3)]
    blocks = {
        "ln1_scale": r.vec("layers.{}.input_layernorm.weight"),
        "ln1_bias": r.vec("layers.{}.input_layernorm.bias"),
        "wq": proj[0], "bq": bias[0], "wk": proj[1], "bk": bias[1], "wv": proj[2], "bv": bias[2],
        "wo": r.lin("layers.{}.attention.dense.weight"),
        "bo": r.vec("layers.{}.attention.dense.bias"),
        "ln2_scale": r.vec("layers.{}.post_attention_layernorm.weight"),
        "ln2_bias": r.vec("layers.{}.post_attention_layernorm.bias"),
        "w_up": r.lin("layers.{}.mlp.dense_h_to_4h.weight"),
        "b_up": r.vec("layers.{}.mlp.dense_h_to_4h.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": r.lin("layers.{}.mlp.dense_4h_to_h.weight"),
        "b_down": r.vec("layers.{}.mlp.dense_4h_to_h.bias"),
    }
    return {
        "tok_embed": r.get("embed_in.weight"),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": r.get("final_layer_norm.weight"),
        "final_bias": r.get("final_layer_norm.bias"),
        "lm_head": r.put(torch.as_tensor(sd["embed_out.weight"]).T),
    }


def convert_phi(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                device: Device = "cuda") -> Dict[str, Any]:
    """Phi-1/1.5/2 state dict → parameter dict: one shared LayerNorm feeds
    both parallel branches (``spec.shared_ln``; the ln2 slots hold the same
    tensors, which the shared-LN forward does not read); the head carries a
    bias."""
    r = _Reader(sd, _prefix(sd, "model."), spec.num_layers, dtype, device)
    attn = "layers.{}.self_attn."
    ln_scale = r.vec("layers.{}.input_layernorm.weight")
    ln_bias = r.vec("layers.{}.input_layernorm.bias")
    blocks = {
        "ln1_scale": ln_scale, "ln1_bias": ln_bias,
        "wq": r.lin(attn + "q_proj.weight"), "bq": r.vec(attn + "q_proj.bias"),
        "wk": r.lin(attn + "k_proj.weight"), "bk": r.vec(attn + "k_proj.bias"),
        "wv": r.lin(attn + "v_proj.weight"), "bv": r.vec(attn + "v_proj.bias"),
        "wo": r.lin(attn + "dense.weight"), "bo": r.vec(attn + "dense.bias"),
        "ln2_scale": ln_scale, "ln2_bias": ln_bias,
        "w_up": r.lin("layers.{}.mlp.fc1.weight"), "b_up": r.vec("layers.{}.mlp.fc1.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": r.lin("layers.{}.mlp.fc2.weight"), "b_down": r.vec("layers.{}.mlp.fc2.bias"),
    }
    return {
        "tok_embed": r.get("embed_tokens.weight"),
        "pos_embed": None,
        "blocks": blocks,
        "final_scale": r.get("final_layernorm.weight"),
        "final_bias": r.get("final_layernorm.bias"),
        "lm_head": r.put(torch.as_tensor(sd["lm_head.weight"]).T),
        "lm_head_bias": r.put(torch.as_tensor(sd["lm_head.bias"])),
    }


def convert_opt(sd: StateDict, spec: ModelSpec, dtype=torch.float32, *,
                device: Device = "cuda") -> Dict[str, Any]:
    """OPT state dict → parameter dict. The learned position table's +2
    offset (OPTLearnedPositionalEmbedding) is folded by dropping its first
    two rows. Pre-LN variants only (``do_layer_norm_before=True``)."""
    r = _Reader(sd, _prefix(sd, "model.decoder.", "decoder."), spec.num_layers, dtype, device)
    attn = "layers.{}.self_attn."
    blocks = {
        "ln1_scale": r.vec("layers.{}.self_attn_layer_norm.weight"),
        "ln1_bias": r.vec("layers.{}.self_attn_layer_norm.bias"),
        "wq": r.lin(attn + "q_proj.weight"), "bq": r.vec(attn + "q_proj.bias"),
        "wk": r.lin(attn + "k_proj.weight"), "bk": r.vec(attn + "k_proj.bias"),
        "wv": r.lin(attn + "v_proj.weight"), "bv": r.vec(attn + "v_proj.bias"),
        "wo": r.lin(attn + "out_proj.weight"), "bo": r.vec(attn + "out_proj.bias"),
        "ln2_scale": r.vec("layers.{}.final_layer_norm.weight"),
        "ln2_bias": r.vec("layers.{}.final_layer_norm.bias"),
        "w_up": r.lin("layers.{}.fc1.weight"), "b_up": r.vec("layers.{}.fc1.bias"),
        "w_gate": None, "b_gate": None,
        "w_down": r.lin("layers.{}.fc2.weight"), "b_down": r.vec("layers.{}.fc2.bias"),
    }
    return {
        "tok_embed": r.get("embed_tokens.weight"),
        "pos_embed": r.put(r.raw("embed_positions.weight")[2:]),
        "blocks": blocks,
        "final_scale": r.get("final_layer_norm.weight"),
        "final_bias": r.get("final_layer_norm.bias"),
        "lm_head": None,  # tied
    }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class ModelRegistry:
    """Regex patterns mapping model names to converters, tried in the order
    they were registered."""

    def __init__(self):
        self._entries = []  # (pattern, converter)

    def register(self, pattern: str, converter: Callable):
        self._entries.append((re.compile(pattern), converter))

    def get_converter(self, name: str) -> Callable:
        for pattern, conv in self._entries:
            if pattern.match(name):
                return conv
        raise KeyError(f"no converter registered for model '{name}'")


model_registry = ModelRegistry()
model_registry.register(r"gpt2.*", convert_gpt2)
model_registry.register(r".*mixtral.*", convert_mixtral)
model_registry.register(r".*llama.*", convert_llama)
model_registry.register(r".*mistral.*", convert_llama)
model_registry.register(r".*qwen.*", convert_llama)
model_registry.register(r".*gemma.*", convert_gemma)
model_registry.register(r".*(neox|pythia).*", convert_gpt_neox)
model_registry.register(r".*phi.*", convert_phi)
model_registry.register(r".*opt.*", convert_opt)


#: The converter of each HF ``model_type`` that :func:`spec_from_hf_config`
#: reads.
CONVERTERS = {"gpt2": convert_gpt2, "mixtral": convert_mixtral, "llama": convert_llama,
              "mistral": convert_llama, "qwen2": convert_llama, "gemma": convert_gemma,
              "gpt_neox": convert_gpt_neox, "phi": convert_phi, "opt": convert_opt}


def converter_for(name: str, spec: ModelSpec, model_type: Optional[str] = None) -> Callable:
    """The converter of an HF config's ``model_type`` where there is one
    (:data:`CONVERTERS`; a type it lacks raises ``ValueError``), else the
    registry's for the whole ``name``, else the JAX package's fallback on
    the architecture: learned positions are the GPT-2 layout, anything else
    the Llama one.

    The JAX package picks by name only, so a checkpoint whose path names no
    family (``.../snapshots/<sha>``) or names another one would convert by
    the wrong layout there; a Gemma then loads without its ``(1 + w)`` norm
    fold."""
    if model_type is not None:
        if model_type not in CONVERTERS:
            raise ValueError(f"unsupported HF model_type '{model_type}'")
        return CONVERTERS[model_type]
    try:
        return model_registry.get_converter(name)
    except KeyError:
        return convert_gpt2 if spec.positional == "learned" else convert_llama


def load_model(
    name_or_path: str,
    *,
    dtype=torch.bfloat16,
    device: Device = "cuda",
    torch_model=None,
    spec: Optional[ModelSpec] = None,
    seed: int = 0,
):
    """Load a model by preset name (random init from ``seed``), from an
    in-memory HF module (``torch_model``, its config read for the spec) or
    from a local HF checkpoint directory (its ``config.json`` and weights,
    :func:`state_dict_from_dir`). Returns ``(spec, params)`` on ``device``.

    The converter comes from the config's ``model_type`` where a config is
    at hand (the module's, or the directory's ``config.json``), else from
    :data:`model_registry` by the whole ``name_or_path``, else by
    architecture (:func:`converter_for`)."""
    dev = resolve_device(device)
    path = Path(name_or_path)
    if torch_model is not None:
        sd = state_dict_from_torch(torch_model)
        cfg = torch_model.config
    elif path.is_dir():
        sd = state_dict_from_dir(path)
        cfg_file = path / "config.json"
        if not cfg_file.exists() and spec is None:
            raise FileNotFoundError(f"no config.json in {path}; pass spec=")
        cfg = json.loads(cfg_file.read_text()) if cfg_file.exists() else None
    else:
        spec = spec or get_spec(name_or_path)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return spec, init_params(spec, generator, dtype=dtype, device=dev)
    if spec is None:
        spec = spec_from_hf_config(cfg, name=path.name if torch_model is None else name_or_path)
    model_type = None if cfg is None else (
        cfg.get("model_type", "gpt2") if isinstance(cfg, dict)
        else getattr(cfg, "model_type", "gpt2"))
    converter = converter_for(name_or_path, spec, model_type)
    return spec, converter(sd, spec, dtype=dtype, device=dev)
