"""The port's HF loaders of every family against the JAX package's, on the
CPU in fp32.

HF models of each family are built offline from small configs (those of
``tests/test_model_families.py``, with Llama and Mistral beside them) with
random init. For each: ``spec_from_hf_config`` field for field against the
JAX package's; every converted parameter of ``load_model(torch_model=)``
against the JAX package's, as numpy, exactly (both cast the same fp32
weights); the port's logits against the JAX package's (atol = rtol = 1e-4,
fp32 summation order) and against HF's own (rtol 1e-3, atol 5e-3, 8e-3 for
Gemma: ``tests/test_model_families.py``'s limits). A checkpoint directory
written by ``save_pretrained`` (safetensors and ``.bin``) loads to the
same bits as the live module; a bf16 safetensors file loads as bf16; the
registry picks the JAX package's converter for each name.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import load_model as jax_load_model
from mlio_tpu.models import loader as jax_loader
from mlio_tpu_torch.models import Impl, forward, load_model, read_safetensors
from mlio_tpu_torch.models import loader

VOCAB = 257
TOL = dict(atol=1e-4, rtol=1e-4)


def _config(family):
    """(name, HF model class, config) of a family's tiny model."""
    import transformers as tf

    common = dict(vocab_size=VOCAB, max_position_embeddings=64)
    if family == "llama":
        return "llama-test", tf.LlamaForCausalLM, tf.LlamaConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False, **common)
    if family == "mistral":
        # sliding_window is not read (the JAX package's fault, ROADMAP.md §3):
        # None here, so HF attends over every key as both packages do
        return "mistral-test", tf.MistralForCausalLM, tf.MistralConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, sliding_window=None, tie_word_embeddings=False, **common)
    if family == "qwen2":
        return "qwen2-test", tf.Qwen2ForCausalLM, tf.Qwen2Config(
            hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False, attention_dropout=0.0, **common)
    if family == "gemma":
        return "gemma-test", tf.GemmaForCausalLM, tf.GemmaConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, head_dim=12, attention_dropout=0.0, **common)
    if family.startswith("neox"):
        return "pythia-test", tf.GPTNeoXForCausalLM, tf.GPTNeoXConfig(
            hidden_size=48, intermediate_size=192, num_hidden_layers=3, num_attention_heads=4,
            rotary_pct=0.25, use_parallel_residual=family == "neox_parallel",
            hidden_act="gelu", attention_dropout=0.0, hidden_dropout=0.0, **common)
    if family == "phi":
        return "phi-test", tf.PhiForCausalLM, tf.PhiConfig(
            hidden_size=48, intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
            partial_rotary_factor=0.5, attention_dropout=0.0, embd_pdrop=0.0, resid_pdrop=0.0,
            **common)
    assert family == "opt"
    return "opt-test", tf.OPTForCausalLM, tf.OPTConfig(
        hidden_size=48, ffn_dim=192, num_hidden_layers=3, num_attention_heads=4,
        do_layer_norm_before=True, dropout=0.0, attention_dropout=0.0, word_embed_proj_dim=48,
        **common)


FAMILIES = ["llama", "mistral", "qwen2", "gemma", "neox_parallel", "neox_sequential", "phi",
            "opt"]
_MODELS = {}


def _model(family):
    """(name, HF module) of the family, built once from seed 0."""
    if family not in _MODELS:
        name, cls, cfg = _config(family)
        torch.manual_seed(0)
        _MODELS[family] = name, cls(cfg).eval()
    return _MODELS[family]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_same_params(got, want):
    """Every leaf of ``want`` (numpy or torch) equal, bit for bit, to
    ``got``'s; None where it is None; no leaf of got missing from want."""
    want = dict(_leaves(want))
    assert set(dict(_leaves(got))) == set(want)
    for path, g in _leaves(got):
        w = want[path]
        if w is None:
            assert g is None, path
            continue
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == torch.float32, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(2, 13))


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_from_hf_config_matches_jax(family):
    name, model = _model(family)
    cfg = model.config
    want = dataclasses.asdict(jax_loader.spec_from_hf_config(cfg, name=name))
    assert dataclasses.asdict(loader.spec_from_hf_config(cfg, name=name)) == want
    # the config as config.json holds it (a dict) gives the same spec
    as_dict = json.loads(cfg.to_json_string())
    assert dataclasses.asdict(loader.spec_from_hf_config(as_dict, name=name)) == want


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_params_equal_jax(family):
    name, model = _model(family)
    jspec, jparams = jax_load_model(name, torch_model=model, dtype=jnp.float32)
    spec, params = load_model(name, torch_model=model, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    _assert_same_params(params, jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax_and_hf(family):
    name, model = _model(family)
    jspec, jparams = jax_load_model(name, torch_model=model, dtype=jnp.float32)
    spec, params = load_model(name, torch_model=model, dtype=torch.float32, device="cpu")
    ids = _ids()
    got, _ = forward(params, spec, torch.from_numpy(ids),
                     impl=Impl(attention="flash", norm="fused"))
    want, _ = jax_forward(jparams, jspec, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids)).logits
    np.testing.assert_allclose(got.numpy(), hf.numpy(), rtol=1e-3,
                               atol=8e-3 if family == "gemma" else 5e-3)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_load_dir_equals_torch_model(family, safe, tmp_path):
    """save_pretrained's directory (config.json and model.safetensors or
    pytorch_model.bin) loads to the live module's parameters, bit for bit,
    by its config.json's model_type."""
    name, model = _model(family)
    path = tmp_path / name
    model.save_pretrained(path, safe_serialization=safe)
    assert any(path.glob("*.safetensors")) == safe
    spec, params = load_model(str(path), dtype=torch.float32, device="cpu")
    want_spec, want = load_model(name, torch_model=model, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(want_spec)
    _assert_same_params(params, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_load_dir_by_config_not_name(family, tmp_path):
    """A directory whose path names no family, as HF's cache lays one out
    (``models--org--name/snapshots/<sha>``), converts by its config.json's
    model_type: a Gemma keeps its (1 + w) norm fold. Under the JAX
    package's rule (the registry over the path, else the architecture) this
    path would take the Llama converter."""
    name, model = _model(family)
    path = tmp_path / "snapshots" / "3f2a9c"
    model.save_pretrained(path)
    with pytest.raises(KeyError):
        jax_loader.model_registry.get_converter("snapshots/3f2a9c")
    spec, params = load_model(str(path), dtype=torch.float32, device="cpu")
    _, want = load_model(name, torch_model=model, dtype=torch.float32, device="cpu")
    assert spec.name == "3f2a9c"
    _assert_same_params(params, want)


def test_bf16_safetensors_load_as_bf16(tmp_path):
    """A bf16 checkpoint's tensors read as torch.bfloat16 (numpy has no
    bfloat16), bit for bit, and convert to bf16 parameters without a
    rounding; a sharded checkpoint reads every file."""
    from safetensors.torch import save_file

    name, model = _model("gemma")
    sd = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    keys = sorted(sd)
    path = tmp_path / name
    path.mkdir()
    for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
        save_file({k: sd[k] for k in part}, path / f"model-0000{i + 1}-of-00002.safetensors")
    (path / "config.json").write_text(model.config.to_json_string())
    got = loader.state_dict_from_dir(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], v), k
    spec, params = load_model(str(path), dtype=torch.bfloat16, device="cpu")
    emb = params["tok_embed"]
    assert emb.dtype == torch.bfloat16 and torch.equal(emb, sd["model.embed_tokens.weight"])
    # Gemma's (1 + w) fold, taken in fp32 and rounded once
    want = (sd["model.norm.weight"].float() + 1).to(torch.bfloat16)
    assert torch.equal(params["final_scale"], want)


def test_read_safetensors_every_dtype(tmp_path):
    from safetensors.torch import save_file

    tensors = {"u8": torch.arange(5, dtype=torch.uint8),
               "f64": torch.randn(3, dtype=torch.float64),
               "bf16": torch.randn(2, 3).to(torch.bfloat16),
               "i32": torch.arange(6).int().view(2, 3), "f16": torch.randn(4).half(),
               "empty": torch.zeros(0, 4), "b": torch.tensor([True, False, True])}
    save_file(tensors, tmp_path / "x.safetensors")
    got = read_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


NAMES = ["gpt2", "gpt2-medium", "mixtral-8x7b", "llama3-8b", "Meta-Llama-3-8B", "mistral-7b",
         "qwen2-7b", "Qwen2-0.5B", "gemma-7b", "gemma-test", "pythia-1.4b", "gpt-neox-20b",
         "phi-2", "opt-1.3b", "facebook-opt-125m", "custom"]


@pytest.mark.parametrize("name", NAMES)
def test_registry_picks_the_jax_converter(name):
    try:
        want = jax_loader.model_registry.get_converter(name).__name__
    except KeyError:
        want = None
    try:
        got = loader.model_registry.get_converter(name).__name__
    except KeyError:
        got = None
    assert got == want


def test_unknown_name_falls_back_on_architecture():
    """No config and no pattern: learned positions take the GPT-2 converter,
    the rest the Llama one (the JAX package's fallback). With a config, its
    model_type decides whatever the name says, and a type with no converter
    raises."""
    from mlio_tpu_torch.models import get_spec

    assert loader.converter_for("custom", get_spec("gpt2-tiny")) is loader.convert_gpt2
    assert loader.converter_for("custom", get_spec("llama-tiny")) is loader.convert_llama
    assert loader.converter_for("custom", get_spec("llama-tiny"), "gemma") is loader.convert_gemma
    assert loader.converter_for("opt-1.3b", get_spec("llama-tiny"), "phi") is loader.convert_phi
    with pytest.raises(ValueError, match="unsupported HF model_type"):
        loader.converter_for("custom", get_spec("llama-tiny"), "bert")
    with pytest.raises(ValueError, match="unsupported HF model_type"):
        loader.spec_from_hf_config({"model_type": "bert"})
