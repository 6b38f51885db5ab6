"""The port's model path against the JAX package, on the CPU in fp32.

Weights come from the JAX package's ``init_params`` and reach the port
through ``from_jax_params``; token ids come from ``numpy.random.default_rng``.
The JAX kernels run in Pallas interpret mode (automatic off TPU), the port's
wrappers run their plain versions on CPU tensors. Logits differ by fp32
summation order only: atol = rtol = 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import Impl as JaxImpl
from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models import load_model as jax_load_model
from mlio_tpu.runtime import greedy_generate as jax_greedy_generate
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu_torch.models import PRESETS, Impl, forward, from_jax_params, get_spec, load_model
from mlio_tpu_torch.ops.decode_layer import decode_layer_stack
from mlio_tpu_torch.runtime import greedy_generate, init_cache

TOL = dict(atol=1e-4, rtol=1e-4)
MODELS = ["gpt2-tiny", "llama-tiny"]
IMPLS = {
    "kernels": dict(attention="flash", norm="fused", decode_stack="scan"),
    "dense": dict(),
}


def _both(name):
    """(JAX spec, JAX params, port spec, port params) with the same weights."""
    jspec = JAX_PRESETS[name]
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, get_spec(name), params


def _ids(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def test_presets_match_jax_field_by_field():
    assert set(PRESETS) == set(JAX_PRESETS)
    for name, spec in PRESETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(JAX_PRESETS[name]), name
        assert spec.head_size == JAX_PRESETS[name].head_size
        assert spec.num_params() == JAX_PRESETS[name].num_params()


def test_impl_keeps_jax_fields():
    assert [f.name for f in dataclasses.fields(Impl)] == \
        [f.name for f in dataclasses.fields(JaxImpl)]


@pytest.mark.parametrize("name", MODELS)
def test_from_jax_params_round_trip(name):
    jspec, jparams, spec, params = _both(name)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams, is_leaf=lambda x: x is None)[0]
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        if leaf is None:
            assert node is None, path
        else:
            assert node.dtype == torch.float32 and tuple(node.shape) == leaf.shape
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert set(params) == set(jparams) and set(params["blocks"]) == set(jparams["blocks"])
    bf16 = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu", dtype=torch.bfloat16)
    assert bf16["tok_embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", MODELS)
def test_forward_without_cache_matches_jax(name, impl):
    jspec, jparams, spec, params = _both(name)
    ids = _ids(spec.vocab_size, (2, 11))
    want, _ = jax_forward(jparams, jspec, jnp.asarray(ids), impl=JaxImpl(**IMPLS[impl]))
    got, cache = forward(params, spec, torch.from_numpy(ids), impl=Impl(**IMPLS[impl]))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", MODELS)
def test_forward_with_cache_prefill_then_decode_matches_jax(name, impl):
    jspec, jparams, spec, params = _both(name)
    B, prompt, steps, cache_len = 2, 7, 3, 16
    ids = _ids(spec.vocab_size, (B, prompt + steps), seed=1)
    jimpl, timpl = JaxImpl(**IMPLS[impl]), Impl(**IMPLS[impl])
    jcache = jax_init_cache(jspec, B, cache_len, dtype=jnp.float32)
    cache = init_cache(spec, B, cache_len, dtype=torch.float32, device="cpu")
    chunks = [ids[:, :prompt]] + [ids[:, prompt + i:prompt + i + 1] for i in range(steps)]
    for chunk in chunks:
        want, jcache = jax_forward(jparams, jspec, jnp.asarray(chunk), impl=jimpl, cache=jcache)
        got, cache = forward(params, spec, torch.from_numpy(chunk), impl=timpl, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert cache["pos"] == int(jcache["pos"])
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_greedy_generate_ids_equal_jax(name):
    jspec, jparams, spec, params = _both(name)
    ids = _ids(spec.vocab_size, (2, 8), seed=2)
    kernels = IMPLS["kernels"]
    want = jax_greedy_generate(jparams, jspec, jnp.asarray(ids), max_new_tokens=6,
                               impl=JaxImpl(**kernels))
    got = greedy_generate(params, spec, torch.from_numpy(ids), max_new_tokens=6,
                          impl=Impl(**kernels), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _small_gpt2_torch():
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    cfg = GPT2Config(vocab_size=257, n_positions=64, n_embd=48, n_layer=3, n_head=4,
                     resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return GPT2LMHeadModel(cfg).eval()


def test_convert_gpt2_equals_jax_loader():
    model = _small_gpt2_torch()
    jspec, jparams = jax_load_model("gpt2", torch_model=model, dtype=jnp.float32)
    spec, params = load_model("gpt2", torch_model=model, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams, is_leaf=lambda x: x is None)[0]
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        if leaf is None:
            assert node is None, path
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    ids = _ids(257, (2, 9), seed=3)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids).long()).logits
    got, _ = forward(params, spec, torch.from_numpy(ids), impl=Impl(**IMPLS["kernels"]))
    # fp32 through 3 layers against HF's own ops, as tests/test_model_parity.py
    np.testing.assert_allclose(got.numpy(), hf.numpy(), rtol=1e-3, atol=2e-3)


def test_unported_paths_raise():
    spec = get_spec("gpt2-tiny")
    _, params = load_model("gpt2-tiny", dtype=torch.float32, device="cpu")
    cache = init_cache(spec, 1, 8, dtype=torch.float32, device="cpu")
    _, cache = forward(params, spec, torch.zeros(1, 2, dtype=torch.long), cache=cache)
    tok = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="K6"):
        forward(params, spec, tok, cache=dict(cache),
                impl=Impl(attention="flash", decode_stack="tiled"))
    # "mega" runs (K4 is ported) but its INT8 KV and int8 weight paths do not
    logits, _ = forward(params, spec, tok, cache=dict(cache),
                        impl=Impl(attention="flash", decode_stack="mega"))
    assert logits.shape == (1, 1, spec.vocab_size)
    x = torch.zeros(1, spec.hidden_size)
    scales = torch.ones(*cache["k"].shape[:4])
    with pytest.raises(NotImplementedError, match="quantization"):
        decode_layer_stack(x, params["blocks"], cache["k"], cache["v"], 2, spec=spec,
                           k_scales=scales, v_scales=scales)
    int8_blocks = dict(params["blocks"], wq=params["blocks"]["wq"].to(torch.int8))
    with pytest.raises(NotImplementedError, match="quantization"):
        decode_layer_stack(x, int8_blocks, cache["k"], cache["v"], 2, spec=spec)
    # the fused MLP (K11) and fused norm+QKV (K12) are ported; an INT8 KV cache is not
    logits, _ = forward(params, spec, torch.zeros(1, 2, dtype=torch.long),
                        impl=Impl(mlp="fused", fused_ln_qkv=True))
    assert logits.shape == (1, 2, spec.vocab_size)
    from mlio_tpu_torch.runtime import generate

    with pytest.raises(NotImplementedError, match="int8 decode"):
        generate(params, spec, tok, max_new_tokens=2, device="cpu", cache_quant="int8")
    with pytest.raises(NotImplementedError, match="MoE"):
        load_model("moe-tiny", dtype=torch.float32, device="cpu")
