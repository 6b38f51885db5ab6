"""The port's decode megakernel module (K4) and its routing against the JAX package.

The same weights (the JAX package's ``init_params`` through
``from_jax_params``) and the same numpy-seeded inputs go to the JAX
``decode_layer_stack``, run in Pallas interpret mode on the CPU as the JAX
tests run it, and to the port's wrapper on CPU tensors, which runs
``decode_layer_stack_plain``. Both compute in fp32 and differ by summation
order only: atol = rtol = 1e-4, token ids equal.
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
from mlio_tpu.models.transformer import rope_cos_sin as jax_rope_cos_sin
from mlio_tpu.ops.decode_layer import decode_layer_stack as jax_decode_layer_stack
from mlio_tpu.ops.decode_layer import supports_decode_stack as jax_supports_decode_stack
from mlio_tpu.runtime import greedy_generate as jax_greedy_generate
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu_torch.models import Impl, forward, from_jax_params, get_spec, rope_cos_sin
from mlio_tpu_torch.ops import decode_attention as da
from mlio_tpu_torch.ops import decode_layer as dl
from mlio_tpu_torch.runtime import greedy_generate, init_cache

TOL = dict(atol=1e-4, rtol=1e-4)
# gpt2-tiny with kv_dim 128: the spec on which the JAX package itself takes
# the multi-step route (tests/test_decode_epilogue.py)
KV128 = dataclasses.replace(JAX_PRESETS["gpt2-tiny"], name="gpt2-kv128", hidden_size=128,
                            num_heads=2, num_kv_heads=2, intermediate_size=256)


def _spec_pair(name):
    if name == "gpt2-kv128":
        from mlio_tpu_torch.models.spec import ModelSpec

        return KV128, ModelSpec(**dataclasses.asdict(KV128))
    return JAX_PRESETS[name], get_spec(name)


def _both(name):
    """(JAX spec, JAX params, port spec, port params) with the same weights."""
    jspec, spec = _spec_pair(name)
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jspec, jparams, spec, from_jax_params(jax.tree.map(np.asarray, jparams),
                                                 device="cpu")


def _inputs(spec, B, Smax, seed):
    """Seeded x [B, H] and a filled cache [L, B, Smax, Hkv, D]."""
    rng = np.random.default_rng(seed)
    shape = (spec.num_layers, B, Smax, spec.num_kv_heads, spec.head_size)
    x = rng.standard_normal((B, spec.hidden_size)).astype(np.float32)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    return x, kc, vc


def _rope(spec, pos, n):
    """(JAX cos, sin, port cos, sin) [n, rope_dim], or Nones for learned positions."""
    if spec.positional == "learned":
        return None, None, None, None
    jc, js = jax_rope_cos_sin(pos + jnp.arange(n), spec.rope_dim, spec.rope_theta, jnp.float32)
    tc, ts = rope_cos_sin(torch.arange(pos, pos + n), spec.rope_dim, spec.rope_theta)
    return jc, js, tc, ts


def _flat(a):
    return jnp.asarray(a.reshape(*a.shape[:3], -1))


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_single_step_matches_jax(name):
    jspec, jparams, spec, params = _both(name)
    B, Smax, pos = 3, 24, 9
    x, kc, vc = _inputs(spec, B, Smax, seed=1)
    jc, js, tc, ts = _rope(spec, pos, 1)
    jx, jk, jv = jax_decode_layer_stack(jnp.asarray(x), jparams["blocks"], _flat(kc), _flat(vc),
                                        pos, jc, js, spec=jspec, interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, tokens = dl.decode_layer_stack(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc, ts,
                                        spec=spec)
    assert tokens is None
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tk.reshape(jk.shape).numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.reshape(jv.shape).numpy(), np.asarray(jv), **TOL)
    # only slot pos was written
    untouched = np.ones(Smax, bool)
    untouched[pos] = False
    np.testing.assert_array_equal(tk.numpy()[:, :, untouched], kc[:, :, untouched])


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_forward_decode_auto_matches_jax_mega(name):
    """forward with one new token and the default decode_stack: the mega
    branch in both packages (the mirror of tests/test_decode_layer.py:26)."""
    jspec, jparams, spec, params = _both(name)
    B, prompt, cache_len = 2, 7, 16
    ids = np.random.default_rng(2).integers(0, spec.vocab_size, (B, prompt + 3)).astype(np.int32)
    jimpl, timpl = JaxImpl(attention="flash"), Impl(attention="flash")
    jcache = jax_init_cache(jspec, B, cache_len, dtype=jnp.float32)
    cache = init_cache(spec, B, cache_len, dtype=torch.float32, device="cpu")
    chunks = [ids[:, :prompt]] + [ids[:, prompt + i:prompt + i + 1] for i in range(3)]
    for chunk in chunks:
        want, jcache = jax_forward(jparams, jspec, jnp.asarray(chunk), impl=jimpl, cache=jcache)
        got, cache = forward(params, spec, torch.from_numpy(chunk), impl=timpl, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]).reshape(cache["k"].shape),
                               **TOL)
    assert cache["pos"] == int(jcache["pos"]) == prompt + 3


# (model, lm_head bias scale): the tied head of gpt2-tiny with and without
# a bias, the untied head of llama-tiny
EPILOGUE_CASES = {"gpt2_tied": ("gpt2-tiny", None), "gpt2_tied_bias": ("gpt2-tiny", 5.0),
                  "llama_untied": ("llama-tiny", None), "llama_untied_bias": ("llama-tiny", 5.0)}


@pytest.mark.parametrize("case", list(EPILOGUE_CASES), ids=list(EPILOGUE_CASES))
def test_greedy_epilogue_matches_jax(case):
    """The fused epilogue (the mirror of tests/test_decode_epilogue.py:38, :72):
    the JAX kernel streams the vocabulary in 128-row chunks; tokens equal."""
    name, bias_scale = EPILOGUE_CASES[case]
    jspec, jparams, spec, params = _both(name)
    B, Smax, pos = 4, 16, 6
    x, kc, vc = _inputs(spec, B, Smax, seed=3)
    x *= 0.05
    tied = params["lm_head"] is None
    bias = None
    if bias_scale is not None:
        bias = np.random.default_rng(4).standard_normal(spec.vocab_size).astype(np.float32)
        bias *= bias_scale
    pe = jparams["pos_embed"]
    jc, js, tc, ts = _rope(spec, pos, 1)
    jout = jax_decode_layer_stack(
        jnp.asarray(x), jparams["blocks"], _flat(kc), _flat(vc), pos, jc, js, spec=jspec,
        interpret=True, head_norm=(jparams["final_scale"], jparams["final_bias"]),
        lm_head=jparams["tok_embed"] if tied else jparams["lm_head"],
        lm_head_bias=None if bias is None else jnp.asarray(bias), lm_vmajor=tied,
        vocab_chunk=128, pos_embed=pe)
    got, tokens = dl.decode_layer_stack(
        torch.from_numpy(x), params["blocks"], torch.from_numpy(kc), torch.from_numpy(vc), pos,
        tc, ts, spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
        lm_head=params["tok_embed"] if tied else params["lm_head"],
        lm_head_bias=None if bias is None else torch.from_numpy(bias), lm_vmajor=tied,
        pos_embed=params["pos_embed"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jout[0]), **TOL)
    assert tokens.shape == (B,) and tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jout[-1][:, 0]))


def test_multi_step_matches_jax_on_kv128():
    """steps > 1 on the spec where the JAX package takes the multi-step route
    (combined in-place cache, learned positions added in the kernel)."""
    jspec, jparams, spec, params = _both("gpt2-kv128")
    B, Smax, pos, T = 2, 32, 11, 4
    _, kc, vc = _inputs(spec, B, Smax, seed=5)
    tok = np.array([3, 5], np.int32)
    kv = jnp.concatenate([_flat(kc), _flat(vc)], axis=-1)
    jout = jax_decode_layer_stack(
        jparams["tok_embed"][jnp.asarray(tok)], jparams["blocks"], kv, None, pos, None, None,
        spec=jspec, interpret=True, head_norm=(jparams["final_scale"], jparams["final_bias"]),
        lm_head=jparams["tok_embed"], lm_vmajor=True, vocab_chunk=128, kv_combined=True,
        pos_embed=jparams["pos_embed"], steps=T)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, tokens = dl.decode_layer_stack(
        params["tok_embed"][torch.from_numpy(tok)], params["blocks"], tk, tv, pos, spec=spec,
        head_norm=(params["final_scale"], params["final_bias"]), lm_head=params["tok_embed"],
        pos_embed=params["pos_embed"], steps=T)
    assert tokens.shape == (T, B)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jout[-1][:, :, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout[0]), **TOL)
    kvd = spec.kv_dim
    np.testing.assert_allclose(tk.reshape(*kc.shape[:3], kvd).numpy(),
                               np.asarray(jout[1][..., :kvd]), **TOL)
    np.testing.assert_allclose(tv.reshape(*vc.shape[:3], kvd).numpy(),
                               np.asarray(jout[1][..., kvd:]), **TOL)


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny", "gpt2-kv128"])
def test_greedy_generate_default_impl_matches_jax(name):
    """greedy_generate with Impl(attention="flash") and decode_stack "auto":
    the JAX package routes gpt2-tiny and llama-tiny through its per-token
    epilogue and gpt2-kv128 through its multi-step launch; the port takes
    the multi-step launch for every tied head. Ids equal."""
    jspec, jparams, spec, params = _both(name)
    ids = np.random.default_rng(6).integers(0, spec.vocab_size, (2, 5)).astype(np.int32)
    want = jax_greedy_generate(jparams, jspec, jnp.asarray(ids), max_new_tokens=6,
                               impl=JaxImpl(attention="flash"))
    got = greedy_generate(params, spec, torch.from_numpy(ids), max_new_tokens=6,
                          impl=Impl(attention="flash"), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(kwargs.get("steps", 1))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("stack", ["auto", "scan"])
def test_decode_routes_to_k4_or_k3(stack, monkeypatch):
    """"auto" reaches K4's wrapper (one multi-step call in generate, one call
    a token in forward) and never K3's; "scan" reaches K3's a layer a token."""
    _, _, spec, params = _both("gpt2-tiny")
    k4 = _spy(monkeypatch, dl, "decode_layer_stack")
    k3 = _spy(monkeypatch, da, "decode_attention")
    impl = Impl(attention="flash", decode_stack=stack)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 4)))
    greedy_generate(params, spec, ids, max_new_tokens=5, impl=impl, device="cpu")
    cache = init_cache(spec, 2, 8, dtype=torch.float32, device="cpu")
    _, cache = forward(params, spec, ids, impl=impl, cache=cache)
    forward(params, spec, ids[:, :1], impl=impl, cache=cache)
    if stack == "auto":
        assert k4 == [4, 1] and not k3
    else:
        assert not k4 and len(k3) == spec.num_layers * 5


@pytest.mark.parametrize("name,want", [("gpt2-tiny", True), ("llama-tiny", True),
                                       ("neox-tiny", False), ("moe-tiny", False)])
def test_supports_decode_stack(name, want):
    assert dl.supports_decode_stack(get_spec(name)) is want
    assert jax_supports_decode_stack(JAX_PRESETS[name]) is want
    # the JAX package's TPU VMEM rule is not kept: a 7B model takes K4 here
    assert dl.supports_decode_stack(get_spec("llama2-7b"))


def test_wrapper_rejects_bad_calls_and_cpu_launches_nothing():
    _, _, spec, params = _both("gpt2-tiny")
    B, Smax = 2, 8
    x, kc, vc = (torch.from_numpy(a) for a in _inputs(spec, B, Smax, seed=8))
    blocks = params["blocks"]
    head = dict(head_norm=(params["final_scale"], params["final_bias"]))
    with pytest.raises(ValueError, match="outside"):
        dl.decode_layer_stack(x, blocks, kc, vc, Smax - 1, spec=spec, steps=2,
                              lm_head=params["tok_embed"], **head)
    with pytest.raises(ValueError, match="tied"):
        dl.decode_layer_stack(x, blocks, kc, vc, 0, spec=spec, steps=2,
                              lm_head=params["tok_embed"].T, lm_vmajor=False, **head)
    with pytest.raises(ValueError, match="RoPE"):
        dl.decode_layer_stack(x, blocks, kc, vc, 0, torch.ones(1, 16), torch.ones(1, 16),
                              spec=spec)
    with pytest.raises(ValueError, match="head_norm"):
        dl.decode_layer_stack(x, blocks, kc, vc, 0, spec=spec, lm_head=params["tok_embed"])
    with pytest.raises(ValueError, match="not a model K4 runs"):
        dl.decode_layer_stack(x, blocks, kc, vc, 0, spec=get_spec("neox-tiny"))
    before = dl.decode_layer_stack.launches
    dl.decode_layer_stack(x, blocks, kc, vc, 3, spec=spec, lm_head=params["tok_embed"], **head)
    assert dl.decode_layer_stack.launches == before
