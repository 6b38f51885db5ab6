"""The long-context slice against the JAX package, on the CPU: HF config
specs, RoPE near position 32,767, and a small Mistral-shaped model whose
prefill runs on K10's route.

K10's route is forced by lowering the port's ``KV_VMEM_BUDGET`` (the port's
module only): a cache or a sequence longer than the JAX package's 1024-key
tile then streams K/V, as Mistral-7B-Instruct-v0.2's 32,768-slot cache does
at the default budget. The JAX reference runs its dense attention: the
function is the same whichever kernel computes it. Weights come from the
JAX package's ``init_params`` through ``from_jax_params``, ids from numpy;
in fp32 the two packages differ by summation order only (atol = rtol =
1e-4), and greedy ids are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import Impl as JaxImpl
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models import rope_cos_sin as jax_rope_cos_sin
from mlio_tpu.models import spec_from_hf_config as jax_spec_from_hf_config
from mlio_tpu.runtime import generate as jax_generate
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu_torch.models import Impl, forward, from_jax_params, rope_cos_sin
from mlio_tpu_torch.models import spec_from_hf_config
from mlio_tpu_torch.ops import flash_attention as fa
from mlio_tpu_torch.runtime import generate, init_cache, next_token_loss, trainable

TOL = dict(atol=1e-4, rtol=1e-4)

# The published config.json of Mistral-7B-Instruct-v0.2.
MISTRAL_V02 = dict(model_type="mistral", hidden_size=4096, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
                   vocab_size=32000, max_position_embeddings=32768, rope_theta=1000000.0,
                   rms_norm_eps=1e-05, sliding_window=None, tie_word_embeddings=False)
CONFIGS = {
    "mistral_v0.2": MISTRAL_V02,
    "llama3_8b": dict(model_type="llama", hidden_size=4096, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
                      vocab_size=128256, max_position_embeddings=8192, rope_theta=500000.0,
                      rms_norm_eps=1e-05, tie_word_embeddings=False),
    "qwen2_7b": dict(model_type="qwen2", hidden_size=3584, num_hidden_layers=28,
                     num_attention_heads=28, num_key_value_heads=4, intermediate_size=18944,
                     vocab_size=152064, max_position_embeddings=32768, rope_theta=1000000.0,
                     rms_norm_eps=1e-06, tie_word_embeddings=False),
    "llama_defaults": dict(model_type="llama", hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=128, vocab_size=100),
}
# Mistral's shape at a test's size: 2 layers, 4/2 heads of 64, theta 1e6.
TINY = dict(MISTRAL_V02, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=512, vocab_size=512)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spec_from_hf_config_matches_jax(name):
    got = dataclasses.asdict(spec_from_hf_config(CONFIGS[name], name=name))
    want = dataclasses.asdict(jax_spec_from_hf_config(CONFIGS[name], name=name))
    assert got == want


def test_rope_tables_near_32k_match_jax():
    """cos/sin at positions 32,700-32,767, theta 1e6, head dim 128. The two
    inverse-frequency tables differ by one fp32 ulp in one entry (their
    powers round apart), which at a position near 32,767 moves an angle by
    about 1e-6: atol 1e-5."""
    pos = np.arange(32700, 32768)[None].repeat(2, 0)
    jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    cos, sin = rope_cos_sin(torch.from_numpy(pos), 128, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5, rtol=0)


def _tiny(dtype=jnp.float32):
    jspec = jax_spec_from_hf_config(TINY, name="mistral-tiny")
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=dtype)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, spec_from_hf_config(TINY, name="mistral-tiny"), params


@pytest.fixture
def k10_route(monkeypatch):
    """The port's K10 route forced; counts the plain version's calls."""
    monkeypatch.setattr(fa, "KV_VMEM_BUDGET", 0)
    calls = [0]
    real = fa.flash_stream_plain

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_stream_plain", counted)
    return calls


def test_generate_on_k10_route_matches_jax(k10_route):
    """A 1280-slot cache (past the 1024-key tile): the cached prefill of
    both layers streams K/V; greedy ids and the prefill logits against the
    JAX package's."""
    jspec, jparams, spec, params = _tiny()
    ids = np.random.default_rng(0).integers(0, spec.vocab_size, (2, 40)).astype(np.int32)
    cache_len, new = 1280, 8
    want = jax_generate(jparams, jspec, jnp.asarray(ids), max_new_tokens=new, impl=JaxImpl(),
                        cache_len=cache_len)
    impl = Impl(attention="flash", norm="fused")
    got = generate(params, spec, torch.from_numpy(ids), max_new_tokens=new, impl=impl,
                   cache_len=cache_len, device="cpu")
    assert k10_route[0] == spec.num_layers  # the prefill; the decode takes its own kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlogits, _ = jax_forward(jparams, jspec, jnp.asarray(ids), impl=JaxImpl(),
                             cache=jax_init_cache(jspec, 2, cache_len, dtype=jnp.float32))
    logits, _ = forward(params, spec, torch.from_numpy(ids).long(), impl=impl,
                        cache=init_cache(spec, 2, cache_len, dtype=torch.float32, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_cache_free_grads_on_k10_route_match_jax(k10_route):
    """The cache-free forward over 1,100 tokens (past the tile) runs
    ``flash_attention_diff`` with K10's route forward: the next-token loss
    and every gradient against ``jax.value_and_grad``."""
    jspec, jparams, spec, params = _tiny()
    ids = np.random.default_rng(1).integers(0, spec.vocab_size, (1, 1101)).astype(np.int32)

    def jloss(p, ids):
        logits, _ = jax_forward(p, jspec, ids[:, :-1], impl=JaxImpl())
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.mean(jnp.take_along_axis(logp, ids[:, 1:, None], -1))

    want, jgrads = jax.value_and_grad(jloss)(jparams, jnp.asarray(ids))
    leaves = trainable(params)
    loss = next_token_loss(params, spec, torch.from_numpy(ids).long(),
                           impl=Impl(attention="flash"))
    loss.backward()
    assert k10_route[0] == spec.num_layers
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    checked = 0
    for key, leaf in params["blocks"].items():
        if leaf is not None:
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jgrads["blocks"][key]),
                                       err_msg=key, **TOL)
            checked += 1
    for key in ("tok_embed", "final_scale", "lm_head"):
        np.testing.assert_allclose(params[key].grad.numpy(), np.asarray(jgrads[key]),
                                   err_msg=key, **TOL)
        checked += 1
    assert checked == len(leaves)


def test_prefill_logits_keep_jax_dtype():
    """The all-position prefill logits of bf16 weights stay bf16, as the JAX
    package's forward returns them (no fp32 copy of [B, S, V])."""
    jspec, jparams, spec, params = _tiny(jnp.bfloat16)
    ids = np.random.default_rng(2).integers(0, spec.vocab_size, (1, 24)).astype(np.int32)
    jlogits, _ = jax_forward(jparams, jspec, jnp.asarray(ids), impl=JaxImpl(),
                             cache=jax_init_cache(jspec, 1, 64, dtype=jnp.bfloat16))
    logits, _ = forward(params, spec, torch.from_numpy(ids).long(),
                        impl=Impl(attention="flash", norm="fused"),
                        cache=init_cache(spec, 1, 64, dtype=torch.bfloat16, device="cpu"))
    assert jlogits.dtype == jnp.bfloat16 and logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == tuple(jlogits.shape) == (1, 24, spec.vocab_size)
