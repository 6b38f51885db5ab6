"""The port's runtime (cache, sampling) against the JAX package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.runtime import cache_memory_bytes as jax_cache_memory_bytes
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu.runtime import sample as jax_sample
from mlio_tpu.runtime.sampling import SamplingMethod as JaxSamplingMethod
from mlio_tpu.runtime.sampling import _filtered_logits as jax_filtered_logits
from mlio_tpu_torch.models import get_spec
from mlio_tpu_torch.runtime import SamplingMethod, cache_memory_bytes, init_cache, sample
from mlio_tpu_torch.runtime.sampling import _filtered_logits

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_init_cache_matches_jax(name, dtypes):
    jdtype, tdtype = dtypes
    jcache = jax_init_cache(JAX_PRESETS[name], 3, 24, dtype=jdtype)
    cache = init_cache(get_spec(name), 3, 24, dtype=tdtype, device="cpu")
    assert set(cache) == set(jcache)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape
        assert cache[key].dtype == tdtype and not cache[key].any()
    assert cache["pos"] == int(jcache["pos"]) == 0
    assert cache_memory_bytes(get_spec(name), 3, 24, tdtype) == \
        jax_cache_memory_bytes(JAX_PRESETS[name], 3, 24, jdtype)


def test_init_cache_int8_not_ported():
    """The INT8 cache is ported now: int8 K/V and ones for the fp32 scales,
    as the JAX package allocates them, and the scales in the byte count."""
    spec = get_spec("gpt2-tiny")
    jcache = jax_init_cache(JAX_PRESETS["gpt2-tiny"], 2, 8, quant="int8")
    cache = init_cache(spec, 2, 8, quant="int8", device="cpu")
    assert set(cache) == set(jcache)
    for key in ("k", "v", "k_scale", "v_scale"):
        assert tuple(cache[key].shape) == jcache[key].shape
        assert str(cache[key].dtype).split(".")[-1] == str(jcache[key].dtype)
        np.testing.assert_array_equal(cache[key].numpy(), np.asarray(jcache[key]))
    assert cache_memory_bytes(spec, 2, 8, quant="int8") == sum(
        cache[k].numel() * cache[k].element_size() for k in ("k", "v", "k_scale", "v_scale"))


def _logits(seed=0, shape=(4, 50)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3


def test_sample_greedy_matches_jax():
    logits = _logits()
    want = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0), JaxSamplingMethod())
    got = sample(torch.from_numpy(logits), None, SamplingMethod())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


METHODS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(temperature=1.0, top_k=5),
    "top_p": dict(temperature=0.9, top_p=0.8),
    "top_k_top_p": dict(temperature=1.3, top_k=10, top_p=0.6),
}


@pytest.mark.parametrize("method", list(METHODS), ids=list(METHODS))
def test_filtered_logits_match_jax(method):
    logits = _logits(seed=1)
    want = np.asarray(jax_filtered_logits(jnp.asarray(logits),
                                          JaxSamplingMethod(**METHODS[method])))
    got = _filtered_logits(torch.from_numpy(logits), SamplingMethod(**METHODS[method])).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    kept = np.isfinite(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)


def test_sample_draws_only_from_the_filtered_support():
    logits = torch.from_numpy(_logits(seed=2, shape=(64, 50)))
    generator = torch.Generator().manual_seed(0)
    tokens = sample(logits, generator, SamplingMethod(temperature=1.0, top_k=3))
    top3 = logits.topk(3, dim=-1).indices
    assert (top3 == tokens[:, None]).any(dim=-1).all()
    again = sample(logits, torch.Generator().manual_seed(0),
                   SamplingMethod(temperature=1.0, top_k=3))
    assert torch.equal(tokens, again)
