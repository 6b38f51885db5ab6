"""Head dims 80 (Phi-2) and 256 (Gemma): the plain versions of K1, K3 and
K6 against the JAX kernels at those head dims, and the routes that refuse
the instances the card does not build.

The same numpy inputs go to the JAX kernels, run in Pallas interpret mode
on the CPU as the JAX tests run them, and to the port's wrappers on CPU
tensors, which run the plain versions: fp32 on both sides, so they differ
by summation order only (atol = rtol = 1e-4, ``tests/test_torch_ops.py``'s
and ``tests/test_torch_decode_tiled.py``'s limit). On the card K1 runs both
head dims without dropout or the lse, K3 both at one query head a KV head
over a bf16 cache, K6 head dim 256 at up to 4 query heads a KV head over
bf16 weights and cache; every other instance at these head dims raises a
``ValueError`` naming ROADMAP.md A4 before any launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models.transformer import rope_cos_sin as jax_rope_cos_sin
from mlio_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from mlio_tpu.ops.decode_tiled import Tiling as JaxTiling
from mlio_tpu.ops.decode_tiled import decode_layer_tiled as jax_decode_layer_tiled
from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu_torch.models import Impl, from_jax_params, get_spec, rope_cos_sin
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import decode_route
from mlio_tpu_torch.ops import decode_attention as da
from mlio_tpu_torch.ops import decode_layer as dl
from mlio_tpu_torch.ops import decode_tiled as dt
from mlio_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-4, rtol=1e-4)
HEAD_DIMS = [80, 256]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (Hq, Hkv, Sq, Skv, causal, q_offset, kv_len): a causal prefill into a
# longer cache past one 64-row tile, a grouped decode-style call, a full one
FLASH_CASES = {
    "causal_prefill_past_tile": (2, 2, 70, 96, True, 0, [70, 41]),
    "causal_gqa_offset_ragged": (4, 2, 5, 32, True, 11, [16, 13]),
    "full_ragged": (2, 1, 7, 32, False, 0, [32, 7]),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_attention_matches_jax(D, case):
    Hq, Hkv, Sq, Skv, causal, q_offset, kv_len = FLASH_CASES[case]
    rng = np.random.default_rng(D)
    B = 2
    q, k, v = _randn(rng, B, Sq, Hq, D), _randn(rng, B, Skv, Hkv, D), _randn(rng, B, Skv, Hkv, D)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_offset=q_offset, kv_len=jnp.asarray(kv_len, jnp.int32),
                               interpret=True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, q_offset=q_offset, kv_len=torch.tensor(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_decode_attention_matches_jax(D, layer):
    rng = np.random.default_rng(D + layer)
    L, B, Smax, Hkv = 2, 4, 48, 2
    q = _randn(rng, B, Hkv, D)
    kc, vc = _randn(rng, L, B, Smax, Hkv, D), _randn(rng, L, B, Smax, Hkv, D)
    ctx = np.array([1, Smax, 17, 0], np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(ctx), layer=layer, interpret=True)
    got = da.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                              torch.from_numpy(ctx), layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[3].any(), "a sequence with no valid slot gives 0"


# Gemma's layout at a narrow width: head dim 256, GeGLU, RMSNorm, 2 layers;
# 1 and 2 query heads a KV head
GEMMA_NARROW = {
    "g1": dataclasses.replace(JAX_PRESETS["llama-tiny"], name="gemma-narrow", hidden_size=128,
                              num_heads=2, num_kv_heads=2, head_dim=256, intermediate_size=256,
                              activation="geglu", norm_eps=1e-6, vocab_size=512),
    "g2": dataclasses.replace(JAX_PRESETS["llama-tiny"], name="gemma-narrow-g2", hidden_size=128,
                              num_heads=4, num_kv_heads=2, head_dim=256, intermediate_size=256,
                              activation="geglu", norm_eps=1e-6, vocab_size=512),
}


@pytest.mark.parametrize("name", list(GEMMA_NARROW))
def test_decode_layer_tiled_plain_d256_matches_jax(name):
    """decode_layer_tiled_plain at head dim 256 against the JAX _tiled_kernel
    (interpret) at the same tiling: x_out and the slot written at every
    layer; no other slot changes."""
    jspec = GEMMA_NARROW[name]
    spec = ModelSpec(**dataclasses.asdict(jspec))
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    B, Smax, pos = 2, 64, 37
    rng = np.random.default_rng(7)
    shape = (spec.num_layers, B, Smax, spec.num_kv_heads, spec.head_size)
    x = _randn(rng, B, spec.hidden_size)
    kc, vc = _randn(rng, *shape), _randn(rng, *shape)
    jc, js = jax_rope_cos_sin(pos + jnp.arange(1), spec.rope_dim, spec.rope_theta, jnp.float32)
    tc, ts = rope_cos_sin(torch.arange(pos, pos + 1), spec.rope_dim, spec.rope_theta)
    tiling = JaxTiling(hg=spec.num_heads, ic=128, ka=1, km=2)
    flat = (lambda a: jnp.asarray(a.reshape(spec.num_layers, B, Smax, -1)))
    out = jax_decode_layer_tiled(jnp.asarray(x), jparams["blocks"], flat(kc), flat(vc), pos, jc,
                                 js, spec=jspec, tiling=tiling, interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = dt.decode_layer_tiled_plain(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc, ts,
                                      spec=spec, tiling=dt.Tiling(*tiling[:4]))
    np.testing.assert_allclose(got.numpy(), np.asarray(out[0]), **TOL)
    rest = np.ones(Smax, bool)
    rest[pos] = False
    for i, (t, orig) in enumerate(((tk, kc), (tv, vc))):
        np.testing.assert_allclose(t.numpy(), np.asarray(out[1 + i]).reshape(t.shape), **TOL)
        np.testing.assert_array_equal(t.numpy()[:, :, rest], orig[:, :, rest])


@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_k3_block_step_and_split_plan(D):
    """K3's split at the KV heads of each head dim's model (GPT-2: 12,
    phi-2: 32, llama3-8b: 8, gemma-7b: 16): a chunk a multiple of TOKEN_STEP, which the kernel
    asserts its block step divides at every head dim (csrc/decode_attn.cuh);
    the plan covers the cache with at most MAX_SPLIT chunks, none wholly
    past it."""
    Hkv = {64: 12, 80: 32, 128: 8, 256: 16}[D]
    for B, Smax in ((8, 1024), (1, 2048), (8, 100), (1, 32768)):
        n_split, chunk = da.split_plan(B, Hkv, Smax)
        assert chunk % da.TOKEN_STEP == 0 and 1 <= n_split <= da.MAX_SPLIT
        assert n_split * chunk >= Smax and (n_split - 1) * chunk < Smax


def test_routes_of_the_new_head_dims():
    """gemma-7b decodes on K6 (bf16, G 1), phi-2 through the scan (parallel
    residual: K3), on the card's route check as on the CPU."""
    impl = Impl(attention="flash", norm="fused")
    for on_card in (True, False):
        assert decode_route(get_spec("gemma-7b"), impl, None, 8, smax=1024,
                            on_card=on_card) == "tiled"
        assert decode_route(get_spec("phi-2"), impl, None, 8, smax=1024,
                            on_card=on_card) == "scan"
    assert dt.kernel_limit(get_spec("gemma-7b"), 8) is None


@pytest.mark.parametrize("what", ["k6_int8_cache", "k6_int8_weights", "k6_group_8", "k6_d80",
                                  "k4_d256", "k4_d80"])
def test_instances_not_built_raise_on_the_card_route(what):
    """The card's route check (on_card=True) refuses the instances not built
    at these head dims with a ValueError naming ROADMAP.md A4, where the
    CPU's plain versions take them."""
    gemma, phi = get_spec("gemma-7b"), get_spec("phi-2")
    sequential_phi = dataclasses.replace(phi, parallel_residual=False, shared_ln=False)
    stack, spec, quant, isz = {
        "k6_int8_cache": ("tiled", gemma, True, 2),
        "k6_int8_weights": ("tiled", gemma, False, 1),
        "k6_group_8": ("tiled", dataclasses.replace(gemma, num_heads=16, num_kv_heads=2), False,
                       2),
        "k6_d80": ("tiled", sequential_phi, False, 2),
        "k4_d256": ("mega", dataclasses.replace(gemma, intermediate_size=3072), False, 2),
        "k4_d80": ("mega", sequential_phi, False, 2),
    }[what]
    if stack == "tiled":
        assert "ROADMAP.md A4" in dt.kernel_limit(spec, 8, quant, isz)
    else:
        assert "ROADMAP.md A4" in dl.kernel_limit(spec, 8)
    if isz == 2:
        impl = Impl(attention="flash", decode_stack=stack)
        with pytest.raises(ValueError, match="ROADMAP.md A4"):
            decode_route(spec, impl, None, 8, cache_quant=quant, smax=1024, on_card=True)
        decode_route(spec, impl, None, 8, cache_quant=quant, smax=1024, on_card=False)


def test_head_dim_errors_name_the_roadmap():
    for what, D in (("flash_attention_kvq", 80), ("flash_attention_stream", 256)):
        err = fa.head_dim_error(what, D)
        assert isinstance(err, ValueError) and "ROADMAP.md A4" in str(err) and str(D) in str(err)
    assert fa.K1_ONLY_HEAD_DIMS == da.FP32_ONLY_HEAD_DIMS == (80, 256) and dt.D256 == 256


@pytest.mark.parametrize("D", [80, 256])
def test_k1_options_not_built_at_the_new_head_dims(D):
    """K1's instance at D 80 and 256 takes the causal/kv_len call alone: a
    user mask, the lse or dropout raise on the card, each with a message
    that names what does run there; an INT8 cache (K9) has no instance at
    these head dims; the built call and D 64/128 raise nothing."""
    base = dict(quant=False, lse=False, dropout=False, mask=False)
    assert fa.k1_instance_error("flash_attention", D, **base) is None
    for option in ("mask", "lse", "dropout"):
        err = fa.k1_instance_error("flash_attention", D, **{**base, option: True})
        assert isinstance(err, ValueError) and "ROADMAP.md A4" in str(err)
        assert f"head dim {D} runs without a user mask, the lse or dropout only" in str(err)
    err = fa.k1_instance_error("flash_attention_kvq", D, **{**base, "quant": True})
    assert f"head dim {D} not in (64, 128)" in str(err)
    for built in (64, 128):
        assert fa.k1_instance_error("flash_attention", built, quant=True, lse=True,
                                    dropout=True, mask=True) is None
    assert "head dim 96 not in (64, 128)" in str(fa.k1_instance_error("flash_attention", 96,
                                                                       **base))
