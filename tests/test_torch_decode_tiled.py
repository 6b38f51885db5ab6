"""The port's tiled decode megakernel module (K6) and the decode routing
against the JAX package.

The same weights (the JAX package's ``init_params``, quantized by its
``quantize_params`` where asked, through ``from_jax_params``) and the same
numpy-seeded inputs go to the JAX ``decode_layer_tiled``, run in Pallas
interpret mode on the CPU as the JAX tests run it, and to the port's
``decode_layer_tiled_plain`` at the same tiling. Both compute in fp32 and
differ by summation order only: atol = rtol = 1e-4, the tolerance of
``tests/test_decode_tiled.py``; an INT8 cache's written ints within one step
and its scales within 1e-4. Every geometry here keeps H, a head group's
query width and the intermediate chunk multiples of 8, where the JAX
wrapper's ``npw`` choice is defined (``mlio_tpu/ops/decode_tiled.py:1021``).

The routing cases (fault F1): the decode route and the engine's backend see
the batch and the kernels' shape limits before any launch.
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
from mlio_tpu.ops.decode_tiled import Tiling as JaxTiling
from mlio_tpu.ops.decode_tiled import choose_tiling as jax_choose_tiling
from mlio_tpu.ops.decode_tiled import decode_layer_tiled as jax_decode_layer_tiled
from mlio_tpu.ops.decode_tiled import pad_scales_for_tiled, unpad_scales_from_tiled
from mlio_tpu.ops.decode_tiled import supports_decode_tiled as jax_supports_decode_tiled
from mlio_tpu.ops.quant import quantize_kv as jax_quantize_kv
from mlio_tpu.runtime import generate as jax_generate
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu.runtime.quantization import quantize_params as jax_quantize_params
from mlio_tpu.runtime.sampling import SamplingMethod as JaxSamplingMethod
from mlio_tpu_torch.models import Impl, forward, from_jax_cache, from_jax_params, get_spec
from mlio_tpu_torch.models import rope_cos_sin
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import decode_route
from mlio_tpu_torch.ops import decode_tiled as dt
from mlio_tpu_torch.ops.moe import topk_mask as moe_topk_mask
from mlio_tpu_torch.ops.quant import QTensor
from mlio_tpu_torch.runtime import InferenceEngine, SamplingMethod, generate

TOL = dict(atol=1e-4, rtol=1e-4)
# test_tiled_multiphase_with_edge_masking's spec: 2 head groups of 2 query
# heads and 1 KV head, two MLP chunks of 256 over an intermediate of 384
EDGE = dataclasses.replace(JAX_PRESETS["llama-tiny"], name="tile-test", intermediate_size=384)
EDGE_TILING = JaxTiling(hg=2, ic=256, ka=2, km=2)
# test_generate_routes_big_model_through_tiled's spec: its layers pass the
# JAX package's VMEM gate and the port's K4-or-K6 rule alike
MIDSIZE = dataclasses.replace(JAX_PRESETS["llama-tiny"], name="midsize", hidden_size=2048,
                              num_heads=16, num_kv_heads=16, intermediate_size=8192,
                              num_layers=2, vocab_size=512)
_models = {}


def _np(t):
    return np.array(t)


def _model(jspec, weights=None):
    """(JAX params, port spec, port params): the same fp32 weights."""
    key = (jspec.name, weights)
    if key not in _models:
        jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
        if weights is not None:
            jparams = jax_quantize_params(jparams, jspec, weights)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        _models[key] = jparams, ModelSpec(**dataclasses.asdict(jspec)), params
    return _models[key]


def _inputs(spec, B, Smax, pos, seed, kv8):
    """Seeded x [B, H], a filled cache (INT8 by the JAX quantize_kv where
    kv8) and the RoPE tables of ``pos`` for both packages."""
    rng = np.random.default_rng(seed)
    shape = (spec.num_layers, B, Smax, spec.num_kv_heads, spec.head_size)
    x = rng.standard_normal((B, spec.hidden_size)).astype(np.float32)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ks = vs = None
    if kv8:
        (kc, ks), (vc, vs) = ((_np(q), _np(s)) for q, s in (jax_quantize_kv(jnp.asarray(kc)),
                                                            jax_quantize_kv(jnp.asarray(vc))))
    rope = (None,) * 4
    if spec.positional != "learned":
        rope = (*jax_rope_cos_sin(pos + jnp.arange(1), spec.rope_dim, spec.rope_theta,
                                  jnp.float32),
                *rope_cos_sin(torch.arange(pos, pos + 1), spec.rope_dim, spec.rope_theta))
    return x, kc, vc, ks, vs, rope


# name: (JAX spec, weights, INT8 cache, JAX tiling or None for its choose_tiling)
CASES = {
    "gpt2_tiny": (JAX_PRESETS["gpt2-tiny"], None, False, None),
    "llama_tiny_gqa_rope": (JAX_PRESETS["llama-tiny"], None, False, None),
    "multiphase_edge_masked": (EDGE, None, False, EDGE_TILING),
    "int8_weights": (JAX_PRESETS["llama-tiny"], "int8", False, None),
    "fp8_weights": (JAX_PRESETS["llama-tiny"], "fp8", False, None),
    "int8_kv_cache": (JAX_PRESETS["llama-tiny"], None, True, None),
    "int8_weights_int8_kv_edge": (EDGE, "int8", True, EDGE_TILING),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_matches_jax_tiled_kernel(case):
    """decode_layer_tiled_plain against the JAX _tiled_kernel (interpret) at
    the same tiling: x_out and every written slot (an INT8 cache: ints within
    one step, scales within 1e-4); no other slot changes."""
    jspec, weights, kv8, jtiling = CASES[case]
    jparams, spec, params = _model(jspec, weights)
    B, Smax, pos = 2, 128, 37
    x, kc, vc, ks, vs, (jc, js, tc, ts) = _inputs(spec, B, Smax, pos, 11, kv8)
    if jtiling is None:
        jtiling = jax_choose_tiling(jspec, B, 1 if weights else 4, 1 if kv8 else 4,
                                    weight_fmt=weights)
    L, Hkv = spec.num_layers, spec.num_kv_heads
    flat = (lambda a: jnp.asarray(a.reshape(L, B, Smax, -1)))
    jkw = {}
    if kv8:
        jkw = dict(k_scales=pad_scales_for_tiled(jnp.asarray(ks), Hkv, jtiling.ka),
                   v_scales=pad_scales_for_tiled(jnp.asarray(vs), Hkv, jtiling.ka))
    out = jax_decode_layer_tiled(jnp.asarray(x), jparams["blocks"], flat(kc), flat(vc), pos, jc,
                                 js, spec=jspec, tiling=jtiling, interpret=True, **jkw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    kw = dict(k_scales=torch.from_numpy(ks.copy()), v_scales=torch.from_numpy(vs.copy())) \
        if kv8 else {}
    got = dt.decode_layer_tiled_plain(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc, ts,
                                      spec=spec, tiling=dt.Tiling(*jtiling[:4]), **kw)
    np.testing.assert_allclose(got.numpy(), _np(out[0]), **TOL)
    rest = np.ones(Smax, bool)
    rest[pos] = False
    for i, (t, orig) in enumerate(((tk, kc), (tv, vc))):
        jt = _np(out[1 + i]).reshape(t.shape)
        if kv8:
            assert np.abs(t.numpy().astype(np.int32) - jt.astype(np.int32)).max() <= 1
            sc = kw["k_scales" if i == 0 else "v_scales"]
            np.testing.assert_allclose(sc.numpy(), _np(unpad_scales_from_tiled(out[3 + i], Hkv)),
                                       atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(t.numpy(), jt, **TOL)
        np.testing.assert_array_equal(t.numpy()[:, :, rest], orig[:, :, rest])


@pytest.mark.parametrize("case", ["multiphase_edge_masked", "int8_weights_int8_kv_edge"])
def test_plain_does_not_depend_on_the_tiling(case):
    """The plain version at the JAX tiling and at Hopper's (one KV head a
    group, 16-column chunks with a ragged last one) agree to fp32 rounding,
    and the wrapper on CPU tensors runs it at choose_tiling's."""
    jspec, weights, kv8, _ = CASES[case]
    _, spec, params = _model(jspec, weights)
    B, Smax, pos = 3, 128, 90
    x, kc, vc, ks, vs, (_, _, tc, ts) = _inputs(spec, B, Smax, pos, 12, kv8)
    outs = []
    for tiling in (dt.Tiling(*EDGE_TILING[:4]), dt.Tiling(hg=4, ic=80, ka=1, km=5),
                   dt.choose_tiling(spec, B)):
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        kw = dict(k_scales=torch.from_numpy(ks.copy()), v_scales=torch.from_numpy(vs.copy())) \
            if kv8 else {}
        outs.append((dt.decode_layer_tiled_plain(torch.from_numpy(x), params["blocks"], tk, tv,
                                                 pos, tc, ts, spec=spec, tiling=tiling, **kw),
                     tk, tv))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    kw = dict(k_scales=torch.from_numpy(ks.copy()), v_scales=torch.from_numpy(vs.copy())) \
        if kv8 else {}
    before = dt.decode_layer_tiled.launches
    outs.append((dt.decode_layer_tiled(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc, ts,
                                       spec=spec, **kw), tk, tv))
    assert dt.decode_layer_tiled.launches == before  # the CPU launches nothing
    for got, gk, gv in outs[1:]:
        np.testing.assert_allclose(got.numpy(), outs[0][0].numpy(), atol=1e-5, rtol=1e-5)
        for a, b in ((gk, outs[0][1]), (gv, outs[0][2])):
            if kv8:
                assert (a.int() - b.int()).abs().max() <= 1
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_forward_tiled_matches_jax_over_steps(name):
    """forward with decode_stack="tiled" against the JAX forward's tiled
    route over 3 steps from the same prefilled cache: logits and caches."""
    jspec = JAX_PRESETS[name]
    jparams, spec, params = _model(jspec)
    B, cache_len = 2, 32
    ids = np.random.default_rng(3).integers(0, spec.vocab_size, (B, 6)).astype(np.int32)
    jcache = jax_init_cache(jspec, B, cache_len, dtype=jnp.float32)
    _, jcache = jax_forward(jparams, jspec, jnp.asarray(ids[:, :3]), impl=JaxImpl(), cache=jcache)
    cache = from_jax_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    jimpl = JaxImpl(attention="flash", decode_stack="tiled")
    impl = Impl(attention="flash", decode_stack="tiled")
    for s in range(3, 6):
        tok = ids[:, s:s + 1]
        jl, jcache = jax_forward(jparams, jspec, jnp.asarray(tok), impl=jimpl, cache=jcache)
        tl, cache = forward(params, spec, torch.from_numpy(tok).long(), impl=impl, cache=cache)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        assert cache["pos"] == int(jcache["pos"]) == s + 1
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       _np(jcache[key]).reshape(cache[key].shape), **TOL)


@pytest.mark.parametrize("stack", ["auto", "tiled"])
def test_generate_midsize_matches_jax(stack):
    """generate on the JAX test's midsize spec (its layers take the tiled
    route in both packages): "auto" and "tiled" give the JAX package's
    greedy ids in fp32."""
    jparams, spec, params = _model(MIDSIZE)
    assert decode_route(spec, Impl(attention="flash"), params["blocks"], 1,
                        on_card=False) == "tiled"
    ids = np.asarray([[5, 3, 2, 6]], np.int32)
    want = jax_generate(jparams, MIDSIZE, jnp.asarray(ids), max_new_tokens=4,
                        impl=JaxImpl(attention="flash", decode_stack=stack),
                        method=JaxSamplingMethod(temperature=0.0))
    before = dt.decode_layer_tiled.launches
    got = generate(params, spec, torch.from_numpy(ids), max_new_tokens=4, device="cpu",
                   impl=Impl(attention="flash", decode_stack=stack),
                   method=SamplingMethod(temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert dt.decode_layer_tiled.launches == before


DENSE = ["gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl", "llama2-7b", "llama2-13b",
         "llama2-70b", "llama3-8b", "llama3-70b", "mistral-7b", "qwen2-7b", "opt-1.3b"]


@pytest.mark.parametrize("name", DENSE)
def test_supports_decode_tiled_matches_jax(name):
    """The port's feature conditions against the JAX package's on the dense
    presets, bf16 and INT8 caches, where its VMEM clause does not decide
    (the JAX package finds a tiling); parallel-residual and MoE presets are
    refused by both."""
    spec, jspec = get_spec(name), JAX_PRESETS[name]
    lanes = spec.head_size % 128 and spec.q_dim % 128  # the TPU's lane clause, not kept
    for B, quant in ((8, False), (1, True)):
        if jax_choose_tiling(jspec, B, 2, 1 if quant else 2) is None:
            continue
        jax_ok = jax_supports_decode_tiled(jspec, B, cache_quant=quant, smax=1024)
        assert dt.supports_decode_tiled(spec, B, cache_quant=quant, smax=1024) == (
            jax_ok or bool(lanes))
    assert not dt.supports_decode_tiled(spec, 8, cache_quant=True, smax=1000)
    for other in ("pythia-1.4b", "phi-2", "mixtral-8x7b", "neox-tiny"):
        assert not dt.supports_decode_tiled(get_spec(other))
        assert not jax_supports_decode_tiled(JAX_PRESETS[other])


# ---------------------------------------------------------------------------
# Routing: fault F1 and the K4-or-K6 rule
# ---------------------------------------------------------------------------

def _route(name, B, stack="auto", on_card=True, **spec_kw):
    spec = dataclasses.replace(get_spec(name), **spec_kw) if spec_kw else get_spec(name)
    return decode_route(spec, Impl(attention="flash", decode_stack=stack), None, B,
                        on_card=on_card)


@pytest.mark.parametrize("B,spec_kw,want", [
    (8, {}, "mega"),                                               # the main path stays on K4
    (16, {}, "tiled"),                                             # F1: past K4's batch limit
    (33, {}, "scan"),                                              # past K6's too
    (8, dict(hidden_size=896, num_heads=14, num_kv_heads=2), "tiled"),  # group 7
    (8, dict(hidden_size=8704, num_heads=68, num_kv_heads=68), "scan"),  # H > 8192
])
def test_route_sees_batch_and_kernel_limits(B, spec_kw, want):
    assert _route("gpt2", B, **spec_kw) == want
    if want != "mega":
        with pytest.raises(ValueError, match="K4 does not run"):
            _route("gpt2", B, "mega", **spec_kw)


def test_route_rule_and_forced_routes():
    """llama3-8b takes K6 under "auto" at B 8, bf16 or int8; "mega" still
    runs it on K4 where K4 takes the shapes; the CPU rehearsal keeps the
    batch limits but not the head limits; "tiled" past K6's limits raises."""
    assert _route("llama3-8b", 8) == "tiled"
    assert _route("llama3-8b", 8, "mega") == "mega"
    assert _route("qwen2-7b", 8) == "tiled"                         # group 7: K6 only
    assert _route("gpt2-tiny", 8, on_card=False) == "mega"          # head dim 16 on the CPU
    assert _route("gpt2-tiny", 8) == "scan"                         # and not on the card
    assert _route("gpt2-tiny", 16, on_card=False) == "tiled"
    with pytest.raises(ValueError, match="batch 16 must be 1..8"):
        _route("gpt2-tiny", 16, "mega", on_card=False)
    with pytest.raises(ValueError, match="K6 does not run"):
        _route("gpt2", 40, "tiled")
    assert _route("gpt2", 40, "scan") == "scan"
    assert dt.prefer_mega(get_spec("gpt2"), 2)
    assert dt.prefer_mega(get_spec("gpt2-xl"), 2)       # K4 measured faster here
    assert dt.prefer_mega(get_spec("opt-1.3b"), 2)      # and here (96 MiB a layer)
    assert not dt.prefer_mega(get_spec("llama3-8b"), 1)  # K6 faster from 208 MiB


def test_engine_resolves_past_k8_batch_to_perop():
    """InferenceEngine(max_batch=16): "auto" resolves to the per-op decode
    (K7), which serves the batch; "mega" raises naming the limit."""
    spec = get_spec("gpt2-tiny")
    _, _, params = _model(JAX_PRESETS["gpt2-tiny"])
    geometry = dict(max_seq_len=64, block_size=16, dtype=torch.float32, device="cpu")
    eng = InferenceEngine(spec, params, max_batch=16, **geometry)
    assert eng.decode_stack == "perop"
    outs = eng.run([[1, 2, 3], [4, 5]], max_new_tokens=3)
    assert [len(o) for o in outs] == [3, 3]
    assert InferenceEngine(spec, params, max_batch=8, **geometry).decode_stack == "mega"
    with pytest.raises(ValueError, match="batch 16 must be 1..8"):
        InferenceEngine(spec, params, max_batch=16, decode_stack="mega", **geometry)


def test_generate_batch_16_takes_tiled_route():
    """generate at B = 16 on the CPU: "auto" routes off K4 (F1) to the tiled
    decode, whose greedy ids equal the scan decode's in fp32."""
    _, spec, params = _model(JAX_PRESETS["llama-tiny"])
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, spec.vocab_size, (16, 5)))
    assert decode_route(spec, Impl(attention="flash"), params["blocks"], 16,
                        on_card=False) == "tiled"
    got = generate(params, spec, ids, max_new_tokens=4, device="cpu",
                   impl=Impl(attention="flash"))
    want = generate(params, spec, ids, max_new_tokens=4, device="cpu",
                    impl=Impl(attention="flash", decode_stack="scan"))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K6's MoE phases (Mixtral's decode route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("weights,kv8", [(None, False), ("int8", True)], ids=["fp32", "w8kv8"])
def test_plain_moe_matches_jax_tiled_kernel(weights, kv8, B):
    """decode_layer_tiled_plain's MoE phases (the router's softmax, the
    top-k by repeated max, every expert's chunks weighted by the rows'
    routing weights) against the JAX _tiled_kernel in interpret mode on
    moe-tiny, fp32 weights over an fp32 cache and int8 weights over
    an INT8 cache, at the JAX tiling; the softmax it reports sums to 1."""
    jspec = JAX_PRESETS["moe-tiny"]
    jparams, spec, params = _model(jspec, weights)
    Smax, pos = 128, 41
    x, kc, vc, ks, vs, (jc, js, tc, ts) = _inputs(spec, B, Smax, pos, 21 + B, kv8)
    jtiling = jax_choose_tiling(jspec, B, 1 if weights else 4, 1 if kv8 else 4,
                                weight_fmt=weights)
    L, Hkv = spec.num_layers, spec.num_kv_heads
    flat = (lambda a: jnp.asarray(a.reshape(L, B, Smax, -1)))
    jkw = {}
    if kv8:
        jkw = dict(k_scales=pad_scales_for_tiled(jnp.asarray(ks), Hkv, jtiling.ka),
                   v_scales=pad_scales_for_tiled(jnp.asarray(vs), Hkv, jtiling.ka))
    out = jax_decode_layer_tiled(jnp.asarray(x), jparams["blocks"], flat(kc), flat(vc), pos, jc,
                                 js, spec=jspec, tiling=jtiling, interpret=True, **jkw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    kw = dict(k_scales=torch.from_numpy(ks.copy()), v_scales=torch.from_numpy(vs.copy())) \
        if kv8 else {}
    probs = torch.zeros((L, B, spec.num_experts))
    got = dt.decode_layer_tiled_plain(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc, ts,
                                      spec=spec, tiling=dt.Tiling(*jtiling[:4]),
                                      router_probs=probs, **kw)
    np.testing.assert_allclose(got.numpy(), _np(out[0]), **TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)
    for i, t in enumerate((tk, tv)):
        jt = _np(out[1 + i]).reshape(t.shape)
        if kv8:
            assert np.abs(t.numpy().astype(np.int32) - jt.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), jt, **TOL)


def test_plain_moe_follows_given_experts_and_top1_differs():
    """``experts=`` makes the plain version take the given picks: its own
    picks reproduce its output bit for bit, a top-1 routing (each row's
    second expert dropped) moves x_out, and the wrapper on CPU tensors
    reports the same softmax as the plain version."""
    _, spec, params = _model(JAX_PRESETS["moe-tiny"])
    B, Smax, pos = 3, 64, 20
    x, kc, vc, _, _, (_, _, tc, ts) = _inputs(spec, B, Smax, pos, 5, False)
    L, E = spec.num_layers, spec.num_experts

    def run(**kw):
        return dt.decode_layer_tiled_plain(torch.from_numpy(x), params["blocks"],
                                           torch.from_numpy(kc.copy()),
                                           torch.from_numpy(vc.copy()), pos, tc, ts, spec=spec,
                                           **kw)

    probs = torch.zeros((L, B, E))
    own = run(router_probs=probs)
    picks = moe_topk_mask(probs, spec.num_experts_per_tok)
    assert torch.equal(run(experts=picks), own)
    top1 = dt.decode_layer_tiled_plain(
        torch.from_numpy(x), params["blocks"], torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), pos, tc, ts,
        spec=dataclasses.replace(spec, num_experts_per_tok=1))
    assert (top1 - own).abs().max() > 1e-2
    wrapped = torch.zeros((L, B, E))
    dt.decode_layer_tiled(torch.from_numpy(x), params["blocks"], torch.from_numpy(kc.copy()),
                          torch.from_numpy(vc.copy()), pos, tc, ts, spec=spec,
                          router_probs=wrapped)
    assert torch.equal(wrapped, probs)


def test_supports_decode_tiled_moe_clauses_match_jax():
    """The MoE clauses of supports_decode_tiled (a router, up and down expert
    stacks, stored as the attention weights are) as the JAX package decides
    them, on moe-tiny's fp32 and int8 blocks; the spec widens its heads to
    128 so that the JAX package's lane clause (not kept) does not decide."""
    tiny = JAX_PRESETS["moe-tiny"]
    jspec = dataclasses.replace(tiny, hidden_size=256, num_heads=2, num_kv_heads=2)
    spec = ModelSpec(**dataclasses.asdict(jspec))
    for weights in (None, "int8"):
        jparams, _, params = _model(tiny, weights)
        jb, b = dict(jparams["blocks"]), dict(params["blocks"])
        assert dt.supports_decode_tiled(spec, 2, blocks=b, on_card=False)
        assert jax_supports_decode_tiled(jspec, 2, blocks=jb)
        for drop in ("router", "moe_up", "moe_down"):
            assert not dt.supports_decode_tiled(spec, 2, blocks={**b, drop: None}, on_card=False)
            assert not jax_supports_decode_tiled(jspec, 2, blocks={**jb, drop: None})
    # experts stored otherwise than the attention weights
    jf, _, pf = _model(tiny)
    j8, _, p8 = _model(tiny, "int8")
    mixed = {**pf["blocks"], "moe_up": p8["blocks"]["moe_up"]}
    jmixed = {**jf["blocks"], "moe_up": j8["blocks"]["moe_up"]}
    assert not dt.supports_decode_tiled(spec, 2, blocks=mixed, on_card=False)
    assert not jax_supports_decode_tiled(jspec, 2, blocks=jmixed)


def test_mixtral_routes_to_tiled_and_counts_every_expert():
    """Mixtral-8x7B at B 8 with int8 weights and an INT8 cache takes K6 under
    "auto" (K4 refuses experts); "mega" raises naming them; a layer's
    weights count all 8 experts and the router."""
    spec = get_spec("mixtral-8x7b")
    blocks = {"wq": QTensor(torch.zeros(1, dtype=torch.int8), torch.zeros(1), "int8"),
              "router": torch.zeros(1), "moe_up": QTensor(torch.zeros(1, dtype=torch.int8),
                                                          torch.zeros(1), "int8"),
              "moe_down": QTensor(torch.zeros(1, dtype=torch.int8), torch.zeros(1), "int8")}
    impl = Impl(attention="flash")
    assert decode_route(spec, impl, blocks, 8, cache_quant=True, smax=1024) == "tiled"
    assert decode_route(spec, impl, blocks, 32, cache_quant=True, smax=1024) == "tiled"
    assert decode_route(spec, impl, blocks, 33, cache_quant=True, smax=1024) == "scan"
    with pytest.raises(ValueError, match="8 experts"):
        decode_route(spec, Impl(attention="flash", decode_stack="mega"), blocks, 8)
    attn = 4096 * (4096 + 2 * 1024) + 4096 * 4096
    assert dt.layer_weight_bytes(spec, 1) == attn + 8 * 3 * 4096 * 14336 + 2 * 4096 * 8
    t = dt.choose_tiling(spec, 8)
    assert t.ic % 16 == 0 and t.km * t.ic >= 14336 > (t.km - 1) * t.ic
    assert dt.kernel_limit(dataclasses.replace(spec, num_experts=17), 8) is not None
