"""The README quick start's path on the port (int8 weights, an INT8 KV cache)
against the JAX package, on the CPU in fp32.

The same numpy-seeded inputs and the same weights (the JAX package's
``init_params``, quantized by its ``quantize_params``, through
``from_jax_params``) go to the JAX functions, whose Pallas kernels run in
interpret mode as the JAX tests run them, and to the port's wrappers on CPU
tensors, which run the plain versions: K9 (flash attention over an INT8
cache), K3's and K7's int8 instances, K4's int8-weight and INT8-KV paths,
K8's int8-weight path, and the forward, generate and engine routes over them.
Tolerances: 1e-5 where both sides compute the same fp32 (and bf16) values in
another order; an INT8 cache written by two computations of the same K/V may
differ by one int8 step where a value sits on a rounding boundary, so the
decode over it is held within 2e-2 as the JAX package's own test holds its
two routes (tests/test_decode_layer.py).
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
import mlio_tpu.ops.decode_paged_stack as jax_dps
import mlio_tpu.ops.paged_attention as jax_pa
from mlio_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from mlio_tpu.ops.decode_layer import decode_layer_stack as jax_decode_layer_stack
from mlio_tpu.ops.decode_layer import pad_scales_for_mega, unpad_scales_from_mega
from mlio_tpu.ops.decode_layer import supports_decode_stack as jax_supports_decode_stack
from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu.ops.quant import quantize_kv as jax_quantize_kv
from mlio_tpu.ops.reference import attention_reference as jax_attention_reference
from mlio_tpu.runtime import generate as jax_generate
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu.runtime.engine import InferenceEngine as JaxEngine
from mlio_tpu.runtime.quantization import quantize_params as jax_quantize_params
from mlio_tpu.runtime.sampling import SamplingMethod as JaxSamplingMethod
from mlio_tpu_torch.models import Impl, forward, from_jax_cache, from_jax_params, rope_cos_sin
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops import attention_reference
from mlio_tpu_torch.ops import decode_layer as dl
from mlio_tpu_torch.ops import decode_paged_stack as dps
from mlio_tpu_torch.ops import paged_attention as pa
from mlio_tpu_torch.ops.decode_attention import decode_attention
from mlio_tpu_torch.ops.flash_attention import flash_attention, flash_attention_kvq
from mlio_tpu_torch.runtime import InferenceEngine, SamplingMethod, generate, init_cache
from mlio_tpu_torch.runtime.quantization import quantize_params

TIGHT = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
KV_NOISE = 2e-2  # the JAX package's bound between two routes over an INT8 cache
_models = {}


def _np(t):
    return np.array(t)  # a writable copy, as torch.from_numpy wants


def _quant_kv(rng, *shape):
    """(int8 values, fp32 scales) of seeded normal K/V rows, by the JAX
    package's quantize_kv."""
    q, s = jax_quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    return _np(q), _np(s)


def _model(name, weights=None):
    """(JAX spec, JAX params, port spec, port params): the same fp32 weights,
    int8-quantized by the JAX package's quantize_params when asked."""
    key = (name, weights)
    if key not in _models:
        jspec = JAX_PRESETS[name]
        jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
        if weights is not None:
            jparams = jax_quantize_params(jparams, jspec, weights)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        _models[key] = jspec, jparams, ModelSpec(**dataclasses.asdict(jspec)), params
    return _models[key]


# (Hq, Hkv, Sq, Skv, q_offset, kv_len, D): one kv block of the JAX kernel
# (Skv <= 512), so both sides round p * v_scale against the same row max and
# the plain version holds at 1e-5 (fp32, summation order only). The last two
# span several of K9's 64-key tiles at head dim 128 and four query heads a
# KV head, kv_len ending mid-tile (130 = 2 x 64 + 2; 200 = 3 x 64 + 8 and 137
# = 2 x 64 + 9 behind a q_offset, a chunked prefill's second chunk).
FLASH_CASES = {
    "prefill_mha": (4, 4, 24, 64, 0, 24, 64),
    "gqa2_offset_ragged": (8, 4, 9, 128, 37, [46, 40], 64),
    "mqa_decode_row": (4, 1, 1, 96, 60, [61, 17], 64),
    "gqa4_d128_tiles_mid_tile": (8, 2, 130, 256, 0, 130, 128),
    "gqa4_d128_offset_mid_tile": (16, 4, 100, 384, 100, [200, 137], 128),
}


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_attention_int8_matches_jax(case):
    """K9's plain version against the JAX kernel (interpret) and the dense
    references against each other, both at 1e-5; the kernel's bf16
    rounding of q and p against the dense fp32 reference at the JAX test's
    2e-2."""
    hq, hkv, sq, skv, qo, kvl, D = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B = 2
    q = rng.standard_normal((B, sq, hq, D)).astype(np.float32)
    kq, ks = _quant_kv(rng, B, skv, hkv, D)
    vq, vs = _quant_kv(rng, B, skv, hkv, D)
    kv = np.asarray(kvl, np.int32) if isinstance(kvl, list) else kvl
    args = dict(causal=True, q_offset=qo)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                               kv_len=jnp.asarray(kv), k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs), interpret=True, **args)
    tq, tk, tv, tks, tvs = (torch.from_numpy(a) for a in (q, kq, vq, ks, vs))
    tkv = torch.from_numpy(kv) if isinstance(kvl, list) else kv
    before = flash_attention_kvq.launches
    got = flash_attention(tq, tk, tv, kv_len=tkv, k_scale=tks, v_scale=tvs, **args)
    assert flash_attention_kvq.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), **TIGHT)
    ref = attention_reference(tq, tk, tv, kv_len=tkv, k_scale=tks, v_scale=tvs, **args)
    jref = jax_attention_reference(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                                   kv_len=jnp.asarray(kv), k_scale=jnp.asarray(ks),
                                   v_scale=jnp.asarray(vs), **args)
    np.testing.assert_allclose(ref.numpy(), _np(jref), **TIGHT)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-2, rtol=2e-2)


def test_flash_attention_int8_refuses_what_jax_refuses():
    q = torch.zeros(1, 4, 2, 64)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.int8)
    s = torch.ones(1, 8, 2)
    with pytest.raises(NotImplementedError, match="full"):
        flash_attention(q, k, k, k_scale=s, v_scale=s, mask=torch.ones(1, 4, 8))
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention(q, k, k, k_scale=s, v_scale=s, dropout_rate=0.1)
    with pytest.raises(ValueError, match="scales"):
        flash_attention(q, k, k, k_scale=s)


@pytest.mark.parametrize("group", [1, 2])
def test_decode_attention_int8_matches_jax(group):
    """K3's int8 plain version: fp32 at G = 1, the GQA branch's bf16
    rounding of q and p * v_scale at G = 2 (one block of the JAX kernel)."""
    rng = np.random.default_rng(10 + group)
    L, B, Smax, Hkv, D, layer = 2, 3, 32, 2, 64, 1
    q = rng.standard_normal((B, Hkv * group, D)).astype(np.float32)
    kc, ks = _quant_kv(rng, L, B, Smax, Hkv, D)
    vc, vs = _quant_kv(rng, L, B, Smax, Hkv, D)
    ctx = np.array([1, 32, 19], np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(ctx), layer=layer, k_scales=jnp.asarray(ks),
                                v_scales=jnp.asarray(vs), interpret=True)
    got = decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, ctx)), layer=layer,
                           k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), _np(want), **TIGHT)


def test_reshape_and_cache_quant_and_paged_attention_int8_match_jax():
    """reshape_and_cache_quant bit-equal to the JAX scatter; K7's int8
    plain version over the written pools (fp32, dequantized before both
    products) against the JAX kernel, as tests/test_kv_quant.py runs it."""
    rng = np.random.default_rng(20)
    B, L, NB, Hq, Hkv, bs, D, S, layer = 2, 2, 16, 4, 2, 16, 32, 33, 1
    tables = np.array([[1, 2, 0, 0], [3, 5, 7, 0]], np.int32)
    ctx = np.array([20, 33], np.int32)
    k_new, v_new = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    jpools = jax_pa.init_kv_pools(L, NB, Hkv, bs, D, quant="int8")
    jpools = jax_pa.reshape_and_cache_quant(*jpools, jnp.asarray(k_new), jnp.asarray(v_new),
                                            jnp.asarray(tables), jnp.zeros((B,), jnp.int32),
                                            layer)
    pools = pa.init_kv_pools(L, NB, Hkv, bs, D, quant="int8", device="cpu")
    pools = pa.reshape_and_cache_quant(*pools, torch.from_numpy(k_new), torch.from_numpy(v_new),
                                       torch.from_numpy(tables), torch.zeros(B, dtype=torch.int32),
                                       layer)
    for got, want in zip(pools, jpools):
        assert got.dtype in (torch.int8, torch.float32)
        np.testing.assert_array_equal(got.numpy(), _np(want))
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    want = jax_pa.paged_attention(jnp.asarray(q), jpools[0], jpools[1], jnp.asarray(tables),
                                  jnp.asarray(ctx), layer=layer, k_scale_pool=jpools[2],
                                  v_scale_pool=jpools[3], interpret=True)
    got = pa.paged_attention(torch.from_numpy(q), pools[0], pools[1], torch.from_numpy(tables),
                             torch.from_numpy(ctx), layer=layer, k_scale_pool=pools[2],
                             v_scale_pool=pools[3])
    np.testing.assert_allclose(got.numpy(), _np(want), **TIGHT)


# (model, int8 weights, INT8 KV cache)
K4_CASES = {"gpt2-w8": ("gpt2-tiny", True, False), "gpt2-kv8": ("gpt2-tiny", False, True),
            "gpt2-w8kv8": ("gpt2-tiny", True, True), "llama-w8kv8": ("llama-tiny", True, True)}


@pytest.mark.parametrize("case", list(K4_CASES), ids=list(K4_CASES))
def test_decode_layer_stack_int8_matches_jax(case):
    """K4's plain version with int8 weights, an INT8 KV cache or both against
    the JAX megakernel (interpret). The JAX cache is flat with its scales in
    the mega layout (the JAX package's own pad_scales_for_mega /
    unpad_scales_from_mega); the port's is [L, B, Smax, Hkv, D] with scales
    [L, B, Smax, Hkv]. x_out within 1e-4 with int8 weights alone; with an
    INT8 cache within 2e-2, the written ints within one step and the
    scales within 1e-4; no other slot changes."""
    name, w8, kv8 = K4_CASES[case]
    jspec, jparams, spec, params = _model(name, "int8" if w8 else None)
    rng = np.random.default_rng(30)
    B, Smax, pos = 3, 128, 41
    L, Hkv, D = spec.num_layers, spec.num_kv_heads, spec.head_size
    x = rng.standard_normal((B, spec.hidden_size)).astype(np.float32)
    if kv8:
        kc, ks = _quant_kv(rng, L, B, Smax, Hkv, D)
        vc, vs = _quant_kv(rng, L, B, Smax, Hkv, D)
    else:
        kc, vc = (rng.standard_normal((L, B, Smax, Hkv, D)).astype(np.float32)
                  for _ in range(2))
    jc = js = tc = ts = None
    if spec.positional != "learned":
        jc, js = jax_rope_cos_sin(pos + jnp.arange(1), spec.rope_dim, spec.rope_theta,
                                  jnp.float32)
        tc, ts = rope_cos_sin(torch.arange(pos, pos + 1), spec.rope_dim, spec.rope_theta)
    flat = (lambda a: jnp.asarray(a.reshape(L, B, Smax, -1)))
    jkw = dict(k_scales=pad_scales_for_mega(jnp.asarray(ks), Hkv),
               v_scales=pad_scales_for_mega(jnp.asarray(vs), Hkv)) if kv8 else {}
    out = jax_decode_layer_stack(jnp.asarray(x), jparams["blocks"], flat(kc), flat(vc), pos, jc,
                                 js, spec=jspec, interpret=True, **jkw)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    kw = dict(k_scales=torch.from_numpy(ks.copy()), v_scales=torch.from_numpy(vs.copy())) \
        if kv8 else {}
    got, tokens = dl.decode_layer_stack(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc,
                                        ts, spec=spec, **kw)
    assert tokens is None
    np.testing.assert_allclose(got.numpy(), _np(out[0]), **(
        dict(atol=KV_NOISE, rtol=0) if kv8 else TOL))
    for i, (t, orig) in enumerate(((tk, kc), (tv, vc))):
        jt = _np(out[1 + i]).reshape(t.shape)
        if kv8:
            assert np.abs(t.numpy().astype(np.int32) - jt.astype(np.int32)).max() <= 1
            sc = kw["k_scales" if i == 0 else "v_scales"]
            np.testing.assert_allclose(sc.numpy(), _np(unpad_scales_from_mega(out[3 + i], Hkv)),
                                       atol=1e-4, rtol=0)
        else:
            np.testing.assert_allclose(t.numpy(), jt, **TOL)
        rest = np.ones(Smax, bool)
        rest[pos] = False
        np.testing.assert_array_equal(t.numpy()[:, :, rest], orig[:, :, rest])


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_decode_paged_stack_int8_weights_match_jax(name):
    """K8's plain version with int8 weights against the JAX paged megakernel
    (interpret), at past contexts that span equal block counts (the JAX
    kernel's fault at ragged ones: ROADMAP.md, queue 3)."""
    jspec, jparams, spec, params = _model(name, "int8")
    rng = np.random.default_rng(40)
    L, NB, bs, D = spec.num_layers, 16, 8, spec.head_size
    past = np.array([9, 12, 15, 16], np.int32)
    B, max_blocks = len(past), 3
    tables = rng.permutation(np.arange(1, NB))[:B * max_blocks].reshape(B, max_blocks)
    tables = tables.astype(np.int32)
    x = (0.5 * rng.standard_normal((B, spec.hidden_size))).astype(np.float32)
    kp, vp = (rng.standard_normal((L, NB, bs, spec.num_kv_heads, D)).astype(np.float32)
              for _ in range(2))
    jrope = cos = sin = None
    if spec.positional != "learned":
        jrope = jax_dps.rope_tables_for_paged(jspec, jnp.asarray(past), spec.num_heads,
                                              spec.num_kv_heads)
        cos, sin = rope_cos_sin(torch.from_numpy(past), spec.rope_dim, spec.rope_theta)
    tied = params["lm_head"] is None
    head = dict(head_norm=(params["final_scale"], params["final_bias"]),
                lm_head=params["tok_embed"] if tied else params["lm_head"],
                lm_head_bias=params["lm_head_bias"], lm_vmajor=tied, emit="logits")
    jhead = dict(head_norm=(jparams["final_scale"], jparams["final_bias"]),
                 lm_head=jparams["tok_embed"] if tied else jparams["lm_head"],
                 lm_head_bias=jparams["lm_head_bias"], lm_vmajor=tied, emit="logits")
    flat = (lambda a: jnp.asarray(a.reshape(*a.shape[:3], -1)))
    jout, jk, _ = jax_dps.decode_paged_stack(
        jnp.asarray(x), jparams["blocks"], flat(kp), flat(vp), jnp.asarray(tables),
        jnp.asarray(past), jrope, spec=jspec, interpret=True, **jhead)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, logits = dps.decode_paged_stack(torch.from_numpy(x), params["blocks"], tk, tv,
                                       torch.from_numpy(tables), torch.from_numpy(past), cos,
                                       sin, spec=spec, **head)
    np.testing.assert_allclose(logits.numpy(), _np(jout)[:, :spec.vocab_size], **TOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk).reshape(tk.shape), **TIGHT)


# name: (model, Impl fields, cache length): the dense route, the flash route
# with the scan decode (a cache not 128-aligned) and with K4
FORWARD_CASES = {"gpt2-dense": ("gpt2-tiny", dict(), 32),
                 "gpt2-flash-scan": ("gpt2-tiny", dict(attention="flash"), 32),
                 "llama-flash-scan": ("llama-tiny", dict(attention="flash"), 32),
                 "llama-flash-mega": ("llama-tiny", dict(attention="flash"), 128)}


@pytest.mark.parametrize("case", list(FORWARD_CASES), ids=list(FORWARD_CASES))
def test_forward_int8_cache_matches_jax(case):
    """A prefill into an INT8 cache, then three decode steps, against the
    JAX forward (tests/test_kv_quant.py:47): logits within 2e-2, the cache's
    ints within one step and its scales within 1e-4."""
    name, fields, cache_len = FORWARD_CASES[case]
    jspec, jparams, spec, params = _model(name)
    B = 2
    ids = np.random.default_rng(50).integers(0, spec.vocab_size, (B, 11)).astype(np.int32)
    jcache = jax_init_cache(jspec, B, cache_len, quant="int8")
    cache = from_jax_cache(jax.tree.map(np.asarray, jcache), device="cpu")
    assert cache["k"].dtype == torch.int8 and cache["pos"] == 0
    for chunk in (ids[:, :8], ids[:, 8:9], ids[:, 9:10], ids[:, 10:11]):
        want, jcache = jax_forward(jparams, jspec, jnp.asarray(chunk), impl=JaxImpl(**fields),
                                   cache=jcache)
        got, cache = forward(params, spec, torch.from_numpy(chunk), impl=Impl(**fields),
                             cache=cache)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=KV_NOISE, rtol=0)
    assert cache["pos"] == int(jcache["pos"]) == 11
    for key in ("k", "v"):
        dk = cache[key].numpy().astype(np.int32) - _np(jcache[key]).reshape(
            cache[key].shape).astype(np.int32)
        assert np.abs(dk).max() <= 1
        np.testing.assert_allclose(cache[f"{key}_scale"].numpy(), _np(jcache[f"{key}_scale"]),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("route", ["scan", "mega"])
def test_generate_int8_weights_int8_cache_matches_jax(route):
    """The README quick start: int8 weights, an INT8 KV cache, greedy
    generate. Ids equal on the scan route; on the mega route (K4's int8
    paths in both packages) at least 4 of 5 new tokens agree, the JAX
    test's own rule (tests/test_decode_layer.py)."""
    jspec, jparams, spec, params = _model("llama-tiny", "int8")
    ids = np.array([[5, 3, 2, 6]], np.int32)
    fields = dict(attention="flash", decode_stack=route)
    want = jax_generate(jparams, jspec, jnp.asarray(ids), max_new_tokens=5, cache_len=128,
                        impl=JaxImpl(**fields), cache_quant="int8",
                        method=JaxSamplingMethod(temperature=0.0))
    got = generate(params, spec, torch.from_numpy(ids), max_new_tokens=5, cache_len=128,
                   impl=Impl(**fields), cache_quant="int8",
                   method=SamplingMethod(temperature=0.0), device="cpu")
    got, want = got.numpy(), _np(want)
    if route == "scan":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.array_equal(got[:, :4], ids) and np.mean(got[:, 4:] == want[:, 4:]) >= 0.8


def test_supports_decode_stack_quantized_matches_jax():
    """int8 weights take the megakernel, int4 and fp8 do not; an INT8 cache
    must be 128-aligned (tests/test_decode_layer.py:139-154)."""
    jspec, jparams, spec, params = _model("gpt2-tiny")
    for fmt in ("int8", "int4", "fp8"):
        jq = jax_quantize_params(jparams, jspec, fmt)
        q = quantize_params(params, spec, fmt)
        want = jax_supports_decode_stack(jspec, blocks=jq["blocks"])
        assert dl.supports_decode_stack(spec, blocks=q["blocks"]) is want is (fmt == "int8")
    for smax in (100, 128, 256):
        assert dl.supports_decode_stack(spec, cache_quant=True, smax=smax) is \
            jax_supports_decode_stack(jspec, cache_quant=True, smax=smax) is (smax % 128 == 0)
    assert dl.supports_decode_stack(spec, cache_quant=False, smax=100)


def test_engine_int8_weights_takes_k8_and_matches_jax():
    """The engine with int8 weights resolves to K8 ("mega") as the JAX
    engine does, and gives the JAX sync engine's greedy ids (its per-op
    decode, as tests/test_torch_engine.py runs it)."""
    jspec, jparams, spec, params = _model("gpt2-tiny", "int8")
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]
    geometry = dict(max_batch=4, max_seq_len=64, block_size=16)
    jeng = JaxEngine(jspec, jparams, dtype=jnp.float32, decode_stack="perop", **geometry)
    assert JaxEngine(jspec, jparams, dtype=jnp.float32, **geometry).decode_stack == "mega"
    want = jeng.run(prompts, max_new_tokens=6, pipeline=False)
    eng = InferenceEngine(spec, params, dtype=torch.float32, device="cpu", **geometry)
    assert eng.decode_stack == "mega"
    assert eng.run(prompts, max_new_tokens=6) == want
