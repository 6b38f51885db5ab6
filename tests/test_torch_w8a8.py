"""The port's W8A8 serving path and fp8 → int8 transcode against the JAX
package, on the CPU.

The same fp32 weights (the JAX package's ``init_params`` through
``from_jax_params``) and numpy-seeded inputs go to both packages. The int8
activations must be equal; the port's float64 sums are exact, so
``w8a8_matmul``'s outputs lie within 1e-6 relative of the JAX XLA product
(fp32 rescale rounding only). Calibration stats within 1e-5 relative
(summation order upstream of each amax). A whole W8A8 forward within
``FORWARD_RTOL`` of the largest JAX logit: an activation a hair from a
rounding boundary may quantize one step apart after the layers' fp32
summation-order differences. The decode kernels ignore ``act_scale`` (as
the JAX megakernels do): bit for bit the weight-only int8 result, and
within the K4/K6 tests' 1e-4 of the JAX kernels in interpret mode. The
transcode's payloads equal the JAX package's, its scales within 1 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models.transformer import rope_cos_sin as jax_rope_cos_sin
from mlio_tpu.ops import quant as jq
from mlio_tpu.ops.decode_layer import decode_layer_stack as jax_decode_layer_stack
from mlio_tpu.ops.decode_tiled import choose_tiling as jax_choose_tiling
from mlio_tpu.ops.decode_tiled import decode_layer_tiled as jax_decode_layer_tiled
from mlio_tpu.runtime import quantization as jquant
from mlio_tpu_torch.models import Impl, forward, from_jax_params, rope_cos_sin
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import decode_route
from mlio_tpu_torch.ops import decode_layer as dl
from mlio_tpu_torch.ops import decode_tiled as dt
from mlio_tpu_torch.ops import quant as tq
from mlio_tpu_torch.runtime import (apply_activation_scales, calibrate_activation_scales,
                                    fuse_projections, quantize_params, transcode_fp8_to_int8)

SITES = ("attn_in", "attn_out_in", "mlp_in", "mlp_down_in")
MATMUL_RTOL = 1e-6
STATS_RTOL = 1e-5
FORWARD_RTOL = 1e-3   # of the largest |logit|
TOL = dict(atol=1e-4, rtol=1e-4)
_models = {}


def _np(t):
    return np.array(t)


def _ids(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _model(name):
    """(JAX spec, JAX fp32 params, port spec, port fp32 params)."""
    if name not in _models:
        jspec = JAX_PRESETS[name]
        jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        _models[name] = jspec, jparams, ModelSpec(**dataclasses.asdict(jspec)), params
    return _models[name]


def _w8a8(name, shape=(2, 16), seed=5):
    """(calibration ids, JAX W8A8 params, port W8A8 params): each package's
    calibrate → quantize_params("int8") → apply_activation_scales over the
    same seeded ids."""
    key = (name, shape, seed)
    if key not in _models:
        jspec, jparams, spec, params = _model(name)
        ids = _ids(spec.vocab_size, shape, seed)
        jstats = jquant.calibrate_activation_scales(jparams, jspec, jnp.asarray(ids))
        stats = calibrate_activation_scales(params, spec, torch.from_numpy(ids))
        jw = jquant.apply_activation_scales(jquant.quantize_params(jparams, jspec, "int8"),
                                            jstats)
        w = apply_activation_scales(quantize_params(params, spec, "int8"), stats)
        _models[key] = ids, jw, w
    return _models[key]


# (batch shape, K, N, act_scale as a multiple of x's amax / 127)
MATMUL_CASES = {
    "rows": ((7,), 64, 48, 1.0),
    "batch_seq": ((2, 5), 128, 40, 1.0),
    "clipped": ((3, 4), 64, 24, 0.5),   # half the range: the quantizer clips
    "wide_scale": ((9,), 32, 16, 3.0),  # a third of the int8 range used
}


@pytest.mark.parametrize("case", list(MATMUL_CASES), ids=list(MATMUL_CASES))
def test_w8a8_matmul_matches_jax(case):
    lead, K, N, mult = MATMUL_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    x[..., 0] *= 9.0  # an outlier channel
    w = rng.standard_normal((K, N)).astype(np.float32)
    act = np.float32(np.abs(x).max() / 127.0 * mult)
    jt = jq.quantize(jnp.asarray(w), "int8")
    jw = jq.QTensor(jt.q, jt.scale, "int8", jnp.asarray(act))
    tt = tq.quantize(torch.from_numpy(w), "int8")
    tw = tq.QTensor(tt.q, tt.scale, "int8", torch.tensor(act))
    jx_q = jnp.clip(jnp.round(jnp.asarray(x) / jnp.asarray(act)), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(tq.quantize_activations(torch.from_numpy(x), tw.act_scale)
                                  .numpy(), _np(jx_q))
    want = _np(jq.w8a8_matmul(jnp.asarray(x), jw))
    got = tq.w8a8_matmul(torch.from_numpy(x), tw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_RTOL,
                               atol=MATMUL_RTOL * np.abs(want).max())
    # the float64 sums are the exact integer product
    xq = tq.quantize_activations(torch.from_numpy(x).reshape(-1, K), tw.act_scale)
    exact = xq.numpy().astype(np.int64) @ tt.q.numpy().astype(np.int64)
    np.testing.assert_array_equal(tq.int8_sums_plain(xq, tt.q).numpy(), exact)
    before = tq.w8a8_matmul.launches
    tq.linear(torch.from_numpy(x), tw)
    assert tq.w8a8_matmul.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_calibrate_activation_scales_matches_jax(name):
    jspec, jparams, spec, params = _model(name)
    ids = _ids(spec.vocab_size, (2, 3, 16), seed=1)  # [num_batches, B, S]
    for sample in (ids[0], ids):
        want = jquant.calibrate_activation_scales(jparams, jspec, jnp.asarray(sample))
        got = calibrate_activation_scales(params, spec, torch.from_numpy(sample))
        assert list(got) == list(want) == list(SITES)
        for site in SITES:
            assert got[site].shape == (spec.num_layers,) and got[site].dtype == torch.float32
            np.testing.assert_allclose(got[site].numpy(), _np(want[site]), rtol=STATS_RTOL)
    # the max over batches
    one = calibrate_activation_scales(params, spec, torch.from_numpy(ids[1]))
    assert all(bool((got[s] >= one[s]).all()) for s in SITES)


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_apply_activation_scales_matches_jax(name):
    jspec, jparams, spec, params = _model(name)
    stats = {s: np.abs(np.random.default_rng(4).standard_normal(spec.num_layers))
             .astype(np.float32) for s in SITES[:3]}  # mlp_down_in left out
    stats["attn_in"][0] = 0.0  # a zero amax takes scale 1
    jw = jquant.apply_activation_scales(jquant.quantize_params(jparams, jspec, "int8"),
                                        {k: jnp.asarray(v) for k, v in stats.items()},
                                        margin=1.25)
    w = apply_activation_scales(quantize_params(params, spec, "int8"),
                                {k: torch.from_numpy(v) for k, v in stats.items()}, margin=1.25)
    for name_, jt in jw["blocks"].items():
        t = w["blocks"][name_]
        if not isinstance(jt, jq.QTensor):
            assert not isinstance(t, tq.QTensor)
            continue
        if jt.act_scale is None:
            assert t.act_scale is None, name_
        else:
            np.testing.assert_array_equal(t.act_scale.numpy(), _np(jt.act_scale))
    assert w["blocks"]["wq"].act_scale[0] == 1.0 and w["blocks"]["w_down"].act_scale is None


def _ppl(logits, ids):
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return float(torch.exp(-logp.gather(-1, ids[:, 1:, None]).mean()))


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_w8a8_forward_matches_jax(name):
    """A W8A8 forward's logits against the JAX package's, and the JAX
    tests' gates on the port: within 0.12 of the fp32 logits (relative to
    their largest), different from weight-only int8, and a perplexity delta
    under half the fp32 perplexity."""
    jspec, jparams, spec, params = _model(name)
    ids, jw, w = _w8a8(name, (4, 32), seed=2)
    want = _np(jax_forward(jw, jspec, jnp.asarray(ids))[0])
    tids = torch.from_numpy(ids).long()
    got = forward(w, spec, tids)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FORWARD_RTOL * np.abs(want).max())
    ref = forward(params, spec, tids)[0]
    assert float((got - ref).abs().max() / (ref.abs().max() + 1e-6)) < 0.12
    wonly = forward(quantize_params(params, spec, "int8"), spec, tids)[0]
    assert not torch.allclose(got, wonly, atol=1e-6)
    base = _ppl(ref, tids)
    assert abs(_ppl(got, tids) - base) < 0.5 * base


@pytest.mark.parametrize("name", ["llama-tiny"])  # both fused layouts: wqkv, w_upgate
def test_fused_w8a8_keeps_act_scales(name):
    """The reference fault: the JAX package's fuse_projections drops
    act_scale, so its fused W8A8 forward runs wqkv (and w_upgate)
    weight-only: it is the forward of the W8A8 tree with those parts'
    act_scales removed, and not the W8A8 forward. The port keeps the one
    act_scale of wq|wk|wv and w_up|w_gate: its fused forward is its unfused
    W8A8 forward; parts whose act_scales differ are refused."""
    jspec, _, spec, params = _model(name)
    ids, jw, w = _w8a8(name)
    fused_parts = ("wq", "wk", "wv", "w_up", "w_gate")
    dropped = dict(jw, blocks={k: jq.QTensor(v.q, v.scale, v.fmt) if k in fused_parts else v
                               for k, v in jw["blocks"].items()})
    jfused = _np(jax_forward(jquant.fuse_projections(jw, jspec), jspec, jnp.asarray(ids))[0])
    np.testing.assert_allclose(jfused, _np(jax_forward(dropped, jspec, jnp.asarray(ids))[0]),
                               rtol=0, atol=1e-5)
    assert not np.allclose(jfused, _np(jax_forward(jw, jspec, jnp.asarray(ids))[0]), atol=1e-4)
    tids = torch.from_numpy(ids).long()
    fused = fuse_projections(w, spec)
    assert fused["blocks"]["wqkv"].act_scale is not None
    torch.testing.assert_close(forward(fused, spec, tids)[0], forward(w, spec, tids)[0],
                               rtol=0, atol=1e-6)
    blocks = dict(w["blocks"])
    wk = blocks["wk"]
    blocks["wk"] = tq.QTensor(wk.q, wk.scale, "int8", wk.act_scale * 2)
    with pytest.raises(ValueError, match="act_scale"):
        fuse_projections(dict(w, blocks=blocks), spec)


def _decode_inputs(spec, B, Smax, pos, seed):
    rng = np.random.default_rng(seed)
    shape = (spec.num_layers, B, Smax, spec.num_kv_heads, spec.head_size)
    x = rng.standard_normal((B, spec.hidden_size)).astype(np.float32)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    rope = (None,) * 4
    if spec.positional != "learned":
        rope = (*jax_rope_cos_sin(pos + jnp.arange(1), spec.rope_dim, spec.rope_theta,
                                  jnp.float32),
                *rope_cos_sin(torch.arange(pos, pos + 1), spec.rope_dim, spec.rope_theta))
    return x, kc, vc, rope


@pytest.mark.parametrize("name,route", [("gpt2-tiny", "mega"), ("llama-tiny", "mega"),
                                        ("llama-tiny", "tiled")])
def test_decode_kernels_ignore_act_scale(name, route):
    """K4 (mega) and K6 (tiled) take W8A8 weights: the same bits as the
    same weights without act_scale, within 1e-4 of the JAX megakernel
    (interpret) given the JAX W8A8 tree, and "auto" picks the route it
    picks for weight-only int8."""
    jspec, _, spec, _ = _model(name)
    _, jw, _ = _w8a8(name)
    w = from_jax_params(jax.tree.map(np.asarray, jw), device="cpu")  # the JAX act_scales
    w8 = dict(w, blocks={k: tq.QTensor(v.q, v.scale, v.fmt) if isinstance(v, tq.QTensor) else v
                         for k, v in w["blocks"].items()})
    assert w["blocks"]["wq"].act_scale is not None
    B, Smax, pos = 2, 128, 37
    x, kc, vc, (jc, js, tc, ts) = _decode_inputs(spec, B, Smax, pos, 7)
    L = spec.num_layers
    flat = (lambda a: jnp.asarray(a.reshape(L, B, Smax, -1)))
    outs = []
    for p in (w, w8):
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        if route == "mega":
            got = dl.decode_layer_stack(torch.from_numpy(x), p["blocks"], tk, tv, pos, tc, ts,
                                        spec=spec)[0]
        else:
            jtiling = jax_choose_tiling(jspec, B, 1, 4, weight_fmt="int8")
            got = dt.decode_layer_tiled_plain(torch.from_numpy(x), p["blocks"], tk, tv, pos, tc,
                                              ts, spec=spec, tiling=dt.Tiling(*jtiling[:4]))
        outs.append((got, tk, tv))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if route == "mega":
        want = jax_decode_layer_stack(jnp.asarray(x), jw["blocks"], flat(kc), flat(vc), pos, jc,
                                      js, spec=jspec, interpret=True)
    else:
        want = jax_decode_layer_tiled(jnp.asarray(x), jw["blocks"], flat(kc), flat(vc), pos, jc,
                                      js, spec=jspec, tiling=jtiling, interpret=True)
    np.testing.assert_allclose(outs[0][0].numpy(), _np(want[0]), **TOL)
    impl = Impl(attention="flash")
    assert decode_route(spec, impl, w["blocks"], B, on_card=False) == \
        decode_route(spec, impl, w8["blocks"], B, on_card=False)


EAGER = {"wq": [(0,)], "moe_down": [(1, 2)], "lm_head": [()]}  # leaf: matrix indices


@pytest.mark.parametrize("name", ["moe-tiny"])
def test_transcode_fp8_to_int8_matches_jax(name):
    """Every fp8 leaf (attention weights, expert stacks, an fp8 lm_head) becomes
    int8, the other leaves pass through. Each matrix equals, payload and
    scales bit for bit, the JAX package's int8 quantizer applied eagerly to
    its fp32 dequantization, the function the JAX transcode computes. The
    JAX transcode itself runs that under one jit, where XLA's scales
    (amax / 127) come out up to 1 ulp apart: the scales within 1 ulp, and
    the payloads within one int8 step, at the few elements (under 1 %)
    whose quotient lies on a rounding boundary. The eager comparison takes
    the matrices of ``EAGER`` (each a JAX compile)."""
    jspec, jparams, spec, params = _model(name)
    jfp8 = jquant.quantize_params(jparams, jspec, "fp8", quantize_lm_head=True)
    want = jquant.transcode_fp8_to_int8(jfp8)
    got = transcode_fp8_to_int8(from_jax_params(jax.tree.map(np.asarray, jfp8), device="cpu"))
    leaves = [(k, jfp8["blocks"][k], v, got["blocks"][k]) for k, v in want["blocks"].items()]
    leaves.append(("lm_head", jfp8["lm_head"], want["lm_head"], got["lm_head"]))
    n = 0
    for key, src, jt, t in leaves:
        if not isinstance(jt, jq.QTensor):
            if jt is not None:
                np.testing.assert_array_equal(t.numpy(), _np(jt))
            continue
        assert isinstance(t, tq.QTensor) and t.fmt == jt.fmt == "int8", key
        for idx in EAGER.get(key, ()):
            m = jq.quantize(jq.dequantize(jq.QTensor(src.q[idx], src.scale[idx], "fp8"),
                                          jnp.float32), "int8")
            np.testing.assert_array_equal(t.q[idx].numpy(), _np(m.q))
            np.testing.assert_array_equal(t.scale[idx].numpy(), _np(m.scale))
        np.testing.assert_array_max_ulp(t.scale.numpy(), _np(jt.scale), maxulp=1)
        step = np.abs(t.q.numpy().astype(np.int32) - _np(jt.q).astype(np.int32))
        assert step.max() <= 1 and (step > 0).mean() < 0.01, key
        n += 1
    assert n == sum(isinstance(v, jq.QTensor) for v in jfp8["blocks"].values()) + 1
