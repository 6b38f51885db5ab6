"""The port's Mixture-of-Experts path against the JAX package on the CPU.

``ops/moe.py`` (routing, the dense oracle, the dropless ragged product, the
GShard capacity dispatch, the load-balance loss), the MoE layer of
``forward`` (prefill, the cached decode, the scan and tiled decodes of
``generate``), the engine's per-op route, and the Mixtral loader against
HF's ``MixtralForCausalLM``. Inputs come from ``numpy.random.default_rng``
and the weights from the JAX package's ``init_params`` through
``from_jax_params``; both packages compute in fp32 and differ by summation
order only (atol = rtol = 1e-5 for an op, 1e-4 through a model, as
``tests/test_moe.py`` holds its own methods).
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
from mlio_tpu.ops import moe as jmoe
from mlio_tpu.runtime import generate as jax_generate
from mlio_tpu.runtime.engine import InferenceEngine as JaxEngine
from mlio_tpu.runtime.quantization import quantize_params as jax_quantize_params
from mlio_tpu.runtime.sampling import SamplingMethod as JaxSamplingMethod
from mlio_tpu_torch import ops
from mlio_tpu_torch.models import Impl, forward, from_jax_params, init_params, load_model
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops import decode_tiled as dt
from mlio_tpu_torch.ops import moe as tmoe
from mlio_tpu_torch.ops.quant import QTensor
from mlio_tpu_torch.runtime import InferenceEngine, SamplingMethod, generate, init_cache

OP_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
T, H, I, E = 48, 32, 64, 4
_models = {}


def _np(t):
    return np.array(t)


def _weights(seed, quant=None):
    """x [T, H], router [H, E], gate/up [E, H, I], down [E, I, H] from numpy
    (the JAX test's scales), as JAX arrays and as the port's tensors; with
    ``quant`` the expert stacks are the JAX quantizer's QTensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H)).astype(np.float32)
    wr = (0.1 * rng.standard_normal((H, E))).astype(np.float32)
    ws = [(0.1 * rng.standard_normal(s)).astype(np.float32)
          for s in ((E, H, I), (E, H, I), (E, I, H))]
    jw = [jnp.asarray(a) for a in (x, wr, *ws)]
    if quant:
        from mlio_tpu.ops.quant import quantize as jquantize

        jw[2:] = [jax.vmap(lambda w: jquantize(w, quant))(w) for w in jw[2:]]
    names = ("x", "wr", "wg", "wu", "wd")
    tw = from_jax_params(jax.tree.map(np.asarray, dict(zip(names, jw))), device="cpu")
    return jw, [tw[n] for n in names]


def test_router_topk_matches_jax_and_ties_take_lowest_index():
    jw, tw = _weights(0)
    want = jmoe.router_topk(jw[0], jw[1], 2)
    got = tmoe.router_topk(tw[0], tw[1], 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **OP_TOL)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    # a tie: experts 1 and 3 (and 0 and 2) share a logit, so the lowest wins
    x = np.ones((2, 4), np.float32)
    wr = np.zeros((4, 4), np.float32)
    wr[:, 1] = wr[:, 3] = 0.5
    want = jmoe.router_topk(jnp.asarray(x), jnp.asarray(wr), 3)
    got = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(wr), 3)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_array_equal(got[1].numpy(), [[1, 3, 0]] * 2)
    assert tmoe.topk_mask(got[2], 3).tolist() == [[True, True, False, True]] * 2


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("method", ["dense", "ragged"])
def test_moe_methods_match_jax(method, quant):
    """Dense and ragged against the JAX functions, with fp32 expert stacks
    and with int8/fp8 ones (dequantized one expert at a time)."""
    jw, tw = _weights(1, quant)
    jfn = {"dense": jmoe.moe_mlp_dense, "ragged": jmoe.moe_mlp_ragged}[method]
    tfn = {"dense": tmoe.moe_mlp_dense, "ragged": tmoe.moe_mlp_ragged}[method]
    want = jfn(jw[0], jw[1], jw[2], jw[3], jw[4], top_k=2)
    got = tfn(tw[0], tw[1], tw[2], tw[3], tw[4], top_k=2)
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5, 4.0])
def test_dispatch_matches_jax_including_drops(capacity_factor):
    """GShard dispatch with the JAX capacity rounding: at factors 0.25 and
    0.5 (8 and 16 slots an expert for 96 copies over 4 experts) copies drop
    (their combine weight 0), at 4 none does."""
    jw, tw = _weights(2)
    want = jmoe.moe_mlp_dispatch(jw[0], jw[1], jw[2], jw[3], jw[4], top_k=2,
                                 capacity_factor=capacity_factor)
    got = tmoe.moe_mlp_dispatch(tw[0], tw[1], tw[2], tw[3], tw[4], top_k=2,
                                capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)
    dense = tmoe.moe_mlp_dense(tw[0], tw[1], tw[2], tw[3], tw[4], top_k=2)
    dropped = not torch.allclose(got, dense, atol=1e-5, rtol=1e-5)
    assert dropped == (capacity_factor < 4.0)


def test_moe_mlp_dispatcher_and_load_balance_loss_match_jax():
    jw, tw = _weights(3)
    x3 = tw[0].reshape(4, T // 4, H)
    got = ops.moe_mlp(x3, tw[1], tw[2], tw[3], tw[4], top_k=2, method="ragged")
    want = jmoe.moe_mlp(jnp.asarray(x3.numpy()), jw[1], jw[2], jw[3], jw[4], top_k=2)
    assert got.shape == x3.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)
    with pytest.raises(ValueError, match="unknown method"):
        ops.moe_mlp(x3, tw[1], tw[2], tw[3], tw[4], top_k=2, method="expert")
    _, jidx, jprobs = jmoe.router_topk(jw[0], jw[1], 2)
    _, idx, probs = tmoe.router_topk(tw[0], tw[1], 2)
    np.testing.assert_allclose(tmoe.load_balance_loss(probs, idx, E).item(),
                               float(jmoe.load_balance_loss(jprobs, jidx, E)), **OP_TOL)


def _moe_model(weights=None):
    """(JAX params, port spec, port params) of moe-tiny in fp32, optionally
    quantized by the JAX package."""
    if weights not in _models:
        jspec = JAX_PRESETS["moe-tiny"]
        jparams = jax_init_params(jspec, jax.random.PRNGKey(1), dtype=jnp.float32)
        if weights:
            jparams = jax_quantize_params(jparams, jspec, weights)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        _models[weights] = jparams, ModelSpec(**dataclasses.asdict(jspec)), params
    return _models[weights]


def test_from_jax_params_carries_expert_stacks():
    """[L, E, ...] stacks, the router and expert QTensors (per-expert scales
    [L, E, out]) cross unchanged."""
    for weights in (None, "int8"):
        jparams, spec, params = _moe_model(weights)
        jb, b = jparams["blocks"], params["blocks"]
        np.testing.assert_array_equal(b["router"].numpy(), _np(jb["router"]))
        for name in ("moe_up", "moe_gate", "moe_down"):
            if weights:
                assert isinstance(b[name], QTensor) and b[name].fmt == "int8"
                assert b[name].scale.shape == (spec.num_layers, spec.num_experts,
                                               b[name].q.shape[-1])
                np.testing.assert_array_equal(b[name].q.numpy(), _np(jb[name].q))
                np.testing.assert_array_equal(b[name].scale.numpy(), _np(jb[name].scale))
            else:
                assert b[name].shape[:2] == (spec.num_layers, spec.num_experts)
                np.testing.assert_array_equal(b[name].numpy(), _np(jb[name]))
        assert b["w_up"] is None and b["w_down"] is None


@pytest.mark.parametrize("method", ["dense", "ragged", "dispatch"])
def test_forward_matches_jax(method):
    jparams, spec, params = _moe_model()
    ids = np.arange(2 * 24).reshape(2, 24) % spec.vocab_size
    want, _ = jax_forward(jparams, JAX_PRESETS["moe-tiny"], jnp.asarray(ids),
                          impl=JaxImpl(moe=method, moe_capacity_factor=4.0))
    got, _ = forward(params, spec, torch.from_numpy(ids),
                     impl=Impl(moe=method, moe_capacity_factor=4.0))
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


def test_forward_int8_experts_match_jax():
    jparams, spec, params = _moe_model("int8")
    ids = np.arange(2 * 10).reshape(2, 10) % spec.vocab_size
    want, _ = jax_forward(jparams, JAX_PRESETS["moe-tiny"], jnp.asarray(ids), impl=JaxImpl())
    got, _ = forward(params, spec, torch.from_numpy(ids), impl=Impl())
    np.testing.assert_allclose(got.numpy(), _np(want), **MODEL_TOL)


@pytest.mark.parametrize("stack", ["scan", "tiled"])
def test_cached_decode_matches_prefill(stack):
    """A cached decode step (the scan's MoE MLP, or K6's plain MoE phases)
    gives the prefill's logits at that position (tests/test_moe.py:98)."""
    _, spec, params = _moe_model()
    ids = torch.arange(2 * 8).reshape(2, 8) % spec.vocab_size
    full, _ = forward(params, spec, ids, impl=Impl(moe="ragged"))
    cache = init_cache(spec, 2, 16, dtype=torch.float32, device="cpu")
    impl = Impl(attention="flash", decode_stack=stack)
    _, cache = forward(params, spec, ids[:, :7], impl=impl, cache=cache)
    step, cache = forward(params, spec, ids[:, 7:8], impl=impl, cache=cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 7].numpy(), **MODEL_TOL)


@pytest.mark.parametrize("weights,cache_quant", [(None, None), ("int8", "int8")])
@pytest.mark.parametrize("stack", ["scan", "tiled", "auto"])
def test_generate_ids_match_jax(stack, weights, cache_quant):
    """Greedy ids on moe-tiny against the JAX package's, on the scan decode
    and on K6's MoE phases (what "auto" picks, as K4 refuses experts)."""
    jparams, spec, params = _moe_model(weights)
    ids = np.asarray([[5, 3, 2, 6], [1, 2, 3, 4]], np.int32)
    want = jax_generate(jparams, JAX_PRESETS["moe-tiny"], jnp.asarray(ids), max_new_tokens=5,
                        cache_len=128, cache_quant=cache_quant,
                        impl=JaxImpl(attention="flash", decode_stack=stack),
                        method=JaxSamplingMethod(temperature=0.0))
    before = dt.decode_layer_tiled.launches
    got = generate(params, spec, torch.from_numpy(ids), max_new_tokens=5, cache_len=128,
                   cache_quant=cache_quant, impl=Impl(attention="flash", decode_stack=stack),
                   method=SamplingMethod(temperature=0.0), device="cpu")
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert dt.decode_layer_tiled.launches == before  # the CPU launches nothing


def test_engine_serves_moe_like_jax():
    """The engine's per-op route runs the model's own MoE MLP: greedy ids
    equal to the JAX engine's (its per-op decode, synchronous loop); "auto"
    resolves to it, as K8 refuses experts."""
    jparams, spec, params = _moe_model()
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [2]]
    geometry = dict(max_batch=4, max_seq_len=64, block_size=16)
    want = JaxEngine(JAX_PRESETS["moe-tiny"], jparams, dtype=jnp.float32, decode_stack="perop",
                     **geometry).run(prompts, max_new_tokens=6, pipeline=False)
    eng = InferenceEngine(spec, params, dtype=torch.float32, device="cpu", **geometry)
    assert eng.decode_stack == "perop"
    assert eng.run(prompts, max_new_tokens=6) == want


def test_mixtral_logits_match_hf():
    """convert_mixtral (through load_model) against HF's MixtralForCausalLM
    built from a small config, offline (tests/test_moe.py:115's model):
    rtol 1e-3, atol 5e-3, that test's tolerance."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    cfg = MixtralConfig(
        vocab_size=257, hidden_size=48, intermediate_size=96, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=64, tie_word_embeddings=False,
        attention_dropout=0.0, router_jitter_noise=0.0)
    model = MixtralForCausalLM(cfg).eval()
    spec, params = load_model("mixtral-test", torch_model=model, dtype=torch.float32,
                              device="cpu")
    assert spec.num_experts == 4 and spec.num_experts_per_tok == 2
    assert params["blocks"]["moe_up"].shape == (3, 4, 48, 96)
    ids = np.random.default_rng(0).integers(0, 257, size=(2, 13))
    ours, _ = forward(params, spec, torch.from_numpy(ids), impl=Impl(moe="ragged"))
    with torch.no_grad():
        theirs = model(input_ids=torch.from_numpy(ids)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-3, atol=5e-3)


def test_init_params_moe_shapes_match_jax():
    spec = ModelSpec(**dataclasses.asdict(JAX_PRESETS["moe-tiny"]))
    got = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    want = jax_init_params(JAX_PRESETS["moe-tiny"], jax.random.PRNGKey(0), dtype=jnp.float32)
    for k, w in want["blocks"].items():
        g = got["blocks"][k]
        assert (g is None) == (w is None), k
        if w is not None:
            assert tuple(g.shape) == tuple(w.shape), k
