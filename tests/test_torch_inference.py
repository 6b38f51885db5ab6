"""The port's inference runner and A/B harness (``runtime/inference.py``) and
the fused and quantized forward against the JAX package, on the CPU.

Weights come from the JAX package's ``init_params`` (fp32) and reach the
port through ``from_jax_params``; token ids come from
``numpy.random.default_rng``. The JAX kernels run in Pallas interpret mode
(automatic off TPU; its quantized ``linear`` then multiplies by the
dequantised weight), the port's wrappers run their plain versions. Logits
differ by fp32 summation order only: atol = rtol = 1e-4, as in
tests/test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import Impl as JaxImpl
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.runtime import inference as jinf
from mlio_tpu.runtime import quantization as jquant
from mlio_tpu_torch.models import Impl, forward, from_jax_params, get_spec
from mlio_tpu_torch.models import utils as mutils
from mlio_tpu_torch.ops import fused_mlp as fm
from mlio_tpu_torch.ops import ln_qkv as lq
from mlio_tpu_torch.ops import quant as tq
from mlio_tpu_torch.runtime import (
    InferenceRunner,
    TransformerInferenceRunner,
    benchmark_optimization_impact,
    create_inference_runner,
    fuse_projections,
    quantize_params,
)
from mlio_tpu_torch.utils import device_utils

TOL = dict(atol=1e-4, rtol=1e-4)
MODELS = ["gpt2-tiny", "llama-tiny"]
FUSED = dict(attention="flash", mlp="fused", norm="fused", fused_ln_qkv=True)


def _both(name):
    """(JAX spec, JAX params, port spec, port params) with the same weights."""
    jspec = JAX_PRESETS[name]
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jspec, jparams, get_spec(name), from_jax_params(jax.tree.map(np.asarray, jparams),
                                                           device="cpu")


def _ids(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


# (precision, Impl fields, weight layout)
FORWARD_CASES = {
    "fp32_fused_ln_qkv": (None, FUSED, "split"),
    "int8_fused": ("int8", FUSED, "split"),
    "int8_dense": ("int8", {}, "split"),
    "int4_flash": ("int4", dict(attention="flash", norm="fused"), "split"),
    "fp32_fused_projections": (None, dict(attention="flash", mlp="fused"), "fused"),
    "int8_fused_projections": ("int8", {}, "fused"),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES), ids=list(FORWARD_CASES))
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name, case):
    precision, fields, layout = FORWARD_CASES[case]
    jspec, jparams, spec, params = _both(name)
    if precision:
        jparams = jquant.quantize_params(jparams, jspec, precision)
        params = quantize_params(params, spec, precision)
    if layout == "fused":
        jparams = jquant.fuse_projections(jparams, jspec)
        params = fuse_projections(params, spec)
    ids = _ids(spec.vocab_size, (2, 11))
    want, _ = jax_forward(jparams, jspec, jnp.asarray(ids), impl=JaxImpl(**fields))
    counts = (fm.fused_mlp.launches, lq.fused_norm_matmul.launches, tq.quant_matmul.launches)
    got, _ = forward(params, spec, torch.from_numpy(ids), impl=Impl(**fields))
    assert counts == (fm.fused_mlp.launches, lq.fused_norm_matmul.launches,
                      tq.quant_matmul.launches)  # CPU tensors take the plain versions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_ln_qkv_skips_the_separate_norm(monkeypatch):
    """With fused_ln_qkv the ln1 norm runs inside K12: K2 runs ln2 and the
    final norm only (2 layers: 3 calls, not 5)."""
    from mlio_tpu_torch.ops import norms

    spec, params = get_spec("gpt2-tiny"), _both("gpt2-tiny")[3]
    calls = []
    real = norms.fused_norm
    monkeypatch.setattr(norms, "fused_norm", lambda *a, **k: calls.append(1) or real(*a, **k))
    forward(params, spec, torch.zeros(1, 3, dtype=torch.long), impl=Impl(**FUSED))
    assert len(calls) == spec.num_layers + 1  # ln2 of each layer and the final norm


@pytest.fixture(scope="module")
def llama():
    jspec, jparams, spec, params = _both("llama-tiny")
    return jspec, jparams, spec, params


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8", "int4", "fp8"])
def test_runner_precisions_match_jax(llama, precision):
    jspec, jparams, spec, params = llama
    ids = np.zeros((1, 8), np.int32)
    r = InferenceRunner(spec, params, precision=precision, impl=Impl())
    out = r.run_inference(torch.from_numpy(ids))
    assert out["mean_ms"] > 0 and out["output"].shape == (1, 8, spec.vocab_size)
    jr = jinf.InferenceRunner(jspec, jparams, precision=precision, impl=JaxImpl())
    stats, jstats = r.quantization_stats(), jr.quantization_stats()
    assert stats == jstats
    assert (stats["quantized_tensors"] > 0) == (precision in ("int8", "int4", "fp8"))
    if precision == "fp32":  # the others run bf16 activations (quantized: bf16 first)
        want = np.asarray(jr.run_inference(jnp.asarray(ids))["output"])
        np.testing.assert_allclose(out["output"].float().numpy(), want, **TOL)


def test_runner_defaults_and_generate(llama):
    jspec, jparams, spec, params = llama
    r = InferenceRunner(spec, params, precision="fp32")
    assert r.impl == Impl()  # parameters on the CPU: the dense Impl
    assert r.device == torch.device("cpu")
    impl = dict(attention="flash", mlp="fused", norm="fused", decode_stack="scan")
    ids = _ids(spec.vocab_size, (2, 5), seed=1)
    got = InferenceRunner(spec, params, precision="fp32", impl=Impl(**impl)).generate(
        ids, max_new_tokens=5)
    want = jinf.InferenceRunner(jspec, jparams, precision="fp32",
                                impl=JaxImpl(**impl)).generate(jnp.asarray(ids),
                                                               max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="profiling"):
        r.profile_model(ids)
    with pytest.raises(NotImplementedError, match="int8 decode"):
        InferenceRunner(spec, params, precision="fp32", kv_quant="int8").generate(ids, 2)
    with pytest.raises(ValueError, match="precision"):
        InferenceRunner(spec, params, precision="fp64")


def test_transformer_runner_engine(llama):
    _, _, spec, params = llama
    r = TransformerInferenceRunner(spec, params, precision="fp32", impl=Impl())
    assert r.kv_cache_stats() == {"contiguous_cache_bytes_at_max":
                                  jinf.TransformerInferenceRunner(
                                      llama[0], llama[1], precision="fp32",
                                      impl=JaxImpl()).kv_cache_stats()[
                                      "contiguous_cache_bytes_at_max"]}
    eng = r.engine(max_batch=2, max_seq_len=32, dtype=torch.float32)
    outs = eng.run([[1, 2, 3]], max_new_tokens=3)
    assert len(outs[0]) == 3
    assert r.kv_cache_stats()["generated_tokens"] == 3


def test_quantized_runner_takes_the_per_op_decodes(llama):
    """K4 and K8 have no int8-weight path yet: a quantized runner's engine
    resolves to the per-op decode and its generate to the scan decode."""
    _, _, spec, params = llama
    r = TransformerInferenceRunner(spec, params, precision="int8",
                                   impl=Impl(attention="flash", norm="fused"))
    eng = r.engine(max_batch=2, max_seq_len=32, dtype=torch.bfloat16)
    assert eng.decode_stack == "perop"
    assert [len(o) for o in eng.run([[1, 2, 3], [4, 5]], max_new_tokens=3)] == [3, 3]
    assert r.generate(torch.tensor([[1, 2, 3]]), max_new_tokens=3).shape == (1, 6)


def test_create_inference_runner_dispatch(llama):
    _, _, spec, params = llama
    r = create_inference_runner(spec, params, model_type="transformer", precision="fp32",
                                impl=Impl())
    assert isinstance(r, TransformerInferenceRunner)
    r = create_inference_runner(spec, params, model_type="other", precision="fp32")
    assert type(r) is InferenceRunner
    with pytest.raises(NotImplementedError, match="diffusion"):
        create_inference_runner(spec, params, model_type="diffusion")


def test_ab_harness_default_configs(llama):
    jspec, jparams, spec, params = llama
    ids = np.zeros((1, 16), np.int32)
    results = benchmark_optimization_impact(spec, params, torch.from_numpy(ids), iters=1)
    want = jinf.benchmark_optimization_impact(jspec, jparams, jnp.asarray(ids), iters=1)
    assert list(results) == list(want)
    for name, entry in results.items():
        assert set(entry) == set(want[name]), name
        for key in ("precision", "quantized_tensors", "total_bytes"):
            assert entry[key] == want[name][key], (name, key)
        assert entry["mean_ms"] > 0 and entry["peak_bytes"] == 0  # no card: no device bytes
    assert results["baseline"]["speedup"] == 1.0
    assert results["int8_weights"]["total_bytes"] < results["baseline"]["total_bytes"]


def test_model_utils_match_jax(llama):
    from mlio_tpu.models import utils as jutils

    jspec, jparams, spec, params = llama
    for p, jp in ((params, jparams),
                  (quantize_params(params, spec, "int4"),
                   jquant.quantize_params(jparams, jspec, "int4"))):
        assert mutils.get_model_size(p) == jutils.get_model_size(jp)
        assert sorted(mutils.get_attention_params(p)) == sorted(jutils.get_attention_params(jp))
        assert sorted(mutils.get_mlp_params(p)) == sorted(jutils.get_mlp_params(jp))
    assert mutils.theoretical_flops(spec, 2, 16) == jutils.theoretical_flops(jspec, 2, 16)
    assert mutils.count_macs(spec, 2, 16) == jutils.count_macs(jspec, 2, 16)
    assert mutils.model_summary(spec, params) == jutils.model_summary(jspec, jparams)
    q = quantize_params(params, spec, "int8")
    bf = mutils.convert_precision(q, torch.bfloat16)
    assert bf["tok_embed"].dtype == torch.bfloat16
    assert bf["blocks"]["wq"] is q["blocks"]["wq"]  # a QTensor stays whole
    new, loaded, missing = mutils.load_partial_state(
        params, {"tok_embed": np.ones((spec.vocab_size, spec.hidden_size), np.float32),
                 "blocks/wq": np.zeros((1, 1)), "nope": np.zeros(1)})
    assert loaded == ["tok_embed"] and sorted(missing) == ["blocks/wq", "nope"]
    assert float(new["tok_embed"].sum()) == spec.vocab_size * spec.hidden_size
    assert new["blocks"]["wk"] is params["blocks"]["wk"]
    with pytest.raises(ValueError, match="shape mismatch"):
        mutils.load_partial_state(params, {"blocks/wq": np.zeros((1, 1))}, strict=True)


def test_device_utils_on_the_cpu():
    mem = device_utils.get_device_memory_usage("cpu")
    assert mem["bytes_in_use"] == mem["peak_bytes_in_use"] == mem["bytes_limit"] == 0
    need = device_utils.calculate_memory_needed(124_000_000, batch_size=8, seq_len=1024)
    from mlio_tpu.utils.tpu_utils import calculate_memory_needed

    assert need == calculate_memory_needed(124_000_000, batch_size=8, seq_len=1024)
    assert device_utils.is_enough_device_memory(1024, "cpu")
    assert isinstance(device_utils.device_info_string(), str)
    device_utils.clear_device_memory()
