"""The port's quantization (``mlio_tpu_torch/ops/quant.py``,
``runtime/quantization.py``) against the JAX package's, on the CPU.

Weights and inputs come from ``numpy.random.default_rng``. The quantizers
must give the JAX package's payloads and scales bit for bit; K5's plain
version is held against the JAX kernels in Pallas interpret mode in fp32,
where the two differ by summation order only: rtol = 1e-5 of the largest
output (atol = 1e-5 * max |out|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import get_spec as jax_get_spec
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.ops import quant as jq
from mlio_tpu.runtime import quantization as jquant
from mlio_tpu_torch.models import from_jax_params, get_spec
from mlio_tpu_torch.ops import quant as tq
from mlio_tpu_torch.runtime import fuse_projections, quantize_params, quantized_size_bytes


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _payload(a):
    """A payload as comparable integers (fp8 by its bytes)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == tq.FP8 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


# (fmt, K, N, group_size); K = 40 leaves int4 no power-of-two group (K/2 = 20)
QUANTIZER_CASES = {
    "int8": ("int8", 64, 48, None),
    "int4_per_channel": ("int4", 64, 48, None),
    "int4_g128": ("int4", 512, 40, 128),
    "int4_g_falls_back_to_16": ("int4", 96, 24, 128),
    "int4_no_group": ("int4", 40, 24, 128),
    "fp8": ("fp8", 64, 48, None),
}


@pytest.mark.parametrize("case", list(QUANTIZER_CASES), ids=list(QUANTIZER_CASES))
def test_quantizers_bit_equal_to_jax(case):
    fmt, K, N, gs = QUANTIZER_CASES[case]
    rng = np.random.default_rng(0)
    w = _randn(rng, 3, K, N)
    w[0, :, 1] = 0.0      # an all-zero channel takes scale 1
    w[1, 5, :] *= 30.0    # an outlier row
    if fmt == "int4":
        jfn = lambda a: jq.quantize_int4(a, group_size=gs)  # noqa: E731
        got = tq.quantize_int4(torch.from_numpy(w), group_size=gs)
    else:
        jfn = lambda a: jq.quantize(a, fmt)  # noqa: E731
        got = tq.quantize(torch.from_numpy(w), fmt)
    want = jax.vmap(jfn)(jnp.asarray(w))
    assert got.fmt == want.fmt
    np.testing.assert_array_equal(_payload(got.q), _payload(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if case == "int4_g128":
        assert got.scale.shape == (3, K // 128, N)
    if case == "int4_g_falls_back_to_16":
        assert got.scale.shape == (3, K // 16, N)
    if case == "int4_no_group":
        assert got.scale.shape == (3, N)
    for layer in range(3):  # the JAX dequantize takes one [K, N] matrix
        one = jax.tree.map(lambda a: a[layer], want)
        np.testing.assert_array_equal(tq.dequantize(got.select(layer)).numpy(),
                                      np.asarray(jq.dequantize(one)))
        if fmt == "int4":
            np.testing.assert_array_equal(tq.unpack_int4(got.q[layer]).numpy(),
                                          np.asarray(jq.unpack_int4(one.q)))


def test_int4_group_size_matches_jax():
    for K in (2, 32, 40, 96, 256, 512, 4096, 14336):
        for g in (16, 64, 128):
            assert tq.int4_group_size(K, g) == jq.int4_group_size(K, g), (K, g)


# (fmt, group_size, M, K, N): ragged M and N (the JAX wrapper pads them)
QM_CASES = {
    "int8": ("int8", None, 37, 256, 200),
    "int8_ragged_k": ("int8", None, 40, 200, 136),
    "int4": ("int4", None, 37, 512, 136),
    "int4_g128": ("int4", 128, 45, 512, 136),
    "int4_g64": ("int4", 64, 9, 256, 130),
    # past the card kernel's tiles: 130 rows (128-row tiles), N past 256
    # (int8) and 128 (int4) columns, K not a multiple of 64, K/2 = 384 over
    # six 64-row steps with groups of 16 and 64
    "int8_past_the_tiles": ("int8", None, 130, 200, 264),
    "int4_past_the_tiles": ("int4", None, 130, 768, 264),
    "int4_g16_past_the_tiles": ("int4", 16, 130, 768, 264),
    "int4_g64_past_the_tiles": ("int4", 64, 130, 768, 264),
}


@pytest.mark.parametrize("case", list(QM_CASES), ids=list(QM_CASES))
def test_quant_matmul_plain_matches_jax_kernel(case):
    fmt, gs, M, K, N = QM_CASES[case]
    rng = np.random.default_rng(1)
    x, w = _randn(rng, M, K), _randn(rng, K, N)
    t = (jq.quantize_int4(jnp.asarray(w), group_size=gs) if fmt == "int4"
         else jq.quantize_int8(jnp.asarray(w)))
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), t.q, t.scale, fmt=fmt, block_m=32,
                                      block_n=128, block_k=128, interpret=True))
    got = tq.quant_matmul(torch.from_numpy(x), torch.from_numpy(np.array(t.q)),
                          torch.from_numpy(np.array(t.scale)), fmt=fmt)
    assert got.shape == (M, N)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)
    # the same product through the dequantised weight
    deq = tq.dequantize(tq.QTensor(torch.from_numpy(np.array(t.q)),
                                   torch.from_numpy(np.array(t.scale)), fmt))
    np.testing.assert_allclose(got.numpy(), (torch.from_numpy(x) @ deq).numpy(), rtol=1e-5,
                               atol=tol)


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_linear_dispatch_matches_jax(fmt):
    rng = np.random.default_rng(2)
    x, w, b = _randn(rng, 2, 5, 64), _randn(rng, 64, 48), _randn(rng, 48)
    jt = jq.quantize(jnp.asarray(w), fmt)
    want = np.asarray(jq.linear(jnp.asarray(x), jt, jnp.asarray(b), interpret=True))
    tt = tq.quantize(torch.from_numpy(w), fmt)
    got = tq.linear(torch.from_numpy(x), tt, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    before = tq.quant_matmul.launches
    tq.linear(torch.from_numpy(x), tt)
    assert tq.quant_matmul.launches == before  # CPU tensors launch nothing


def test_linear_refuses_w8a8_and_kernel_refuses_bad_groups():
    t = tq.quantize_int8(torch.randn(16, 8))
    with pytest.raises(NotImplementedError, match="W8A8"):
        tq.linear(torch.randn(2, 16), tq.QTensor(t.q, t.scale, "int8", torch.ones(())))
    t4 = tq.quantize_int4(torch.randn(64, 8), group_size=None)
    with pytest.raises(ValueError, match="groups"):
        tq.quant_matmul(torch.randn(2, 64), t4.q, torch.ones(8, 8), fmt="int4")
    with pytest.raises(ValueError, match="fmt"):
        tq.quant_matmul(torch.randn(2, 64), t4.q, t4.scale, fmt="fp8")


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_from_jax_params_carries_qtensors(fmt):
    spec = jax_get_spec("gpt2-tiny")
    jparams = jquant.quantize_params(
        jax_init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32), spec, fmt,
        quantize_lm_head=True)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu",
                             dtype=torch.bfloat16)
    for name in jquant.QUANTIZABLE:
        want, got = jparams["blocks"][name], params["blocks"][name]
        if want is None:
            assert got is None
            continue
        assert isinstance(got, tq.QTensor) and got.fmt == fmt and got.act_scale is None
        np.testing.assert_array_equal(_payload(got.q), _payload(want.q))
        assert got.scale.dtype == torch.float32  # dtype casts floats, not a QTensor
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert params["blocks"]["ln1_scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_quantize_params_and_size_match_jax(name, fmt):
    jspec = jax_get_spec(name)
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = jquant.quantize_params(jparams, jspec, fmt)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    got = quantize_params(params, get_spec(name), fmt)
    assert isinstance(params["blocks"]["wq"], torch.Tensor)  # the input is left whole
    for k in jquant.QUANTIZABLE:
        if want["blocks"][k] is None:
            continue
        np.testing.assert_array_equal(_payload(got["blocks"][k].q),
                                      _payload(want["blocks"][k].q))
        np.testing.assert_array_equal(got["blocks"][k].scale.numpy(),
                                      np.asarray(want["blocks"][k].scale))
    assert quantized_size_bytes(got) == jquant.quantized_size_bytes(want)
    assert quantized_size_bytes(params) == jquant.quantized_size_bytes(jparams)


def test_quantize_params_donate_consumes_the_input():
    spec = get_spec("gpt2-tiny")
    jparams = jax_init_params(jax_get_spec("gpt2-tiny"), jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    kept = quantize_params(params, spec, "int8")
    out = quantize_params(params, spec, "int8", donate=True)
    assert out["blocks"] is params["blocks"]  # the caller's dict now holds the QTensors
    for k in ("wq", "w_up", "w_down"):
        assert isinstance(params["blocks"][k], tq.QTensor)
        assert torch.equal(out["blocks"][k].q, kept["blocks"][k].q)


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
@pytest.mark.parametrize("fmt", [None, "int8"])
def test_fuse_projections_matches_jax(name, fmt):
    jspec = jax_get_spec(name)
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    if fmt:
        jparams = jquant.quantize_params(jparams, jspec, fmt)
        params = quantize_params(params, get_spec(name), fmt)
    want = jquant.fuse_projections(jparams, jspec)
    got = fuse_projections(params, get_spec(name))
    assert set(got["blocks"]) == set(want["blocks"])
    for k in ("wqkv", "bqkv", "w_upgate", "b_upgate"):
        w, g = want["blocks"].get(k), got["blocks"].get(k)
        if w is None:
            assert g is None, k
        elif isinstance(g, tq.QTensor):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kv_quantizers_match_jax():
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 7, 3, 64)
    x[0, 0, 0] = 0.0
    jqv, jsc = jq.quantize_kv(jnp.asarray(x))
    q, sc = tq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(tq.dequantize_kv(q, sc).numpy(),
                                  np.asarray(jq.dequantize_kv(jqv, jsc)))


# ---------------------------------------------------------------------------
# MoE expert stacks and the quantized random init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_params_moe_matches_jax(fmt):
    """quantize_params on an MoE tree: the expert stacks get per-expert
    per-output-channel scales [L, E, out], payloads and scales bit for bit
    the JAX package's; the router stays as it is."""
    jspec = jax_get_spec("moe-tiny")
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = jquant.quantize_params(jparams, jspec, fmt)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    got = quantize_params(params, get_spec("moe-tiny"), fmt)
    L, E = jspec.num_layers, jspec.num_experts
    for k in jquant.QUANTIZABLE + jquant.QUANTIZABLE_MOE:
        if want["blocks"][k] is None:
            assert got["blocks"][k] is None
            continue
        np.testing.assert_array_equal(_payload(got["blocks"][k].q),
                                      _payload(want["blocks"][k].q))
        np.testing.assert_array_equal(got["blocks"][k].scale.numpy(),
                                      np.asarray(want["blocks"][k].scale))
    assert got["blocks"]["moe_down"].scale.shape == (L, E, jspec.hidden_size)
    assert isinstance(got["blocks"]["router"], torch.Tensor)
    assert quantized_size_bytes(got) == jquant.quantized_size_bytes(want)


def _structure(tree):
    """{path: (shape, dtype name, fmt)} of a parameter tree of either package."""
    out = {}

    def walk(node, path):
        if node is None:
            out[path] = None
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif hasattr(node, "fmt"):
            out[path] = (tuple(node.q.shape), tuple(node.scale.shape), str(node.fmt))
        else:
            out[path] = (tuple(node.shape), str(node.dtype).replace("torch.", ""))

    walk(tree, "")
    return out


@pytest.mark.parametrize("name", ["moe-tiny", "llama-tiny"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_init_quantized_params_matches_jax_layout(name, fmt):
    """init_quantized_params: the JAX package's tree (shapes, dtypes, formats,
    with the quantized head), its scale constants fan_in ** -0.5 / 64 bit for
    bit, payloads over the int8 range (cast to e4m3 for fp8), and a forward
    that runs."""
    from mlio_tpu_torch.models import Impl, forward
    from mlio_tpu_torch.runtime.quantization import init_quantized_params

    jspec = jax_get_spec(name)
    want = jquant.init_quantized_params(jspec, jax.random.PRNGKey(0), fmt, dtype=jnp.bfloat16,
                                        quantize_lm_head=True)
    spec = get_spec(name)
    got = init_quantized_params(spec, torch.Generator().manual_seed(0), fmt,
                                quantize_lm_head=True, device="cpu")
    assert _structure(got) == _structure(want)
    leaves = {k: v for k, v in got["blocks"].items() if isinstance(v, tq.QTensor)}
    leaves["lm_head"] = got["lm_head"]
    assert set(leaves) >= {"wq", "wo"} | ({"moe_up", "moe_down"} if spec.num_experts else set())
    for k, t in leaves.items():
        w = want[k] if k == "lm_head" else want["blocks"][k]
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(w.scale))
        vals = t.q.float()
        top = 127 if fmt == "int8" else 128  # e4m3 rounds 127 (and 125, 126) to 128
        assert 100 <= vals.abs().max() <= top
        if fmt == "fp8":
            ints = torch.arange(-127, 128, dtype=torch.float32)
            assert torch.isin(vals, ints.to(tq.FP8).float()).all()
        else:
            assert torch.equal(vals, vals.round())
    ids = torch.arange(8).reshape(1, 8)
    logits, _ = forward(got, spec, ids, impl=Impl())
    assert logits.shape == (1, 8, spec.vocab_size) and torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("fn", ["init_quantized_params", "streamed_quantized_init"])
@pytest.mark.parametrize("card", [False, True])
def test_quantized_init_runs_on_the_card_unless_asked(fn, card, monkeypatch):
    """Both builds default to the card, as init_params does: with no card
    they raise rather than build on the CPU, and with one they refuse a
    generator that lives elsewhere."""
    from mlio_tpu_torch.runtime import quantization as rq

    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    err, match = (ValueError, "generator lives on cpu") if card else (RuntimeError, "no CUDA")
    with pytest.raises(err, match=match):
        getattr(rq, fn)(get_spec("moe-tiny"), torch.Generator().manual_seed(0), "int8")


@pytest.mark.parametrize("name", ["moe-tiny", "llama-tiny"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_streamed_quantized_init_equals_init_then_quantize(name, fmt):
    """streamed_quantized_init gives quantize_params(init_params(...)) from
    the same generator state bit for bit (the JAX package's contract,
    tests/test_quantization.py), experts included."""
    from mlio_tpu_torch.models import init_params
    from mlio_tpu_torch.runtime.quantization import streamed_quantized_init

    spec = get_spec(name)
    got = streamed_quantized_init(spec, torch.Generator().manual_seed(3), fmt,
                                  dtype=torch.bfloat16, device="cpu")
    want = quantize_params(init_params(spec, torch.Generator().manual_seed(3),
                                       dtype=torch.bfloat16, device="cpu"), spec, fmt)
    assert _structure(got) == _structure(want)
    for k, w in want["blocks"].items():
        g = got["blocks"][k]
        if isinstance(w, tq.QTensor):
            np.testing.assert_array_equal(_payload(g.q), _payload(w.q))
            assert torch.equal(g.scale, w.scale)
        elif w is not None:
            assert torch.equal(g, w), k
    for k in ("tok_embed", "lm_head"):
        if want[k] is not None:
            assert torch.equal(got[k], want[k])
