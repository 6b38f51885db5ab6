"""The fused MLP (K11) and fused norm + matmul (K12) against the JAX package.

The same numpy inputs (``numpy.random.default_rng``) go to the JAX kernels,
run in Pallas interpret mode on the CPU as the JAX tests run them, and to
the port's wrappers on CPU tensors, which run the kernels' plain versions.
Both compute in fp32 and differ by summation order only: rtol = 1e-5 with
atol = 1e-5 of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from mlio_tpu.ops.ln_qkv import fused_ln_qkv as jax_fused_ln_qkv
from mlio_tpu.ops.ln_qkv import fused_norm_matmul as jax_fused_norm_matmul
from mlio_tpu_torch.ops import fused_mlp as fm
from mlio_tpu_torch.ops import ln_qkv as lq
from mlio_tpu_torch.ops import mlp_reference


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", ["gelu_new", "gelu", "relu", "swiglu", "geglu"])
def test_fused_mlp_matches_jax(activation, bias):
    rng = np.random.default_rng(0)
    M, H, I = 13, 64, 160  # M not a multiple of 8, I not one of the JAX block
    gated = activation in ("swiglu", "geglu")
    x = _randn(rng, M, H)
    w_up, w_down = _randn(rng, H, I, scale=H ** -0.5), _randn(rng, I, H, scale=I ** -0.5)
    w_gate = _randn(rng, H, I, scale=H ** -0.5) if gated else None
    b = dict(b_up=_randn(rng, I, scale=0.1), b_down=_randn(rng, H, scale=0.1),
             b_gate=_randn(rng, I, scale=0.1) if gated else None) if bias else {}
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in b.items()}
    want = jax_fused_mlp(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down),
                         w_gate=None if w_gate is None else jnp.asarray(w_gate),
                         activation=activation, block_m=8, block_i=128, interpret=True, **j)
    t = {k: (None if v is None else torch.from_numpy(v)) for k, v in b.items()}
    tg = None if w_gate is None else torch.from_numpy(w_gate)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(torch.from_numpy(x), torch.from_numpy(w_up), torch.from_numpy(w_down),
                       w_gate=tg, activation=activation, **t)
    assert fm.fused_mlp.launches == before  # CPU tensors run the plain version
    assert got.shape == x.shape
    _close(got, want)
    ref = mlp_reference(torch.from_numpy(x), torch.from_numpy(w_up), torch.from_numpy(w_down),
                        w_gate=tg, activation=activation, **t)
    _close(got, ref.numpy())


@pytest.mark.parametrize("activation", fm.ACTIVATIONS)
def test_fused_mlp_matches_jax_past_the_tiles(activation):
    """Two rows past the card kernel's 128-row tile, H eight columns past a
    64-deep K tile, and I past one 256-column chunk and not a multiple of 64
    (nor of the JAX kernel's 128-wide blocks), so the down product's sum runs
    over a ragged second chunk."""
    rng = np.random.default_rng(5)
    M, H, I = 130, 72, 300
    gated = activation in ("swiglu", "geglu")
    x = _randn(rng, M, H)
    w_up, w_down = _randn(rng, H, I, scale=H ** -0.5), _randn(rng, I, H, scale=I ** -0.5)
    w_gate = _randn(rng, H, I, scale=H ** -0.5) if gated else None
    b = dict(b_up=_randn(rng, I, scale=0.1), b_down=_randn(rng, H, scale=0.1),
             b_gate=_randn(rng, I, scale=0.1) if gated else None)
    want = jax_fused_mlp(jnp.asarray(x), jnp.asarray(w_up), jnp.asarray(w_down),
                         w_gate=None if w_gate is None else jnp.asarray(w_gate),
                         activation=activation, block_m=136, block_i=128, interpret=True,
                         **{k: (None if v is None else jnp.asarray(v)) for k, v in b.items()})
    got = fm.fused_mlp(torch.from_numpy(x), torch.from_numpy(w_up), torch.from_numpy(w_down),
                       w_gate=None if w_gate is None else torch.from_numpy(w_gate),
                       activation=activation,
                       **{k: (None if v is None else torch.from_numpy(v)) for k, v in b.items()})
    assert got.shape == (M, H)
    _close(got, want)


def test_fused_mlp_plain_rounds_the_activation_like_the_kernel():
    """In bf16 the activation is rounded to bf16 before the down product and
    b_down is added after the output's rounding, as in the JAX kernel."""
    rng = np.random.default_rng(1)
    x, wu, wd = (torch.from_numpy(_randn(rng, *s)).bfloat16() for s in
                 ((5, 32), (32, 64), (64, 32)))
    bd = torch.from_numpy(_randn(rng, 32)).bfloat16()
    a = fm.activate(x.float() @ wu.float(), None, "gelu_new").bfloat16()
    want = (a.float() @ wd.float()).bfloat16() + bd
    assert torch.equal(fm.fused_mlp_plain(x, wu, wd, b_down=bd), want)


def test_fused_mlp_refuses_bad_shapes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="w_gate"):
        fm.fused_mlp(x, torch.zeros(8, 4), torch.zeros(4, 8), activation="swiglu")
    with pytest.raises(ValueError, match="w_down"):
        fm.fused_mlp(x, torch.zeros(8, 4), torch.zeros(8, 4))
    with pytest.raises(ValueError, match="activation"):
        fm.fused_mlp(x, torch.zeros(8, 4), torch.zeros(4, 8), activation="tanh")


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_fused_norm_matmul_matches_jax(kind, bias):
    rng = np.random.default_rng(2)
    x = _randn(rng, 3, 7, 64) + 0.5
    w = _randn(rng, 64, 200, scale=0.125)
    scale, b = 1 + _randn(rng, 64, scale=0.1), _randn(rng, 64, scale=0.1)
    want = jax_fused_norm_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                 jnp.asarray(b) if bias else None, kind=kind, block_m=8,
                                 block_n=128, interpret=True)
    got = lq.fused_norm_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(scale), torch.from_numpy(b) if bias else None,
                               kind=kind)
    assert got.shape == (3, 7, 200)
    _close(got, want)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_fused_norm_matmul_matches_jax_past_the_tiles(kind, bias):
    """One row, eight columns of H and eight of N past a tile (the card
    kernel's 64-deep K tiles; the JAX kernel's 8 x 128 blocks), W in three
    parts that the port reads in place."""
    rng = np.random.default_rng(4)
    x = _randn(rng, 9, 72) + 0.5
    w = _randn(rng, 72, 136, scale=72 ** -0.5)
    scale, b = 1 + _randn(rng, 72, scale=0.1), _randn(rng, 72, scale=0.1)
    want = jax_fused_norm_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                 jnp.asarray(b) if bias else None, kind=kind, block_m=8,
                                 block_n=128, interpret=True)
    parts = [torch.from_numpy(np.ascontiguousarray(w[:, a:z])) for a, z in ((0, 72), (72, 104),
                                                                           (104, 136))]
    got = lq.fused_norm_matmul(torch.from_numpy(x), None, torch.from_numpy(scale),
                               torch.from_numpy(b) if bias else None, kind=kind, parts=parts)
    assert got.shape == (9, 136)
    _close(got, want)


# (kind, Hq, Hkv, with q/k/v biases)
QKV_CASES = {
    "layernorm_mha_bias": ("layernorm", 4, 4, True),
    "rmsnorm_gqa4": ("rmsnorm", 8, 2, False),
    "rmsnorm_mqa_bias": ("rmsnorm", 4, 1, True),
}


@pytest.mark.parametrize("case", list(QKV_CASES), ids=list(QKV_CASES))
def test_fused_ln_qkv_matches_jax(case):
    kind, hq, hkv, qkv_bias = QKV_CASES[case]
    rng = np.random.default_rng(3)
    H, D = 64, 16
    x = _randn(rng, 2, 9, H)
    ln_s, ln_b = 1 + _randn(rng, H, scale=0.1), _randn(rng, H, scale=0.1)
    ws = [_randn(rng, H, n * D, scale=0.125) for n in (hq, hkv, hkv)]
    bs = [_randn(rng, n * D, scale=0.1) if qkv_bias else None for n in (hq, hkv, hkv)]
    ln_bias = ln_b if kind == "layernorm" else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want = jax_fused_ln_qkv(j(x), j(ln_s), j(ln_bias), j(ws[0]), j(bs[0]), j(ws[1]), j(bs[1]),
                            j(ws[2]), j(bs[2]), kind=kind, interpret=True)
    before = lq.fused_norm_matmul.launches
    got = lq.fused_ln_qkv(t(x), t(ln_s), t(ln_bias), t(ws[0]), t(bs[0]), t(ws[1]), t(bs[1]),
                          t(ws[2]), t(bs[2]), kind=kind)
    assert lq.fused_norm_matmul.launches == before
    for g, w, n in zip(got, want, (hq, hkv, hkv)):
        assert g.shape == (2, 9, n * D)
        _close(g, w)


def test_fused_norm_matmul_plain_rounds_the_norm_like_the_kernel():
    """In bf16 the normalised x is rounded to bf16 before the product."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_randn(rng, 6, 32)).bfloat16()
    w = torch.from_numpy(_randn(rng, 32, 24)).bfloat16()
    s = torch.ones(32, dtype=torch.bfloat16)
    xn = torch.nn.functional.layer_norm(x.float(), (32,), eps=1e-5).bfloat16()
    assert torch.equal(lq.fused_norm_matmul_plain(x, w, s),
                       (xn.float() @ w.float()).bfloat16())


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    from mlio_tpu_torch.ops import quant as tq

    m = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        fm.fused_mlp(m, torch.empty(64, 32, device="meta"), torch.empty(32, 64, device="meta"))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        lq.fused_norm_matmul(m, torch.empty(64, 32, device="meta"), torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        tq.quant_matmul(m, torch.empty(64, 32, dtype=torch.int8, device="meta"),
                        torch.empty(32, device="meta"))
