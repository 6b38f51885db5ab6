"""The port's kernel modules against the JAX package's Pallas kernels.

Each case hands the same numpy inputs (``numpy.random.default_rng``) to the
JAX kernel, run in Pallas interpret mode on the CPU as the JAX tests run
it, and to the port's wrapper on CPU tensors, which runs the kernel's plain
PyTorch version. Both compute in fp32, so they differ by summation order
only: atol = rtol = 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu.ops.norms import fused_norm as jax_fused_norm
from mlio_tpu_torch.ops import attention_reference
from mlio_tpu_torch.ops.decode_attention import decode_attention
from mlio_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from mlio_tpu_torch.ops.norms import fused_norm

TOL = dict(atol=1e-4, rtol=1e-4)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (Hq, Hkv, Sq, Skv, causal, q_offset, kv_len)
FLASH_CASES = {
    "causal_mha": (4, 4, 20, 20, True, 0, None),
    "causal_gqa4_offset_ragged": (8, 2, 5, 32, True, 11, [16, 13]),
    "row_without_keys": (4, 4, 6, 24, True, 0, [0, 9]),
    "full_ragged_mqa": (4, 1, 7, 32, False, 0, [32, 7]),
    "causal_scalar_kv_len": (4, 2, 9, 32, True, 3, 12),
    # one row and one key past a 64-row tile, the second sequence's keys
    # ending inside the first tile: the card kernel's tile edges
    "causal_gqa4_past_tile_ragged": (8, 2, 65, 80, True, 0, [80, 41]),
}


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_attention_matches_jax(case):
    Hq, Hkv, Sq, Skv, causal, q_offset, kv_len = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    B, D = 2, 64
    q, k, v = _randn(rng, B, Sq, Hq, D), _randn(rng, B, Skv, Hkv, D), _randn(rng, B, Skv, Hkv, D)
    jax_kv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_offset=q_offset, kv_len=jax_kv, interpret=True)
    torch_kv = kv_len if not isinstance(kv_len, list) else torch.tensor(kv_len)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, q_offset=q_offset, kv_len=torch_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, q_offset=q_offset, kv_len=torch_kv)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    if case == "row_without_keys":
        assert not got[0].any(), "a row with no valid key must give 0"


def test_flash_plain_rounds_like_the_kernel_in_bf16():
    """In bf16 the plain version keeps the kernel's roundings (q*scale and p
    cast to bf16), so it stays within bf16 noise of the fp32 reference."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 16, 2, 64)) for _ in range(3))
    got = flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    ref = attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), atol=2e-2, rtol=2e-2)


# (kind, with_bias, residual_alpha or None)
NORM_CASES = {
    "layernorm": ("layernorm", True, None),
    "layernorm_residual": ("layernorm", True, 1.0),
    "layernorm_residual_alpha": ("layernorm", True, 0.5),
    "rmsnorm": ("rmsnorm", False, None),
    "rmsnorm_residual_alpha": ("rmsnorm", False, 0.25),
}


@pytest.mark.parametrize("case", list(NORM_CASES), ids=list(NORM_CASES))
def test_fused_norm_matches_jax(case):
    kind, with_bias, alpha = NORM_CASES[case]
    rng = np.random.default_rng(2)
    x, res = _randn(rng, 3, 5, 64), _randn(rng, 3, 5, 64)
    scale, bias = 1 + 0.1 * _randn(rng, 64), 0.1 * _randn(rng, 64)
    kw = dict(kind=kind, eps=1e-5)
    if alpha is not None:
        kw["residual_alpha"] = alpha
    want = jax_fused_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias) if with_bias else None,
                          residual=jnp.asarray(res) if alpha is not None else None,
                          interpret=True, **kw)
    got = fused_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias) if with_bias else None,
                     residual=torch.from_numpy(res) if alpha is not None else None, **kw)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("group", [1, 4], ids=["mha", "gqa4"])
@pytest.mark.parametrize("layer", [0, 2])
def test_decode_attention_matches_jax(group, layer):
    rng = np.random.default_rng(3 + group + layer)
    L, B, Smax, Hkv, D = 3, 4, 32, 2, 64
    q = _randn(rng, B, Hkv * group, D)
    kc, vc = _randn(rng, L, B, Smax, Hkv, D), _randn(rng, L, B, Smax, Hkv, D)
    ctx = np.array([1, Smax, 17, 9], np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(ctx), layer=layer, interpret=True)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.from_numpy(ctx), layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_attention_empty_context_gives_zero():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_randn(rng, 2, 4, 64))
    kc = torch.from_numpy(_randn(rng, 1, 2, 8, 2, 64))
    out = decode_attention(q, kc, kc.clone(), torch.tensor([0, 3], dtype=torch.int32), layer=0)
    assert not out[0].any() and out[1].abs().sum() > 0


def test_unported_options_raise():
    q = torch.zeros(1, 4, 2, 64)
    # user masks are ported (tests/test_torch_masks.py): an all-ones key mask
    # changes nothing, and a mask of the wrong shape raises as in JAX
    np.testing.assert_array_equal(flash_attention(q, q, q, mask=torch.ones(1, 4)).numpy(),
                                  flash_attention(q, q, q).numpy())
    with pytest.raises(ValueError, match="mask"):
        flash_attention(q, q, q, mask=torch.ones(1, 5))
    # return_stats is ported (K1's and K10's lse instances): (o, lse) as the
    # JAX function returns them
    rng = np.random.default_rng(4)
    qs, ks, vs = (_randn(rng, 2, 6, 4, 64) for _ in range(3))
    want_o, want_lse = jax_flash_attention(jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs),
                                           kv_len=jnp.asarray([6, 0], jnp.int32),
                                           return_stats=True, interpret=True)
    o, lse = flash_attention(torch.from_numpy(qs), torch.from_numpy(ks), torch.from_numpy(vs),
                             kv_len=torch.tensor([6, 0]), return_stats=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(np.asarray(want_lse)))
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(want_lse)[0], **TOL)
    # INT8 K/V scales are ported (K3's int8 instances): the result is the
    # attention over the dequantized cache
    rng = np.random.default_rng(5)
    qd = torch.from_numpy(_randn(rng, 1, 2, 64))
    kc = torch.from_numpy(rng.integers(-127, 128, (1, 1, 4, 2, 64)).astype(np.int8))
    vc = torch.from_numpy(rng.integers(-127, 128, (1, 1, 4, 2, 64)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(0.005, 0.02, (1, 1, 4, 2)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.005, 0.02, (1, 1, 4, 2)).astype(np.float32))
    got = decode_attention(qd, kc, vc, torch.full((1,), 3, dtype=torch.int32), layer=0,
                           k_scales=ks, v_scales=vs)
    want = attention_reference(qd[:, None], kc[0] * ks[0][..., None], vc[0] * vs[0][..., None],
                               causal=False, kv_len=3)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
