"""The port's position-hashed dropout against the JAX package, on the CPU.

The masks (``ops/dropmask.py``) must equal the JAX package's bit for bit:
the port carries the int32 hash's bit patterns in int64, so these cases take
positions past 65,536 and seeds whose products and folds overflow int32.
Attention with dropout (the dense reference and K1's plain version) gets
the same numpy inputs as the JAX functions (K1 in Pallas interpret mode) and
is compared in fp32 within atol = rtol = 1e-4 (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops import dropmask as jdm
from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu.ops.reference import attention_reference as jax_attention_reference
from mlio_tpu_torch.ops import attention_reference, dropmask
from mlio_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(atol=1e-4, rtol=1e-4)
SEEDS = [0, 7, 2**31 - 1, -2**31, -123456789, 1234567891]


def _grid(lo_i, lo_j, n=96, m=80, step=997):
    i = np.arange(lo_i, lo_i + n, dtype=np.int32)[:, None]
    j = (np.arange(m, dtype=np.int64) * step + lo_j).astype(np.int32)[None, :]
    return i, j


@pytest.mark.parametrize("seed", SEEDS)
def test_keep_u01_equals_jax(seed):
    for lo_i, lo_j in ((0, 0), (65530, 65536), (2**20, 3 * 2**16 + 5)):
        i, j = _grid(lo_i, lo_j)
        want = np.asarray(jdm.keep_u01(jnp.asarray(i), jnp.asarray(j), seed))
        got = dropmask.keep_u01(torch.from_numpy(i), torch.from_numpy(j), seed).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_seed_equals_jax(seed):
    b = np.arange(0, 40, 3, dtype=np.int32)[:, None]
    h = np.arange(0, 70000, 4999, dtype=np.int32)[None, :]  # b*131071 + h*8191 overflows
    want = np.asarray(jdm.fold_seed(seed, jnp.asarray(b), jnp.asarray(h)))
    got = dropmask.fold_seed(seed, torch.from_numpy(b), torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("q_offset", [0, 65530, 70001])
@pytest.mark.parametrize("seed", [3, 2**31 - 1])
def test_dense_keep_mask_equals_jax(seed, q_offset):
    for rate in (0.1, 0.5):
        want = np.asarray(jdm.dense_keep_mask(2, 3, 40, 72, seed, rate, q_offset=q_offset))
        got = dropmask.dense_keep_mask(2, 3, 40, 72, seed, rate, q_offset=q_offset).numpy()
        np.testing.assert_array_equal(got, want)
        i, j = _grid(q_offset, 0, 40, 72, 1)
        np.testing.assert_array_equal(
            dropmask.keep_mask(torch.from_numpy(i), torch.from_numpy(j), seed, rate).numpy(),
            np.asarray(jdm.keep_mask(jnp.asarray(i), jnp.asarray(j), seed, rate)))


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))


# (B, Sq, Skv, Hq, Hkv, causal, q_offset, kv_len, rate, seed)
REF_CASES = {
    "causal_mha": (2, 48, 48, 4, 4, True, 0, None, 0.15, 42),
    "causal_gqa2_high_rate": (1, 40, 40, 4, 2, True, 0, None, 0.5, 2**31 - 1),
    "full_mqa": (2, 24, 56, 4, 1, False, 0, None, 0.2, -5),
    "far_offset_kv_len": (2, 8, 64, 4, 2, True, 65530, 40, 0.25, 9),
}


@pytest.mark.parametrize("case", list(REF_CASES), ids=list(REF_CASES))
def test_attention_reference_dropout_matches_jax(case):
    B, Sq, Skv, Hq, Hkv, causal, q_offset, kv_len, rate, seed = REF_CASES[case]
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, 16)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, dropout_rate=rate,
              dropout_seed=seed)
    want_o, want_p = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             return_probs=True, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got_o, got_p = attention_reference(tq, tk, tv, return_probs=True, **kw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(attention_reference(tq, tk, tv, **kw).numpy(), got_o.numpy())


# (B, Sq, Skv, Hq, Hkv, D, q_offset, kv_len, rate, seed): the last case puts
# the query rows past 65,536 (a cache position) with ragged kv_len.
FLASH_CASES = {
    "prefill_gqa4": (2, 96, 96, 8, 2, 16, 0, None, 0.1, 7),
    "prefill_mha_ragged": (1, 70, 70, 4, 4, 32, 0, None, 0.3, 2**31 - 1),
    "far_offset_kv_len": (2, 16, 128, 4, 2, 16, 65536, [128, 77], 0.2, -77),
}


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_dropout_matches_jax(case):
    B, Sq, Skv, Hq, Hkv, D, q_offset, kv_len, rate, seed = FLASH_CASES[case]
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=1)
    kw = dict(causal=True, q_offset=q_offset, dropout_rate=rate, dropout_seed=seed)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                               kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
                               block_q=16, block_kv=64, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw["kv_len"] = None if kv_len is None else torch.tensor(kv_len)
    got = flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same mask as the dense reference's; another seed gives another output
    np.testing.assert_allclose(got.numpy(), attention_reference(tq, tk, tv, **kw).numpy(), **TOL)
    other = flash_attention(tq, tk, tv, **dict(kw, dropout_seed=seed + 1))
    assert not np.allclose(other.numpy(), got.numpy(), **TOL)
