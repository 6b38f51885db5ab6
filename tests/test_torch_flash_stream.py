"""K10, the long-context flash forward, and the flash route against the JAX
package, on the CPU.

The same numpy inputs go to ``mlio_tpu.ops.flash_attention.flash_attention``
in Pallas interpret mode with ``block_q=128, block_kv=128,
kv_vmem_budget=1 << 16`` (the tile and budget at which it takes
``_flash_fwd_stream_kernel``, as ``tests/test_flash_attention.py`` forces it)
and to the port: ``flash_stream_plain`` and ``flash_attention`` forced onto
K10's route with the same budget, whose wrapper runs the plain version on
CPU tensors. The port counts K/V chunks in the JAX package's default tile,
1024 keys, so every case holds more than 1024. In fp32 both differ by summation order only: atol =
rtol = 1e-4, the port's flash tests' limit. The bf16 case holds the plain
version's rounding points (q * scale, p for the PV product) against the JAX
kernel's by the relative RMS error (BF16_REL_RMS, as
``tests/test_torch_flash_grad.py``).

The route test traces the JAX function (``jax.make_jaxpr``, nothing runs)
and reads whether the stream kernel is in it: its manual K/V copies are the
only ``dma_start`` of the module's kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL_RMS = 1e-3
JAX_STREAM = dict(interpret=True, block_q=128, block_kv=128, kv_vmem_budget=1 << 16)
PORT_STREAM = dict(kv_vmem_budget=1 << 16)

# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len): every Skv passes 1024,
# so both packages stream K/V at the budget above.
CASES = {
    "causal_g1_d64": (1, 40, 1100, 2, 2, 64, True, 1060, None),
    "causal_g2_ragged_offset": (2, 40, 1100, 4, 2, 64, True, 1050, [1090, 1003]),
    "full_g4_ragged": (2, 33, 1060, 4, 1, 64, False, 0, [1060, 70]),
    "causal_g2_sq_tail_d128": (1, 150, 1200, 4, 2, 128, True, 1049, 1199),
    "causal_g4_prefill_d128": (1, 200, 1100, 8, 2, 128, True, 0, 200),
}


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _kv_len(kv_len, jax_side):
    if isinstance(kv_len, list):
        return jnp.asarray(kv_len, jnp.int32) if jax_side else torch.tensor(kv_len)
    return kv_len


def _jax(q, k, v, causal, q_offset, kv_len, return_stats=False, **kw):
    return jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_offset=q_offset, kv_len=_kv_len(kv_len, True),
                               return_stats=return_stats, **kw)


@pytest.fixture
def spy(monkeypatch):
    """Names of the plain versions the port's flash route runs."""
    ran = []
    for name in ("flash_stream_plain", "flash_plain_lse", "flash_attention_kvq_plain"):
        real = getattr(fa, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            ran.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(fa, name, wrapper)
    return ran


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_stream_matches_jax(case, spy):
    B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len = CASES[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, D)
    want = np.asarray(_jax(q, k, v, causal, q_offset, kv_len, **JAX_STREAM))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=_kv_len(kv_len, False))
    np.testing.assert_allclose(fa.flash_stream_plain(tq, tk, tv, **kw).numpy(), want, **TOL)
    spy.clear()
    got = fa.flash_attention(tq, tk, tv, **kw, **PORT_STREAM)
    assert spy == ["flash_stream_plain"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("route", ["k10", "k1"])
@pytest.mark.parametrize("case", ["causal_g2_ragged_offset", "full_g4_ragged",
                                  "causal_g2_sq_tail_d128"])
def test_return_stats_matches_jax(case, route, spy):
    """(o, lse) on K10's route (the budget forced) and on K1's (the default
    budget), against the JAX function's on the same route."""
    B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len = CASES[case]
    q, k, v = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=1)
    jax_kw = JAX_STREAM if route == "k10" else dict(interpret=True)
    want_o, want_lse = _jax(q, k, v, causal, q_offset, kv_len, return_stats=True, **jax_kw)
    o, lse = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                q_offset=q_offset, kv_len=_kv_len(kv_len, False),
                                return_stats=True, **(PORT_STREAM if route == "k10" else {}))
    assert spy == ["flash_stream_plain" if route == "k10" else "flash_plain_lse"]
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_return_stats_row_without_keys():
    """A row that sees no key: o 0 and lse -inf on both routes, as in JAX."""
    q, k, v = _inputs(2, 8, 1100, 2, 2, 64, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for kw in (PORT_STREAM, {}):
        o, lse = fa.flash_attention(tq, tk, tv, kv_len=torch.tensor([0, 5]), return_stats=True,
                                    **kw)
        assert not o[0].any() and torch.isneginf(lse[0]).all()
        assert torch.isfinite(lse[1]).all()
    want = np.asarray(_jax(q, k, v, True, 0, [0, 5], return_stats=True, **JAX_STREAM)[1])
    assert np.isneginf(want[0]).all()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_rms(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_stream_rounds_as_jax():
    """The plain version on bf16 inputs against the JAX stream kernel at
    K10's K/V tile (``STREAM_BLOCK_KV``, 128 keys): p is rounded against the
    running max of the blocks seen so far, so the tile is part of the
    function in bf16 (a 64-key plain version against the JAX kernel at 128
    keys lay 1.4e-3 off). Three key blocks, so the running max moves; D 32
    makes the scale no power of two, so rounding q * scale matters."""
    B, Sq, Skv, Hq, Hkv, D = 1, 200, 384, 4, 2, 32
    arrs = _inputs(B, Sq, Skv, Hq, Hkv, D, seed=5)
    kw = dict(causal=True, q_offset=Skv - Sq)
    want_o, want_lse = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                                           return_stats=True, **kw,
                                           **dict(JAX_STREAM, block_kv=fa.STREAM_BLOCK_KV))
    o, lse = fa.flash_stream_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrs),
                                   return_stats=True, **kw)
    assert o.dtype == torch.bfloat16
    errs = dict(o=_rel_rms(o, want_o), lse=_rel_rms(lse, want_lse))
    assert max(errs.values()) <= BF16_REL_RMS, errs
    fp32 = jax_flash_attention(*map(jnp.asarray, arrs), **kw, **JAX_STREAM)
    assert _rel_rms(want_o, fp32) > 2 * BF16_REL_RMS  # the case can see a rounding


def _jax_streams(Skv, D, dtype, budget=None, dropout=0.0, int8=False):
    """Whether the JAX package takes its stream kernel for this call."""
    B, Sq, H = 1, 8, 2
    kv_dtype = jnp.int8 if int8 else dtype
    q = jax.ShapeDtypeStruct((B, Sq, H, D), dtype)
    k = jax.ShapeDtypeStruct((B, Skv, H, D), kv_dtype)
    scales = dict(k_scale=jax.ShapeDtypeStruct((B, Skv, H), jnp.float32),
                  v_scale=jax.ShapeDtypeStruct((B, Skv, H), jnp.float32)) if int8 else {}
    kw = dict(causal=True, q_offset=Skv - Sq, dropout_rate=dropout)
    if budget is not None:
        kw["kv_vmem_budget"] = budget
    jaxpr = jax.make_jaxpr(lambda q, k, v, **s: jax_flash_attention(q, k, v, **kw, **s))(
        q, k, k, **scales)
    return "dma_start" in str(jaxpr)


# (Skv, D, dtype, kv_vmem_budget): both sides of the default threshold
# (12,288 keys of bf16 at head dim 64 and 128, which the rule rounds up to 128
# lanes alike; 6,144 of fp32), and of the one-tile clause under the small
# budget the tests force (more than 1024 keys).
ROUTES = [(s, d, "bfloat16", None) for d in (64, 128) for s in (12160, 12288, 12289, 32768)]
ROUTES += [(129, 64, "float32", 1 << 16), (1024, 64, "float32", 1 << 16),
           (1025, 64, "float32", 1 << 16), (6144, 128, "float32", None),
           (6145, 128, "float32", None)]


@pytest.mark.parametrize("variant", ["plain", "dropout", "int8"])
@pytest.mark.parametrize("route", ROUTES, ids=[f"skv{r[0]}_d{r[1]}_{r[2]}_b{r[3]}"
                                               for r in ROUTES])
def test_route_follows_jax(route, variant, monkeypatch, spy):
    """The port takes K10 exactly where the JAX package takes its stream
    kernel, and never with dropout or an INT8 cache."""
    Skv, D, dtype, budget = route
    jax_takes = _jax_streams(Skv, D, jnp.dtype(dtype), budget,
                             dropout=0.1 if variant == "dropout" else 0.0,
                             int8=variant == "int8")
    assert fa.stream_route(Skv, D, jnp.dtype(dtype).itemsize,
                           kv_vmem_budget=budget) == _jax_streams(Skv, D, jnp.dtype(dtype), budget)
    tdtype = getattr(torch, dtype)
    q = torch.zeros(1, 8, 2, D, dtype=tdtype)
    k = torch.zeros(1, Skv, 2, D, dtype=torch.int8 if variant == "int8" else tdtype)
    kw = dict(causal=True, q_offset=Skv - 8, kv_vmem_budget=budget)
    if variant == "int8":
        kw.update(k_scale=torch.ones(1, Skv, 2), v_scale=torch.ones(1, Skv, 2))
    if variant == "dropout":
        kw.update(dropout_rate=0.1)
    stub = {"flash_stream_plain": lambda q, *a, **k: q,
            "flash_plain_lse": lambda q, *a, **k: (q, None),
            "flash_attention_kvq_plain": lambda q, *a, **k: q}
    for name, fn in stub.items():  # record the route without running its plain version
        monkeypatch.setattr(fa, name, lambda *a, _n=name, _f=fn, **k: (spy.append(_n), _f(*a))[1])
    fa.flash_attention(q, k, k, **kw)
    assert (spy == ["flash_stream_plain"]) == jax_takes
    if variant != "plain":
        assert not jax_takes and spy != ["flash_stream_plain"]
