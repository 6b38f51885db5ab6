"""User masks, the lse over an INT8 cache and under dropout, and the bhsd
layouts (K1's and K9's branches) against the JAX package, on the CPU.

The same numpy inputs go to ``mlio_tpu.ops.flash_attention.flash_attention``
in Pallas interpret mode (``_flash_fwd_kernel`` and ``_flash_fwd_kernel_kvq``
with ``mask_kind`` "key" or "full", ``with_stats``) and to the port's
``flash_attention``, whose wrapper runs K1's plain version
(``flash_plain_lse``) or K9's (``flash_attention_kvq_plain``) on CPU
tensors. In fp32 the two differ by summation order alone: atol = rtol =
1e-4, the port's flash tests' limit. K9 rounds q and p * v_scale to bf16 in
both; a rounding that falls the other way over fp32 noise moves an output by
2^-8 of one term, so its cases hold 2e-3. The dense references agree to
1e-5. A row that sees no key gives 0 and lse -inf in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops.flash_attention import canonicalize_mask as jax_canonicalize_mask
from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu.ops.quant import quantize_kv as jax_quantize_kv
from mlio_tpu.ops.reference import attention_reference as jax_attention_reference
from mlio_tpu_torch import ops
from mlio_tpu_torch.models import Impl
from mlio_tpu_torch.ops import flash_attention as fa
from mlio_tpu_torch.ops.reference import attention_reference, canonicalize_mask

TOL = dict(atol=1e-4, rtol=1e-4)
TIGHT = dict(atol=1e-5, rtol=1e-5)
KVQ_TOL = dict(atol=2e-3, rtol=2e-3)


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _left_pad(rng, B, S, max_pad):
    """tests/test_flash_attention.py's _left_pad_mask, from numpy."""
    pads = rng.integers(0, max_pad + 1, B)
    return (np.arange(S)[None, :] >= pads[:, None]).astype(np.int8)


def _mask(kind, rng, B, Hq, Sq, Skv):
    """Masks of every shape canonicalize_mask takes."""
    if kind == "left_pad":
        return _left_pad(rng, B, Skv, Skv // 3)
    if kind == "holes":
        m = (rng.random((B, Skv)) < 0.8).astype(np.int8)
        m[:, 0] = 1
        return m
    if kind == "key_b1s":
        return _left_pad(rng, B, Skv, Skv // 4)[:, None, :]
    if kind == "prefix_lm":  # [B, Sq, Skv]: a bidirectional prefix, causal after it
        pre = rng.integers(1, Skv // 2, B)
        i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
        return ((j[None] < pre[:, None, None]) | (j <= i)[None]).astype(bool)
    if kind == "per_head":
        return (rng.random((B, Hq, Sq, Skv)) < 0.7).astype(np.int8)
    if kind == "one_head":
        return (rng.random((B, 1, Sq, Skv)) < 0.6).astype(np.float32)
    raise ValueError(kind)


def _jax_kv(kv_len):
    return jnp.asarray(kv_len, jnp.int32) if isinstance(kv_len, list) else kv_len


def _port_kv(kv_len):
    return torch.tensor(kv_len) if isinstance(kv_len, list) else kv_len


def _lse_close(got, want, tol):
    """Equal -inf rows, the finite ones within tol."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


# ---------------------------------------------------------------------------
# canonicalize_mask
# ---------------------------------------------------------------------------

B_, HQ_, SQ_, SKV_ = 2, 4, 8, 16
SHAPES = {"key": (B_, SKV_), "key_b1s": (B_, 1, SKV_), "per_query": (B_, SQ_, SKV_),
          "full_h1": (B_, 1, SQ_, SKV_), "full_hq": (B_, HQ_, SQ_, SKV_),
          "per_query_sq1": (B_, 1, SKV_)}
BAD = {"key_wrong_b": (B_ + 1, SKV_), "key_wrong_skv": (B_, SKV_ + 1),
       "per_query_wrong_sq": (B_, SQ_ + 1, SKV_), "full_wrong_heads": (B_, 3, SQ_, SKV_),
       "full_wrong_b": (1, HQ_, SQ_, SKV_), "full_wrong_skv": (B_, 1, SQ_, SKV_ - 1),
       "rank1": (SKV_,), "rank5": (B_, 1, 1, SQ_, SKV_)}


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("dtype", ["bool", "int8", "float32"])
def test_canonicalize_mask_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape) + len(dtype))
    m = (rng.random(SHAPES[shape]) < 0.5).astype(dtype)
    want_kind, want = jax_canonicalize_mask(jnp.asarray(m), B_, HQ_, SQ_, SKV_)
    kind, got = canonicalize_mask(torch.from_numpy(m), B_, HQ_, SQ_, SKV_)
    assert kind == want_kind and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # canonical in, itself out: nothing copied
    again = canonicalize_mask(got, B_, HQ_, SQ_, SKV_)
    assert again[0] == kind and again[1].data_ptr() == got.data_ptr()


@pytest.mark.parametrize("shape", list(BAD), ids=list(BAD))
def test_canonicalize_mask_refuses_what_jax_refuses(shape):
    m = np.ones(BAD[shape], np.int8)
    with pytest.raises(ValueError) as jax_err:
        jax_canonicalize_mask(jnp.asarray(m), B_, HQ_, SQ_, SKV_)
    with pytest.raises(ValueError) as port_err:
        canonicalize_mask(torch.from_numpy(m), B_, HQ_, SQ_, SKV_)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# attention_reference with mask and bias
# ---------------------------------------------------------------------------

REF_MASKS = ["left_pad", "holes", "key_b1s", "prefix_lm", "per_head", "one_head"]


@pytest.mark.parametrize("mask,bias", [(m, b) for m in REF_MASKS for b in (False, True)]
                         + [(None, True)])
def test_attention_reference_mask_bias_matches_jax(mask, bias):
    B, Sq, Skv, Hq, Hkv, D = 2, 24, 40, 4, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=8)
    m = None if mask is None else _mask(mask, rng, B, Hq, Sq, Skv)
    b = rng.standard_normal((1, Hq, Sq, Skv)).astype(np.float32) if bias else None
    kw = dict(causal=mask not in ("prefix_lm",), q_offset=Skv - Sq, kv_len=[Skv, 33])
    want = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask=None if m is None else jnp.asarray(m),
                                   bias=None if b is None else jnp.asarray(b),
                                   **dict(kw, kv_len=_jax_kv(kw["kv_len"])))
    got = attention_reference(*map(torch.from_numpy, (q, k, v)),
                              mask=None if m is None else torch.from_numpy(m),
                              bias=None if b is None else torch.from_numpy(b),
                              **dict(kw, kv_len=_port_kv(kw["kv_len"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


# ---------------------------------------------------------------------------
# flash_attention's masked branches (K1's plain version)
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, mask, causal, q_offset, kv_len)
MASK_CASES = {
    "left_pad_causal": (3, 256, 256, 4, 2, 64, "left_pad", True, 0, None),
    "left_pad_bidirectional": (3, 256, 256, 4, 2, 64, "left_pad", False, 0, None),
    "holes_causal": (2, 192, 192, 4, 4, 64, "holes", True, 0, None),
    "holes_bidirectional": (2, 192, 192, 4, 4, 64, "holes", False, 0, None),
    "key_b1s_kv_len_offset": (2, 40, 300, 4, 2, 64, "key_b1s", True, 250, [290, 120]),
    "prefix_lm_3d": (2, 160, 160, 4, 2, 64, "prefix_lm", False, 0, None),
    "per_head_4d": (1, 200, 200, 4, 2, 64, "per_head", True, 0, None),
    "one_head_4d_kv_len": (2, 64, 192, 2, 1, 64, "one_head", True, 128, [192, 70]),
}


def _flash_pair(case, seed=0, **extra):
    B, Sq, Skv, Hq, Hkv, D, mask, causal, q_offset, kv_len = MASK_CASES[case]
    rng = np.random.default_rng(seed + sum(map(ord, case)))
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=seed + 1)
    m = _mask(mask, rng, B, Hq, Sq, Skv)
    kw = dict(causal=causal, q_offset=q_offset, **extra)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=jnp.asarray(m), kv_len=_jax_kv(kv_len), interpret=True,
                               **kw)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(m),
                             kv_len=_port_kv(kv_len), **kw)
    return got, want


@pytest.mark.parametrize("case", list(MASK_CASES), ids=list(MASK_CASES))
def test_flash_mask_matches_jax(case):
    got, want = _flash_pair(case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["left_pad_causal", "key_b1s_kv_len_offset", "per_head_4d"])
def test_flash_mask_return_stats_matches_jax(case):
    (o, lse), (want_o, want_lse) = _flash_pair(case, seed=3, return_stats=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    _lse_close(lse, want_lse, TOL)
    # a left-padded causal row before its first key sees none: 0 and -inf
    if case == "left_pad_causal":
        assert np.isneginf(lse.numpy()).any()


def test_flash_mask_stays_on_k1_under_a_tiny_budget(monkeypatch):
    """The mirror of test_flash_mask_chunked_long_context: a budget that
    sends the unmasked call to K10 leaves the masked one on K1, at any
    length, as the JAX package takes its chunked grid and never the stream
    kernel for a mask. The port counts K/V chunks in the JAX package's
    default tile, so the keys pass 1024 (tests/test_torch_flash_stream.py)."""
    B, Sq, Skv, Hq, Hkv, D = 1, 64, 1100, 2, 2, 64
    rng = np.random.default_rng(14)
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=13)
    m = _left_pad(rng, B, Skv, 200)
    kw = dict(causal=True, q_offset=Skv - Sq)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
                               mask=jnp.asarray(m), interpret=True, block_q=128, block_kv=128,
                               kv_vmem_budget=1 << 16)
    assert fa.stream_route(Skv, D, 4, kv_vmem_budget=1 << 16)
    ran = []
    for name in ("flash_stream_plain", "flash_plain_lse"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **kw: (ran.append(_n),
                                                                            _r(*a, **kw))[1])
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw,
                             mask=torch.from_numpy(m), kv_vmem_budget=1 << 16)
    assert ran == ["flash_plain_lse"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# K9 with a key mask and the lse; K1's lse under dropout
# ---------------------------------------------------------------------------

def _quant_kv(rng, *shape):
    q, s = jax_quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    return np.array(q), np.array(s)


@pytest.mark.parametrize("group,kv_len,q_offset", [(1, None, 0), (4, [300, 177], 236)],
                         ids=["mha_prefill", "gqa4_cache"])
def test_flash_kvq_key_mask_return_stats_matches_jax(group, kv_len, q_offset):
    B, Sq, Skv, Hkv, D = 2, 64 if q_offset else 256, 320 if q_offset else 256, 2, 64
    rng = np.random.default_rng(21 + group)
    q = rng.standard_normal((B, Sq, Hkv * group, D)).astype(np.float32)
    kq, ks = _quant_kv(rng, B, Skv, Hkv, D)
    vq, vs = _quant_kv(rng, B, Skv, Hkv, D)
    m = _left_pad(rng, B, Skv, 100)
    kw = dict(causal=True, q_offset=q_offset)
    want_o, want_lse = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), mask=jnp.asarray(m), kv_len=_jax_kv(kv_len), return_stats=True,
        interpret=True, **kw)
    tq, tk, tv, tks, tvs, tm = map(torch.from_numpy, (q, kq, vq, ks, vs, m))
    before = fa.flash_attention_kvq.launches
    o, lse = fa.flash_attention(tq, tk, tv, k_scale=tks, v_scale=tvs, mask=tm,
                                kv_len=_port_kv(kv_len), return_stats=True, **kw)
    assert fa.flash_attention_kvq.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **KVQ_TOL)
    _lse_close(lse, want_lse, TOL)  # the lse is fp32 throughout
    # a full mask over an INT8 cache raises in both packages
    full = np.ones((B, Sq, Skv), np.int8)
    with pytest.raises(NotImplementedError, match="full"):
        fa.flash_attention(tq, tk, tv, k_scale=tks, v_scale=tvs, mask=torch.from_numpy(full))
    with pytest.raises(NotImplementedError, match="full"):
        jax_flash_attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                            mask=jnp.asarray(full), interpret=True)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "key_mask"])
def test_flash_dropout_return_stats_matches_jax(masked):
    """K1's lse under dropout: l sums p before the drop, so the lse is the
    undropped one, in both packages; the output takes the kept p."""
    B, S, Hq, Hkv, D = 2, 160, 4, 2, 64
    rng = np.random.default_rng(31)
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, seed=32)
    m = _left_pad(rng, B, S, 60) if masked else None
    kw = dict(causal=True, dropout_rate=0.2, dropout_seed=-5)
    want_o, want_lse = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_stats=True, interpret=True,
        mask=None if m is None else jnp.asarray(m), block_q=32, block_kv=64, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tm = None if m is None else torch.from_numpy(m)
    o, lse = fa.flash_attention(tq, tk, tv, return_stats=True, mask=tm, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    _lse_close(lse, want_lse, TOL)
    undropped = fa.flash_attention(tq, tk, tv, return_stats=True, mask=tm, causal=True)[1]
    _lse_close(lse, undropped.numpy(), TIGHT)


# ---------------------------------------------------------------------------
# the bhsd layouts
# ---------------------------------------------------------------------------

def _bhsd(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("layouts", [("bhsd", "bshd", "bshd"), ("bshd", "bhsd", "bshd"),
                                     ("bshd", "bshd", "bhsd"), ("bhsd", "bhsd", "bhsd")],
                         ids=["q", "kv", "out", "all"])
@pytest.mark.parametrize("route", ["k1_mask", "k9", "k10"])
def test_flash_layouts_match_jax(layouts, route):
    q_layout, kv_layout, out_layout = layouts
    B, Sq, Skv, Hq, Hkv, D = 2, 48, 1100 if route == "k10" else 96, 4, 2, 64
    rng = np.random.default_rng(41)
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=42)
    kw = dict(causal=True, q_offset=Skv - Sq, return_stats=True)
    jkw, pkw = {}, {}
    if route == "k1_mask":
        m = _left_pad(rng, B, Skv, 30)
        jkw["mask"], pkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if route == "k9":
        k, ks = _quant_kv(rng, B, Skv, Hkv, D)
        v, vs = _quant_kv(rng, B, Skv, Hkv, D)
        if kv_layout == "bhsd":
            ks, vs = _bhsd(ks), _bhsd(vs)
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        pkw.update(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    if route == "k10":
        jkw.update(block_q=128, block_kv=128, kv_vmem_budget=1 << 16)
        pkw.update(kv_vmem_budget=1 << 16)
    if q_layout == "bhsd":
        q = _bhsd(q)
    if kv_layout == "bhsd":
        k, v = _bhsd(k), _bhsd(v)
    lay = dict(q_layout=q_layout, kv_layout=kv_layout, out_layout=out_layout)
    want_o, want_lse = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           interpret=True, **kw, **lay, **jkw)
    o, lse = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw, **lay, **pkw)
    assert o.shape == want_o.shape and lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               **(KVQ_TOL if route == "k9" else TOL))
    _lse_close(lse, want_lse, TOL)
    # the plain twin takes the same arguments
    o_p, lse_p = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), **kw, **lay,
                                          **pkw)
    np.testing.assert_array_equal(o_p.numpy(), o.numpy())


def test_layout_argument_is_checked():
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="q_layout"):
        fa.flash_attention(q, q, q, q_layout="sbhd")
    with pytest.raises(ValueError, match="out_layout"):
        fa.flash_attention(q, q, q, out_layout="hsbd")


# ---------------------------------------------------------------------------
# ops.attention's masked flash route
# ---------------------------------------------------------------------------

def test_masked_flash_call_refuses_gradients():
    """A masked call is not training-shaped (the JAX package's condition):
    it goes to flash_attention, which has no backward, and never to
    flash_attention_diff."""
    rng = np.random.default_rng(51)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 32, 32, 2, 2, 64, 52))
    m = torch.from_numpy(_left_pad(rng, 1, 32, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v, mask=m, impl=Impl(attention="flash"))
    with torch.no_grad():
        got = ops.attention(q, k, v, mask=m, impl=Impl(attention="flash"))
        want = ops.attention(q, k, v, mask=m)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # without the mask the same call is training-shaped and differentiable
    ops.attention(q, k, v, impl=Impl(attention="flash")).sum().backward()
    assert q.grad is not None


def test_flash_kv_layout_through_ops_attention():
    rng = np.random.default_rng(61)
    q, k, v = _qkv(2, 16, 40, 4, 2, 64, seed=62)
    m = _left_pad(rng, 2, 40, 10)
    kw = dict(q_offset=24, kv_len=40, mask=torch.from_numpy(m))
    want = ops.attention(*map(torch.from_numpy, (q, k, v)), **kw)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(_bhsd(k)),
                        torch.from_numpy(_bhsd(v)), kv_layout="bhsd",
                        impl=Impl(attention="flash"), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
