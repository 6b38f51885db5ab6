"""Ring attention (``mlio_tpu_torch/ops/ring_attention.py``) and the ring
route of ``ops.attention`` and the model, against the JAX package on the CPU.

The same numpy inputs go to ``mlio_tpu.ops.ring_attention`` (its jnp chunk
walk, and ``chunk_step_flash`` through the Pallas flash kernel in interpret
mode) and to the port, whose flash route runs K1's and K10's plain versions
on CPU tensors. In fp32 both differ by summation order alone: atol = rtol =
1e-4, the port's flash tests' limit. The model runs gpt2-tiny in fp32 with
the JAX package's weights carried across by ``from_jax_params``: logits
within 1e-4, greedy ids equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlio_tpu.ops.ring_attention as jra
from mlio_tpu.models import Impl as JaxImpl
from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.ops import attention as jax_attention
from mlio_tpu.ops.reference import attention_reference as jax_attention_reference
from mlio_tpu.runtime import greedy_generate as jax_greedy_generate
from mlio_tpu.runtime import init_cache as jax_init_cache
from mlio_tpu_torch import ops
from mlio_tpu_torch.models import Impl, forward, from_jax_params, get_spec
from mlio_tpu_torch.ops import flash_attention as fa
from mlio_tpu_torch.ops import ring_attention as ra
from mlio_tpu_torch.ops.quant import quantize_kv
from mlio_tpu_torch.runtime import greedy_generate, init_cache

TOL = dict(atol=1e-4, rtol=1e-4)


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _stats_close(got, want):
    """(m, l, acc) equal: -inf where the JAX state has it, else within TOL."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], **TOL)


def test_init_stats_and_finalize_match_jax():
    want = jra.init_stats(2, 3, 5, 16)
    got = ra.init_stats(2, 3, 5, 16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(1)
    m = rng.standard_normal((2, 3, 5, 1)).astype(np.float32)
    l = np.abs(rng.standard_normal((2, 3, 5, 1))).astype(np.float32)
    l[0, 1, 2] = 0.0  # a row with no key gives 0
    acc = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    want = jra.finalize(jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc), jnp.float32)
    got = ra.finalize(*_t(m, l, acc), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len", [None, 37, [50, 12]], ids=["none", "int", "per_row"])
def test_chunk_step_matches_jax(causal, kv_len):
    B, Sq, C, Hq, Hkv, D = 2, 24, 32, 4, 2, 16
    q, k, v = _qkv(B, Sq, C, Hq, Hkv, D, seed=2)
    qpos, kpos = np.arange(Sq) + 30, np.arange(C) + 20
    state = jra.init_stats(B, Hq, Sq, D)
    tstate = ra.init_stats(B, Hq, Sq, D)
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    tkv = None if kv_len is None else torch.tensor(kv_len)
    for step in range(2):  # a second step merges into a live state
        kw = dict(scale=0.25, causal=causal)
        state = jra.chunk_step(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *state,
                               q_positions=jnp.asarray(qpos),
                               k_positions=jnp.asarray(kpos + 32 * step), kv_len=jkv, **kw)
        tstate = ra.chunk_step(*_t(q, k, v), *tstate, q_positions=torch.from_numpy(qpos),
                               k_positions=torch.from_numpy(kpos + 32 * step), kv_len=tkv, **kw)
        _stats_close(tstate, state)


# (q_offset, k_offset, kv_len): the kernel sees q_offset - k_offset (negative
# where the chunk lies past the queries) and kv_len - k_offset clipped to
# [0, C] (0 where it lies past the context)
FLASH_STEPS = {
    "chunk_at_queries": (64, 64, None),
    "negative_relative_offset": (10, 64, None),
    "all_rows_before_chunk": (0, 200, None),
    "kv_len_0": (128, 96, 90),
    "kv_len_per_row_partial": (40, 32, [60, 20]),
}


@pytest.mark.parametrize("case", list(FLASH_STEPS), ids=list(FLASH_STEPS))
def test_chunk_step_flash_matches_jax(case):
    q_offset, k_offset, kv_len = FLASH_STEPS[case]
    B, Sq, C, Hq, Hkv, D = 2, 48, 64, 4, 2, 64
    q, k, v = _qkv(B, Sq, C, Hq, Hkv, D, seed=3)
    # a live state: one earlier chunk merged in by the jnp step
    rng = np.random.default_rng(4)
    k0, v0 = (rng.standard_normal((B, 16, Hkv, D)).astype(np.float32) for _ in range(2))
    state = jra.chunk_step(jnp.asarray(q), jnp.asarray(k0), jnp.asarray(v0),
                           *jra.init_stats(B, Hq, Sq, D), scale=D ** -0.5,
                           q_positions=jnp.arange(Sq) + q_offset, k_positions=jnp.arange(16),
                           causal=True)
    tstate = [torch.from_numpy(np.array(s)) for s in state]
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    tkv = None if kv_len is None else (torch.tensor(kv_len) if isinstance(kv_len, list)
                                       else kv_len)
    kw = dict(scale=D ** -0.5, q_offset=q_offset, k_offset=k_offset, causal=True)
    want = jra.chunk_step_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *state,
                                kv_len=jkv, interpret=True, **kw)
    got = ra.chunk_step_flash(*_t(q, k, v), *tstate, kv_len=tkv, **kw)
    _stats_close(got, want)
    if case in ("all_rows_before_chunk", "kv_len_0"):  # the chunk adds nothing
        _stats_close(got, tstate)


def test_chunk_step_flash_merge_equals_one_flash_call():
    """Chunks merged by chunk_step_flash give one flash call's output and
    lse, the later chunks at negative relative offsets."""
    B, S, Hq, Hkv, D, C = 1, 200, 4, 2, 64, 64
    q, k, v = _t(*_qkv(B, S, S + 56, Hq, Hkv, D, seed=5))
    m, l, acc = ra.init_stats(B, Hq, S, D)
    for c0 in range(0, S + 56, C):
        m, l, acc = ra.chunk_step_flash(q, k[:, c0:c0 + C], v[:, c0:c0 + C], m, l, acc,
                                        scale=D ** -0.5, q_offset=0, k_offset=c0, causal=True,
                                        kv_len=S)
    want, want_lse = fa.flash_attention(q, k, v, kv_len=S, return_stats=True)
    np.testing.assert_allclose(ra.finalize(m, l, acc, q.dtype).numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose((m + torch.log(l))[..., 0].numpy(), want_lse.numpy(), **TOL)


# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len, chunk)
RING_CASES = {
    "causal_chunk64": (2, 96, 96, 4, 4, 32, True, 0, None, 64),
    "causal_gqa_chunk_not_dividing": (2, 80, 80, 4, 2, 32, True, 0, None, 48),
    "bidirectional_gqa4": (1, 40, 120, 8, 2, 32, False, 0, None, 32),
    "decode_offset_kv_len": (2, 8, 128, 4, 2, 32, True, 100, [108, 60], 40),
    "one_chunk": (1, 32, 32, 2, 1, 64, True, 0, 30, 512),
}


@pytest.mark.parametrize("use_flash", [False, True], ids=["scan", "flash_fold"])
@pytest.mark.parametrize("case", list(RING_CASES), ids=list(RING_CASES))
def test_chunked_ring_attention_matches_jax(case, use_flash):
    B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len, chunk = RING_CASES[case]
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, D, seed=6)
    kw = dict(causal=causal, q_offset=q_offset, chunk_size=chunk, use_flash=use_flash)
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    tkv = torch.tensor(kv_len) if isinstance(kv_len, list) else kv_len
    want = jra.chunked_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      kv_len=jkv, interpret=True, **kw)
    got = ra.chunked_ring_attention(*_t(q, k, v), kv_len=tkv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the dense reference
    ref = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, q_offset=q_offset, kv_len=jkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ring_cross_attention_and_memory_model_match_jax():
    q, k, v = _qkv(2, 20, 70, 4, 2, 32, seed=7)
    want = jra.ring_cross_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    kv_len=jnp.asarray([70, 33]), chunk_size=32)
    got = ra.ring_cross_attention(*_t(q, k, v), kv_len=torch.tensor([70, 33]), chunk_size=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for args in ((1, 32, 4096, 65536, 128, 4), (2, 8, 1000, 1001, 64, 3, 4), (1, 1, 8, 8, 8, 0)):
        assert ra.ring_attention_memory_model(*args) == jra.ring_attention_memory_model(*args)


# ---------------------------------------------------------------------------
# ops.attention's ring route
# ---------------------------------------------------------------------------

RING = Impl(attention="ring", ring_chunk=32)


def test_ring_route_matches_jax_and_refuses_dropout():
    q, k, v = _qkv(2, 16, 80, 4, 2, 32, seed=8)
    kw = dict(q_offset=64, kv_len=[80, 70])
    want = jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   q_offset=64, kv_len=jnp.asarray([80, 70]))
    got = ops.attention(*_t(q, k, v), q_offset=64, kv_len=torch.tensor(kw["kv_len"]), impl=RING)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError, match="dropout"):
        ops.attention(*_t(q, k, v), impl=RING, dropout_rate=0.1)


def test_ring_route_hands_bhsd_kv_to_k10_as_laid_out(monkeypatch):
    """The ring route with bhsd K/V long enough for K10's route (past 1,024
    keys under a 1-byte budget), with the fold forced (on CUDA tensors it is
    the default): K10 is told "bhsd" and gets the caller's tensors, which
    are contiguous in that layout, never a strided bshd view of them (the
    card's K10 wrapper reads through TMA maps of contiguous tensors); the
    output equals the JAX package's ring route with the same layout."""
    q, k, v = _qkv(2, 16, 1100, 4, 2, 32, seed=12)
    kb, vb = (np.ascontiguousarray(t.transpose(0, 2, 1, 3)) for t in (k, v))
    kv_len = [1100, 1000]
    want = jax_attention(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), q_offset=1084,
                         kv_len=jnp.asarray(kv_len), impl=JaxImpl(attention="ring",
                                                                  ring_chunk=256),
                         kv_layout="bhsd")
    seen = []
    plain, fold = fa.flash_stream_plain, ra.chunked_ring_attention

    def spy(q, k, v, **kw):
        seen.append((kw["kv_layout"], k.is_contiguous(), v.is_contiguous()))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_stream_plain", spy)
    monkeypatch.setattr(fa, "KV_VMEM_BUDGET", 1)
    monkeypatch.setattr(ra, "chunked_ring_attention", lambda *a, **kw: fold(*a, use_flash=True,
                                                                          **kw))
    got = ops.attention(*_t(q, kb, vb), q_offset=1084, kv_len=torch.tensor(kv_len),
                        impl=Impl(attention="ring", ring_chunk=256), kv_layout="bhsd")
    assert seen == [("bhsd", True, True)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ring_route_dequantizes_an_int8_cache():
    q, k, v = _t(*_qkv(1, 8, 64, 4, 2, 32, seed=9))
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    got = ops.attention(q, kq, vq, k_scale=ks, v_scale=vs, q_offset=56, kv_len=64, impl=RING)
    want = ops.attention(q, kq.float() * ks[..., None], vq.float() * vs[..., None], q_offset=56,
                         kv_len=64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_ring_route_with_a_mask_or_probs_takes_the_dense_reference(monkeypatch):
    q, k, v = _t(*_qkv(2, 12, 12, 2, 2, 32, seed=10))
    mask = torch.ones(2, 12, dtype=torch.int8)
    mask[0, :5] = 0
    bias = torch.from_numpy(np.random.default_rng(11).standard_normal((1, 2, 12, 12))
                            .astype(np.float32))
    walked = []
    real = ra.chunked_ring_attention
    monkeypatch.setattr(ra, "chunked_ring_attention",
                        lambda *a, **kw: (walked.append(1), real(*a, **kw))[1])
    got = ops.attention(q, k, v, mask=mask, bias=bias, impl=RING)
    want = ops.attention(q, k, v, mask=mask, bias=bias)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # return_probs: the dense reference and the probabilities, where the JAX
    # package's ring route returns its output alone (a fault there)
    jax_out = jax_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            impl=JaxImpl(attention="ring", ring_chunk=32), return_probs=True)
    assert not isinstance(jax_out, tuple) and jax_out.shape == tuple(q.shape)
    out, probs = ops.attention(q, k, v, impl=RING, return_probs=True)
    ref_out, ref_probs = ops.attention(q, k, v, return_probs=True)
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    np.testing.assert_array_equal(probs.numpy(), ref_probs.numpy())
    assert probs.shape == (2, 2, 12, 12) and not walked


@pytest.mark.parametrize("kind", ["flash", "ring"])
def test_bias_is_refused_where_the_jax_package_drops_it(kind):
    """The JAX dispatcher drops ``bias`` on its flash route and on its ring
    route without a mask (only the dense reference adds it); the port
    raises there instead."""
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 32, seed=12))
    bias = torch.ones(1, 2, 8, 8)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    dropped = jax_attention(jq, jk, jv, bias=jnp.asarray(bias.numpy()),
                            impl=JaxImpl(attention=kind))
    no_bias = jax_attention(jq, jk, jv, impl=JaxImpl(attention=kind))
    np.testing.assert_allclose(np.asarray(dropped), np.asarray(no_bias), **TOL)  # the fault
    with pytest.raises(ValueError, match=kind):
        ops.attention(q, k, v, bias=bias, impl=Impl(attention=kind))


# ---------------------------------------------------------------------------
# the model with Impl(attention="ring")
# ---------------------------------------------------------------------------

JAX_RING = dict(attention="ring", ring_chunk=8, decode_stack="scan")


def _gpt2_tiny():
    jspec = JAX_PRESETS["gpt2-tiny"]
    jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, get_spec("gpt2-tiny"), params


def test_ring_forward_matches_jax():
    jspec, jparams, spec, params = _gpt2_tiny()
    ids = np.random.default_rng(13).integers(0, spec.vocab_size, (2, 19)).astype(np.int32)
    jimpl, impl = JaxImpl(**JAX_RING), Impl(**JAX_RING)
    want, _ = jax_forward(jparams, jspec, jnp.asarray(ids), impl=jimpl)
    got, _ = forward(params, spec, torch.from_numpy(ids), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # with a cache: the prefill (ring over the cache) and a decode step
    jcache = jax_init_cache(jspec, 2, 24, dtype=jnp.float32)
    cache = init_cache(spec, 2, 24, dtype=torch.float32, device="cpu")
    for chunk in (ids[:, :17], ids[:, 17:18]):
        want, jcache = jax_forward(jparams, jspec, jnp.asarray(chunk), impl=jimpl, cache=jcache)
        got, cache = forward(params, spec, torch.from_numpy(chunk), impl=impl, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ring_generate_ids_equal_jax():
    jspec, jparams, spec, params = _gpt2_tiny()
    ids = np.random.default_rng(14).integers(0, spec.vocab_size, (2, 10)).astype(np.int32)
    want = jax_greedy_generate(jparams, jspec, jnp.asarray(ids), max_new_tokens=5,
                               impl=JaxImpl(**JAX_RING))
    got = greedy_generate(params, spec, torch.from_numpy(ids), max_new_tokens=5,
                          impl=Impl(**JAX_RING), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
