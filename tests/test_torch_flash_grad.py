"""The port's differentiable flash attention (K13) against the JAX package,
and the kernels that refuse a gradient (F3), on the CPU.

The same numpy inputs go to ``mlio_tpu.ops.flash_attention_grad`` (its
Pallas kernels in interpret mode, as ``tests/test_flash_attention_grad.py``
runs them) and to the port's autograd functions, whose wrappers run their
plain versions on CPU tensors. (o, lse) and dq/dk/dv of a fixed weighted-sum
loss are compared in fp32 within atol = rtol = 1e-4: both compute in fp32
and differ by summation order only.

The bf16 cases hold the plain versions' rounding points (q * scale, p, dS,
P~ and the per-head dK/dV rounded to bf16 where the JAX kernels round them,
delta and the group sum kept in fp32) against the JAX kernels on bf16
inputs, by the relative RMS error of each output (BF16_REL_RMS).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops import flash_attention_grad as jfg
from mlio_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mlio_tpu_torch import ops
from mlio_tpu_torch.models import Impl, forward, get_spec, init_params
from mlio_tpu_torch.ops import decode_paged_stack as dps
from mlio_tpu_torch.ops import flash_attention_grad as fg
from mlio_tpu_torch.ops import paged_attention as pa
from mlio_tpu_torch.ops.flash_attention import flash_attention_plain
from mlio_tpu_torch.runtime import init_cache, quantize_params, trainable

TOL = dict(atol=1e-4, rtol=1e-4)

# (B, S, Hq, Hkv, D, causal, dropout_rate, dropout_seed)
CASES = {
    "causal_g1": (2, 64, 4, 4, 16, True, 0.0, 0),
    "full_g2": (1, 64, 4, 2, 32, False, 0.0, 0),
    "causal_g4_ragged": (1, 100, 8, 2, 16, True, 0.0, 0),
    "causal_g2_dropout": (1, 72, 4, 2, 16, True, 0.2, 11),
    "full_g4_dropout_seed_max": (2, 48, 4, 1, 16, False, 0.1, 2**31 - 1),
    "ragged_tile_g4_dropout": (1, 129, 8, 2, 32, True, 0.1, 5),
}


def _inputs(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D))]


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_fwd_lse_matches_jax(case):
    B, S, Hq, Hkv, D, causal, rate, seed = CASES[case]
    q, k, v, _ = _inputs(B, S, Hq, Hkv, D)
    want_o, (_, lse_slab, *_) = jfg._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              seed, causal, D ** -0.5, 64, 128, True, rate)
    o, lse = fg.flash_fwd_lse(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              dropout_rate=rate, dropout_seed=seed)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_slab)[:, :, 0, :S], **TOL)


@pytest.mark.parametrize("which", ["vjp", "diff"])
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_grads_match_jax(case, which):
    B, S, Hq, Hkv, D, causal, rate, seed = CASES[case]
    q, k, v, w = _inputs(B, S, Hq, Hkv, D)
    jfn = {"vjp": jfg.flash_attention_vjp, "diff": jfg.flash_attention_diff}[which]

    def jloss(q, k, v):
        o = jfn(q, k, v, seed, causal, None, 64, 128, True, rate)
        return jnp.sum(o * jnp.asarray(w))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    fn = {"vjp": fg.flash_attention_vjp, "diff": fg.flash_attention_diff}[which]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss = (fn(tq, tk, tv, torch.tensor(seed), causal=causal, dropout_rate=rate)
            * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), **TOL)
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **TOL)


# bf16: (B, S, Hq, Hkv, D, causal, dropout_rate, dropout_seed). S <= 128 keeps
# one 128-key block in the JAX forward, so its p is rounded against the row's
# final max as the plain versions round it; at S 129 only the last row sees a
# second block (the card's ragged_tile_g4_dropout case, 17 x 64 + 1 tokens,
# at this size: the plain versions the card compares against, held to the
# JAX kernels one row past a tile). D 32 makes the scale no power of two, so
# rounding q * scale matters.
BF16_CASES = {
    "causal_g4_d64": (1, 128, 8, 2, 64, True, 0.0, 0),
    "full_g1_ragged_d32": (1, 100, 4, 4, 32, False, 0.0, 0),
    "causal_g2_dropout_d32": (1, 96, 4, 2, 32, True, 0.1, 7),
    "ragged_tile_g4_dropout": (1, 129, 8, 2, 32, True, 0.1, 5),
}
# Relative RMS error from the JAX kernels' bf16 outputs. The plain versions
# lie at 9.2e-5 or less here (fp32 summation order, then a bf16 rounding that
# falls the other way now and then); each bf16 path lies 2.3e-3 to 3.9e-3
# from its fp32 path. Leaving out one of the rounding points above, or adding
# one to dP, delta or the per-head dK/dV before the group sum, moved some
# output of these cases by 2.6e-3 or more.
BF16_REL_RMS = 1e-3


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_rms(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_grads(fn, q, k, v, w, seed, causal, rate):
    def loss(q, k, v):
        o = fn(q, k, v, seed, causal, None, 64, 128, True, rate)
        return jnp.sum(o.astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", list(BF16_CASES), ids=list(BF16_CASES))
def test_bf16_forward_rounds_as_jax(case):
    """K1's and K13a's plain versions against the JAX kernels on bf16 inputs."""
    B, S, Hq, Hkv, D, causal, rate, seed = BF16_CASES[case]
    arrs = _inputs(B, S, Hq, Hkv, D, seed=5)[:3]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed)
    want_k1 = jax_flash_attention(jq, jk, jv, interpret=True, block_q=64, block_kv=128, **kw)
    want_o, (_, lse_slab, *_) = jfg._fwd_impl(jq, jk, jv, seed, causal, D ** -0.5, 64, 128,
                                              True, rate)
    o, lse = fg.flash_fwd_lse(tq, tk, tv, **kw)
    k1 = flash_attention_plain(tq, tk, tv, **kw)
    assert k1.dtype == o.dtype == torch.bfloat16
    errs = dict(k1=_rel_rms(k1, want_k1), o=_rel_rms(o, want_o),
                lse=_rel_rms(lse, np.asarray(lse_slab)[:, :, 0, :S]))
    assert max(errs.values()) <= BF16_REL_RMS, errs
    fp32 = jax_flash_attention(*map(jnp.asarray, arrs), interpret=True, block_q=64,
                               block_kv=128, **kw)
    assert _rel_rms(want_k1, fp32) > 2 * BF16_REL_RMS  # the case can see a rounding


@pytest.mark.parametrize("which", ["vjp", "diff"])
@pytest.mark.parametrize("case", list(BF16_CASES), ids=list(BF16_CASES))
def test_bf16_grads_round_as_jax(case, which):
    """dq/dk/dv through K13b's and K13c's plain versions and the glue against
    jax.grad of the JAX kernels on bf16 inputs."""
    B, S, Hq, Hkv, D, causal, rate, seed = BF16_CASES[case]
    arrs = _inputs(B, S, Hq, Hkv, D, seed=5)
    w = jnp.asarray(arrs[3], jnp.bfloat16).astype(jnp.float32)
    jfn = {"vjp": jfg.flash_attention_vjp, "diff": jfg.flash_attention_diff}[which]
    want = _jax_grads(jfn, *(jnp.asarray(a, jnp.bfloat16) for a in arrs[:3]), w, seed,
                           causal, rate)
    fn = {"vjp": fg.flash_attention_vjp, "diff": fg.flash_attention_diff}[which]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrs[:3])
    (fn(tq, tk, tv, seed, causal=causal, dropout_rate=rate).float()
     * torch.from_numpy(np.array(w))).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))
    errs = {f"d{n}": _rel_rms(t.grad, g) for n, t, g in zip("qkv", (tq, tk, tv), want)}
    assert max(errs.values()) <= BF16_REL_RMS, errs
    if which == "vjp":  # the case can see a rounding
        fp32 = _jax_grads(jfn, *map(jnp.asarray, arrs[:3]), w, seed, causal, rate)
        assert min(_rel_rms(g, f) for g, f in zip(want, fp32)) > 2 * BF16_REL_RMS


def test_backward_pieces_match_the_dense_reference():
    """K13b/K13c's plain versions and the group sum, against autograd of the
    dense fp32 reference (what the pieces add up to)."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(1, 40, 8, 2, 16, seed=3))
    o, lse = fg.flash_fwd_lse(q, k, v)
    dq, dk, dv = fg.attention_backward(q, k, v, o, lse, w)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    (ops.attention_reference(tq, tk, tv) * w).sum().backward()
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    dk_heads, _ = fg.flash_bwd_dkv(q, k, v, w, lse, (w * o).sum(-1).transpose(1, 2))
    assert dk_heads.shape == (1, 40, 8, 16) and dk_heads.dtype == torch.float32


def test_attention_training_route_has_the_k13_backward():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in _inputs(1, 32, 4, 2, 16))
    out = ops.attention(q, k, v, impl=Impl(attention="flash"))
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    probs = ops.attention(q, k, v, impl=Impl(attention="flash"), return_probs=True)[1]
    assert probs.shape == (1, 4, 32, 32)
    with pytest.raises(RuntimeError, match="K1"):  # the cache route has no backward
        ops.attention(q, k, v, kv_len=20, impl=Impl(attention="flash"))
    with torch.no_grad():
        ops.attention(q, k, v, kv_len=20, impl=Impl(attention="flash"))


# F3: each kernel without a backward refuses a gradient, on either device.

def _model(name):
    spec = get_spec(name)
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    ids = torch.arange(6)[None] * 7 % spec.vocab_size
    return spec, params, ids


def _forward_call(impl, quant=None, cache=False):
    spec, params, ids = _model("llama-tiny")
    if quant:
        params = quantize_params(params, spec, quant)
    trainable(params)

    def call():
        c = init_cache(spec, 1, 16, device="cpu", quant="int8" if cache == "int8" else None) \
            if cache else None
        return forward(params, spec, ids, impl=impl, cache=c)[0]
    return call


def _decode_call(stack):
    spec, params, ids = _model("llama-tiny")
    trainable(params)
    impl = Impl(attention="flash", decode_stack=stack)

    def call():
        cache = init_cache(spec, 1, 16, device="cpu")
        with torch.no_grad():
            forward(params, spec, ids, impl=impl, cache=cache)
        cache["pos"] = ids.shape[1]
        return forward(params, spec, ids[:, :1], impl=impl, cache=cache)[0]
    return call


def _paged_call(kernel):
    spec, params, _ = _model("gpt2-tiny")
    trainable(params)
    B, H = 2, spec.hidden_size
    pool = torch.zeros(spec.num_layers, 4, 8, spec.num_kv_heads, spec.head_size)
    tables, ctx = torch.ones(B, 2, dtype=torch.int32), torch.ones(B, dtype=torch.int32)
    if kernel == "K7":
        q = torch.randn(B, spec.num_heads, spec.head_size, requires_grad=True)
        return lambda: pa.paged_attention(q, pool, pool, tables, ctx, layer=0)
    x = torch.randn(B, H, requires_grad=True)
    return lambda: dps.decode_paged_stack(x, params["blocks"], pool, pool, tables, ctx,
                                          spec=spec)


F3 = {
    "K1_cache_prefill": lambda: _forward_call(Impl(attention="flash"), cache=True),
    "K2_fused_norm": lambda: _forward_call(Impl(norm="fused")),
    "K5_int8_linear": lambda: _forward_call(Impl(), quant="int8"),
    "K9_int8_cache_prefill": lambda: _forward_call(Impl(attention="flash"), cache="int8"),
    "K11_fused_mlp": lambda: _forward_call(Impl(mlp="fused")),
    "K12_fused_ln_qkv": lambda: _forward_call(Impl(fused_ln_qkv=True)),
    "K3_scan_decode": lambda: _decode_call("scan"),
    "K4_mega_decode": lambda: _decode_call("mega"),
    "K6_tiled_decode": lambda: _decode_call("tiled"),
    "K7_paged_attention": lambda: _paged_call("K7"),
    "K8_paged_stack": lambda: _paged_call("K8"),
}


@pytest.mark.parametrize("case", list(F3), ids=list(F3))
def test_kernels_without_backward_refuse_gradients(case):
    call = F3[case]()
    kernel = case.split("_")[0]
    with pytest.raises(RuntimeError, match=rf"\({kernel}\) has no backward"):
        call()
    with torch.no_grad():
        out = call()
    assert torch.isfinite(out if isinstance(out, torch.Tensor) else out[0]).all()
