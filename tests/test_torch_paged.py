"""The port's paged pools, paged attention (K7) and paged decode megakernel
(K8) against the JAX package on the CPU.

The same numpy-seeded inputs and tables go to the JAX functions, whose
Pallas kernels run in interpret mode as the JAX tests run them, and to the
port's wrappers on CPU tensors, which run the plain versions. Both compute in
fp32: K7 within 1e-5 abs + 1e-5 rel, K8 within 1e-4 on x_out and the
logits, the written pool rows within 1e-5, token ids equal. Slots outside
the live contexts filled with NaN must leave the port's outputs unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import init_params as jax_init_params
import mlio_tpu.ops.decode_paged_stack as jax_dps
import mlio_tpu.ops.paged_attention as jax_pa
from mlio_tpu_torch.models import from_jax_params, get_spec, rope_cos_sin
from mlio_tpu_torch.models.spec import ModelSpec
import mlio_tpu_torch.ops.decode_paged_stack as dps
import mlio_tpu_torch.ops.paged_attention as pa


def to_port_pool(pool, head_dim):
    """A JAX pool as the port's [L, NB, bs, Hkv, D] numpy array: the JAX
    flat [L, NB, bs, Hkv*D] (megakernel) layout is reshaped, the per-op
    [L, NB, bs, Hkv, D] one is taken as it is."""
    a = np.asarray(pool)
    return a.reshape(*a.shape[:3], -1, head_dim) if a.ndim == 4 else a


def to_jax_pool(pool, flat):
    """The port's pool as a JAX pool, flat [L, NB, bs, Hkv*D] or not."""
    a = np.asarray(pool)
    return jnp.asarray(a.reshape(*a.shape[:3], -1) if flat else a)


def _tables(rng, B, NB, max_blocks):
    """Shuffled, non-contiguous tables over blocks 1..NB-1 (0 is scratch)."""
    free = rng.permutation(np.arange(1, NB))[:B * max_blocks]
    return free.reshape(B, max_blocks).astype(np.int32)


def _live(ctx, bs, max_blocks, tables, NB, inclusive):
    """Boolean [NB, bs] of the pool rows inside some sequence's context."""
    live = np.zeros((NB, bs), bool)
    for b, c in enumerate(ctx):
        for s in range(min(c + (1 if inclusive else 0), max_blocks * bs)):
            live[tables[b, s // bs], s % bs] = True
    return live


def test_reshape_and_cache_matches_jax():
    rng = np.random.default_rng(0)
    L, NB, bs, Hkv, D, B, S = 2, 12, 8, 2, 16, 3, 11
    tables = _tables(rng, B, NB, 3)
    write_pos = np.array([0, 5, 13], np.int32)
    k_new, v_new = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    k0, v0 = (rng.standard_normal((L, NB, bs, Hkv, D)).astype(np.float32) for _ in range(2))
    jk, jv = jax_pa.reshape_and_cache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(k_new),
                                      jnp.asarray(v_new), jnp.asarray(tables),
                                      jnp.asarray(write_pos), 1)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    pa.reshape_and_cache(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                         torch.from_numpy(tables), torch.from_numpy(write_pos), 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the flat twin, on the flat view of the same pool
    jf = jax_pa.reshape_and_cache_flat(to_jax_pool(k0, True), jnp.asarray(k_new.reshape(B, S, -1)),
                                       jnp.asarray(tables), jnp.asarray(write_pos), 0)
    tf = torch.from_numpy(k0.reshape(L, NB, bs, -1).copy())
    pa.reshape_and_cache_flat(tf, torch.from_numpy(k_new.reshape(B, S, -1)),
                              torch.from_numpy(tables), torch.from_numpy(write_pos), 0)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert to_port_pool(jf, D).shape == (L, NB, bs, Hkv, D)


def test_init_kv_pools_matches_jax():
    jk, _ = jax_pa.init_kv_pools(2, 5, 3, 8, 64, dtype=jnp.float32)
    tk, tv = pa.init_kv_pools(2, 5, 3, 8, 64, dtype=torch.float32, device="cpu")
    assert tuple(tk.shape) == jk.shape and tv.shape == tk.shape and not tk.any()
    # INT8 pools: int8 K/V and fp32 scale pools of ones, as the JAX package's
    jq = jax_pa.init_kv_pools(2, 5, 3, 8, 64, quant="int8")
    tq = pa.init_kv_pools(2, 5, 3, 8, 64, quant="int8", device="cpu")
    assert len(tq) == len(jq) == 4
    for t, j in zip(tq, jq):
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# (group, block size): contexts [1, bs, 2 bs, 2 bs + 5] include a context of
# one and two that end on a block edge
K7_CASES = [(1, 8), (4, 8), (1, 16), (4, 16)]


@pytest.mark.parametrize("G,bs", K7_CASES, ids=[f"g{g}-bs{b}" for g, b in K7_CASES])
def test_paged_attention_matches_jax(G, bs):
    rng = np.random.default_rng(G * 100 + bs)
    L, NB, Hkv, D, layer = 2, 16, 2, 16, 1
    ctx = np.array([1, bs, 2 * bs, 2 * bs + 5], np.int32)
    B, max_blocks = len(ctx), 3
    tables = _tables(rng, B, NB, max_blocks)
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((L, NB, bs, Hkv, D)).astype(np.float32) for _ in range(2))
    want = jax_pa.paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(tables), jnp.asarray(ctx), layer=layer,
                                  interpret=True)
    args = (torch.from_numpy(tables), torch.from_numpy(ctx))
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                             *args, layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    ref = pa.paged_attention_reference(torch.from_numpy(q), torch.from_numpy(kp),
                                       torch.from_numpy(vp), *args, layer=layer)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # NaN in every slot outside the live contexts changes nothing
    dead = ~_live(ctx, bs, max_blocks, tables, NB, inclusive=False)
    kn, vn = kp.copy(), vp.copy()
    kn[:, dead], vn[:, dead] = np.nan, np.nan
    nan = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
                             *args, layer=layer)
    np.testing.assert_array_equal(nan.numpy(), got.numpy())


def test_paged_attention_wrapper_rejects_bad_calls():
    q = torch.zeros(2, 4, 64)
    pool = torch.zeros(1, 4, 8, 2, 64)
    tables, ctx = torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):  # one scale pool, and a bf16 pool
        pa.paged_attention(q, pool, pool, tables, ctx, layer=0, k_scale_pool=pool[..., 0])
    with pytest.raises(ValueError, match="layer"):
        pa.paged_attention(q, pool, pool, tables, ctx, layer=1)
    with pytest.raises(ValueError, match="block_tables"):
        pa.paged_attention(q, pool, pool, tables[:1], ctx, layer=0)
    before = pa.paged_attention.launches
    pa.paged_attention(q, pool, pool, tables, ctx, layer=0)
    assert pa.paged_attention.launches == before


def _both(name, bias_scale=None):
    """(JAX spec, JAX params, port spec, port params): the same weights, the
    norm scales and biases drawn from a seed, and an lm_head bias when asked."""
    jspec = JAX_PRESETS[name]
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, jax.random.PRNGKey(0),
                                                       dtype=jnp.float32))
    rng = np.random.default_rng(1)
    for key, vec in list(jparams["blocks"].items()):
        if vec is not None and ("bias" in key or key.startswith("b") or "scale" in key):
            jparams["blocks"][key] = (vec + 0.1 * rng.standard_normal(vec.shape)).astype(np.float32)
    if bias_scale is not None:
        jparams["lm_head_bias"] = (bias_scale * rng.standard_normal(jspec.vocab_size)).astype(
            np.float32)
    spec = ModelSpec(**dataclasses.asdict(jspec))
    return jspec, jax.tree.map(jnp.asarray, jparams), spec, from_jax_params(jparams, device="cpu")


def _head(params):
    tied = params["lm_head"] is None
    return dict(head_norm=(params["final_scale"], params["final_bias"]),
                lm_head=params["tok_embed"] if tied else params["lm_head"],
                lm_head_bias=params["lm_head_bias"], lm_vmajor=tied)


# (model, emit, lm_head bias scale): greedy and logits on both models, the
# llama-tiny logits case untied with a bias
K8_CASES = {"gpt2-none": ("gpt2-tiny", None, None), "gpt2-greedy": ("gpt2-tiny", "greedy", None),
            "gpt2-logits": ("gpt2-tiny", "logits", None),
            "llama-greedy": ("llama-tiny", "greedy", None),
            "llama-logits-bias": ("llama-tiny", "logits", 3.0)}


@pytest.mark.parametrize("case", list(K8_CASES), ids=list(K8_CASES))
def test_decode_paged_stack_matches_jax(case):
    name, emit, bias_scale = K8_CASES[case]
    jspec, jparams, spec, params = _both(name, bias_scale)
    rng = np.random.default_rng(2)
    L, NB, bs, D = spec.num_layers, 16, 8, spec.head_size
    # ragged past contexts in the same number of blocks, two at a block edge
    # (slots 0..15 read; slot 16 written into a fresh block). The JAX kernel
    # scans as many blocks as the longest context needs and multiplies a
    # block it never loaded for a shorter sequence (NaN in interpret mode)
    # by zero probabilities, so ragged block counts are held against the
    # port's own single-sequence calls below.
    past = np.array([9, 12, 15, 16], np.int32)
    B, max_blocks = len(past), 3
    tables = _tables(rng, B, NB, max_blocks)
    x = (0.5 * rng.standard_normal((B, spec.hidden_size))).astype(np.float32)
    kp, vp = (rng.standard_normal((L, NB, bs, spec.num_kv_heads, D)).astype(np.float32)
              for _ in range(2))
    jrope, cos, sin = None, None, None
    if spec.positional != "learned":
        jrope = jax_dps.rope_tables_for_paged(jspec, jnp.asarray(past), spec.num_heads,
                                              spec.num_kv_heads)
        cos, sin = rope_cos_sin(torch.from_numpy(past), spec.rope_dim, spec.rope_theta)
    jkw, kw = {}, {}
    if emit is not None:
        jkw = dict(_head(jparams), emit=emit)
        kw = dict(_head(params), emit=emit)
    jout, jk, jv = jax_dps.decode_paged_stack(
        jnp.asarray(x), jparams["blocks"], to_jax_pool(kp, True), to_jax_pool(vp, True),
        jnp.asarray(tables), jnp.asarray(past), jrope, spec=jspec, interpret=True, **jkw)

    def port(k_pool, v_pool):
        tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
        out = dps.decode_paged_stack(torch.from_numpy(x), params["blocks"], tk, tv,
                                     torch.from_numpy(tables), torch.from_numpy(past), cos, sin,
                                     spec=spec, **kw)
        return out, tk, tv

    (x_out, out), tk, tv = port(kp, vp)
    np.testing.assert_allclose(tk.numpy(), to_port_pool(jk, D), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), to_port_pool(jv, D), atol=1e-5, rtol=1e-5)
    if emit is None:
        assert out is None
        np.testing.assert_allclose(x_out.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    elif emit == "greedy":
        assert out.shape == (B,) and out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    else:
        assert out.shape == (B, spec.vocab_size) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jout)[:, :spec.vocab_size],
                                   atol=1e-4, rtol=1e-4)
    # only each sequence's slot past[b] changed
    changed = np.zeros((NB, bs), bool)
    for b, c in enumerate(past):
        changed[tables[b, c // bs], c % bs] = True
    np.testing.assert_array_equal(tk.numpy()[:, ~changed], kp[:, ~changed])
    # NaN in every slot outside the live contexts and the written slots
    dead = ~_live(past, bs, max_blocks, tables, NB, inclusive=True)
    kn, vn = kp.copy(), vp.copy()
    kn[:, dead], vn[:, dead] = np.nan, np.nan
    (x_nan, out_nan), _, _ = port(kn, vn)
    np.testing.assert_array_equal(x_nan.numpy(), x_out.numpy())
    if out is not None:
        np.testing.assert_array_equal(out_nan.numpy(), out.numpy())


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_decode_paged_stack_ragged_blocks_match_single_sequences(name):
    """Past contexts of 0 (the current token alone), 3, 8 and 21 slots, over
    one to three blocks: each row of the batch equals that sequence decoded
    alone."""
    _, _, spec, params = _both(name)
    rng = np.random.default_rng(3)
    L, NB, bs, D = spec.num_layers, 16, 8, spec.head_size
    past = np.array([0, 3, 8, 21], np.int32)
    B, max_blocks = len(past), 3
    tables = _tables(rng, B, NB, max_blocks)
    x = (0.5 * rng.standard_normal((B, spec.hidden_size))).astype(np.float32)
    kp, vp = (rng.standard_normal((L, NB, bs, spec.num_kv_heads, D)).astype(np.float32)
              for _ in range(2))

    def run(rows):
        cos = sin = None
        if spec.positional != "learned":
            cos, sin = rope_cos_sin(torch.from_numpy(past[rows]), spec.rope_dim, spec.rope_theta)
        return dps.decode_paged_stack(
            torch.from_numpy(x[rows]), params["blocks"], torch.from_numpy(kp.copy()),
            torch.from_numpy(vp.copy()), torch.from_numpy(tables[rows]),
            torch.from_numpy(past[rows]), cos, sin, spec=spec, emit="logits", **_head(params))

    x_all, logits_all = run(slice(None))
    for b in range(B):
        x_b, logits_b = run(slice(b, b + 1))
        np.testing.assert_allclose(x_all[b:b + 1].numpy(), x_b.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(logits_all[b:b + 1].numpy(), logits_b.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("name,want", [("gpt2-tiny", True), ("llama-tiny", True),
                                       ("neox-tiny", False), ("moe-tiny", False)])
def test_supports_paged_stack_matches_jax(name, want):
    assert dps.supports_paged_stack(get_spec(name)) is want
    assert jax_dps.supports_paged_stack(JAX_PRESETS[name]) is want


def test_decode_paged_stack_wrapper_rejects_bad_calls():
    _, _, spec, params = _both("gpt2-tiny")
    B, pool = 2, torch.zeros(spec.num_layers, 4, 8, spec.num_kv_heads, spec.head_size)
    x = torch.zeros(B, spec.hidden_size)
    tables, ctx = torch.ones(B, 2, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="emit"):
        dps.decode_paged_stack(x, params["blocks"], pool, pool, tables, ctx, spec=spec,
                               emit="probs")
    with pytest.raises(ValueError, match="head_norm"):
        dps.decode_paged_stack(x, params["blocks"], pool, pool, tables, ctx, spec=spec,
                               lm_head=params["tok_embed"])
    with pytest.raises(ValueError, match="RoPE"):
        dps.decode_paged_stack(x, params["blocks"], pool, pool, tables, ctx,
                               torch.ones(B, 4), torch.ones(B, 4), spec=spec)
    with pytest.raises(ValueError, match="not a model K8 runs"):
        dps.decode_paged_stack(x, params["blocks"], pool, pool, tables, ctx,
                               spec=get_spec("neox-tiny"))
    before = dps.decode_paged_stack.launches
    dps.decode_paged_stack(x, params["blocks"], pool, pool, tables, ctx, spec=spec)
    assert dps.decode_paged_stack.launches == before
