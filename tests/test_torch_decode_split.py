"""K3's context split, on the CPU.

K3 (``mlio_tpu_torch/csrc/decode_attn.cu``) runs each (sequence, KV head)
as a thread-block cluster: block r of n_split takes the cache's slots
[r * chunk, (r + 1) * chunk), runs the online softmax over the valid ones
(none where the chunk lies at or past the context: m = -inf, l = 0) and
leaves its (m, l, acc) in shared memory; the blocks then merge the states
in rank order. ``ops.decode_attention.split_plan`` picks (n_split, chunk)
from the shapes alone.

The plan is held to what the kernel needs: the chunks cover every slot
once, each a multiple of the block's token step, at most 8 blocks a
cluster, and enough blocks to fill the card about twice where the cap
allows. The split and the merge are written here in torch, fp32, chunk by
chunk, and held against the JAX package's ``decode_attention`` in Pallas
interpret mode (as ``tests/test_torch_ops.py`` runs it) on the same numpy
inputs, for n_split 1 to 16, at one and four query heads a KV head, with
contexts ending on a chunk boundary, one slot past it, at 1 and at 0. Both
compute in fp32 and differ by summation order only: atol = rtol = 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from mlio_tpu_torch.ops import decode_attention as da

TOL = dict(atol=1e-4, rtol=1e-4)

# (B, Hkv, Smax): GPT-2 small's decode (B 8, 12 heads, a 1024-slot cache),
# Mistral-7B-Instruct-v0.2's at 32K (B 1, 8 KV heads), and others around them.
NAMED = {"gpt2": (8, 12, 1024), "mistral_32k": (1, 8, 32768)}
GRID = [(1, 1, 10), (1, 1, 1024), (2, 2, 100), (4, 8, 2048), (8, 8, 1024), (16, 12, 1024),
        (32, 32, 4096), (64, 8, 2048), (3, 5, 777), (1, 32, 131072), (1, 2, 1100)]


def _chunks(Smax, n_split, chunk):
    return [(r * chunk, min((r + 1) * chunk, Smax)) for r in range(n_split)]


@pytest.mark.parametrize("shape", list(NAMED.values()) + GRID,
                         ids=list(NAMED) + [f"b{b}_h{h}_s{s}" for b, h, s in GRID])
def test_split_plan(shape):
    B, Hkv, Smax = shape
    n_split, chunk = da.split_plan(B, Hkv, Smax)
    assert 1 <= n_split <= da.MAX_SPLIT
    assert chunk % da.TOKEN_STEP == 0
    covered = np.zeros(Smax, np.int64)
    for lo, hi in _chunks(Smax, n_split, chunk):
        assert lo < hi, "a chunk lies wholly past the cache"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the fewest blocks that reach the target: short of it only where a
    # smaller chunk would need more blocks than a cluster holds, or the chunk
    # is one token step; past it only where a chunk one step larger falls short
    step = da.TOKEN_STEP
    if B * Hkv * n_split < da.BLOCK_TARGET:
        assert chunk == step or -(-Smax // (chunk - step)) > da.MAX_SPLIT
    else:
        assert B * Hkv * -(-Smax // (chunk + step)) < da.BLOCK_TARGET or n_split == 1


def test_split_plan_named_shapes():
    """GPT-2's 96 (sequence, KV head) pairs take 2-4 blocks each; Mistral's
    8 take the largest cluster, 8 blocks of 4,096 slots."""
    assert 2 <= da.split_plan(*NAMED["gpt2"])[0] <= 4
    assert da.split_plan(*NAMED["mistral_32k"]) == (da.MAX_SPLIT, 32768 // da.MAX_SPLIT)


def split_merge(q, kc, vc, ctx, layer, n_split, chunk, scale=None):
    """K3's split and merge in fp32: q [B, Hq, D], caches [L, B, Smax, Hkv,
    D], ctx [B]. Per chunk (block) r the softmax state (m, l, acc) over its
    valid slots; then, in rank order, mx = max m_r, f_r = exp(m_r - mx) (0
    where m_r = -inf), out = sum f_r acc_r / sum f_r l_r, 0 where l is 0."""
    B, Hq, D = q.shape
    Smax, Hkv = kc.shape[2], kc.shape[3]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qs = (q.float() * scale).reshape(B, Hkv, G, D)
    k, v = kc[layer].float(), vc[layer].float()  # [B, Smax, Hkv, D]
    states = []
    for lo, hi in _chunks(Smax, n_split, chunk):
        s = torch.einsum("bkgd,bskd->bkgs", qs, k[:, lo:hi])
        valid = (torch.arange(lo, hi)[None, :] < ctx[:, None])[:, None, None, :]
        s = s.masked_fill(~valid, float("-inf"))
        m = s.amax(-1)  # -inf for a chunk at or past the context
        p = torch.exp(s - torch.where(m.isneginf(), 0.0, m)[..., None])
        states.append((m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi])))
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l = torch.zeros_like(mx)
    o = torch.zeros(B, Hkv, G, D)
    for m, lr, acc in states:  # rank order
        f = torch.where(m.isneginf(), 0.0, torch.exp(m - mx))
        l = l + lr * f
        o = o + acc * f[..., None]
    return (o / torch.where(l == 0, 1.0, l)[..., None]).reshape(B, Hq, D)


@pytest.mark.parametrize("group", [1, 4], ids=["g1", "g4"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 7, 16])
def test_split_merge_matches_jax(n_split, group):
    L, B, Smax, Hkv, D = 2, 8, 64, 2, 64
    chunk = -(-Smax // n_split)
    rng = np.random.default_rng(100 + n_split + group)
    q = rng.standard_normal((B, Hkv * group, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((L, B, Smax, Hkv, D)).astype(np.float32) for _ in range(2))
    # on a chunk boundary, one slot past it, two chunks, the whole cache, 1 and 0
    ctx = np.array([chunk, min(chunk + 1, Smax), min(2 * chunk, Smax), Smax, Smax - 1, 1, 0,
                    17], np.int32)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                           jnp.asarray(ctx), layer=1, interpret=True))
    got = split_merge(*map(torch.from_numpy, (q, kc, vc, ctx)), layer=1, n_split=n_split,
                      chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[6].any()  # ctx 0 gives 0
    # the wrapper's plain version computes the same function in one pass
    plain = da.decode_attention(*map(torch.from_numpy, (q, kc, vc, ctx)), layer=1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_split_merge_at_the_plan():
    """The plan the wrapper launches at a small shape (B 6, one KV head of
    64, a 1024-slot cache: 8 chunks of 128 slots), contexts on and past its
    chunk edges, against the JAX package."""
    L, B, Smax, Hkv, D = 1, 6, 1024, 1, 64
    n_split, chunk = da.split_plan(B, Hkv, Smax)
    assert n_split > 1
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((L, B, Smax, Hkv, D)).astype(np.float32) for _ in range(2))
    ctx = np.array([chunk, chunk + 1, (n_split - 1) * chunk, Smax, 1, 0], np.int32)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                           jnp.asarray(ctx), layer=0, interpret=True))
    got = split_merge(*map(torch.from_numpy, (q, kc, vc, ctx)), layer=0, n_split=n_split,
                      chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
