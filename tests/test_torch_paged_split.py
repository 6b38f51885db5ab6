"""K7's context split and page walk, on the CPU.

K7 (``mlio_tpu_torch/csrc/paged_attn.cu``) runs each (sequence, KV head) as
a thread-block cluster: block r of n_split reads the table entries of its
chunk, pages [r * pages, (r + 1) * pages), once, and walks that chunk's slots
below the context in tiles of 64 slots (several whole pages at a block size
of 64 or less, a piece of one page above), each of its 8 warps an online
softmax in fp32 over its own slots of each tile (none where the chunk lies
at or past the context: m = -inf, l = 0); the warps' (m, l, acc) merge in
order into the block's, and the blocks' in rank order.
``ops.paged_attention.paged_split_plan`` picks (n_split, chunk) from the
shapes alone, a chunk a whole number of pages.

The plan is held to what the kernel needs: the chunks cover every page of
the table once, at most 8 blocks a cluster, equal chunks of whole pages,
and about one and a half blocks for each SM where the cap allows. The walk, the split and the merges
are written here in torch, fp32, tile by tile and warp by warp, reading the
table entries
past ceil(ctx / bs) as a block far outside the pool (so a read of one
fails), and held against the JAX package's ``paged_attention`` in Pallas
interpret mode (as ``tests/test_torch_paged.py`` runs it) on the same numpy
inputs and permuted tables, for n_split 1 to 8, one and four query heads a
KV head, blocks of 16 and 128 slots, bf16 and INT8 pools, with contexts of
0, 1, every page edge and one slot past it (so every chunk edge and one past
it at each n_split) and the full table. Both compute in fp32 and differ by
summation order only: atol = rtol = 1e-4.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from mlio_tpu_torch.ops import paged_attention as pa

TOL = dict(atol=1e-4, rtol=1e-4)
TS = 64  # the kernel's tile of slots

# (B, Hkv, max_blocks, bs): GPT-2 small's engine (B 8, 12 heads, tables of 8
# blocks of 128), llama3-8b's heads there, a long table of small blocks, and
# block sizes that are no power of two or larger than a tile
NAMED = {"gpt2_engine": (8, 12, 8, 128), "llama3_8b_heads": (8, 8, 8, 128),
         "long_table_bs16": (1, 8, 2048, 16)}
GRID = [(1, 1, 1, 128), (1, 1, 3, 16), (2, 2, 8, 16), (4, 8, 32, 128), (16, 12, 8, 128),
        (32, 32, 64, 16), (3, 5, 30, 48), (2, 4, 10, 256), (64, 8, 16, 64), (1, 32, 4096, 8)]


def _pages(max_blocks, n_split, pages):
    return [(r * pages, min((r + 1) * pages, max_blocks)) for r in range(n_split)]


@pytest.mark.parametrize("shape", list(NAMED.values()) + GRID,
                         ids=list(NAMED) + [f"b{b}_h{h}_nb{n}_bs{s}" for b, h, n, s in GRID])
def test_paged_split_plan(shape):
    B, Hkv, max_blocks, bs = shape
    n_split, chunk = pa.paged_split_plan(B, Hkv, max_blocks, bs)
    assert 1 <= n_split <= pa.MAX_SPLIT
    assert chunk % bs == 0, "a chunk is a whole number of pages"
    per = chunk // bs
    covered = np.zeros(max_blocks, np.int64)
    for lo, hi in _pages(max_blocks, n_split, per):
        assert lo < hi, "a chunk lies wholly past the table"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # equal chunks of whole pages, as many as the target asks where the cap
    # (MAX_SPLIT, TOKEN_STEP slots a chunk) and the pages allow: one page
    # less a chunk would need more blocks than the target asks
    want = min(pa.MAX_SPLIT, -(-pa.BLOCK_TARGET // (B * Hkv)))
    least = min(max_blocks, -(-pa.TOKEN_STEP // bs))
    assert per == max(least, -(-max_blocks // want))
    assert n_split <= want
    assert per == least or -(-max_blocks // (per - 1)) > want


def test_paged_split_plan_named_shapes():
    """GPT-2's 96 (sequence, KV head) pairs take 2 blocks of 4 pages,
    llama3-8b's 64 take 3 of 3 pages (the last 2); a long table of small
    blocks takes the largest cluster."""
    assert pa.paged_split_plan(*NAMED["gpt2_engine"]) == (2, 512)
    assert pa.paged_split_plan(*NAMED["llama3_8b_heads"]) == (3, 384)
    assert pa.paged_split_plan(*NAMED["long_table_bs16"]) == (pa.MAX_SPLIT, 2048 * 16 // 8)


def tiles(bs, rem):
    """The kernel's walk (paged_attn.cu's Walk) of a chunk whose first rem
    slots lie below the context: (first slot, page, row, valid slots) a
    tile, the page and row those of its first slot within the chunk."""
    if bs <= TS:
        ppt = TS // bs
        ts = ppt * bs
        return [(k * ts, k * ppt, 0, min(ts, rem - k * ts)) for k in range(-(-rem // ts))]
    ppp = -(-bs // TS)
    out = []
    for k in range((rem // bs) * ppp + -(-(rem % bs) // TS)):
        page, row = k // ppp, (k % ppp) * TS
        first = page * bs + row
        out.append((first, page, row, min(TS, bs - row, rem - first)))
    return out


def warp_slots(D):
    """The tile positions each of the block's 8 warps takes (paged_attn.cu:
    thread t takes 8 dims, t % (D / 8), of the slots t / (D / 8) + SP j)."""
    ndg = D // 8
    sp, per = 256 // ndg, 32 // ndg
    return [[sl + sp * j for sl in range(w * per, (w + 1) * per) for j in range(TS // sp)]
            for w in range(8)]


def merge(states):
    """(m, l, acc) states merged in order: mx = max m_r, f_r = exp(m_r - mx)
    (0 where m_r = -inf), l = sum f_r l_r, acc = sum f_r acc_r."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    lt, o = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for m, lr, acc in states:
        f = torch.where(m.isneginf(), 0.0, torch.exp(m - mx))
        lt = lt + lr * f
        o = o + acc * f[..., None]
    return mx, lt, o


@contextlib.contextmanager
def one_thread():
    """torch on one thread: the mirror's thousands of tiny products ran many
    times slower on the intra-op thread pool beside JAX's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def split_merge(q, kp, vp, tables, ctx, layer, n_split, pages, ksp=None, vsp=None):
    """K7's page walk, split and merges in fp32: q [B, Hq, D], pools
    [L, NB, bs, Hkv, D] (with INT8 pools their scale pools [L, NB, bs,
    Hkv]), tables [B, max_blocks], ctx [B]. Block r reads its chunk's table
    entries and walks the tiles of its slots below ctx; each warp keeps an
    online softmax over its own slots of each tile: s = (q * scale) . k
    (times the K scale), m, alpha, p = exp(s - m) and l, acc += (p times
    the V scale) v. The warps' states merge in order into the block's, the
    blocks' in rank order (``merge``); out = acc / l, 0 where l is 0."""
    with one_thread():
        return _split_merge(q, kp, vp, tables, ctx, layer, n_split, pages, ksp, vsp)


def _split_merge(q, kp, vp, tables, ctx, layer, n_split, pages, ksp, vsp):
    B, Hq, D = q.shape
    bs, Hkv = kp.shape[2], kp.shape[3]
    G, max_blocks = Hq // Hkv, tables.shape[1]
    qs = (q.float() * D ** -0.5).reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    for b in range(B):
        n = max(0, min(int(ctx[b]), max_blocks * bs))
        blocks = []
        for r in range(n_split):
            page0 = r * pages
            chunk_pages = max(0, min(pages, max_blocks - page0))
            rem = max(0, min(n, (page0 + chunk_pages) * bs) - page0 * bs)
            table = tables[b, page0:page0 + chunk_pages].tolist()  # read once, whole
            warps = [[torch.full((Hkv, G), float("-inf")), torch.zeros(Hkv, G),
                      torch.zeros(Hkv, G, D)] for _ in range(8)]
            for _, page, row, valid in tiles(bs, rem):
                for st, mine in zip(warps, warp_slots(D)):
                    pos = [i for i in mine if i < valid]
                    if not pos:  # all -inf: the warp's state stays
                        continue
                    blk = [table[page + (row + i) // bs] for i in pos]
                    slot = [(row + i) % bs for i in pos]
                    k, v = kp[layer, blk, slot].float(), vp[layer, blk, slot].float()
                    s = qs[b] @ k.permute(1, 2, 0)  # [Hkv, G, slots]
                    if ksp is not None:
                        s = s * ksp[layer, blk, slot].T[:, None, :]
                    m, l, acc = st
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.where(m.isneginf(), 0.0, torch.exp(m - m_new))
                    p = torch.exp(s - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    if vsp is not None:
                        p = p * vsp[layer, blk, slot].T[:, None, :]
                    st[:] = m_new, l, acc * alpha[..., None] + p @ v.transpose(0, 1)
            blocks.append(merge(warps))
        _, lt, o = merge(blocks)  # rank order
        out[b] = o / torch.where(lt == 0, 1.0, lt)[..., None]
    return out.reshape(B, Hq, D)


# (group, block size, table blocks), bf16 or INT8 pools
CASES = [(1, 16, 16), (4, 16, 16), (1, 128, 8), (4, 128, 8)]
_refs = {}


def _case(G, bs, nblk, pool):
    """Numpy inputs (permuted tables of nblk blocks over a pool of
    B * nblk + 1, contexts 0, 1, every page edge and one past it, the full
    table), the tables with the entries past ceil(ctx / bs) naming a block
    far outside the pool, and the JAX package's output (interpret mode),
    cached a case."""
    key = (G, bs, nblk, pool)
    if key not in _refs:
        rng = np.random.default_rng(G * 1000 + bs + (7 if pool == "int8" else 0))
        smax = nblk * bs
        ctx = np.array([0, 1] + [e + d for e in range(bs, smax, bs) for d in (0, 1)] + [smax],
                       np.int32)
        B, L, Hkv, D, layer = len(ctx), 2, 2, 64, 1
        nb = B * nblk + 1
        tables = (rng.permutation(nb - 1)[:B * nblk] + 1).reshape(B, nblk).astype(np.int32)
        far = tables.copy()
        for i, c in enumerate(ctx):
            far[i, -(-c // bs):] = nb + (1 << 20)
        q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
        kp, vp = (rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32) for _ in range(2))
        if pool == "int8":
            pools = []
            for x in (kp, vp):
                sc = np.abs(x).max(-1) / 127.0
                pools += [np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8),
                          sc.astype(np.float32)]
            tk, tks, tv, tvs = (torch.from_numpy(a) for a in pools)
            jk, jks, jv, jvs = (jnp.asarray(a) for a in pools)
            extra = dict(k_scale_pool=jks, v_scale_pool=jvs)
        else:  # bf16 values, the same on both sides
            tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (kp, vp))
            jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tk, tv))
            tks = tvs = None
            extra = {}
        want = np.asarray(jax_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                                              jnp.asarray(ctx), layer=layer, interpret=True,
                                              **extra))
        _refs[key] = dict(q=torch.from_numpy(q), k=tk, v=tv, ks=tks, vs=tvs,
                          tables=torch.from_numpy(tables), far=torch.from_numpy(far),
                          ctx=torch.from_numpy(ctx), layer=layer, want=want)
    return _refs[key]


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("G,bs,nblk", CASES, ids=[f"g{g}_bs{b}" for g, b, _ in CASES])
@pytest.mark.parametrize("n_split", list(range(1, 9)))
def test_paged_split_merge_matches_jax(n_split, G, bs, nblk, pool):
    c = _case(G, bs, nblk, pool)
    pages = -(-nblk // n_split)
    got = split_merge(c["q"], c["k"], c["v"], c["far"], c["ctx"], c["layer"], n_split, pages,
                      c["ks"], c["vs"])
    np.testing.assert_allclose(got.numpy(), c["want"], **TOL)
    assert not got[0].any()  # ctx 0 gives 0
    # the wrapper's plain version computes the same function in one pass
    plain = pa.paged_attention(c["q"], c["k"], c["v"], c["tables"], c["ctx"], layer=c["layer"],
                               k_scale_pool=c["ks"], v_scale_pool=c["vs"])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_paged_split_merge_at_the_plan():
    """The plan the wrapper launches at a small shape (B 6, one KV head of
    64, tables of 8 blocks of 128: 8 chunks of a page), contexts on and past
    its chunk edges, against the JAX package."""
    B, L, Hkv, D, bs, nblk = 6, 1, 1, 64, 128, 8
    n_split, chunk = pa.paged_split_plan(B, Hkv, nblk, bs)
    assert n_split > 1
    rng = np.random.default_rng(7)
    nb = B * nblk + 1
    tables = (rng.permutation(nb - 1)[:B * nblk] + 1).reshape(B, nblk).astype(np.int32)
    q = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32) for _ in range(2))
    ctx = np.array([chunk, chunk + 1, (n_split - 1) * chunk + 1, nblk * bs, 1, 0], np.int32)
    want = np.asarray(jax_paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                          jnp.asarray(tables), jnp.asarray(ctx), layer=0,
                                          interpret=True))
    got = split_merge(*map(torch.from_numpy, (q, kp, vp, tables, ctx)), layer=0,
                      n_split=n_split, pages=chunk // bs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
