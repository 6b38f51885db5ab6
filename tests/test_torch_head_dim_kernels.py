"""The plans of K1 at head dim 256 and K3 at head dim 80, mirrored in Python.

Both kernels run only on the card; what surrounds them is Python that the
wrappers use before any launch, held here on the CPU:

- K1 at D 256 (``csrc/flash_fwd_d256.cu``): its blocks in launch order
  (``flash_attention.d256_blocks``) and each consumer's tiles
  (``d256_consumer``). Walking them the way the kernel does must visit
  every (query, key) pair that the causal, q_offset and kv_len rule admits
  exactly once, and no other; interior (unmasked) tiles must hold admitted
  pairs only; the heaviest q tile must start first.
- K3 at D 80 (``csrc/decode_attn.cuh``'s TMA pass): inside each
  ``split_plan`` chunk the ring's stages (``decode_attention.ring_stages``)
  cover [0, n_b) exactly once.
- The TMA maps both build from strides (``flash_attention.tma_map``,
  ``decode_attention.cache_map``): dims, byte strides and boxes for the bshd
  and bhsd layouts and for a cache sliced at kv_len, and a ``ValueError``
  where a stride breaks TMA's rules. K3's maps are encoded once per cache.
"""
import numpy as np
import pytest
import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops import decode_attention as da
from mlio_tpu_torch.ops import flash_attention as fa

# (Hq, Hkv, Sq, Skv, causal, q_offset, kv_len) at B 2: tests/test_torch_head_dims.py's
# FLASH_CASES, gemma-7b's prefill (8 x 704 into 1024 slots, 16 heads) and two edges
CASES = {
    "causal_prefill_past_tile": (2, 2, 70, 96, True, 0, [70, 41]),
    "causal_gqa_offset_ragged": (4, 2, 5, 32, True, 11, [16, 13]),
    "full_ragged": (2, 1, 7, 32, False, 0, [32, 7]),
    "gemma_7b_prefill": (16, 16, 704, 1024, True, 0, [704] * 8),
    "negative_offset_empty_kv": (2, 1, 130, 200, True, -40, [200, 0]),
    "ragged_q_tile_kv_tail": (4, 4, 200, 256, True, 0, [150, 256]),
}


def _admitted(Sq, Skv, kvl, causal, q_offset):
    """[Sq, Skv] bool: the pairs the rule admits."""
    i = np.arange(Sq)[:, None]
    j = np.arange(Skv)[None, :]
    ok = j < kvl
    return ok & (j <= i + q_offset) if causal else ok & np.ones_like(i, bool)


@pytest.mark.parametrize("case", list(CASES))
def test_d256_blocks_visit_each_admitted_pair_once(case):
    Hq, Hkv, Sq, Skv, causal, q_offset, kv_len = CASES[case]
    B = len(kv_len)
    BKV = fa.D256_BKV
    blocks = fa.d256_blocks(B, Sq, Hq, Hkv)
    n_qt = -(-Sq // fa.D256_BQ)
    assert len(blocks) == B * Hq * n_qt
    assert len(set(blocks)) == len(blocks)
    # the heaviest q tile starts first; within each (batch, KV head) the
    # tiles go from the heaviest to the lightest, its query heads side by
    # side; a group of pairs runs its heaviest tiles before its lighter ones
    assert blocks[0][2] == (n_qt - 1) * fa.D256_BQ
    G = Hq // Hkv
    starts_of = {}
    for b, h, q_start in blocks:
        starts_of.setdefault((b, h // G), []).append(q_start)
    for starts in starts_of.values():
        assert starts == sorted(starts, reverse=True)
    group = max(1, 132 // (G * n_qt))
    per_group = group * G * n_qt
    for p in range(0, len(blocks), per_group):
        window = blocks[p:p + per_group]
        assert len({(b, h // G) for b, h, _ in window}) <= group
        qs = [q for _, _, q in window]
        assert qs == sorted(qs, reverse=True)
        for j in range(0, len(window), G):
            heads = window[j:j + G]
            assert len({(b, h // G, q) for b, h, q in heads}) == 1
    by_pair = {}
    for b, h, q_start in blocks:
        by_pair.setdefault((b, h), []).append(q_start)
    for (b, h), starts in by_pair.items():
        kvl = min(kv_len[b], Skv)
        want = _admitted(Sq, Skv, kvl, causal, q_offset)
        seen = np.zeros((Sq, Skv), np.int32)
        for q_start in starts:
            for w in range(2):
                row0 = q_start + 64 * w
                plan = fa.d256_consumer(row0, Sq, kvl, causal, q_offset)
                if plan is None:
                    assert row0 >= Sq
                    continue
                n, n_full = plan
                rows = slice(row0, min(row0 + 64, Sq))
                for j in range(n):
                    keys = slice(j * BKV, min((j + 1) * BKV, Skv))
                    if j < n_full:  # interior: no mask, so every pair must be admitted
                        assert want[rows, keys].all(), (b, h, row0, j)
                        seen[rows, keys] += 1
                    else:
                        seen[rows, keys] += want[rows, keys]
        np.testing.assert_array_equal(seen, want.astype(np.int32))


def test_d256_consumer_of_the_ragged_tile():
    """gemma-7b's last q tile (rows 640-703 of 704): its second consumer has
    no row; the first takes all 11 tiles of 704 keys, 10 of them interior;
    consumer 0 of a full tile stops one tile before consumer 1."""
    assert fa.d256_consumer(704, 704, 704, True, 0) is None
    assert fa.d256_consumer(640, 704, 704, True, 0) == (11, 10)
    assert fa.d256_consumer(512, 704, 704, True, 0) == (9, 8)
    assert fa.d256_consumer(576, 704, 704, True, 0) == (10, 9)
    assert fa.d256_consumer(0, 704, 0, True, 0) == (0, 0)


# (B, Hkv, Smax) of phi-2's decode (the scan's cache), a long cache, and one
# that a chunk does not divide
K3_SHAPES = [(8, 32, 1024), (1, 32, 4096), (2, 32, 200)]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=["phi2", "long", "short"])
def test_k3_ring_stages_cover_each_chunk_once(shape):
    B, Hkv, Smax = shape
    n_split, chunk = da.split_plan(B, Hkv, Smax)
    assert da.TOKEN_STEP % da.RING_TOKENS == 0 and chunk % da.RING_TOKENS == 0
    rng = np.random.default_rng(Smax)
    contexts = {0, 1, Smax, Smax - 1, da.RING_TOKENS, da.RING_TOKENS + 1, chunk, chunk + 1,
                *[min(c, Smax) for c in (15, 16, 127, 128, 500, 895, 896, 1022)],
                *rng.integers(0, Smax + 1, 8).tolist()}
    for ctx in sorted(contexts):
        n_b = min(ctx, Smax)
        seen = np.zeros(Smax + da.RING_TOKENS, np.int32)
        for rank in range(n_split):
            stages = da.ring_stages(n_b, rank, chunk)
            lo, hi = rank * chunk, min(n_b, (rank + 1) * chunk)
            if hi <= lo:
                assert stages == []
            for t0, cnt in stages:
                assert lo <= t0 < hi and (t0 - lo) % da.RING_TOKENS == 0
                assert 0 < cnt <= da.RING_TOKENS and t0 + cnt <= hi
                seen[t0:t0 + cnt] += 1
        np.testing.assert_array_equal(seen[:n_b], 1)
        assert not seen[n_b:].any()


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_tma_map_bshd_bhsd_and_sliced():
    # gemma-7b's q and cache in bshd: [D, S, H, B], the byte strides of S, H, B
    q = _bf16(8, 704, 16, 256)
    assert fa.tma_map(q, "bshd", 64) == ((256, 704, 16, 8), (8192, 512, 704 * 8192),
                                         (64, 64, 1, 1))
    k = _bf16(8, 1024, 16, 256)
    # the cache sliced at kv_len keeps the cache's strides, its S shrinks
    assert fa.tma_map(k[:, :704], "bshd", fa.D256_BKV) == (
        (256, 704, 16, 8), (8192, 512, 1024 * 8192), (64, fa.D256_BKV, 1, 1))
    # bhsd: [B, H, S, D] in memory, the same dims, S's stride one row
    kb = _bf16(8, 16, 1024, 256)
    assert fa.tma_map(kb, "bhsd", 64) == ((256, 1024, 16, 8), (512, 1024 * 512, 16 * 1024 * 512),
                                          (64, 64, 1, 1))
    # a dim of size 1 takes a row's bytes (its coordinate is always 0)
    assert fa.tma_map(_bf16(1, 5, 1, 256), "bshd", 64)[1] == (512, 512, 512)


def test_cache_map_of_the_scan_cache():
    # phi-2's cache [L, B, Smax, Hkv, 80]: [D, Hkv, Smax, L * B], 160-byte rows
    c = _bf16(4, 8, 1024, 32, 80)
    assert da.cache_map(c) == ((80, 32, 1024, 32), (160, 32 * 160, 1024 * 32 * 160),
                               (80, 1, da.RING_TOKENS, 1))
    assert da.cache_map(_bf16(1, 3, 64, 2, 80))[0] == (80, 2, 64, 3)


@pytest.mark.parametrize("bad", ["row_stride", "head_dim_stride", "start"])
def test_tma_maps_refuse_what_tma_refuses(bad):
    if bad == "row_stride":  # 257 elements a head: 514-byte strides
        t = _bf16(2, 8, 4, 257)[..., :256]
        c = _bf16(2, 2, 16, 4, 81)[..., :80]
    elif bad == "head_dim_stride":
        t = _bf16(2, 8, 4, 512)[..., ::2]
        c = _bf16(2, 2, 16, 4, 160)[..., ::2]
    else:  # a start 2 bytes past a 16-byte boundary
        t = _bf16(2 * 8 * 4 * 256 + 8).view(-1)[1:1 + 2 * 8 * 4 * 256].view(2, 8, 4, 256)
        c = _bf16(2 * 2 * 16 * 4 * 80 + 8).view(-1)[1:1 + 2 * 2 * 16 * 4 * 80].view(2, 2, 16, 4, 80)
    with pytest.raises(ValueError, match="TMA"):
        fa.tma_map(t, "bshd", 64)
    with pytest.raises(ValueError, match="TMA"):
        da.cache_map(c)


class _FakeLib:
    """The two map entries of decode_attn's library, counting the encodes."""

    def __init__(self):
        self.encodes = 0

    def mlio_decode_attn_maps_bytes(self):
        return 256

    def mlio_decode_attn_maps(self, k, v, geo, buf):
        self.encodes += 1
        return 0


def test_k3_maps_encoded_once_per_cache():
    lib = _FakeLib()
    k, v = _bf16(2, 4, 256, 32, 80), _bf16(2, 4, 256, 32, 80)
    first = da._maps(lib, k, v)
    for _ in range(3):
        assert da._maps(lib, k, v) is first
    assert lib.encodes == 1
    da._maps(lib, _bf16(2, 4, 256, 32, 80), v)
    assert lib.encodes == 2
    with pytest.raises(ValueError, match="same strides"):
        da._maps(lib, k, _bf16(2, 4, 256, 32, 88)[..., :80])
    _build._maps.clear()
