"""K6's GEMV item plan (``decode_tiled.item_plan``, the mirror of the
kernel's ``make_job``, ``unit_begin`` and ``unit_owner`` and of the order in
which ``finish_group`` sums partials) and the plain version's skipping of
experts no row picks.

The plan needs no card: every check here is on the mirror, which the card's
own plan function (``mlio_decode_tiled_items``) is held against in
chip_smoke.py. Shapes: llama3-8b and Mixtral-8x7B at full width, and the
widths chip_smoke.py's ``tiled_variants`` runs (H 256-4096; I 528, 784, 1040,
1200, 14336), and Gemma-7B's (head dim 256: Q/K/V 4096 wide beside an H of
3072; I 24576).
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from mlio_tpu_torch.models import get_spec, init_params, rope_cos_sin
from mlio_tpu_torch.ops import decode_tiled as dt

SMS = 132
FORMATS = {"bf16": None, "int8": "int8", "fp8": "fp8"}
# Mixtral's picked experts at a layer by batch: B 1 picks 2 of 8, B 8 leaves
# some unpicked, B 32 picks them all.
PICKS = {1: [2, 5], 8: [0, 1, 3, 4, 6, 7], 32: list(range(8))}


def _variant_specs():
    """chip_smoke.py's tiled_variants geometries (2 layers)."""
    gpt2, llama = get_spec("gpt2"), get_spec("llama-tiny")
    small = dict(num_layers=2, vocab_size=1000)
    return {
        "g4_d128": dataclasses.replace(llama, name="t-g4", hidden_size=1024, num_heads=8,
                                       num_kv_heads=2, intermediate_size=1040, **small),
        "g7_d64": dataclasses.replace(llama, name="t-g7", hidden_size=448, num_heads=7,
                                      num_kv_heads=1, intermediate_size=1200, **small),
        "g2_d64_geglu": dataclasses.replace(llama, name="t-g2", hidden_size=512, num_heads=8,
                                            num_kv_heads=4, intermediate_size=784,
                                            activation="geglu", **small),
        "g1_rope_partial": dataclasses.replace(gpt2, name="t-rope", hidden_size=256, num_heads=4,
                                               num_kv_heads=4, intermediate_size=528,
                                               positional="rope", rope_fraction=0.5,
                                               activation="gelu", **small),
        "gpt2": dataclasses.replace(gpt2, name="t-gpt2", **small),
    }


def _plan(model, fmt, B):
    spec = get_spec(model)
    picks = PICKS[B] if spec.num_experts else None
    return spec, picks, dt.item_plan(spec, FORMATS[fmt], nb=SMS, experts=picks)


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("model", ["llama3-8b", "mixtral-8x7b", "gemma-7b"])
def test_plan_covers_every_unit_once(model, fmt, B):
    """Each phase's items cut [0, ntiles * nk) into runs, one a block in
    block order, each run split at tile edges: every (tile, k block) of
    every picked expert is streamed by exactly one item, and the tiles are
    exactly the picked experts' column tiles."""
    spec, picks, plan = _plan(model, fmt, B)
    for phase, p in plan.items():
        U = p["ntiles"] * p["nk"]
        covered = np.zeros(U, dtype=np.int32)
        last_block, end = -1, 0
        for block, tile, u0, u1 in p["items"]:
            assert u0 == end and u1 > u0 and block >= last_block
            assert u0 // p["nk"] == tile == (u1 - 1) // p["nk"]
            covered[u0:u1] += 1
            last_block, end = block, u1
        assert end == U and (covered == 1).all()
        if phase.startswith("mlp"):
            want = picks if spec.num_experts else [0]
            experts = [t["expert"] for t in p["tiles"]]
            assert sorted(set(experts)) == sorted(want)
            assert all(experts.count(e) == p["ct"] for e in want)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_unpicked_expert_gets_no_item(fmt):
    """At Mixtral's widths with experts 1 and 6 picked, no item of the up or
    down phase streams another expert's rows, and the attention phases do
    not depend on the picks."""
    spec = get_spec("mixtral-8x7b")
    plan = dt.item_plan(spec, FORMATS[fmt], nb=SMS, experts=[1, 6])
    every = dt.item_plan(spec, FORMATS[fmt], nb=SMS)
    for phase in ("mlp_up", "mlp_down"):
        p = plan[phase]
        assert {p["tiles"][t]["expert"] for _, t, _, _ in p["items"]} == {1, 6}
        assert p["ntiles"] * 4 == every[phase]["ntiles"]
    for phase in ("qkv", "out_proj"):
        assert plan[phase]["items"] == every[phase]["items"]


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("model", ["llama3-8b", "mixtral-8x7b", "gemma-7b"])
def test_plan_fills_every_sm(model, fmt, B):
    """Every GEMV phase has at least 132 items (segments) at llama3-8b's
    and Mixtral's widths, and every one of the 132 blocks streams units:
    the MLP is spread over all SMs at every batch."""
    _, _, plan = _plan(model, fmt, B)
    for phase, p in plan.items():
        assert len(p["items"]) >= SMS, phase
        assert {block for block, *_ in p["items"]} == set(range(SMS)), phase


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", ["llama3-8b", "mixtral-8x7b", "gemma-7b", *_variant_specs()])
def test_tile_rows_and_tma_strides(case, fmt):
    """A tile row is 256 bytes of each matrix (two 128-byte TMA boxes)
    wherever the matrix is that wide, only a matrix's last tile is
    narrower, and every matrix's row stride is a multiple of 16 bytes (what
    a tensor map takes) at every width tiled_variants runs."""
    spec = get_spec(case) if case in ("llama3-8b", "mixtral-8x7b", "gemma-7b") \
        else _variant_specs()[case]
    isz = 2 if fmt == "bf16" else 1
    plan = dt.item_plan(spec, FORMATS[fmt], nb=SMS)
    for phase, p in plan.items():
        assert p["tc"] * isz == dt.TILE_BYTES
        assert p["kb"] * p["nm"] * dt.TILE_BYTES == dt.SLOT_BYTES
        by_matrix = {}
        for t in p["tiles"]:
            by_matrix.setdefault((t["matrix"], t["expert"]), []).append(t)
        for tiles in by_matrix.values():
            assert tiles[0]["stride"] % 16 == 0
            width = tiles[0]["stride"] // isz
            for i, t in enumerate(tiles):
                assert t["col0"] == i * p["tc"]
                if i < len(tiles) - 1:
                    assert t["width"] * isz == dt.TILE_BYTES
                else:
                    assert t["col0"] + t["width"] == width


def _arrivals(p, rng):
    """Replay the kernel's sums: the segments arrive in a shuffled order, a
    counter a group counts them, and the one that brings a group's count to
    its total sums the group's partials in the plan's order. Returns, per
    group, (the slots summed, the block that summed them)."""
    ct = p["ct"]
    down = "expert" in p["tiles"][0] and p["tiles"][0]["matrix"] == "w_down"
    group = (lambda t: t % ct) if down else (lambda t: t)
    totals = {}
    for _, tile, _, _ in p["items"]:
        totals[group(tile)] = totals.get(group(tile), 0) + 1
    seen, out = {}, {}
    items = list(p["items"])
    rng.shuffle(items)
    for block, tile, _, _ in items:
        g = group(tile)
        seen[g] = seen.get(g, 0) + 1
        if seen[g] == totals[g]:
            out[g] = (list(p["order"][g]), block)
    assert len(out) == len(p["order"]) and all(len(p["order"][g]) == n
                                               for g, n in totals.items())
    return out


@pytest.mark.parametrize("phase", list(dt.GEMV_PHASES))
@pytest.mark.parametrize("model,fmt,experts", [("llama3-8b", None, None),
                                               ("mixtral-8x7b", "int8", [0, 2, 3, 7]),
                                               ("gemma-7b", None, None)],
                         ids=["llama3-8b-bf16", "mixtral-8x7b-int8", "gemma-7b-bf16"])
def test_sum_order_does_not_depend_on_arrival(model, fmt, experts, phase):
    """Whatever order the segments arrive in, each group's partials are
    summed in one order: its segments' slots (block + tile, unique in the
    phase) by expert, then by block (k order). fp32 sums of seeded partials
    in that order give the same bits under every arrival order."""
    spec = get_spec(model)
    p = dt.item_plan(spec, fmt, nb=SMS, experts=experts)[phase]
    slots = [block + tile for block, tile, _, _ in p["items"]]
    assert len(set(slots)) == len(slots)
    by_slot = {block + tile: (tile, block) for block, tile, _, _ in p["items"]}
    for g, order in enumerate(p["order"]):
        keys = [(p["tiles"][by_slot[s][0]]["expert"] or 0, by_slot[s][1]) for s in order]
        assert keys == sorted(keys) and len(set(keys)) == len(keys), g
    partial = np.random.default_rng(1).standard_normal(max(slots) + 1).astype(np.float32)
    results = []
    for seed in range(3):
        sums = {}
        for g, (order, _) in _arrivals(p, random.Random(seed)).items():
            acc = np.float32(0)
            for s in order:
                acc = np.float32(acc + partial[s])
            sums[g] = acc.tobytes()
        results.append(sums)
    assert results[0] == results[1] == results[2]


# ---------------------------------------------------------------------------
# The plain version skips the experts no row picks
# ---------------------------------------------------------------------------

def _mixtral_shaped():
    """Mixtral-8x7B's structure (8 experts, top 2, SwiGLU, RMSNorm, RoPE,
    32/8 query/KV heads) at 2 layers and small widths."""
    return dataclasses.replace(get_spec("mixtral-8x7b"), name="mixtral-shaped", num_layers=2,
                               hidden_size=256, num_heads=8, num_kv_heads=2,
                               intermediate_size=448, vocab_size=512)


def _mixtral_inputs(spec, B, seed):
    rng = np.random.default_rng(seed)
    Smax, pos = 64, 40
    shape = (spec.num_layers, B, Smax, spec.num_kv_heads, spec.head_size)
    x = torch.from_numpy(rng.standard_normal((B, spec.hidden_size)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    cos, sin = rope_cos_sin(torch.arange(pos, pos + 1), spec.rope_dim, spec.rope_theta)
    return x, kc, vc, pos, cos, sin


@pytest.mark.parametrize("B", [1, 3])
def test_plain_skipping_unpicked_experts_gives_the_same_bits(B):
    """decode_layer_tiled_plain with the experts no row picks skipped (the
    kernel's way) gives the same bits as adding every expert's product
    weighted by comb 0 (the TPU kernel's way), caches included, at a
    2-layer Mixtral-shaped spec where some experts go unpicked; and wrecking
    an unpicked expert's weights (inf) changes nothing when it is skipped."""
    spec = _mixtral_shaped()
    params = init_params(spec, torch.Generator().manual_seed(3), dtype=torch.float32,
                         device="cpu")
    blocks = params["blocks"]
    x, kc, vc, pos, cos, sin = _mixtral_inputs(spec, B, 7 + B)
    L, E = spec.num_layers, spec.num_experts
    probs = torch.zeros((L, B, E))

    def run(blk, **kw):
        k, v = kc.clone(), vc.clone()
        out = dt.decode_layer_tiled_plain(x, blk, k, v, pos, cos, sin, spec=spec, **kw)
        return out, k, v

    skipped = run(blocks, router_probs=probs)
    every = run(blocks, every_expert=True)
    for a, b in zip(skipped, every):
        assert torch.equal(a, b)
    picks = dt.topk_mask(probs, spec.num_experts_per_tok)
    unpicked = [(layer, e) for layer in range(L) for e in range(E)
                if not bool(picks[layer, :, e].any())]
    assert unpicked, "every expert picked: the case shows nothing"
    layer, e = unpicked[0]
    wrecked = dict(blocks)
    for name in ("moe_up", "moe_gate", "moe_down"):
        w = blocks[name].clone()
        w[layer, e] = float("inf")
        wrecked[name] = w
    assert torch.equal(run(wrecked)[0], skipped[0])
    assert not torch.isfinite(run(wrecked, every_expert=True)[0]).all()
