"""K4's and K8's plan (``decode_layer.stack_plan``, ``block_program`` and
``unit_stream``: the mirror of ``csrc/decode_stack.cuh``'s make_phase and
make_plan, of its producer warp's order of weight units and of its
consumers' waits), held without a card. chip_smoke.py holds the card's own
plan (``mlio_*_stack_items``) against the same mirror.

Shapes: GPT-2 small, gpt2-medium, gpt2-xl, opt-1.3b and llama3-8b at full
width, bf16, int8 and mixed weights (each matrix has its own format), B 1
and 8, K4's contiguous cache (two steps in one launch) and K8's ragged
contexts (one step, each sequence's attention split by its own context).
The dependency checks cut the depth to 2 layers: every layer's plan is the
same, and 2 layers over 2 steps cross both a layer and a step boundary.

The ring's protocol (ring slot i % slots, a full and an empty mbarrier a
slot, their parities) is read from the kernel's source and run against a
model of the mbarriers under random schedules.

A mixed set of weights (``quantize_params(skip=...)``) also goes through
K4's plain version against the JAX package's kernel (interpret), and the
routes take it (a gated MLP's w_up and w_gate in one format).
"""
import dataclasses
import random
import re
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models.transformer import rope_cos_sin as jax_rope_cos_sin
from mlio_tpu.ops.decode_layer import decode_layer_stack as jax_decode_layer_stack
from mlio_tpu.runtime.quantization import quantize_params as jax_quantize_params
from mlio_tpu_torch.models import from_jax_params, get_spec, rope_cos_sin
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops import decode_layer as dl
from mlio_tpu_torch.runtime.quantization import quantize_params

SMS = dl.SMS
MODELS = ["gpt2", "gpt2-medium", "gpt2-xl", "opt-1.3b", "llama3-8b"]
# mixed: QKV's three matrices in two formats, the out-projection bf16 and
# down int8 (their residual statistics over tiles of different widths)
MIXED = {"wq": "int8", "wv": "int8", "w_down": "int8"}
FORMATS = {"bf16": None, "int8": "int8", "mixed": MIXED}
CACHES = {"contiguous": 2, "ragged": 1}  # the launch's steps: K4 multi-step, K8 one
RAGGED = (1, 15, 16, 127, 128, 500, 895, 1022)  # chip_smoke.py's K8 past contexts


def _slots(cache, B):
    """Each sequence's slots to attend at step s: K4 at context 896 (+ s),
    K8 at the ragged past contexts (+ the current token)."""
    if cache == "contiguous":
        return lambda s: [896 + s] * B
    return lambda s: [RAGGED[b % len(RAGGED)] + 1 for b in range(B)]
CHUNK = 32  # columns: every unit's rows, tile and head are whole chunks


def _case(model, cache):
    spec = dataclasses.replace(get_spec(model), num_layers=2)
    return spec, CACHES[cache]


CASES = pytest.mark.parametrize("cache", list(CACHES))
BATCH = pytest.mark.parametrize("B", [1, 8])
FMT = pytest.mark.parametrize("fmt", list(FORMATS))
MODEL = pytest.mark.parametrize("model", MODELS)


@MODEL
@FMT
@BATCH
@CASES
def test_every_unit_issued_once_in_the_consumers_order(model, fmt, B, cache):
    """Each block's producer issues its units in the order its consumers
    take them (the segments of block_program, phase by phase), and over
    all blocks every (step, layer, phase, tile, k rows) unit is issued
    exactly once."""
    spec, steps = _case(model, cache)
    plan = dl.stack_plan(spec, FORMATS[fmt])
    seen = set()
    for b in range(SMS):
        stream = dl.unit_stream(plan, b, steps, spec.num_layers)
        consumed = []
        for ev in dl.block_program(plan, spec, B, steps, b, slots=_slots(cache, B)):
            if ev[0] == "seg":
                _, kind, it, tile, u0, u1 = ev
                s, layer = divmod(it, spec.num_layers)
                KB, nk = plan["phases"][kind]["KB"], plan["phases"][kind]["nk"]
                consumed += [(s, layer, kind, u // nk, (u % nk) * KB) for u in range(u0, u1)]
            elif ev[0] == "logits":
                _, s, t0, t1 = ev
                consumed += [(s, spec.num_layers, "head", vt, kc) for vt in range(t0, t1)
                             for kc in range(plan["head"]["nk"])]
        assert consumed == stream
        assert not seen & set(stream)
        seen |= set(stream)
    want = steps * spec.num_layers * sum(p["ntiles"] * p["nk"] for p in plan["phases"].values())
    want += steps * plan["head"]["tiles"] * plan["head"]["nk"]
    assert len(seen) == want


@FMT
def test_every_sm_has_work_in_every_gemv_phase_at_gpt2_small(fmt):
    """At GPT-2 small the units are cut small enough (KB 32-128 rows) that
    all 132 blocks stream weights in each of the four GEMV phases."""
    plan = dl.stack_plan(get_spec("gpt2"), FORMATS[fmt])
    for kind, ph in plan["phases"].items():
        assert {i[0] for i in ph["items"]} == set(range(SMS)), kind
        assert ph["KB"] >= dl.MIN_KB


@MODEL
@FMT
@BATCH
@CASES
def test_each_sum_order_is_fixed_whatever_arrives_last(model, fmt, B, cache):
    """A group's sum adds its segments' partial slots in k order (w_up's,
    then w_gate's): the list the plan gives is the group's segments sorted
    by (tile, first unit), computed from the plan alone, so whichever
    segment arrives last sums in the same order; and its length is the
    arrivals that complete the group."""
    spec, _ = _case(model, cache)
    plan = dl.stack_plan(spec, FORMATS[fmt])
    for kind, ph in plan["phases"].items():
        by_group = defaultdict(list)
        for block, tile, u0, u1 in ph["items"]:
            by_group[dl.segment_group(ph, tile)].append((tile, u0, block + tile))
        assert set(by_group) == set(range(ph["groups"])), kind
        for gi, segs in by_group.items():
            assert [slot for _, _, slot in sorted(segs)] == ph["order"][gi]
            assert ph["need"][gi] == len(segs) == len(set(ph["order"][gi]))


def _chunks(lo, hi):
    """The CHUNK-column chunks of columns [lo, hi)."""
    return range(lo // CHUNK, -(-hi // CHUNK))


def _accesses(plan, spec, B, steps, nb, progs):
    """The kernel's memory use by node of the dependency graph: (reads,
    writes) as sets of elements ("xres" | "act", chunk), ("qkv" | "attn", row,
    chunk), ("part", phase, slot), ("emax", block); and the node's place in
    the sequential function (iteration, rank) that orders conflicting
    accesses."""
    H, I, L = spec.hidden_size, spec.intermediate_size, spec.num_layers
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_size
    G, Qd, KVd = Hq // Hkv, Hq * D, Hkv * D
    ph = plan["phases"]
    rows = range(B)
    xres_all = {("xres", c) for c in _chunks(0, H)}

    def strided(b):  # the grid-stride elements block b writes of [B, H]
        out = set()
        for e0 in range(b * 256, B * H, nb * 256):
            for e in range(e0, min(e0 + 256, B * H), CHUNK):
                out.add(("xres", (e % H) // CHUNK))
        return out

    # the residual's tiles' row statistics, left by the out and down sums
    stats = {k: {(k, t) for t in range(ph[kind]["ntiles"])}
             for k, kind in (("ostat", "out_proj"), ("dstat", "mlp_down"))}
    acc = {}
    rank = {"qkv": (1, 2), "out_proj": (4, 5), "mlp_up": (6, 7), "mlp_down": (8, 9)}
    for b, prog in enumerate(progs):
        for i, ev in enumerate(prog):
            key = ("ev", b, i)
            if ev[0] == "init":
                acc[key] = (set(), strided(b), (0, 0))
            elif ev[0] == "token":
                acc[key] = ({("emax", k) for k in range(nb)}, strided(b), ((ev[1] + 1) * L, 0))
            elif ev[0] == "logits":
                acc[key] = (xres_all | stats["dstat"], {("emax", b)}, (ev[1] * L + L - 1, 10))
            elif ev[0] == "attn":
                _, it, r, hk, j, ns = ev
                reads = {("qkv", r, c) for c in _chunks(hk * G * D, (hk + 1) * G * D)}
                reads |= {("qkv", r, c) for off in (Qd, Qd + KVd)
                          for c in _chunks(off + hk * D, off + (hk + 1) * D)}
                out = {("attn", r, c) for c in _chunks(hk * G * D, (hk + 1) * G * D)}
                if ns == 1:
                    acc[key] = (reads, out, (it, 3))
                else:  # a split's partial, merged by the item's last split
                    acc[key] = (reads, {("split", r, hk, j)}, (it, 3))
                    acc[("merge", it, r, hk)] = ({("split", r, hk, q) for q in range(ns)}, out,
                                                 (it, 3.5))
            elif ev[0] == "seg":
                _, kind, it, tile, u0, u1 = ev
                p = ph[kind]
                lo, hi = (u0 % p["nk"]) * p["KB"], min(p["K"], (u1 - tile * p["nk"]) * p["KB"])
                if kind == "qkv" and it % L == 0:
                    reads = set(xres_all)  # the step input's statistics: whole rows
                elif kind in ("qkv", "mlp_up"):  # statistics from the residual's last sums
                    reads = {("xres", c) for c in _chunks(lo, hi)}
                    reads |= stats["dstat" if kind == "qkv" else "ostat"]
                elif kind == "out_proj":
                    reads = {("attn", r, c) for r in rows for c in _chunks(lo, hi)}
                else:
                    reads = {("act", c) for c in _chunks(lo, hi)}
                acc[key] = (reads, {("part", kind, b + tile)}, (it, rank[kind][0]))
    iters = steps * L
    for kind, p in ph.items():
        for it in range(iters):
            for gi in range(p["groups"]):
                m = dl.tile_matrix(p, gi)
                col0 = (gi - p["t0"][m]) * p["tcm"][m]
                cols = (col0, min(col0 + p["tcm"][m], p["N"][m]))
                reads = {("part", kind, slot) for slot in p["order"][gi]}
                if kind == "qkv":
                    off = (0, Qd, Qd + KVd)[m]
                    writes = {("qkv", r, c) for r in rows for c in _chunks(off + cols[0],
                                                                           off + cols[1])}
                elif kind == "mlp_up":
                    writes = {("act", c) for c in _chunks(*cols)}
                else:  # the residual: read, added to, written; and its tile statistics
                    writes = {("xres", c) for c in _chunks(*cols)}
                    reads |= writes
                    writes = writes | {("ostat" if kind == "out_proj" else "dstat", gi)}
                acc[("fin", kind, it, gi)] = (reads, writes, (it, rank[kind][1]))
    return acc


def _graph(plan, spec, B, steps, nb, progs):
    """The happens-before graph: each block's program order, a segment
    before its group's sum, an attention split before its item's merge, a
    sum, whole attention item or merge, logits or token before
    the waits its counter's target covers (the releases of the iteration
    the target names). Returns (nodes in topological order, ancestors as
    bit sets by node index, node index, the releases of each counter by
    iteration). A cycle (a deadlock) fails."""
    L, Hkv = spec.num_layers, spec.num_kv_heads
    ph = plan["phases"]
    releases = defaultdict(list)  # (counter, iteration) -> nodes
    preds = defaultdict(set)
    for b, prog in enumerate(progs):
        for i, ev in enumerate(prog):
            key = ("ev", b, i)
            if i:
                preds[key].add(("ev", b, i - 1))
            if ev[0] == "init":
                releases[(("init",), 0)].append(key)
            elif ev[0] == "logits":
                releases[(("logits",), ev[1])].append(key)
            elif ev[0] == "token":
                releases[(("token",), ev[1])].append(key)
            elif ev[0] == "attn":
                _, it, r, hk, j, ns = ev
                if ns == 1:
                    releases[(("attn", hk), it)].append(key)
                else:
                    preds[("merge", it, r, hk)].add(key)
                    if j == 0:
                        releases[(("attn", hk), it)].append(("merge", it, r, hk))
            elif ev[0] == "seg":
                _, kind, it, tile, _, _ = ev
                preds[("fin", kind, it, dl.segment_group(ph[kind], tile))].add(key)
    for kind, p in ph.items():
        for it in range(steps * L):
            for gi in range(p["groups"]):
                fin = ("fin", kind, it, gi)
                releases[(("done", kind, gi), it)].append(fin)
                releases[(("phase", kind), it)].append(fin)
    # a counter's target: the iteration whose releases it completes
    per_it = {"init": SMS, "logits": SMS, "token": SMS, "attn": B}

    def target_iter(counter, target):
        if counter[0] == "done":
            return target - 1
        if counter[0] == "phase":
            return target // ph[counter[1]]["groups"] - 1
        return target // per_it[counter[0]] - 1

    for b, prog in enumerate(progs):
        for i, ev in enumerate(prog):
            if ev[0] != "wait":
                continue
            for counter, target in ev[1]:
                it = target_iter(counter, target)
                rel = releases[(counter, it)]
                assert rel, f"block {b} waits on {counter} >= {target}: nothing releases it"
                preds[("ev", b, i)].update(rel)
    nodes = set(preds) | {n for ps in preds.values() for n in ps}
    succs = defaultdict(list)
    indeg = {n: 0 for n in nodes}
    for n, ps in preds.items():
        for q in ps:
            succs[q].append(n)
            indeg[n] += 1
    order = [n for n in nodes if indeg[n] == 0]
    for n in order:
        for m in succs[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                order.append(m)
    assert len(order) == len(nodes), "the waits form a cycle: the launch would deadlock"
    index = {n: i for i, n in enumerate(order)}
    anc = [0] * len(order)
    for n in order:
        a = 0
        for q in preds.get(n, ()):
            a |= anc[index[q]] | (1 << index[q])
        anc[index[n]] = a
    return order, anc, index, releases


@MODEL
@FMT
@BATCH
@CASES
def test_waits_cover_every_element_an_item_reads(model, fmt, B, cache):
    """Every access of the launch, in the happens-before graph of its
    program order, segment arrivals and waits: a read has the last write
    before it (in the function's order) among its ancestors, and a write
    has the previous write and every read since among its ancestors, for
    every element of the residual, the q/k/v and attention rows, the
    activations, the partial slots and the blocks' maxima, across the
    layer and the step boundary. So a missing or too-narrow wait fails
    here, not as a rare race on the card. The releases a counter counts
    for one iteration also follow all of the previous iteration's (the
    targets are monotonic)."""
    spec, steps = _case(model, cache)
    plan = dl.stack_plan(spec, FORMATS[fmt])
    progs = [dl.block_program(plan, spec, B, steps, b, slots=_slots(cache, B)) for b in range(SMS)]
    order, anc, index, releases = _graph(plan, spec, B, steps, SMS, progs)
    for (counter, it), rel in releases.items():
        prev = releases.get((counter, it - 1), [])
        for n in rel:
            a = anc[index[n]]
            assert all((a >> index[q]) & 1 for q in prev), \
                f"{counter} iteration {it} may count before iteration {it - 1} is complete"
    by_elem = defaultdict(list)
    for node, (reads, writes, place) in _accesses(plan, spec, B, steps, SMS, progs).items():
        for e in reads:
            by_elem[e].append((place, index[node], e in writes, True))
        for e in writes - reads:
            by_elem[e].append((place, index[node], True, False))
    for e, accs in by_elem.items():
        accs.sort()
        writers = defaultdict(list)  # place -> its writers
        for place, n, w, _ in accs:
            if w:
                writers[place].append(n)
        last_w, reads_since = [], []
        for place, n, w, r in accs:
            here = writers.get(place, [])
            # several writers at one place only for the grid-stride rows of
            # the step input (rank 0): they write disjoint rows of a chunk
            assert len(here) <= 1 or place[1] == 0, f"{e}: two writes at {place}"
            if r:
                for m in last_w:
                    assert (anc[n] >> m) & 1, f"{e}: a read at {place} may miss its write"
            if w:
                for m in last_w + reads_since:
                    if m != n and m not in here:
                        assert (anc[n] >> m) & 1, f"{e}: a write at {place} may overtake an access"
                if not last_w or last_w[0] not in here:
                    last_w, reads_since = [], []
                last_w.append(n)
            elif r:
                reads_since.append(n)


SOURCE = Path(dl.__file__).resolve().parent.parent / "csrc" / "decode_stack.cuh"


def _ring_protocol():
    """The ring's protocol as the kernel's source states it: the producer's
    wait on a slot's empty barrier before it refills it (unit i: the parity
    of ``((i / S) - 1) & 1u``), the consumers' wait on its full barrier
    (unit seq: ``(seq / S) & 1u``, the same in every phase that reads the
    ring), the barriers' arrival counts and the consumers' arrivals a unit.
    Parities as Python functions of (unit, S)."""
    src = SOURCE.read_text()

    def py(expr):  # the C expression of unsigned ints, in Python
        return re.sub(r"(\d+)u\b", r"\1", expr).replace("/", "//")

    empty = re.findall(r"bar_wait_bounded\(&empty\[q\], (.+?)\);", src)
    full = set(re.findall(r"bar_wait_bounded\(&full\[q\], (.+?)\);", src))
    assert len(empty) == 1 and len(full) == 1, (empty, full)
    counts = dict(re.findall(r"bar_init\(&(full|empty)\[q\], (\w+)\);", src))
    arrivals = src.count("if (lane == 0) tma::bar_arrive(&empty[q]);")
    assert arrivals == 2  # gemv_phase and logits_phase: one a consumer warp a unit
    assert counts == {"full": "1", "empty": "kWarps"}
    return dict(empty=eval(f"lambda i, S: {py(empty[0])}"),
                full=eval(f"lambda seq, S: {py(full.pop())}"),
                full_count=1, empty_count=dl.WARPS)


def _run_ring(n, S, proto, seed):
    """One block's ring under a random schedule: the producer (unit i into
    slot i % S after its wait on empty[i % S]; the TMA's bytes land later,
    in any order across slots, completing full's phase) and the eight
    consumer warps (each waits on full[seq % S], reads, then arrives on
    empty[seq % S]). An mbarrier's wait with parity P passes once its
    completed phases' count is odd against P (the PTX test_wait.parity
    rule). Returns the first fault: a slot written while a warp reads it or
    before a warp has read its last unit, a warp reading another unit than
    its own, or no step possible before the end (a deadlock); None if
    none."""
    rnd = random.Random(seed)
    W, need = dl.WARPS, proto["empty_count"]
    full_ph, empty_ph, empty_pend = [0] * S, [0] * S, [0] * S
    slot = [None] * S
    reading = [None] * W  # the unit a warp reads (between its wait and its arrival)
    nxt = [0] * W         # each warp's next unit
    issued, landed, flying = 0, set(), []

    def passes(ph, parity):
        return ph % 2 != parity

    while min(nxt) < n:
        moves = []
        if issued < n and (issued < S or passes(empty_ph[issued % S],
                                                proto["empty"](issued, S))):
            moves.append(("issue", None))
        moves += [("land", i) for i in flying]
        for w in range(W):
            if reading[w] is not None:
                moves.append(("arrive", w))
            elif nxt[w] < n and passes(full_ph[nxt[w] % S], proto["full"](nxt[w], S)):
                moves.append(("read", w))
        if not moves:
            return f"deadlock at unit {min(nxt)}"
        kind, a = rnd.choice(moves)
        if kind == "issue":
            flying.append(issued)
            issued += 1
        elif kind == "land":
            flying.remove(a)
            q = a % S
            if any(r is not None and r % S == q for r in reading):
                return f"unit {a} landed in slot {q} while a warp reads it"
            if any(x <= a - S for x in nxt):
                return f"unit {a} landed in slot {q} before every warp read unit {a - S}"
            slot[q] = a
            full_ph[q] += 1
        elif kind == "read":
            seq = nxt[a]
            if slot[seq % S] != seq:
                return f"warp {a} read slot {seq % S} for unit {seq}, held {slot[seq % S]}"
            reading[a] = seq
        else:
            q = reading[a] % S
            reading[a] = None
            nxt[a] += 1
            empty_pend[q] += 1
            if empty_pend[q] == need:
                empty_pend[q] = 0
                empty_ph[q] += 1
    return None


@MODEL
@FMT
@BATCH
@CASES
def test_no_ring_slot_is_refilled_before_its_last_reader(model, fmt, B, cache):
    """The ring: the kernel's own full/empty parities and arrival counts
    (_ring_protocol) run over blocks' unit streams of the launch under
    random schedules (_run_ring): no slot is written while a warp reads
    it or before every warp has read its last unit, each warp reads its own
    unit, and the ring never deadlocks; the consumers' buffers
    (activations, attention, the epilogue's rows) lie in their own region
    after the ring, never over a slot."""
    spec, steps = _case(model, cache)
    plan = dl.stack_plan(spec, FORMATS[fmt])
    S = plan["slots"]
    assert S >= 2
    ring_lo, ring_hi = plan["ring"]
    reg_lo, reg_hi = plan["region"]
    assert ring_hi - ring_lo == S * dl.SLOT_BYTES and ring_hi <= reg_lo
    assert all(v <= reg_hi - reg_lo for k, v in plan["consumer"].items() if k != "region")
    proto = _ring_protocol()
    for b in (0, SMS // 2, SMS - 1):
        n = len(dl.unit_stream(plan, b, steps, spec.num_layers))
        for seed in range(3):
            assert _run_ring(n, S, proto, seed * 131 + b + B) is None


@pytest.mark.parametrize("wrong", ["empty_same_round", "full_off_by_one", "empty_count_7"])
def test_ring_model_catches_a_wrong_protocol(wrong):
    """The ring's model is not vacuous: a producer that waits on the parity
    of the slot's current round (not the previous), consumers that wait on
    the other parity, or an empty barrier that completes at 7 of the 8
    warps' arrivals each give a fault under some of 20 schedules."""
    proto = _ring_protocol()
    if wrong == "empty_same_round":
        proto["empty"] = lambda i, S: (i // S) & 1
    elif wrong == "full_off_by_one":
        proto["full"] = lambda seq, S: ((seq // S) + 1) & 1
    else:
        proto["empty_count"] = 7
    assert any(_run_ring(64, 4, proto, seed) is not None for seed in range(20))


@MODEL
@pytest.mark.parametrize("epilogue", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_every_instance_fits_the_shared_memory(model, epilogue, D, G):
    """Each template instance (head dim, group) at the model's widths: the
    ring (at least two slots), the consumers' region and the static shared
    memory within 227 KB a block."""
    base = get_spec(model)
    spec = dataclasses.replace(base, head_dim=D, num_kv_heads=max(1, base.num_heads // G),
                               num_heads=max(1, base.num_heads // G) * G)
    plan = dl.stack_plan(spec, None, epilogue=epilogue)
    assert plan["slots"] >= 2
    assert plan["smem"] + dl.STATIC_SMEM <= dl.SMEM_LIMIT
    wide = dataclasses.replace(spec, hidden_size=dl.MAX_HIDDEN)
    assert dl.stack_plan(wide, None, epilogue=epilogue)["slots"] >= 2


# (model, projections left in bf16 by quantize_params(skip=...))
MIXED_CASES = {"gpt2-down-bf16": ("gpt2-tiny", ("w_down",)),
               "llama-wk-wo-bf16": ("llama-tiny", ("wk", "wo"))}


@pytest.mark.parametrize("case", list(MIXED_CASES), ids=list(MIXED_CASES))
def test_decode_layer_stack_mixed_formats_match_jax(case):
    """K4's plain version with a mixed set (int8 weights but those ``skip``
    leaves bf16) against the JAX megakernel (interpret), which reads each
    projection's format from its own scale: x_out within 1e-4, the cache's
    slot within 1e-4. The set takes K4's route and its ``wfmt`` bits mark
    the int8 projections."""
    name, skip = MIXED_CASES[case]
    jspec = JAX_PRESETS[name]
    jparams = jax_quantize_params(jax_init_params(jspec, jax.random.PRNGKey(0),
                                                  dtype=jnp.float32), jspec, "int8", skip=skip)
    spec = ModelSpec(**dataclasses.asdict(jspec))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    assert dl.supports_decode_stack(spec, blocks=params["blocks"], B=3, on_card=False)
    assert dl.weight_format(params["blocks"]) == sum(
        1 << i for i, n in enumerate(dl.PROJECTIONS)
        if n not in skip and params["blocks"].get(n) is not None)
    rng = np.random.default_rng(31)
    B, Smax, pos = 3, 64, 29
    L, Hkv, D = spec.num_layers, spec.num_kv_heads, spec.head_size
    x = rng.standard_normal((B, spec.hidden_size)).astype(np.float32)
    kc, vc = (rng.standard_normal((L, B, Smax, Hkv, D)).astype(np.float32) for _ in range(2))
    jc = js = tc = ts = None
    if spec.positional != "learned":
        jc, js = jax_rope_cos_sin(pos + jnp.arange(1), spec.rope_dim, spec.rope_theta,
                                  jnp.float32)
        tc, ts = rope_cos_sin(torch.arange(pos, pos + 1), spec.rope_dim, spec.rope_theta)
    flat = (lambda a: jnp.asarray(a.reshape(L, B, Smax, -1)))
    out = jax_decode_layer_stack(jnp.asarray(x), jparams["blocks"], flat(kc), flat(vc), pos, jc,
                                 js, spec=jspec, interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, _ = dl.decode_layer_stack(torch.from_numpy(x), params["blocks"], tk, tv, pos, tc, ts,
                                   spec=spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(out[0]), atol=1e-4, rtol=1e-4)
    for t, jt in ((tk, out[1]), (tv, out[2])):
        np.testing.assert_allclose(t.numpy()[:, :, pos], np.asarray(jt).reshape(t.shape)[:, :, pos],
                                   atol=1e-4, rtol=1e-4)


def test_a_gated_pair_in_two_formats_takes_another_route():
    """A gated MLP whose w_up and w_gate differ in format is the one mix K4
    and K8 refuse (their up phase sums the pair over shared column tiles):
    supports_decode_stack says no, so decode_route's "auto" does not pick
    K4, and the wrapper raises; the mirror refuses to plan it. The same
    model with both in int8 (w_down left bf16) is taken."""
    from mlio_tpu_torch.models import Impl, init_params
    from mlio_tpu_torch.models.transformer import decode_route

    spec = get_spec("llama-tiny")
    params = init_params(spec, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")
    split = quantize_params(params, spec, "int8", skip=("w_gate",))["blocks"]
    assert not dl.supports_decode_stack(spec, blocks=split, B=2, on_card=False)
    assert decode_route(spec, Impl(attention="flash"), split, 2, smax=128,
                        on_card=False) != "mega"
    x = torch.zeros((2, spec.hidden_size))
    kc = torch.zeros((spec.num_layers, 2, 16, spec.num_kv_heads, spec.head_size))
    with pytest.raises(ValueError, match="w_up and w_gate in one format"):
        dl.decode_layer_stack(x, split, kc, kc.clone(), 3, *rope_cos_sin(
            torch.arange(3, 4), spec.rope_dim, spec.rope_theta), spec=spec)
    with pytest.raises(ValueError, match="one format"):
        dl.stack_plan(spec, {"w_up": "int8"})
    ok = quantize_params(params, spec, "int8", skip=("w_down",))["blocks"]
    assert dl.supports_decode_stack(spec, blocks=ok, B=2, on_card=False)
    assert decode_route(spec, Impl(attention="flash"), ok, 2, smax=128, on_card=False) == "mega"


@MODEL
@FMT
def test_waits_map_to_the_cards_counter_ranges(model, fmt):
    """The mirror's counters sit where make_plan lays them out (distinct,
    within the sync buffer), and each out or down segment waits on one
    contiguous range of them and each attention item on its q, k and v
    tile ranges: the form in which the card exports its segment_wait and
    attention_wait, which chip_smoke.py holds against program_waits."""
    spec = dataclasses.replace(get_spec(model), num_layers=2)
    plan = dl.stack_plan(spec, FORMATS[fmt])
    c = plan["counters"]
    named = [("init",), ("logits",), ("token",)] + [("attn", h) for h in range(spec.num_kv_heads)]
    named += [("phase", k) for k in dl.STACK_PHASES]
    named += [("done", k, g) for k in dl.STACK_PHASES for g in range(plan["phases"][k]["groups"])]
    offs = [dl.counter_offset(plan, n) for n in named]
    assert len(set(offs)) == len(offs) and max(offs) < c["total"]
    pq = plan["phases"]["qkv"]
    for b in (0, 1, SMS // 2, SMS - 1):
        for key, got in dl.program_waits(plan, spec, 8, b).items():
            if key[0] == "seg":
                assert got == list(range(got[0], got[-1] + 1)), key
            else:
                runs = [g for i, g in enumerate(got) if i == 0 or got[i - 1] + 1 != g]
                assert 1 <= len(runs) <= 3 and got[0] >= pq["done"], key
