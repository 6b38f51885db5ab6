"""The port's native (C++) scheduler against its Python scheduler and the JAX
package's Python scheduler.

The three share one policy (incremental allocation, preempt-youngest by
recompute, chained-hash prefix caching, multi-step planning), so any state
that differs on the same workload is a fault in one of them. The port's two
also share ``plan_multi_step``'s shortage signal (-1 where even one step is
not covered), where the JAX package's returns 1.
"""
import numpy as np
import pytest
import torch

from mlio_tpu.runtime.scheduler import PyScheduler as JaxPyScheduler
from mlio_tpu.runtime.scheduler import chain_hash as jax_chain_hash
from mlio_tpu_torch import native
from mlio_tpu_torch.models import get_spec, init_params
from mlio_tpu_torch.runtime import InferenceEngine, greedy_generate
from mlio_tpu_torch.runtime import engine as engine_mod
from mlio_tpu_torch.runtime.scheduler import PyScheduler, chain_hash, make_scheduler

pytestmark = pytest.mark.skipif(native.compiler() is None, reason="no C++ compiler on PATH")


def _tok(rid: int, n: int) -> int:
    return int((rid * 131 + n * 17) % 1000 + 2)


def _three(**kw):
    return native.NativeScheduler(**kw), PyScheduler(**kw), JaxPyScheduler(**kw)


def _same_state(scheds):
    a = scheds[0]
    for b in scheds[1:]:
        np.testing.assert_array_equal(a.tables, b.tables)
        np.testing.assert_array_equal(a.ctx, b.ctx)
        np.testing.assert_array_equal(a.cur, b.cur)
        assert a.num_free_blocks == b.num_free_blocks
        assert (a.num_active, a.num_queued) == (b.num_active, b.num_queued)


def _drive(scheds, reqs, max_steps=5000):
    """Run the schedulers on the same inputs, asserting the same state after
    every phase. Returns (finished outputs by id, steps)."""
    a = scheds[0]
    for prompt, max_new, eos in reqs:
        assert len({s.submit(prompt, max_new, eos) for s in scheds}) == 1
    fin, steps = {}, 0
    while any(s.num_active or s.num_queued for s in scheds):
        steps += 1
        assert steps < max_steps, "scheduler livelock"
        adm = [s.admit() for s in scheds]
        assert all(x == adm[0] for x in adm)
        for slot, prompt, _nc in adm[0]:
            rid = a.slot_req_id(slot)
            assert all(s.slot_req_id(slot) == rid for s in scheds)
            for s in scheds:
                s.commit_prefill(slot, _tok(rid, len(prompt)))
        _same_state(scheds)
        if a.num_active:
            toks = np.zeros(a.max_batch, np.int32)
            for slot in range(a.max_batch):
                rid = a.slot_req_id(slot)
                if rid >= 0:
                    toks[slot] = _tok(rid, int(a.ctx[slot]))
            assert len({s.commit_tokens(toks) for s in scheds}) == 1
        _same_state(scheds)
        while True:
            out = [s.pop_finished() for s in scheds]
            assert all(o == out[0] for o in out)
            if out[0] is None:
                break
            fin[out[0][0]] = out[0][1]
    assert all(s.stats() == a.stats() for s in scheds)
    return fin, steps


def test_scheduler_parity_mixed_workload(rng):
    scheds = _three(max_batch=4, num_blocks=64, block_size=4, max_blocks_per_seq=16,
                    prefix_caching=True)
    shared = rng.integers(2, 50, size=12).tolist()
    reqs = []
    for i in range(14):
        if i % 3 == 0:  # shares a 12-token prefix: prefix-cache hits
            prompt = shared + rng.integers(2, 50, size=int(rng.integers(1, 9))).tolist()
        else:
            prompt = rng.integers(2, 50, size=int(rng.integers(1, 20))).tolist()
        reqs.append((prompt, int(rng.integers(1, 30)), 7 if i % 4 == 1 else None))
    fin, _ = _drive(scheds, reqs)
    assert len(fin) == len(reqs)
    assert scheds[0].stats()["prefix_hit_blocks"] > 0


def test_scheduler_parity_under_preemption():
    scheds = _three(max_batch=4, num_blocks=30, block_size=2, max_blocks_per_seq=24,
                    prefix_caching=False)
    fin, _ = _drive(scheds, [(list(range(2, 5 + i)), 20, None) for i in range(6)])
    assert len(fin) == 6
    # despite preemption (recompute), every request gets its full budget
    assert all(len(v) == 20 for v in fin.values())
    assert scheds[0].stats()["preempted"] > 0


@pytest.mark.parametrize("cls", ["native", "python"])
def test_admission_control_rejects_infeasible(cls):
    kw = dict(max_batch=2, num_blocks=8, block_size=2, max_blocks_per_seq=32,
              prefix_caching=False)
    s = native.NativeScheduler(**kw) if cls == "native" else PyScheduler(**kw)
    # worst case ceil((4+20)/2) = 12 blocks > 7 usable: rejected
    with pytest.raises(ValueError):
        s.submit([1, 2, 3, 4], 20)
    # exactly fits: ceil((4+10)/2) = 7 == num_blocks - 1
    s.submit([1, 2, 3, 4], 10)


def test_native_block_manager_refcounts():
    m = native.NativeBlockManager(num_blocks=8, block_size=4)
    assert m.num_free == 7  # block 0 pinned as scratch
    b1 = m.allocate()
    assert b1 != 0 and m.refcount(b1) == 1
    assert m.fork(b1) == b1 and m.refcount(b1) == 2
    m.free(b1)
    assert m.refcount(b1) == 1 and m.num_free == 6
    m.free(b1)
    assert m.num_free == 7
    with pytest.raises(ValueError):
        m.free(b1)  # double free
    blocks = [m.allocate() for _ in range(7)]
    assert len(set(blocks)) == 7
    with pytest.raises(MemoryError):
        m.allocate()


def test_prefix_cache_reuses_blocks_and_survives_finish():
    scheds = _three(max_batch=2, num_blocks=32, block_size=4, max_blocks_per_seq=8,
                    prefix_caching=True)
    prefix = list(range(10, 22))  # 3 full blocks
    fin, _ = _drive(scheds, [(prefix + [77], 4, None)])
    assert len(fin) == 1
    # the same prefix again hits all 3 full blocks, published by the first
    fin2, _ = _drive(scheds, [(prefix + [88, 89], 4, None)])
    assert len(fin2) == 1
    assert all(s.stats()["prefix_hit_blocks"] == 3 for s in scheds)


def test_chain_hash_matches_jax_and_native():
    """The Python chain hash equals the JAX package's; the C++ one must equal
    it too or prefix reuse diverges, which the prefix-hit parity above
    shows through the native scheduler's hits."""
    rng = np.random.default_rng(3)
    h = jh = 0
    for _ in range(6):
        toks = rng.integers(0, 1 << 31, size=16).tolist()
        h, jh = chain_hash(h, toks), jax_chain_hash(jh, toks)
        assert h == jh and h != 0
    h1 = chain_hash(0, [1, 2, 3, 4])
    h2 = chain_hash(h1, [5, 6, 7, 8])
    assert h1 not in (0, h2)
    # position sensitivity: the same tokens at another depth differ
    assert chain_hash(0, [5, 6, 7, 8]) != h2


@pytest.mark.parametrize("reserve,want", [(0, [8, 8, 8]), (3, [-1, -1, 1])])
def test_plan_multi_step_shortage_signal(reserve, want):
    """Where even a one-step chunk's blocks cannot all be allocated, both of
    the port's schedulers return -1 with the same allocations as the JAX
    package's scheduler, which returns 1 (and whose pipelined loop then
    dispatches past the pool)."""
    scheds = _three(max_batch=2, num_blocks=5, block_size=8, max_blocks_per_seq=4,
                    prefix_caching=False)
    for s in scheds:
        s.submit([5, 9, 2, 7, 1, 3], 16)
        s.submit([11, 3, 6, 1, 8, 4], 16)
        for slot, _prompt, _nc in s.admit():
            s.commit_prefill(slot, 1)
    # a block each is held, two of the four usable are free
    assert [s.plan_multi_step(8, reserve=reserve) for s in scheds] == want
    _same_state(scheds)
    assert all(s.num_free_blocks == 0 for s in scheds)
    # one step past 16 positions in flight: short in every case
    assert [s.plan_multi_step(8, reserve=16) for s in scheds] == [-1, -1, 1]
    _same_state(scheds)


def test_make_scheduler_backends():
    assert make_scheduler(2, 16, 4, 8, backend="python").name == "python"
    assert make_scheduler(2, 16, 4, 8, backend="native").name == "native"
    assert make_scheduler(2, 16, 4, 8, backend="auto").name == "native"


def test_failed_build_raises_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match=r"failed to build broken\.cc(.|\n)*error"):
        native.build()
    assert not list((tmp_path / "out").iterdir())  # no half-written library left
    # a library that does not load: make_scheduler("native") raises, "auto"
    # falls back to the Python scheduler
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "native scheduler: g++ failed (a test)")
    with pytest.raises(RuntimeError, match="a test"):
        make_scheduler(2, 16, 4, 8, backend="native")
    assert make_scheduler(2, 16, 4, 8, backend="auto").name == "python"


def test_engine_backend_equivalence_and_shortage_path(monkeypatch):
    """Greedy outputs and stats are the same through both schedulers and both
    loops, equal to dense greedy generate; at the pool-exhaustion geometry
    the pipelined loop takes its synchronous step on the shortage signal."""
    spec = get_spec("gpt2-tiny")
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[5, 9, 2, 7, 1, 3], [11, 3, 6, 1, 8, 4]]
    geometry = dict(max_batch=2, num_blocks=5, block_size=8, max_seq_len=32,
                    decode_stack="perop", dtype=torch.float32, device="cpu")
    calls = [0]
    real = InferenceEngine._decode_sync

    def counted(self):
        calls[0] += 1
        return real(self)

    monkeypatch.setattr(InferenceEngine, "_decode_sync", counted)
    outs, stats = {}, {}
    for backend in ("python", "native"):
        for pipeline in (False, True):
            eng = InferenceEngine(spec, params, scheduler=backend, **geometry)
            calls[0] = 0
            outs[backend, pipeline] = eng.run(prompts, max_new_tokens=16, pipeline=pipeline)
            stats[backend, pipeline] = eng.memory_stats()
            assert stats[backend, pipeline]["scheduler"] == backend
            assert stats[backend, pipeline]["preempted"] > 0
            if pipeline:
                assert calls[0] > 0  # the shortage signal's synchronous step
    assert len({str(v) for v in outs.values()}) == 1
    for pipeline in (False, True):
        py, nat = (dict(stats[b, pipeline], scheduler=None) for b in ("python", "native"))
        assert py == nat
    for p, out in zip(prompts, outs["native", True]):
        dense = greedy_generate(params, spec, torch.tensor([p]), max_new_tokens=16, device="cpu")
        assert out == dense[0, len(p):].tolist()
    assert engine_mod._Fetch(torch.arange(3)).get().tolist() == [0, 1, 2]
