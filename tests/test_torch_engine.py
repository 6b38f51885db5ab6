"""The port's continuous-batching engine against the JAX package's on the CPU.

Both engines get the same weights (the JAX package's ``init_params`` through
``from_jax_params``) and the same prompts, in fp32. The JAX engine runs its
synchronous loop (``pipeline=False``) with its per-op decode, whose paged
attention runs in interpret mode as the JAX tests run it; the JAX package's
own tests hold its megakernel decode equal to that. The port runs both of
its decode backends, "mega" (K8's plain version) and "perop" (K7's), through
its sync loop and its pipelined loop with either scheduler, and must give
the same greedy token ids in every geometry. At ``pool_exhausted`` the JAX
package's pipelined loop dispatches past the exhausted pool and its ids go
wrong; the port's do not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.runtime.engine import InferenceEngine as JaxEngine
from mlio_tpu_torch import native
from mlio_tpu_torch.models import from_jax_params, get_spec, init_params
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.runtime import InferenceEngine, SamplingMethod, greedy_generate
from mlio_tpu_torch.runtime.scheduler import make_scheduler

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [2]]
P1 = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]
GEOMETRY = dict(max_batch=4, max_seq_len=64, block_size=16)
# name: (engine keywords over GEOMETRY, prompts, max_new_tokens, EOS from the
# "steps8" ids, the models)
BOTH, GPT2 = ("gpt2-tiny", "llama-tiny"), ("gpt2-tiny",)
CASES = {
    "steps1": (dict(steps_per_dispatch=1), PROMPTS, 8, False, BOTH),
    "steps8": (dict(steps_per_dispatch=8), PROMPTS, 11, False, BOTH),
    "eos": (dict(), PROMPTS, 11, True, BOTH),
    "waves": (dict(), [[i + 1, i + 2, i + 3] for i in range(10)], 6, False, GPT2),
    # one slot: the second prompt is admitted after the first has finished
    # and published its full prompt block
    "prefix_hit": (dict(max_batch=1), [P1, P1[:16] + [8, 4]], 4, False, GPT2),
    # the geometry at which the JAX package's pipelined loop goes wrong (the
    # pool runs out: two slots, five blocks of 8, 6-token prompts, 16 new
    # tokens); the sync loops of both packages preempt and recompute
    "pool_exhausted": (dict(max_batch=2, num_blocks=5, block_size=8),
                       [[5, 9, 2, 7, 1, 3], [11, 3, 6, 1, 8, 4]], 16, False, BOTH),
}
BACKENDS = ["mega", "perop"]
_reference = {}


_models = {}


def _model(name):
    """(JAX spec, JAX params, port spec, port params) with the same weights."""
    if name not in _models:
        jspec = JAX_PRESETS[name]
        jparams = jax_init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.float32)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        _models[name] = jspec, jparams, ModelSpec(**dataclasses.asdict(jspec)), params
    return _models[name]


def _eos(model):
    return _jax_run(model, "steps8")[0][0][2]


def _jax_run(model, case, pipeline=False):
    """The JAX engine's ids for a case (cached), its scheduler stats and its
    free blocks after the run: its sync loop, or its pipelined loop with
    its Python scheduler."""
    key = (model[0].name, case, pipeline)
    if key not in _reference:
        kw, prompts, max_new, eos, _ = CASES[case]
        eng = JaxEngine(model[0], model[1], dtype=jnp.float32, decode_stack="perop",
                        **{**GEOMETRY, **kw, **({"scheduler": "python"} if pipeline else {})})
        out = eng.run(prompts, max_new_tokens=max_new,
                      eos_token=_eos(model) if eos else None, pipeline=pipeline)
        _reference[key] = (out, {**eng.memory_stats(), "num_free": eng.manager.num_free})
    return _reference[key]


def _port(model, case, backend, pipeline=False, **extra):
    kw, prompts, max_new, eos, _ = CASES[case]
    eng = InferenceEngine(model[2], model[3], dtype=torch.float32, decode_stack=backend,
                          device="cpu", **{**GEOMETRY, **kw, **extra})
    assert eng.decode_stack == backend and not eng.kv_combined
    out = eng.run(prompts, max_new_tokens=max_new, eos_token=_eos(model) if eos else None,
                  pipeline=pipeline)
    return out, eng


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,case", [(n, c) for c in CASES for n in CASES[c][4]])
def test_engine_greedy_ids_match_jax(name, case, backend):
    model = _model(name)
    want, jstats = _jax_run(model, case)
    got, eng = _port(model, case, backend)
    assert got == want
    stats = eng.memory_stats()
    for key in ("preempted", "prefills", "generated_tokens", "prefix_hit_blocks"):
        assert stats[key] == jstats[key], key
    assert eng.manager.num_free == jstats["num_free"]  # blocks back, or held by the prefix cache
    if case == "eos":
        assert any(len(o) < CASES[case][2] for o in got)
    if case == "prefix_hit":
        assert stats["prefix_hit_blocks"] > 0
    if case == "pool_exhausted":
        assert stats["preempted"] > 0


SCHEDULERS = ["python", "native"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,case", [(n, c) for c in CASES for n in CASES[c][4]])
def test_pipelined_loop_matches_sync_and_jax(name, case, backend, scheduler):
    """The pipelined loop gives the port's sync ids and the JAX sync loop's,
    with either scheduler; at pool_exhausted the JAX pipelined loop does
    not (it dispatches a chunk whose blocks were never allocated)."""
    if scheduler == "native" and not native.available():
        pytest.skip("no C++ compiler builds the native scheduler here")
    model = _model(name)
    want, jstats = _jax_run(model, case)
    got, eng = _port(model, case, backend, pipeline=True, scheduler=scheduler)
    assert got == want
    assert _port(model, case, backend, scheduler=scheduler)[0] == want
    stats = eng.memory_stats()
    assert stats["scheduler"] == scheduler
    assert stats["generated_tokens"] == jstats["generated_tokens"]
    assert eng.num_active == 0 and eng.sched.num_queued == 0
    if case == "pool_exhausted":
        assert stats["preempted"] > 0
        jax_pipelined = _jax_run(model, case, pipeline=True)[0]
        assert jax_pipelined != want


def test_sampling_same_through_both_backends():
    """Sampling draws from the engine's generator once per sampled step, so
    one seed gives the same tokens through K8's logits and the per-op head."""
    spec = get_spec("llama-tiny")
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    method = SamplingMethod(temperature=1.0, top_k=8)
    outs = []
    for backend in BACKENDS:
        eng = InferenceEngine(spec, params, dtype=torch.float32, method=method,
                              generator=torch.Generator().manual_seed(7), decode_stack=backend,
                              steps_per_dispatch=4, device="cpu", **GEOMETRY)
        outs.append(eng.run(PROMPTS, max_new_tokens=9))
    assert outs[0] == outs[1]
    greedy = InferenceEngine(spec, params, dtype=torch.float32, device="cpu", **GEOMETRY)
    assert greedy.run(PROMPTS, max_new_tokens=9) != outs[0]


def test_lifecycle():
    spec = get_spec("gpt2-tiny")
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    eng = InferenceEngine(spec, params, max_batch=2, max_seq_len=32, dtype=torch.float32,
                          device="cpu")
    free0 = eng.manager.num_free
    eng.run([[1, 2, 3]], max_new_tokens=4)
    assert eng.manager.num_free == free0 and eng.num_active == 0
    stats = eng.memory_stats()
    assert stats["generated_tokens"] == 4
    # "auto" takes the native scheduler where it builds
    assert stats["scheduler"] == ("native" if native.available() else "python")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(list(range(30)), max_new_tokens=8)
    with pytest.raises(ValueError, match="unknown scheduler backend"):
        make_scheduler(2, 8, 16, 2, backend="cuda")
    with pytest.raises(ValueError, match="pipeline must be"):
        eng.run([[1, 2]], pipeline="sometimes")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(spec, params)


def test_parallel_residual_takes_perop():
    """K8 refuses a parallel-residual model: "auto" takes the per-op decode,
    which matches the port's dense greedy generate; "mega" raises."""
    spec = get_spec("neox-tiny")
    params = init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    eng = InferenceEngine(spec, params, dtype=torch.float32, device="cpu", **GEOMETRY)
    assert eng.decode_stack == "perop"
    outs = eng.run(PROMPTS[:2], max_new_tokens=5)
    for p, out in zip(PROMPTS[:2], outs):
        dense = greedy_generate(params, spec, torch.tensor([p]), max_new_tokens=5, device="cpu")
        assert out == dense[0, len(p):].tolist()
    with pytest.raises(ValueError, match="K8 does not run"):
        InferenceEngine(spec, params, decode_stack="mega", device="cpu")


def test_paged_kv_cache_accounting_matches_jax():
    """PagedKVCache's host accounting (allocate, append across a block edge,
    fork, free), its tables, memory stats and calculate_num_blocks."""
    from mlio_tpu.runtime.kv_cache import PagedKVCache as JaxPagedKVCache
    from mlio_tpu.runtime.kv_cache import calculate_num_blocks as jax_calculate_num_blocks
    from mlio_tpu_torch.runtime.kv_cache import PagedKVCache, calculate_num_blocks

    jspec = JAX_PRESETS["gpt2-tiny"]
    spec = ModelSpec(**dataclasses.asdict(jspec))
    jcache = JaxPagedKVCache(jspec, 12, block_size=4, max_seq_len=32, dtype=jnp.float32)
    cache = PagedKVCache(spec, 12, block_size=4, max_seq_len=32, dtype=torch.float32,
                         device="cpu")
    assert tuple(cache.k_pool.shape) == jcache.k_pool.shape
    for c in (jcache, cache):
        c.allocate_sequence(0, 7)
        c.allocate_sequence(1, 4)
        c.append_token(1)  # crosses a block edge
        c.fork_sequence(0, 2)
        c.free_sequence(0)
    np.testing.assert_array_equal(cache.block_table_array([1, 2]).numpy(),
                                  np.asarray(jcache.block_table_array([1, 2])))
    np.testing.assert_array_equal(cache.context_lens_array([1, 2]).numpy(),
                                  np.asarray(jcache.context_lens_array([1, 2])))
    assert cache.memory_stats() == jcache.memory_stats()
    assert calculate_num_blocks(get_spec("gpt2"), 8 << 30, 128) == \
        jax_calculate_num_blocks(JAX_PRESETS["gpt2"], 8 << 30, 128)
