"""The port's speculative decoding against the JAX package's on the CPU.

The same numpy inputs and the same weights (the JAX package's
``init_params`` through ``from_jax_params``) go through both packages in
fp32: ``probabilities``, the n-gram drafter, the acceptance rule (with the
JAX package's own uniforms), the gamma controller, and
``speculative_generate`` in every drafting mode, whose ids must equal the
JAX package's and the port's ``greedy_generate``. The JAX package's
draft-model path leaves a hole in the draft cache (its last draft's K/V are
never written, yet the cache is rewound past them when every draft was
accepted): self-speculation there takes more rounds than the
ceil((T - 1) / (gamma + 1)) the port takes. The JAX calls are few and
cached: each static-argument set compiles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu.models import forward as jax_forward
from mlio_tpu.models import init_params as jax_init_params
from mlio_tpu.models import synthetic as jax_synthetic
from mlio_tpu.runtime import greedy_generate as jax_greedy_generate
from mlio_tpu.runtime import sampling as jax_sampling
from mlio_tpu.runtime import speculative as jax_spec
from mlio_tpu_torch.models import (
    forward,
    from_jax_params,
    induction_spec,
    make_induction_model,
    periodic_prompt,
)
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.runtime import (
    SamplingMethod,
    greedy_generate,
    probabilities,
    speculative_generate,
)
from mlio_tpu_torch.runtime import speculative as spec_mod
from mlio_tpu_torch.runtime.speculative import (
    AutoGamma,
    optimal_gamma,
    speculative_generate_auto,
)

MODELS = ("gpt2-tiny", "llama-tiny")
B, S, NEW = 2, 12, 15
_cache = {}


def _cached(key, make):
    if key not in _cache:
        _cache[key] = make()
    return _cache[key]


def _model(name, layers=None, seed=0):
    """(JAX spec, JAX params, port spec, port params), the same weights; with
    ``layers`` a shallower draft model of the same vocabulary."""
    def make():
        jspec = JAX_PRESETS[name]
        if layers is not None:
            jspec = dataclasses.replace(jspec, num_layers=layers, name=f"{name}-draft")
        jparams = jax_init_params(jspec, jax.random.PRNGKey(seed), dtype=jnp.float32)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        return jspec, jparams, ModelSpec(**dataclasses.asdict(jspec)), params
    return _cached(("model", name, layers, seed), make)


def _ids(name):
    vocab = JAX_PRESETS[name].vocab_size
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(np.int32)


def _jax_greedy(name):
    jspec, jparams, _, _ = _model(name)
    return _cached(("greedy", name), lambda: np.asarray(
        jax_greedy_generate(jparams, jspec, jnp.asarray(_ids(name)), max_new_tokens=NEW)))


def _jax_spec(name, mode):
    """The JAX package's ids and stats for a drafting mode (cached)."""
    def make():
        jspec, jparams, _, _ = _model(name)
        kw = _jax_kwargs(name, mode)
        out, st = jax_spec.speculative_generate(jparams, jspec, jnp.asarray(_ids(name)),
                                                max_new_tokens=NEW, return_stats=True, **kw)
        return np.asarray(out), st
    return _cached(("spec", name, mode), make)


def _jax_kwargs(name, mode):
    kind, arg = mode
    if kind == "ngram":
        return dict(gamma=arg)
    if kind == "draft":
        d = _model(name, layers=1, seed=7)
        return dict(gamma=4, draft_params=d[1], draft_spec=d[0])
    oracle = _jax_greedy(name)[:, S:]
    return dict(gamma=4, draft_tokens=jnp.asarray(oracle), draft_accept=arg)


def _port_kwargs(name, mode):
    kind, arg = mode
    if kind == "ngram":
        return dict(gamma=arg)
    if kind == "draft":
        d = _model(name, layers=1, seed=7)
        return dict(gamma=4, draft_params=d[3], draft_spec=d[2])
    oracle = torch.from_numpy(_jax_greedy(name)[:, S:].astype(np.int64))
    return dict(gamma=4, draft_tokens=oracle, draft_accept=arg,
                generator=torch.Generator().manual_seed(5))


METHODS = {"greedy": (0.0, None, None), "temperature": (0.7, None, None),
           "top_k": (0.9, 5, None), "top_p": (1.1, None, 0.8)}


@pytest.mark.parametrize("method", list(METHODS))
def test_probabilities_match_jax(method):
    t, k, p = METHODS[method]
    logits = np.random.default_rng(0).normal(size=(3, 17)).astype(np.float32)
    want = jax_sampling.probabilities(jnp.asarray(logits),
                                      jax_sampling.SamplingMethod(t, k, p))
    got = probabilities(torch.from_numpy(logits), SamplingMethod(t, k, p))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _ngram_buf(case):
    """(buffer [B, L], buf_len, window): planted repeats, no match, a match
    on the window's edge (and one just past it), proposals clamped at the
    buffer's end."""
    rng = np.random.default_rng(4)
    buf = rng.integers(100, 200, (3, 40)).astype(np.int32)
    if case == "planted":
        buf[0, 5:7] = buf[0, 28:30] = [7, 8]      # matched twice: the later one wins
        buf[0, 17:19] = [7, 8]
        buf[1, 0:2] = buf[1, 28:30] = [3, 4]      # at the buffer's start
        return buf, 30, 64
    if case == "none":
        return buf, 30, 64
    if case == "window_edge":
        buf[:, 28:30] = [[7, 8], [7, 8], [7, 8]]
        buf[0, 18:20] = [7, 8]  # ends at last - window: inside
        buf[1, 17:19] = [7, 8]  # ends one before it: outside
        return buf, 30, 10
    buf[:, 38:40] = [[7, 8]] * 3  # "clamped": a match near the end
    buf[:, 35:37] = [[7, 8]] * 3
    return buf, 40, 64


@pytest.mark.parametrize("case", ["planted", "none", "window_edge", "clamped"])
def test_draft_ngram_matches_jax(case):
    buf, n, window = _ngram_buf(case)
    jt, jq = jax_spec._draft_ngram(jnp.asarray(buf), n, 6, 256, window=window)
    t, q = spec_mod._draft_ngram(torch.from_numpy(buf).long(), n, 6, 256, window=window)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    if case == "none":
        assert (t.numpy() == buf[:, n - 1:n]).all()


def _accept_inputs(seed=0, Bn=4, g=5, V=8):
    rng = np.random.default_rng(seed)
    draft = rng.integers(0, V, (Bn, g)).astype(np.int32)
    q = rng.dirichlet(np.ones(V), (Bn, g)).astype(np.float32)
    p = rng.dirichlet(np.ones(V) * 0.5, (Bn, g + 1)).astype(np.float32)
    return draft, q, p


def test_accept_greedy_matches_jax():
    draft, _, p = _accept_inputs()
    logits = np.log(p)
    # plant argmax agreements so that prefixes of every length occur
    draft[0] = logits[0, :5].argmax(-1)
    draft[1, :2] = logits[1, :2].argmax(-1)
    pj = jax_sampling.probabilities(jnp.asarray(logits.reshape(-1, 8)),
                                    jax_sampling.SamplingMethod()).reshape(p.shape)
    q1 = np.eye(8, dtype=np.float32)[draft]
    jt, jn = jax_spec._accept(jnp.asarray(draft), jnp.asarray(q1), pj, jax.random.PRNGKey(0),
                              True)
    t, n = spec_mod._accept(torch.from_numpy(draft).long(), torch.from_numpy(q1),
                            torch.from_numpy(np.array(pj)), None, True)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert set(n.tolist()) >= {5, 2}


def test_accept_stochastic_prefixes_match_jax():
    """The JAX package's own uniforms, handed to the port, give its accepted
    prefix lengths."""
    draft, q, p = _accept_inputs(seed=1, Bn=64)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, draft.shape))
    _, jn = jax_spec._accept(jnp.asarray(draft), jnp.asarray(q), jnp.asarray(p), key, False)
    _, n = spec_mod._accept(torch.from_numpy(draft).long(), torch.from_numpy(q),
                            torch.from_numpy(p), torch.Generator().manual_seed(0), False,
                            u=torch.from_numpy(u))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert len(set(n.tolist())) > 2


def test_accept_residual_distribution_matches_jax():
    """Rows whose cut is certain (p(x) = 0 at the first draft, at the third,
    or p >= q at every draft): the port's residual distribution against the
    frequencies of the JAX package's cut tokens, and of the port's own
    draws, over 3000 copies of each row."""
    rng = np.random.default_rng(2)
    V, g, reps = 8, 3, 3000
    q = rng.dirichlet(np.ones(V), (3, g)).astype(np.float32)
    p = rng.dirichlet(np.ones(V), (3, g + 1)).astype(np.float32)
    draft = np.array([[1, 2, 3], [4, 5, 6], [0, 1, 2]], np.int32)
    p[0, 0, 1] = 0.0                       # row 0: rejected at 0
    p[1, :2] = q[1, :2]                    # row 1: accepted at 0 and 1, rejected at 2
    p[1, 2, 6] = 0.0
    p[2, :g] = q[2]                        # row 2: accepted throughout, the bonus
    p /= p.sum(-1, keepdims=True)
    want_n = np.array([0, 2, 3])
    dist = spec_mod._residual(torch.from_numpy(q), torch.from_numpy(p),
                              torch.from_numpy(want_n)).numpy()
    np.testing.assert_allclose(dist.sum(-1), 1.0, rtol=1e-5)
    assert dist[2] == pytest.approx(p[2, 3], rel=1e-5)

    tile = lambda a: np.repeat(a, reps, axis=0)  # noqa: E731
    jt, jn = jax_spec._accept(jnp.asarray(tile(draft)), jnp.asarray(tile(q)),
                              jnp.asarray(tile(p)), jax.random.PRNGKey(9), False)
    t, n = spec_mod._accept(torch.from_numpy(tile(draft)).long(), torch.from_numpy(tile(q)),
                            torch.from_numpy(tile(p)), torch.Generator().manual_seed(9), False)
    assert (np.asarray(jn) == tile(want_n)).all() and (n.numpy() == tile(want_n)).all()
    for toks in (np.asarray(jt), t.numpy()):
        cut = toks[np.arange(3 * reps), tile(want_n)].reshape(3, reps)
        freq = np.stack([np.bincount(c, minlength=V) / reps for c in cut])
        np.testing.assert_allclose(freq, dist, atol=0.04)


def test_optimal_gamma_and_controller_match_jax():
    for r in (0.0, 0.3, 0.5, 0.7, 0.9, 0.99):
        for cost in (0.0, 0.35):
            assert optimal_gamma(r, draft_cost_ratio=cost) == \
                jax_spec.optimal_gamma(r, draft_cost_ratio=cost)
    ours, theirs = AutoGamma(prior_rate=0.2), jax_spec.AutoGamma(prior_rate=0.2)
    for tokens, rounds in ((12, 10), (30, 10), (25, 8), (40, 9), (16, 16)):
        assert ours.gamma() == theirs.gamma()
        g = ours.gamma()
        ours.update(tokens, rounds, g)
        theirs.update(tokens, rounds, g)
        assert ours.rate == pytest.approx(theirs.rate, abs=1e-12)


MODES = [("ngram", 1), ("ngram", 3), ("ngram", 5), ("draft", 4), ("stream", 1.0),
         ("stream", 0.5)]


@pytest.mark.parametrize("mode", MODES, ids=[f"{k}{a}" for k, a in MODES])
@pytest.mark.parametrize("name", MODELS)
def test_speculative_ids_match_jax_and_greedy(name, mode):
    """B 2, batch-synchronised: the port's ids equal the JAX package's, its
    greedy_generate's and the JAX package's greedy; the deterministic
    drafters take the JAX package's rounds."""
    _, _, spec, params = _model(name)
    want, jst = _jax_spec(name, mode)
    np.testing.assert_array_equal(want, _jax_greedy(name))
    out, st = speculative_generate(params, spec, torch.from_numpy(_ids(name)),
                                   max_new_tokens=NEW, return_stats=True, device="cpu",
                                   **_port_kwargs(name, mode))
    np.testing.assert_array_equal(out.numpy(), want)
    ref = greedy_generate(params, spec, torch.from_numpy(_ids(name)).long(),
                          max_new_tokens=NEW, device="cpu")
    assert torch.equal(out, ref)
    if mode[0] == "ngram" or mode == ("stream", 1.0):
        assert st["rounds"] == int(jst["rounds"])
    if mode == ("stream", 1.0):  # perfect drafts: ceil((NEW - 1) / (gamma + 1)) rounds
        assert st["rounds"] == -(-(NEW - 1) // 5)
    assert st["rounds"] <= NEW


def test_self_speculation_has_no_draft_cache_hole():
    """Draft == target, S 8, T 40, gamma 3: the port accepts every draft and
    takes ceil(39 / 4) = 10 rounds; the JAX package's draft decays over its
    hole and takes more (13 at this prompt), with the same ids."""
    jspec, jparams, spec, params = _model("gpt2-tiny")
    ids = np.random.default_rng(0).integers(0, jspec.vocab_size, (1, 8)).astype(np.int32)
    jout, jst = jax_spec.speculative_generate(
        jparams, jspec, jnp.asarray(ids), draft_params=jparams, draft_spec=jspec, gamma=3,
        max_new_tokens=40, return_stats=True)
    out, st = speculative_generate(params, spec, torch.from_numpy(ids), draft_params=params,
                                   draft_spec=spec, gamma=3, max_new_tokens=40,
                                   return_stats=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert st["rounds"] == 10
    assert int(jst["rounds"]) > 10


def test_draft_with_model_fills_the_last_slot():
    """After a round that accepted every draft, the next round writes the
    last draft's K/V into its slot before drafting; the JAX package's slot
    stays zero."""
    jspec, jparams, spec, params = _model("gpt2-tiny")
    ids = np.zeros((1, 8), np.int32)
    jcache = jax_spec.init_cache(jspec, 1, 16, dtype=jnp.float32)
    _, jcache = jax_forward(jparams, jspec, jnp.asarray(ids), cache=jcache)
    jt, _, jcache = jax_spec._draft_with_model(jparams, jspec, jax_spec.Impl(), jcache,
                                               jnp.zeros((1,), jnp.int32), 3,
                                               jax.random.PRNGKey(0),
                                               jax_sampling.SamplingMethod())
    assert int(jcache["pos"]) == 11 and not np.asarray(jcache["k"])[:, :, 11].any()

    cache = spec_mod.init_cache(spec, 1, 16, dtype=torch.float32, device="cpu")
    _, cache = forward(params, spec, torch.from_numpy(ids).long(), cache=cache)
    cur = torch.zeros((1,), dtype=torch.long)
    t, _, cache = spec_mod._draft_with_model(params, spec, spec_mod.Impl(), cache, cur, 3,
                                             None, SamplingMethod())
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    cache = dict(cache, pos=12)  # all three accepted: slot 11 holds d3
    _, _, cache = spec_mod._draft_with_model(params, spec, spec_mod.Impl(), cache, cur, 1,
                                             None, SamplingMethod(), hole=t[:, -1])
    assert cache["k"][:, :, 11].abs().sum() > 0


def test_stochastic_speculation_valid():
    """Temperature sampling: ids in range, the loop ends, and with draft ==
    target nearly every draft is accepted (p == q up to rounding)."""
    _, _, spec, params = _model("gpt2-tiny")
    _, _, dspec, dparams = _model("gpt2-tiny", layers=1, seed=7)
    ids = torch.zeros((2, 6), dtype=torch.long)
    method = SamplingMethod(temperature=0.8, top_k=32)
    out = speculative_generate(params, spec, ids, draft_params=dparams, draft_spec=dspec,
                               gamma=3, max_new_tokens=10, method=method,
                               generator=torch.Generator().manual_seed(3), device="cpu")
    assert out.shape == (2, 16)
    assert ((out[:, 6:] >= 0) & (out[:, 6:] < spec.vocab_size)).all()
    _, st = speculative_generate(params, spec, ids, draft_params=params, draft_spec=spec,
                                 gamma=3, max_new_tokens=12, method=method,
                                 generator=torch.Generator().manual_seed(4),
                                 return_stats=True, device="cpu")
    assert st["rounds"] <= 6


def test_induction_model_logits_match_jax():
    """The port's forward on the JAX package's induction weights gives its
    logits; the port's own construction keeps the same shapes."""
    jspec = jax_synthetic.induction_spec(hidden=256, layers=2, heads=4, vocab=512,
                                         max_seq=128)
    jparams = jax_synthetic.make_induction_model(jspec, period=8)
    ids = np.array(jax_synthetic.periodic_prompt(8, 4, jspec.vocab_size))
    want = np.asarray(jax_forward(jparams, jspec, jnp.asarray(ids))[0])
    spec = induction_spec(hidden=256, layers=2, heads=4, vocab=512, max_seq=128)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    got, _ = forward(from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu"), spec,
                     torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)
    ours = make_induction_model(spec, 8, torch.Generator().manual_seed(0), device="cpu")
    flat = lambda t: {k: v for k, v in t.items() if k != "blocks"}  # noqa: E731
    for tree, jtree in ((flat(ours), flat(jparams)), (ours["blocks"], jparams["blocks"])):
        for k, v in jtree.items():
            assert (None if tree[k] is None else tuple(tree[k].shape)) == \
                (None if v is None else tuple(v.shape)), k
    with pytest.raises(ValueError, match="max_seq_len"):
        make_induction_model(induction_spec(hidden=256, max_seq=200), 8, device="cpu")


def test_induction_model_continues_the_period():
    """The port's own induction model continues a periodic prompt, and the
    online-gamma n-gram speculation gives its greedy ids, accepting several
    tokens a round."""
    spec = induction_spec(hidden=512, layers=3, heads=8, vocab=2048, max_seq=256)
    P = 16
    params = make_induction_model(spec, P, torch.Generator().manual_seed(0), device="cpu")
    ids = periodic_prompt(P, 6, spec.vocab_size, torch.Generator().manual_seed(7),
                          device="cpu")
    assert ids.shape == (1, 96) and torch.equal(ids[:, :P], ids[:, P:2 * P])
    ref = greedy_generate(params, spec, ids, max_new_tokens=48, device="cpu")
    assert torch.equal(ref[0, 96:], ids[0, :48])  # the pattern, continued
    out, stats = speculative_generate_auto(params, spec, ids, max_new_tokens=48, chunk=16,
                                           return_stats=True, device="cpu")
    assert torch.equal(out, ref)
    assert stats[-1]["tokens_per_round"] > 2.0
    assert stats[-1]["gamma"] > stats[0]["gamma"] or stats[0]["gamma"] >= 4


def test_arguments_refused():
    _, _, spec, params = _model("gpt2-tiny")
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="cache too small"):
        speculative_generate(params, spec, ids, cache_len=8, device="cpu")
    with pytest.raises(ValueError, match="together"):
        speculative_generate(params, spec, ids, draft_params=params, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        speculative_generate(params, spec, ids, draft_params=params, draft_spec=spec,
                             draft_tokens=ids, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            speculative_generate(params, spec, ids)
