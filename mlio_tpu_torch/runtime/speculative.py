"""Speculative decoding: n-gram, draft-model and external-stream drafting
(``mlio_tpu/runtime/speculative.py``).

Each round drafts ``gamma`` tokens and scores ``[cur, d1 .. d_gamma]`` with
ONE target forward over the cache; the accepted prefix and the token at the
cut are committed. The committed stream is exactly the target's greedy
stream (greedy) or an exact sample from it (stochastic: Leviathan et al.,
accept x with prob min(1, p(x)/q(x)), resample a rejection from
max(p - q, 0)).

* **Cache rewind by position.** The window's K/V are written optimistically;
  on rejection ``cache["pos"]`` is rewound, every attention kernel masks
  the stale slots by ``kv_len``, and the next round overwrites them.
* **Batch-synchronised acceptance.** Every sequence commits
  ``k = min_b(n_accept_b) + 1`` tokens a round, so the contiguous cache
  keeps one position. Tokens a sequence would have accepted are drawn
  again the next round: exact, only slower when rows disagree.
* **A host loop over rounds.** The JAX package runs its rounds as
  ``lax.scan`` over ``lax.cond``, a TPU compile workaround. Here the cache
  position is a host int (``runtime/kv_cache.py``), so ``k`` comes to the
  host once a round, and only there; the buffer, the drafts, the
  acceptance and the commit stay on the device.
* **The draft cache has no hole.** The JAX package's ``_draft_with_model``
  feeds ``cur, d1 .. d_(gamma-1)`` and never writes ``d_gamma``'s K/V, yet
  rewinds the draft cache past it when every draft was accepted; the slot
  keeps zeros and the draft decays (the output stays exact). Here the round
  after a full acceptance first feeds ``d_gamma`` to the draft model at its
  slot, its sample dropped: gamma draft steps a round, one more after a
  round that accepted all of its drafts.

Routes: a verify window (gamma + 1 tokens) goes through ``forward`` with a
cache, so K1 at ``q_offset`` = pos over the whole cache (and K2 where
``Impl(norm="fused")``); a draft step is one token through
``_decode_forward``'s ``decode_route``: K4 at B <= 8, else K6 or the scan.
The cache is bf16 (the model's dtype), as the JAX package's.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl, forward
from mlio_tpu_torch.runtime import sampling
from mlio_tpu_torch.runtime.kv_cache import init_cache


# ---------------------------------------------------------------------------
# Drafting
# ---------------------------------------------------------------------------

def _draft_with_model(draft_params, draft_spec, draft_impl, cache, token, gamma, generator,
                      method, hole=None):
    """Draft ``gamma`` tokens with the small model after ``token`` [B], whose
    slot is ``cache["pos"]``. ``hole`` [B] is the previous round's last
    draft where that round accepted every draft: its K/V go into slot
    ``pos - 1`` first, its sample dropped.

    Returns (tokens [B, gamma], probs [B, gamma, V], cache); probs are the
    draft's next-token distributions (q in the acceptance rule)."""
    if hole is not None:
        _, cache = forward(draft_params, draft_spec, hole[:, None], impl=draft_impl,
                           cache=dict(cache, pos=cache["pos"] - 1))
    toks, probs = [], []
    for _ in range(gamma):
        logits, cache = forward(draft_params, draft_spec, token[:, None], impl=draft_impl,
                                cache=cache)
        probs.append(sampling.probabilities(logits[:, -1, :], method))
        token = sampling.sample(logits[:, -1, :], generator, method)
        toks.append(token)
    return torch.stack(toks, dim=1), torch.stack(probs, dim=1), cache


def _draft_ngram(buf: torch.Tensor, buf_len: int, gamma: int, vocab_size: int,
                 window: int = 64, match: int = 2):
    """Prompt-lookup drafting: the most recent earlier occurrence of the last
    ``match`` tokens of ``buf[:, :buf_len]`` within the last ``window``
    positions proposes the ``gamma`` tokens that followed it (indices
    clamped at the buffer's end); with no match, the last token repeated.
    Runs on ``buf``'s device. Returns ([B, gamma] tokens, [B, gamma, V]
    one-hot q)."""
    B, L = buf.shape
    pos = torch.arange(L, device=buf.device)[None, :]
    last = buf_len - 1  # the newest token's index
    # candidate c matches where buf[c - j] == buf[last - j] for j < match
    ok = torch.ones((B, L), dtype=torch.bool, device=buf.device)
    for j in range(match):
        tgt = buf[:, last - j:last - j + 1]
        ok &= (torch.roll(buf, j, dims=1) == tgt) & (pos >= j)
    # strictly in the past and recent
    ok &= (pos < last) & (pos >= last - window)
    best = torch.where(ok, pos, -1).amax(dim=1)  # the most recent, -1 for none
    idx = (best[:, None] + 1 + torch.arange(gamma, device=buf.device)).clamp(0, L - 1)
    toks = torch.where((best >= 0)[:, None], torch.gather(buf, 1, idx), buf[:, last:last + 1])
    return toks, torch.nn.functional.one_hot(toks, vocab_size).float()


# ---------------------------------------------------------------------------
# Acceptance (Leviathan et al. speculative sampling)
# ---------------------------------------------------------------------------

def _residual(q: torch.Tensor, p: torch.Tensor, n_accept: torch.Tensor) -> torch.Tensor:
    """The resampling distribution [B, V] at each row's cut: max(p - q, 0)
    normalised at the first rejected position (q is 0 at the bonus slot
    ``g``), or p where p <= q everywhere."""
    qpad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    resid = (p - qpad).clamp_min(0.0)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid,
                        p / p.sum(-1, keepdim=True).clamp_min(1e-20))
    return resid[torch.arange(p.shape[0], device=p.device), n_accept]


def _accept(draft_toks: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
            generator: Optional[torch.Generator], greedy: bool,
            u: Optional[torch.Tensor] = None):
    """Accept or resample, vectorised over the batch.

    draft_toks [B, g]; q [B, g, V] draft probs; p [B, g + 1, V] target
    probs. ``u`` [B, g] are the acceptance uniforms (drawn from
    ``generator`` when None). Returns (tokens [B, g + 1], n_accept [B]):
    ``n_accept`` drafts survive and tokens[:, n_accept] is the token at the
    cut (the argmax when greedy, else a draw from :func:`_residual`);
    positions past it are left as drafted."""
    B, g = draft_toks.shape
    if greedy:
        accept = draft_toks == p[:, :g].argmax(dim=-1)
    else:
        p_draft = torch.gather(p[:, :g], -1, draft_toks[..., None])[..., 0]
        q_draft = torch.gather(q, -1, draft_toks[..., None])[..., 0]
        if u is None:
            u = torch.rand((B, g), generator=generator, device=p.device)
        accept = u < (p_draft / q_draft.clamp_min(1e-20)).clamp(max=1.0)
    # n_accept = the accepted PREFIX's length
    n_accept = accept.long().cumprod(dim=1).sum(dim=1)
    if greedy:
        cut = torch.gather(p.argmax(dim=-1), 1, n_accept[:, None])[:, 0]
    else:
        cut = torch.multinomial(_residual(q, p, n_accept), 1, generator=generator)[:, 0]
    toks = torch.cat([draft_toks, torch.zeros_like(draft_toks[:, :1])], dim=1)
    return toks.scatter(1, n_accept[:, None], cut[:, None].to(toks.dtype)), n_accept


# ---------------------------------------------------------------------------
# The round loop
# ---------------------------------------------------------------------------

def _speculative_impl(params, spec, input_ids, generator, draft_params, draft_spec, oracle, *,
                      impl, draft_impl, gamma, max_new_tokens, cache_len, method,
                      ngram_window, draft_accept, dev):
    B, S = input_ids.shape
    V = spec.vocab_size
    greedy = method.temperature == 0.0
    use_model_draft = draft_params is not None

    cache = init_cache(spec, B, cache_len, dtype=params["tok_embed"].dtype, device=dev)
    logits, cache = forward(params, spec, input_ids, impl=impl, cache=cache)
    first = sampling.sample(logits[:, -1, :], generator, method)
    dcache = hole = None
    if use_model_draft:
        dcache = init_cache(draft_spec, B, cache_len, dtype=draft_params["tok_embed"].dtype,
                            device=dev)
        _, dcache = forward(draft_params, draft_spec, input_ids, impl=draft_impl, cache=dcache)

    # the token buffer: prompt, committed tokens, gamma + 1 of scratch
    buf = torch.zeros((B, S + max_new_tokens + gamma + 1), dtype=torch.long, device=dev)
    buf[:, :S] = input_ids
    buf[:, S] = first
    done, rounds = 1, 0  # committed new tokens; rounds run
    while done < max_new_tokens:
        cur = buf[:, S + done - 1]  # its slot is cache["pos"]
        if oracle is not None:
            # the external stream proposes oracle[done .. done + gamma - 1],
            # each corrupted with rate 1 - draft_accept
            d_toks = oracle[:, done:done + gamma]
            if draft_accept < 1.0:
                flip = torch.rand(d_toks.shape, generator=generator, device=dev) >= draft_accept
                d_toks = torch.where(flip, (d_toks + 1) % V, d_toks)
            q = torch.nn.functional.one_hot(d_toks, V).float()
        elif use_model_draft:
            d_toks, q, dcache = _draft_with_model(draft_params, draft_spec, draft_impl, dcache,
                                                  cur, gamma, generator, method, hole)
        else:
            d_toks, q = _draft_ngram(buf, S + done, gamma, V, window=ngram_window)

        # one target forward over [cur, drafts] (gamma + 1 tokens)
        window = torch.cat([cur[:, None], d_toks], dim=1)
        logits, _ = forward(params, spec, window, impl=impl, cache=cache)
        p = sampling.probabilities(logits.reshape(B * (gamma + 1), V), method)
        toks, n_acc = _accept(d_toks, q, p.reshape(B, gamma + 1, V), generator, greedy)
        # the round's one host read: how many tokens every row commits
        k = min(int(n_acc.min()) + 1, max_new_tokens - done)
        buf[:, S + done:S + done + k] = toks[:, :k]
        # rewind both caches to the committed length: the k-th committed
        # token (the next cur) is written by the next round
        cache = dict(cache, pos=cache["pos"] + k)
        if use_model_draft:
            dcache = dict(dcache, pos=cache["pos"])
            hole = d_toks[:, -1] if k == gamma + 1 else None
        done += k
        rounds += 1
    return buf[:, :S + max_new_tokens], rounds


@torch.inference_mode()
def speculative_generate(
    params,
    spec: ModelSpec,
    input_ids,
    *,
    draft_params=None,
    draft_spec: Optional[ModelSpec] = None,
    gamma: int = 4,
    max_new_tokens: int = 16,
    impl: Impl = Impl(),
    draft_impl: Optional[Impl] = None,
    method: Optional[sampling.SamplingMethod] = None,
    generator: Optional[torch.Generator] = None,
    cache_len: Optional[int] = None,
    ngram_window: int = 64,
    draft_tokens=None,
    draft_accept: float = 1.0,
    return_stats: bool = False,
    device: Union[str, torch.device] = "cuda",
):
    """Generate with speculative decoding; exact with respect to the target.

    With ``draft_params``/``draft_spec``: two-model speculation. With
    ``draft_tokens`` [B, n]: an external draft stream (retrieval hits, a
    cached response), edge-padded so that a round's window never runs off
    its end; round j proposes ``draft_tokens[:, done:done + gamma]``, each
    token corrupted with rate ``1 - draft_accept``. Otherwise n-gram
    prompt-lookup drafting. Sampling, the corruption and the acceptance
    draw from ``generator`` (seed 0 on ``device`` if None), which must live
    on ``device``, where ``params`` must lie.

    Returns [B, S + max_new_tokens] ids on ``device``, and with
    ``return_stats`` also ``{"rounds", "tokens_per_round"}``."""
    if method is None:
        method = sampling.SamplingMethod(temperature=0.0)
    if draft_impl is None:
        draft_impl = impl
    dev = resolve_device(device)
    for name, p in (("params", params), ("draft_params", draft_params)):
        if p is not None and p["tok_embed"].device.type != dev.type:
            raise ValueError(f"speculative_generate: {name} lie on {p['tok_embed'].device}, "
                             f"not {dev}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    B, S = input_ids.shape
    if gamma < 1 or max_new_tokens < 1:
        raise ValueError("speculative_generate: gamma and max_new_tokens must be at least 1")
    if cache_len is None:
        cache_len = min(spec.max_seq_len, S + max_new_tokens + gamma + 1)
    if S + max_new_tokens + gamma + 1 > cache_len:
        raise ValueError("speculative_generate: cache too small: speculation needs gamma + 1 "
                         "slots of slack beyond the output")
    if (draft_params is None) != (draft_spec is None):
        raise ValueError("speculative_generate: give draft_params and draft_spec together")
    oracle = None
    if draft_tokens is not None:
        if draft_params is not None:
            raise ValueError("speculative_generate: draft_tokens and a draft model are "
                             "mutually exclusive")
        oracle = torch.as_tensor(draft_tokens, device=dev).long()
        pad = max_new_tokens + gamma + 1 - oracle.shape[1]
        if pad > 0:  # edge-repeat, so that round windows never run off the end
            oracle = torch.cat([oracle, oracle[:, -1:].expand(B, pad)], dim=1)
    out, rounds = _speculative_impl(
        params, spec, input_ids, generator, draft_params, draft_spec, oracle, impl=impl,
        draft_impl=draft_impl, gamma=gamma, max_new_tokens=max_new_tokens, cache_len=cache_len,
        method=method, ngram_window=ngram_window, draft_accept=draft_accept, dev=dev)
    if return_stats:
        return out, {"rounds": rounds, "tokens_per_round": max_new_tokens / max(rounds, 1)}
    return out


# ---------------------------------------------------------------------------
# Online gamma adaptation
# ---------------------------------------------------------------------------

def optimal_gamma(accept_rate: float, verify_slope: float = 0.04,
                  draft_cost_ratio: float = 0.0, max_gamma: int = 16) -> int:
    """The draft length in [1, max_gamma] that maximises tokens a unit of
    cost for a per-token acceptance ``accept_rate`` r: a round commits
    (1 - r^(g+1)) / (1 - r) tokens on average and costs
    1 + g * (verify_slope + draft_cost_ratio) target steps (a verify window
    of g + 1 tokens, plus g draft steps for model drafting; n-gram drafting
    is free). ``verify_slope`` is a cost model's constant, not a
    measurement of this card."""
    r = min(max(float(accept_rate), 0.0), 0.999)
    best_g, best_rate = 1, -1.0
    for g in range(1, max_gamma + 1):
        toks = (1.0 - r ** (g + 1)) / (1.0 - r)
        cost = 1.0 + g * (verify_slope + draft_cost_ratio)
        if toks / cost > best_rate:
            best_rate = toks / cost
            best_g = g
    return best_g


class AutoGamma:
    """An EMA of the acceptance rate and a gamma chosen from a bounded set
    of candidates."""

    def __init__(self, gammas=(1, 2, 3, 4, 6, 8, 12, 16), ema: float = 0.6,
                 verify_slope: float = 0.04, draft_cost_ratio: float = 0.0,
                 prior_rate: float = 0.5):
        self.gammas = tuple(sorted(gammas))
        self.ema = ema
        self.verify_slope = verify_slope
        self.draft_cost_ratio = draft_cost_ratio
        self.rate = prior_rate

    def update(self, tokens: int, rounds: int, gamma: int) -> None:
        """Back the per-token acceptance rate out of the measured tokens a
        round at ``gamma`` (bisecting the monotonic E[tokens](r)), then fold
        it into the EMA."""
        tpr = max(1.0, min(tokens / max(rounds, 1), gamma + 1))
        lo, hi = 0.0, 0.999

        def expected(r):
            return (gamma + 1) if r >= 0.999 else (1.0 - r ** (gamma + 1)) / (1.0 - r)

        for _ in range(40):
            mid = (lo + hi) / 2
            if expected(mid) < tpr:
                lo = mid
            else:
                hi = mid
        self.rate = self.ema * self.rate + (1 - self.ema) * (lo + hi) / 2

    def gamma(self) -> int:
        g = optimal_gamma(self.rate, self.verify_slope, self.draft_cost_ratio,
                          max_gamma=self.gammas[-1])
        return min(self.gammas, key=lambda c: (abs(c - g), c))


def speculative_generate_auto(params, spec, input_ids, *, max_new_tokens: int = 64,
                              chunk: int = 32, controller: Optional[AutoGamma] = None,
                              return_stats: bool = False, **kw):
    """Speculative generation with gamma adapted online: decode in chunks of
    ``chunk`` tokens, each a :func:`speculative_generate` call over the
    grown prefix (its prefill included), and re-pick gamma for the next
    chunk from the chunk's tokens a round. ``kw`` go to each call.

    Returns [B, S + max_new_tokens] ids, and with ``return_stats`` a list
    of each chunk's ``{"gamma", "rounds", "tokens_per_round", "rate_ema"}``."""
    ctrl = controller or AutoGamma(
        draft_cost_ratio=0.35 if kw.get("draft_params") is not None else 0.0)
    ids, done, stats = input_ids, 0, []
    while done < max_new_tokens:
        n = min(chunk, max_new_tokens - done)
        g = ctrl.gamma()
        ids, st = speculative_generate(params, spec, ids, gamma=g, max_new_tokens=n,
                                       return_stats=True, **kw)
        ctrl.update(n, st["rounds"], g)
        stats.append({"gamma": g, **st, "rate_ema": round(ctrl.rate, 3)})
        done += n
    if return_stats:
        return ids, stats
    return ids
