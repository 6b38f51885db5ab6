"""Token sampling: greedy, temperature, top-k, top-p (``mlio_tpu/runtime/sampling.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingMethod:
    """temperature == 0.0 → greedy argmax."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           method: SamplingMethod) -> torch.Tensor:
    """logits [B, V] → token ids [B] (int64). Sampling draws from
    ``generator``, which must live on the logits' device."""
    if method.temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(_filtered_logits(logits, method), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def probabilities(logits: torch.Tensor, method: SamplingMethod) -> torch.Tensor:
    """The distribution ``sample`` draws from, as probs [B, V] (fp32).

    Greedy collapses to a one-hot at the (first) argmax. Speculative
    decoding's acceptance rule (``runtime/speculative.py``) takes these
    post-filter distributions, not the raw softmax."""
    if method.temperature == 0.0:
        return torch.nn.functional.one_hot(logits.argmax(dim=-1),
                                           logits.shape[-1]).to(torch.float32)
    return torch.softmax(_filtered_logits(logits, method), dim=-1)


def _filtered_logits(logits: torch.Tensor, method: SamplingMethod) -> torch.Tensor:
    """Temperature, then top-k, then top-p filtering (fp32); filtered-out
    entries are -inf."""
    logits = logits.float() / method.temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if method.top_k is not None:
        kth = torch.topk(logits, method.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if method.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # Keep the smallest set of tokens whose cumulative prob >= top_p.
        cutoff_idx = (cum < method.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits
