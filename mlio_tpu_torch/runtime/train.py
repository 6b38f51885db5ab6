"""The training step: the next-token loss over the cache-free ``forward``,
its gradient, and SGD (``__graft_entry__.py:104-118`` in the JAX package).

``jax.value_and_grad`` becomes ``loss.backward()`` on parameters that
require grad (:func:`trainable`). With ``Impl(attention="flash")`` the
attention's forward is K1 and its backward K13
(``ops.flash_attention_grad.flash_attention_diff``); the norms and MLPs stay
dense, because K2, K11 and K12 have no backward here, as in the JAX package
(their wrappers raise under autograd). The SGD update is in place under
``torch.no_grad()``, where JAX builds a new tree.
"""
from __future__ import annotations

from typing import List

import torch

from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl, Params, forward


def trainable(params: Params) -> List[torch.Tensor]:
    """Mark every floating tensor of the tree as requiring grad; returns them
    (the leaves an optimizer updates)."""
    leaves = []

    def walk(v):
        if isinstance(v, dict):
            for t in v.values():
                walk(t)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            leaves.append(v.requires_grad_())

    walk(params)
    return leaves


def next_token_loss(params: Params, spec: ModelSpec, ids: torch.Tensor, *,
                    impl: Impl = Impl()) -> torch.Tensor:
    """Mean next-token cross-entropy of ids [B, S + 1]: the forward over
    ``ids[:, :-1]``, an fp32 log-softmax of its logits, the targets
    ``ids[:, 1:]``."""
    logits, _ = forward(params, spec, ids[:, :-1], impl=impl)
    logp = torch.log_softmax(logits.float(), -1)
    return -logp.gather(-1, ids[:, 1:, None]).mean()


@torch.no_grad()
def sgd_step(leaves: List[torch.Tensor], lr: float = 1e-3) -> None:
    """p -= lr * p.grad in place for every leaf with a gradient; the
    gradients are then dropped."""
    for p in leaves:
        if p.grad is not None:
            p.add_(p.grad, alpha=-lr)
            p.grad = None

