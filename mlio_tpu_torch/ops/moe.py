"""Mixture-of-Experts MLP: routing, the dropless grouped product and the
GShard capacity dispatch (``mlio_tpu/ops/moe.py``).

Three methods behind one contract, as in the JAX package:

``dense``
    Every expert runs on every token, combined by the routing weights: the
    oracle.
``ragged``
    Dropless: each token is copied ``top_k`` times, the copies sorted by
    expert, each expert's contiguous rows multiplied by its weights, the
    copies unsorted and combined. The JAX package runs ``lax.ragged_dot``;
    PyTorch has no counterpart, so a loop over the experts with one
    ``torch.matmul`` over each expert's rows computes the same products
    (empty groups are skipped, as ``ragged_dot`` skips them). The default.
``dispatch``
    GShard/Switch capacity dispatch as einsums against a one-hot
    ``[T, E, C]`` tensor; copies past an expert's capacity drop (combine
    weight 0), top-1 choices first.

These products run outside any kernel, as the JAX package leaves them to
XLA. int8 or fp8 expert stacks (``QTensor`` with per-expert per-output-
channel scales ``[E, out]``) are dequantized one expert at a time before
that expert's product, so an ``[E, H, I]`` stack is never widened whole.

Routing follows Mixtral: an fp32 softmax over all experts, the top-k, the
kept weights renormalized. Top-k is taken by repeated ``argmax``, which
returns the first maximum, so ties go to the lowest expert index as
``lax.top_k`` gives them (``torch.topk`` promises no order on ties).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mlio_tpu_torch.ops.fused_mlp import activate as _activate
from mlio_tpu_torch.ops.quant import QTensor, dequantize


def _expert(w, e: int, dtype):
    """Expert ``e`` of a stack [E, in, out] in ``dtype`` (a QTensor
    dequantized with its expert's scales); None stays None."""
    if w is None:
        return None
    if isinstance(w, QTensor):
        return dequantize(w.select(e), dtype)
    return w[e].to(dtype)


def _num_experts(w) -> int:
    return (w.q if isinstance(w, QTensor) else w).shape[0]


def topk_mask(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """[..., E] bool: the ``top_k`` largest of ``probs`` by repeated argmax,
    ties to the lowest index (the JAX kernel's and ``lax.top_k``'s rule)."""
    return _topk(probs, top_k)[2]


def _topk(probs: torch.Tensor, top_k: int):
    """(values [..., k], indices [..., k], mask [..., E]) in descending
    order, ties to the lowest index."""
    rem = probs.clone()
    mask = torch.zeros_like(probs, dtype=torch.bool)
    vals, idxs = [], []
    for _ in range(top_k):
        i = rem.argmax(-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idxs.append(i)
        mask.scatter_(-1, i, True)
        rem.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1), mask


def router_topk(x: torch.Tensor, w_router: torch.Tensor,
                top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route tokens x [T, H] with w_router [H, E]: softmax over all experts
    in fp32, keep the top-k, renormalize. Returns (weights [T, k] fp32,
    expert indices [T, k] int32, probabilities [T, E] fp32)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx, _ = _topk(probs, top_k)
    weights = weights / weights.sum(-1, keepdim=True)
    return weights, idx.to(torch.int32), probs


def _expert_mlp_batched(xe, w_gate, w_up, w_down, activation, dtype):
    """Per-expert MLP over expert-major batches xe [E, C, H] → [E, C, H],
    one expert's weights in ``dtype`` at a time."""
    out = []
    for e in range(xe.shape[0]):
        up = xe[e] @ _expert(w_up, e, dtype)
        gate = xe[e] @ _expert(w_gate, e, dtype) if w_gate is not None else None
        h = _activate(up, gate, activation).to(dtype)
        out.append(h @ _expert(w_down, e, dtype))
    return torch.stack(out)


def moe_mlp_dense(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                  activation: str = "swiglu") -> torch.Tensor:
    """The oracle: every expert on every token, combined by the routing
    weights. x [T, H]; expert weights [E, H, I] / [E, I, H]."""
    dtype = x.dtype
    weights, idx, _ = router_topk(x, w_router, top_k)
    E = _num_experts(w_up)
    ye = _expert_mlp_batched(x[None].expand(E, *x.shape), w_gate, w_up, w_down, activation,
                             dtype)
    comb = torch.zeros((x.shape[0], E), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, idx.long(), weights)
    return torch.einsum("ceh,ce->ch", ye.transpose(0, 1).float(), comb).to(dtype)


def moe_mlp_ragged(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                   activation: str = "swiglu") -> torch.Tensor:
    """Dropless grouped product: the token copies sorted by expert, each
    expert's contiguous rows through its own weights (``lax.ragged_dot``'s
    products as one matmul per non-empty expert), unsorted and combined."""
    dtype = x.dtype
    T, H = x.shape
    E = _num_experts(w_up)
    weights, idx, _ = router_topk(x, w_router, top_k)
    flat_e = idx.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = x.repeat_interleave(top_k, dim=0)[order]
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    ys = torch.empty((T * top_k, H), dtype=dtype, device=x.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            rows = xs[start:start + n]
            up = rows @ _expert(w_up, e, dtype)
            gate = rows @ _expert(w_gate, e, dtype) if w_gate is not None else None
            ys[start:start + n] = _activate(up, gate, activation).to(dtype) @ _expert(
                w_down, e, dtype)
        start += n
    y = ys[inv].reshape(T, top_k, H).float()
    return torch.einsum("tkh,tk->th", y, weights).to(dtype)


def moe_mlp_dispatch(x, w_router, w_gate, w_up, w_down, *, top_k: int,
                     activation: str = "swiglu", capacity_factor: float = 2.0,
                     capacity: Optional[int] = None) -> torch.Tensor:
    """GShard capacity dispatch: copies ranked in (k, token) order fill
    each expert's ``capacity`` slots, top-1 choices first; the rest drop
    (combine weight 0). The capacity is ``int(capacity_factor * top_k * T
    / E) + 1`` rounded up to a multiple of 8, as the JAX package rounds it
    (the rounding decides which copies drop), at most ``top_k * T``."""
    dtype = x.dtype
    T, H = x.shape
    E = _num_experts(w_up)
    if capacity is None:
        capacity = int(capacity_factor * top_k * T / E) + 1
        capacity = -(-capacity // 8) * 8
    C = min(capacity, top_k * T)
    weights, idx, _ = router_topk(x, w_router, top_k)
    onehot = torch.nn.functional.one_hot(idx.long(), E).to(torch.int32)  # [T, k, E]
    flat = onehot.transpose(0, 1).reshape(top_k * T, E)  # k-major
    pos_flat = torch.cumsum(flat, dim=0) - flat
    pos = pos_flat.reshape(top_k, T, E).transpose(0, 1)  # [T, k, E]
    pos_k = (pos * onehot).sum(-1)  # [T, k]
    keep = pos_k < C
    slot = torch.nn.functional.one_hot(torch.where(keep, pos_k, torch.full_like(pos_k, C)).long(),
                                       C + 1)[..., :C]  # [T, k, C]; a dropped copy is all 0
    disp = torch.einsum("tke,tkc->tec", onehot.to(dtype), slot.to(dtype))
    comb = torch.einsum("tke,tkc,tk->tec", onehot.float(), slot.float(),
                        weights * keep.float())
    xe = torch.einsum("tec,th->ech", disp, x)
    ye = _expert_mlp_batched(xe, w_gate, w_up, w_down, activation, dtype)
    return torch.einsum("tec,ech->th", comb, ye.float()).to(dtype)


_METHODS = ("dense", "ragged", "dispatch")


def moe_mlp(x, w_router, w_gate, w_up, w_down, *, top_k: int, activation: str = "swiglu",
            method: str = "ragged", capacity_factor: float = 2.0) -> torch.Tensor:
    """MoE MLP over x [B, S, H] or [T, H] by ``method`` (see the module's
    docstring)."""
    if method not in _METHODS:
        raise ValueError(f"moe_mlp: unknown method {method!r} (one of {_METHODS})")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if method == "dense":
        y = moe_mlp_dense(x2, w_router, w_gate, w_up, w_down, top_k=top_k,
                          activation=activation)
    elif method == "ragged":
        y = moe_mlp_ragged(x2, w_router, w_gate, w_up, w_down, top_k=top_k,
                           activation=activation)
    else:
        y = moe_mlp_dispatch(x2, w_router, w_gate, w_up, w_down, top_k=top_k,
                             activation=activation, capacity_factor=capacity_factor)
    return y.reshape(shape)


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch Transformer's auxiliary loss: E * sum_e f_e * P_e, with f_e
    the share of tokens whose top-1 choice is e and P_e the mean router
    probability of e."""
    top1 = idx[..., 0].long()
    f = torch.nn.functional.one_hot(top1, num_experts).float().reshape(-1, num_experts).mean(0)
    p = probs.reshape(-1, num_experts).float().mean(0)
    return num_experts * (f * p).sum()
