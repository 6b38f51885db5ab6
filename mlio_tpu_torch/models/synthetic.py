"""Synthetic models with known behaviour (``mlio_tpu/models/synthetic.py``).

:func:`make_induction_model` builds a transformer whose greedy continuation
repeats the prompt's period: a stand-in for a trained checkpoint continuing
code or a document. It pays the full forward cost of its geometry (every
weight tensor at its real size) and knows nothing of any drafter, so
speculative decoding on it measures the real machinery on a model that
predicts repetitive continuations.

Construction (one induction layer, then pass-through layers):

* the learned positions are a scaled random orthonormal family {u_t}; the
  token embeddings are random rows E[V, H] of norm about 1;
* layer 0's W_k projects onto the positional subspace (k_j ~ u_j) and W_q
  also shifts by the period (q_i ~ beta u_{i-P+1}), so the scores peak at
  j = i-P+1 and the softmax is about one-hot;
* W_v strips the positional subspace and W_o = gain * I: the token
  embedding of position i-P+1, which is the next token of period-P text,
  is added to the residual and dominates the logits E x;
* the other layers have zero attention and MLP weights of full size.

The port draws E, and the Gaussian under U's QR, from a ``torch.Generator``
on an explicit device; the JAX package draws them from a PRNG key, so the
two packages' models differ in their draws, not in their construction.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec


def induction_spec(hidden: int = 1024, layers: int = 8, heads: int = 8,
                   intermediate: Optional[int] = None, vocab: int = 8192,
                   max_seq: int = 2048, name: str = "induction") -> ModelSpec:
    return ModelSpec(
        name=name, vocab_size=vocab, hidden_size=hidden, num_layers=layers,
        num_heads=heads, num_kv_heads=heads,
        intermediate_size=intermediate or 4 * hidden, max_seq_len=max_seq,
        activation="gelu_new", norm="layernorm", positional="learned",
        use_qkv_bias=True, use_mlp_bias=True, use_out_bias=True,
        tie_embeddings=True)


def make_induction_model(spec: ModelSpec, period: int,
                         generator: Optional[torch.Generator] = None, *,
                         beta: float = 40.0, gain: float = 6.0, pos_scale: float = 6.0,
                         dtype=torch.float32, device: Union[str, torch.device] = "cuda"):
    """The params (the port's layout) of a period-``period`` induction model
    on ``spec`` (learned positions, tied embeddings), on ``device`` in
    ``dtype``. The draws come from ``generator`` (seed 0 on ``device`` if
    None), which must live on ``device``; the construction runs in fp32."""
    if spec.positional != "learned" or not spec.tie_embeddings:
        raise ValueError("make_induction_model: needs learned positions and tied embeddings")
    if spec.max_seq_len > spec.hidden_size // 2:
        raise ValueError(
            "make_induction_model: the positional family must span a strict subspace "
            "(token embeddings keep most of their energy under I - P_pos): use "
            "max_seq_len <= hidden_size/2")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"make_induction_model: the generator lives on {generator.device}, "
                         f"not {dev}")
    H, V, S = spec.hidden_size, spec.vocab_size, spec.max_seq_len
    L, Hq, D, inter = spec.num_layers, spec.num_heads, spec.head_size, spec.intermediate_size
    if Hq * D != H:
        raise ValueError("make_induction_model: needs num_heads * head_size == hidden_size")

    # random unit token rows; a scaled orthonormal positional family
    E = torch.randn((V, H), generator=generator, device=dev) / H ** 0.5
    U = torch.linalg.qr(torch.randn((H, S), generator=generator, device=dev))[0].T  # [S, H]
    # Row-vector maps: x @ P_pos projects onto the positional span; x @
    # SHIFT maps u_t to u_{t-period+1} (clamped at 0), the key an induction
    # head must hit. Scores scale by 1/sqrt(D): beta is folded into W_q.
    P_pos = U.T @ U
    dst = (torch.arange(S, device=dev) - (period - 1)).clamp(min=0)
    SHIFT = U.T @ U[dst]
    eye = torch.eye(H, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def layer0(w0, shape):
        w = zeros(*shape)
        w[0] = w0.to(dtype)
        return w

    # The flat [H, Hq*D] layout slices heads on columns, so the full H x H
    # maps give head h the coordinate slice [hD, (h+1)D) of the positional
    # dot: each head sees 1/Hq of the signal, and beta sharpens its softmax.
    blocks = {
        "ln1_scale": torch.ones((L, H), dtype=dtype, device=dev), "ln1_bias": zeros(L, H),
        "ln2_scale": torch.ones((L, H), dtype=dtype, device=dev), "ln2_bias": zeros(L, H),
        "wq": layer0(beta * D ** 0.5 * SHIFT, (L, H, Hq * D)), "bq": zeros(L, Hq * D),
        "wk": layer0(P_pos, (L, H, Hq * D)), "bk": zeros(L, Hq * D),
        # W_v strips the positional subspace: the value is the key
        # position's token embedding
        "wv": layer0(eye - P_pos, (L, H, Hq * D)), "bv": zeros(L, Hq * D),
        "wo": layer0(gain * eye, (L, Hq * D, H)), "bo": zeros(L, H),
        "w_up": zeros(L, H, inter), "b_up": zeros(L, inter),
        "w_down": zeros(L, inter, H), "b_down": zeros(L, H),
        "w_gate": None, "b_gate": None,
    }
    return {
        "tok_embed": E.to(dtype),
        "pos_embed": (pos_scale * U).to(dtype),
        "blocks": blocks,
        "final_scale": torch.ones((H,), dtype=dtype, device=dev),
        "final_bias": zeros(H),
        "lm_head": None,
        "lm_head_bias": None,
    }


def periodic_prompt(period: int, repeats: int, vocab: int,
                    generator: Optional[torch.Generator] = None, *,
                    device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """A [1, period * repeats] int64 prompt of a random period-``period``
    pattern of ids in [2, vocab), on ``device`` (the draws from
    ``generator``, seed 7 on ``device`` if None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(7)
    pat = torch.randint(2, vocab, (period,), generator=generator, device=dev)
    return pat.repeat(repeats)[None]
