"""Fused MLP: up-projection → activation (→ gate) → down-projection (K11).

Replaces ``mlio_tpu/ops/fused_mlp.py::_fused_mlp_kernel``. The kernel is
CUDA C++ in ``mlio_tpu_torch/csrc/fused_mlp.cu``: the [M, I] activation
never goes to device memory. Each block takes a tile of 128 rows and a chunk
of the intermediate axis, keeps its activation tile in shared memory and
adds its share of the down product to an fp32 [M, H] workspace in a fixed
order, chunk after chunk, each waiting for its ticket; the last chunk rounds
the sum to bf16 and adds ``b_down``. One launch, no atomics: the output is
the same bits from run to run (see the source's note for the H100 bound and
the design).

The function is the JAX kernel's: the up (and gate) products sum in fp32,
their biases added in fp32, the activation in fp32 (tanh-GELU for
``gelu_new``/``gelu_tanh``/``geglu``, erf-GELU for ``gelu``, SiLU for
``swiglu``), rounded to x's dtype before the down product, whose fp32 sum
is rounded to x's dtype; ``b_down`` is added after, in x's dtype.

On CPU tensors :func:`fused_mlp` runs :func:`fused_mlp_plain`; on CUDA
tensors it launches the kernel or raises. The kernel takes bf16 only.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mlio_tpu_torch.ops import _build, cost

ACTIVATIONS = ("gelu_new", "gelu_tanh", "gelu", "relu", "swiglu", "geglu")
_GATED = ("swiglu", "geglu")
_ACT_CODE = {"gelu_new": 0, "gelu_tanh": 0, "gelu": 1, "relu": 2, "swiglu": 3, "geglu": 4}


def activate(h: torch.Tensor, gate: Optional[torch.Tensor], activation: str) -> torch.Tensor:
    """``_activate`` of the JAX module: the activation in fp32 of the up
    projection ``h`` (gated by ``gate`` for SwiGLU/GeGLU)."""
    hf = h.float()
    if activation == "swiglu":
        return F.silu(gate.float()) * hf
    if activation == "geglu":
        return F.gelu(gate.float(), approximate="tanh") * hf
    if activation in ("gelu_new", "gelu_tanh"):
        return F.gelu(hf, approximate="tanh")
    if activation == "gelu":
        return F.gelu(hf)
    if activation == "relu":
        return torch.clamp_min(hf, 0.0)
    raise ValueError(f"unknown activation {activation}")


def _check(x, w_up, w_down, b_up, b_down, w_gate, b_gate, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp: unknown activation {activation!r}")
    H = x.shape[-1]
    if w_up.ndim != 2 or w_up.shape[0] != H:
        raise ValueError(f"fused_mlp: w_up must be [{H}, I], got {tuple(w_up.shape)}")
    I = w_up.shape[1]
    if w_down.shape != (I, H):
        raise ValueError(f"fused_mlp: w_down must be [{I}, {H}], got {tuple(w_down.shape)}")
    if (activation in _GATED) != (w_gate is not None):
        raise ValueError(f"fused_mlp: {activation} {'needs' if w_gate is None else 'takes no'} "
                         "w_gate")
    if w_gate is not None and w_gate.shape != (H, I):
        raise ValueError(f"fused_mlp: w_gate must be [{H}, {I}]")
    for name, b, n in (("b_up", b_up, I), ("b_gate", b_gate, I), ("b_down", b_down, H)):
        if b is not None and b.shape != (n,):
            raise ValueError(f"fused_mlp: {name} must be [{n}]")
    return H, I


def fused_mlp_plain(x, w_up, w_down, *, b_up=None, b_down=None, w_gate=None, b_gate=None,
                    activation: str = "gelu_new") -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 sums over x's dtype)."""
    _check(x, w_up, w_down, b_up, b_down, w_gate, b_gate, activation)
    xf = x.float()
    h = xf @ w_up.float()
    g = None if w_gate is None else xf @ w_gate.float()
    if b_up is not None:  # the JAX kernel adds b_gate only with b_up
        h = h + b_up.float()
        if g is not None and b_gate is not None:
            g = g + b_gate.float()
    a = activate(h, g, activation).to(x.dtype)
    out = (a.float() @ w_down.float()).to(x.dtype)
    return out + b_down if b_down is not None else out


def _entry():
    lib = _build.library("fused_mlp")
    fn = lib.mlio_fused_mlp
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    return lib, fn


# The kernel's block tile (csrc/fused_mlp.cu): 128 rows, a chunk of
# BLOCK_I columns of I, and 256 columns of H a down-product tile; one split-K
# ticket and one fp32 workspace tile per (row tile, H tile).
_BLOCK_M, BLOCK_I, _BLOCK_H = 128, 256, 256


def mlp_work(x, w_up, w_down, *, b_up=None, b_down=None, w_gate=None, b_gate=None, **_):
    """(FLOPs, bytes) for the profiler's count (``ops/cost.py``): the up
    (and gate) and down products; x, the weights and biases read once, the
    output written once."""
    M, (H, I) = x.numel() // x.shape[-1], w_up.shape
    flops = 2 * M * H * I * (3 if w_gate is not None else 2)
    return flops, (cost.tensor_bytes(x, w_up, w_down, b_up, b_down, w_gate, b_gate)
                   + x.numel() * x.element_size())


@cost.counts(mlp_work)
def fused_mlp(x, w_up, w_down, *, b_up=None, b_down=None, w_gate=None, b_gate=None,
              activation: str = "gelu_new") -> torch.Tensor:
    """Fused MLP. x [..., H], w_up (and w_gate) [H, I], w_down [I, H] →
    [..., H] in x's dtype."""
    _build.refuse_grad("fused_mlp (K11)", x, w_up, w_down, b_up, b_down, w_gate, b_gate)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w_up, w_down, b_up=b_up, b_down=b_down, w_gate=w_gate,
                               b_gate=b_gate, activation=activation)
    H, I = _check(x, w_up, w_down, b_up, b_down, w_gate, b_gate, activation)
    extra = [t for t in (b_up, b_down, w_gate, b_gate) if t is not None]
    dev = _build.require_cuda("fused_mlp", x, w_up, w_down, *extra)
    _build.require_bf16("fused_mlp", x=x, w_up=w_up, w_down=w_down, b_up=b_up, b_down=b_down,
                        w_gate=w_gate, b_gate=b_gate)
    x2 = x.reshape(-1, H)
    _build.require_contiguous_aligned("fused_mlp", x=x2, w_up=w_up, w_down=w_down, b_up=b_up,
                                      b_down=b_down, w_gate=w_gate, b_gate=b_gate)
    M = x2.shape[0]
    tiles = -(-M // _BLOCK_M) * -(-H // _BLOCK_H)
    ws = torch.empty(tiles * _BLOCK_M * _BLOCK_H, dtype=torch.float32, device=dev)  # split-K sums
    tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    out = torch.empty((M, H), dtype=x.dtype, device=dev)

    lib, fn = _entry()
    with torch.cuda.device(dev):
        # as in the JAX kernel, b_gate is added only together with b_up
        err = fn(x2.data_ptr(), w_up.data_ptr(), _build.ptr(w_gate), w_down.data_ptr(),
                 _build.ptr(b_up), _build.ptr(b_gate) if b_up is not None else None,
                 _build.ptr(b_down), ws.data_ptr(), tickets.data_ptr(), out.data_ptr(), M, H, I,
                 _ACT_CODE[activation], _build.stream_handle(dev))
    _build.check(lib, err, "fused_mlp")
    fused_mlp.launches += 1
    return out.reshape(x.shape)


fused_mlp.launches = 0
