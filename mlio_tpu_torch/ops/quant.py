"""Weight quantization (INT8 / INT4 / FP8) and the dequant-fused matmul (K5).

Port of ``mlio_tpu/ops/quant.py``. Weights become :class:`QTensor` leaves
(an int8, packed-int4 or fp8 payload with per-output-channel or, for int4,
per-group scales) and every projection goes through :func:`linear`, which
sends int8 and int4 to :func:`quant_matmul`. That wrapper launches K5, the
CUDA C++ kernel in ``mlio_tpu_torch/csrc/quant_matmul.cu`` which replaces
``_quant_matmul_kernel``, ``_int4_matmul_kernel`` and
``_int4_group_matmul_kernel``: the weights cross device memory quantized and
are widened to bf16 in shared memory; the scales multiply the fp32 sums
(see the source's note for the H100 bound and design).

The quantizers reproduce the JAX package's payloads and scales bit for bit
on the same fp32 weights (``torch.round`` and ``jnp.round`` both round half
to even). They take a stack ``[..., K, N]`` and quantize each ``[K, N]``
matrix on its own, as the JAX package's ``vmap`` does.

The JAX package leaves M <= 32 to an XLA dot, a split measured on the TPU;
the port runs K5 for every M. fp8 stays a plain dequantise-then-matmul, as
the JAX package leaves it to XLA.

W8A8 (a QTensor with ``act_scale``, from
``runtime.quantization.apply_activation_scales``): :func:`w8a8_matmul`
quantizes x with the calibrated static scale and multiplies int8 by int8
into int32 sums, rescaled by ``act_scale * scale``, as the JAX package's
``w8a8_matmul``. The JAX package leaves that product to XLA (a plain
``dot_general``, no Pallas kernel), so on the card ``torch._int_mm``
(cuBLASLt's int8 GEMM) computes it; on the CPU the float64 sums of
:func:`int8_sums_plain`, which are exact.

On CPU tensors :func:`quant_matmul` runs :func:`quant_matmul_plain`; on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mlio_tpu_torch.ops import _build, cost

FP8 = torch.float8_e4m3fn


class QTensor(NamedTuple):
    """Quantized weight: payload ``q`` [..., K, N] (int8), [..., K/2, N]
    (int4 packed as halves) or [..., K, N] (``torch.float8_e4m3fn``) and
    fp32 ``scale`` [..., N] (per output channel) or, for int4, [..., K/g, N]
    (per group of g input rows). ``act_scale`` (fp32: [L] for a stack of L
    layers, one value for one layer's weight) marks an int8 weight whose
    activations are quantized with that static scale (W8A8)."""

    q: torch.Tensor
    scale: torch.Tensor
    fmt: str = "int8"  # "int8" | "int4" | "fp8"
    act_scale: Optional[torch.Tensor] = None

    @property
    def in_features(self) -> int:
        return self.q.shape[-2] * (2 if self.fmt == "int4" else 1)

    @property
    def out_features(self) -> int:
        return self.q.shape[-1]

    def select(self, i) -> "QTensor":
        """Index every field's leading axis (one layer of a stacked weight)."""
        a = None if self.act_scale is None else self.act_scale[i]
        return QTensor(self.q[i], self.scale[i], self.fmt, a)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def divided(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d rounded once on every device. PyTorch's CUDA division by a
    Python number multiplies by its reciprocal, which can land one ulp
    from the quotient the CPU (and the JAX package, eagerly) computes; a
    0-d tensor divisor is divided."""
    return t / t.new_tensor(d)


def _scales(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-channel scales amax / qmax, 1 where a channel is all zero."""
    return torch.where(amax == 0, torch.ones_like(amax), divided(amax, qmax))


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel INT8. w [..., K, N] → QTensor."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = _scales(amax, 127.0)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return QTensor(q, scale, "int8")


def int4_group_size(K: int, group_size: int = 128) -> Optional[int]:
    """Largest power-of-two group <= group_size that divides K/2, so that no
    group straddles the halves split; None when there is none."""
    g = group_size
    while g >= 16:
        if (K // 2) % g == 0:
            return g
        g //= 2
    return None


def _pack_halves(q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int8 in [-7, 7] → [..., K/2, N]: byte i holds row i in its
    low nibble and row i + K/2 in its high nibble."""
    K = q.shape[-2]
    qi = q.to(torch.int32)
    lo = qi[..., : K // 2, :] & 0x0F
    hi = (qi[..., K // 2:, :] & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def quantize_int4(w: torch.Tensor, group_size: Optional[int] = 128) -> QTensor:
    """Symmetric INT4 packed as halves, with group scales [..., K/g, N]
    (g from :func:`int4_group_size`) or, with ``group_size=None`` or no
    viable group, per-channel scales [..., N]."""
    K, N = w.shape[-2:]
    if K % 2:
        raise ValueError(f"quantize_int4: in_features {K} must be even")
    wf = w.float()
    g = int4_group_size(K, group_size) if group_size else None
    if g is None:
        amax = wf.abs().amax(dim=-2)
        scale = _scales(amax, 7.0)
        q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -7, 7)
    else:
        wg = wf.reshape(*wf.shape[:-2], K // g, g, N)
        amax = wg.abs().amax(dim=-2)
        scale = _scales(amax, 7.0)
        q = torch.clamp(torch.round(wg / scale.unsqueeze(-2)), -7, 7).reshape(wf.shape)
    return QTensor(_pack_halves(q.to(torch.int8)), scale, "int4")


def _nibbles(packed: torch.Tensor):
    """Sign-extended (lo, hi) int32 nibbles of a packed int4 payload."""
    wi = packed.to(torch.int32)
    lo = ((wi & 0x0F) ^ 8) - 8
    hi = (((wi >> 4) & 0x0F) ^ 8) - 8
    return lo, hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] packed → [..., K, N] int8 in [-7, 7]."""
    lo, hi = _nibbles(packed)
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def quantize_fp8(w: torch.Tensor) -> QTensor:
    """FP8 (e4m3) with per-channel scales to the format's range (448);
    values below the smallest normal (2^-6) after scaling become 0, as in
    the JAX package."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = _scales(amax, 448.0)
    ws = wf / scale.unsqueeze(-2)
    ws = torch.where(ws.abs() < 2.0 ** -6, torch.zeros_like(ws), ws)
    return QTensor(ws.to(FP8), scale, "fp8")


def quantize(w: torch.Tensor, fmt: str) -> QTensor:
    try:
        fn = {"int8": quantize_int8, "int4": quantize_int4, "fp8": quantize_fp8}[fmt]
    except KeyError:
        raise ValueError(f"unknown quantization format {fmt!r}") from None
    return fn(w)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    """The weight a QTensor stands for, [..., K, N] in ``dtype``. Group
    scales repeat to row granularity; per-channel scales broadcast over K."""
    q = unpack_int4(t.q) if t.fmt == "int4" else t.q
    scale = t.scale.float()
    if t.fmt == "int4" and scale.ndim == q.ndim:
        scale = scale.repeat_interleave(q.shape[-2] // scale.shape[-2], dim=-2)
    elif scale.ndim == q.ndim - 1 and scale.ndim >= 1:
        scale = scale.unsqueeze(-2)
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# K5: the dequant-fused matmul
# ---------------------------------------------------------------------------

def _check_qm_shapes(x, q, scale, fmt):
    K = x.shape[-1]
    if fmt not in ("int8", "int4"):
        raise ValueError(f"quant_matmul: fmt must be int8 or int4, got {fmt!r}")
    if q.ndim != 2 or q.dtype != torch.int8:
        raise ValueError(f"quant_matmul: q must be a 2-D int8 payload, got {tuple(q.shape)} "
                         f"{q.dtype}")
    pack = 2 if fmt == "int4" else 1
    if q.shape[0] * pack != K:
        raise ValueError(f"quant_matmul: q {tuple(q.shape)} ({fmt}) does not match K={K}")
    N = q.shape[1]
    if scale.dtype != torch.float32:
        raise ValueError(f"quant_matmul: scale must be float32, got {scale.dtype}")
    if fmt == "int4" and scale.ndim == 2:
        groups = scale.shape[0]
        if scale.shape[1] != N or groups == 0 or K % groups or (K // 2) % (K // groups) \
                or (K // groups) % 16:
            raise ValueError(f"quant_matmul: group scales {tuple(scale.shape)} must tile each "
                             f"half of K={K} into groups of a multiple of 16 rows")
        return K, N, K // groups
    if scale.shape != (N,):
        raise ValueError(f"quant_matmul: scale must be [{N}], got {tuple(scale.shape)}")
    return K, N, 0


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                       fmt: str = "int8") -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [..., K] @ dequant(q) → [..., N]
    in x's dtype. Products of x (as given) and the integer weights sum in
    fp32; the per-channel scale multiplies the sum (int8, int4), or each
    group's partial sums over its low-nibble and high-nibble rows are scaled
    by their own scale rows and added (int4 with group scales)."""
    K, N, g = _check_qm_shapes(x, q, scale, fmt)
    x2 = x.reshape(-1, K).float()
    if fmt == "int8":
        y = (x2 @ q.float()) * scale
    elif not g:
        lo, hi = _nibbles(q)
        y = (x2[:, : K // 2] @ lo.float() + x2[:, K // 2:] @ hi.float()) * scale
    else:
        lo, hi = _nibbles(q)
        Kh, gh = K // 2, K // 2 // g  # groups per half
        xl = x2[:, :Kh].reshape(-1, gh, g).transpose(0, 1)   # [gh, M, g]
        xh = x2[:, Kh:].reshape(-1, gh, g).transpose(0, 1)
        pl_ = torch.bmm(xl, lo.float().reshape(gh, g, N))    # [gh, M, N]
        ph_ = torch.bmm(xh, hi.float().reshape(gh, g, N))
        y = (pl_ * scale[:gh, None, :] + ph_ * scale[gh:, None, :]).sum(0)
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


def _entry():
    lib = _build.library("quant_matmul")
    fn = lib.mlio_quant_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
    return lib, fn


def qm_work(x, q, scale, *, fmt="int8", **_):
    """(FLOPs, bytes) for the profiler's count (``ops/cost.py``): the
    product; x, the payload and scales read once, the output written once."""
    M, K, N = x.numel() // x.shape[-1], x.shape[-1], q.shape[-1]
    return 2 * M * K * N, cost.tensor_bytes(x, q, scale) + M * N * x.element_size()


@cost.counts(qm_work)
def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 fmt: str = "int8") -> torch.Tensor:
    """x [..., K] @ dequant(q, scale) [K, N] → [..., N] in x's dtype."""
    _build.refuse_grad("quant_matmul (K5)", x, scale)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scale, fmt=fmt)
    dev = _build.require_cuda("quant_matmul", x, q, scale)
    K, N, g = _check_qm_shapes(x, q, scale, fmt)
    _build.require_bf16("quant_matmul", x=x)
    x2 = x.reshape(-1, K)
    _build.require_contiguous_aligned("quant_matmul", x=x2, q=q, scale=scale)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    lib, fn = _entry()
    kind = {"int8": 0, "int4": 1}[fmt]
    with torch.cuda.device(dev):
        err = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K,
                 kind, g, _build.stream_handle(dev))
    _build.check(lib, err, "quant_matmul")
    quant_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


quant_matmul.launches = 0


# ---------------------------------------------------------------------------
# Linear dispatch (dense or quantized)
# ---------------------------------------------------------------------------

def quantize_activations(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """W8A8's activation quantizer, in the JAX package's order: x in fp32
    over the static ``act_scale``, rounded half to even, clipped to ±127,
    int8."""
    s = act_scale.float()
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def int8_sums_plain(x_q: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The int8 x int8 product's sums, x_q [M, K] @ q [K, N], in float64:
    exact, since |sum| <= 127^2 K < 2^53, so the card's int32 sums can be
    held against them bit for bit. Returns float64 [M, N]."""
    return x_q.double() @ q.double()


def w8a8_rescale(sums: torch.Tensor, w: QTensor, dtype) -> torch.Tensor:
    """The sums (int32, or float64 holding integers) in fp32 times
    ``act_scale * scale`` (that product in fp32 first, as the JAX package
    multiplies), cast to ``dtype``. int32 sums widen to fp32 inside the
    product (type promotion: one pass); float64 ones are rounded to fp32
    first, the same fp32 value."""
    if sums.is_floating_point():
        sums = sums.float()
    return (sums * (w.act_scale.float() * w.scale.float())).to(dtype)


def _check_w8a8(x, w):
    if w.fmt != "int8" or w.act_scale is None or w.q.ndim != 2:
        raise ValueError("w8a8_matmul: w must be a 2-D int8 QTensor with act_scale")
    if w.act_scale.numel() != 1:
        raise ValueError(f"w8a8_matmul: act_scale must hold one value (one layer's), got "
                         f"{tuple(w.act_scale.shape)}")
    if x.shape[-1] != w.q.shape[0]:
        raise ValueError(f"w8a8_matmul: x's last axis {x.shape[-1]} does not match "
                         f"q {tuple(w.q.shape)}")


def w8a8_matmul_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """:func:`w8a8_matmul` with the sums of :func:`int8_sums_plain`."""
    _check_w8a8(x, w)
    K, N = w.q.shape
    x_q = quantize_activations(x.reshape(-1, K), w.act_scale)
    return w8a8_rescale(int8_sums_plain(x_q, w.q), w, x.dtype).reshape(*x.shape[:-1], N)


INT_MM_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows


def w8a8_work(x, w, **_):
    """(FLOPs, bytes) for the profiler's count (``ops/cost.py``): the int8
    product; x, the payload and scales read once, the output written once."""
    M, (K, N) = x.numel() // x.shape[-1], w.q.shape
    return 2 * M * K * N, cost.tensor_bytes(x, w) + M * N * x.element_size()


@cost.counts(w8a8_work)
def w8a8_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Static-scale W8A8, x [..., K] @ w → [..., N] in x's dtype: x
    quantized by :func:`quantize_activations`, int8 x int8 summed in int32,
    rescaled by :func:`w8a8_rescale`. On the card the product is
    ``torch._int_mm`` over the payload's [N, K] copy (cuBLASLt's int8 kernels
    run several times faster with the weight operand column-major than over
    the [K, N] payload as it is stored, which K4, K5 and K6 read), with the
    rows of a call of 16 rows or fewer padded with zeros to
    ``INT_MM_MIN_ROWS``; K and N must be multiples of 8. On the CPU the
    float64 sums of :func:`int8_sums_plain`."""
    _check_w8a8(x, w)
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, w)
    dev = _build.require_cuda("w8a8_matmul", x, w.q, w.scale, w.act_scale)
    K, N = w.q.shape
    if K % 8 or N % 8:
        raise ValueError(f"w8a8_matmul: torch._int_mm takes K and N multiples of 8, got "
                         f"K={K}, N={N}")
    x_q = quantize_activations(x.reshape(-1, K), w.act_scale)
    M = x_q.shape[0]
    if M < INT_MM_MIN_ROWS:
        x_q = torch.cat([x_q, x_q.new_zeros(INT_MM_MIN_ROWS - M, K)])
    with torch.cuda.device(dev):
        sums = torch._int_mm(x_q, w.q.t().contiguous().t())[:M]
    w8a8_matmul.launches += 1
    return w8a8_rescale(sums, w, x.dtype).reshape(*x.shape[:-1], N)


w8a8_matmul.launches = 0


def linear(x: torch.Tensor, w, bias=None) -> torch.Tensor:
    """x @ w (+ bias) where w is a tensor or a QTensor: an int8 QTensor
    with ``act_scale`` takes :func:`w8a8_matmul`, int8 and int4 take K5,
    fp8 a plain dequantise-then-matmul in x's dtype. The bias is added in
    x's dtype after the product."""
    if isinstance(w, QTensor):
        if w.act_scale is not None and w.fmt == "int8":
            out = w8a8_matmul(x, w)
        elif w.fmt == "fp8":
            out = x @ dequantize(w, x.dtype)
        else:
            out = quant_matmul(x, w.q, w.scale, fmt=w.fmt)
    else:
        out = x @ w
    return out + bias if bias is not None else out


# ---------------------------------------------------------------------------
# KV-cache quantization (plain functions; the INT8 caches that use them come
# with the int8 decode slice)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric INT8 of K/V rows [..., D] →
    (q int8 [..., D], scale fp32 [...])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(-1)), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(-1)).to(dtype)
