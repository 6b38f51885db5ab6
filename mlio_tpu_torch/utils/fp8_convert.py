"""The weight-widening probe (K15): the counterpart of
``exp_fp8_convert.py``'s ``_kernel``.

``out [8, C] = sum_j x [8, R] @ widen(w_j) [R, C]`` in fp32 over the n
chunks of ``w [n, R, C]``, int8 or fp8 e4m3, by one of four widenings
(:data:`VARIANTS`, ``_convert``'s): ``int8``; ``fp8``, the card's
e4m3x2 -> f16x2 convert (the one K6 uses); ``fp8-f32``, one e4m3 at a time
through fp32; ``fp8-bits``, integer bit assembly (right for zero and the
normals; a subnormal comes out as a normal with a zero exponent field, as
in the script). The kernel (``mlio_tpu_torch/csrc/fp8_convert.cu``) streams the
weights through K6's own product loop, so its rate is what K6's int8 and
fp8 GEMVs can reach at batch 8 with their widening and CUDA-core FMAs.

On CPU tensors :func:`widen_matmul` runs :func:`widen_matmul_plain`; on
CUDA tensors it launches the kernel or raises. Run on the card as

    python -m mlio_tpu_torch.utils.fp8_convert [int8 fp8 fp8-f32 fp8-bits]

which checks each variant against its plain version over a seeded 1 GB
slab, times it by the two-length marginal (2 and 6 passes) and prints a
line a variant, in the JAX script's manner, with the rate beside the best
checked rate of the probe K14 (``utils/dma_bench.py``).
"""
from __future__ import annotations

import ctypes
import statistics
import sys
from typing import Optional, Sequence

import torch

from mlio_tpu_torch.ops import _build
from mlio_tpu_torch.ops.quant import FP8
from mlio_tpu_torch.utils import dma_bench as db

VARIANTS = ("int8", "fp8", "fp8-f32", "fp8-bits")
R, C = 2048, 2048  # a chunk: 4 MB of int8 or e4m3 (exp_fp8_convert.py)
N_CHUNKS = 256     # 1 GB
ROWS = 8           # rows of x
FP32_FLOPS = 67e12  # the data sheet's CUDA-core fp32 rate (H100 SXM), FMA = 2
BLOCKS_PER_SM = 2  # the reduction's split on the card
SHORT, LONG = 2, 6  # passes of the two-length marginal (exp_fp8_convert.py)
_CODES = {v: i + 1 for i, v in enumerate(VARIANTS)}


def storage_dtype(variant: str) -> torch.dtype:
    return torch.int8 if variant == "int8" else FP8


def widen_plain(w: torch.Tensor, variant: str) -> torch.Tensor:
    """``_convert(w, variant)``: the stored weights as bf16. fp8-bits
    assembles the bf16 bits from the byte (sign; exponent and mantissa +
    960 << 4): right for zero and the normals, a subnormal read as a normal
    with a zero exponent field, as the script's bit assembly reads it."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    if variant in ("int8", "fp8"):
        return w.to(torch.bfloat16)
    if variant == "fp8-f32":
        return w.float().to(torch.bfloat16)
    u = w.view(torch.uint8).to(torch.int32)
    rest = u & 0x7F
    bits = torch.where(rest == 0, torch.zeros_like(u), ((u & 0x80) << 8) | ((rest + 960) << 4))
    bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)  # as a signed 16-bit word
    return bits.to(torch.int16).view(torch.bfloat16)


def widen_matmul_plain(x: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """``_kernel``'s function chunk by chunk: sum_j x @ widen(w_j), fp32."""
    acc = torch.zeros((x.shape[0], w.shape[2]), dtype=torch.float32, device=x.device)
    xf = x.float()
    for j in range(w.shape[0]):
        acc += xf @ widen_plain(w[j], variant).float()
    return acc


def _entry():
    lib = _build.library("fp8_convert")
    fn = lib.mlio_fp8_convert
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, ctypes.c_longlong, i, i, p, p, p, i, p]
        fn.restype = i
    return lib, fn


def widen_matmul(x: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """out [8, C] fp32 = sum_j x [8, R] @ widen(w_j) for w [n, R, C] (int8
    for ``int8``, ``torch.float8_e4m3fn`` for the fp8 variants) and x bf16.
    On the card the reduction splits over :data:`BLOCKS_PER_SM` blocks an
    SM."""
    if variant not in VARIANTS:
        raise ValueError(f"widen_matmul: unknown variant {variant!r} (one of {VARIANTS})")
    if w.ndim != 3 or x.ndim != 2 or x.shape != (ROWS, w.shape[1]):
        raise ValueError(f"widen_matmul: x must be [{ROWS}, R] and w [n, R, C], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != storage_dtype(variant):
        raise ValueError(f"widen_matmul: {variant} weights must be {storage_dtype(variant)}, "
                         f"got {w.dtype}")
    if x.device.type == "cpu":
        return widen_matmul_plain(x, w, variant)
    dev = _build.require_cuda("widen_matmul", x, w)
    _build.require_bf16("widen_matmul", x=x)
    _build.require_contiguous_aligned("widen_matmul", x=x, w=w)
    n, r, c = w.shape
    if c % 8 or c > 2048 or r > 2048 or r <= 8 * (256 // (c // 8)):
        raise ValueError(f"widen_matmul: the kernel takes C a multiple of 8 up to 2048 and R up "
                         f"to 2048, above its rows in flight; got R {r}, C {c}")
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * BLOCKS_PER_SM
    out = torch.empty((ROWS, c), dtype=torch.float32, device=dev)
    part = torch.empty((blocks, ROWS, c), dtype=torch.float32, device=dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(_CODES[variant], w.data_ptr(), n * r, r, c, x.data_ptr(), out.data_ptr(),
                 part.data_ptr(), blocks, _build.stream_handle(dev))
    _build.check(lib, err, "widen_matmul")
    widen_matmul.launches += 1
    return out


widen_matmul.launches = 0


def draw_weights(variant: str, n: int, r: int, c: int, generator: torch.Generator) -> torch.Tensor:
    """Seeded weights [n, r, c] on the generator's device, a chunk at a
    time: int8 uniform over [-127, 127]; e4m3 bytes uniform over zero and the
    normals (never NaN, 0x7F / 0xFF, nor a subnormal, which fp8-bits
    misreads)."""
    dev = generator.device
    w = torch.empty((n, r, c), dtype=storage_dtype(variant), device=dev)
    if variant == "int8":
        for j in range(n):
            w[j].random_(-127, 128, generator=generator)
        return w
    e = torch.arange(256, device=dev)
    exp, man = (e >> 3) & 0xF, e & 7
    valid = ((exp > 0) & ~((exp == 15) & (man == 7))) | ((e & 0x7F) == 0)
    table = e[valid].to(torch.uint8)
    raw = w.view(torch.uint8)
    for j in range(n):
        idx = torch.randint(0, table.numel(), (r, c), generator=generator, device=dev)
        raw[j] = table[idx]
    return w


def marginal_ms(fn) -> float:
    """The device ms of one call by the two-length marginal of
    ``exp_fp8_convert.py``: (time of LONG calls - time of SHORT) /
    (LONG - SHORT), CUDA events; the median of K14's ``ROUNDS`` (the
    script takes the best, which one slow short run can make too fast)."""
    return statistics.median((db.event_ms(fn, LONG) * LONG - db.event_ms(fn, SHORT) * SHORT)
                             / (LONG - SHORT) for _ in range(db.ROUNDS))


def check(x, w, variant: str, atol: float, rtol: float):
    """(kernel out, plain out, max-abs error); raises where the kernel lies
    outside atol + rtol * |plain| or is not finite."""
    got = widen_matmul(x, w, variant)
    want = widen_matmul_plain(x, w, variant)
    err = (got - want).abs()
    if not (torch.isfinite(got).all() and bool((err <= atol + rtol * want.abs()).all())):
        raise AssertionError(f"widen_matmul {variant}: the kernel disagrees with its plain "
                             f"version (max_abs_err {err.max().item()})")
    return got, want, err.max().item()


# K15 sums 524,288 products into each fp32 output, in blocks and then over
# blocks, in another order than its plain version's per-chunk matmuls: with
# the seeded 1 GB slab |out| reaches about 3e5, and the two lay 0.17-0.31
# apart on the card (NVIDIA H100 80GB HBM3, 700 W); a chunk left out or
# changed moved an output by 1.3e4 or more there.
ATOL, RTOL = 2.0, 1e-5


def main(argv: Optional[Sequence[str]] = None) -> int:
    variants = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("fp8_convert: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    rate, rate_from = db.best_rate(db.probe(dev))
    print(f"K14's best checked rate: {rate / 1e9:.1f} GB/s ({rate_from})", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((ROWS, R), generator=gen, device=dev).to(torch.bfloat16)
    slabs = {}
    for v in variants:
        kind = storage_dtype(v)
        if kind not in slabs:
            slabs[kind] = draw_weights(v, N_CHUNKS, R, C, gen)
        w = slabs[kind]
        check(x, w, v, ATOL, RTOL)
        ms = marginal_ms(lambda: widen_matmul(x, w, v))
        gbs = w.numel() / (ms * 1e-3) / 1e9
        b_ms, b_by = db.bound_ms(w.numel() + x.numel() * 2 + ROWS * C * 4,
                                 2 * ROWS * w.numel(), rate, FP32_FLOPS)
        print(f"{v:9s}: {ms:8.4f} ms/GB-pass  ({gbs:7.1f} GB/s eff, {gbs * 1e9 / rate:.3f} of "
              f"K14's rate; bound {b_ms:.4f} ms by {b_by})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
