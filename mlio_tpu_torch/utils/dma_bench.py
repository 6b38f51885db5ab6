"""The H100 bandwidth probe (K14): the counterparts of ``dma_bench.py``'s
``_auto_kernel`` and ``_manual_kernel``.

Both streams read ``w [n, 512, C]`` bf16 (chunks of ``512 * C * 2`` bytes)
and give ``[8, 128]`` fp32: :func:`auto_stream` the sum over chunks of
``w[i, :8, :128]`` plus ``x`` once a chunk, :func:`manual_stream` the same
sum plus ``x`` once. The kernels (``mlio_tpu_torch/csrc/dma_bench.cu``)
read every byte of w: the auto stream with 16-byte loads from every block,
the manual one with ``cp.async.bulk`` copies into a depth-N shared-memory
ring a block, completed on ``mbarrier``\\ s. They compute the corners' sum
from the bytes they stream, and beside it a checksum of every word they
read (:func:`checksum_plain`), so a stream that skips or repeats a slice
fails its check. :func:`probe` checks each configuration and times it on
the card by the two-length marginal; the fastest, or a ``copy_`` where
that is faster, gives the rate the port's byte bounds divide by.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import statistics
from typing import Dict, Optional, Sequence, Tuple

import torch

from mlio_tpu_torch.ops import _build

ROWS = 512  # rows of a chunk, as dma_bench.py's R


def chunk_cols(chunk_mb: int) -> int:
    """C of a chunk of ``chunk_mb`` MB (``dma_bench.py``: R * C * 2 bytes)."""
    return (chunk_mb << 20) >> 10


def auto_stream_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``_auto_kernel``'s function: sum_i (w[i, :8, :128] + x)."""
    return w[:, :8, :128].float().sum(0) + w.shape[0] * x.float().reshape(())


def manual_stream_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``_manual_kernel``'s function: sum_i w[i, :8, :128] + x."""
    return w[:, :8, :128].float().sum(0) + x.float().reshape(())


def checksum_plain(w: torch.Tensor) -> int:
    """The streams' checksum of w: the sum over w's 32-bit words j (in
    memory order) of word_j * (j + 1), mod 2^32."""
    words = w.contiguous().reshape(-1).view(torch.int32)
    total, step = 0, 1 << 26
    for s in range(0, words.numel(), step):
        t = words[s:s + step].to(torch.int64) & 0xFFFFFFFF
        j = torch.arange(s + 1, s + 1 + t.numel(), dtype=torch.int64, device=t.device)
        total = (total + int(((t * j) & 0xFFFFFFFF).sum())) & 0xFFFFFFFF
    return total


def _entry():
    lib = _build.library("dma_bench")
    fn = lib.mlio_dma_bench
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, i, p, p, p, p, i, i, i, p]
        fn.restype = i
    return lib, fn


def _launch(kind: int, w, x, depth, slice_bytes, streams):
    name = ("auto_stream", "manual_stream")[kind]
    dev = _build.require_cuda(name, w, x)
    if w.ndim != 3 or w.shape[1] != ROWS or w.shape[2] % 128 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: w must be bf16 [n, {ROWS}, C] with C a multiple of 128")
    if x.numel() != 1 or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be one fp32 value")
    if streams < 1 or (kind == 0 and depth not in (4, 8)):
        raise ValueError(f"{name}: streams must be positive and loads in flight 4 or 8")
    if kind == 1 and (depth < 1 or slice_bytes % 256 or not 0 < slice_bytes <= ROWS * w.shape[2] * 2
                      or (w.numel() * 2) % slice_bytes):
        raise ValueError(f"{name}: slices of {slice_bytes} bytes must be multiples of 256, at "
                         f"most a chunk, and divide the stream's {w.numel() * 2} bytes")
    _build.require_contiguous_aligned(name, w=w)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    checksum = torch.empty(1, dtype=torch.int32, device=dev)
    grid = torch.cuda.get_device_properties(dev).multi_processor_count * streams
    work = torch.empty(grid * (8 * 128 + 1), dtype=torch.float32, device=dev)
    lib, fn = _entry()
    with torch.cuda.device(dev):
        err = fn(kind, w.data_ptr(), w.shape[0], w.shape[2], x.data_ptr(), out.data_ptr(),
                 checksum.data_ptr(), work.data_ptr(), depth, slice_bytes, streams,
                 _build.stream_handle(dev))
    _build.check(lib, err, name)
    return out, checksum


def _plain(out: torch.Tensor, w: torch.Tensor):
    return out, torch.tensor([checksum_plain(w)], dtype=torch.int64).to(torch.int32)


def auto_stream(w: torch.Tensor, x: torch.Tensor, *, loads: int = 4,
                streams: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The auto stream over w [n, 512, C] bf16 with x (one fp32 value):
    ``streams`` blocks an SM, ``loads`` (4 or 8) 16-byte loads in flight a
    thread. Returns (o [8, 128] fp32, the checksum as one int32)."""
    if w.device.type == "cpu":
        return _plain(auto_stream_plain(w, x), w)
    out = _launch(0, w, x, loads, 0, streams)
    auto_stream.launches += 1
    return out


def manual_stream(w: torch.Tensor, x: torch.Tensor, *, depth: int = 4,
                  slice_bytes: int = 32 << 10,
                  streams: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The manual stream: ``depth`` bulk copies of ``slice_bytes`` in flight
    a block, ``streams`` blocks an SM. Returns (o [8, 128] fp32, the
    checksum as one int32)."""
    if w.device.type == "cpu":
        return _plain(manual_stream_plain(w, x), w)
    out = _launch(1, w, x, depth, slice_bytes, streams)
    manual_stream.launches += 1
    return out


auto_stream.launches = 0
manual_stream.launches = 0

# (name, kind, chunk MB, depth, slice bytes, blocks an SM): the configurations
# the probe checks and times. The auto stream's depth is its 16-byte loads in
# flight a thread; the manual stream's, its ring slots a block.
CONFIGS: Sequence[Tuple[str, str, int, int, int, int]] = (
    ("auto_1mb", "auto", 1, 4, 0, 2),
    ("auto_4mb", "auto", 4, 4, 0, 2),
    ("auto_4mb_u8", "auto", 4, 8, 0, 2),
    ("auto_4mb_x4", "auto", 4, 4, 0, 4),
    ("manual_d2_32k", "manual", 4, 2, 32 << 10, 1),
    ("manual_d4_32k", "manual", 4, 4, 32 << 10, 1),
    ("manual_d6_32k", "manual", 4, 6, 32 << 10, 1),
    ("manual_d3_64k", "manual", 4, 3, 64 << 10, 1),
    ("manual_d4_16k_x2", "manual", 4, 4, 16 << 10, 2),
)


def run_config(config, w: torch.Tensor, x: torch.Tensor):
    """One launch of ``config`` (an entry of :data:`CONFIGS`) over w."""
    _, kind, _, depth, slice_bytes, streams = config
    if kind == "auto":
        return auto_stream(w, x, loads=depth, streams=streams)
    return manual_stream(w, x, depth=depth, slice_bytes=slice_bytes, streams=streams)


def event_ms(fn, reps: int) -> float:
    """Device ms a call of fn, by CUDA events over ``reps`` calls after one
    warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Alternating (short, long) rounds of the two-length marginal; the median is
# kept, since one slow short run alone can read faster than the HBM streams.
ROUNDS = 3


def probe(device, total_bytes: int = 4 << 30, buf: Optional[torch.Tensor] = None,
          reps: int = 5, atol: float = 1e-4, rtol: float = 1e-4) -> Dict[str, dict]:
    """Each stream of :data:`CONFIGS`, checked and timed on the card over
    ``buf`` (bf16, at least 2 * total_bytes bytes, seeded data; None: a
    fresh one of ones).

    First the check, over the short stream (``total_bytes``) and the long
    one (twice that): o within atol + rtol * |plain| of the plain version
    and the checksum equal to :func:`checksum_plain`'s. Then GB/s by the
    two-length marginal: the device ms of a launch over each length, CUDA
    events over ``reps`` launches each, in :data:`ROUNDS` alternating
    rounds; GB/s = total_bytes / the median of (ms_long - ms_short), with
    the medians of ms_short and ms_long beside it. A configuration that
    fails its check raises. Also a
    ``torch.Tensor.copy_`` of the short stream's bytes into a second buffer
    (``copy``: GB/s counting its reads and writes; the copy is held equal
    to its source)."""
    if buf is None:
        buf = torch.ones(total_bytes, dtype=torch.bfloat16, device=device)  # 2 x total_bytes
    x = torch.full((1,), 0.5, dtype=torch.float32, device=device)
    sums = {}  # the plain checksum by the stream's length (every view starts at buf[0])
    out = {}
    for config in CONFIGS:
        name, kind, chunk_mb, depth, slice_bytes, streams = config
        C = chunk_cols(chunk_mb)
        n = total_bytes // (ROWS * C * 2)
        short = buf[: n * ROWS * C].view(n, ROWS, C)
        long_ = buf[: 2 * n * ROWS * C].view(2 * n, ROWS, C)
        plain = auto_stream_plain if kind == "auto" else manual_stream_plain
        errs = {}
        for label, w in (("short", short), ("long", long_)):
            got, checksum = run_config(config, w, x)
            want = plain(w, x)
            err = (got - want).abs()
            if not (torch.isfinite(got).all() and bool((err <= atol + rtol * want.abs()).all())):
                raise AssertionError(f"probe {name} ({label}): o disagrees with the plain "
                                     f"version (max_abs_err {err.max().item()})")
            if w.numel() not in sums:
                sums[w.numel()] = checksum_plain(w)
            got_sum = int(checksum.item()) & 0xFFFFFFFF
            if got_sum != sums[w.numel()]:
                raise AssertionError(f"probe {name} ({label}): checksum {got_sum:#x} != plain "
                                     f"{sums[w.numel()]:#x}")
            errs[label] = err.max().item()
        pairs = [(event_ms(lambda: run_config(config, short, x), reps),
                  event_ms(lambda: run_config(config, long_, x), reps)) for _ in range(ROUNDS)]
        ms_short, ms_long = (statistics.median(p[i] for p in pairs) for i in (0, 1))
        marginal = statistics.median(lg - sh for sh, lg in pairs)
        nbytes = short.numel() * 2
        out[name] = dict(kind=kind, chunk_mb=chunk_mb, depth=depth, slice_bytes=slice_bytes,
                         streams=streams, bytes_short=nbytes, ms_short=ms_short,
                         ms_long=ms_long, max_abs_err=errs, checksum_equal=True,
                         gb_per_s=nbytes / (marginal * 1e-3) / 1e9)
    src = buf[: total_bytes // 2]
    dst = torch.empty_like(src)
    ms = event_ms(lambda: dst.copy_(src), reps)
    if not torch.equal(dst, src):
        raise AssertionError("probe copy: the copy differs from its source")
    out["copy"] = dict(bytes=2 * src.numel() * 2, ms=ms,
                       gb_per_s=2 * src.numel() * 2 / (ms * 1e-3) / 1e9)
    del dst
    return out


def best_rate(res: Dict[str, dict]) -> Tuple[float, str]:
    """(bytes/s, its name): the highest rate in :func:`probe`'s result,
    the best stream's or the copy's (counting its reads and writes)."""
    name = max(res, key=lambda k: res[k]["gb_per_s"])
    return res[name]["gb_per_s"] * 1e9, name


def bound_ms(nbytes: float, ops: float, bytes_per_s: float, ops_per_s: float) -> Tuple[float, str]:
    """(ms, what bounds it): the least time for work that moves ``nbytes``
    and does ``ops`` operations, the larger of the bytes over ``bytes_per_s``
    and the operations over ``ops_per_s``."""
    t_bytes, t_ops = nbytes / bytes_per_s, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
