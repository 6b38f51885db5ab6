"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source ``mlio_tpu_torch/csrc/<name>.cu`` becomes one shared library
with a plain C interface, ``build/kernels/<name>-<hash>.so`` under the
repository root. The hash covers that source, the shared headers and the
flags, so an edited source rebuilds and an unchanged tree reuses its
libraries. Nothing builds at import: a wrapper's first launch builds its
library, and :func:`build_all` builds every library at once, one ``nvcc``
process per source, all started together.

The libraries link the CUDA runtime statically and run in the primary
context that PyTorch also uses, so kernels launch on PyTorch's current
stream. Each C entry point returns ``cudaGetLastError()``; :func:`check`
raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "fused_norm", "decode_attn", "decode_layer", "decode_layer_kv8",
           "paged_attn", "paged_stack",
           "quant_matmul", "fused_mlp", "ln_matmul", "decode_tiled_bf16", "decode_tiled_int8",
           "decode_tiled_fp8", "decode_tiled_d256", "dma_bench", "fp8_convert", "flash_bwd",
           "flash_stream", "flash_fwd_d256")
# -Xptxas -v only reports each kernel's registers, stack and spills (kept in
# BUILD_LOGS, summarised by ptxas_summary); it does not change the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # nvcc's output of each source built by this process
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))  # the toolkit's default prefix
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
                       "the kernels in mlio_tpu_torch/csrc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    src = CSRC / f"{name}.cu"
    # a source may include another source (decode_layer_kv8.cu: decode_layer.cu)
    included = [CSRC / n for n in re.findall(r'#include "(\w+\.cu)"', src.read_text())]
    for f in [src, *included, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build the named libraries that are missing, all ``nvcc`` runs in
    parallel. Returns the wall seconds spent; raises with nvcc's output if
    any build fails."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            BUILD_LOGS[name] = log
            os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def ptxas_summary() -> Dict[str, dict]:
    """Per source built by this process, from ptxas's report: the range of
    registers a thread over its kernel instances, the largest stack frame
    (bytes), and the instances that spill with their spill-store bytes (by
    mangled name)."""
    out = {}
    for name, log in BUILD_LOGS.items():
        regs, frames, spills, kernel = [], [], {}, None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            if m:
                frames.append(int(m.group(1)))
                if int(m.group(2)):
                    spills[kernel] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
        if regs:
            out[name] = dict(instances=len(regs), registers=[min(regs), max(regs)],
                             max_stack_frame=max(frames, default=0), spill_store_bytes=spills)
    return out


def ptxas_functions(name: str) -> Dict[str, dict]:
    """Per function of source ``name`` built by this process, from ptxas's
    report: its stack frame and spill-store bytes and, for a kernel (an
    entry function), its registers a thread. Keys are the mangled names."""
    out, fn, entry = {}, None, None
    for line in BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and fn:
            out[fn].update(stack_frame=int(m.group(1)), spill_store_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.mlio_error_string.argtypes = [ctypes.c_int]
            lib.mlio_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


# The decode megakernels' weight tensor maps (K4/K8's mlio_*_stack_maps, K6's
# mlio_decode_tiled_maps), built once per set of weight tensors: the last
# MAPS_KEEP keys' (a model's, a copy's, the checks' variants) are kept.
_maps: Dict[tuple, ctypes.Array] = {}
MAPS_KEEP = 16


def tensor_maps(key: tuple, nbytes: int, fill: Callable[[ctypes.Array], int],
                lib: ctypes.CDLL, what: str) -> ctypes.Array:
    """The maps cached under ``key`` (the kernel and every field the maps
    encode: the weights' addresses, shapes and formats), else a new buffer
    of ``nbytes`` that ``fill(buffer)`` writes (a C entry's error code,
    raised on)."""
    maps = _maps.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(nbytes)
        check(lib, fill(maps), what)
        if len(_maps) >= MAPS_KEEP:
            _maps.pop(next(iter(_maps)))
        _maps[key] = maps
    return maps


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.mlio_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device; returns it."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on a CUDA device or the CPU, "
                         f"got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must lie on {dev}, got {t.device}")
    return dev


def require_bf16(name: str, **tensors) -> None:
    """Each tensor given bf16: the kernels are built for that dtype only."""
    for arg, t in tensors.items():
        if t is not None and t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bfloat16 on CUDA, got {t.dtype}")


def require_contiguous_aligned(name: str, **tensors) -> None:
    """Each tensor given (None is skipped) contiguous and 16-byte aligned,
    as the kernels' 16-byte vector accesses need."""
    for arg, t in tensors.items():
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


_DENSE = ("train with the dense Impl: Impl(attention='flash' or 'dense') with norm='dense', "
          "mlp='dense', fused_ln_qkv=False and unquantized weights, and no KV cache")


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):  # QTensor is a NamedTuple
        for v in obj:
            yield from _tensors(v)


def refuse_grad(name: str, *args, hint: str = _DENSE) -> None:
    """Raise where autograd would need a gradient through a kernel that has
    none: grad mode is on and a floating tensor among ``args`` (searched
    through dicts, lists and tuples) requires grad. The JAX package cannot
    differentiate these Pallas kernels either; on the card the output would
    be detached and the gradient silently wrong."""
    if not torch.is_grad_enabled():
        return
    for t in _tensors(args):
        if t.is_floating_point() and t.requires_grad:
            raise RuntimeError(f"{name} has no backward, as in the JAX package (its Pallas "
                               f"kernel has no VJP); {hint}")


def ptr(t):
    """A tensor's device address for a C entry point; 0 (null) for None."""
    return None if t is None else t.data_ptr()


def check_kv_scales(name: str, k: torch.Tensor, v: torch.Tensor, k_scale, v_scale) -> bool:
    """Whether k/v are an INT8 cache: then both are int8 and both fp32 scales
    are given with k's shape less its head dim; otherwise neither scale is
    given and k/v are not int8. Raises on anything else."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: give both K and V scales or neither")
    if k_scale is None:
        if k.dtype == torch.int8 or v.dtype == torch.int8:
            raise ValueError(f"{name}: an int8 K/V cache needs its scales")
        return False
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{name}: K/V scales go with an int8 cache, got {k.dtype}, {v.dtype}")
    for arg, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.shape != k.shape[:-1] or s.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be fp32 {tuple(k.shape[:-1])}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    return True
