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
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "fused_norm", "decode_attn", "decode_layer", "paged_attn", "paged_stack",
           "quant_matmul", "fused_mlp", "ln_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
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
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
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
            os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


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
