"""Native (C++) host runtime: the block allocator and the continuous-batching
scheduler (``mlio_tpu/native``), the port's own copy.

Between decode dispatches the host's bookkeeping (block accounting, table
assembly, token commit, finish and preemption decisions) is the engine's
serialisation point. ``src/mlio_runtime.cc`` does it in C++17 behind a
plain C interface, driven through ctypes, one C call per engine step, with
the per-slot arrays (block tables, context lengths, current tokens) exposed
as zero-copy numpy views. The policy is :class:`PyScheduler`'s
(``runtime/scheduler.py``), ``plan_multi_step``'s shortage signal included.

Build: ``g++ -std=c++17 -O2 -shared -fPIC`` (or ``c++``/``clang++``) at first
use, into ``build/native/mlio_runtime-<hash of the source>.so`` beside the
repository's other build outputs, through a temporary file and an atomic
rename, so that processes building at once never load a half-written
library. A failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "mlio_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def compiler() -> Optional[str]:
    """The C++ compiler the build takes, or None."""
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"mlio_runtime-{h}.so"


def build() -> Path:
    """Build the library unless this source's build exists; its path. Raises
    RuntimeError with the compiler's message when the build fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("native scheduler: no C++ compiler (g++, c++ or clang++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native scheduler: {cxx} failed to build {SRC.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "mlio_bm_create": ([ctypes.c_int, ctypes.c_int], ctypes.c_void_p),
        "mlio_bm_destroy": ([ctypes.c_void_p], None),
        "mlio_bm_num_free": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_bm_allocate": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_bm_fork": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_bm_free": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_bm_refcount": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_sched_create": ([ctypes.c_int] * 5, ctypes.c_void_p),
        "mlio_sched_destroy": ([ctypes.c_void_p], None),
        "mlio_sched_submit": ([ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int32], ctypes.c_longlong),
        "mlio_sched_admit": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_admitted": ([ctypes.c_void_p], i32p),
        "mlio_sched_slot_prompt": ([ctypes.c_void_p, ctypes.c_int, i32p, ctypes.c_int, i32p],
                                   ctypes.c_int),
        "mlio_sched_slot_req_id": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_longlong),
        "mlio_sched_commit_prefill": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int32],
                                      ctypes.c_int),
        "mlio_sched_commit_prefill_pending": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_sched_resolve_prefill": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int32],
                                       ctypes.c_int),
        "mlio_sched_commit_tokens": ([ctypes.c_void_p, i32p], ctypes.c_int),
        "mlio_sched_plan_multi_step": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "mlio_sched_plan_multi_step_r": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
                                         ctypes.c_int),
        "mlio_sched_tables": ([ctypes.c_void_p], i32p),
        "mlio_sched_ctx": ([ctypes.c_void_p], i32p),
        "mlio_sched_cur": ([ctypes.c_void_p], i32p),
        "mlio_sched_num_active": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_num_queued": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_num_finished": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_num_free_blocks": ([ctypes.c_void_p], ctypes.c_int),
        "mlio_sched_pop_finished": ([ctypes.c_void_p, i32p, ctypes.c_int, i32p],
                                    ctypes.c_longlong),
        "mlio_sched_stats": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library, built at first use. Raises RuntimeError (the
    compiler's message) or OSError when it cannot be built or loaded; a
    failure is remembered and raised again without a second build."""
    global _lib, _error
    if _lib is None:
        if _error is not None:
            raise RuntimeError(_error)
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _error = str(e)
            raise RuntimeError(_error) from e
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def _as_i32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int32))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBlockManager:
    """The C++ block allocator (block 0 is the pinned scratch block)."""

    def __init__(self, num_blocks: int, block_size: int):
        self._lib = load_library()
        self._h = self._lib.mlio_bm_create(num_blocks, block_size)
        self.num_blocks = num_blocks
        self.block_size = block_size

    @property
    def num_free(self) -> int:
        return self._lib.mlio_bm_num_free(self._h)

    def allocate(self) -> int:
        b = self._lib.mlio_bm_allocate(self._h)
        if b < 0:
            raise MemoryError("out of KV-cache blocks")
        return b

    def fork(self, block: int) -> int:
        b = self._lib.mlio_bm_fork(self._h, block)
        if b < 0:
            raise ValueError(f"fork of dead block {block}")
        return b

    def free(self, block: int) -> None:
        if self._lib.mlio_bm_free(self._h, block) < 0:
            raise ValueError(f"double free of block {block}")

    def refcount(self, block: int) -> int:
        return self._lib.mlio_bm_refcount(self._h, block)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mlio_bm_destroy(self._h)
            self._h = None


class NativeScheduler:
    """The C++ continuous-batching scheduler, with
    :class:`~mlio_tpu_torch.runtime.scheduler.PyScheduler`'s interface;
    ``tables``/``ctx``/``cur`` are zero-copy views into C++ memory, valid
    for the scheduler's lifetime (copy them before handing them to a
    device copy that may still be in flight at the next plan)."""

    name = "native"

    def __init__(self, max_batch: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, prefix_caching: bool = True):
        lib = self._lib = load_library()
        self._h = lib.mlio_sched_create(max_batch, num_blocks, block_size, max_blocks_per_seq,
                                        1 if prefix_caching else 0)
        if not self._h:
            raise ValueError("invalid scheduler parameters")
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        n = max_batch * max_blocks_per_seq
        self.tables = np.ctypeslib.as_array(lib.mlio_sched_tables(self._h), (n,)).reshape(
            max_batch, max_blocks_per_seq)
        self.ctx = np.ctypeslib.as_array(lib.mlio_sched_ctx(self._h), (max_batch,))
        self.cur = np.ctypeslib.as_array(lib.mlio_sched_cur(self._h), (max_batch,))
        self._scratch = np.empty(max_blocks_per_seq * block_size + 4096, np.int32)

    def submit(self, prompt, max_new_tokens: int, eos_token: Optional[int] = None) -> int:
        p = _as_i32(prompt)
        rid = self._lib.mlio_sched_submit(self._h, _i32p(p), len(p), max_new_tokens,
                                          -1 if eos_token is None else eos_token)
        if rid < 0:
            raise ValueError("bad request (empty prompt, max_new_tokens < 1, or more blocks "
                             "than a sequence or the pool has)")
        return int(rid)

    def admit(self) -> List[Tuple[int, List[int], int]]:
        """Admit queued requests; [(slot, prompt, num_cached), ...] of the
        slots that now need a prefill."""
        n = self._lib.mlio_sched_admit(self._h)
        if n < 0:
            raise ValueError("request longer than max_blocks_per_seq allows")
        if n == 0:
            return []
        slots = np.ctypeslib.as_array(self._lib.mlio_sched_admitted(self._h), (n,))
        out = []
        cached = np.zeros(1, np.int32)
        for s in slots.tolist():
            ln = self._lib.mlio_sched_slot_prompt(self._h, s, _i32p(self._scratch),
                                                  len(self._scratch), _i32p(cached))
            out.append((s, self._scratch[:ln].tolist(), int(cached[0])))
        return out

    def slot_req_id(self, slot: int) -> int:
        return int(self._lib.mlio_sched_slot_req_id(self._h, slot))

    def commit_prefill(self, slot: int, token: int) -> None:
        if self._lib.mlio_sched_commit_prefill(self._h, slot, token) < 0:
            raise ValueError(f"slot {slot} not active")

    def commit_prefill_pending(self, slot: int) -> None:
        if self._lib.mlio_sched_commit_prefill_pending(self._h, slot) < 0:
            raise ValueError(f"slot {slot} not active")

    def resolve_prefill(self, slot: int, token: int) -> None:
        if self._lib.mlio_sched_resolve_prefill(self._h, slot, token) < 0:
            raise ValueError(f"slot {slot} not active")

    def commit_tokens(self, tokens) -> int:
        t = _as_i32(tokens)
        if len(t) != self.max_batch:
            raise ValueError(f"commit_tokens: {len(t)} tokens for {self.max_batch} slots")
        return self._lib.mlio_sched_commit_tokens(self._h, _i32p(t))

    def plan_multi_step(self, k_max: int, reserve: int = 0) -> int:
        """The multi-step plan (PyScheduler.plan_multi_step): preallocates the
        chunk's blocks and returns its k <= k_max, 0 when no slot is active,
        -1 when even k = 1 is not covered."""
        return self._lib.mlio_sched_plan_multi_step_r(self._h, int(k_max), int(reserve))

    def commit_tokens_multi(self, tokens_steps) -> int:
        done = 0
        for row in np.asarray(tokens_steps, np.int32):
            done += self.commit_tokens(row)
        return done

    @property
    def num_active(self) -> int:
        return self._lib.mlio_sched_num_active(self._h)

    @property
    def num_queued(self) -> int:
        return self._lib.mlio_sched_num_queued(self._h)

    @property
    def num_finished(self) -> int:
        return self._lib.mlio_sched_num_finished(self._h)

    @property
    def num_free_blocks(self) -> int:
        return self._lib.mlio_sched_num_free_blocks(self._h)

    def pop_finished(self) -> Optional[Tuple[int, List[int]]]:
        n = np.zeros(1, np.int32)
        rid = self._lib.mlio_sched_pop_finished(self._h, _i32p(self._scratch),
                                                len(self._scratch), _i32p(n))
        if rid < 0:
            return None
        return int(rid), self._scratch[: int(n[0])].tolist()

    def stats(self) -> dict:
        out = (ctypes.c_longlong * 4)()
        self._lib.mlio_sched_stats(self._h, out)
        return {"preempted": out[0], "prefills": out[1], "generated_tokens": out[2],
                "prefix_hit_blocks": out[3]}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mlio_sched_destroy(self._h)
            self._h = None
