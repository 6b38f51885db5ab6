"""Profiler wrapper: wall-time stats, ``torch.profiler`` traces and counted
cost (``mlio_tpu/profiling/profiler.py``).

The JAX package times a jitted callable and reads XLA's compiled cost and
memory analyses. The port times the callable with a device
synchronisation after each call, writes an optional Chrome trace of the
timed calls, and counts the work in one extra untimed call
(``ops/cost.py``: FLOPs and bytes of the aten ops, plus each hand-written
kernel's own count). Memory comes from ``torch.cuda``'s allocator stats.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from mlio_tpu_torch.utils.device_utils import get_device_memory_usage


@dataclasses.dataclass
class ProfilerConfig:
    trace_dir: Optional[str] = None     # write a Chrome trace of the timed calls when set
    warmup_steps: int = 2
    active_steps: int = 5
    capture_memory: bool = True
    capture_cost: bool = True           # count FLOPs and bytes in one extra call


@dataclasses.dataclass
class ProfileResults:
    """Timing, cost and memory of a profiled callable."""

    wall_times_s: List[float]
    cost: Dict[str, float]              # flops, bytes accessed, and each kernel's share
    memory: Dict[str, Any]              # device memory stats
    trace_dir: Optional[str] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.wall_times_s)) if self.wall_times_s else 0.0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.wall_times_s, p))

    def summary(self) -> Dict[str, Any]:
        t = np.asarray(self.wall_times_s)
        flops = self.cost.get("flops", 0.0)
        return {
            "mean_ms": float(t.mean() * 1e3) if t.size else 0.0,
            "p50_ms": float(np.percentile(t, 50) * 1e3) if t.size else 0.0,
            "p99_ms": float(np.percentile(t, 99) * 1e3) if t.size else 0.0,
            "flops": flops,
            "bytes_accessed": self.cost.get("bytes accessed", 0.0),
            "tflops_per_s": (flops / t.mean() / 1e12) if (t.size and flops) else 0.0,
            **{f"mem_{k}": v for k, v in self.memory.items()},
        }

    def to_dataframe(self):
        """The summary as a pandas DataFrame of (metric, value) rows."""
        import pandas as pd

        return pd.DataFrame([{"metric": k, "value": v} for k, v in self.summary().items()])

    def top_costs(self, k: int = 10) -> List[tuple]:
        return sorted(self.cost.items(), key=lambda kv: -abs(kv[1]))[:k]

    def save(self, path) -> None:
        """JSON for a ``.json`` path, else a pickle."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.suffix == ".json":
            path.write_text(json.dumps(dataclasses.asdict(self), default=float, indent=2))
        else:
            path.write_bytes(pickle.dumps(self))

    @staticmethod
    def load(path) -> "ProfileResults":
        path = Path(path)
        if path.suffix == ".json":
            return ProfileResults(**json.loads(path.read_text()))
        return pickle.loads(path.read_bytes())


def device_memory_stats(device=None) -> Dict[str, Any]:
    """Bytes of live tensors now and at their peak (``torch.cuda``'s
    allocator: the peak is ``torch.cuda.max_memory_allocated``) and the
    card's total; zeros on the CPU. ``device`` None: the current card when
    there is one."""
    m = get_device_memory_usage(device)
    return {k: m[k] for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}


def tensor_device(tree) -> torch.device:
    """The device of the first tensor in ``tree`` (the card when it holds
    none)."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cuda")


def synchronize(out) -> None:
    """Wait for the work that made ``out`` on every card it lies on."""
    for dev in {t.device for t in tree_leaves(out) if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def trace_activities(device: torch.device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


class ProfilerWrapper:
    """Profile callables: warm-up, timed calls, an optional trace, the cost."""

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self.results: List[ProfileResults] = []

    def profile_function(self, fn: Callable, *args, name: str = "fn") -> ProfileResults:
        """Run ``fn(*args)`` ``warmup_steps`` times, count its work in one
        more call (``cost``: "flops" and "bytes accessed", and each
        hand-written kernel's share as "flops <wrapper>" and "bytes accessed
        <wrapper>"), then time ``active_steps`` calls by the host clock, the
        device synchronised after each (traced into ``trace_dir`` when it is
        set). The device is the first tensor argument's."""
        from mlio_tpu_torch.ops import cost as work

        cfg = self.config
        dev = tensor_device(args)

        def run_once():
            out = fn(*args)
            synchronize(out)
            return out

        for _ in range(cfg.warmup_steps):
            run_once()
        cost: Dict[str, float] = {}
        if cfg.capture_cost:
            with work.counting() as count:
                run_once()
            cost = count.as_cost()
            for kernel, (flops, nbytes) in count.kernels.items():
                cost[f"flops {kernel}"] = flops
                cost[f"bytes accessed {kernel}"] = nbytes
        mem_before = device_memory_stats(dev) if cfg.capture_memory else {}
        times = []
        traced = (torch.profiler.profile(activities=trace_activities(dev)) if cfg.trace_dir
                  else contextlib.nullcontext())
        with traced as prof:
            for _ in range(cfg.active_steps):
                t0 = time.perf_counter()
                run_once()
                times.append(time.perf_counter() - t0)
        if cfg.trace_dir:
            os.makedirs(cfg.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(cfg.trace_dir, f"{name}.pt.trace.json"))
        mem_after = device_memory_stats(dev) if cfg.capture_memory else {}
        memory = {"before": mem_before, "after": mem_after,
                  "delta_bytes": mem_after.get("bytes_in_use", 0)
                  - mem_before.get("bytes_in_use", 0)} if cfg.capture_memory else {}
        res = ProfileResults(wall_times_s=times, cost=cost, memory=memory,
                             trace_dir=cfg.trace_dir, meta={"name": name})
        self.results.append(res)
        return res

    def profile_model(self, params, spec, ids, *, impl=None, name: str = "model"
                      ) -> ProfileResults:
        """A cache-free forward of the model's logits (``Impl()`` by
        default) through :meth:`profile_function`."""
        from mlio_tpu_torch.models.transformer import Impl, forward

        impl = impl or Impl()

        def fn(params, ids):
            with torch.inference_mode():
                return forward(params, spec, ids, impl=impl)[0]

        return self.profile_function(fn, params, ids, name=name)
