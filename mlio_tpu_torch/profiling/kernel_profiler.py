"""Per-kernel profiler: a ``torch.profiler`` trace → a per-op time table
(``mlio_tpu/profiling/kernel_profiler.py``).

:meth:`KernelProfiler.profile_function` traces a callable's calls with
``torch.profiler`` and builds the table from the Chrome trace with
``profiling/trace.py``: one row a kernel (the port's hand-written kernels
under their CUDA symbol names), or a top-level host op on the CPU.
:meth:`KernelProfiler.profile_segments` times caller-named segments by the
two-length marginal instead, with CUDA events on the card, and gives the
same table shape.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from mlio_tpu_torch.profiling.profiler import synchronize, tensor_device, trace_activities
from mlio_tpu_torch.profiling.trace import OpStats, OpTable, op_table_from_trace

__all__ = ["KernelProfiler", "KernelProfileResults"]


@dataclasses.dataclass
class KernelProfileResults:
    """The per-op table of a profiled callable, its wall time a step and
    where the table came from."""

    table: OpTable
    wall_time_s: float = 0.0
    steps: int = 1
    source: str = "trace"               # "trace" | "segments"

    @property
    def ops(self) -> List[OpStats]:
        return self.table.ops

    def top(self, k: int = 10) -> List[OpStats]:
        return self.table.top(k)

    def slow_ops(self, threshold_us: float = 0.0, min_pct: float = 0.0) -> List[OpStats]:
        return self.table.slow_ops(threshold_us, min_pct)

    def op_time_fraction(self) -> float:
        """Fraction of wall time covered by summed op time (well below 1:
        the step is dominated by launch gaps and host work)."""
        if not self.wall_time_s:
            return 0.0
        return min(1.0, self.table.total_us / 1e6 / self.wall_time_s)

    def summary(self, k: int = 10) -> str:
        head = self.table.summary(k)
        if self.wall_time_s:
            head += (f"\nwall={self.wall_time_s * 1e3:.3f}ms covered="
                     f"{self.op_time_fraction():.0%} source={self.source}")
        return head

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame([dataclasses.asdict(o) for o in self.ops])

    def to_json(self) -> dict:
        return {"wall_time_s": self.wall_time_s, "steps": self.steps, "source": self.source,
                **self.table.to_json()}


class KernelProfiler:
    """Profile a callable down to its kernels."""

    def __init__(self, warmup: int = 2, steps: int = 5, trace_dir: Optional[str] = None):
        self.warmup = warmup
        self.steps = steps
        self.trace_dir = trace_dir

    def profile_function(self, fn: Callable, *args, device_substr: Optional[str] = None
                         ) -> Optional[KernelProfileResults]:
        """Run ``fn(*args)`` ``warmup`` times, then trace ``steps`` calls
        (each followed by a device synchronisation) into a Chrome trace under
        ``trace_dir`` (a new temporary directory when None) and build the
        per-op table from it. ``wall_time_s`` is the host clock a step.
        Returns None when the trace holds no op."""
        def run_once():
            synchronize(fn(*args))

        for _ in range(self.warmup):
            run_once()
        trace_dir = self.trace_dir or tempfile.mkdtemp(prefix="mlio_ktrace_")
        with torch.profiler.profile(activities=trace_activities(tensor_device(args))) as prof:
            t0 = time.perf_counter()
            for _ in range(self.steps):
                run_once()
            wall = (time.perf_counter() - t0) / self.steps
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "kernels.pt.trace.json")
        prof.export_chrome_trace(path)
        table = op_table_from_trace(path, device_substr)
        if table is None or not table.ops:
            return None
        return KernelProfileResults(table=table, wall_time_s=wall, steps=self.steps,
                                    source="trace")

    def profile_segments(self, segments: Dict[str, Callable], lo: int = 32, hi: int = 160,
                         reps: int = 3, device="cuda") -> KernelProfileResults:
        """Per-segment time where no trace is wanted: each segment's
        ``make(n)`` returns a thunk running its piece n times and waiting for
        it; the two-length marginal ``(T(hi) - T(lo)) / (hi - lo)`` (the best
        of ``reps``) cancels launch and set-up costs. Timed by CUDA events on
        ``device`` when it is a card, by the host clock on the CPU."""
        dev = torch.device(device)
        stats: List[OpStats] = []
        for name, make in segments.items():
            f_lo, f_hi = make(lo), make(hi)
            f_lo()
            f_hi()
            best = float("inf")
            for _ in range(reps):
                best = min(best, (_seconds(f_hi, dev) - _seconds(f_lo, dev)) / (hi - lo))
            stats.append(OpStats(name=name, count=reps * (lo + hi), total_us=best * 1e6,
                                 avg_us=best * 1e6, pct=0.0, line="segments"))
        total = sum(o.total_us for o in stats) or 1.0
        for o in stats:
            o.pct = 100.0 * o.total_us / total
        stats.sort(key=lambda o: -o.total_us)
        label = f"GPU {dev.index or 0}" if dev.type == "cuda" else "CPU"
        return KernelProfileResults(table=OpTable(device=label, total_us=total, ops=stats),
                                    wall_time_s=total / 1e6, steps=1, source="segments")


def _seconds(thunk: Callable, dev: torch.device) -> float:
    """Seconds of one call of ``thunk``: CUDA events around it on a card,
    the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        thunk()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        start.record()
        thunk()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3
