"""Per-op device-time tables from ``torch.profiler`` traces
(``mlio_tpu/profiling/xplane.py``).

The JAX package decodes XLA's xplane protobufs. On the GPU the ground truth
is the Chrome-trace JSON that ``torch.profiler`` writes
(``prof.export_chrome_trace(path)``, or a ``tensorboard_trace_handler``
directory of ``*.pt.trace.json`` files): Kineto's ``traceEvents``, complete
events (``"ph": "X"``) with microsecond ``ts`` and ``dur``. Device rows come
from the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events, one line a
CUDA stream. A trace with no device events (a CPU run) falls back to the
host's top-level ``cpu_op`` events, those not nested in another op of their
thread, as the JAX reader falls back to the host plane.

Kernels launched through ``ctypes`` (the port's hand-written ones) appear
under their CUDA symbol names as Kineto demangles them; the table names
them as they are. :func:`device_busy_ms` is the union of the device
intervals, the time the card was busy.
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "OpStats",
    "OpTable",
    "parse_trace",
    "latest_trace_path",
    "device_events",
    "host_op_events",
    "device_busy_ms",
    "op_table_from_events",
    "op_table_from_trace",
]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


# ---------------------------------------------------------------------------
# Reading a trace


def parse_trace(path: str) -> List[dict]:
    """The complete events (``"ph": "X"``) of a Chrome-trace JSON file
    (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]


def latest_trace_path(trace_dir: str) -> Optional[str]:
    """Newest Chrome trace (``*.json``, ``*.json.gz``) under ``trace_dir``."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def device_events(events: Iterable[dict]) -> List[dict]:
    """The events that ran on a device: kernels, copies and memsets."""
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def host_op_events(events: Iterable[dict]) -> List[dict]:
    """The top-level ``cpu_op`` events: those that no other ``cpu_op`` of
    the same thread encloses."""
    by_thread: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        end = float("-inf")
        for e in evs:
            if e["ts"] >= end:  # not inside the last top-level op
                out.append(e)
                end = e["ts"] + e.get("dur", 0.0)
    return out


def _interval(e) -> Optional[Tuple[float, float]]:
    """(start, end) in microseconds of a device event: a Chrome-trace dict
    or a ``torch.profiler`` FunctionEvent on a CUDA device. None for
    anything that did not run on a device."""
    if isinstance(e, dict):
        if e.get("cat") not in DEVICE_CATEGORIES:
            return None
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    if getattr(e, "device_type", None) is not None and e.device_type.name == "CUDA":
        return float(e.time_range.start), float(e.time_range.end)
    return None


def device_busy_ms(events: Iterable) -> float:
    """The union of the device events' intervals, in ms: the time at least
    one kernel, copy or memset ran. ``events`` are Chrome-trace dicts
    (:func:`parse_trace`) or ``torch.profiler`` FunctionEvents
    (``prof.events()``)."""
    spans = sorted(s for s in map(_interval, events) if s is not None)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


# ---------------------------------------------------------------------------
# Per-op aggregation (the reference's kernel-stats table shape)


@dataclasses.dataclass
class OpStats:
    name: str
    count: int
    total_us: float
    avg_us: float
    pct: float           # share of summed device op time
    line: str            # which device line (stream) or host thread it came from
    flops: float = 0.0   # summed over occurrences (0: the trace carries no cost)
    bytes_accessed: float = 0.0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else float("inf") if self.flops else 0.0


@dataclasses.dataclass
class OpTable:
    device: str
    total_us: float
    ops: List[OpStats]

    def top(self, k: int = 10) -> List[OpStats]:
        return self.ops[:k]

    def slow_ops(self, threshold_us: float = 0.0, min_pct: float = 0.0) -> List[OpStats]:
        """The ops at or past ``threshold_us`` a call and ``min_pct`` of the time."""
        return [o for o in self.ops if o.avg_us >= threshold_us and o.pct >= min_pct]

    def find(self, substr: str) -> List[OpStats]:
        """The rows whose name contains ``substr``."""
        return [o for o in self.ops if substr in o.name]

    def summary(self, k: int = 10) -> str:
        hdr = f"device={self.device} total_device_time={self.total_us / 1e3:.3f}ms\n"
        rows = [f"{'op':<48} {'count':>7} {'total_us':>10} {'avg_us':>9} {'pct':>6}"]
        for o in self.top(k):
            nm = o.name if len(o.name) <= 48 else o.name[:45] + "..."
            rows.append(f"{nm:<48} {o.count:>7} {o.total_us:>10.1f} "
                        f"{o.avg_us:>9.2f} {o.pct:>5.1f}%")
        return hdr + "\n".join(rows)

    def to_json(self) -> dict:
        return {"device": self.device, "total_us": self.total_us,
                "ops": [dataclasses.asdict(o) for o in self.ops]}


def _device_label(e: dict) -> str:
    return f"GPU {e.get('args', {}).get('device', e.get('pid'))}"


def op_table_from_events(events: List[dict], device_substr: Optional[str] = None) -> OpTable:
    """Aggregate the events' time by name: device events by (stream, name)
    on each device (``device_substr`` keeps the devices whose label, "GPU
    <index>", contains it), or, with no device events, the top-level
    ``cpu_op`` events by (thread, name)."""
    dev = device_events(events)
    if dev:
        rows = [(e, _device_label(e), f"stream {e.get('args', {}).get('stream', e.get('tid'))}")
                for e in dev]
    else:
        rows = [(e, "CPU", f"thread {e.get('tid')}") for e in host_op_events(events)]
    rows = [r for r in rows if not device_substr or device_substr in r[1]]
    agg: Dict[Tuple[str, str], List[float]] = {}
    devices: List[str] = []
    for e, label, line in rows:
        if label not in devices:
            devices.append(label)
        cell = agg.setdefault((line, e.get("name", "?")), [0, 0.0])
        cell[0] += 1
        cell[1] += float(e.get("dur", 0.0))
    total = sum(v[1] for v in agg.values()) or 1.0
    ops = [OpStats(name=name, count=int(c), total_us=t, avg_us=t / max(1, c),
                   pct=100.0 * t / total, line=line)
           for (line, name), (c, t) in agg.items()]
    ops.sort(key=lambda o: -o.total_us)
    return OpTable(device=",".join(devices) or "none", total_us=total, ops=ops)


def op_table_from_trace(trace_dir: str, device_substr: Optional[str] = None
                        ) -> Optional[OpTable]:
    """The per-op table of the newest trace under ``trace_dir`` (a file
    path is taken as it is); None when there is none."""
    path = trace_dir if os.path.isfile(trace_dir) else latest_trace_path(trace_dir)
    if path is None:
        return None
    return op_table_from_events(parse_trace(path), device_substr)
