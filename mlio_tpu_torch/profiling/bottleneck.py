"""Bottleneck analysis: roofline classification of a measured step
(``mlio_tpu/profiling/bottleneck.py``).

A step's counted FLOPs and bytes (``ProfileResults.cost``, or given by the
caller) against the card's peak rates decide compute- or memory-bound;
measured wall time past the roofline's time is overhead (launches, host
work, syncs). The JAX package's constants are a TPU v5e's; these are the
H100 SXM's, and the memory rate is an argument, so that a caller can pass
the rate it measured (``utils.dma_bench``'s K14 probe).
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Optional


class BottleneckType(enum.Enum):
    COMPUTE = "compute"
    MEMORY = "memory"
    COMMUNICATION = "communication"
    IO = "io"
    OVERHEAD = "overhead"
    MIXED = "mixed"


# NVIDIA H100 SXM5 data sheet: dense tensor-core bf16 989.4 TFLOP/s, int8
# 1,979 TOPS; fp32 (CUDA cores) 66.9 TFLOP/s.
PEAK_FLOPS = {"bf16": 989.4e12, "fp32": 66.9e12, "int8": 1979e12}
# NVIDIA H100 SXM5 data sheet: HBM3 3.35 TB/s.
HBM_GBPS = 3350.0
# NVIDIA H100 SXM5 data sheet: NVLink 900 GB/s a GPU (both directions).
NVLINK_GBPS = 900.0


@dataclasses.dataclass
class Bottleneck:
    kind: BottleneckType
    severity: float          # 0..1 fraction of step time attributed
    detail: str
    suggestions: List[str]


@dataclasses.dataclass
class BottleneckReport:
    bottlenecks: List[Bottleneck]
    metrics: Dict[str, float]

    @property
    def primary(self) -> Optional[Bottleneck]:
        return max(self.bottlenecks, key=lambda b: b.severity, default=None)

    def to_text(self) -> str:
        lines = ["Bottleneck report", "=" * 40]
        for k, v in self.metrics.items():
            lines.append(f"  {k}: {v:.4g}")
        for b in sorted(self.bottlenecks, key=lambda b: -b.severity):
            lines.append(f"\n[{b.kind.value}] severity {b.severity:.2f}")
            lines.append(f"  {b.detail}")
            for s in b.suggestions:
                lines.append(f"  -> {s}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "metrics": self.metrics,
            "bottlenecks": [
                {"kind": b.kind.value, "severity": b.severity, "detail": b.detail,
                 "suggestions": b.suggestions}
                for b in self.bottlenecks],
        }, indent=2)


_SUGGESTIONS = {
    BottleneckType.COMPUTE: [
        "use bf16 (or int8 W8A8) so that the products run on the tensor cores",
        "increase the batch so that each product fills the tensor cores' tiles",
        "enable the fused kernels (Impl(attention='flash', mlp='fused', norm='fused')) to "
        "remove element-wise passes",
        "shard with tensor parallelism across NVLink to add SMs",
    ],
    BottleneckType.MEMORY: [
        "quantize weights to int8/int4 (the dequant-fused matmul reads half the bytes or less)",
        "quantize the KV cache to int8",
        "use flash/paged attention to avoid materializing score matrices",
        "increase the batch so that weight reads amortize over more tokens",
    ],
    BottleneckType.COMMUNICATION: [
        "keep tensor-parallel groups within one NVLink domain",
        "use ring attention (peer-to-peer sends) instead of all-gather for long context",
        "overlap collectives with compute on separate CUDA streams",
        "lower the communication dtype to bf16",
    ],
    BottleneckType.OVERHEAD: [
        "capture the step in a CUDA graph, or run the whole decode in one megakernel "
        "launch, to amortize launch latency",
        "batch multiple requests per step (continuous batching)",
        "avoid host syncs (.item(), .cpu()) and host<->device copies in the hot loop",
    ],
}


class BottleneckAnalyzer:
    """Roofline classification at ``peak_flops`` and ``hbm_gbps`` (by
    default the H100 SXM data sheet's bf16 and HBM3 rates)."""

    def __init__(self, peak_flops: float = PEAK_FLOPS["bf16"], hbm_gbps: float = HBM_GBPS):
        self.peak_flops = peak_flops
        self.hbm_bps = hbm_gbps * 1e9

    def analyze(self, *, wall_time_s: float, flops: float = 0.0, bytes_accessed: float = 0.0,
                comm_bytes: float = 0.0, num_devices: int = 1) -> BottleneckReport:
        """Classify a measured step against the roofline; ``comm_bytes``
        cross NVLink at :data:`NVLINK_GBPS`."""
        t_compute = flops / self.peak_flops / max(1, num_devices)
        t_memory = bytes_accessed / self.hbm_bps / max(1, num_devices)
        t_comm = comm_bytes / (NVLINK_GBPS * 1e9) if comm_bytes else 0.0
        t_model = max(t_compute, t_memory) + t_comm
        overhead = max(0.0, wall_time_s - t_model)

        intensity = flops / bytes_accessed if bytes_accessed else float("inf")
        ridge = self.peak_flops / self.hbm_bps

        bottlenecks = []
        denom = max(wall_time_s, 1e-12)
        if t_compute >= t_memory and flops:
            bottlenecks.append(Bottleneck(
                BottleneckType.COMPUTE, min(1.0, t_compute / denom),
                f"arithmetic intensity {intensity:.1f} FLOP/B >= ridge {ridge:.1f}; "
                f"tensor-core-bound at {flops / denom / 1e12:.1f} TFLOP/s "
                f"({flops / denom / self.peak_flops:.0%} of peak)",
                _SUGGESTIONS[BottleneckType.COMPUTE]))
        if t_memory > t_compute and bytes_accessed:
            bottlenecks.append(Bottleneck(
                BottleneckType.MEMORY, min(1.0, t_memory / denom),
                f"arithmetic intensity {intensity:.1f} FLOP/B < ridge {ridge:.1f}; "
                f"HBM-bound at {bytes_accessed / denom / 1e9:.0f} GB/s "
                f"({bytes_accessed / denom / self.hbm_bps:.0%} of peak)",
                _SUGGESTIONS[BottleneckType.MEMORY]))
        if t_comm:
            bottlenecks.append(Bottleneck(
                BottleneckType.COMMUNICATION, min(1.0, t_comm / denom),
                f"{comm_bytes / 1e6:.1f} MB over NVLink per step",
                _SUGGESTIONS[BottleneckType.COMMUNICATION]))
        if overhead / denom > 0.3:
            bottlenecks.append(Bottleneck(
                BottleneckType.OVERHEAD, min(1.0, overhead / denom),
                f"{overhead * 1e3:.2f} ms ({overhead / denom:.0%}) not explained by "
                "compute/memory/comm: launch latency, host work or syncs",
                _SUGGESTIONS[BottleneckType.OVERHEAD]))

        metrics = {
            "wall_time_ms": wall_time_s * 1e3,
            "model_time_ms": t_model * 1e3,
            "compute_time_ms": t_compute * 1e3,
            "memory_time_ms": t_memory * 1e3,
            "comm_time_ms": t_comm * 1e3,
            "arithmetic_intensity": 0.0 if intensity == float("inf") else intensity,
            "flops_utilization": flops / denom / self.peak_flops if flops else 0.0,
            "bandwidth_utilization": (bytes_accessed / denom / self.hbm_bps
                                      if bytes_accessed else 0.0),
        }
        return BottleneckReport(bottlenecks=bottlenecks, metrics=metrics)

    def analyze_op_table(self, results, top_k: int = 5) -> BottleneckReport:
        """Name the ops that dominate measured device time. ``results`` is a
        KernelProfileResults or an OpTable; device time covering little of
        the wall clock is flagged as launch or host overhead."""
        table = getattr(results, "table", results)
        wall_s = getattr(results, "wall_time_s", 0.0)
        top = table.top(top_k)
        bottlenecks = [
            Bottleneck(
                BottleneckType.MIXED, op.pct / 100.0,
                f"op '{op.name}' {op.total_us:.0f}us total ({op.count} calls, "
                f"{op.avg_us:.1f}us avg, {op.pct:.1f}% of device op time)",
                _SUGGESTIONS[BottleneckType.MEMORY][:2] + _SUGGESTIONS[BottleneckType.COMPUTE][:1])
            for op in top
        ]
        covered = min(1.0, table.total_us / 1e6 / wall_s) if wall_s else 1.0
        if wall_s and covered < 0.7:
            bottlenecks.append(Bottleneck(
                BottleneckType.OVERHEAD, 1.0 - covered,
                f"device ops cover only {covered:.0%} of wall time: launch gaps or host "
                "work dominate",
                _SUGGESTIONS[BottleneckType.OVERHEAD]))
        metrics = {
            "device_op_time_ms": table.total_us / 1e3,
            "wall_time_ms": wall_s * 1e3,
            "op_coverage": covered,
            "num_ops": float(len(table.ops)),
        }
        return BottleneckReport(bottlenecks=bottlenecks, metrics=metrics)

    def analyze_profile(self, profile_results) -> BottleneckReport:
        """Classify a ProfileResults (mean wall time and its counted cost)."""
        cost = profile_results.cost
        return self.analyze(wall_time_s=profile_results.mean_s, flops=cost.get("flops", 0.0),
                            bytes_accessed=cost.get("bytes accessed", 0.0))


def _per_op_bound(source: Any, compute: bool, min_pct: float) -> List[str]:
    """Classify each OpTable row by its own arithmetic intensity against the
    card's ridge point (bf16 peak over HBM rate); a whole-call cost dict
    (``ProfileResults.cost``) is one row named "executable"."""
    ridge = PEAK_FLOPS["bf16"] / (HBM_GBPS * 1e9)
    table = getattr(source, "table", source)
    ops = getattr(table, "ops", None)
    if ops is None:
        flops = source.get("flops", 0.0)
        bytes_ = source.get("bytes accessed", 0.0)
        if not bytes_:
            return []
        return ["executable"] if (flops / bytes_ >= ridge) == compute else []
    out = []
    for op in ops:
        if op.pct < min_pct or not op.bytes_accessed:
            continue  # a small op, or a row the trace carried no cost for
        if (op.flops / op.bytes_accessed >= ridge) == compute:
            out.append(op.name)
    return out


def identify_compute_bound_ops(source: Any, min_pct: float = 1.0,
                               threshold: float = 10.0) -> List[str]:
    """Names of the ops above the ridge point (tensor-core-bound), from an
    ``OpTable``/``KernelProfileResults`` whose rows carry FLOPs and bytes, or
    a whole-call cost dict. ``threshold`` is the JAX signature's and unused
    there too."""
    return _per_op_bound(source, compute=True, min_pct=min_pct)


def identify_memory_bound_ops(source: Any, min_pct: float = 1.0) -> List[str]:
    """Names of the ops below the ridge point (HBM-bound); the same sources
    as :func:`identify_compute_bound_ops`."""
    return _per_op_bound(source, compute=False, min_pct=min_pct)
