"""Profiling (``mlio_tpu/profiling``): the profiler wrapper with counted
cost, memory tools, roofline bottleneck analysis on the H100, the per-kernel
profiler over ``torch.profiler`` traces and the plots. ``parse_trace``
(Chrome-trace JSON) takes the place of the JAX package's ``parse_xspace``."""
from mlio_tpu_torch.profiling.profiler import (
    ProfileResults,
    ProfilerConfig,
    ProfilerWrapper,
    device_memory_stats,
)
from mlio_tpu_torch.profiling.memory import (
    DeviceMemoryTracker,
    detect_memory_leak,
    find_max_batch_size,
    per_layer_memory,
)
from mlio_tpu_torch.profiling.bottleneck import (
    Bottleneck,
    BottleneckAnalyzer,
    BottleneckReport,
    BottleneckType,
)
from mlio_tpu_torch.profiling.kernel_profiler import (
    KernelProfileResults,
    KernelProfiler,
)
from mlio_tpu_torch.profiling.trace import (
    OpStats,
    OpTable,
    device_busy_ms,
    op_table_from_trace,
    parse_trace,
)
from mlio_tpu_torch.profiling import visualizer

__all__ = [
    "KernelProfileResults",
    "KernelProfiler",
    "OpStats",
    "OpTable",
    "device_busy_ms",
    "op_table_from_trace",
    "parse_trace",
    "ProfileResults",
    "ProfilerConfig",
    "ProfilerWrapper",
    "device_memory_stats",
    "DeviceMemoryTracker",
    "detect_memory_leak",
    "find_max_batch_size",
    "per_layer_memory",
    "Bottleneck",
    "BottleneckAnalyzer",
    "BottleneckReport",
    "BottleneckType",
    "visualizer",
]
