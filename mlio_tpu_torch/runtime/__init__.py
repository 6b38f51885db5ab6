from mlio_tpu_torch.runtime.kv_cache import cache_memory_bytes, init_cache
from mlio_tpu_torch.runtime.generate import generate, greedy_generate
from mlio_tpu_torch.runtime.engine import InferenceEngine, Request
from mlio_tpu_torch.runtime.inference import (
    InferenceRunner,
    TransformerInferenceRunner,
    benchmark_optimization_impact,
    create_inference_runner,
)
from mlio_tpu_torch.runtime.quantization import (
    fuse_projections,
    quantize_params,
    quantized_size_bytes,
)
from mlio_tpu_torch.runtime.sampling import SamplingMethod, sample

__all__ = [
    "cache_memory_bytes",
    "init_cache",
    "generate",
    "greedy_generate",
    "InferenceEngine",
    "Request",
    "InferenceRunner",
    "TransformerInferenceRunner",
    "benchmark_optimization_impact",
    "create_inference_runner",
    "fuse_projections",
    "quantize_params",
    "quantized_size_bytes",
    "SamplingMethod",
    "sample",
]
