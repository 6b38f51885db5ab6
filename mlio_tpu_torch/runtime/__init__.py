from mlio_tpu_torch.runtime.kv_cache import cache_memory_bytes, init_cache
from mlio_tpu_torch.runtime.generate import generate, greedy_generate
from mlio_tpu_torch.runtime.engine import InferenceEngine, Request
from mlio_tpu_torch.runtime.sampling import SamplingMethod, sample

__all__ = [
    "cache_memory_bytes",
    "init_cache",
    "generate",
    "greedy_generate",
    "InferenceEngine",
    "Request",
    "SamplingMethod",
    "sample",
]
