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
    apply_activation_scales,
    calibrate_activation_scales,
    fuse_projections,
    quantize_params,
    quantized_size_bytes,
    transcode_fp8_to_int8,
)
from mlio_tpu_torch.runtime.sampling import SamplingMethod, probabilities, sample
from mlio_tpu_torch.runtime.speculative import speculative_generate, speculative_generate_auto
from mlio_tpu_torch.runtime.train import next_token_loss, sgd_step, trainable

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
    "apply_activation_scales",
    "calibrate_activation_scales",
    "fuse_projections",
    "quantize_params",
    "quantized_size_bytes",
    "transcode_fp8_to_int8",
    "SamplingMethod",
    "probabilities",
    "sample",
    "speculative_generate",
    "speculative_generate_auto",
    "next_token_loss",
    "sgd_step",
    "trainable",
]
