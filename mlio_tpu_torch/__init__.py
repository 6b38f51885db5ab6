"""mlio_tpu_torch — the PyTorch/CUDA port of ``mlio_tpu`` for NVIDIA Hopper.

The JAX package ``mlio_tpu`` stays the reference; this package mirrors its
module names and public signatures. Plain tensor code is PyTorch; every
Pallas kernel on the ported path has a hand-written CUDA counterpart under
``mlio_tpu_torch/csrc``, built with nvcc at first use (``ops/_build.py``).
Entry points run on the card unless the caller passes ``device="cpu"``,
where each kernel wrapper runs its plain PyTorch version.

Importing the package builds nothing and imports neither JAX nor the JAX
package; the names below load on first access.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "ModelSpec": "mlio_tpu_torch.models.spec",
    "PRESETS": "mlio_tpu_torch.models.spec",
    "get_spec": "mlio_tpu_torch.models.spec",
    "Impl": "mlio_tpu_torch.models.transformer",
    "forward": "mlio_tpu_torch.models.transformer",
    "init_params": "mlio_tpu_torch.models.transformer",
    "load_model": "mlio_tpu_torch.models.loader",
    "from_jax_params": "mlio_tpu_torch.models.weights",
    "init_cache": "mlio_tpu_torch.runtime.kv_cache",
    "generate": "mlio_tpu_torch.runtime.generate",
    "greedy_generate": "mlio_tpu_torch.runtime.generate",
    "SamplingMethod": "mlio_tpu_torch.runtime.sampling",
    "QTensor": "mlio_tpu_torch.ops.quant",
    "quantize_params": "mlio_tpu_torch.runtime.quantization",
    "InferenceRunner": "mlio_tpu_torch.runtime.inference",
    "TransformerInferenceRunner": "mlio_tpu_torch.runtime.inference",
    "create_inference_runner": "mlio_tpu_torch.runtime.inference",
    "benchmark_optimization_impact": "mlio_tpu_torch.runtime.inference",
}

__all__ = [*_EXPORTS, "__version__"]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
