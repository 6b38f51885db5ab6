"""Inference runner facade and optimization A/B harness
(``mlio_tpu/runtime/inference.py``).

:class:`InferenceRunner` applies a precision (``fp32``, ``bf16``, ``fp16``
which maps to bf16 as in the JAX package since the kernels are bf16, or
quantized ``int8``/``int4``/``fp8`` weights) and an :class:`Impl` to a
parameter dict, and times a cache-free forward. The device is the
parameters' device; the default ``impl`` is the fused one,
``Impl(attention="flash", mlp="fused", norm="fused")`` (K1, K11, K2), when
the parameters lie on the card, and the dense ``Impl()`` on the CPU, as the
JAX runner picks the fused one on its accelerator. Quantized weights take
the dequant-fused matmul (K5) in every projection.
:func:`benchmark_optimization_impact` runs the JAX package's seven default
configurations.

Not ported yet, and raising ``NotImplementedError``: ``profile_model``
(ROADMAP.md, queue 1, item 11: ``profiling/``), the diffusion runner
(``create_inference_runner(model_type="diffusion")``, item 11:
``runtime/diffusion.py``), and INT8 KV caches in ``generate`` (the int8
decode slice).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl, forward
from mlio_tpu_torch.models.utils import convert_precision
from mlio_tpu_torch.ops.quant import QTensor
from mlio_tpu_torch.runtime.quantization import quantize_params, quantized_size_bytes
from mlio_tpu_torch.utils.device_utils import get_device_memory_usage


def _qtensors(tree):
    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qtensors(v)


class InferenceRunner:
    """A model at a precision and an implementation, with timed inference."""

    def __init__(
        self,
        spec: ModelSpec,
        params,
        *,
        precision: str = "bf16",          # fp32 | bf16 | fp16 | int8 | int4 | fp8
        kv_quant: Optional[str] = None,    # None | int8
        impl: Optional[Impl] = None,
        use_paged_attention: bool = False,
        warmup_iters: int = 1,
    ):
        self.spec = spec
        self.precision = precision
        self.kv_quant = kv_quant
        self.use_paged_attention = use_paged_attention
        self.warmup_iters = warmup_iters
        self.device = params["tok_embed"].device
        on_card = self.device.type == "cuda"
        self.impl = impl if impl is not None else (
            Impl(attention="flash", mlp="fused", norm="fused") if on_card else Impl())
        if precision == "fp32":
            params = convert_precision(params, torch.float32)
        elif precision in ("bf16", "fp16"):  # fp16 maps to bf16: the kernels are bf16
            params = convert_precision(params, torch.bfloat16)
        elif precision in ("int8", "int4", "fp8"):
            params = quantize_params(convert_precision(params, torch.bfloat16), spec, precision)
        else:
            raise ValueError(f"unknown precision {precision}")
        self.params = params
        self._engine = None
        self.last_stats: Dict[str, Any] = {}

    # -- core ----------------------------------------------------------------

    def _forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V] of a cache-free forward."""
        with torch.inference_mode():
            logits, _ = forward(self.params, self.spec, input_ids, impl=self.impl)
        return logits

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_inference(self, input_ids, *, iters: int = 1) -> Dict[str, Any]:
        """Time ``iters`` forwards after ``warmup_iters`` untimed ones: mean
        and p99 ms by the host clock around each call, the card synchronised
        before and after it; peak bytes of live tensors over the timed calls
        (the card's peak counter is reset before them) and the change in
        bytes in use. Returns those and the last call's logits."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        for _ in range(self.warmup_iters):
            self._forward(input_ids)
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        mem_before = get_device_memory_usage(self.device)
        times = []
        out = None
        for _ in range(iters):
            self._sync()
            t0 = time.perf_counter()
            out = self._forward(input_ids)
            self._sync()
            times.append(time.perf_counter() - t0)
        mem_after = get_device_memory_usage(self.device)
        self.last_stats = {
            "mean_ms": float(np.mean(times)) * 1e3,
            "p99_ms": float(np.percentile(times, 99)) * 1e3,
            "peak_bytes": mem_after["peak_bytes_in_use"],
            "delta_bytes": mem_after["bytes_in_use"] - mem_before["bytes_in_use"],
        }
        return {"output": out, **self.last_stats}

    def batch_inference(self, batches: Sequence, **kw) -> List[Dict[str, Any]]:
        return [self.run_inference(b, **kw) for b in batches]

    def generate(self, input_ids, max_new_tokens: int = 32, **kw):
        from mlio_tpu_torch.runtime.generate import generate

        return generate(self.params, self.spec, torch.as_tensor(input_ids, device=self.device),
                        max_new_tokens=max_new_tokens, impl=self.impl,
                        cache_quant=self.kv_quant, device=self.device, **kw)

    def profile_model(self, input_ids, **kw):
        raise NotImplementedError(
            "InferenceRunner.profile_model needs the profiling package, not ported yet; see "
            "ROADMAP.md, queue 1, item 11 (profiling/)")

    def quantization_stats(self) -> Dict[str, Any]:
        return {"precision": self.precision,
                "quantized_tensors": sum(1 for _ in _qtensors(self.params)),
                "total_bytes": quantized_size_bytes(self.params)}


class TransformerInferenceRunner(InferenceRunner):
    """Adds paged serving through :class:`InferenceEngine`."""

    def engine(self, **engine_kw):
        """The continuous-batching engine over paged KV pools, built once."""
        if self._engine is None:
            from mlio_tpu_torch.runtime.engine import InferenceEngine

            engine_kw.setdefault("device", self.device)
            self._engine = InferenceEngine(
                self.spec, self.params,
                impl=Impl() if self.impl.attention == "dense" else self.impl, **engine_kw)
        return self._engine

    def kv_cache_stats(self) -> Dict[str, Any]:
        if self._engine is not None:
            return self._engine.memory_stats()
        from mlio_tpu_torch.runtime.kv_cache import cache_memory_bytes

        return {"contiguous_cache_bytes_at_max": cache_memory_bytes(
            self.spec, 1, self.spec.max_seq_len)}


def create_inference_runner(spec: ModelSpec, params, *, model_type: str = "transformer",
                            **kw) -> InferenceRunner:
    if model_type == "transformer":
        return TransformerInferenceRunner(spec, params, **kw)
    if model_type == "diffusion":
        raise NotImplementedError(
            "the diffusion runner needs runtime/diffusion.py, not ported yet; see ROADMAP.md, "
            "queue 1, item 11")
    return InferenceRunner(spec, params, **kw)


def benchmark_optimization_impact(
    spec: ModelSpec,
    params,
    input_ids,
    *,
    iters: int = 3,
    configs: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Dict[str, Dict[str, Any]]:
    """A/B harness: for each configuration (by default the JAX package's
    seven) a runner's mean and p99 ms, peak bytes, quantization stats and
    speedup over the first configuration. ``kv_quant`` does not change a
    cache-free forward, so ``int8_kv_cache`` times what ``flash_attention``
    does, as in the JAX harness."""
    if configs is None:
        configs = {
            "baseline": {"impl": Impl()},
            "flash_attention": {"impl": Impl(attention="flash")},
            "fused_mlp": {"impl": Impl(mlp="fused")},
            "flash+fusion": {"impl": Impl(attention="flash", mlp="fused", norm="fused")},
            "int8_weights": {"impl": Impl(attention="flash"), "precision": "int8"},
            "int8_kv_cache": {"impl": Impl(attention="flash"), "kv_quant": "int8"},
            "all": {"impl": Impl(attention="flash", mlp="fused", norm="fused"),
                    "precision": "int8", "kv_quant": "int8"},
        }
    results = {}
    base_ms = None
    for name, cfg in configs.items():
        runner = InferenceRunner(spec, params, precision=cfg.get("precision", "bf16"),
                                 kv_quant=cfg.get("kv_quant"), impl=cfg.get("impl"))
        r = runner.run_inference(input_ids, iters=iters)
        entry = {"mean_ms": r["mean_ms"], "p99_ms": r["p99_ms"],
                 "peak_bytes": r["peak_bytes"], **runner.quantization_stats()}
        if base_ms is None:
            base_ms = r["mean_ms"]
        entry["speedup"] = base_ms / r["mean_ms"] if r["mean_ms"] else 0.0
        results[name] = entry
    return results
