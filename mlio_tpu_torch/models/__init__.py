from mlio_tpu_torch.models.spec import ModelSpec, PRESETS, get_spec
from mlio_tpu_torch.models.transformer import (
    Impl,
    apply_rope,
    forward,
    init_params,
    rope_cos_sin,
    run_layer_stack,
)
from mlio_tpu_torch.models.loader import (
    convert_gpt2,
    convert_llama_attention_only,
    convert_mixtral,
    load_model,
    spec_from_hf_config,
    state_dict_from_torch,
)
from mlio_tpu_torch.models.weights import from_jax_cache, from_jax_params

__all__ = [
    "ModelSpec",
    "PRESETS",
    "get_spec",
    "Impl",
    "forward",
    "init_params",
    "apply_rope",
    "rope_cos_sin",
    "run_layer_stack",
    "convert_gpt2",
    "convert_llama_attention_only",
    "convert_mixtral",
    "load_model",
    "spec_from_hf_config",
    "state_dict_from_torch",
    "from_jax_params",
    "from_jax_cache",
]
