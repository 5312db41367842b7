"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1] (copy of
``repro.configs.grok1_314b``)."""
from repro_torch.configs.base import Family, ModelConfig


def get_config(name: str = "grok-1-314b") -> ModelConfig:
    return ModelConfig(
        name=name,
        family=Family.MOE,
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        n_experts=8,
        top_k=2,
    )


def get_smoke_config(name: str = "grok-1-314b") -> ModelConfig:
    return ModelConfig(
        name=name + "-smoke",
        family=Family.MOE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        n_experts=4,
        top_k=2,
        param_dtype="float32",
        compute_dtype="float32",
    )
