"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base] (copy of
``repro.configs.dbrx_132b``)."""
from repro_torch.configs.base import Family, ModelConfig


def get_config(name: str = "dbrx-132b") -> ModelConfig:
    return ModelConfig(
        name=name,
        family=Family.MOE,
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        top_k=4,
    )


def get_smoke_config(name: str = "dbrx-132b") -> ModelConfig:
    return ModelConfig(
        name=name + "-smoke",
        family=Family.MOE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        n_experts=8,
        top_k=4,
        param_dtype="float32",
        compute_dtype="float32",
    )
