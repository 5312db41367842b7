"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242] (copy of
``repro.configs.zamba2_1_2b``)."""
from repro_torch.configs.base import Family, ModelConfig


def get_config(name: str = "zamba2-1.2b") -> ModelConfig:
    return ModelConfig(
        name=name,
        family=Family.HYBRID,
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        shared_attn_every=6,  # one shared attn+MLP block applied every 6 mamba layers
    )


def get_smoke_config(name: str = "zamba2-1.2b") -> ModelConfig:
    return ModelConfig(
        name=name + "-smoke",
        family=Family.HYBRID,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=32,
        shared_attn_every=2,
        param_dtype="float32",
        compute_dtype="float32",
    )
