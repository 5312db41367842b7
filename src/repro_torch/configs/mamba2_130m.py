"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060] (copy of
``repro.configs.mamba2_130m``)."""
from repro_torch.configs.base import Family, ModelConfig


def get_config(name: str = "mamba2-130m") -> ModelConfig:
    return ModelConfig(
        name=name,
        family=Family.SSM,
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        tie_embeddings=True,
    )


def get_smoke_config(name: str = "mamba2-130m") -> ModelConfig:
    return ModelConfig(
        name=name + "-smoke",
        family=Family.SSM,
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=32,
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
