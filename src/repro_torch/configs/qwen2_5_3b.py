"""qwen2.5-3b — dense GQA with QKV bias (copy of ``repro.configs.qwen2_5_3b``)."""
from repro_torch.configs.base import Family, ModelConfig


def get_config(name: str = "qwen2.5-3b") -> ModelConfig:
    return ModelConfig(
        name=name,
        family=Family.DENSE,
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def get_smoke_config(name: str = "qwen2.5-3b") -> ModelConfig:
    return ModelConfig(
        name=name + "-smoke",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        qkv_bias=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
