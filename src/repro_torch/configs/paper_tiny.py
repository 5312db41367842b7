"""The paper's own models as LM-shaped analogues (copy of
``repro.configs.paper_tiny``): ``paper-tinyconv`` (4 layers, d 128) and
``paper-resnet-tiny`` (8 layers, d 192), DENSE, float32.  The search's
default arch and the arch of its tests."""
from repro_torch.configs.base import Family, ModelConfig


def get_config(name: str) -> ModelConfig:
    if name == "paper-tinyconv":
        return ModelConfig(
            name=name,
            family=Family.DENSE,
            n_layers=4,
            d_model=128,
            n_heads=4,
            n_kv_heads=4,
            d_ff=256,
            vocab_size=512,
            param_dtype="float32",
            compute_dtype="float32",
        )
    return ModelConfig(
        name=name,
        family=Family.DENSE,
        n_layers=8,
        d_model=192,
        n_heads=6,
        n_kv_heads=6,
        d_ff=384,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )


def get_smoke_config(name: str) -> ModelConfig:
    return get_config(name)
