"""Architecture registry: ``get_config("qwen2.5-3b")``.

The qwen2.5-3b entry, the MoE family's dbrx-132b and grok-1-314b, the SSM
family's mamba2-130m, the hybrid family's zamba2-1.2b, and the paper's own
models (``paper-tinyconv``, ``paper-resnet-tiny``) are ported; the
reference's other archs raise.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ApproxConfig,
    Backend,
    Family,
    ModelConfig,
    TrainConfig,
    TrainMode,
)

_ARCH_MODULES: Dict[str, str] = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "paper-tinyconv": "repro_torch.configs.paper_tiny",
    "paper-resnet-tiny": "repro_torch.configs.paper_tiny",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}
# archs the JAX reference registers that the port does not serve yet
_NOT_PORTED = (
    "yi-6b", "mistral-large-123b", "granite-20b", "paligemma-3b", "musicgen-large",
)


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not yet ported to repro_torch (ROADMAP A5)")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).get_config(name)


def get_smoke_config(name: str) -> ModelConfig:
    """A reduced config of the same family, for CPU tests."""
    return _module(name).get_smoke_config(name)


__all__ = [
    "ApproxConfig",
    "Backend",
    "Family",
    "ModelConfig",
    "TrainConfig",
    "TrainMode",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
