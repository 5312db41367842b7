"""Model facade tying init, forward, decode and slot ops together (port of
``repro.models.model``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D
from repro_torch.models import transformer as T


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent:
    nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int, device="cuda") -> T.Transformer:
        return T.init_params(self.cfg, seed, resolve_device(device))

    def init_cache(self, batch: int, max_seq: int, device="cuda") -> Dict[str, Any]:
        return D.init_cache(self.cfg, batch, max_seq, resolve_device(device))

    def init_calibration(self, approx, device="cuda") -> Dict[str, Any]:
        return T.init_calibration(self.cfg, approx, resolve_device(device))

    def apply(self, params, batch, **kw) -> T.ApplyOutput:
        return T.apply_model(params, batch, self.cfg, **kw)

    def serve_step(self, params, cache, tokens, pos, **kw):
        return D.serve_step(params, cache, tokens, pos, self.cfg, **kw)

    def prefill(self, params, tokens, **kw):
        return D.prefill(params, tokens, self.cfg, **kw)

    def slot_insert(self, cache, sub, slot):
        return D.slot_insert(self.cfg, cache, sub, slot)

    def slot_extract(self, cache, slot, k: int = 1):
        return D.slot_extract(self.cfg, cache, slot, k)

    def slot_reset(self, cache, slot, k: int = 1):
        return D.slot_reset(self.cfg, cache, slot, k)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
