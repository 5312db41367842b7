"""Error-feedback buffers of the compressed gradient reduction (port of
``repro.optim.compress.init_compression_state``).

The reference's reducers (``int8_allreduce``, ``topk_allreduce``,
``crosspod_reduce``) are collectives across pods; they come with the
port's multi-device work.  Their state is made here: one zero residual per
parameter, carried from step to step.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn


def init_compression_state(params: Union[nn.Module, Dict[str, torch.Tensor]], method: str,
                           dtype=torch.bfloat16) -> Optional[Dict[str, torch.Tensor]]:
    """Zero error-feedback residuals, ``{name: tensor}`` shaped as the
    parameters, or None for ``method="none"`` (nothing to carry).  bf16 by
    default: the residual is a noise-scale correction, well inside bf16's
    range, and the reducers compute in float32 and round back on write;
    pass ``dtype=torch.float32`` for full-precision buffers."""
    if method == "none":
        return None
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    return {n: torch.zeros(t.shape, dtype=dtype, device=t.device) for n, t in named.items()}
