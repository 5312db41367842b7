"""Operand splitting and dynamic scales (port of ``split_signed``,
``tensor_scale`` and ``row_scale`` from ``repro.core.proxy``; the proxy
activations belong to training and are not ported yet)."""
from __future__ import annotations

import torch

OPERAND_EPS = 1e-6  # the floor of a dynamic scale


def split_signed(x):
    """Split a signed tensor into its unipolar halves (both >= 0)."""
    return torch.clamp_min(x, 0.0), torch.clamp_min(-x, 0.0)


def tensor_scale(x, eps: float = OPERAND_EPS):
    """Per-tensor dynamic scale: max |x|, never below eps."""
    m = torch.amax(torch.abs(x))
    return torch.maximum(m, torch.tensor(eps, dtype=x.dtype, device=x.device))


def row_scale(x, eps: float = OPERAND_EPS):
    """Per-row (per-token) dynamic scale: max |x| over the contraction
    axis, keepdims.  Per-token quantisation keeps the multiplier-error
    emulations batch-invariant: a request's quantisation grid never
    depends on what shares its slot batch.  The SC and analog emulators
    keep per-tensor activation scales (a device property), as in the
    reference, so their outputs depend on the whole batch."""
    m = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return torch.maximum(m, torch.tensor(eps, dtype=x.dtype, device=x.device))
