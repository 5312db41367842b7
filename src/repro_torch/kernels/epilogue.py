"""MODEL-mode epilogue math for the fused matmuls (port of
``repro.kernels.epilogue``).

The CUDA counterpart is ``csrc/epilogue.cuh``; both keep the reference's
two exactness invariants:

* ``eval_poly`` accumulates terms in sequence (term 0, then + term 1, ...)
  and forms ``t**i`` by the same square-and-multiply chain as
  ``jax.lax.integer_pow`` (:func:`ipow`), so ``t**3`` is ``t * (t*t)``.
* the per-token row scale is ``max(max|y|, eps)``: a max chain, so it is
  the same bits whichever tile or kernel computes it.

Every op runs in ``y``'s dtype and rounds to it, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import const

ROW_EPS = 1e-6


def ipow(t, i: int):
    """``t ** i`` for an integer ``i >= 1`` by binary exponentiation, in
    the multiplication order of ``jax.lax.integer_pow``."""
    acc = None
    x = t
    while i > 0:
        if i & 1:
            acc = x if acc is None else acc * x
        i >>= 1
        if i:
            x = x * x
    return acc


def eval_poly(coeffs, t):
    """``sum_i coeffs[..., i] * t**i`` with a fixed, sequential order."""
    out = coeffs[..., 0] * torch.ones_like(t)
    for i in range(1, coeffs.shape[-1]):
        out = out + coeffs[..., i] * ipow(t, i)
    return out


def row_abs_scale(y, eps: float = ROW_EPS):
    """Per-token activation scale: max(|y|) over the last axis, floored,
    and detached (the reference's ``stop_gradient``): the chip's additive
    terms ride on it and steer no gradient."""
    m = torch.amax(torch.abs(y.detach()), dim=-1, keepdim=True)
    return torch.maximum(m, const(eps, m))  # made once: no copy from the host a call


def apply_epilogue(
    y,
    colgain=None,
    coladd=None,
    mean_coeffs=None,
    mean_scale=None,
    eps: float = ROW_EPS,
):
    """Chip + calibration epilogue on a matmul output.

    Gain families pass ``colgain`` and ``coladd`` (``y * colgain + coladd
    * scale``); fault families pass ``coladd`` only (``y + coladd *
    scale``); ``mean_coeffs``/``mean_scale`` subtract the fitted
    conditional-mean error ``eval_poly(coeffs, y / mean_scale)``.
    ``colgain``/``coladd`` must already be in ``y.dtype``; the
    coefficients and ``mean_scale`` are float32.
    """
    if colgain is not None or coladd is not None:
        scale = row_abs_scale(y, eps).to(y.dtype)
        if colgain is not None:
            y = y * colgain + coladd * scale
        else:
            y = y + coladd * scale
    if mean_coeffs is not None:
        t = y.to(torch.float32) / mean_scale
        y = y - eval_poly(mean_coeffs, t).to(y.dtype)
    return y
