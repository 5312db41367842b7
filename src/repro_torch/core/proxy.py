"""Operand splitting, dynamic scales and the approximation-proxy
activations (port of ``repro.core.proxy``: ``split_signed``,
``tensor_scale``, ``row_scale``, ``sc_or_act``, ``analog_clamp_act``,
``unipolar_matmuls``, ``sc_proxy``, ``analog_proxy``, ``identity_proxy``,
``proxy_forward`` and ``int8_dequant``, the operand grid of the
approximate backward).

The proxies are smooth surrogates of the approximate accumulators, applied
to the positive and negative halves of the accumulation (paper Sec. 3.1):

    SC_act(x)     = (1 - e^{-x_pos}) - (1 - e^{-x_neg})
    Analog_act(x) = HardTanh(x_pos)  - HardTanh(x_neg)

MODEL mode's backward is the VJP of a backend's proxy
(:mod:`repro_torch.core.injection`), so the ops here are written to give
the reference's gradients as well as its values: the scales are detached
(the reference's ``stop_gradient``), ``|x|`` passes ``+g`` at 0 as
``jnp.abs``'s VJP does, the clamp is ``maximum`` then ``minimum``, whose
gradients split evenly at a tie as ``jnp.clip``'s do, and every Python
constant meets a tensor in the tensor's dtype (JAX's weak typing).

A scale's floor is a 0-dim tensor made once per (value, dtype, device)
(:func:`repro_torch.kernels.ref.const`): made per call from a Python float,
it would be a blocking copy from the host in every projection.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AnalogParams, ApproxConfig, Backend, SCParams
from repro_torch.kernels.ref import const

OPERAND_EPS = 1e-6  # the floor of a dynamic scale


def split_signed(x):
    """Split a signed tensor into its unipolar halves (both >= 0)."""
    return torch.clamp_min(x, 0.0), torch.clamp_min(-x, 0.0)


def tensor_scale(x, eps: float = OPERAND_EPS):
    """Per-tensor dynamic scale: max |x|, never below eps (no gradient)."""
    m = torch.amax(torch.abs(x.detach()))
    return torch.maximum(m, const(eps, m))


def row_scale(x, eps: float = OPERAND_EPS):
    """Per-row (per-token) dynamic scale: max |x| over the contraction
    axis, keepdims (no gradient).  Per-token quantisation keeps the
    multiplier-error emulations batch-invariant: a request's quantisation
    grid never depends on what shares its slot batch.  The SC and analog
    emulators keep per-tensor activation scales (a device property), as in
    the reference, so their outputs depend on the whole batch."""
    m = torch.amax(torch.abs(x.detach()), dim=-1, keepdim=True)
    return torch.maximum(m, const(eps, m))


def int8_dequant(t, axis: Optional[int] = -1, eps: float = OPERAND_EPS):
    """``t`` rounded onto a symmetric signed 8-bit grid and dequantised:
    the operand an int8 datapath sees.  ``axis`` an int takes a max-abs
    scale per row over that axis (activations and cotangents); ``None``
    one per-tensor scale (weights).  The scale gets no gradient.
    ``round(t / s * 127) * (s / 127)`` in ``t``'s dtype, each constant
    rounded to it first; ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  The approximate backward evaluates the gradient
    matmuls at these operands (:mod:`repro_torch.core.injection`)."""
    if axis is None:
        s = tensor_scale(t, eps)
    else:
        m = torch.amax(torch.abs(t.detach()), dim=axis, keepdim=True)
        s = torch.maximum(m, const(eps, m))
    c = const(127.0, s)
    return torch.round(t / s * c) * (s / c)


def _abs(x):
    """``|x|`` with ``jnp.abs``'s gradient: ``+g`` where ``x >= 0``
    (``torch.abs`` passes 0 at 0)."""
    return torch.where(x >= 0, x, -x)


def sc_or_act(z):
    """Mean behaviour of an OR-accumulator over unipolar product streams."""
    return 1.0 - torch.exp(-z)


def analog_clamp_act(z, limit: float):
    """HardTanh on a unipolar half: ADC saturation of the accumulated sum."""
    return torch.minimum(torch.maximum(z, const(0.0, z)), const(limit, z))


def unipolar_matmuls(x, w, gx: float, gw: float):
    """Scaled unipolar contraction pair ``(z_pos, z_neg, rescale)``: the
    value-domain output is ``(act(z_pos) - act(z_neg)) * rescale``.  Two
    contractions, not four: ``z_pos - z_neg = x@w`` (signed) and
    ``z_pos + z_neg = |x|@|w|`` (magnitude), as in the reference."""
    sx = tensor_scale(x)
    sw = tensor_scale(w)
    xs = x * (const(gx, sx) / sx)
    ws = w * (const(gw, sw) / sw)
    signed = xs @ ws
    magnitude = _abs(xs) @ _abs(ws)
    z_pos = (magnitude + signed) * 0.5
    z_neg = (magnitude - signed) * 0.5
    rescale = (sx * sw) / const(gx * gw, sx)
    return z_pos, z_neg, rescale


def sc_proxy(x, w, p: SCParams):
    """OR-accumulator saturation proxy for stochastic computing."""
    z_pos, z_neg, rescale = unipolar_matmuls(x, w, p.gain, p.gain)
    return (sc_or_act(z_pos) - sc_or_act(z_neg)) * rescale


def analog_proxy(x, w, p: AnalogParams):
    """ADC HardTanh saturation proxy for analog arrays: each half-sum
    clamps at the total saturation point of the arrays over the 2K
    split-unipolar ports."""
    z_pos, z_neg, rescale = unipolar_matmuls(x, w, 1.0, 1.0)
    n_arrays = max(1, -(-(2 * x.shape[-1]) // p.array_size))
    limit = p.adc_range * n_arrays
    return (analog_clamp_act(z_pos, limit) - analog_clamp_act(z_neg, limit)) * rescale


def identity_proxy(x, w, p=None):
    """Plain matmul: the proxy of the backends whose error enters in the
    multiplier only (approx-mult, log-mult), whose accumulation is exact."""
    return x @ w


def proxy_forward(x, w, cfg: ApproxConfig, backend: Optional[Backend] = None):
    """The proxy-activation forward of ``x @ w`` on a backend (``backend``
    overrides ``cfg.backend``), through the registry."""
    from repro_torch.core import registry  # deferred: registry -> backends -> proxy

    backend = backend if backend is not None else cfg.backend
    return registry.get(backend).proxy_forward(x, w, cfg.params_for(backend))
