"""Bit-accurate forward emulation of the multiplier-error hardware (port
of ``repro.core.backends``: the approx_mult and log_mult emulators, their
fused variants, and the built-in registry entries).

The value-domain scaling — per-token activation scale, per-tensor weight
scale, rounding to signed integers — stays here in plain torch, op for op
as in the reference (``torch.round`` rounds half to even like
``jnp.round``); the kernels in :mod:`repro_torch.kernels.ops` do the
integer-domain contraction.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ApproxMultParams, Backend, LogMultParams
from repro_torch.core import registry
from repro_torch.core.proxy import row_scale, tensor_scale
from repro_torch.core.registry import BackendSpec
from repro_torch.kernels import ops as kops


def _emulate_exact(x, w, p):
    del p
    return x @ w


def _int_operand_quantize(x, w, bits: int):
    """Per-token dynamic quantisation to signed integer magnitudes, plus
    the value-domain prescale that undoes it after the contraction."""
    levels = (1 << bits) - 1
    sx = row_scale(x)
    sw = tensor_scale(w)
    xi = torch.round(torch.clamp(x / sx, -1.0, 1.0) * levels)
    wi = torch.round(torch.clamp(w / sw, -1.0, 1.0) * levels)
    return xi, wi, sx * sw / (levels * levels)


def _int_operand_emulate(x, w, bits: int, matmul):
    """Scale to signed integers, contract through ``matmul``, rescale."""
    xi, wi, prescale = _int_operand_quantize(x, w, bits)
    acc = matmul(xi.reshape(-1, x.shape[-1]), wi)
    out = acc.reshape(x.shape[:-1] + (w.shape[-1],)) * prescale
    return out.to(x.dtype)


def _emulate_approx_mult(x, w, p: ApproxMultParams):
    return _int_operand_emulate(
        x, w, p.bits, lambda a, b: kops.approx_mult_matmul(a, b, p.bits, p.perforate)
    )


def _emulate_log_mult(x, w, p: LogMultParams):
    return _int_operand_emulate(x, w, p.bits, kops.log_matmul)


# Fused MODEL-mode emulators: matmul + chip/calibration epilogue in one
# kernel call (the serving decode path).  Scaling mirrors the composed
# emulators above op for op, so fused == composed bit for bit.


def _fused_int_operand(x, w, bits: int, fused_matmul, epi: dict):
    xi, wi, prescale = _int_operand_quantize(x, w, bits)
    y = fused_matmul(
        xi.reshape(-1, x.shape[-1]), wi, prescale.reshape(-1, 1), epi, x.dtype
    )
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def _fused_emulate_approx_mult(x, w, p: ApproxMultParams, epi):
    return _fused_int_operand(
        x, w, p.bits,
        lambda a, b, pre, e, dt: kops.approx_mult_matmul_fused(
            a, b, p.bits, p.perforate, pre, e, dt
        ),
        epi,
    )


def _fused_emulate_log_mult(x, w, p: LogMultParams, epi):
    return _fused_int_operand(x, w, p.bits, kops.log_matmul_fused, epi)


registry.register(BackendSpec(
    name=Backend.EXACT.value,
    params_cls=type(None),
    emulate=_emulate_exact,
))

registry.register(BackendSpec(
    name=Backend.APPROX_MULT.value,
    params_cls=ApproxMultParams,
    emulate=_emulate_approx_mult,
    fused_emulate=_fused_emulate_approx_mult,
    kernels=kops.KERNELS["approx_mult"],
))

registry.register(BackendSpec(
    name=Backend.LOG_MULT.value,
    params_cls=LogMultParams,
    emulate=_emulate_log_mult,
    fused_emulate=_fused_emulate_log_mult,
    kernels=kops.KERNELS["log_mult"],
))
