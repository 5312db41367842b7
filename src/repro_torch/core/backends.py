"""Bit-accurate forward emulation of the approximate hardware (port of
``repro.core.backends``: the sc, analog, approx_mult and log_mult
emulators, their fused variants, ``fake_quant_unipolar``, the parametric
energy models and the built-in registry entries with their proxies, fast
forwards, calibration degrees and energy models).

The value-domain scaling — dynamic scales, split-unipolar planes,
operand quantisation — runs in plain torch, op for op as in the
reference (``torch.round`` rounds half to even like ``jnp.round``); the
kernels in :mod:`repro_torch.kernels.ops` do the contractions.  The
exceptions are approx_mult and log_mult, whose kernels take the operands
themselves and quantise them on load, bit for bit as
:func:`repro_torch.kernels.vpu_matmul.int_operand_quantize` does (K2 at
decode, the prefill contractions at more than 4 rows), and SC's prefill
projection, whose kernel forms the probability planes on load, bit for bit
as :func:`repro_torch.kernels.sc_matmul.stream_planes` does.  Two details keep
the ops those of the reference:

* A Python constant meets a tensor as a 0-dim tensor of the tensor's
  dtype (:func:`repro_torch.kernels.ref.const`), as JAX's weak typing
  makes it: ``g / sx`` is a bf16 quotient for a bf16 ``sx``, ``levels**2``
  is rounded to bf16 before it divides, and ``(r * rescale)`` is an f32
  product.
  PyTorch would compute ``g / sx`` as ``reciprocal(sx) * g`` and, on a
  CUDA tensor, ``a / 255.0`` as ``a * (1 / 255)``.
* Every emulator takes ``rng``, the site's source of generator draws
  (``rng(n_ports, n_bits, device) -> (ux, uw)``, see
  :meth:`repro_torch.core.approx_linear.ApproxCtx.site_rng`); only SC
  reads it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (
    AnalogParams,
    ApproxMultParams,
    Backend,
    LogMultParams,
    SCParams,
)
from repro_torch.core import proxy as proxy_lib
from repro_torch.core import registry
from repro_torch.core.proxy import split_signed, tensor_scale
from repro_torch.core.registry import BackendSpec, concat_planes, split_unipolar_contract
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import const
from repro_torch.kernels.sc_matmul import row_major, stream_planes


def fake_quant_unipolar(x, bits: int):
    """Round a [0,1] tensor to ``bits`` levels.  The reference's
    straight-through form ``x + stop_gradient(q - x)`` is kept as
    ``x + (q - x)``, rounded in ``x``'s dtype: it need not equal ``q``."""
    levels = (1 << bits) - 1
    q = torch.round(x * levels) / const(levels, x)
    return x + (q - x)


def _emulate_exact(x, w, p, rng):
    del p, rng
    return x @ w


def _stream_planes(x, w, p: SCParams):
    """Per-tensor scales and the clipped probability planes of SC."""
    return stream_planes(x, w, p.gain)


def _emulate_sc(x, w, p: SCParams, rng):
    """Split-unipolar streams, AND multiply, OR accumulate: the positive
    output tree takes {xp*wp} U {xn*wn}, the negative {xp*wn} U {xn*wp},
    one accumulation per polarity over 2K ports, both against the same
    generator sequences.  One call from the operands themselves: on the
    CPU the plain composition (the planes, the two contractions, the
    rescale), op for op the reference's; on the card one pass over the
    weight for both polarities, the planes formed in the kernel's loads."""
    K, N = w.shape
    draws = rng(2 * K, p.bits, x.device)
    # a tied lm_head's weight is the view embed.T, which the kernel reads in
    # place
    y = kops.sc_matmul_quantized(x.reshape(-1, K).contiguous(), w, p.gain, p.bits, draws)
    return y.reshape(x.shape[:-1] + (N,))


def _array_planes(x, w, p: AnalogParams):
    """Per-tensor scales and the quantised unipolar planes of an analog
    array."""
    sx = tensor_scale(x)
    sw = tensor_scale(w)
    xp, xn = split_signed(x / sx)
    wp, wn = split_signed(row_major(torch.div, w, sw))  # row-major for a tied head's embed.T
    xp = fake_quant_unipolar(xp, p.input_bits)
    xn = fake_quant_unipolar(xn, p.input_bits)
    wp = fake_quant_unipolar(wp, p.weight_bits)
    wn = fake_quant_unipolar(wn, p.weight_bits)
    return xp, xn, wp, wn, sx * sw


def _emulate_analog(x, w, p: AnalogParams, rng):
    """Operand quantisation, then one accumulation per polarity over the
    2K unipolar ports, each array's partial sum through the ADC."""
    del rng
    xp, xn, wp, wn, prescale = _array_planes(x, w, p)
    out = split_unipolar_contract(
        (xp, xn), (wp, wn),
        lambda a, b: kops.analog_matmul(a, b, p.array_size, p.adc_bits, p.adc_range),
    )
    return (out * prescale).to(x.dtype)


# The multiplier-error backends hand the operands themselves to the
# kernels, which quantise them on load: no plain-torch op runs over the
# weight.  The reference runs _int_operand_quantize in front of its kernel
# (XLA fuses it into one program): _int_operand_emulate for the prefill
# projection, then (acc * prescale).astype(x.dtype); _fused_int_operand,
# with the chip/calibration epilogue, for the decode projection.  The
# port's one entry per multiplier computes both, the prefill with an empty
# epilogue (the same ops: the epilogue of {} is the identity); on the CPU
# it is the plain int_operand_matmul_fused_ref, op for op the reference's.


def _int_operand_emulate(x, w, matmul_quantized, epi: dict):
    x2 = x.reshape(-1, x.shape[-1])
    # a tied lm_head's weight is the view embed.T, which the kernels read in
    # place
    y = matmul_quantized(x2.contiguous(), w, epi, x.dtype)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def _approx_mult_quantized(p: ApproxMultParams):
    return lambda a, b, e, dt: kops.approx_mult_matmul_quantized(a, b, p.bits, p.perforate, e, dt)


def _log_mult_quantized(p: LogMultParams):
    return lambda a, b, e, dt: kops.log_matmul_quantized(a, b, p.bits, e, dt)


def _emulate_approx_mult(x, w, p: ApproxMultParams, rng):
    del rng
    return _int_operand_emulate(x, w, _approx_mult_quantized(p), {})


def _emulate_log_mult(x, w, p: LogMultParams, rng):
    del rng
    return _int_operand_emulate(x, w, _log_mult_quantized(p), {})


# Fused MODEL-mode emulators: matmul + chip/calibration epilogue in one
# kernel call (the serving decode path).  Scaling mirrors the composed
# emulators above op for op, so fused == composed bit for bit.


def _fused_emulate_approx_mult(x, w, p: ApproxMultParams, rng, epi):
    del rng
    return _int_operand_emulate(x, w, _approx_mult_quantized(p), epi)


def _fused_emulate_log_mult(x, w, p: LogMultParams, rng, epi):
    del rng
    return _int_operand_emulate(x, w, _log_mult_quantized(p), epi)


def _fused_emulate_sc(x, w, p: SCParams, rng, epi):
    xp, xn, wp, wn, rescale = _stream_planes(x, w, p)
    draws = rng(2 * xp.shape[-1], p.bits, x.device)
    y = kops.sc_matmul_fused(concat_planes(xp, xn), (wp, wn), p.bits, draws, rescale, epi, x.dtype)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def _fused_emulate_analog(x, w, p: AnalogParams, rng, epi):
    del rng
    xp, xn, wp, wn, prescale = _array_planes(x, w, p)
    y = kops.analog_matmul_fused(
        concat_planes(xp, xn), (wp, wn), p.array_size, p.adc_bits, p.adc_range, prescale, epi,
        x.dtype,
    )
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


# ---------------------------------------------------------------------------
# Parametric deployment-energy models (relative energy per MAC; one exact
# digital MAC = 1.0): the paper's Tab. 1 relative op costs made parametric
# in each backend's knobs, read by repro_torch.search.costmodel to price a
# site->backend map.  SC grows linearly with stream length (split-unipolar
# doubles the streams); a truncated multiplier ~quadratically with operand
# width, saving ~8% per perforated partial-product row; a Mitchell
# multiplier replaces the multiply array with shift/add; an analog MAC is
# nearly free but pays an amortised share of its ADC, whose energy grows
# exponentially in resolution.  Monotone in every knob, which is what the
# search needs.  Constants copied from the reference.
# ---------------------------------------------------------------------------

_SC_BIT_CYCLE = 0.02       # AND+OR per stream bit-cycle vs one exact MAC
_SC_RNG_OVERHEAD = 0.10    # stream generation (shared LFSRs, amortised)
_ANALOG_MAC = 0.005        # crossbar current-summing MAC
_ANALOG_ADC_UNIT = 0.004   # per-conversion unit: * bits * 2^bits / array
_LOG_MULT_SCALE = 0.30     # shift/add vs multiply array, at 8-bit operands
_APPROX_MULT_PERFORATE_SAVE = 0.08  # energy saved per dropped PP row


def _energy_sc(p: SCParams) -> float:
    return _SC_RNG_OVERHEAD + _SC_BIT_CYCLE * 2 * p.bits


def _energy_analog(p: AnalogParams) -> float:
    adc = _ANALOG_ADC_UNIT * p.adc_bits * (1 << p.adc_bits) / max(p.array_size, 1)
    # operand DACs scale linearly in resolution (minor next to the ADC)
    dac = 0.001 * (p.input_bits + p.weight_bits) / 16.0
    return _ANALOG_MAC + adc + dac


def _energy_approx_mult(p: ApproxMultParams) -> float:
    full = (p.bits / 8.0) ** 2  # multiplier array area/energy ~ bits^2
    return max(full * (1.0 - _APPROX_MULT_PERFORATE_SAVE * p.perforate), 1e-3)


def _energy_log_mult(p: LogMultParams) -> float:
    return _LOG_MULT_SCALE * p.bits / 8.0


registry.register(BackendSpec(
    name=Backend.EXACT.value,
    params_cls=type(None),
    emulate=_emulate_exact,
    proxy_forward=proxy_lib.identity_proxy,
    calib_degree=0,
    energy=lambda p: 1.0,
))

registry.register(BackendSpec(
    name=Backend.SC.value,
    params_cls=SCParams,
    emulate=_emulate_sc,
    proxy_forward=proxy_lib.sc_proxy,
    fused_emulate=_fused_emulate_sc,
    kernels=kops.KERNELS["sc"],
    energy=_energy_sc,
))

registry.register(BackendSpec(
    name=Backend.ANALOG.value,
    params_cls=AnalogParams,
    emulate=_emulate_analog,
    proxy_forward=proxy_lib.analog_proxy,
    # Type 2 (paper): plain matmul on non-calibration INJECT batches, and
    # scalar (degree-0) error statistics
    fast_forward=proxy_lib.identity_proxy,
    calib_degree=0,
    fused_emulate=_fused_emulate_analog,
    kernels=kops.KERNELS["analog"],
    energy=_energy_analog,
))

registry.register(BackendSpec(
    name=Backend.APPROX_MULT.value,
    params_cls=ApproxMultParams,
    emulate=_emulate_approx_mult,
    proxy_forward=proxy_lib.identity_proxy,
    fused_emulate=_fused_emulate_approx_mult,
    kernels=kops.KERNELS["approx_mult"],
    energy=_energy_approx_mult,
))

registry.register(BackendSpec(
    name=Backend.LOG_MULT.value,
    params_cls=LogMultParams,
    emulate=_emulate_log_mult,
    proxy_forward=proxy_lib.identity_proxy,
    fused_emulate=_fused_emulate_log_mult,
    kernels=kops.KERNELS["log_mult"],
    energy=_energy_log_mult,
))
