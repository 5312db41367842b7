"""Analog-array contractions with ADC partial-sum quantisation: the CUDA
kernels K6/K7 and their plain versions (port of
``repro.kernels.analog_matmul``).

``analog_matmul_cuda`` (K6) and ``analog_matmul_fused_cuda`` (K7) launch
``csrc/analog_matmul.cu``.  They take the unipolar activation plane ``x``
[M, 2K] and the weight plane as its two [K, N] halves ``(top, bottom)``,
read in place in their own dtype (no concatenation, no float32 copy).
Each array of ``array_size`` ports sums in float64 (on the float64
tensor cores) and rounds once to float32, so for the emulator's operands (bf16 values on 8-bit grids) the
kernels are bitwise equal to their plain versions,
:func:`repro_torch.kernels.ref.analog_matmul_ref` (K6) and
:func:`analog_matmul_fused_ref` below (K7).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.ref import analog_matmul_ref
from repro_torch.kernels.vpu_matmul import epilogue_operands

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def analog_matmul_fused_ref(
    x, w: Tuple, array_size: int, adc_bits: int, adc_range: float, prescale, epi: Dict,
    out_dtype,
):
    """K7's plain version: ``sum(adc_p) - sum(adc_n)`` over w_pos = [wp; wn]
    and w_neg = [wn; wp], times the prescale, cast to ``out_dtype``, then
    the epilogue."""
    wp, wn = w
    out = analog_matmul_ref(x, (wp, wn), array_size, adc_bits, adc_range) - analog_matmul_ref(
        x, (wn, wp), array_size, adc_bits, adc_range
    )
    return apply_epilogue((out * prescale).to(out_dtype), **epi)


def _check(x, w: Tuple):
    top, bottom = w
    tensors = (x, top, bottom)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(
            f"CUDA kernel needs every operand on one CUDA device; got "
            f"{[str(t.device) for t in tensors]}"
        )
    K, N = top.shape if top.dim() == 2 else (-1, -1)
    if x.dim() != 2 or tuple(bottom.shape) != (K, N) or x.shape[1] != 2 * K:
        raise ValueError(
            f"need x [M, 2K] and two [K, N] halves; got {tuple(x.shape)}, "
            f"{tuple(top.shape)}, {tuple(bottom.shape)}"
        )
    if not (x.dtype == top.dtype == bottom.dtype) or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x and the halves must share float32 or bfloat16; got "
                         f"{x.dtype}, {top.dtype}, {bottom.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x and the halves must be contiguous (row-major)")


def _array_scratch(M: int, N: int, K: int, array_size: int, adc_bits: int, dev):
    """K6's scratch as the kernel lays it out: one pass's ADC codes (a
    bounded share of rows and arrays, whatever M) and its rows of x as
    float64."""
    n = build.lib("analog_matmul").analog_scratch_bytes(M, N, K, array_size, adc_bits)
    if n < 0:
        raise ValueError(f"ADC code scratch for 64 rows of {2 * K}x{N} exceeds 2^31 bytes")
    return torch.empty((max(n, 1),), dtype=torch.uint8, device=dev)


def _fused_scratch(M: int, N: int, K: int, array_size: int, adc_bits: int, dev):
    """K7's scratch as the kernel lays it out: the ADC code of every array
    per polarity and output, and the straddling array's first piece when K
    is not a multiple of ``array_size``."""
    n = build.lib("analog_matmul").analog_fused_scratch_bytes(M, N, K, array_size, adc_bits)
    if n < 0:
        raise ValueError(f"ADC code scratch for {M}x{2 * K}x{N} exceeds 2^31 bytes")
    return torch.empty((n,), dtype=torch.uint8, device=dev)


def analog_matmul_cuda(x, w: Tuple, array_size: int, adc_bits: int, adc_range: float):
    """K6: x [M, 2K] against the plane [top; bottom] -> [M, N] float32:
    three launches a pass (one pass at the serving shapes), x widened to
    float64, the contraction and the pass that adds each output's ADC
    levels in array order."""
    _check(x, w)
    top, bottom = w
    K, N = top.shape
    M = x.shape[0]
    q = _array_scratch(M, N, K, array_size, adc_bits, x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch(
        "analog_matmul", "analog_matmul", "analog_matmul",
        _DTYPE_CODE[x.dtype], x.data_ptr(), top.data_ptr(), bottom.data_ptr(), q.data_ptr(),
        out.data_ptr(), M, N, K, array_size, adc_bits, float(adc_range),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def analog_matmul_fused_cuda(
    x, w: Tuple, array_size: int, adc_bits: int, adc_range: float, prescale, epi: Dict,
    out_dtype,
):
    """K7: both polarities of the plane halves ``w = (wp, wn)``, the
    difference of their ADC sums, the prescale, the cast to ``out_dtype``
    and the epilogue ``epi`` in one call."""
    _check(x, w)
    wp, wn = w
    K, N = wp.shape
    M = x.shape[0]
    dev = x.device
    ops = epilogue_operands(M, N, prescale, epi, out_dtype, dev)
    scratch = _fused_scratch(M, N, K, array_size, adc_bits, dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    build.launch(
        "analog_matmul_fused", "analog_matmul", "analog_matmul_fused",
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], x.data_ptr(), wp.data_ptr(),
        wn.data_ptr(), scratch.data_ptr(), *ops.pointers(), out.data_ptr(),
        M, N, K, array_size, adc_bits, float(adc_range),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out
