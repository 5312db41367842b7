"""Stochastic-computing contractions: the CUDA kernels K4/K5 and their plain
versions (port of ``repro.kernels.sc_matmul``).

``sc_matmul_cuda`` (K4) and ``sc_matmul_fused_cuda`` (K5) launch
``csrc/sc_matmul.cu``.  They take the activation probabilities ``x``
[M, 2K], the weight probability plane as its two [K, N] halves
``(top, bottom)`` (read in place: the reference's ``concatenate``s are
never built), and the generator draws ``ux`` [1, bits] (shared by every
activation port) and ``uw`` [2K, bits] (one sequence per weight row).
The kernels compare and pack the streams themselves.
``sc_matmul_words_cuda`` is K4's contraction on pre-packed words, the
reference kernel's own interface, for checking the contraction alone.

The plain versions are :func:`repro_torch.kernels.ref.sc_matmul_ref`
(K4) and :func:`sc_matmul_fused_ref` below (K5).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.ref import sc_matmul_ref
from repro_torch.kernels.vpu_matmul import epilogue_operands

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BITS = 256  # the kernel's table of one activation sequence holds 8 words
ROW = 65        # words of one (port, word) table row: 32 thresholds, 33 masks


def sc_matmul_fused_ref(x, w: Tuple, n_bits: int, ux, uw, prescale, epi: Dict, out_dtype):
    """K5's plain version: both polarities, w_pos = [wp; wn] and w_neg =
    [wn; wp], ``r_p - r_n`` times the prescale, cast to ``out_dtype``,
    then the epilogue."""
    wp, wn = w
    r = sc_matmul_ref(x, (wp, wn), n_bits, ux, uw) - sc_matmul_ref(x, (wn, wp), n_bits, ux, uw)
    return apply_epilogue((r * prescale).to(out_dtype), **epi)


def _check(x, w: Tuple, n_bits: int, ux, uw):
    top, bottom = w
    tensors = (x, top, bottom, ux, uw)
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
    if n_bits % 32 or not 0 < n_bits <= MAX_BITS:
        raise ValueError(f"n_bits must be a multiple of 32 in [32, {MAX_BITS}]; got {n_bits}")
    if ux.numel() != n_bits or tuple(uw.shape) != (2 * K, n_bits):
        raise ValueError(f"need ux [1, {n_bits}] and uw [{2 * K}, {n_bits}]; got "
                         f"{tuple(ux.shape)}, {tuple(uw.shape)}")
    if ux.dtype != torch.float32 or uw.dtype != torch.float32:
        raise ValueError("the generator draws must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, the halves and the draws must be contiguous (row-major)")


def _scratch(x, K: int, N: int, n_bits: int, planes: int):
    """Table rows, activation words and word accumulators for one call."""
    M, W, dev = x.shape[0], n_bits // 32, x.device
    tab = torch.empty(((2 * K + 1) * W * ROW,), dtype=torch.int32, device=dev)
    xbits = torch.empty((M * 2 * K * W,), dtype=torch.int32, device=dev)
    accs = [torch.empty((M * N * W,), dtype=torch.int32, device=dev) for _ in range(planes)]
    return tab, xbits, accs


def sc_matmul_cuda(x, w: Tuple, n_bits: int, ux, uw):
    """K4: x [M, 2K] against the plane [top; bottom] -> [M, N] float32
    stream value (popcount / n_bits)."""
    _check(x, w, n_bits, ux, uw)
    top, bottom = w
    K, N = top.shape
    M = x.shape[0]
    tab, xbits, (acc,) = _scratch(x, K, N, n_bits, 1)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch(
        "sc_matmul_packed", "sc_matmul", "sc_matmul",
        _DTYPE_CODE[x.dtype], x.data_ptr(), top.data_ptr(), bottom.data_ptr(),
        ux.data_ptr(), uw.data_ptr(), tab.data_ptr(), xbits.data_ptr(), acc.data_ptr(),
        out.data_ptr(), M, N, K, n_bits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def sc_matmul_words_cuda(xbits, wbits, n_bits: int):
    """K4's contraction on pre-packed int32 words: xbits [M, K, W], wbits
    [K, N, W] -> [M, N] float32 (popcount / n_bits)."""
    if xbits.device.type != "cuda" or wbits.device != xbits.device:
        raise ValueError("CUDA kernel needs xbits and wbits on one CUDA device")
    if xbits.dtype != torch.int32 or wbits.dtype != torch.int32:
        raise ValueError("packed words must be int32")
    M, K, W = xbits.shape
    if wbits.dim() != 3 or wbits.shape[0] != K or wbits.shape[2] != W or n_bits != 32 * W:
        raise ValueError(f"need xbits [M,K,W], wbits [K,N,W], n_bits = 32 W; got "
                         f"{tuple(xbits.shape)}, {tuple(wbits.shape)}, {n_bits}")
    if not (xbits.is_contiguous() and wbits.is_contiguous()):
        raise ValueError("packed words must be contiguous")
    N = wbits.shape[1]
    acc = torch.empty((M * N * W,), dtype=torch.int32, device=xbits.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xbits.device)
    build.launch(
        "sc_matmul_packed[words]", "sc_matmul", "sc_matmul_words",
        xbits.data_ptr(), wbits.data_ptr(), acc.data_ptr(), out.data_ptr(), M, N, K, n_bits,
        torch.cuda.current_stream(xbits.device).cuda_stream,
    )
    return out


def sc_matmul_fused_cuda(x, w: Tuple, n_bits: int, ux, uw, prescale, epi: Dict, out_dtype):
    """K5: both polarities of the plane halves ``w = (wp, wn)`` against the
    same streams, ``r_p - r_n``, the prescale, the cast to ``out_dtype``
    and the epilogue ``epi`` in one call."""
    _check(x, w, n_bits, ux, uw)
    wp, wn = w
    K, N = wp.shape
    M = x.shape[0]
    ops = epilogue_operands(M, N, prescale, epi, out_dtype, x.device)
    tab, xbits, (acc_p, acc_n) = _scratch(x, K, N, n_bits, 2)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    build.launch(
        "sc_matmul_packed_fused", "sc_matmul", "sc_matmul_fused",
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], x.data_ptr(), wp.data_ptr(),
        wn.data_ptr(), ux.data_ptr(), uw.data_ptr(), tab.data_ptr(), xbits.data_ptr(),
        acc_p.data_ptr(), acc_n.data_ptr(), *ops.pointers(), out.data_ptr(), M, N, K, n_bits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out
