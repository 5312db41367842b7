"""Multiplier-error contractions: the CUDA kernels K1/K2 and the plain
fused version (port of ``repro.kernels.vpu_matmul``).

``elementwise_matmul_cuda`` (K1) and ``elementwise_matmul_fused_cuda``
(K2) launch ``csrc/vpu_matmul.cu``; the multiplier is picked by name
(``"approx_mult"`` or ``"log_mult"``), since the per-product op lives in
the CUDA source.  Their plain versions are :func:`repro_torch.kernels.ref.
elementwise_matmul_ref` and :func:`elementwise_matmul_fused_ref` below.

Operands are integer-valued float32 or bfloat16 tensors of magnitude at
most 255 (what the backends' operand quantisation produces).  The kernel
reads them as integers: a non-integer operand is rounded to the nearest
integer, where the plain version would multiply it as a float.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import ROW_EPS, apply_epilogue
from repro_torch.kernels.ref import elementwise_matmul_ref

_MUL_CODE = {"approx_mult": 0, "log_mult": 1}
# K * 255 * 255 must fit the int32 accumulator
MAX_K = (2**31 - 1) // (255 * 255)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def elementwise_matmul_fused_ref(
    x, w, mul: Callable, prescale, epi: Dict, out_dtype
):
    """K1's contraction, ``(acc * prescale).to(out_dtype)``, then the
    epilogue in ``out_dtype`` — the plain version of K2."""
    acc = elementwise_matmul_ref(x, w, mul)
    return apply_epilogue((acc * prescale).to(out_dtype), **epi)


def _check(x, w):
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"CUDA kernel needs x and w on one CUDA device; got {x.device}, {w.device}"
        )
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x [M,K] and w [K,N]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x and w must share float32 or bfloat16; got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (row-major)")
    if x.shape[1] > MAX_K:
        raise ValueError(f"K={x.shape[1]} overflows the int32 accumulator (max {MAX_K})")


def elementwise_matmul_cuda(x, w, mul: str, drop_bits: int = 0):
    """K1: [M,K] @ [K,N] -> [M,N] float32 through the named multiplier."""
    _check(x, w)
    M, K = x.shape
    N = w.shape[1]
    acc = torch.empty((M, N), dtype=torch.int32, device=x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch(
        f"elementwise_matmul[{mul}]", "vpu_matmul", "vpu_matmul",
        _MUL_CODE[mul], _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        acc.data_ptr(), out.data_ptr(), M, N, K, drop_bits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def _row_operand(v, N: int, dtype, device) -> Optional[torch.Tensor]:
    """An epilogue vector (scalar, [N] or [1, N]) as a contiguous [N]."""
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=dtype, device=device).reshape(-1)
    if v.numel() not in (1, N):
        raise ValueError(f"epilogue vector must have 1 or N={N} entries; got {v.numel()}")
    return v.expand(N).contiguous()


@dataclasses.dataclass
class EpilogueOperands:
    """The per-row prescale and the epilogue ``epi`` of a fused kernel, as
    the C entry points take them (holds the tensors while they run)."""

    pre: torch.Tensor
    gain: Optional[torch.Tensor]
    add: Optional[torch.Tensor]
    coeffs: Optional[torch.Tensor]
    P: int
    mean_scale: float
    eps: float

    def pointers(self) -> tuple:
        """``pre, gain, add, coeffs, P, mean_scale, eps`` (NULL for absent)."""
        ptr = lambda t: None if t is None else t.data_ptr()
        return (self.pre.data_ptr(), ptr(self.gain), ptr(self.add), ptr(self.coeffs),
                self.P, self.mean_scale, self.eps)


def epilogue_operands(M: int, N: int, prescale, epi: Dict, out_dtype, dev) -> EpilogueOperands:
    """Check and lay out a fused kernel's prescale (a scalar or one value
    per row) and epilogue operands (see :func:`repro_torch.kernels.
    epilogue.apply_epilogue`)."""
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16; got {out_dtype}")
    if epi.get("colgain") is not None and epi.get("coladd") is None:
        raise ValueError("epilogue colgain needs coladd")
    pre = torch.as_tensor(prescale, device=dev).to(torch.float32).reshape(-1)
    pre = pre.expand(M).contiguous() if pre.numel() == 1 else pre.contiguous()
    if pre.numel() != M:
        raise ValueError(f"prescale must have M={M} entries; got {pre.numel()}")
    coeffs = epi.get("mean_coeffs")
    P, mean_scale = 0, 1.0
    if coeffs is not None:
        coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev).reshape(-1).contiguous()
        P = coeffs.numel()
        mean_scale = float(torch.as_tensor(epi["mean_scale"], dtype=torch.float32))
    return EpilogueOperands(
        pre=pre,
        gain=_row_operand(epi.get("colgain"), N, out_dtype, dev),
        add=_row_operand(epi.get("coladd"), N, out_dtype, dev),
        coeffs=coeffs, P=P, mean_scale=mean_scale,
        eps=float(torch.tensor(ROW_EPS, dtype=out_dtype)),  # eps as the epilogue's dtype holds it
    )


def elementwise_matmul_fused_cuda(
    x, w, mul: str, prescale, epi: Dict, out_dtype, drop_bits: int = 0
):
    """K2: K1's contraction with the per-token prescale, the cast to
    ``out_dtype`` and the MODEL-mode epilogue ``epi`` (see
    :func:`repro_torch.kernels.epilogue.apply_epilogue`) in one call."""
    _check(x, w)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    ops = epilogue_operands(M, N, prescale, epi, out_dtype, dev)
    acc = torch.empty((M, N), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    build.launch(
        f"elementwise_matmul_fused[{mul}]", "vpu_matmul", "vpu_matmul_fused",
        _MUL_CODE[mul], _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        x.data_ptr(), w.data_ptr(), *ops.pointers(), acc.data_ptr(), out.data_ptr(),
        M, N, K, drop_bits, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out
