"""Multiplier-error contractions: the CUDA kernels K1/K2 and the plain
fused versions (port of ``repro.kernels.vpu_matmul``, and of the operand
quantisation ``repro.core.backends._int_operand_quantize`` that K2 takes
in).

``elementwise_matmul_cuda`` (K1 on integer-valued operands, the reference
kernel's interface), ``int_operand_matmul_fused_cuda`` (the operands
themselves, the serving path: K2 at M <= 4 rows, the prefill projection
at more) and ``elementwise_matmul_fused_cuda`` (K2 on integer-valued
operands, the reference kernel's interface) launch ``csrc/vpu_matmul.cu``;
the multiplier is picked by name (``"approx_mult"`` or ``"log_mult"``),
since the per-product op lives in the CUDA source.  Their plain versions
are :func:`repro_torch.kernels.ref.elementwise_matmul_ref`,
:func:`int_operand_matmul_fused_ref` and :func:`elementwise_matmul_fused_ref`
below.  With more than 4 rows, the truncated product of operands of at
most 7 bits with at most 4 dropped bits runs on the int8 tensor cores
through the slot identity of :func:`truncated_slots` (the source's note
gives the routes).

The integer entries take integer-valued float32 or bfloat16 tensors of
magnitude at most 255 (what the operand quantisation produces; K1: at
most ``2^bits - 1``, and it refuses more).  The kernels read them as integers: a non-integer
operand is rounded to the nearest integer, where the plain version would
multiply it as a float.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.proxy import OPERAND_EPS, row_scale, tensor_scale
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import ROW_EPS, apply_epilogue
from repro_torch.kernels.ref import approx_mul, const, elementwise_matmul_ref, mitchell_mul

_MUL_CODE = {"approx_mult": 0, "log_mult": 1}
# K * 255 * 255 must fit the int32 accumulator
MAX_K = (2**31 - 1) // (255 * 255)
MAX_BITS = 8  # operands of at most 8 bits: |xi|, |wi| <= 255
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def plain_multiplier(mul: str, drop_bits: int = 0) -> Callable:
    """The named multiplier as the plain versions take it."""
    if mul == "approx_mult":
        return lambda a, b: approx_mul(a, b, drop_bits)
    if mul == "log_mult":
        return mitchell_mul
    raise ValueError(f"unknown multiplier {mul!r}; expected one of {sorted(_MUL_CODE)}")


def int_operand_quantize(x, w, bits: int):
    """Per-token dynamic quantisation to signed integer magnitudes, plus
    the value-domain prescale that undoes it after the contraction (the
    reference's ``_int_operand_quantize``, op for op)."""
    levels = (1 << bits) - 1
    sx = row_scale(x)
    sw = tensor_scale(w)
    xi = torch.round(torch.clamp(x / sx, -1.0, 1.0) * levels)
    wi = torch.round(torch.clamp(w / sw, -1.0, 1.0) * levels)
    return xi, wi, sx * sw / const(levels * levels, sx)


def elementwise_matmul_fused_ref(
    x, w, mul: Callable, prescale, epi: Dict, out_dtype
):
    """K1's contraction, ``(acc * prescale).to(out_dtype)``, then the
    epilogue in ``out_dtype`` — the plain version of K2 on integer-valued
    operands."""
    acc = elementwise_matmul_ref(x, w, mul)
    return apply_epilogue((acc * prescale).to(out_dtype), **epi)


def int_operand_matmul_fused_ref(x, w, bits: int, mul: Callable, epi: Dict, out_dtype):
    """The plain version of K2 on the operands themselves: x [M, K] and w
    [K, N] quantised by :func:`int_operand_quantize`, then
    :func:`elementwise_matmul_fused_ref` with its prescale."""
    xi, wi, prescale = int_operand_quantize(x, w, bits)
    return elementwise_matmul_fused_ref(xi, wi, mul, prescale, epi, out_dtype)


def truncated_slots(a, b, drop_bits: int):
    """The slots through which the tensor-core route sums truncated
    products: ``A'`` [..., S] of integer-valued ``a`` and ``B'`` [..., S]
    of ``b`` (int64), S = max(16, 2^drop_bits), with ``(A' * B').sum(-1) ==
    approx_mul(a, b, drop_bits)`` for any integers.  Slot 0 is the exact
    product; slot j = 1..S-1 takes ``-sign(a) ((r(a) j) mod 2^d)`` against
    ``sign(b) [r(b) == j]``, r(v) = |v| mod 2^d (the plain version of
    ``k1::a_slots`` and ``k1::b_slots``, whose 16 int8 slots hold these for
    |a|, |b| <= 127 and ``drop_bits`` <= 4)."""
    low = (1 << drop_bits) - 1
    a, b = a.to(torch.int64), b.to(torch.int64)
    j = torch.arange(max(16, low + 1), dtype=torch.int64, device=a.device)
    ra, rb = (a.abs() & low)[..., None], (b.abs() & low)[..., None]
    sa, sb = torch.sign(a)[..., None], torch.sign(b)[..., None]
    ap = torch.where(j == 0, a[..., None], -sa * ((ra * j) & low))
    bp = torch.where(j == 0, b[..., None], sb * (rb == j).to(torch.int64))
    return ap, bp


def weight_layout(w) -> int:
    """0 for a row-major [K, N] weight; 1 for the transpose of a row-major
    [N, K] tensor (``embed.T``, a tied LM head's weight), which the serving
    entries read in place; else a ``ValueError``."""
    if w.is_contiguous():
        return 0
    if w.dim() == 2 and w.t().is_contiguous():
        return 1
    raise ValueError(f"w must be row-major [K, N], or the transpose of a row-major [N, K]; "
                     f"got strides {tuple(w.stride())} for shape {tuple(w.shape)}")


def _check(x, w, transposed_ok: bool = False) -> int:
    """The operands' checks; returns :func:`weight_layout` (1 only where
    ``transposed_ok``)."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"CUDA kernel needs x and w on one CUDA device; got {x.device}, {w.device}"
        )
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x [M,K] and w [K,N]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x and w must share float32 or bfloat16; got {x.dtype}, {w.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major)")
    w_nk = weight_layout(w)
    if w_nk and not transposed_ok:
        raise ValueError("w must be contiguous (row-major)")
    if x.shape[1] > MAX_K:
        raise ValueError(f"K={x.shape[1]} overflows the int32 accumulator (max {MAX_K})")
    return w_nk




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

    pre: Optional[torch.Tensor]
    gain: Optional[torch.Tensor]
    add: Optional[torch.Tensor]
    coeffs: Optional[torch.Tensor]  # the P coefficients, then the scale
    P: int
    eps: float

    def pointers(self) -> tuple:
        """``pre, gain, add, coeffs, P, eps`` (NULL for absent)."""
        ptr = lambda t: None if t is None else t.data_ptr()
        return (ptr(self.pre), ptr(self.gain), ptr(self.add), ptr(self.coeffs), self.P,
                self.eps)


@functools.lru_cache(maxsize=None)
def _in_dtype(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(v, dtype=dtype))


def epilogue_operands(M: int, N: int, prescale, epi: Dict, out_dtype, dev) -> EpilogueOperands:
    """Check and lay out a fused kernel's prescale (a scalar or one value
    per row; None where the kernel computes it) and epilogue operands (see
    :func:`repro_torch.kernels.epilogue.apply_epilogue`)."""
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16; got {out_dtype}")
    if epi.get("colgain") is not None and epi.get("coladd") is None:
        raise ValueError("epilogue colgain needs coladd")
    pre = None
    if prescale is not None:
        pre = torch.as_tensor(prescale, device=dev).to(torch.float32).reshape(-1)
        pre = pre.expand(M).contiguous() if pre.numel() == 1 else pre.contiguous()
        if pre.numel() != M:
            raise ValueError(f"prescale must have M={M} entries; got {pre.numel()}")
    coeffs = epi.get("mean_coeffs")
    P = 0
    if coeffs is not None:
        # the scale rides after the coefficients, on the device: the kernel
        # reads it there, so a call never waits to read it back
        coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev).reshape(-1)
        P = coeffs.numel()
        scale = torch.as_tensor(epi["mean_scale"], dtype=torch.float32, device=dev)
        coeffs = torch.cat([coeffs, scale.reshape(1)])
    return EpilogueOperands(
        pre=pre,
        gain=_row_operand(epi.get("colgain"), N, out_dtype, dev),
        add=_row_operand(epi.get("coladd"), N, out_dtype, dev),
        coeffs=coeffs, P=P,
        eps=_in_dtype(ROW_EPS, out_dtype),  # eps as the epilogue's dtype holds it
    )


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# (device, stream) -> K1's and K2's int32 words that are zero between
# calls: the accumulators, which the finishing passes clear after reading
# them, and the scale pass's maxima and block count, which its last block
# clears.  So a call launches no memset.  Zero-filled when first made or
# grown.
_CLEAR: Dict[Tuple[int, int], torch.Tensor] = {}


def _clear_words(dev, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _CLEAR.get(key)
    if buf is None or buf.numel() < n:
        buf = _CLEAR[key] = torch.zeros((n,), dtype=torch.int32, device=dev)
    return buf


def _launch_clearing(dev, stream: int, kernel: str, entry: str, *args) -> None:
    try:
        build.launch(kernel, "vpu_matmul", entry, *args)
    except RuntimeError:
        _CLEAR.pop((dev.index, stream), None)  # a pass may not have cleared its words
        raise


def elementwise_matmul_fused_cuda(
    x, w, mul: str, prescale, epi: Dict, out_dtype, drop_bits: int = 0
):
    """K2 on integer-valued operands: K1's contraction with the per-token
    prescale, the cast to ``out_dtype`` and the MODEL-mode epilogue ``epi``
    (see :func:`repro_torch.kernels.epilogue.apply_epilogue`) in one call:
    two launches."""
    _check(x, w)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    ops = epilogue_operands(M, N, prescale, epi, out_dtype, dev)
    stream = _stream(dev)
    acc = _clear_words(dev, stream, M * N)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _launch_clearing(
        dev, stream, f"elementwise_matmul_fused[{mul},int]", "vpu_matmul_fused",
        _MUL_CODE[mul], _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        x.data_ptr(), w.data_ptr(), *ops.pointers(), acc.data_ptr(), out.data_ptr(),
        M, N, K, drop_bits, stream,
    )
    return out


def _prefill_scratch(mul: str, M: int, N: int, K: int, bits: int, drop_bits: int, dev):
    """The tensor-core route's A' (16 bytes an activation; one word off it)
    and a prefill contraction's split planes of int32 sums (None at M <= 4:
    the decode contraction adds into cleared accumulators)."""
    so, code = build.lib("vpu_matmul"), _MUL_CODE[mul]
    words = so.vpu_slot_words(code, M, K, bits, drop_bits)
    planes = so.vpu_plane_count(code, M, N, K, bits, drop_bits)
    slots = torch.empty((max(words, 1), 16), dtype=torch.uint8, device=dev)
    sums = torch.empty((planes, M, N), dtype=torch.int32, device=dev) if planes else None
    return slots, sums


def _check_range(x, w, bits: int) -> None:
    """Refuse integer operands past 2^bits - 1 after the kernel's rounding
    (half to even, so |v| >= 2^bits - 1/2 is past): the route that
    ``bits`` picks computes only those (one reduction of each operand and
    a synchronisation; the integer entry is off the serving path)."""
    if x.numel() == 0 or w.numel() == 0:
        return
    lim = (1 << bits) - 0.5
    ext = torch.stack([t.float() for v in (x, w) for t in torch.aminmax(v)])
    if not bool((ext.abs() < lim).all()):
        big = ext.abs().max().item()
        raise ValueError(f"operands of {bits} bits have |v| <= {(1 << bits) - 1}; got {big}")


def elementwise_matmul_cuda(x, w, mul: str, drop_bits: int = 0, bits: int = MAX_BITS):
    """K1: [M,K] @ [K,N] -> [M,N] float32 through the named multiplier, on
    integer-valued operands of at most ``bits`` bits (|v| <= 2^bits - 1):
    two or three launches, no memset."""
    _check(x, w)
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"the CUDA kernel takes operands of 1 to {MAX_BITS} bits; got {bits}")
    _check_range(x, w, bits)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    stream = _stream(dev)
    slots, acc = _prefill_scratch(mul, M, N, K, bits, drop_bits, dev)
    if acc is None:
        acc = _clear_words(dev, stream, M * N)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    _launch_clearing(
        dev, stream, f"elementwise_matmul[{mul}]", "vpu_matmul",
        _MUL_CODE[mul], _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), slots.data_ptr(),
        acc.data_ptr(), out.data_ptr(), M, N, K, bits, drop_bits, stream,
    )
    return out


def int_operand_matmul_fused_cuda(
    x, w, bits: int, mul: str, epi: Dict, out_dtype, drop_bits: int = 0
):
    """The operands themselves: x [M, K] and w [K, N] (float32 or
    bfloat16; w row-major, or the transpose of a row-major [N, K] tensor,
    read in place: a tied LM head's ``embed.T``) quantised to ``bits``-bit
    integers as :func:`int_operand_quantize` does, contracted through the named
    multiplier, rescaled, cast to ``out_dtype`` and passed through the
    epilogue ``epi``: three launches (the scale pass, the contraction and
    the finishing pass), each weight read from device memory by the first
    two only.  M <= 4 rows is K2, the decode projection; more rows are the
    prefill projection (K1's function with the quantisation taken in),
    counted as ``elementwise_matmul[{mul},quantized]``.  A transposed
    weight counts as the ``[N, K]`` entry: ``elementwise_matmul_fused[{mul},
    nk]`` and ``elementwise_matmul[{mul},quantized,nk]``."""
    w_nk = _check(x, w, transposed_ok=True)
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"the CUDA kernel takes operands of 1 to {MAX_BITS} bits; got {bits}")
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    ops = epilogue_operands(M, N, None, epi, out_dtype, dev)
    stream = _stream(dev)
    slots, acc = _prefill_scratch(mul, M, N, K, bits, drop_bits, dev)
    decode = acc is None  # K2's contraction: it adds into cleared accumulators
    if decode:  # cleared accumulators, then the scale pass's 2 + M words
        acc = _clear_words(dev, stream, M * N + 2 + M)
        hold = acc[M * N:]
    else:
        hold = _clear_words(dev, stream, 2 + M)
    scales = torch.empty((build.lib("vpu_matmul").vpu_scales_words(M),), dtype=torch.float32,
                         device=dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    levels = (1 << bits) - 1
    # the [N, K] entry (a tied LM head) counts apart: its loads differ
    nk = ",nk" if w_nk else ""
    kernel = f"elementwise_matmul_fused[{mul}{nk}]" if decode else \
        f"elementwise_matmul[{mul},quantized{nk}]"
    _launch_clearing(
        dev, stream, kernel, "vpu_quantize_matmul_fused",
        _MUL_CODE[mul], _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        x.data_ptr(), w.data_ptr(), hold.data_ptr(), scales.data_ptr(),
        slots.data_ptr(), bits,
        float(levels), _in_dtype(levels * levels, x.dtype), _in_dtype(OPERAND_EPS, x.dtype),
        *ops.pointers()[1:], acc.data_ptr(), out.data_ptr(), M, N, K, drop_bits, w_nk, stream,
    )
    return out
