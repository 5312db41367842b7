"""Matmul through the behavioural truncated multiplier (port of
``repro.kernels.approx_mult``): the K1/K2 CUDA kernels instantiated with
``sign(ab) * floor(|ab| / 4^p) * 4^p`` as the per-product op."""
from __future__ import annotations

from repro_torch.kernels.vpu_matmul import (
    elementwise_matmul_cuda,
    elementwise_matmul_fused_cuda,
    int_operand_matmul_fused_cuda,
)


def approx_mult_matmul(x, w, mult_bits: int, perforate: int):
    """x: [M, K] integer-valued in [-(2^b-1), 2^b-1], w: [K, N] -> [M, N] f32."""
    _check_bits(mult_bits)
    return elementwise_matmul_cuda(x, w, "approx_mult", 2 * perforate, mult_bits)


def approx_mult_matmul_fused(
    x, w, mult_bits: int, perforate: int, prescale, epi: dict, out_dtype
):
    """Truncated-product matmul with the per-token rescale and the
    chip/calibration epilogue in the same call."""
    _check_bits(mult_bits)
    return elementwise_matmul_fused_cuda(
        x, w, "approx_mult", prescale, epi, out_dtype, 2 * perforate
    )


def approx_mult_matmul_quantized(x, w, mult_bits: int, perforate: int, epi: dict, out_dtype):
    """x [M, K] and w [K, N] as they are (float32 or bfloat16), quantised
    to ``mult_bits``-bit integers in the kernel, then the truncated-product
    matmul with the rescale and the epilogue in the same call."""
    return int_operand_matmul_fused_cuda(
        x, w, mult_bits, "approx_mult", epi, out_dtype, 2 * perforate
    )


def _check_bits(mult_bits: int) -> None:
    if mult_bits > 8:
        raise ValueError(f"the CUDA kernel takes operands of at most 8 bits; got {mult_bits}")
