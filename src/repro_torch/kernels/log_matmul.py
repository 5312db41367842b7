"""Matmul through the Mitchell log-domain multiplier (port of
``repro.kernels.log_matmul``): the K1/K2 CUDA kernels instantiated with
Mitchell's product, computed in integer arithmetic in the kernel."""
from __future__ import annotations

from repro_torch.kernels.vpu_matmul import (
    elementwise_matmul_cuda,
    elementwise_matmul_fused_cuda,
    int_operand_matmul_fused_cuda,
)


def log_matmul(x, w):
    """x: [M, K] integer-valued (|x| <= 255), w: [K, N] likewise -> [M, N] f32."""
    return elementwise_matmul_cuda(x, w, "log_mult")


def log_matmul_fused(x, w, prescale, epi: dict, out_dtype):
    """Mitchell-multiplier matmul with the per-token rescale and the
    chip/calibration epilogue in the same call."""
    return elementwise_matmul_fused_cuda(x, w, "log_mult", prescale, epi, out_dtype)


def log_matmul_quantized(x, w, bits: int, epi: dict, out_dtype):
    """x [M, K] and w [K, N] as they are (float32 or bfloat16), quantised
    to ``bits``-bit integers in the kernel, then the Mitchell-multiplier
    matmul with the rescale and the epilogue in the same call."""
    return int_operand_matmul_fused_cuda(x, w, bits, "log_mult", epi, out_dtype)
