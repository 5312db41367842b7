"""Dispatch wrappers around the emulation kernels (port of
``repro.kernels.ops``).

Each wrapper picks by the device of its inputs: a CPU tensor takes the
plain PyTorch version, a CUDA tensor takes the hand-written kernel, and
any other device raises.  There is no switch that sends a CUDA tensor to
the plain version.  Registry specs carry these wrappers as their kernel
handles (:data:`KERNELS`).
"""
from __future__ import annotations


from repro_torch.kernels import approx_mult as _amult
from repro_torch.kernels import flash_decode as _flash
from repro_torch.kernels import log_matmul as _log
from repro_torch.kernels import ref as kref
from repro_torch.kernels.vpu_matmul import elementwise_matmul_fused_ref


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        f"kernels take CPU tensors (plain version) or CUDA tensors (kernel); "
        f"got devices {sorted(str(t.device) for t in tensors)}"
    )


def approx_mult_matmul(x, w, mult_bits: int, perforate: int):
    """Integer-valued [M,K] @ [K,N] through the approximate multiplier."""
    if _on_cuda(x, w):
        return _amult.approx_mult_matmul(x, w, mult_bits, perforate)
    return kref.approx_mult_matmul_ref(x, w, mult_bits, perforate)


def log_matmul(x, w):
    """Integer-valued [M,K] @ [K,N] through the Mitchell log multiplier."""
    if _on_cuda(x, w):
        return _log.log_matmul(x, w)
    return kref.log_matmul_ref(x, w)


def approx_mult_matmul_fused(
    x, w, mult_bits: int, perforate: int, prescale, epi: dict, out_dtype
):
    """Approximate-multiplier contraction with the fused epilogue."""
    if _on_cuda(x, w):
        return _amult.approx_mult_matmul_fused(
            x, w, mult_bits, perforate, prescale, epi, out_dtype
        )
    drop_bits = 2 * perforate
    return elementwise_matmul_fused_ref(
        x, w, lambda a, b: kref.approx_mul(a, b, drop_bits), prescale, epi, out_dtype
    )


def log_matmul_fused(x, w, prescale, epi: dict, out_dtype):
    """Mitchell-multiplier contraction with the fused epilogue."""
    if _on_cuda(x, w):
        return _log.log_matmul_fused(x, w, prescale, epi, out_dtype)
    return elementwise_matmul_fused_ref(
        x, w, kref.mitchell_mul, prescale, epi, out_dtype
    )


def flash_decode_attention(q, cache_k, cache_v, pos_vec):
    """Online-softmax decode attention (``q`` [B,KV,G,dh] against caches
    [B,S,KV,dh] at per-row ``pos_vec``) -> [B,KV,G,dh] float32."""
    if _on_cuda(q, cache_k, cache_v):
        return _flash.flash_decode(q, cache_k, cache_v, pos_vec)
    return _flash.flash_decode_ref(q, cache_k, cache_v, pos_vec)


# Named kernel handles per approximate backend (BackendSpec.kernels).
KERNELS = {
    "approx_mult": {
        "matmul": approx_mult_matmul,
        "matmul_fused": approx_mult_matmul_fused,
    },
    "log_mult": {"matmul": log_matmul, "matmul_fused": log_matmul_fused},
}
