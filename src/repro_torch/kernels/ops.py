"""Dispatch wrappers around the emulation kernels (port of
``repro.kernels.ops``).

Each wrapper picks by the device of its inputs: a CPU tensor takes the
plain PyTorch version, a CUDA tensor takes the hand-written kernel, and
any other device raises.  There is no switch that sends a CUDA tensor to
the plain version.  Registry specs carry these wrappers as their kernel
handles (:data:`KERNELS`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import analog_matmul as _analog
from repro_torch.kernels import approx_mult as _amult
from repro_torch.kernels import flash_decode as _flash
from repro_torch.kernels import log_matmul as _log
from repro_torch.kernels import prng as _prng
from repro_torch.kernels import ref as kref
from repro_torch.kernels import sc_matmul as _sc
from repro_torch.kernels.vpu_matmul import (
    elementwise_matmul_fused_ref,
    int_operand_matmul_fused_ref,
    plain_multiplier,
)


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


def sc_draws(key: Tuple[int, ...], n_ports: int, n_bits: int, device):
    """The generator sequences of one SC projection: ``ux`` [1, n_bits],
    shared by every activation port, and ``uw`` [n_ports, n_bits], one
    per weight row, uniform in [0, 1) as float32.

    ``key`` is the projection's key path (a root seed, then the values
    folded in: engine tick, layer, site; see :class:`repro_torch.core.
    approx_linear.ApproxCtx`).  The draws are the reference's bit for bit
    (``PRNGKey``, the ``fold_in``s, ``split``, ``jax.random.uniform``;
    :mod:`repro_torch.kernels.prng`), on the CPU by the plain version and
    on the card by one launch of ``csrc/prng.cu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return _prng.sc_draws_cuda(_path_on_card(key, device), n_ports, n_bits)
    if device.type == "cpu":
        return _prng.sc_draws_ref(key, n_ports, n_bits)
    raise ValueError(f"SC draws are made on the CPU (plain version) or a CUDA device "
                     f"(kernel); got {device}")


def _path_on_card(key, device):
    # pinned, so the copy is queued on the stream and the host does not wait
    words = torch.tensor(_prng.path_words(key), dtype=torch.int32, pin_memory=True)
    return words.to(device, non_blocking=True)


def stochastic_round_bf16(x, path, offset: int = 0):
    """``x`` (float32) rounded to bfloat16 stochastically, with the draws of
    a key path at element counters ``offset ..`` (``jax.random.randint(...,
    0, 2**16)`` of the path's key: :func:`repro_torch.kernels.prng.
    stochastic_round_bf16`).  ``path`` is the path's int32 words
    (:func:`repro_torch.kernels.prng.path_words`) as a tensor on ``x``'s
    device: on the CPU the plain version, on the card one launch of
    ``csrc/prng.cu`` that reads the words there."""
    if _on_cuda(x, path):
        return _prng.stochastic_round_bf16_cuda(path, x.contiguous(), offset)
    words = [int(w) & _prng.MASK for w in path.tolist()]
    return _prng.stochastic_round_bf16(x, _prng.key_of_path(words), offset)


def normal(key: Tuple[int, ...], shape, device):
    """Standard normals (float32) of a key path: ``jax.random.normal`` of
    the path's key (:func:`repro_torch.kernels.prng.normal`), on the CPU by
    the plain version and on the card by one launch of ``csrc/prng.cu``."""
    device = torch.device(device)
    if device.type == "cuda":
        return _prng.normal_cuda(_path_on_card(key, device), shape)
    if device.type == "cpu":
        return _prng.normal(_prng.key_of_path(key), shape)
    raise ValueError(f"normal draws are made on the CPU (plain version) or a CUDA device "
                     f"(kernel); got {device}")


def sc_matmul(xp, w, n_bits: int, draws):
    """Probability-domain [M, 2K] @ [2K, N] through SC streams; ``w`` is the
    plane's ``(top, bottom)`` halves, ``draws`` the generator draws ``(ux,
    uw)`` (on the card, an :class:`repro_torch.kernels.sc_matmul.SCDraws`
    keeps their threshold tables for the next call)."""
    if _on_cuda(xp, *w, *draws):
        return _sc.sc_matmul_cuda(xp, w, n_bits, draws)
    return kref.sc_matmul_ref(xp, w, n_bits, *draws)


def sc_matmul_quantized(x, w, gain: float, n_bits: int, draws):
    """The SC prefill projection from the operands themselves: x [M, K]
    and w [K, N] scaled to probability planes at ``gain``, both output
    polarities through SC streams against ``draws``, their difference
    rescaled and cast to x's dtype."""
    if _on_cuda(x, w, *draws):
        return _sc.sc_matmul_quantized_cuda(x, w, gain, n_bits, draws)
    return _sc.sc_matmul_quantized_ref(x, w, gain, n_bits, draws)


def analog_matmul(x, w, array_size: int, adc_bits: int, adc_range: float):
    """Unipolar [M, 2K] @ [2K, N] with per-array ADC quantisation; ``w`` is
    the plane's ``(top, bottom)`` halves."""
    if _on_cuda(x, *w):
        return _analog.analog_matmul_cuda(x, w, array_size, adc_bits, adc_range)
    return kref.analog_matmul_ref(x, w, array_size, adc_bits, adc_range)


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
    return elementwise_matmul_fused_ref(
        x, w, plain_multiplier("approx_mult", 2 * perforate), prescale, epi, out_dtype
    )


def log_matmul_fused(x, w, prescale, epi: dict, out_dtype):
    """Mitchell-multiplier contraction with the fused epilogue."""
    if _on_cuda(x, w):
        return _log.log_matmul_fused(x, w, prescale, epi, out_dtype)
    return elementwise_matmul_fused_ref(
        x, w, kref.mitchell_mul, prescale, epi, out_dtype
    )


def approx_mult_matmul_quantized(x, w, mult_bits: int, perforate: int, epi: dict, out_dtype):
    """[M,K] @ [K,N] of the operands themselves: quantised to ``mult_bits``
    bits (per-token activation scales, a per-tensor weight scale), through
    the approximate multiplier, rescaled, with the fused epilogue."""
    if _on_cuda(x, w):
        return _amult.approx_mult_matmul_quantized(x, w, mult_bits, perforate, epi, out_dtype)
    return int_operand_matmul_fused_ref(
        x, w, mult_bits, plain_multiplier("approx_mult", 2 * perforate), epi, out_dtype
    )


def log_matmul_quantized(x, w, bits: int, epi: dict, out_dtype):
    """[M,K] @ [K,N] of the operands themselves: quantised to ``bits`` bits,
    through the Mitchell multiplier, rescaled, with the fused epilogue."""
    if _on_cuda(x, w):
        return _log.log_matmul_quantized(x, w, bits, epi, out_dtype)
    return int_operand_matmul_fused_ref(
        x, w, bits, plain_multiplier("log_mult"), epi, out_dtype
    )


def sc_matmul_fused(xcat, w, n_bits: int, draws, prescale, epi: dict, out_dtype):
    """Dual-plane SC stream contraction with the fused epilogue; ``w`` is
    ``(wp, wn)``, the halves of w_pos = [wp; wn] and w_neg = [wn; wp];
    ``draws`` as for :func:`sc_matmul`."""
    if _on_cuda(xcat, *w, *draws):
        return _sc.sc_matmul_fused_cuda(xcat, w, n_bits, draws, prescale, epi, out_dtype)
    return _sc.sc_matmul_fused_ref(xcat, w, n_bits, draws, prescale, epi, out_dtype)


def analog_matmul_fused(
    xcat, w, array_size: int, adc_bits: int, adc_range: float, prescale, epi: dict, out_dtype
):
    """Dual-plane unipolar contraction with ADC quantisation, rescale and
    the fused epilogue; ``w`` is ``(wp, wn)`` as for :func:`sc_matmul_fused`."""
    if _on_cuda(xcat, *w):
        return _analog.analog_matmul_fused_cuda(
            xcat, w, array_size, adc_bits, adc_range, prescale, epi, out_dtype
        )
    return _analog.analog_matmul_fused_ref(
        xcat, w, array_size, adc_bits, adc_range, prescale, epi, out_dtype
    )


def flash_decode_attention(q, cache_k, cache_v, pos_vec):
    """Online-softmax decode attention (``q`` [B,KV,G,dh] against caches
    [B,S,KV,dh] at per-row ``pos_vec``) -> [B,KV,G,dh] float32."""
    if _on_cuda(q, cache_k, cache_v):
        return _flash.flash_decode(q, cache_k, cache_v, pos_vec)
    return _flash.flash_decode_ref(q, cache_k, cache_v, pos_vec)


# Named kernel handles per approximate backend (BackendSpec.kernels).
KERNELS = {
    "sc": {"matmul": sc_matmul, "matmul_fused": sc_matmul_fused},
    "analog": {"matmul": analog_matmul, "matmul_fused": analog_matmul_fused},
    "approx_mult": {
        "matmul": approx_mult_matmul,
        "matmul_fused": approx_mult_matmul_fused,
    },
    "log_mult": {"matmul": log_matmul, "matmul_fused": log_matmul_fused},
}
