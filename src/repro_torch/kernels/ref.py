"""Plain PyTorch versions of the multiplier-error contractions
(port of ``repro.kernels.ref``: ``approx_mul``, ``approx_mult_matmul_ref``,
``mitchell_mul``, ``log_matmul_ref``, ``elementwise_matmul_chunked_ref``).

These are what CPU tensors run and what ``chip_smoke.py`` holds the CUDA
kernels against.  Two choices differ from the jnp oracles, both to make
the function exact rather than to change it:

* ``mitchell_mul`` takes ``floor(log2 ·)`` from ``frexp`` and builds
  ``2^k`` from exponent bits.  ``jnp.exp2`` on XLA:CPU is not exact at
  some integer arguments (2^13 evaluates to 8192.0039), so the reference
  returns non-integer products there; these return the exact integer.
* The contraction sums integer-valued products in float64, which is
  exact for any order at these operand widths (|product| <= 65025, K <
  33025), then rounds once to float32.  That equals the reference's
  sequential float32 sum wherever that sum is exact (partial sums below
  2^24) and equals the CUDA kernels' int32 sum everywhere.
"""
from __future__ import annotations

from typing import Callable

import torch

# elements of one [M, chunk, N] product slab (bounds the plain version's
# scratch memory at full width: ~0.5 GiB per float32 temporary)
_SLAB = 1 << 27


def approx_mul(a, b, drop_bits: int):
    """Behavioural truncated multiplier: the product's low ``drop_bits``
    bits are never formed.  Signed via sign(ab) * approx(|ab|).  Exact in
    float32 for 7-bit integer operands."""
    prod = a * b
    scale = float(1 << drop_bits)
    mag = torch.floor(torch.abs(prod) / scale) * scale
    return torch.sign(prod) * mag


def _floor_log2(v):
    """floor(log2 v) for v >= 1, from the float's exponent bits."""
    return torch.frexp(v)[1] - 1


def _exp2i(k):
    """2**k as float32 for integer k in [-126, 127], built from bits."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def mitchell_mul(a, b):
    """Mitchell's logarithmic multiplier on integer magnitudes.

    With |a| = 2^ka (1+ma), |b| = 2^kb (1+mb) and m = ma+mb, the product
    is read back as 2^(ka+kb) (1+m) when m < 1 and 2^(ka+kb+1) m on
    mantissa-sum carry.  Signed via sign(ab); zero operands give 0.
    Operands are float32 holding integers of at most 8 bits.
    """
    absa, absb = torch.abs(a), torch.abs(b)
    nonzero = (absa >= 1.0) & (absb >= 1.0)
    sa = torch.clamp_min(absa, 1.0)  # keep log2 defined on the dead lanes
    sb = torch.clamp_min(absb, 1.0)
    ka = _floor_log2(sa)
    kb = _floor_log2(sb)
    m = sa / _exp2i(ka) + sb / _exp2i(kb) - 2.0  # ma + mb, in [0, 2)
    mag = _exp2i(ka + kb) * torch.where(m < 1.0, 1.0 + m, 2.0 * m)
    return torch.sign(a) * torch.sign(b) * torch.where(nonzero, mag, 0.0)


def elementwise_matmul_ref(x, w, mul: Callable):
    """[M,K] @ [K,N] -> [M,N] float32 with every product through ``mul``,
    K-chunked into [M, chunk, N] slabs and summed exactly (see module
    docstring)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    M, K = x.shape
    N = w.shape[1]
    chunk = max(1, min(K, _SLAB // max(M * N, 1)))
    acc = torch.zeros((M, N), dtype=torch.float64, device=x.device)
    for k0 in range(0, K, chunk):
        prod = mul(x[:, k0 : k0 + chunk, None], w[None, k0 : k0 + chunk, :])
        acc += prod.sum(dim=1, dtype=torch.float64)
    return acc.to(torch.float32)


def approx_mult_matmul_ref(x, w, mult_bits: int, perforate: int):
    """Integer-valued [M,K] @ [K,N] through the truncated multiplier, with
    exact accumulation (error enters multiplies only — paper Sec. 3.1)."""
    del mult_bits
    drop_bits = 2 * perforate
    return elementwise_matmul_ref(x, w, lambda a, b: approx_mul(a, b, drop_bits))


def log_matmul_ref(x, w):
    """Integer-valued [M,K] @ [K,N] through the Mitchell multiplier, with
    exact accumulation."""
    return elementwise_matmul_ref(x, w, mitchell_mul)
