"""Plain PyTorch versions of the emulation contractions (port of
``repro.kernels.ref``: ``sc_pack_streams``, ``sc_matmul_packed_ref``,
``sc_matmul_packed_chunked_ref``, ``sc_matmul_ref``, ``adc_quantize``,
``analog_matmul_ref``, ``approx_mul``, ``approx_mult_matmul_ref``,
``mitchell_mul``, ``log_matmul_ref``, ``elementwise_matmul_chunked_ref``).

These are what CPU tensors run and what ``chip_smoke.py`` holds the CUDA
kernels against, so each bounds its scratch memory at full width.

Stochastic computing.  Packed stream words are int32 tensors holding the
bits of the reference's uint32 words (bit j of word w is stream bit
32 w + j).  The generator draws are arguments: ``repro.kernels.ref.
sc_matmul_ref`` draws them itself with ``jax.random``; the port makes
the same draws, bit for bit, in ``repro_torch.kernels.prng``.

Analog arrays.  Each array's partial sum is a float64 product rounded
once to float32.  For the emulator's operands (bf16 values on 8-bit
grids in [0, 1]) the float64 sum is exact, so it does not depend on the
order of the terms, which makes it the value the CUDA kernel computes
bit for bit.  A weight plane may be given as a ``(top, bottom)`` pair of
[K, N] halves standing for ``concatenate([top, bottom])``; its rows are
read per array and the plane is never built.

Divisions by a constant divide by a tensor on the operand's device:
PyTorch computes ``a / python_float`` on a CUDA tensor as ``a * (1/b)``,
which is not the correctly rounded quotient the reference and the
kernels use.

Multiplier-error contractions.  Two choices differ from the jnp
oracles, both to make the function exact rather than to change it:

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

import functools
from typing import Callable

import torch

# elements of one [M, chunk, N] product slab (bounds the plain version's
# scratch memory at full width: ~0.5 GiB per float32 temporary)
_SLAB = 1 << 27


@functools.lru_cache(maxsize=256)
def _full(v: float, dtype, device):
    return torch.full((), v, dtype=dtype, device=device)


def const(v: float, like):
    """A Python constant as a 0-dim tensor of ``like``'s dtype and device
    (cached, never written to): what JAX's weak typing makes of a
    constant that meets an array."""
    return _full(float(v), like.dtype, like.device)


def _div(a, d: float):
    """``a / d`` correctly rounded on every device (see module docstring)."""
    return a / const(d, a)


# ---------------------------------------------------------------------------
# Stochastic computing
# ---------------------------------------------------------------------------


def _to_int32_bits(v):
    """int64 values in [0, 2^32) as int32 tensors with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def sc_pack_streams(p, u):
    """Threshold-compare probabilities against generator sequences and
    pack the bit-streams into 32-bit words.

    p: [...] probabilities in [0, 1]
    u: generator values broadcastable against ``p[..., None]``, last axis
       the stream length L (e.g. [1, L] shared by every port of an
       activation [M, K], [K, 1, L] one per row of a weight [K, N])
    returns: [..., L // 32] int32 words, bit j of word w = p > u[32 w + j]
    """
    L = u.shape[-1]
    assert L % 32 == 0, "stream length must pack into 32-bit words"
    p = p.to(torch.float32)
    words = []
    for w in range(L // 32):
        word = None
        for j in range(32):
            bit = (p > u[..., 32 * w + j]).to(torch.int64) << j
            word = bit if word is None else word | bit
        words.append(_to_int32_bits(word))
    return torch.stack(words, dim=-1)


def _popcount(words):
    """Set bits of each int32 word, as int64."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _or_reduce(t, dim: int):
    """OR over one axis, as a tree of pairwise ORs."""
    while t.shape[dim] > 1:
        n = t.shape[dim]
        half = n // 2
        a, b = t.narrow(dim, 0, half), t.narrow(dim, half, half)
        out = a | b
        if n % 2:
            out = torch.cat([out, t.narrow(dim, n - 1, 1)], dim=dim)
        t = out
    return t.squeeze(dim)


def sc_matmul_packed_ref(xbits, wbits):
    """OR-accumulated AND-product contraction over packed streams, one
    port at a time (the reference's fori_loop).

    xbits: [M, K, W] int32, wbits: [K, N, W] int32
    returns: [M, N] float32 — popcount(OR_k(x & w)) summed over words.
    """
    M, K, W = xbits.shape
    N = wbits.shape[1]
    acc = torch.zeros((M, N, W), dtype=torch.int32, device=xbits.device)
    for k in range(K):
        acc |= xbits[:, k, None, :] & wbits[None, k, :, :]
    return _popcount(acc).sum(-1).to(torch.float32)


def sc_matmul_packed_chunked_ref(xbits, wbits, chunk: int = 0):
    """K-chunked variant of :func:`sc_matmul_packed_ref`: each chunk ANDs
    as one batched op and OR-reduces as a tree.  OR is order-free, so the
    result is bitwise identical.  ``chunk`` 0 sizes the chunks so the
    [M, chunk, N, W] temporary stays within ``_SLAB`` elements."""
    M, K, W = xbits.shape
    N = wbits.shape[1]
    if chunk <= 0:
        chunk = max(1, min(K, _SLAB // max(M * N * W, 1)))
    acc = torch.zeros((M, N, W), dtype=torch.int32, device=xbits.device)
    for k0 in range(0, K, chunk):
        prod = xbits[:, k0 : k0 + chunk, None, :] & wbits[None, k0 : k0 + chunk, :, :]
        acc |= _or_reduce(prod, 1)
    return _popcount(acc).sum(-1).to(torch.float32)


def _plane_rows(w, k0: int, k1: int):
    """Rows k0..k1-1 of a plane given as a tensor or a (top, bottom) pair
    of halves (see module docstring)."""
    if isinstance(w, torch.Tensor):
        return w[k0:k1]
    top, bottom = w
    K = top.shape[0]
    if k1 <= K:
        return top[k0:k1]
    if k0 >= K:
        return bottom[k0 - K : k1 - K]
    return torch.cat([top[k0:], bottom[: k1 - K]])


def _plane_shape(w):
    if isinstance(w, torch.Tensor):
        return w.shape[0], w.shape[1]
    return 2 * w[0].shape[0], w[0].shape[1]


def sc_matmul_ref(xp, w, n_bits: int, ux, uw):
    """Full SC emulation: stream generation + packed contraction.

    xp: [M, K] probabilities; w: [K, N] probabilities (or a (top, bottom)
    pair); ux: [1, n_bits] generator values shared by every activation
    port; uw: [K, n_bits], one sequence per weight row.  Returns the
    OR-accumulated stream value r in [0, 1]: [M, N] float32.  Weight
    streams are packed a block of columns at a time.
    """
    K, N = _plane_shape(w)
    M = xp.shape[0]
    xbits = sc_pack_streams(xp, ux.reshape(1, n_bits))
    rows = [_plane_rows(w, 0, K)] if isinstance(w, torch.Tensor) else list(w)
    W = n_bits // 32
    block = max(1, min(N, _SLAB // max(K * 8, M * 8 * W, 1)))
    counts = torch.empty((M, N), dtype=torch.float32, device=xp.device)
    for n0 in range(0, N, block):
        plane = torch.cat([r[:, n0 : n0 + block] for r in rows])
        wbits = sc_pack_streams(plane, uw[:, None, :])
        counts[:, n0 : n0 + block] = sc_matmul_packed_chunked_ref(xbits, wbits)
    return _div(counts, n_bits)


# ---------------------------------------------------------------------------
# Analog arrays with ADC partial-sum quantisation
# ---------------------------------------------------------------------------


def adc_quantize(psum, adc_bits: int, adc_range: float):
    """Clamp a unipolar partial sum to the ADC range, round to 2^b - 1
    levels (half to even), and min with the range, one rounding per op
    (``repro.kernels.analog_matmul._adc_quantize``; the trailing min is a
    no-op that ``repro.kernels.ref.adc_quantize`` leaves out)."""
    levels = (1 << adc_bits) - 1
    clamped = torch.clamp(psum, 0.0, adc_range)
    q = _div(torch.round(_div(clamped, adc_range) * levels), levels) * adc_range
    return torch.minimum(q, const(adc_range, q))


def analog_matmul_ref(x, w, array_size: int, adc_bits: int, adc_range: float):
    """x: [M, K] unipolar (>= 0), w: [K, N] unipolar (or a (top, bottom)
    pair).  Every ``array_size`` slice of K is one physical analog array;
    its partial sum (float64, rounded once to float32) passes through the
    ADC, and the arrays add up in float32 in order."""
    K, N = _plane_shape(w)
    M = x.shape[0]
    x64 = x.to(torch.float64)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, array_size):
        k1 = min(K, k0 + array_size)
        psum = (x64[:, k0:k1] @ _plane_rows(w, k0, k1).to(torch.float64)).to(torch.float32)
        acc = acc + adc_quantize(psum, adc_bits, adc_range)
    return acc


# ---------------------------------------------------------------------------
# Multiplier-error contractions
# ---------------------------------------------------------------------------


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
