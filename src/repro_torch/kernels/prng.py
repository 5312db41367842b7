"""Counter-based random numbers, bitwise ``jax.random``'s: threefry2x32
keys, ``fold_in``, ``split`` and float32 ``uniform`` (the port of the
``jax.random`` calls that ``repro.kernels.ops`` makes for SC's generator
sequences), and float32 ``normal`` (the ``jax.random.normal`` of
``repro.core.calibration.sample_error``, INJECT mode's noise), in plain
PyTorch and as the CUDA kernels of ``csrc/prng.cu``.

The layout is the one JAX gives with ``jax_default_prng_impl =
threefry2x32``, ``jax_threefry_partitionable = True`` and 64-bit types
off:

* ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
* ``uniform(key, shape)`` hashes the flat index ``i`` of each element,
  ``(hi, lo) = (i >> 32, i mod 2**32)``, takes ``b0 ^ b1`` of the result,
  keeps its top 23 bits as the mantissa of a float in [1, 2) and
  subtracts 1.

* ``randint(key, shape, 0, 2**16)`` is the low 16 bits of the bits of
  ``split(key)[1]`` (the other stream's multiplier, ``2**32 mod 2**16``,
  is 0): :func:`stochastic_round_bf16` adds them to a float's pattern, the
  reference's ``_stochastic_round_bf16`` of AdamW's first moment.

* ``normal(key, shape)`` maps the same bits to ``u`` in ``(-1, 1)``
  (``max(lo, f * 2 + lo)`` with ``f`` the [0, 1) float above and ``lo``
  the float32 after -1) and returns ``sqrt(2) * erfinv(u)``, ``erfinv``
  being XLA's float32 polynomial (:func:`erfinv`).

Every value is a pure function of the key and the index, so the CPU and
the card give the same numbers (the normals to the last bit of
``log1p``: the CPU's are XLA:CPU's, bitwise ``jax.random.normal`` on the
CPU, the card's its math library's).  The plain version carries uint32
arithmetic in int64 tensors (or Python ints for keys).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """The 20-round threefry2x32 block of ``key`` on counters ``(x0, x1)``
    (Python ints or int64 tensors holding uint32 values)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``0 <= data < 2**32``."""
    if not 0 <= int(data) <= MASK:
        raise ValueError(f"fold_in takes a uint32; got {data}")
    return threefry2x32(key, 0, int(data))


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def key_of_path(path: Sequence[int]) -> Key:
    """``PRNGKey(path[0])`` with ``path[1:]`` folded in, in order."""
    key = prng_key(path[0])
    for d in path[1:]:
        key = fold_in(key, d)
    return key


def uniform(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32)`` in [0, 1)."""
    n = 1
    for s in shape:
        n *= int(s)
    mant = (_bits(key, n, device) >> 9) | 0x3F800000  # < 2**31: fits an int32
    return (mant.to(torch.int32).view(torch.float32) - 1.0).reshape(tuple(shape))


def randint(key: Key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two bit
    streams, from ``split(key)``'s keys, reduced into ``[minval, maxval)``
    as JAX does, ``(hi % span * m + lo % span) % span`` with ``m = 2**32 %
    span`` and every product wrapping at 32 bits."""
    lo_i32, hi_i32 = -(2**31), 2**31 - 1
    minval = min(max(int(minval), lo_i32), hi_i32)
    maxval = min(max(int(maxval), lo_i32), hi_i32)
    n = 1
    for s in shape:
        n *= int(s)
    k1, k2 = split(key)
    higher, lower = _bits(k1, n, device), _bits(k2, n, device)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (2**16 % span) ** 2 % (2**32) % span  # the square wraps at 32 bits
    offset = (((higher % span) * mult) & MASK) + lower % span
    offset = (offset & MASK) % span
    out = (minval + offset + 2**31) % 2**32 - 2**31  # wraps into int32
    return out.to(torch.int32).reshape(tuple(shape))


def _bits(key: Key, n: int, device, offset: int = 0):
    """The 32 random bits of elements offset..offset+n-1 (``b0 ^ b1``), in
    int64."""
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & MASK)
    return b0 ^ b1


# XLA's ErfInv32 (the polynomial of M. Giles, "Approximating the erfinv
# function"): coefficients for w = -log1p(-x*x) below 5 and above
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
NORMAL_LO = -0.99999994  # float32 nextafter(-1, 0)
SQRT2 = 1.4142135381698608  # float32 sqrt(2)


def _fma(a, b, c):
    """``a * b + c`` of float32 tensors as one fused multiply-add: taken in
    float64, where the product of two floats is exact, and rounded once."""
    return (a.double() * b.double() + c.double()).float()


# XLA:CPU's float32 log1p, as it compiles it: Cephes' rational form for
# |x| < sqrt(2) - 1, else Cephes' logf of 1 + x; LLVM contracts each
# multiply feeding an add into a fused multiply-add
LOG1P_SMALL = 0.41421356  # float32 sqrt(2) - 1
LOG1P_DEN = (15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
LOG1P_NUM = (4.5270000e-05, 0.49854103, 6.5787325, 29.911919, 60.949668, 57.112963, 20.039553)
LOGF_SQRTHF = 0.70710677
LOGF_P = ((0.070376836, -0.1151461, 0.116769984), (-0.12420141, 0.14249323, -0.16668057),
          (0.20000714, -0.24999994, 0.3333333))
LOGF_Q1, LOGF_Q2 = -2.1219444e-4, 0.693359375
FLT_MIN = 1.1754944e-38


def xla_log1p(x):
    """``jax.numpy.log1p`` of a float32 tensor as XLA:CPU computes it,
    bitwise for normal floats (XLA flushes subnormal inputs to zero)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    den = torch.ones_like(x)
    for c in LOG1P_DEN:
        den = _fma(den, x, f32(c))
    num = torch.full_like(x, LOG1P_NUM[0])
    for c in LOG1P_NUM[1:]:
        num = _fma(num, x, f32(c))
    x2 = x * x
    small = x + _fma(x2, f32(-0.5), (x * x2) * (num / den))
    v = x + 1.0
    bits = torch.maximum(v, f32(FLT_MIN)).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    lt = m < f32(LOGF_SQRTHF)
    z = (m - 1.0) + torch.where(lt, m, f32(0.0))
    e = e - lt.to(torch.float32)
    z2 = z * z
    z3 = z2 * z
    a, b, c = (_fma(_fma(z, f32(p0), f32(p1)), z, f32(p2)) for p0, p1, p2 in LOGF_P)
    t = _fma(_fma(_fma(a, z3, b), z3, c), z3, e * f32(LOGF_Q1))
    large = _fma(e, f32(LOGF_Q2), _fma(-z2, f32(0.5), z) + t)
    large = torch.where(v <= 0, f32(float("nan")), large)
    large = torch.where(v == 0, f32(float("-inf")), large)
    large = torch.where(v == float("inf"), v, large)
    return torch.where(torch.abs(x) < f32(LOG1P_SMALL), small, large)


def erfinv(x):
    """XLA's float32 ``erf_inv`` on a float32 tensor.  The polynomial's
    steps are fused multiply-adds, as XLA contracts them: ``c + p * w`` is
    taken in float64 (where ``p * w`` of two floats is exact) and rounded
    once to float32.  Its ``log1p`` is XLA:CPU's on the CPU
    (:func:`xla_log1p`), so the CPU's draws are JAX's to the bit, and the
    device's own ``log1p`` elsewhere, as the card's kernel computes it."""
    f32 = dict(dtype=torch.float32, device=x.device)
    cpu = x.device.type == "cpu"
    w = -(xla_log1p if cpu else torch.log1p)(-(x * x))
    lt = w < 5.0
    # the CPU's float32 torch.sqrt is not correctly rounded; float64's is
    sqrt = torch.sqrt(w.double()).float() if cpu else torch.sqrt(w)
    w = torch.where(lt, w - 2.5, sqrt - 3.0)
    wd = w.double()
    coef = lambda i: torch.where(lt, torch.tensor(ERFINV_LT5[i], **f32),
                                 torch.tensor(ERFINV_GE5[i], **f32))
    p = coef(0)
    for i in range(1, len(ERFINV_LT5)):
        p = (coef(i).double() + p.double() * wd).float()
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)``."""
    n = 1
    for s in shape:
        n *= int(s)
    mant = (_bits(key, n, device) >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(NORMAL_LO, dtype=torch.float32, device=device)
    u = torch.maximum(lo, f * 2.0 + lo)
    return (SQRT2 * erfinv(u)).reshape(tuple(shape))


def stochastic_round_bf16(x, key: Key, offset: int = 0) -> torch.Tensor:
    """``x`` (float32) to bfloat16 with stochastic rounding: the low 16
    bits of element ``offset + i``'s draw of ``key`` added to ``x[i]``'s bit
    pattern (a uint32 add that wraps), the low half masked off, the top
    half kept (the exact bf16 of the masked float, NaNs apart).  With
    ``key = split(k)[1]`` and ``offset`` 0 this is the reference's
    ``(bits + randint(k, shape, 0, 2**16)) & 0xFFFF0000``; ``offset`` places
    the tensor inside the stacked leaf whose draws it takes."""
    n = x.numel()
    noise = _bits(key, n, x.device, offset) & 0xFFFF
    pattern = x.detach().to(torch.float32).contiguous().view(torch.int32).reshape(-1)
    top = (((pattern.to(torch.int64) & MASK) + noise) & MASK) >> 16
    top = torch.where(top >= 2**15, top - 2**16, top).to(torch.int16)
    return top.view(torch.bfloat16).reshape(x.shape)


def stochastic_round_bf16_cuda(path, x, offset: int = 0) -> torch.Tensor:
    """:func:`stochastic_round_bf16` on the card: one launch over ``x``
    (float32, contiguous), the key derived from the path's int32 words
    (:func:`path_words`) in ``path``, a tensor on the card, so the words
    (AdamW's step count among them) never pass through the host."""
    if path.device.type != "cuda" or path.dtype != torch.int32 or path.dim() != 1:
        raise ValueError(f"need the path words as an int32 vector on the card; got "
                         f"{path.dtype} {tuple(path.shape)} on {path.device}")
    if not path.is_contiguous() or path.numel() < 1:
        raise ValueError("the path words must be a contiguous, non-empty vector")
    if x.device != path.device or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"need a contiguous float32 tensor on {path.device}; got "
                         f"{x.dtype} on {x.device}")
    if offset < 0 or offset + x.numel() >= 2**63:
        raise ValueError(f"counters {offset} .. {offset + x.numel()} out of range")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    build.launch("sr_bf16", "prng", "sr_bf16", path.data_ptr(), path.numel(), x.data_ptr(),
                 out.data_ptr(), x.numel(), offset, torch.cuda.current_stream(x.device).cuda_stream)
    return out


def sc_draws_ref(path: Sequence[int], n_ports: int, n_bits: int, device="cpu"):
    """The SC generator draws of a key path, as the reference makes them:
    the path's key split into (kx, kw), ``ux = uniform(kx, (1, n_bits))``
    and ``uw = uniform(kw, (n_ports, n_bits))``."""
    kx, kw = split(key_of_path(path))
    return uniform(kx, (1, n_bits), device), uniform(kw, (n_ports, n_bits), device)


def path_words(path: Sequence[int]) -> list:
    """The key path as the kernel reads it: int32 words, the seed taken mod
    2**32 as ``PRNGKey`` does, each folded value a uint32."""
    words = [int(path[0]) & MASK]
    for d in path[1:]:
        if not 0 <= int(d) <= MASK:
            raise ValueError(f"fold_in takes a uint32; got {d}")
        words.append(int(d))
    return [w - (1 << 32) if w >= 1 << 31 else w for w in words]


def sc_draws_cuda(path, n_ports: int, n_bits: int):
    """The SC draws on the card: one launch writes ``ux`` [1, n_bits] and
    ``uw`` [n_ports, n_bits] from ``path``, the key path's int32 words
    (:func:`path_words`) in a tensor on the card; each thread derives the
    key from them, so the words can change in place between launches."""
    if path.device.type != "cuda" or path.dtype != torch.int32 or path.dim() != 1:
        raise ValueError(f"need the path words as an int32 vector on the card; got "
                         f"{path.dtype} {tuple(path.shape)} on {path.device}")
    if not path.is_contiguous() or path.numel() < 1:
        raise ValueError("the path words must be a contiguous, non-empty vector")
    if n_ports < 0 or n_bits < 0 or n_ports * n_bits >= 2**31:
        raise ValueError(f"draws of {n_ports} x {n_bits} do not fit the kernel")
    dev = path.device
    ux = torch.empty((1, n_bits), dtype=torch.float32, device=dev)
    uw = torch.empty((n_ports, n_bits), dtype=torch.float32, device=dev)
    build.launch("sc_draws", "prng", "sc_draws", path.data_ptr(), path.numel(), ux.data_ptr(),
                 uw.data_ptr(), n_ports, n_bits, torch.cuda.current_stream(dev).cuda_stream)
    return ux, uw


def normal_cuda(path, shape) -> torch.Tensor:
    """``normal(key_of_path(...), shape)`` on the card: one launch, reading
    the key path's int32 words (:func:`path_words`) from ``path``, a tensor
    on the card."""
    if path.device.type != "cuda" or path.dtype != torch.int32 or path.dim() != 1:
        raise ValueError(f"need the path words as an int32 vector on the card; got "
                         f"{path.dtype} {tuple(path.shape)} on {path.device}")
    if not path.is_contiguous() or path.numel() < 1:
        raise ValueError("the path words must be a contiguous, non-empty vector")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=path.device)
    build.launch("normal_draws", "prng", "normal_draws", path.data_ptr(), path.numel(),
                 out.data_ptr(), out.numel(), torch.cuda.current_stream(path.device).cuda_stream)
    return out
