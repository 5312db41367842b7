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

* ``normal(key, shape)`` maps the same bits to ``u`` in ``(-1, 1)``
  (``max(lo, f * 2 + lo)`` with ``f`` the [0, 1) float above and ``lo``
  the float32 after -1) and returns ``sqrt(2) * erfinv(u)``, ``erfinv``
  being XLA's float32 polynomial (:func:`erfinv`).

Every value is a pure function of the key and the index, so the CPU and
the card give the same numbers (the normals to the last bit of
``log1p``, which each device's math library rounds).  The plain version carries uint32
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


def _bits(key: Key, n: int, device):
    """The 32 random bits of elements 0..n-1 (``b0 ^ b1``), in int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
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


def erfinv(x):
    """XLA's float32 ``erf_inv`` on a float32 tensor.  The polynomial's
    steps are fused multiply-adds, as XLA contracts them: ``c + p * w`` is
    taken in float64 (where ``p * w`` of two floats is exact) and rounded
    once to float32."""
    f32 = dict(dtype=torch.float32, device=x.device)
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
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
