"""Approximate-backend registry (port of ``repro.core.registry``).

Every hardware target is one :class:`BackendSpec`: its params class, its
bit-accurate emulator, its proxy activation, its fast forward, its
calibration degree, its optional fused emulator and its kernel handles.
``dense()`` dispatches through :func:`get`.  The built-in specs (exact,
sc, approx_mult, analog, log_mult) are registered by
:mod:`repro_torch.core.backends`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.configs.base import Backend


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """What serving and training need to emulate one hardware target.

    * ``emulate``       — bit-accurate forward ``(x, w, params, rng) -> y``;
      ``rng`` is the site's generator-sequence source (see
      :meth:`repro_torch.core.approx_linear.ApproxCtx.site_rng`), which
      only the stochastic backends read.
    * ``proxy_forward`` — smooth surrogate ``(x, w, params) -> y`` whose
      VJP is the MODEL-mode backward (paper Sec. 3.1).  ``None`` leaves the
      backend serve-only: training on it raises.
    * ``fast_forward``  — the cheap INJECT-mode forward whose residual the
      calibrated injection corrects; ``None`` means the proxy (Type-1
      backends); analog (Type 2) takes a plain matmul.
    * ``calib_degree``  — the error fit's polynomial degree, or ``None``
      for ``ApproxConfig.poly_degree`` (analog and exact pin 0).
    * ``fused_emulate`` — ``(x, w, params, rng, epi) -> y`` with the
      chip/calibration epilogue ``epi`` applied in the same kernel, or
      ``None`` for no fused path (``dense()`` then runs ``emulate``).
    * ``kernels``       — named kernel handles (``repro_torch.kernels.ops``).
    * ``energy``        — deployment-energy model ``(params) -> float``: the
      relative energy of one MAC on this hardware, one exact digital MAC
      being 1.0 (the paper's Tab. 1 op costs scaled by the backend's knobs);
      ``None`` prices it as exact.  Read by :mod:`repro_torch.search.
      costmodel`.
    """

    name: str
    params_cls: type
    emulate: Callable
    proxy_forward: Optional[Callable] = None
    fast_forward: Optional[Callable] = None
    calib_degree: Optional[int] = None
    fused_emulate: Optional[Callable] = None
    kernels: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    energy: Optional[Callable] = None

    def proxy(self, x, w, params):
        """The proxy forward; raises for a serve-only spec."""
        if self.proxy_forward is None:
            raise NotImplementedError(
                f"backend {self.name!r} has no proxy_forward: it can serve (MODEL forward) "
                "but not train"
            )
        return self.proxy_forward(x, w, params)

    def fast(self, x, w, params):
        """The INJECT-mode forward: ``fast_forward``, else the proxy."""
        if self.fast_forward is not None:
            return self.fast_forward(x, w, params)
        return self.proxy(x, w, params)

    def mac_energy(self, params) -> float:
        """Relative energy per MAC on this hardware (exact MAC = 1.0)."""
        if self.energy is None:
            return 1.0
        e = float(self.energy(params))
        if not e > 0.0:
            raise ValueError(
                f"backend {self.name!r}: energy model returned {e}; per-MAC "
                "energy must be > 0 (zero-cost hardware breaks Pareto search)"
            )
        return e


_REGISTRY: Dict[str, BackendSpec] = {}


def _ensure_builtins():
    if Backend.EXACT.value not in _REGISTRY:
        import repro_torch.core.backends  # noqa: F401  (registers the built-ins)


def register(spec: BackendSpec, *, override: bool = False) -> BackendSpec:
    if spec.name in _REGISTRY and not override:
        raise ValueError(
            f"backend {spec.name!r} already registered; pass override=True to replace"
        )
    _REGISTRY[spec.name] = spec
    return spec


def get(backend: Union[Backend, str]) -> BackendSpec:
    """The spec for a backend (enum member or registry name)."""
    _ensure_builtins()
    name = backend.value if isinstance(backend, Backend) else str(backend)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no backend {name!r} registered; available: {names()}") from None


def names() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def approx_names() -> Tuple[str, ...]:
    """Every registered approximate backend name (exact excluded)."""
    return tuple(n for n in names() if n != Backend.EXACT.value)


# Shared split-unipolar plumbing.  Signed operands on unipolar hardware
# split into positive and negative planes: z_pos = xp@wp + xn@wn and
# z_neg = xp@wn + xn@wp, one physical accumulation per polarity over the
# concatenated 2K unipolar ports.


def split_unipolar_contract(x_halves, w_halves, matmul: Callable):
    """Contract split-unipolar operand planes through a unipolar matmul.

    ``x_halves = (xp, xn)`` with shape [..., K] (both >= 0), ``w_halves =
    (wp, wn)`` with shape [K, N].  ``matmul(a, (top, bottom))`` is the
    backend's unipolar 2-D contraction of ``a`` [rows, 2K] with the
    [2K, N] plane whose rows 0..K-1 are ``top`` and rows K..2K-1 are
    ``bottom``: the reference's ``concatenate([wp, wn])`` and
    ``concatenate([wn, wp])``, passed as halves so the kernels read the
    planes in place.  Called once per output polarity, positive first;
    returns ``pos - neg`` reshaped to [..., N] (value-domain rescale is
    the caller's job).
    """
    xp, xn = x_halves
    wp, wn = w_halves
    xcat = concat_planes(xp, xn)
    r = matmul(xcat, (wp, wn)) - matmul(xcat, (wn, wp))
    return r.reshape(xp.shape[:-1] + (wp.shape[-1],))


def concat_planes(xp, xn):
    """The [rows, 2K] activation plane of the 2K unipolar ports."""
    K = xp.shape[-1]
    return torch.cat([xp, xn], dim=-1).reshape(-1, 2 * K)
