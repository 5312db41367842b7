"""Approximate-backend registry (port of ``repro.core.registry``).

Every hardware target is one :class:`BackendSpec`: its params class, its
bit-accurate emulator, its optional fused emulator and its kernel
handles.  ``dense()`` dispatches through :func:`get`.  The built-in specs
(exact, approx_mult, log_mult) are registered by
:mod:`repro_torch.core.backends`; ``sc`` and ``analog`` are not ported
yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

from repro_torch.configs.base import Backend

NOT_PORTED = (Backend.SC.value, Backend.ANALOG.value)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """What serving needs to emulate one hardware target.

    * ``emulate``       — bit-accurate forward ``(x, w, params) -> y``.
    * ``fused_emulate`` — ``(x, w, params, epi) -> y`` with the
      chip/calibration epilogue ``epi`` applied in the same kernel, or
      ``None`` for no fused path (``dense()`` then runs ``emulate``).
    * ``kernels``       — named kernel handles (``repro_torch.kernels.ops``).
    """

    name: str
    params_cls: type
    emulate: Callable
    fused_emulate: Optional[Callable] = None
    kernels: Mapping[str, Callable] = dataclasses.field(default_factory=dict)


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
    if name in NOT_PORTED:
        raise NotImplementedError(f"backend {name!r} is not yet ported to repro_torch")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no backend {name!r} registered; available: {names()}") from None


def names() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))
