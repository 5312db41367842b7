"""MODEL-mode projections, forward only (port of ``model_mode_matmul`` and
``fused_model_mode_matmul`` from ``repro.core.injection``).

Serving needs no gradient, so these are plain calls into the backend's
emulator; the proxy-backward ``torch.autograd.Function`` and INJECT mode
come with the training slice.  ``rng`` is the site's source of generator
draws (:meth:`repro_torch.core.approx_linear.ApproxCtx.site_rng`).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ApproxConfig, Backend
from repro_torch.core import registry


def model_mode_matmul(x, w, cfg: ApproxConfig, rng, backend: Optional[Backend] = None):
    """Bit-accurate emulated forward of ``x @ w`` on the configured hardware."""
    backend = backend if backend is not None else cfg.backend
    return registry.get(backend).emulate(x, w, cfg.params_for(backend), rng)


def fused_model_mode_matmul(
    x, w, cfg: ApproxConfig, rng, epi: dict, backend: Optional[Backend] = None
):
    """Emulated matmul with the chip/calibration epilogue ``epi`` (see
    :func:`repro_torch.kernels.epilogue.apply_epilogue`) in one kernel
    call.  ``None`` entries of ``epi`` are dropped."""
    backend = backend if backend is not None else cfg.backend
    epi = {k: v for k, v in epi.items() if v is not None}
    spec = registry.get(backend)
    return spec.fused_emulate(x, w, cfg.params_for(backend), rng, epi)
