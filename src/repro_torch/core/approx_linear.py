"""``dense`` — the projection primitive every matmul of the model routes
through (port of ``repro.core.approx_linear``: ``ApproxCtx``,
``_approx_branch`` and ``dense`` with static dispatch).

* no ctx / inactive config -> plain ``x @ w`` (exact baseline)
* ``TrainMode.MODEL``      -> bit-accurate emulated forward, through the
  backend's fused kernel when ``ctx.fused`` and the spec has one

The backend is resolved per call site (``cfg.backend_for(site)``), so one
model can mix targets.  The reference's chip, correction, runtime-switch,
backward-gate, blend and calibration hooks are not ported yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
from repro_torch.core import injection, registry


@dataclasses.dataclass
class ApproxCtx:
    """Per-forward context: the serving config, and ``fused`` to route
    MODEL-mode projections through the backend's fused kernel (the
    serving decode path)."""

    cfg: ApproxConfig
    fused: bool = False


def skipped_site(site: str, cfg: ApproxConfig) -> bool:
    """True when ``dense()`` keeps this site exact whatever the backend map."""
    return cfg.skip_lm_head and site.endswith("lm_head")


def _approx_branch(x, w, site: str, backend, ctx: ApproxCtx):
    """The non-exact projection body for one backend under the ctx's mode."""
    cfg = ctx.cfg
    if cfg.mode != TrainMode.MODEL:
        raise NotImplementedError(
            f"mode {cfg.mode.value!r} is not yet ported to repro_torch (serving uses MODEL)"
        )
    spec = registry.get(backend)
    if ctx.fused and spec.fused_emulate is not None:
        # no chip and no correction: the epilogue is empty, as in the
        # reference when a lane has no fleet
        return injection.fused_model_mode_matmul(x, w, cfg, {}, backend)
    return injection.model_mode_matmul(x, w, cfg, backend)


def dense(x, w, b=None, *, site: str = "", ctx: ApproxCtx = None):
    """Projection ``x @ w (+ b)`` through the configured approximate path.

    x: [..., K]; w: [K, N]; b: [N] or None.
    """
    compute_dtype = x.dtype
    if ctx is None or not ctx.cfg.active:
        y = x @ w
    else:
        backend = ctx.cfg.backend_for(site)
        if backend == Backend.EXACT or skipped_site(site, ctx.cfg):
            y = x @ w
        else:
            y = _approx_branch(x, w, site, backend, ctx)
    y = y.to(compute_dtype)
    if b is not None:
        y = y + b.to(compute_dtype)
    return y
