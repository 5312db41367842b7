"""``dense`` — the projection primitive every matmul of the model routes
through (port of ``repro.core.approx_linear``: ``ApproxCtx``,
``_approx_branch`` and ``dense`` with static dispatch).

* no ctx / inactive config -> plain ``x @ w`` (exact baseline)
* ``TrainMode.MODEL``      -> bit-accurate emulated forward, proxy backward;
  through the backend's fused kernel (forward only) when ``ctx.fused`` and
  the spec has one
* ``TrainMode.INJECT``     -> fast forward plus calibrated error
* ``TrainMode.PROXY_ONLY`` -> the proxy activation only (ablation)
* ``ctx.collect``          -> calibration pass (emulated forward, fitted
  stats in ``ctx.collected``)

The backend is resolved per call site (``cfg.backend_for(site)``), so one
model can mix targets.  The reference's chip, correction, runtime-switch,
backward-gate and blend hooks are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
from repro_torch.core import injection, registry
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sc_matmul import SCDraws


@dataclasses.dataclass
class ApproxCtx:
    """Per-forward context: the config, ``fused`` to route MODEL-mode
    projections through the backend's fused kernel (the serving decode
    path), the random source of the stochastic backends and of INJECT
    mode, and the layer's calibration sites.

    ``calib`` maps a site name to its stats (:mod:`repro_torch.core.
    calibration`), read by INJECT mode; with ``collect`` set the forward
    is a calibration pass, and each site's fitted stats land in
    ``collected``.

    ``rng`` is a key path, the port's stand-in for a ``jax.random`` key:
    a root seed followed by the values the reference ``fold_in``s into it
    (the engine's tick, the layer index in prefill, ``crc32(site)``).
    ``draws(path, n_ports, n_bits, device) -> (ux, uw)`` turns a site's
    path into its generator sequences: by default the port's own
    (:func:`repro_torch.kernels.ops.sc_draws`); a test may pass the JAX
    reference's draws for the same path, so both packages see identical
    streams.

    The ctx keeps the draws it has made, by path, as
    :class:`repro_torch.kernels.sc_matmul.SCDraws` (which carry their
    threshold tables on the card): a decode step runs every layer under
    one ctx and one path per site, so each site draws and builds its
    tables once per step, not once per layer.  They live as long as the
    ctx: one decode step.  A full-sequence forward gives each layer a ctx
    of its own (:meth:`for_layer`, with an empty memo), so it keeps no
    more than one layer's draws alive.
    """

    cfg: ApproxConfig
    fused: bool = False
    rng: Tuple[int, ...] = (0,)
    draws: Optional[Callable] = None
    calib: Optional[Dict[str, Any]] = None
    collect: bool = False
    collected: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _memo: Dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def site_path(self, site: str) -> Tuple[int, ...]:
        """This site's key path: the ctx's path with ``crc32(site) &
        0x7FFFFFFF`` folded in, the reference's ``ApproxCtx.site_rng``."""
        return tuple(self.rng) + (zlib.crc32(site.encode()) & 0x7FFFFFFF,)

    def site_rng(self, site: str) -> Callable:
        """This site's draw source, ``(n_ports, n_bits, device) -> (ux, uw)``,
        the SC draws of :meth:`site_path`."""
        return functools.partial(self._site_draws, self.site_path(site))

    def _site_draws(self, path, n_ports: int, n_bits: int, device) -> SCDraws:
        key = (path, n_ports, n_bits, str(device))
        if key not in self._memo:
            self._memo[key] = SCDraws(*(self.draws or kops.sc_draws)(path, n_ports, n_bits, device))
        return self._memo[key]

    def for_layer(self, idx: int, calib: Optional[Dict[str, Any]] = None) -> "ApproxCtx":
        """The ctx of layer ``idx`` of a full-sequence forward: the layer
        index folded into the path (the reference's per-layer key), the
        layer's calibration sites and an empty ``collected``."""
        return dataclasses.replace(self, rng=tuple(self.rng) + (int(idx),), calib=calib,
                                   collected={})


def skipped_site(site: str, cfg: ApproxConfig) -> bool:
    """True when ``dense()`` keeps this site exact whatever the backend map."""
    return cfg.skip_lm_head and site.endswith("lm_head")


def _approx_branch(x, w, site: str, backend, ctx: ApproxCtx):
    """The non-exact projection body for one backend under the ctx's mode."""
    cfg = ctx.cfg
    if cfg.mode == TrainMode.MODEL:
        spec = registry.get(backend)
        rng = ctx.site_rng(site)
        if ctx.fused and spec.fused_emulate is not None and not injection.needs_grad(x, w):
            # no chip and no correction: the epilogue is empty, as in the
            # reference when a lane has no fleet (and then the composed
            # path below, which trains, gives the same bits)
            return injection.fused_model_mode_matmul(x, w, cfg, rng, {}, backend)
        return injection.model_mode_matmul(x, w, cfg, rng, backend)
    if cfg.mode == TrainMode.INJECT:
        stats = (ctx.calib or {}).get(site)
        return injection.inject_mode_matmul(x, w, cfg, stats, ctx.site_path(site), backend)
    if cfg.mode == TrainMode.PROXY_ONLY:
        return injection.proxy_only_matmul(x, w, cfg, backend)
    return x @ w  # NO_MODEL with an active backend


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
            if ctx.collect:
                # a calibration pass carries the stats of every site the
                # tree holds, exact and skipped ones too, so the tree keeps
                # its structure
                prev = (ctx.calib or {}).get(site)
                if prev is not None:
                    ctx.collected[site] = prev
        elif ctx.collect:
            y, ctx.collected[site] = injection.calibrate_matmul(
                x, w, ctx.cfg, ctx.site_rng(site), backend, site=site
            )
        else:
            y = _approx_branch(x, w, site, backend, ctx)
    y = y.to(compute_dtype)
    if b is not None:
        y = y + b.to(compute_dtype)
    return y
