"""``dense`` — the projection primitive every matmul of the model routes
through (port of ``repro.core.approx_linear``: ``ApproxCtx``,
``_approx_branch``, ``_switch_dense`` and ``dense`` with static and
runtime-switch dispatch).

* no ctx / inactive config -> plain ``x @ w`` (exact baseline)
* ``TrainMode.MODEL``      -> bit-accurate emulated forward, proxy backward;
  through the backend's fused kernel when ``ctx.fused`` and the spec has
  one
* ``TrainMode.INJECT``     -> fast forward plus calibrated error
* ``TrainMode.PROXY_ONLY`` -> the proxy activation only (ablation)
* ``ctx.collect``          -> calibration pass (emulated forward, fitted
  stats in ``ctx.collected``)

The backend is resolved per call site (``cfg.backend_for(site)``), so one
model can mix targets.  ``ctx.chip`` perturbs every emulated forward (MODEL
mode, calibration passes) as that device instance would, and
``ctx.correct`` subtracts the site's fitted mean error from MODEL-mode
outputs (online recalibration's correction).

``ctx.site_idx`` (:mod:`repro_torch.core.switch`) picks each site's
backend from the switch table at run time instead (one step or serving
lane for every map), and ``ctx.blend`` interpolates every approximate
projection toward exact (the search's sensitivity probe).  ``ctx.bwd_gate``
routes each site's two gradient matmuls through the int8 grid (the
approximate backward, :mod:`repro_torch.core.injection`); forward values
never change with it.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
from repro_torch.core import calibration, injection, registry
from repro_torch.core import switch as switch_lib
from repro_torch.hw import variation
from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import apply_epilogue
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

    ``chip`` is a device instance (:mod:`repro_torch.hw.variation`): every
    emulated forward is perturbed as that chip would compute it.
    ``correct`` subtracts the fitted mean error of ``calib``'s site from
    MODEL-mode outputs, and ``calib_exact_ref`` makes a calibration pass
    fit those stats against the exact matmul (see
    :func:`repro_torch.core.injection.calibrate_matmul`).  The memo also
    keeps the chip's epilogue terms per site, which every layer of a
    decode step shares.

    ``bwd_gate`` is the approximate backward's mask: an int32
    ``[n_sites]`` host array over ``switch.SITE_ORDER``, 1 where a site's
    gradient matmuls (dL/dx, dL/dW) run on the int8 grid, 0 where they
    stay exact (:meth:`site_gate`).  A host array, as ``site_idx`` is: the
    branch is taken on the host, and flipping the mask builds nothing.
    ``None`` leaves every backward as it was.
    """

    cfg: ApproxConfig
    fused: bool = False
    rng: Tuple[int, ...] = (0,)
    draws: Optional[Callable] = None
    calib: Optional[Dict[str, Any]] = None
    collect: bool = False
    collected: Dict[str, Any] = dataclasses.field(default_factory=dict)
    chip: Optional[Dict[str, Any]] = None
    correct: bool = False
    calib_exact_ref: bool = False
    blend: Optional[torch.Tensor] = None
    site_idx: Optional[np.ndarray] = None
    bwd_gate: Optional[np.ndarray] = None
    _memo: Dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def site_path(self, site: str) -> Tuple[int, ...]:
        """This site's key path: the ctx's path with ``crc32(site) &
        0x7FFFFFFF`` folded in, the reference's ``ApproxCtx.site_rng``."""
        return tuple(self.rng) + (zlib.crc32(site.encode()) & 0x7FFFFFFF,)

    def site_gate(self, site: str) -> Optional[int]:
        """This site's backward gate (an int), or None when gating is off:
        without a mask, in a calibration pass (no gradients wanted) and
        under the ``blend`` probe (its gradient must flow through the proxy
        VJP the profile is defined on)."""
        if self.bwd_gate is None or self.collect or self.blend is not None:
            return None
        pos = switch_lib.site_pos(site)
        return None if pos is None else int(self.bwd_gate[pos])

    def site_rng(self, site: str) -> Callable:
        """This site's draw source, ``(n_ports, n_bits, device) -> (ux, uw)``,
        the SC draws of :meth:`site_path`."""
        return functools.partial(self._site_draws, self.site_path(site))

    def _site_draws(self, path, n_ports: int, n_bits: int, device) -> SCDraws:
        key = (path, n_ports, n_bits, str(device))
        if key not in self._memo:
            self._memo[key] = SCDraws(*(self.draws or kops.sc_draws)(path, n_ports, n_bits, device))
        return self._memo[key]

    def chip_terms(self, site: str, backend_name: str, n: int, dtype, device):
        """The chip's ``(colgain, coladd)`` at ``site``
        (:func:`repro_torch.hw.variation.chip_epilogue`), made once per ctx."""
        if self.chip is None:
            return None, None
        key = ("chip", site, backend_name, n, dtype, str(device))
        if key not in self._memo:
            self._memo[key] = variation.chip_epilogue(site, backend_name, self.chip, n, dtype,
                                                      device)
        return self._memo[key]

    def row_selector(self, device) -> torch.Tensor:
        """The per-row ``site_idx`` on ``device``, copied once per ctx (a
        decode step): from pinned host memory on the card, so the copy is
        queued on the stream and the host does not wait."""
        key = ("site_idx", str(device))
        if key not in self._memo:
            idx = torch.from_numpy(np.ascontiguousarray(self.site_idx, dtype=np.int32))
            if torch.device(device).type == "cuda":
                idx = idx.pin_memory().to(device, non_blocking=True)
            self._memo[key] = idx
        return self._memo[key]

    def with_calib(self, calib: Optional[Dict[str, Any]]) -> "ApproxCtx":
        """This ctx with a layer's calibration sites, sharing its path and
        its memo (a decode step's layers draw once per site, not per layer)."""
        ctx = dataclasses.replace(self, calib=calib)
        ctx._memo = self._memo
        return ctx

    def for_layer(self, idx: int, calib: Optional[Dict[str, Any]] = None) -> "ApproxCtx":
        """The ctx of layer ``idx`` of a full-sequence forward: the layer
        index folded into the path (the reference's per-layer key), the
        layer's calibration sites and an empty ``collected``."""
        return dataclasses.replace(self, rng=tuple(self.rng) + (int(idx),), calib=calib,
                                   collected={})


def skipped_site(site: str, cfg: ApproxConfig) -> bool:
    """True when ``dense()`` keeps this site exact whatever the backend map
    (the config's skip flags); the switch's index resolution and the
    search's cost model go by the same rule."""
    if cfg.skip_router and site.endswith("router"):
        return True
    return cfg.skip_lm_head and site.endswith("lm_head")


def _backend_name(backend) -> str:
    return backend.value if isinstance(backend, Backend) else str(backend)


def _exact(x, w, gate):
    """The exact projection, its backward under ``gate``."""
    return x @ w if not gate else injection.gated_exact_matmul(x, w, gate)


def _approx_branch(x, w, site: str, backend, ctx: ApproxCtx, gate=None):
    """The non-exact projection body for one backend under the ctx's mode,
    shared by the static path and every switch branch; with ``ctx.blend``
    interpolated toward exact.  ``gate`` routes the backward through the
    int8 grid; the forward is the same."""
    y = _mode_branch(x, w, site, backend, ctx, gate)
    if ctx.blend is not None:
        # the sensitivity probe (ApproxCtx.blend): d loss / d blend at 0 is
        # the first-order loss change of this site's approximation
        exact = x @ w
        y = exact + ctx.blend.to(exact.dtype) * (y - exact)
    return y


def _mode_branch(x, w, site: str, backend, ctx: ApproxCtx, gate=None):
    cfg = ctx.cfg
    if cfg.mode == TrainMode.MODEL:
        spec = registry.get(backend)
        rng = ctx.site_rng(site)
        name = _backend_name(backend)
        stats = (ctx.calib or {}).get(site) if ctx.correct else None
        if ctx.fused and ctx.blend is None and spec.fused_emulate is not None:
            # the chip and the correction in the kernel's epilogue: the same
            # bits as the composed path below
            colgain, coladd = ctx.chip_terms(site, name, w.shape[-1], x.dtype, x.device)
            epi = {"colgain": colgain, "coladd": coladd,
                   "mean_coeffs": None if stats is None else stats["mean"],
                   "mean_scale": None if stats is None else stats["scale"]}
            return injection.fused_model_mode_matmul(x, w, cfg, rng, epi, backend, gate)
        y = injection.model_mode_matmul(x, w, cfg, rng, backend, gate)
        # what this chip computes (variation.apply_chip, its terms memoised)
        colgain, coladd = ctx.chip_terms(site, name, y.shape[-1], y.dtype, y.device)
        if coladd is not None:
            y = apply_epilogue(y, colgain=colgain, coladd=coladd)
        if stats is not None:
            # online recalibration's de-bias (stats fitted against exact)
            y = y - calibration.predict_mean(stats, y).to(y.dtype)
        return y
    if cfg.mode == TrainMode.INJECT:
        stats = (ctx.calib or {}).get(site)
        return injection.inject_mode_matmul(x, w, cfg, stats, ctx.site_path(site), backend,
                                            gate)
    if cfg.mode == TrainMode.PROXY_ONLY:
        return injection.proxy_only_matmul(x, w, cfg, backend, gate)
    return _exact(x, w, gate)  # NO_MODEL with an active backend


def _switch_dense(x, w, *, site: str, ctx: ApproxCtx):
    """Runtime-dispatched projection: ``ctx.site_idx[..., pos(site)]``
    indexes the switch table (:func:`repro_torch.core.switch.table`, or the
    sub-table of ``cfg.switch_backends``).

    A per-site index (``[n_sites]``) is read on the host and runs its one
    branch.  A per-row index (``[rows, n_sites]``, rows being ``x``'s
    leading dim) runs each selected branch over the whole batch, then
    picks each row's result with ``torch.where``: the SC and analog
    emulators take per-tensor scales over every row, as the reference's
    compute-all does.  A branch that no row selects is skipped: its output
    would be discarded, and a branch is a pure function of the operands and
    the site's key path (the SC draws are keyed by path), so the result is
    bitwise that of computing every branch.  Every branch body is the
    static path's :func:`_approx_branch`, so switch dispatch is bitwise
    static dispatch per backend.  Outputs are in ``x``'s dtype."""
    names = (switch_lib.subtable(ctx.cfg.switch_backends) if ctx.cfg.switch_backends
             else switch_lib.table())
    pos = switch_lib.site_pos(site)
    idx = np.asarray(ctx.site_idx)[..., pos]
    gate = ctx.site_gate(site)

    def branch(i: int):
        if i == 0:
            return _exact(x, w, gate).to(x.dtype)
        return _approx_branch(x, w, site, names[i], ctx, gate).to(x.dtype)

    top = len(names) - 1
    if idx.ndim == 0:
        return branch(min(max(int(idx), 0), top))
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"site_idx has {idx.shape[0]} rows for a batch of {x.shape[0]}")
    chosen = sorted({min(max(int(i), 0), top) for i in idx})
    out = branch(chosen[0])
    if len(chosen) > 1:
        col = ctx.row_selector(x.device)[:, pos].clamp(0, top)
        col = col.reshape((-1,) + (1,) * (x.dim() - 1))
        for i in chosen[1:]:
            out = torch.where(col == i, branch(i), out)
    return out


def dense(x, w, b=None, *, site: str = "", ctx: ApproxCtx = None):
    """Projection ``x @ w (+ b)`` through the configured approximate path.

    x: [..., K]; w: [K, N]; b: [N] or None.
    """
    compute_dtype = x.dtype
    if (ctx is not None and ctx.site_idx is not None and not ctx.collect
            and ctx.cfg.mode != TrainMode.NO_MODEL and switch_lib.site_pos(site) is not None):
        # the backend is a runtime index (skip flags were folded to exact
        # when the index was resolved, switch.site_indices)
        y = _switch_dense(x, w, site=site, ctx=ctx)
    elif ctx is None or not ctx.cfg.active:
        y = x @ w if ctx is None else _exact(x, w, ctx.site_gate(site))
    else:
        backend = ctx.cfg.backend_for(site)
        if backend == Backend.EXACT or skipped_site(site, ctx.cfg):
            # an exact forward still takes the int8 backward when gated open
            # (warm-up phases run every forward exact)
            y = _exact(x, w, ctx.site_gate(site))
            if ctx.collect:
                # a calibration pass carries the stats of every site the
                # tree holds, exact and skipped ones too, so the tree keeps
                # its structure
                prev = (ctx.calib or {}).get(site)
                if prev is not None:
                    ctx.collected[site] = prev
        elif ctx.collect:
            y, ctx.collected[site] = injection.calibrate_matmul(
                x, w, ctx.cfg, ctx.site_rng(site), backend, site=site, chip=ctx.chip,
                exact_ref=ctx.calib_exact_ref,
            )
        else:
            y = _approx_branch(x, w, site, backend, ctx, ctx.site_gate(site))
    y = y.to(compute_dtype)
    if b is not None:
        y = y + b.to(compute_dtype)
    return y
