"""The training-time forward paths of an approximate projection (port of
``repro.core.injection``: ``model_mode_matmul``, ``fused_model_mode_matmul``,
``fast_forward``, ``inject_mode_matmul``, ``proxy_only_matmul`` and
``calibrate_matmul`` with a chip and the exact-reference fit; the gated
approximate-backward variants come later).

* MODEL mode  — bit-accurate emulated forward, proxy-activation backward
  (paper Sec. 3.1): a ``torch.autograd.Function`` whose backward is the
  VJP of the backend's smooth proxy at the saved operands.
* INJECT mode — the fast forward plus calibrated error (Sec. 3.2).
* CALIBRATE   — the emulated value, used as the layer's output, and the
  error statistics fitted against the fast forward.

``rng`` is the site's source of generator draws (:meth:`repro_torch.core.
approx_linear.ApproxCtx.site_rng`, read by SC only); ``path`` is the
site's key path (:meth:`~repro_torch.core.approx_linear.ApproxCtx.
site_path`), from which INJECT mode draws its noise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ApproxConfig, Backend
from repro_torch.core import calibration, registry
from repro_torch.hw.variation import apply_chip


class _ModelModeMatmul(torch.autograd.Function):
    """Forward: ``spec.emulate`` (kernels K1, K4 or K6 on the card) on
    contiguous operands, without a graph.  Backward: the VJP of
    ``spec.proxy_forward`` (or of ``x @ w`` when ``proxy_in_backward`` is
    off, the paper's Tab. 2 ablation) at the saved ``(x, w)``.  The spec,
    params and draw source get no gradient."""

    @staticmethod
    def forward(ctx, x, w, spec, params, rng, proxy_in_backward):
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.params, ctx.proxy_in_backward = spec, params, proxy_in_backward
        return spec.emulate(x.contiguous(), w.contiguous(), params, rng)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            wd = w.detach().requires_grad_(need_w)
            if ctx.proxy_in_backward:
                y = ctx.spec.proxy(xd, wd, ctx.params)
            else:
                y = xd @ wd
            inputs = [t for t, need in ((xd, need_x), (wd, need_w)) if need]
            grads = iter(torch.autograd.grad(y, inputs, g))
        gx = next(grads) if need_x else None
        gw = next(grads) if need_w else None
        return gx, gw, None, None, None, None


def needs_grad(x, w) -> bool:
    """Whether autograd would differentiate a projection of ``x`` and ``w``."""
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def model_mode_matmul(x, w, cfg: ApproxConfig, rng, backend: Optional[Backend] = None):
    """Accurate-forward / proxy-backward projection (MODEL mode).  With no
    operand needing a gradient it is a plain call into the emulator."""
    backend = backend if backend is not None else cfg.backend
    spec = registry.get(backend)
    params = cfg.params_for(backend)
    if not needs_grad(x, w):
        return spec.emulate(x, w, params, rng)
    if cfg.proxy_in_backward and spec.proxy_forward is None:
        raise NotImplementedError(f"backend {spec.name!r} has no proxy_forward: it cannot train")
    return _ModelModeMatmul.apply(x, w, spec, params, rng, cfg.proxy_in_backward)


def fused_model_mode_matmul(
    x, w, cfg: ApproxConfig, rng, epi: dict, backend: Optional[Backend] = None
):
    """Emulated matmul with the chip/calibration epilogue ``epi`` (see
    :func:`repro_torch.kernels.epilogue.apply_epilogue`) in one kernel
    call, forward only: the serving decode path.  ``None`` entries of
    ``epi`` are dropped."""
    if needs_grad(x, w):
        raise NotImplementedError("the fused MODEL-mode projection is forward only")
    backend = backend if backend is not None else cfg.backend
    epi = {k: v for k, v in epi.items() if v is not None}
    spec = registry.get(backend)
    return spec.fused_emulate(x, w, cfg.params_for(backend), rng, epi)


def fast_forward(x, w, cfg: ApproxConfig, backend: Optional[Backend] = None):
    """The cheap forward whose residual the injection corrects: the proxy
    for Type-1 backends, a plain matmul for analog (the spec's ``fast``)."""
    backend = backend if backend is not None else cfg.backend
    return registry.get(backend).fast(x, w, cfg.params_for(backend))


def inject_mode_matmul(
    x, w, cfg: ApproxConfig, site, path: Sequence[int], backend: Optional[Backend] = None
):
    """Fast forward plus injected calibrated error (INJECT mode).  ``site``
    is the projection's calibration stats (``None``: no injection); the
    error is added detached, so it perturbs values and steers no
    gradient."""
    y = fast_forward(x, w, cfg, backend)
    if site is None:
        return y
    err = calibration.sample_error(site, y.detach(), path, cfg.inject_std_scale)
    return y + err


def proxy_only_matmul(x, w, cfg: ApproxConfig, backend: Optional[Backend] = None):
    """Proxy activation forward and backward, no injection (ablation)."""
    backend = backend if backend is not None else cfg.backend
    return registry.get(backend).proxy(x, w, cfg.params_for(backend))


def calibrate_matmul(
    x, w, cfg: ApproxConfig, rng, backend: Optional[Backend] = None, *, site: str = "",
    chip=None, exact_ref: bool = False,
):
    """One calibration pass for this projection (paper Sec. 3.2): the
    bit-accurate emulation (also the layer's output, as on the paper's
    accurate calibration batches) and the error statistics of its residual
    against the fast forward, at the degree of the site's backend.

    ``chip`` (a :class:`repro_torch.hw.variation.ChipProfile`) perturbs the
    emulated output as that device would, so the stats describe the chip.
    ``exact_ref`` fits the residual against the exact ``x @ w`` instead,
    conditioned on the emulated output, at degree ``max(degree, 1)``: the
    serving-side correction, ``y - predict_mean(stats, y)``."""
    backend = backend if backend is not None else cfg.backend
    spec = registry.get(backend)
    params = cfg.params_for(backend)
    name = backend.value if isinstance(backend, Backend) else str(backend)
    with torch.no_grad():
        y_acc = spec.emulate(x.contiguous(), w.contiguous(), params, rng)
        y_acc = apply_chip(y_acc, site, name, chip)
        degree = calibration.effective_degree(cfg, backend)
        if exact_ref:
            resid = y_acc.to(torch.float32) - (x @ w).to(torch.float32)
            fitted = calibration.fit_error_stats(y_acc, resid, max(degree, 1))
        else:
            y_fast = spec.fast(x, w, params)
            resid = (y_acc - y_fast).to(torch.float32)
            fitted = calibration.fit_error_stats(y_fast, resid, degree)
    return y_acc, fitted
