"""The training-time forward paths of an approximate projection (port of
``repro.core.injection``: ``model_mode_matmul``, ``fused_model_mode_matmul``,
``fast_forward``, ``inject_mode_matmul``, ``proxy_only_matmul``,
``calibrate_matmul`` with a chip and the exact-reference fit,
``_gated_vjp`` and ``gated_exact_matmul``).

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

**Approximate backward.**  Every path takes a ``gate``: ``None`` (the
default) or an int, the site's slot of ``ApproxCtx.bwd_gate``.  A closed
gate (None or 0) keeps the path's plain graph, the exact VJP of its
surrogate.  An open one (> 0) makes the backward :func:`_gated_vjp`: the
same VJP at :func:`repro_torch.core.proxy.int8_dequant`-ed operands and
cotangent (the gradient matmuls on the int8 datapath).  The forward is
the same either way.  The reference picks the branch with a ``lax.cond`` on a
device scalar; here the gate is a host int and the branch a Python
``if``, so a gated projection makes the host wait for nothing.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs.base import ApproxConfig, Backend
from repro_torch.core import calibration, registry
from repro_torch.core.proxy import int8_dequant
from repro_torch.hw.variation import apply_chip
from repro_torch.kernels.epilogue import apply_epilogue


def _gated_vjp(surrogate: Callable, x, w, g, gate, need=(True, True)):
    """``(dL/dx, dL/dw)`` of one projection: the VJP of ``surrogate`` (the
    plain matmul, the proxy forward, or the proxy and the epilogue) at
    ``(x, w)`` for the cotangent ``g``; with ``gate > 0`` at the int8 grid
    of each (``x`` and ``g`` per row, ``w`` per tensor).  ``need`` says
    which of the two to compute; the other is None."""
    if gate is not None and int(gate) > 0:
        x, w, g = int8_dequant(x), int8_dequant(w, axis=None), int8_dequant(g)
    need_x, need_w = need
    with torch.enable_grad():
        xd = x.detach().requires_grad_(need_x)
        wd = w.detach().requires_grad_(need_w)
        y = surrogate(xd, wd)
        inputs = [t for t, n in ((xd, need_x), (wd, need_w)) if n]
        grads = iter(torch.autograd.grad(y, inputs, g))
    return (next(grads) if need_x else None), (next(grads) if need_w else None)


def _surrogate(spec, params, proxy_in_backward: bool, epi=None) -> Callable:
    """The function whose VJP is MODEL mode's backward: the backend's proxy
    (or ``x @ w`` when ``proxy_in_backward`` is off, the paper's Tab. 2
    ablation), followed by the epilogue ``epi`` when given (the fused
    projection's: gradients see the chip gain and the correction slope)."""

    def fn(a, b):
        y = spec.proxy(a, b, params) if proxy_in_backward else a @ b
        return y if epi is None else apply_epilogue(y, **epi)

    return fn


class _ModelModeMatmul(torch.autograd.Function):
    """Forward: ``forward_fn(x, w)`` without a graph: the emulator (K1, K4
    or K6 on the card), the fused emulator with an epilogue (K2, K5 or K7),
    or for a gated exact, fast or proxy projection ``surrogate`` itself.
    Backward: :func:`_gated_vjp` of ``surrogate`` at the saved ``(x, w)``
    under ``gate``.  The callables and the gate get no gradient (a fused
    epilogue's operands get the reference's zeros)."""

    @staticmethod
    def forward(ctx, x, w, forward_fn, surrogate, gate):
        ctx.save_for_backward(x, w)
        ctx.surrogate, ctx.gate = surrogate, gate
        return forward_fn(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = _gated_vjp(ctx.surrogate, x, w, g, ctx.gate, ctx.needs_input_grad[:2])
        return gx, gw, None, None, None


def _matmul(a, b):
    return a @ b


def needs_grad(x, w) -> bool:
    """Whether autograd would differentiate a projection of ``x`` and ``w``."""
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def model_mode_matmul(x, w, cfg: ApproxConfig, rng, backend: Optional[Backend] = None,
                      gate=None):
    """Accurate-forward / proxy-backward projection (MODEL mode).  With no
    operand needing a gradient it is a plain call into the emulator.
    ``gate`` routes the backward through the int8 grid (:func:`_gated_vjp`)."""
    backend = backend if backend is not None else cfg.backend
    spec = registry.get(backend)
    params = cfg.params_for(backend)
    if not needs_grad(x, w):
        return spec.emulate(x, w, params, rng)
    if cfg.proxy_in_backward and spec.proxy_forward is None:
        raise NotImplementedError(f"backend {spec.name!r} has no proxy_forward: it cannot train")
    return _ModelModeMatmul.apply(
        x, w, lambda a, b: spec.emulate(a.contiguous(), b.contiguous(), params, rng),
        _surrogate(spec, params, cfg.proxy_in_backward), gate)


def fused_model_mode_matmul(
    x, w, cfg: ApproxConfig, rng, epi: dict, backend: Optional[Backend] = None, gate=None
):
    """Emulated matmul with the chip/calibration epilogue ``epi`` (see
    :func:`repro_torch.kernels.epilogue.apply_epilogue`) in one kernel call
    (the serving decode path).  Its backward is the VJP of the proxy
    followed by the same epilogue, under ``gate`` (:func:`_gated_vjp`).
    ``None`` entries of ``epi`` are dropped."""
    backend = backend if backend is not None else cfg.backend
    epi = {k: v for k, v in epi.items() if v is not None}
    spec = registry.get(backend)
    params = cfg.params_for(backend)
    if not needs_grad(x, w):
        return spec.fused_emulate(x, w, params, rng, epi)
    if cfg.proxy_in_backward and spec.proxy_forward is None:
        raise NotImplementedError(f"backend {spec.name!r} has no proxy_forward: it cannot train")
    return _ModelModeMatmul.apply(
        x, w, lambda a, b: spec.fused_emulate(a, b, params, rng, epi),
        _surrogate(spec, params, cfg.proxy_in_backward, epi), gate)


def fast_forward(x, w, cfg: ApproxConfig, backend: Optional[Backend] = None):
    """The cheap forward whose residual the injection corrects: the proxy
    for Type-1 backends, a plain matmul for analog (the spec's ``fast``)."""
    backend = backend if backend is not None else cfg.backend
    return registry.get(backend).fast(x, w, cfg.params_for(backend))


def _gated(fn: Callable, x, w, gate):
    """``fn(x, w)``, whose backward runs on the int8 grid when ``gate`` is
    open; a closed gate (None or 0) keeps autograd's own graph, which is the
    exact VJP bit for bit."""
    if not gate or not needs_grad(x, w):
        return fn(x, w)
    return _ModelModeMatmul.apply(x, w, fn, fn, gate)


def gated_exact_matmul(x, w, gate):
    """Exact forward ``x @ w`` whose backward obeys the int8 gate: a site
    whose forward stays exact (warm-up phases, exact-mapped or skipped
    sites) can still run its two gradient matmuls on the int8 grid.  At
    gate 0 the VJP is the plain matmul's, bitwise."""
    return _gated(_matmul, x, w, gate)


def inject_mode_matmul(
    x, w, cfg: ApproxConfig, site, path: Sequence[int], backend: Optional[Backend] = None,
    gate=None,
):
    """Fast forward plus injected calibrated error (INJECT mode).  ``site``
    is the projection's calibration stats (``None``: no injection); the
    error is added detached, so it perturbs values and steers no
    gradient.  ``gate`` routes the fast forward's backward through the
    int8 grid."""
    y = _gated(lambda a, b: fast_forward(a, b, cfg, backend), x, w, gate)
    if site is None:
        return y
    err = calibration.sample_error(site, y.detach(), path, cfg.inject_std_scale)
    return y + err


def proxy_only_matmul(x, w, cfg: ApproxConfig, backend: Optional[Backend] = None, gate=None):
    """Proxy activation forward and backward, no injection (ablation);
    ``gate`` routes the backward through the int8 grid."""
    backend = backend if backend is not None else cfg.backend
    spec, params = registry.get(backend), cfg.params_for(backend)
    return _gated(lambda a, b: spec.proxy(a, b, params), x, w, gate)


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
