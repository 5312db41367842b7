"""Per-site approximation-sensitivity profiling (port of
``repro.search.sensitivity``: ``SiteSensitivity``, ``SensitivityProfile``,
``one_site_config``, ``_blend_grad_builder``, ``_switch_cfg``,
``eval_loss``, ``fleet_eval_losses``, ``backward_sensitivities``,
``backward_gate`` and ``profile_sensitivity``).

For every (projection site, candidate backend) pair, two signals on a
fixed profiling batch:

* ``first_order`` — d(loss)/d(blend) at blend=0, the site's output being
  ``y_exact + blend * (y_hw - y_exact)`` (``ApproxCtx.blend``): the
  first-order loss change grad·Δ of moving the site onto the hardware, the
  gradient flowing through the backend's proxy backward (MODEL mode).  One
  backward pass a pair, ``torch.autograd.grad`` with respect to the scalar
  ``blend`` alone: the parameters are held out of the graph during the
  probe, so the forward saves nothing for weight gradients.
* ``hw_delta`` — the swap-one-site hardware-eval loss (MODEL mode, the
  bit-accurate emulation) minus the exact eval loss.

Every step comes from a shared :class:`~repro_torch.training.steps.
CompiledFnCache` keyed on what it computes, so the Pareto search scoring
the same configs later reuses each built step; under ``dispatch="switch"``
the whole probe grid shares two (one eval, one blend-grad).  Deterministic
under a fixed seed.  :func:`backward_gate` ranks the sites by their
first-order sensitivity alone and opens the least sensitive to the
approximate backward (``Phase(backward="approx" | "auto")``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
from repro_torch.core import switch as switch_lib
from repro_torch.models.model import Model
from repro_torch.models.transformer import check_trainable
from repro_torch.search import costmodel
from repro_torch.training.losses import lm_loss
from repro_torch.training.steps import CompiledFnCache, _batch, make_eval_step


@dataclasses.dataclass(frozen=True)
class SiteSensitivity:
    site: str
    backend: str
    first_order: float    # signed d loss / d blend at blend=0
    hw_delta: float       # full MODEL-mode eval loss minus exact loss
    energy_saving: float  # joules-equivalents saved vs exact at this site

    @property
    def score(self) -> float:
        """Greedy desirability: energy saved per unit of (clipped) loss
        hurt.  Loss-improving or loss-neutral swaps rank highest."""
        return self.energy_saving / max(self.hw_delta, 1e-6)


@dataclasses.dataclass(frozen=True)
class SensitivityProfile:
    exact_loss: float
    entries: Tuple[SiteSensitivity, ...]

    def ranking(self, backend: Optional[str] = None) -> Tuple[SiteSensitivity, ...]:
        """Entries sorted most-tolerant first (ascending |first_order|);
        the (site, backend) tiebreak keeps the order stable under a fixed
        seed."""
        pool = [e for e in self.entries if backend is None or e.backend == backend]
        return tuple(sorted(pool, key=lambda e: (abs(e.first_order), e.site, e.backend)))

    def lookup(self, site: str, backend: str) -> SiteSensitivity:
        for e in self.entries:
            if e.site == site and e.backend == backend:
                return e
        raise KeyError(f"no sensitivity entry for ({site!r}, {backend!r})")

    def best_move(self, site: str) -> Optional[SiteSensitivity]:
        """The highest-score energy-saving move for a site (None when no
        candidate backend saves energy there, e.g. long-stream SC)."""
        moves = [e for e in self.entries if e.site == site and e.energy_saving > 0]
        return max(moves, key=lambda e: e.score) if moves else None


def one_site_config(base: ApproxConfig, site: str, backend: str,
                    mode: TrainMode = TrainMode.MODEL) -> ApproxConfig:
    """An ApproxConfig approximating exactly one site (default exact)."""
    return dataclasses.replace(base, backend=Backend.EXACT, mode=mode,
                               site_backends=((site, backend),))


@contextlib.contextmanager
def _held_out(params):
    """The parameters out of autograd's graph for the probe (restored
    after): only ``blend`` is differentiated."""
    flags = [(p, p.requires_grad) for p in params.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _blend_grad_builder(model: Model, approx: ApproxConfig, switch_aware: bool = False):
    """A builder of ``grad_fn(params, batch, rng, blend[, backend_idx])``,
    d(loss)/d(blend) at ``blend`` as a float32 scalar tensor."""

    def grad_fn(params, batch, rng, blend, backend_idx=None):
        if switch_aware and backend_idx is None:
            raise TypeError("a switch-aware blend probe needs backend_idx")
        batch = _batch(batch, params.device)
        b = torch.tensor(float(blend), dtype=torch.float32, device=params.device,
                         requires_grad=True)
        with torch.enable_grad(), _held_out(params):
            out = model.apply(params, batch, approx=approx, rng=tuple(rng), remat="none",
                              blend=b, backend_idx=backend_idx)
            loss = lm_loss(out.logits, batch["labels"])
            (g,) = torch.autograd.grad(loss, [b], allow_unused=True)
        return torch.zeros_like(b) if g is None else g

    if switch_aware:
        return lambda: grad_fn
    return lambda: lambda params, batch, rng, blend: grad_fn(params, batch, rng, blend)


def _switch_cfg(approx: ApproxConfig, switch_backends=None) -> ApproxConfig:
    """The canonical MODEL-mode config every switch-dispatched eval is
    keyed on: the mode pinned to MODEL before canonicalisation, so probes
    and candidates of any map land on one key.  ``switch_backends`` (a
    closed backend world, e.g. the search's) restricts the switch table
    (:func:`repro_torch.core.switch.subtable`) and joins the key."""
    ccfg = switch_lib.canonical(dataclasses.replace(approx, mode=TrainMode.MODEL))
    if switch_backends is not None:
        ccfg = dataclasses.replace(ccfg, switch_backends=switch_lib.subtable(switch_backends))
    return ccfg


def _switch_idx(approx: ApproxConfig, ccfg: ApproxConfig):
    return switch_lib.site_indices(approx, table=ccfg.switch_backends)


def eval_loss(model: Model, params, batch, approx: ApproxConfig, rng, fns: CompiledFnCache,
              dispatch: str = "static", switch_backends=None) -> float:
    """Hardware-eval loss (MODEL mode, the bit-accurate emulation) of
    ``approx`` on a batch, through the shared step cache.

    ``dispatch="switch"`` keys the step on the canonical config and passes
    the site->backend map as its index array (:mod:`repro_torch.core.
    switch`): every candidate map shares one step.  ``switch_backends``
    restricts the switch table to a closed backend world."""
    state = {"params": params, "calib": None}  # MODEL mode reads no stats
    if dispatch == "switch":
        ccfg = _switch_cfg(approx, switch_backends)
        fn = fns.get(("hw_eval_switch", ccfg),
                     lambda: make_eval_step(model, ccfg, switch_aware=True))
        return float(fn(state, batch, rng, backend_idx=_switch_idx(approx, ccfg))["loss"])
    fn = fns.get(("hw_eval", approx), lambda: make_eval_step(model, approx))
    return float(fn(state, batch, rng)["loss"])


def fleet_eval_losses(model: Model, params, batch, approx: ApproxConfig, rng,
                      fns: CompiledFnCache, chips, dispatch: str = "static",
                      switch_backends=None) -> Tuple[float, ...]:
    """Hardware-eval loss on each device instance of a sampled fleet
    (:class:`repro_torch.hw.Fleet`'s ``chips``): one chip-aware step per
    config (one per closed world under switch dispatch), the chip its
    argument."""
    state = {"params": params, "calib": None}
    if dispatch == "switch":
        ccfg = _switch_cfg(approx, switch_backends)
        fn = fns.get(("hw_eval_chip_switch", ccfg),
                     lambda: make_eval_step(model, ccfg, switch_aware=True))
        idx = _switch_idx(approx, ccfg)
        return tuple(float(fn(state, batch, rng, chip, backend_idx=idx)["loss"])
                     for chip in chips)
    fn = fns.get(("hw_eval_chip", approx), lambda: make_eval_step(model, approx))
    return tuple(float(fn(state, batch, rng, chip)["loss"]) for chip in chips)


def backward_sensitivities(model: Model, params, batch, base: ApproxConfig, *,
                           probe_backend=None, seed: int = 0,
                           fns: Optional[CompiledFnCache] = None, dispatch: str = "switch",
                           switch_backends=None,
                           sites: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """``{site: |first_order|}`` against one probe backend: the blend-grad
    half of :func:`profile_sensitivity` (no hardware evals, no energy),
    enough to rank sites for the approximate backward's gate (refused for
    an SSM or HYBRID model, as the search is).
    ``probe_backend`` defaults to the first of ``base``'s approximate
    backends, else ``approx_mult`` (the int8 datapath the gated backward
    emulates).  Under ``dispatch="switch"`` (the default) every site shares
    one blend-grad step of ``fns``, so a second derivation builds
    nothing."""
    check_searchable(model)
    fns = fns if fns is not None else CompiledFnCache()
    if probe_backend is None:
        ab = base.approx_backends
        if ab:
            probe_backend = ab[0].value if isinstance(ab[0], Backend) else str(ab[0])
        else:
            probe_backend = Backend.APPROX_MULT.value
    B, T = batch["tokens"].shape
    costs = costmodel.site_costs(model.cfg, seq_len=T, batch=B)
    sites = tuple(sites) if sites is not None else tuple(costs)
    rng = (seed,)  # the reference's PRNGKey(seed)
    if dispatch == "switch" and switch_backends is None:
        switch_backends = (probe_backend,)
    out = {}
    for site in sites:
        if site not in costs:
            continue
        probe = one_site_config(base, site, probe_backend)
        if dispatch == "switch":
            ccfg = _switch_cfg(probe, switch_backends)
            grad_fn = fns.get(("blend_grad_switch", ccfg),
                              _blend_grad_builder(model, ccfg, switch_aware=True))
            fo = float(grad_fn(params, batch, rng, 0.0, _switch_idx(probe, ccfg)))
        else:
            grad_fn = fns.get(("blend_grad", probe), _blend_grad_builder(model, probe))
            fo = float(grad_fn(params, batch, rng, 0.0))
        out[site] = abs(fo)
    return out


def backward_gate(model: Model, params, batch, base: ApproxConfig, *, frac: float = 0.75,
                  probe_backend=None, seed: int = 0, fns: Optional[CompiledFnCache] = None,
                  dispatch: str = "switch", switch_backends=None) -> np.ndarray:
    """The approximate backward's gate: the int32 ``[n_sites]`` mask over
    ``switch.SITE_ORDER`` that ``ApproxCtx.bwd_gate`` reads.  The sites are
    ranked by :func:`backward_sensitivities`, most sensitive first (ties
    by site name); the ``ceil((1 - frac) * n)`` most sensitive keep the
    exact backward and the rest open.  Sites this architecture lacks stay
    closed."""
    sens = backward_sensitivities(model, params, batch, base, probe_backend=probe_backend,
                                  seed=seed, fns=fns, dispatch=dispatch,
                                  switch_backends=switch_backends)
    n = len(sens)
    mask = np.zeros(len(switch_lib.SITE_ORDER), np.int32)
    if n == 0 or frac <= 0.0:
        return mask
    n_exact = int(math.ceil((1.0 - frac) * n))
    for site in sorted(sens, key=lambda s: (-sens[s], s))[n_exact:]:
        mask[switch_lib.site_pos(site)] = 1
    return mask


def check_searchable(model: Model) -> None:
    """Raise for a MoE model: the search on MoE is not yet held against
    the reference, whose blend and switch never reach the experts (their
    sub-contexts drop both; ROADMAP A5).  Raise for an SSM or HYBRID
    model, which the port serves only."""
    check_trainable(model.cfg, "the search")
    if model.cfg.n_experts:
        raise NotImplementedError(
            f"the search on a MoE model ({model.cfg.name}) is not yet ported (ROADMAP A5)")


def profile_sensitivity(
    model: Model,
    params,
    batch,
    base: ApproxConfig,
    backends: Sequence[str],
    *,
    sites: Optional[Iterable[str]] = None,
    seed: int = 0,
    fns: Optional[CompiledFnCache] = None,
    measured=None,
    dispatch: str = "static",
    switch_backends=None,
) -> SensitivityProfile:
    """Profile every (site, backend) pair on one batch.

    ``base`` gives the hardware knobs (per-backend params, skip flags); its
    own backend map is ignored, each probe approximating one site.
    ``sites`` defaults to every projection site the architecture runs.
    ``measured`` (:func:`repro_torch.search.costmodel.load_measured_energy`)
    overrides the analytic energy models in ``energy_saving``.

    ``dispatch="switch"`` runs the whole sites x backends grid on two
    steps (one eval, one blend-grad), each probe an index-array swap,
    with switch tables restricted to ``switch_backends`` (default
    ``backends``); ``"static"`` builds a step per probe config.
    """
    check_searchable(model)
    fns = fns if fns is not None else CompiledFnCache()
    cfg = model.cfg
    B, T = batch["tokens"].shape
    costs = costmodel.site_costs(cfg, seq_len=T, batch=B)
    sites = tuple(sites) if sites is not None else tuple(costs)
    rng = (seed,)  # the reference's PRNGKey(seed)

    if dispatch == "switch" and switch_backends is None:
        switch_backends = tuple(str(b) for b in backends)

    exact_cfg = dataclasses.replace(base, backend=Backend.EXACT, mode=TrainMode.NO_MODEL,
                                    site_backends=())
    exact = eval_loss(model, params, batch, exact_cfg, rng, fns, dispatch,
                      switch_backends=switch_backends)

    entries = []
    for site in sites:
        c = costs.get(site)
        if c is None:  # site absent from this architecture
            continue
        e_exact = c["macs"] * costmodel.site_mac_energy(exact_cfg, site, c["k"],
                                                        measured=measured)
        for backend in backends:
            probe = one_site_config(base, site, backend)
            if dispatch == "switch":
                ccfg = _switch_cfg(probe, switch_backends)
                grad_fn = fns.get(("blend_grad_switch", ccfg),
                                  _blend_grad_builder(model, ccfg, switch_aware=True))
                fo = float(grad_fn(params, batch, rng, 0.0, _switch_idx(probe, ccfg)))
            else:
                grad_fn = fns.get(("blend_grad", probe), _blend_grad_builder(model, probe))
                fo = float(grad_fn(params, batch, rng, 0.0))
            hw = eval_loss(model, params, batch, probe, rng, fns, dispatch,
                           switch_backends=switch_backends)
            e_site = c["macs"] * costmodel.site_mac_energy(probe, site, c["k"],
                                                           measured=measured)
            entries.append(SiteSensitivity(site=site, backend=str(backend), first_order=fo,
                                           hw_delta=hw - exact,
                                           energy_saving=e_exact - e_site))
    return SensitivityProfile(exact_loss=exact, entries=tuple(entries))
