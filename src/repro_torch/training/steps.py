"""Train, calibration and eval steps, and the caches that hold them (port
of ``repro.training.steps``: ``init_train_state``, ``make_train_step``,
``make_calibration_step``, ``make_eval_step``, ``CompiledFnCache`` and
``StepCache``, with their chip-, switch- and backward-gate-aware
variants).

Every step takes a trailing ``chip`` (default None; a
:class:`repro_torch.hw.variation.ChipProfile`): its emulated forward and
its calibration stats are then that device instance's (variation-aware
training).  A switch-aware train or eval step also takes ``backend_idx``
after it (a :mod:`repro_torch.core.switch` index array or
``model_indices`` dict): the site->backend map is an argument, so every
map shares one step built on ``switch.canonical(approx)``.  A
backward-gate-aware train step takes ``bwd_gate`` last (an int32
``[n_sites]`` host mask, ``ApproxCtx.bwd_gate``): exact and gated phases
share the one step, exact ones passing zeros.

The paper's schedule alternates graphs (INJECT or bit-accurate MODEL
forward), so each step is built for one mode.  The reference jits its
steps; these run eagerly, op by op, which is also how the reference is
held to them on the CPU.

A train state is ``{"params", "opt", "calib", "step"}``: the model's
``Transformer`` (trainable), the AdamW state (:mod:`repro_torch.optim.
adamw`), the calibration tree (:func:`repro_torch.models.transformer.
init_calibration`) and the step count.  A train step updates the
parameters and the optimizer state in place and returns the state.

``rng`` is a key path (see :class:`repro_torch.core.approx_linear.
ApproxCtx`): the reference's ``fold_in(PRNGKey(1), s)`` is ``(1, s)``,
and microbatch ``i`` of a step folds in ``i`` as the reference does.
Batches are the numpy dicts of :class:`repro_torch.data.SyntheticLM` (or
tensors), moved to the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ApproxConfig, TrainConfig, TrainMode
from repro_torch.core import switch as switch_lib
from repro_torch.models.model import Model, resolve_device
from repro_torch.models.transformer import check_trainable
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.training.losses import accuracy, lm_loss


def init_train_state(model: Model, seed: int, approx: ApproxConfig,
                     tcfg: Optional[TrainConfig] = None, *, device="cuda",
                     params=None) -> Dict[str, Any]:
    """A fresh train state: ``model.init(seed)`` on ``device`` (or the
    given ``params``, which are trained in place from here on), every
    weight made trainable, AdamW's state (``tcfg.optim_compress``), zero
    calibration stats.  A MoE model takes ``optim_compress="none"`` only;
    an SSM or HYBRID model is refused (ROADMAP A5)."""
    _check_moe_optim(model, tcfg)
    device = resolve_device(device)
    if params is None:
        params = model.init(seed, device)
    for p in params.parameters():
        p.requires_grad_(True)
    return {
        "params": params,
        "opt": adamw_init(dict(params.named_parameters()),
                          tcfg.optim_compress if tcfg is not None else "none"),
        "calib": model.init_calibration(approx, params.device),
        "step": 0,
    }


def _batch(batch, device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as integer tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        out[k] = t.to(device=device, dtype=torch.long)
    return out


def _loss_parts(params, batch, model: Model, approx, calib, rng, tcfg: TrainConfig,
                chip=None, backend_idx=None, bwd_gate=None):
    """(the LM loss plus 0.01 times the load-balance loss, the LM loss,
    the load-balance loss), as the reference's ``_loss_fn``."""
    out = model.apply(params, batch, approx=approx, calib=calib, rng=rng, remat=tcfg.remat,
                      chip=chip, backend_idx=backend_idx, bwd_gate=bwd_gate)
    loss = lm_loss(out.logits, batch["labels"])
    return loss + 0.01 * out.aux_loss, loss, out.aux_loss


def _loss(*args, **kw):
    """The loss a train step differentiates (:func:`_loss_parts`' first)."""
    return _loss_parts(*args, **kw)[0]


def _check_moe_optim(model: Model, tcfg: Optional[TrainConfig]) -> None:
    check_trainable(model.cfg, "training")
    if model.cfg.n_experts and tcfg is not None and tcfg.optim_compress != "none":
        raise NotImplementedError(
            f"optim_compress={tcfg.optim_compress!r} on a MoE model is not yet ported "
            "(ROADMAP A5: SM3's factors and the rounding over [L, E, ...] expert stacks); "
            "use optim_compress='none'")


def _switch_arg(switch_aware: bool, backend_idx):
    """A switch-aware step needs its map; another step takes none."""
    if switch_aware and backend_idx is None:
        raise TypeError("a switch-aware step needs backend_idx")
    if not switch_aware and backend_idx is not None:
        raise TypeError("backend_idx needs a switch-aware step (switch_aware=True)")
    return backend_idx


def _split_micro(batch, n: int, i: int):
    return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i] for k, v in batch.items()}


def make_train_step(model: Model, approx: ApproxConfig, tcfg: TrainConfig,
                    mode: Optional[TrainMode] = None, *, switch_aware: bool = False,
                    bwd_aware: bool = False):
    """A train step for one approx mode (default: ``approx.mode``):
    ``step(state, batch, rng, chip=None) -> (state, metrics)``, or with
    ``switch_aware`` ``step(state, batch, rng, chip=None, backend_idx=...)``
    (pass the canonical config, ``switch.canonical``).  With ``bwd_aware``
    the step also needs ``bwd_gate=`` (the approximate backward's mask,
    zeros for an exact backward).

    With ``tcfg.microbatches`` > 1 the batch splits into that many
    microbatches along its rows, each with ``rng`` + ``(i,)``; their
    gradients sum in float32 and divide by the count, as the reference's
    scan does.

    The loss differentiated is the LM loss plus 0.01 times the forward's
    load-balance loss (0 for DENSE); ``metrics["loss"]`` is the LM loss,
    ``metrics["aux_loss"]`` the load-balance loss and
    ``metrics["total_loss"]`` their sum, each averaged over microbatches,
    as the reference reports them.  A MoE model trains with
    ``optim_compress="none"`` only; an SSM or HYBRID model is refused
    (ROADMAP A5)."""
    _check_moe_optim(model, tcfg)
    if mode is not None:
        approx = dataclasses.replace(approx, mode=mode)

    def step(state, batch, rng: Tuple[int, ...], chip=None, backend_idx=None, bwd_gate=None):
        backend_idx = _switch_arg(switch_aware, backend_idx)
        if bwd_aware != (bwd_gate is not None):
            raise TypeError("a bwd-aware step needs bwd_gate, and only it takes one "
                            "(bwd_aware=True)")
        params, calib = state["params"], state["calib"]
        named = dict(params.named_parameters())
        batch = _batch(batch, params.device)
        rng = tuple(rng)

        def grad_one(mb, r):
            total, loss, aux = _loss_parts(params, mb, model, approx, calib, r, tcfg, chip,
                                           backend_idx, bwd_gate)
            gs = torch.autograd.grad(total, list(named.values()), allow_unused=True)
            gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, named.values())]
            return dict(zip(named, gs)), total.detach(), loss.detach(), aux.detach()

        n_micro = tcfg.microbatches
        if n_micro <= 1:
            grads, total, loss, aux = grad_one(batch, rng)
        else:
            grads = None
            total, loss, aux = (torch.zeros((), device=params.device) for _ in range(3))
            for i in range(n_micro):
                g, t, l_, a = grad_one(_split_micro(batch, n_micro, i), rng + (i,))
                if grads is None:
                    grads = {n: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                             for n, v in g.items()}
                for n, v in g.items():
                    grads[n] = grads[n] + v.to(torch.float32)
                total, loss, aux = total + t, loss + l_, aux + a
                del g
            grads = {n: v / n_micro for n, v in grads.items()}
            total, loss, aux = total / n_micro, loss / n_micro, aux / n_micro
        opt_metrics = adamw_update(grads, state["opt"], named, tcfg)
        state["step"] += 1
        metrics = {"loss": loss, "aux_loss": aux, **opt_metrics, "total_loss": total}
        return state, metrics

    return step


def make_calibration_step(model: Model, approx: ApproxConfig, tcfg: TrainConfig):
    """A forward pass with the bit-accurate emulation that refreshes the
    error-injection stats (paper Sec. 3.2's calibration batches):
    ``step(state, batch, rng, chip=None) -> (state with the new calib,
    metrics)``; with a chip the stats are that device instance's.  An SSM
    or HYBRID model is refused (ROADMAP A5)."""
    del tcfg
    check_trainable(model.cfg, "the calibration step")

    @torch.no_grad()
    def step(state, batch, rng: Tuple[int, ...], chip=None):
        params = state["params"]
        batch = _batch(batch, params.device)
        out = model.apply(params, batch, approx=approx, calib=state["calib"], rng=tuple(rng),
                          collect=True, remat="none", chip=chip)
        return dict(state, calib=out.collected), {"loss": lm_loss(out.logits, batch["labels"])}

    return step


def make_eval_step(model: Model, approx: ApproxConfig, *, switch_aware: bool = False):
    """Validation with the bit-accurate emulation (what the hardware would
    produce): MODEL mode whenever the config has approximate backends, or
    is switch-aware (the canonical config has none of its own).
    ``step(state, batch, rng, chip=None) -> {"loss", "accuracy"}``; with
    ``switch_aware`` the map comes as ``backend_idx`` after ``chip``.  An
    SSM or HYBRID model is refused (ROADMAP A5)."""
    check_trainable(model.cfg, "the eval step")
    eval_cfg = (dataclasses.replace(approx, mode=TrainMode.MODEL)
                if approx.approx_backends or switch_aware else approx)

    @torch.no_grad()
    def step(state, batch, rng: Tuple[int, ...], chip=None, backend_idx=None):
        backend_idx = _switch_arg(switch_aware, backend_idx)
        params = state["params"]
        batch = _batch(batch, params.device)
        out = model.apply(params, batch, approx=eval_cfg, calib=state["calib"], rng=tuple(rng),
                          remat="none", chip=chip, backend_idx=backend_idx)
        return {"loss": lm_loss(out.logits, batch["labels"]),
                "accuracy": accuracy(out.logits, batch["labels"])}

    return step


# ---------------------------------------------------------------------------
# Step cache
# ---------------------------------------------------------------------------


class CompiledFnCache:
    """Built steps memoised under the key of what they compute: the
    reference's jit cache, which training and the search share.  The
    port's steps run eagerly, so an entry is built once and never traced;
    :meth:`stats` reports ``{"built": n}``, the number of distinct steps
    built (under switch dispatch the search builds at most two: one eval,
    one blend-grad)."""

    def __init__(self):
        self._fns: Dict[Tuple, Callable] = {}

    def get(self, key: Tuple, build: Callable[[], Callable]) -> Callable:
        """The step for ``key``, built by ``build()`` on first use."""
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = build()
        return fn

    def stats(self) -> Dict[str, int]:
        return {"built": len(self._fns)}


class StepCache(CompiledFnCache):
    """The built steps of one model and run, memoised under the
    reference's key: ``(kind, resolved ApproxConfig, lr_scale,
    microbatches, chip_aware, switch_aware, bwd_aware)``.  The resolved
    config is the run's with the requested mode substituted, a frozen
    dataclass whose hash covers the mode, every backend's params and the
    site-backend map, so two phases that share a step share one entry.

    Every step takes the chip as a trailing argument; the key records
    only *that* a chip is threaded (``chip_aware``, as the reference's jit
    cache does), never which one: a whole fleet shares one entry.  A
    switch-aware step is keyed on the canonical config
    (``switch.canonical``), so every map of a mode shares it; its map is
    its ``backend_idx`` argument.

    A backward-gate-aware step (``bwd_aware``) is keyed only on *that* it
    takes a gate, so exact and gated phases share one entry.

    The reference jits each entry and counts its traces; the port's steps
    run eagerly, so :meth:`stats` reports only ``{"built": n}``.
    """

    def __init__(self, model: Model, approx: ApproxConfig, tcfg: TrainConfig):
        super().__init__()
        self.model = model
        self.approx = approx
        self.tcfg = tcfg

    # ------------------------------------------------------------------
    def _resolve(self, mode: Optional[TrainMode]) -> ApproxConfig:
        if mode is None or mode == self.approx.mode:
            return self.approx
        return dataclasses.replace(self.approx, mode=mode)

    def _tcfg_for(self, lr_scale: float, microbatches: int) -> TrainConfig:
        if lr_scale == 1.0 and not microbatches:
            return self.tcfg
        return dataclasses.replace(
            self.tcfg,
            learning_rate=self.tcfg.learning_rate * lr_scale,
            microbatches=microbatches or self.tcfg.microbatches,
        )

    # ------------------------------------------------------------------
    def train(self, mode: Optional[TrainMode] = None, *, lr_scale: float = 1.0,
              microbatches: int = 0, chip_aware: bool = False, switch_aware: bool = False,
              bwd_aware: bool = False) -> Callable:
        approx = self._resolve(mode)
        if switch_aware:
            approx = switch_lib.canonical(approx)
        key = ("train", approx, lr_scale, microbatches or self.tcfg.microbatches,
               chip_aware, switch_aware, bwd_aware)
        return self.get(key, lambda: make_train_step(
            self.model, approx, self._tcfg_for(lr_scale, microbatches),
            switch_aware=switch_aware, bwd_aware=bwd_aware))

    def calibration(self, *, chip_aware: bool = False) -> Callable:
        # calibration stays static: per-(site, backend) stat shapes cannot
        # follow a runtime map
        key = ("calibrate", self.approx, 1.0, self.tcfg.microbatches, chip_aware)
        return self.get(key, lambda: make_calibration_step(self.model, self.approx, self.tcfg))

    def eval(self, *, chip_aware: bool = False, switch_aware: bool = False) -> Callable:
        approx = switch_lib.canonical(self.approx) if switch_aware else self.approx
        key = ("eval", approx, 1.0, self.tcfg.microbatches, chip_aware, switch_aware)
        return self.get(key, lambda: make_eval_step(self.model, approx,
                                                    switch_aware=switch_aware))
