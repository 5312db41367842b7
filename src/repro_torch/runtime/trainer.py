"""Fault-tolerant training loop (port of ``repro.runtime.trainer``).

Beyond calling the step functions:

* **Phase pipeline** (paper Sec. 3.2/3.3): drives the declarative
  :class:`~repro_torch.core.schedule.PhasePlan`.  Per step it resolves
  the active :class:`Phase`, pulls the matching step from the
  :class:`~repro_torch.training.steps.StepCache` (keyed on mode,
  per-phase LR and microbatches, and the site-backend map, so each
  distinct step is built once), and lets the
  :class:`~repro_torch.core.schedule.CalibrationController` decide when
  a calibration batch runs (fixed cadence or adaptive drift-triggered).
* **Checkpoint/restart**: a save every ``checkpoint_every`` steps and at
  the end (copied to the host before the next step, written on a
  thread).  On a step failure (device loss, preemption; a fault hook in
  tests) the loop restores the latest generation and replays from
  there.  Data and key paths are functions of the step, so replayed
  batches and draws are identical.  The calibration controller's state
  rides inside every checkpoint, so a restart mid-phase resumes with its
  cadence and loss history.  The restart budget is windowed: a run of
  ``restart_reset_steps`` steps of new progress refunds it, so a long
  job survives many recoverable failures while a persistent one still
  aborts.
* **Restore in place**: the state's tensors are overwritten from the
  checkpoint (:meth:`repro_torch.ckpt.CheckpointManager.restore`), never
  rebuilt: at full width a second train state would not fit on the card.
  So the state the steps, the optimizer and the caller hold stays the
  same tensors, and a float32 parameter stays its own AdamW master.
* **Straggler watchdog**: per-step wall-time EWMA; steps slower than
  ``straggler_factor`` x the EWMA of the preceding steps are counted.

The reference builds its initial state from ``PRNGKey(seed)``; the
port's ``init(seed)`` draws other weights, so a caller that wants a
given start passes ``state=`` (the reference's, through
:func:`repro_torch.convert.train_state_from_jax`, or weights already on
the card), used when the checkpoint directory is empty.  That state is
trained in place: a fault before the first checkpoint cannot go back to
it, and is re-raised.

* **Variation-aware phases** (``Phase.fleet = N``): each step trains
  against chip ``step % N`` of a fleet sampled from ``variation`` under
  ``fleet_seed`` (default ``seed + 7919``, apart from the data's seed),
  built once per size.  The chip is a runtime argument of the chip-aware
  steps: its emulated forward and calibration stats are that chip's, and
  the adaptive calibration compares losses of one chip only.
* **Approximate backward** (``Phase.backward``): when any phase gates the
  backward, every train step is built bwd-aware and takes the gate mask,
  so exact phases pass zeros through the same step.  An ``"approx"``
  phase derives its sensitivity gate (:func:`repro_torch.search.
  sensitivity.backward_gate`, through the run's step cache) once at its
  entry, an ``"auto"`` phase every ``gate_every`` steps; each mask is kept
  per phase, so a replay after a restore reuses it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import ApproxConfig, CalibPolicy, Phase, TrainConfig, TrainMode
from repro_torch.convert import train_state_layout
from repro_torch.core import switch as switch_lib
from repro_torch.core.schedule import CalibrationController, PhasePlan
from repro_torch.data import SyntheticLM
from repro_torch.hw import Fleet, VariationModel
from repro_torch.models.model import Model, resolve_device
from repro_torch.models.transformer import check_trainable
from repro_torch.training.steps import StepCache, init_train_state


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    step_times: List[float]
    restarts: int
    straggler_steps: int
    calibrations: int
    # --- phase-pipeline accounting -----------------------------------
    calib_losses: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    mode_steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    phase_steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    compile_stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    fleet_steps: int = 0  # steps trained against a sampled device instance
    # --- approximate-backward accounting ------------------------------
    backward_steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    gate_refreshes: int = 0                 # sensitivity-gate derivations
    gate_events: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)               # (step, open-site count)
    # --- the port's: each entry of ``losses``'s global step, and whether
    # a calibration batch ran before it (replayed steps appear again) ---
    steps: List[int] = dataclasses.field(default_factory=list)
    calibrated: List[bool] = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(
        self,
        model: Model,
        approx: ApproxConfig,
        tcfg: TrainConfig,
        data: SyntheticLM,
        ckpt_dir: str,
        *,
        seed: int = 0,
        straggler_factor: float = 3.0,
        fault_hook: Optional[Callable[[int], None]] = None,
        log_every: int = 0,
        restart_budget: int = 10,
        restart_reset_steps: int = 50,
        device="cuda",
        state: Optional[Dict[str, Any]] = None,
        variation: Optional[VariationModel] = None,
        fleet_seed: Optional[int] = None,
    ):
        check_trainable(model.cfg, "the Trainer")
        if model.cfg.n_experts:
            raise NotImplementedError(
                "the Trainer and its checkpoints on a MoE model are not yet ported "
                "(ROADMAP A5); train a MoE model with training.steps.make_train_step")
        self.model = model
        self.approx = approx
        self.tcfg = tcfg
        self.data = data
        self.ckpt = CheckpointManager(ckpt_dir, keep=tcfg.keep_checkpoints)
        self.seed = seed
        self.straggler_factor = straggler_factor
        self.fault_hook = fault_hook
        self.log_every = log_every
        self.restart_budget = restart_budget
        self.restart_reset_steps = restart_reset_steps
        self.device = resolve_device(device) if state is None else None

        self.plan = PhasePlan.from_configs(approx, tcfg)
        self.controller = CalibrationController(self.plan, approx)
        self.steps = StepCache(model, approx, tcfg)
        self._state = state          # the live state: restored in place
        self._given = state is not None
        self._trained = False        # whether a step has changed self._state
        self.variation = variation if variation is not None else VariationModel()
        self.fleet_seed = fleet_seed if fleet_seed is not None else seed + 7919
        self._fleets: Dict[int, Fleet] = {}  # fleet size -> its chips
        # the approximate backward: with any phase gated, every train step
        # is bwd-aware and exact phases pass a zeros mask
        self._bwd_any = self.plan.any_gated_backward
        self._gates: Dict[int, Tuple[int, np.ndarray]] = {}  # phase -> (epoch, mask)
        self._gate_refreshes = 0
        self._gate_events: List[Tuple[int, int]] = []

    # ------------------------------------------------------------------
    def _state_like(self):
        if self._state is None:
            self._state = init_train_state(self.model, self.seed, self.approx, self.tcfg,
                                           device=self.device)
        return self._state

    def init_or_restore(self):
        """The latest checkpoint, restored in place into the live state
        (which also reloads the calibration controller's state saved
        beside it); else the initial state."""
        if self.ckpt.latest_step() is not None:
            state = self._state_like()
            layout = train_state_layout(state)
            if any(p.startswith("['sched']") for p in self.ckpt.paths()):
                full = self.ckpt.restore(dict(layout, sched=self.controller.to_tree()))
                self.controller.load_tree(full["sched"])
            else:
                # a checkpoint without a sched subtree: restore the train
                # state, start the controller fresh
                self.controller = CalibrationController(self.plan, self.approx)
                full = self.ckpt.restore(layout)
            state["step"] = int(full["step"])
            return state
        # no checkpoint: the controller restarts from scratch too, or a
        # failure before the first save replays with the aborted
        # attempt's cadence and skips the phase-entry calibration
        self.controller = CalibrationController(self.plan, self.approx)
        if self._trained:
            if self._given:
                raise RuntimeError(
                    "no checkpoint to restore yet, and the initial state given to the "
                    "Trainer was trained in place")
            self._state = None  # drawn again from the seed
            self._trained = False
        return self._state_like()

    def _save(self, step: int, state):
        self.ckpt.save(step, dict(train_state_layout(state), sched=self.controller.to_tree()))

    def _chip_for(self, phase: Phase, step: int):
        """The device instance this step trains against (None: nominal).
        Only steps that read the chip get one: MODEL and INJECT steps and
        phases that run calibration batches."""
        if not phase.fleet or not self.approx.active:
            return None
        if (phase.mode in (TrainMode.NO_MODEL, TrainMode.PROXY_ONLY)
                and phase.calibrate == CalibPolicy.OFF):
            return None
        fleet = self._fleets.get(phase.fleet)
        if fleet is None:
            fleet = self._fleets[phase.fleet] = Fleet(phase.fleet, seed=self.fleet_seed,
                                                      variation=self.variation)
        return fleet.chip_for_step(step)

    def _step_fn(self, step: int, chip_aware: bool = False):
        """The train step and its label for a global step (cache-backed)."""
        index, phase, _ = self.plan.phase_at(step)
        fn = self.steps.train(phase.mode, lr_scale=phase.lr_scale,
                              microbatches=phase.microbatches, chip_aware=chip_aware,
                              bwd_aware=self._bwd_any)
        label = phase.name if len(self.plan.phases) > 1 else phase.mode.value
        return fn, label, phase

    def _bwd_gate_for(self, index: int, phase: Phase, step: int, sip: int, state, batch):
        """This step's approximate-backward mask (None: no phase gates).
        An ``"exact"`` phase passes zeros; ``"approx"`` derives the
        sensitivity gate once at its entry, ``"auto"`` every
        ``phase.gate_every`` steps of the phase; a mask is kept per phase
        index.  Derivations run through the run's step cache, so every
        refresh shares one blend-grad step."""
        if not self._bwd_any:
            return None
        if phase.backward == "exact":
            return np.zeros(len(switch_lib.SITE_ORDER), np.int32)
        epoch = sip // phase.gate_every if phase.backward == "auto" else 0
        cached = self._gates.get(index)
        if cached is not None and cached[0] == epoch:
            return cached[1]
        from repro_torch.search import sensitivity  # deferred: search -> training steps

        mask = sensitivity.backward_gate(self.model, state["params"], batch, self.approx,
                                         frac=phase.gate_frac, seed=self.seed, fns=self.steps)
        self._gates[index] = (epoch, mask)
        self._gate_refreshes += 1
        self._gate_events.append((step, int(mask.sum())))
        return mask

    # ------------------------------------------------------------------
    def run(self, total_steps: Optional[int] = None) -> TrainReport:
        total = total_steps or self.plan.total_steps
        state = self.init_or_restore()
        start = int(state["step"])
        losses: List[float] = []
        times: List[float] = []
        steps: List[int] = []
        calibrated: List[bool] = []
        calib_losses: List[Tuple[int, float]] = []
        mode_steps: Dict[str, int] = {}
        phase_steps: Dict[str, int] = {}
        backward_steps: Dict[str, int] = {}
        restarts = 0
        fleet_steps = 0
        window_restarts = 0    # failures since the last budget refund
        success_streak = 0     # counts NEW-progress steps only (see below)
        best_step = start      # high-water mark of completed steps
        stragglers = 0
        calibrations = 0
        ewma = None

        step = start
        while step < total:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                rng = (self.seed + 17, step)  # fold_in(PRNGKey(seed + 17), step)
                batch = self.data.batch_at(step)
                # a variation-aware phase's device instance for this step
                cur_index, cur_phase, cur_sip = self.plan.phase_at(step)
                chip = self._chip_for(cur_phase, step)
                t0 = time.perf_counter()
                did_calibrate = self.controller.begin_step(step)
                if did_calibrate:
                    self._trained = True
                    cal = self.steps.calibration(chip_aware=chip is not None)
                    state, cmetrics = cal(state, batch, rng, chip)
                    self._state = state
                    closs = float(cmetrics["loss"])
                    # keyed on the chip: the adaptive policy compares one
                    # chip's losses (the fleet's spread is not drift)
                    self.controller.record(step, closs,
                                           key=step % cur_phase.fleet if chip is not None else -1)
                    calib_losses.append((step, closs))
                    calibrations += 1
                fn, label, phase = self._step_fn(step, chip_aware=chip is not None)
                self._trained = True
                fleet_steps += chip is not None
                gate = self._bwd_gate_for(cur_index, cur_phase, step, cur_sip, state, batch)
                if gate is None:
                    state, metrics = fn(state, batch, rng, chip)
                else:
                    state, metrics = fn(state, batch, rng, chip, bwd_gate=gate)
                self._state = state
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                losses.append(loss)
                times.append(dt)
                steps.append(step)
                calibrated.append(did_calibrate)
                # compare against the EWMA of *prior* steps: folding dt in
                # first inflates the threshold by ~10% and hides stragglers
                if ewma is not None and dt > self.straggler_factor * ewma and len(times) > 3:
                    stragglers += 1
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                mode_steps[phase.mode.value] = mode_steps.get(phase.mode.value, 0) + 1
                phase_steps[label] = phase_steps.get(label, 0) + 1
                backward_steps[phase.backward] = backward_steps.get(phase.backward, 0) + 1
                # only NEW progress counts toward the refund: replayed
                # steps always succeed (the failure hasn't recurred yet),
                # so counting them would let a persistent failure sitting
                # far past the last checkpoint retry forever
                if step + 1 > best_step:
                    best_step = step + 1
                    success_streak += 1
                if window_restarts and success_streak >= self.restart_reset_steps:
                    window_restarts = 0  # stable again: refund the budget
                if self.log_every and step % self.log_every == 0:
                    print(f"[{label}] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
                if (step + 1) % self.tcfg.checkpoint_every == 0 or step + 1 == total:
                    self._save(step + 1, state)
                step += 1
            except (FloatingPointError, RuntimeError) as e:  # device loss etc.
                restarts += 1
                window_restarts += 1
                success_streak = 0
                if window_restarts > self.restart_budget:
                    raise
                print(f"[trainer] step {step} failed ({e}); restoring latest checkpoint")
                state = self.init_or_restore()
                step = int(state["step"])
        self.ckpt.wait()
        return TrainReport(
            losses,
            times,
            restarts,
            stragglers,
            calibrations,
            calib_losses=calib_losses,
            mode_steps=mode_steps,
            phase_steps=phase_steps,
            compile_stats=self.steps.stats(),
            fleet_steps=fleet_steps,
            backward_steps=backward_steps,
            gate_refreshes=self._gate_refreshes,
            gate_events=list(self._gate_events),
            steps=steps,
            calibrated=calibrated,
        )
