"""Declarative multi-phase schedule resolver (paper Sec. 3.2 / 3.3); a
copy of ``repro.core.schedule``, plain Python and numpy.

The paper's headline training-cost win comes from *scheduling*: most
steps run in cheap modes (proxy / injection), with bit-accurate MODEL
emulation and calibration confined to a small, well-placed fraction.
A schedule is a ``tuple[Phase, ...]`` on :class:`TrainConfig`; this
module resolves it:

* :class:`PhasePlan` — maps a global step index to (phase index, phase,
  step-within-phase).  Modes change the step's graph, so the plan is
  resolved in Python by the driver, which pulls built steps from the
  :class:`repro_torch.training.steps.StepCache`: each distinct step is
  built once, whatever the phase sequence.
* :class:`CalibrationController` — executes each phase's calibration
  policy (``every_n`` fixed cadence, ``adaptive`` drift-triggered, or
  ``off``).  Its state is a small pytree of numpy scalars that the
  Trainer persists inside checkpoints, so a preempted run resumes
  mid-phase with the adaptive cadence and loss history intact.
* :func:`paper_schedule` — the paper's recipe as a one-liner: exact
  warmup -> inject with calibration -> short bit-accurate MODEL tail.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import (
    ApproxConfig,
    CalibPolicy,
    Phase,
    TrainConfig,
    TrainMode,
)


class PhaseStep(NamedTuple):
    index: int
    phase: Phase
    step_in_phase: int


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """A resolved phase sequence: global step -> phase lookup."""

    phases: Tuple[Phase, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("PhasePlan needs at least one phase")
        starts, acc = [], 0
        for p in self.phases:
            starts.append(acc)
            acc += p.steps
        object.__setattr__(self, "_starts", tuple(starts))

    # ------------------------------------------------------------------
    @classmethod
    def from_configs(
        cls,
        approx: ApproxConfig,
        tcfg: TrainConfig,
        total_steps: Optional[int] = None,
    ) -> "PhasePlan":
        """Resolve the schedule for a run.

        Priority: explicit ``tcfg.phases``; else the legacy two-phase
        inject/finetune split; else a single phase of the run's total
        steps in the config's mode (with every-N calibration when that
        mode is INJECT — injecting from never-refreshed zero stats is
        always a bug).  When the config is not approx-active, every
        phase collapses to plain exact training.
        """
        if tcfg.phases:
            return cls(tcfg.phases)
        if approx.active and (tcfg.inject_steps or tcfg.finetune_steps):
            phases = []
            if tcfg.inject_steps:
                phases.append(Phase.inject(tcfg.inject_steps))
            if tcfg.finetune_steps:
                phases.append(Phase.model(tcfg.finetune_steps))
            return cls(tuple(phases))
        steps = total_steps or tcfg.total_steps
        mode = approx.mode if approx.active else TrainMode.NO_MODEL
        calibrate = (
            CalibPolicy.EVERY_N if mode == TrainMode.INJECT else CalibPolicy.OFF
        )
        return cls((Phase(mode, steps, calibrate=calibrate),))

    # ------------------------------------------------------------------
    @property
    def total_steps(self) -> int:
        return self._starts[-1] + self.phases[-1].steps

    def phase_at(self, step: int) -> PhaseStep:
        """The phase a global step falls in (clamped to the last phase,
        so a driver asked to run past the plan keeps the final mode)."""
        for i in range(len(self.phases) - 1, -1, -1):
            if step >= self._starts[i]:
                return PhaseStep(i, self.phases[i], step - self._starts[i])
        return PhaseStep(0, self.phases[0], step)

    def mode_at(self, step: int) -> TrainMode:
        return self.phase_at(step).phase.mode

    def phase_start(self, index: int) -> int:
        return self._starts[index]

    def mode_counts(self, total: Optional[int] = None) -> Dict[str, int]:
        """Planned training steps per mode over ``total`` steps."""
        total = self.total_steps if total is None else total
        counts: Dict[str, int] = {}
        for step in range(total):
            m = self.mode_at(step).value
            counts[m] = counts.get(m, 0) + 1
        return counts

    @property
    def any_gated_backward(self) -> bool:
        """True when any phase runs (or may run) the approximate
        backward: the Trainer then builds every train step bwd-aware, so
        exact and gated phases share one step."""
        return any(p.backward != "exact" for p in self.phases)

    def describe(self) -> str:
        return " -> ".join(
            f"{p.name}:{p.steps}"
            + (f"[{p.calibrate.value}]" if p.calibrate != CalibPolicy.OFF else "")
            + (f"{{bwd={p.backward}@{p.gate_frac:g}}}"
               if p.backward != "exact" else "")
            for p in self.phases
        )


def paper_schedule(
    total_steps: int,
    *,
    warmup_frac: float = 0.1,
    tail_frac: float = 0.2,
    calibrate: str = "adaptive",
    drift_threshold: float = 0.02,
    tail_lr_scale: float = 1.0,
) -> Tuple[Phase, ...]:
    """The paper's recipe: exact warmup -> inject (calibrated) -> MODEL tail.

    Fractions are of ``total_steps``; the inject segment absorbs rounding
    so the phases sum exactly to the budget.
    """
    if total_steps < 3:
        raise ValueError("paper_schedule needs at least 3 steps")
    warmup = max(int(round(warmup_frac * total_steps)), 1)
    tail = max(int(round(tail_frac * total_steps)), 1)
    inject = total_steps - warmup - tail
    if inject < 1:
        raise ValueError(
            f"paper_schedule: warmup_frac={warmup_frac} + tail_frac={tail_frac} "
            f"leave no inject steps out of {total_steps}"
        )
    return (
        Phase.exact(warmup, name="warmup"),
        Phase.inject(
            inject,
            calibrate=calibrate,
            drift_threshold=drift_threshold,
            name="inject",
        ),
        Phase.model(tail, lr_scale=tail_lr_scale, name="finetune"),
    )


# ---------------------------------------------------------------------------
# Calibration policy execution
# ---------------------------------------------------------------------------


class CalibrationController:
    """Per-run calibration state machine.

    One instance per Trainer; ``begin_step`` is called once per training
    step and returns whether a calibration batch should run first, and
    ``record`` feeds the measured calibration loss back so the ADAPTIVE
    policy can adjust its cadence.  All mutable state round-trips through
    :meth:`to_tree` / :meth:`load_tree` as numpy scalars, so checkpoints
    capture it and a mid-phase restart replays the exact same calibration
    decisions (data and rng are already splittable-deterministic).
    """

    def __init__(self, plan: PhasePlan, approx: ApproxConfig):
        self.plan = plan
        self.approx = approx
        self.phase_index = -1          # none entered yet
        self.interval = self._base_every(plan.phases[0])
        self.since = self.interval     # "due now" on first adaptive step
        self.last_loss = math.nan
        self.last_key = -1             # source of last_loss (e.g. chip id)
        self.count = 0

    # -- policy parameters ---------------------------------------------
    def _base_every(self, phase: Phase) -> int:
        return max(phase.calibrate_every or self.approx.calibrate_every, 1)

    def _max_every(self, phase: Phase) -> int:
        return phase.max_calibrate_every or 8 * self._base_every(phase)

    # -- driver API -----------------------------------------------------
    def begin_step(self, step: int) -> bool:
        """Advance to ``step``; True if a calibration batch runs first."""
        index, phase, sip = self.plan.phase_at(step)
        if index != self.phase_index:
            # phase entry: reset the cadence; forget the previous phase's
            # loss level (a mode switch shifts the loss scale, which must
            # not read as drift)
            self.phase_index = index
            self.interval = self._base_every(phase)
            self.since = self.interval
            self.last_loss = math.nan
        if not self.approx.active or phase.calibrate == CalibPolicy.OFF:
            return False
        if phase.calibrate == CalibPolicy.EVERY_N:
            do = sip % self._base_every(phase) == 0
        else:  # ADAPTIVE
            do = self.since >= self.interval
        self.since = 1 if do else self.since + 1
        return do

    def record(self, step: int, loss: float, key: int = -1) -> None:
        """Feed back the loss of the calibration batch that just ran.

        ``key`` identifies the loss's *source* (the device instance the
        batch was emulated on — chip id under variation-aware phases).
        The ADAPTIVE comparison only engages between consecutive losses
        from the same source: a fleet's chip-to-chip loss spread is
        fabrication variation, not drift, and must not collapse the
        cadence to every-step.
        """
        phase = self.plan.phase_at(step).phase
        if (
            phase.calibrate == CalibPolicy.ADAPTIVE
            and math.isfinite(self.last_loss)
            and key == self.last_key
        ):
            rel = abs(loss - self.last_loss) / max(abs(self.last_loss), 1e-8)
            if rel > phase.drift_threshold:
                self.interval = max(self.interval // 2, 1)
            else:
                self.interval = min(self.interval * 2, self._max_every(phase))
        self.last_loss = float(loss)
        self.last_key = int(key)
        self.count += 1

    # -- checkpoint round-trip -----------------------------------------
    def to_tree(self) -> Dict[str, np.ndarray]:
        return {
            "phase_index": np.asarray(self.phase_index, np.int32),
            "interval": np.asarray(self.interval, np.int32),
            "since": np.asarray(self.since, np.int32),
            "last_loss": np.asarray(self.last_loss, np.float32),
            "last_key": np.asarray(self.last_key, np.int32),
            "count": np.asarray(self.count, np.int32),
        }

    def load_tree(self, tree: Dict[str, np.ndarray]) -> None:
        self.phase_index = int(tree["phase_index"])
        self.interval = max(int(tree["interval"]), 1)
        self.since = int(tree["since"])
        self.last_loss = float(tree["last_loss"])
        self.last_key = int(tree.get("last_key", -1))
        self.count = int(tree["count"])
