"""The port's phase-plan Trainer (``repro_torch.runtime.trainer``) against
the JAX reference's, on the CPU at the qwen2.5-3b smoke config; its
restart budget and refusals.  Its restart after a fault is in
tests/test_torch_trainer_fault.py, and ``python -m repro_torch.launch.
train`` in tests/test_torch_train_cli.py, with this file's helpers.

Both Trainers start from one state: the reference builds its own from
``PRNGKey(seed)``, and the port is given that state, carried across
(``repro_torch.convert.train_state_from_jax``).  The reference runs
eagerly (``jax.disable_jit()``, ``REPRO_KERNELS=ref``).  Tolerances:

* ``LOSS`` (rtol 1e-3, as tests/test_torch_train_pipeline.py): each
  step's loss and each calibration loss on approx_mult, whose emulated
  forward is bitwise the reference's on the same operands, over a plan
  of exact, INJECT and MODEL phases (the matmuls sum in another order
  than XLA, and INJECT's noise is ``jax.random.normal``'s to a few ulps).
* none for what is decided, not computed: the steps that calibrate,
  ``mode_steps``, ``phase_steps``, ``compile_stats["built"]``, restarts.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs import base as jb
from repro.models import build_model as j_build
from repro.runtime.trainer import Trainer as JTrainer
from repro.training import steps as jsteps
from repro_torch.configs import base as tb
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import train_state_from_jax
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model as t_build
from repro_torch.runtime.trainer import Trainer

LOSS = 1e-3
PLAN = ("exact:1", "inject:3:calib=2", "model:2", "inject:1")
SEED = 4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(m, plan=PLAN, every=2):
    approx = m.ApproxConfig(backend=m.Backend.APPROX_MULT, mode=m.TrainMode.INJECT,
                            calibrate_every=3)
    phases = m.parse_phase_specs(plan)
    tcfg = m.TrainConfig(total_steps=sum(p.steps for p in phases), warmup_steps=1,
                         learning_rate=2e-3, phases=phases, checkpoint_every=every,
                         keep_checkpoints=2)
    return approx, tcfg


def _data():
    return SyntheticLM(512, seq_len=8, global_batch=4, seed=1)


def _fault_at(step):
    fired = []

    def hook(s):
        if s == step and not fired:
            fired.append(s)
            raise RuntimeError("simulated preemption")

    return hook


def _reference_run(path, fault_hook=None, eager=True):
    """The reference Trainer's run of PLAN, eager (its values) or jitted
    (its decisions only, four times faster here)."""
    jm = j_build(j_smoke("qwen2.5-3b"))
    approx, tcfg = _configs(jb)
    tr = JTrainer(jm, approx, tcfg, _data(), str(path), seed=SEED, fault_hook=fault_hook)
    # its own init from PRNGKey(SEED), drawn once outside disable_jit
    tr._state_like = lambda: jax.tree.map(jnp.asarray, _initial_state())
    with jax.disable_jit() if eager else contextlib.nullcontext():
        return tr.run()


@functools.lru_cache(maxsize=1)
def _initial_state():
    """The reference Trainer's own initial state, as numpy."""
    jm = j_build(j_smoke("qwen2.5-3b"))
    approx, tcfg = _configs(jb)
    return jax.tree.map(np.asarray,
                        jsteps.init_train_state(jm, jax.random.PRNGKey(SEED), approx, tcfg))


def _port_trainer(path, fault_hook=None, plan=PLAN, every=2, state="reference"):
    approx, tcfg = _configs(tb, plan, every)
    if state == "reference":
        state = train_state_from_jax(_initial_state(), device="cpu")
    return Trainer(t_build(t_smoke("qwen2.5-3b")), approx, tcfg, _data(), str(path), seed=SEED,
                   fault_hook=fault_hook, device="cpu", state=state)


def test_trainer_tracks_the_reference(tmp_path):
    """One plan, one state, both Trainers: every loss within LOSS; the same
    steps calibrate (phase entry of each INJECT phase, then every 2); the
    same steps by mode and phase; the same number of steps built."""
    want = _reference_run(tmp_path / "ref")
    tr = _port_trainer(tmp_path / "port")
    got = tr.run()
    assert tr.plan.describe() == "exact:1 -> inject:3[every_n] -> model:2 -> inject:1"
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS)
    assert [s for s, _ in got.calib_losses] == [s for s, _ in want.calib_losses] == [1, 3]
    np.testing.assert_allclose([l for _, l in got.calib_losses],
                               [l for _, l in want.calib_losses], rtol=LOSS)
    assert got.mode_steps == want.mode_steps == {"no_model": 1, "inject": 4, "model": 2}
    assert got.phase_steps == want.phase_steps
    assert got.compile_stats["built"] == want.compile_stats["built"] == 4
    assert got.backward_steps == want.backward_steps == {"exact": 7}
    assert got.fleet_steps == want.fleet_steps == 0
    assert got.restarts == want.restarts == 0 and got.calibrations == want.calibrations == 2
    assert got.steps == list(range(7))
    assert got.calibrated == [s in (1, 3) for s in range(7)]


def test_restart_budget_and_refusals(tmp_path):
    """A fault that recurs is re-raised once the budget is spent; a fleet
    phase is taken (tests/test_torch_trainer_fleet.py runs one), and so is a
    gated-backward phase (tests/test_torch_approx_bwd.py runs them)."""

    def always(s):
        if s == 1:
            raise RuntimeError("persistent device loss")

    tr = _port_trainer(tmp_path / "budget", plan=("exact:3",), every=1, fault_hook=always)
    tr.restart_budget = 2
    with pytest.raises(RuntimeError, match="persistent"):
        tr.run()
    assert _port_trainer(tmp_path / "A3", plan=("exact:1", "inject:3:fleet=4"),
                         state=None).plan.phases[1].fleet == 4
    gated = _port_trainer(tmp_path / "A6", plan=("exact:1", "inject:3:bwd=approx"), state=None)
    assert gated.plan.phases[1].backward == "approx" and gated._bwd_any
