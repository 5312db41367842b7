"""The port's Trainer after a fault (``repro_torch.runtime.trainer``), on
the CPU at the qwen2.5-3b smoke config, with the helpers of
tests/test_torch_trainer.py: the restore from a mid-phase checkpoint and
the replay, and a fault before the first checkpoint; the reference's
Trainer (``REPRO_KERNELS=ref``) given the same fault, jitted, since only
its decisions are compared (its losses are, eagerly, in
tests/test_torch_trainer.py).

Tolerance: none.  Between two runs of the port, the state a restore
writes is the checkpoint's bits, and the replayed steps are the same
functions of the same state, batch and key path: the run that restores
ends bitwise where an uninterrupted run ends, and its replayed steps
repeat the first pass's losses bit for bit.  Against the reference, what
is decided: restarts, the steps that calibrate, steps by mode.
"""
import os

import jax
import pytest

from test_torch_trainer import _env, _fault_at, _port_trainer, _reference_run  # noqa: F401
from repro_torch.convert import train_state_to_numpy


def test_fault_after_a_mid_phase_save_replays_bitwise(tmp_path):
    """A fault at step 3, inside the first INJECT phase and after the save
    at step 2: the port restores that generation in place (the state's
    tensors and the controller), replays steps 2 and 3 with their first
    losses and calibration decisions, and ends bitwise where an
    uninterrupted run ends.  The reference, given the same fault,
    restarts once and calibrates at the same steps."""
    clean = _port_trainer(tmp_path / "clean")
    want = clean.run()
    tr = _port_trainer(tmp_path / "fault", fault_hook=_fault_at(3))
    params = list(tr._state["params"].parameters())
    got = tr.run()
    assert got.restarts == 1
    assert got.steps == [0, 1, 2, 2, 3, 4, 5, 6]
    assert got.losses[2] == got.losses[3] == want.losses[2]
    assert got.losses[4:] == want.losses[3:]
    assert got.calibrated == [False, True, False, False, True, False, False, False]
    assert [s for s, _ in got.calib_losses] == [1, 3]
    assert list(tr._state["params"].parameters())[0] is params[0]
    named, master = dict(tr._state["params"].named_parameters()), tr._state["opt"]["master"]
    assert all(named[n].data_ptr() == master[n].data_ptr() for n in named)
    a, b = train_state_to_numpy(tr._state), train_state_to_numpy(clean._state)
    for (kp, x), y in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), jax.tree_util.keystr(kp)
    assert tr.ckpt.latest_step() == 7
    assert sorted(d for d in os.listdir(tmp_path / "fault") if d.startswith("step_")) == \
        ["step_6", "step_7"]
    ref = _reference_run(tmp_path / "ref", fault_hook=_fault_at(3), eager=False)
    assert ref.restarts == got.restarts == 1
    assert ref.calibrations == got.calibrations == 2
    assert [s for s, _ in ref.calib_losses] == [s for s, _ in got.calib_losses]
    assert ref.mode_steps == got.mode_steps
    # a second run on the same directory resumes at the end: no steps
    assert _port_trainer(tmp_path / "fault").run().losses == []


def test_fault_before_the_first_checkpoint(tmp_path):
    """With no generation on disk yet, a Trainer that drew its own state
    replays from a fresh draw (as the reference replays from a fresh
    init); one given a state it trained in place cannot, and says so."""
    plan = ("exact:2", "inject:1")
    clean = _port_trainer(tmp_path / "clean", plan=plan, every=5, state=None).run()
    tr = _port_trainer(tmp_path / "own", plan=plan, every=5, state=None, fault_hook=_fault_at(1))
    got = tr.run()
    assert got.restarts == 1 and got.steps == [0, 0, 1, 2]
    assert got.losses[1:] == clean.losses
    tr = _port_trainer(tmp_path / "given", plan=plan, every=5, fault_hook=_fault_at(1))
    with pytest.raises(RuntimeError, match="no checkpoint"):
        tr.run()


def test_restore_of_a_generation_without_controller_state(tmp_path):
    """A generation that holds the train state alone (as the reference's
    manager writes one of a bare state) restores, and the controller
    starts afresh: the run is the uninterrupted run."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.convert import train_state_layout

    plan = ("exact:1", "inject:2:calib=1")
    clean = _port_trainer(tmp_path / "clean", plan=plan, every=5).run()
    tr = _port_trainer(tmp_path / "bare", plan=plan, every=5)
    CheckpointManager(str(tmp_path / "bare")).save(0, train_state_layout(tr._state),
                                                     blocking=True)
    got = tr.run()
    assert got.losses == clean.losses and got.calibrated == clean.calibrated == [False, True, True]
