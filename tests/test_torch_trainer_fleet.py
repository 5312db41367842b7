"""Variation-aware training in the port's Trainer (``Phase.fleet``)
against the JAX reference's, on the CPU at the qwen2.5-3b smoke config,
and ``python -m repro_torch.launch.train --fleet``.

Both Trainers start from one state (the reference's own, carried across)
and train a plan whose INJECT and MODEL phases round-robin over a fleet
of two chips (the same chips: the port's profiles are the reference's bit
for bit, sampled from ``seed + 7919``).  The reference runs jitted with
``REPRO_KERNELS=ref``.  Contracts:

* none for what is decided: the chip of every step (by its key),
  ``fleet_steps``, the steps that calibrate, ``mode_steps``, the steps
  built;
* ``LOSS`` (rtol 1e-3, as tests/test_torch_trainer.py) on each step's
  loss and each calibration loss: approx_mult's emulated forward is
  bitwise the reference's on the same operands, and the chip's terms
  are; the matmuls sum in another order than XLA, which also contracts
  the chip epilogue's multiply-adds, and INJECT's noise is
  ``jax.random.normal``'s.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_cli as cli_test
import test_torch_trainer as trainer_test
from repro.configs import base as jb
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.configs import base as tb
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import train_state_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.runtime.trainer import Trainer

LOSS, SEED = trainer_test.LOSS, trainer_test.SEED
PLAN = ("exact:1", "inject:3:calib=2,fleet=2", "model:2:fleet=2", "proxy:1:fleet=2")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _record_chips(trainer, key_of):
    """Wrap the trainer's ``_chip_for``: each step's chip key, or None."""
    seen = []
    chip_for = trainer._chip_for

    def recording(phase, step):
        chip = chip_for(phase, step)
        seen.append((step, None if chip is None else key_of(chip["key"])))
        return chip

    trainer._chip_for = recording
    return seen


def test_trainer_fleet_tracks_the_reference(tmp_path):
    """Steps 1-3 (INJECT, calibrating at 1 and 3) and 4-5 (MODEL) train
    against chips 1, 0, 1, 0, 1; the PROXY_ONLY phase reads no chip (no
    calibration), so it trains nominally, as in the reference."""
    approx, tcfg = trainer_test._configs(jb, PLAN)
    jt = JTrainer(j_build(j_smoke("qwen2.5-3b")), approx, tcfg, trainer_test._data(),
                  str(tmp_path / "ref"), seed=SEED)
    jt._state_like = lambda: jax.tree.map(jnp.asarray, trainer_test._initial_state())
    jseen = _record_chips(jt, lambda k: tuple(int(v) for v in np.asarray(k)))
    want = jt.run()

    approx, tcfg = trainer_test._configs(tb, PLAN)
    tt = Trainer(t_build(t_smoke("qwen2.5-3b")), approx, tcfg, trainer_test._data(),
                 str(tmp_path / "port"), seed=SEED, device="cpu",
                 state=train_state_from_jax(trainer_test._initial_state(), device="cpu"))
    tseen = _record_chips(tt, tuple)
    got = tt.run()

    assert tseen == jseen
    fleet = tt._fleets[2]
    assert [k for _, k in tseen] == [None] + [fleet.chip(s % 2)["key"] for s in range(1, 6)] \
        + [None]
    assert got.fleet_steps == want.fleet_steps == 5
    assert [s for s, _ in got.calib_losses] == [s for s, _ in want.calib_losses] == [1, 3]
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS)
    np.testing.assert_allclose([l for _, l in got.calib_losses],
                               [l for _, l in want.calib_losses], rtol=LOSS)
    assert got.mode_steps == want.mode_steps
    assert got.compile_stats["built"] == want.compile_stats["built"]
    assert tt.fleet_seed == SEED + 7919


def test_train_cli_fleet_on_cpu(tmp_path):
    """``--fleet 2`` over an INJECT and a MODEL phase, and over the legacy
    split (which rides on phases when a fleet is asked for)."""
    report = tmp_path / "report.json"
    out = cli_test._train_cli(
        "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--backend", "analog",
        "--phase", "exact:1", "--phase", "inject:2:calib=1", "--phase", "model:1",
        "--fleet", "2", "--variation-scale", "2", "--fleet-seed", "5", "--batch", "2",
        "--seq-len", "8", "--ckpt-dir", str(tmp_path / "ck"), "--report", str(report))
    assert out.returncode == 0, out.stderr
    summary = json.loads(report.read_text())
    assert set(summary) == cli_test.SUMMARY_KEYS
    assert summary["fleet_steps"] == 3 and summary["calibrations"] == 2
    legacy = cli_test._train_cli(
        "--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--backend", "approx_mult",
        "--inject-steps", "2", "--finetune-steps", "1", "--fleet", "2", "--batch", "2",
        "--seq-len", "8", "--ckpt-dir", str(tmp_path / "ck2"))
    assert legacy.returncode == 0, legacy.stderr
    assert '"fleet_steps": 3' in legacy.stdout
