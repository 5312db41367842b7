"""Activation checkpointing in the port's train step (``TrainConfig.remat``,
``repro_torch.core.checkpoint_policy``), on the CPU at the qwen2.5-3b
smoke config: INJECT on analog, MODEL on approx_mult and analog.

Tolerances:

* none between the port's policies: ``none``, ``full``, ``block`` and
  ``group:2`` give bitwise equal losses and gradients, since a
  recomputed layer is the first pass's function of the same inputs and
  key path (the emulators, INJECT's noise) and the saved matmul outputs
  are its bits.
* ``STEP`` of tests/test_torch_train_step.py (rtol 1e-4, atol 1e-5) for
  the port's gradients under ``block`` against the eager reference's
  under ``block``, as its train-step tests hold a step: the forward and
  backward sum their matmuls in another order than XLA.  Held on INJECT
  and approx_mult MODEL.  Analog's MODEL forward is chaotic end to end
  at this ADC (ROADMAP section C: one ADC level that flips at a decision
  boundary, where XLA's sums and torch's differ in their last bit, moves
  every later layer), so under ``block`` every projection it emulates,
  the recomputed ones too, is held against the reference's emulator on
  the same operands under the ADC contract, as the pipeline tests hold
  analog (tests/test_torch_train_pipeline.py), and its gradients equal
  ``none``'s bitwise (above).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_train_pipeline as pipeline_test
import test_torch_train_step as steps_test
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import build_model as j_build
from repro.training import steps as jsteps
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import named_to_jax, train_state_from_jax, train_state_to_numpy
from repro_torch.core import registry
from repro_torch.models import build_model as t_build
from repro_torch.training import steps as tsteps

CASES = [("analog", TMode.INJECT), ("approx_mult", TMode.MODEL), ("analog", TMode.MODEL)]
POLICIES = ("none", "full", "block", "group:2")
_STARTS = {}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    return j_build(j_smoke("qwen2.5-3b")), t_build(t_smoke("qwen2.5-3b"))


def _start(models, be, mode):
    """One state in both packages; for INJECT, after the port's calibration
    step (its stats carried back to the reference), so the injected error
    is not zero."""
    if (be, mode) not in _STARTS:
        _STARTS[be, mode] = _make_start(models, be, mode)
    return _STARTS[be, mode]


def _make_start(models, be, mode):
    jm, tm = models
    ja, ta = steps_test._cfgs(be, mode)
    js = jax.tree.map(np.asarray, jsteps.init_train_state(jm, jax.random.PRNGKey(2), ja))
    data = steps_test._data()
    if mode == TMode.INJECT:
        ts = train_state_from_jax(js, device="cpu")
        ts, _ = tsteps.make_calibration_step(tm, ta, TrainConfig())(ts, data.batch_at(0), (1, 0))
        js = dict(js, calib=train_state_to_numpy(ts)["calib"])
    return ja, ta, js, data.batch_at(1)


def _port_grads(models, ta, js, batch, remat):
    _, tm = models
    ts = train_state_from_jax(js, device="cpu")
    named = dict(ts["params"].named_parameters())
    loss = tsteps._loss(ts["params"], tsteps._batch(batch, "cpu"), tm, ta, ts["calib"], (1, 1),
                        TrainConfig(remat=remat))
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


@pytest.mark.parametrize("be,mode", CASES, ids=lambda v: getattr(v, "value", v))
def test_remat_policies_give_bitwise_equal_gradients(models, be, mode):
    """Every policy's loss and gradients equal ``none``'s, bit for bit; under
    ``block`` the emulated steps recompute each layer's projections (a
    MODEL step emulates 7 per layer twice, the head once)."""
    _, ta, js, batch = _start(models, be, mode)
    spec, calls = registry.get(be), [0]

    def emulate(*a):
        calls[0] += 1
        return spec.emulate(*a)

    registry.register(dataclasses.replace(spec, emulate=emulate), override=True)
    try:
        got = {}
        for remat in POLICIES:
            calls[0] = 0
            got[remat] = _port_grads(models, ta, js, batch, remat)
            n_layers = models[1].cfg.n_layers
            want = 0 if mode == TMode.INJECT else (
                7 * n_layers + 1 + (0 if remat == "none" else 7 * n_layers))
            assert calls[0] == want, (remat, calls[0])
    finally:
        registry.register(spec, override=True)
    loss0, g0 = got["none"]
    for remat in POLICIES[1:]:
        loss, g = got[remat]
        assert torch.equal(loss, loss0), remat
        for n in g0:
            assert torch.equal(g[n], g0[n]), (remat, n)


@pytest.mark.parametrize("be,mode", CASES, ids=lambda v: getattr(v, "value", v))
def test_block_gradients_track_the_reference_under_block(models, be, mode):
    jm, tm = models
    ja, ta, js, batch = _start(models, be, mode)
    if be == "analog" and mode == TMode.MODEL:
        rec = pipeline_test.AnalogProjections(ta.analog)
        with rec:
            loss, grads = _port_grads(models, ta, js, batch, "block")
        assert rec.hold(ja.analog) == 14 * tm.cfg.n_layers + 1
        assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                  for g in grads.values())
        return
    jt = JTrainConfig(remat="block")
    jbatch = jax.tree.map(np.asarray, batch)

    def loss_fn(p):
        return jsteps._loss_fn(p, jbatch, jm, ja, js["calib"], steps_test.jkey((1, 1)), jt)

    with jax.disable_jit():
        (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jax.numpy.asarray, js["params"]))
    loss, grads = _port_grads(models, ta, js, batch, "block")
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **steps_test.STEP)
    want = jax.tree.map(np.asarray, jgrads)
    got = named_to_jax(grads)
    for (kp, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, **steps_test.STEP, err_msg=jax.tree_util.keystr(kp))
