"""The port's microbatch loop, calibration step and eval step against the
JAX reference on the CPU (qwen2.5-3b smoke config), with the helpers and
the tolerances (``STEP``, ``ADAM_FLIP``, ``CALIB``, ``CALIB_ADC``) of
tests/test_torch_train_step.py, where each is stated and justified.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_step as steps_test
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.training import steps as jsteps
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import train_state_to_numpy
from repro_torch.models import build_model as t_build
from repro_torch.training import steps as tsteps

STEP, CALIB, CALIB_ADC = steps_test.STEP, steps_test.CALIB, steps_test.CALIB_ADC
jkey, _cfgs, _tcfgs, _states, _data, _hold_params = (
    steps_test.jkey, steps_test._cfgs, steps_test._tcfgs, steps_test._states, steps_test._data,
    steps_test._hold_params)


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


def test_microbatches_match_the_full_batch(models):
    """Two microbatches against the full batch, in the port, on a forward
    that reads no key (PROXY_ONLY): the gradients' float32 sum of the
    halves and the whole batch's differ only in rounding, so the losses
    within STEP and the weights within STEP but for ADAM_FLIP."""
    jm, tm = models
    ja, ta = _cfgs("analog", TMode.PROXY_ONLY)
    _, tt = _tcfgs(microbatches=2)
    _, ts = _states(jm, ja)
    _, ts_full = _states(jm, ja)
    batch = _data().batch_at(0)
    ts, tmet = tsteps.make_train_step(tm, ta, tt)(ts, batch, (1, 0))
    ts_full, fmet = tsteps.make_train_step(tm, ta, dataclasses.replace(tt, microbatches=1))(
        ts_full, batch, (1, 0))
    np.testing.assert_allclose(tmet["loss"].numpy(), fmet["loss"].numpy(), **STEP)
    _hold_params(ts, {"params": train_state_to_numpy(ts_full)["params"]}, tt.learning_rate, 1)


def test_microbatches_match_reference(models):
    """Two microbatches of an INJECT step against the reference's scan: each
    microbatch draws its error from its own key, ``rng + (i,)`` (the
    reference's ``fold_in(rng, i)``), from the same stats (the port's
    calibration, carried into the reference's state): the loss within
    STEP, the weights within STEP but for ADAM_FLIP."""
    jm, tm = models
    ja, ta = _cfgs("analog", TMode.INJECT)
    jt, tt = _tcfgs(microbatches=2)
    js, ts = _states(jm, ja)
    data = _data()
    ts, _ = tsteps.make_calibration_step(tm, ta, tt)(ts, data.batch_at(1), (1, 1))
    js = dict(js, calib=jax.tree.map(jnp.asarray, train_state_to_numpy(ts)["calib"]))
    with jax.disable_jit():
        js, jmet = jsteps.make_train_step(jm, ja, jt)(js, data.batch_at(0), jkey((1, 0)))
    ts, tmet = tsteps.make_train_step(tm, ta, tt)(ts, data.batch_at(0), (1, 0))
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]), **STEP)
    _hold_params(ts, js, tt.learning_rate, 1)


def _hold_calib(got, want, adc: bool):
    for site_path, w in jax.tree_util.tree_leaves_with_path(want, is_leaf=_is_site):
        g = _site_at(got, site_path)
        name = jax.tree_util.keystr(site_path)
        if not adc:
            for k in w:
                wk = np.asarray(w[k])
                np.testing.assert_allclose(np.asarray(g[k]), wk, rtol=CALIB["rtol"],
                                           atol=CALIB["atol"] * max(1.0, np.abs(wk).max()),
                                           err_msg=f"{name}[{k}]")
            continue
        std = np.sqrt(np.abs(np.asarray(w["var"])))
        assert np.all(np.abs(g["mean"] - w["mean"]) <= CALIB_ADC * std), name
        np.testing.assert_allclose(g["var"], w["var"], rtol=CALIB_ADC, err_msg=name)
        np.testing.assert_allclose(g["scale"], w["scale"], rtol=1e-5, err_msg=name)


def _is_site(t):
    return isinstance(t, dict) and set(t) == {"mean", "var", "scale"}


def _site_at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("be", ["approx_mult", "log_mult", "analog"])
def test_calibration_step_matches_reference(models, be):
    """The calibration step's loss within STEP and its collected stats, for
    every site of every layer and the head, laid out as the reference's
    tree: within CALIB; analog within CALIB_ADC, where the ADC levels a
    pass flips move the residuals' sums.  Each projection, SC's too (its
    stats against the reference's), is held on its own in
    tests/test_torch_train_core.py::test_calibrate_matmul_matches_reference."""
    jm, tm = models
    ja, ta = _cfgs(be, TMode.INJECT)
    jt, tt = _tcfgs()
    js, ts = _states(jm, ja)
    batch = _data().batch_at(3)
    with jax.disable_jit():
        js, jmet = jsteps.make_calibration_step(jm, ja, jt)(js, batch, jkey((1, 3)))
    ts, tmet = tsteps.make_calibration_step(tm, ta, tt)(ts, batch, (1, 3))
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]), **STEP)
    got = train_state_to_numpy(ts)["calib"]
    want = jax.tree.map(np.asarray, js["calib"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    _hold_calib(got, want, adc=be == "analog")


@pytest.mark.parametrize("be", ["exact", "approx_mult", "log_mult"])
def test_eval_step_matches_reference(models, be):
    """Hardware eval (MODEL mode for an approximate config, whatever its
    train mode): loss within STEP, accuracy equal.  (SC's and analog's
    emulated forwards are held in tests/test_torch_train_pipeline.py: SC's
    MODEL steps by their losses, analog's eval per projection.)"""
    jm, tm = models
    ja, ta = _cfgs(be, TMode.INJECT)
    js, ts = _states(jm, ja, seed=2)
    batch = _data().batch_at(9)
    with jax.disable_jit():
        want = jsteps.make_eval_step(jm, ja)(js, batch, jkey((2,)))
    got = tsteps.make_eval_step(tm, ta)(ts, batch, (2,))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), **STEP)
    np.testing.assert_array_equal(got["accuracy"].numpy(), np.asarray(want["accuracy"]))
