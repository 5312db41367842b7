"""The port's MODEL-mode train steps over several steps, and the
quickstart's pipeline (calibrate, INJECT, MODEL, hardware eval), against
the eagerly-run JAX reference on the CPU (qwen2.5-3b smoke config); and
the quickstart's command line.

Both packages start from the reference's train state, carried across
(``repro_torch.convert.train_state_from_jax``).  Tolerances:

* ``LOSS`` (rtol 1e-3): a loss after MODEL steps on SC, or after the
  INJECT steps of the pipeline.  ROADMAP section C's reference-side
  facts apply to an emulated forward: an SC stream bit or an analog ADC
  level at a decision boundary flips when an upstream op differs in its
  last bit (XLA's and torch's matmuls sum in other orders), and the flip
  moves every later layer.  SC's flips are rare enough for LOSS over two
  steps.  Analog's 4-bit ADC over arrays of 16 is not: one MODEL step
  from one state moved the loss by 1.6% here (and the next step, from
  the next common state, by 1e-7).  So analog's emulated passes (MODEL,
  calibration, eval) are held per projection: every projection the port
  emulated in the step, against the reference's emulator on the same
  operands, under the ADC contract of tests/test_torch_sc_analog.py
  (bitwise, or whole ADC steps only within 2^-18 adc_range of a
  decision); a MODEL step's backward is the proxy's VJP, held per
  projection in tests/test_torch_train_core.py.
* ``STEP`` (rtol 1e-4, atol 1e-5) with ``ADAM_FLIP`` for the weights, as
  in tests/test_torch_train_step.py: the MODEL steps of approx_mult, whose
  forward is bitwise the reference's on the same operands, and of
  log_mult, within the reference's inexact exp2 (2^-20 relative).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sc_analog as sca
import test_torch_train_step as steps_test
from repro.configs import get_smoke_config as j_smoke
from repro.core import backends as jbe
from repro.models import build_model as j_build
from repro.training import steps as jsteps
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.core import backends as tbe
from repro_torch.core import registry
from repro_torch.core.registry import concat_planes
from repro_torch.models import build_model as t_build
from repro_torch.training import steps as tsteps

LOSS = 1e-3
jkey, _cfgs, _tcfgs, _states, _data = (steps_test.jkey, steps_test._cfgs, steps_test._tcfgs,
                                       steps_test._states, steps_test._data)


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


@pytest.mark.parametrize("be,n", [("sc", 2), ("approx_mult", 2), ("log_mult", 1)])
def test_model_steps_match_reference(models, be, n):
    """``n`` MODEL train steps from one state: every loss within LOSS (SC)
    or STEP (the multiplier-error backends, and then the weights as
    well)."""
    jm, tm = models
    ja, ta = _cfgs(be, TMode.MODEL)
    jt, tt = _tcfgs()
    js, ts = _states(jm, ja, seed=1)
    data = _data()
    jstep = jsteps.make_train_step(jm, ja, jt)
    tstep = tsteps.make_train_step(tm, ta, tt)
    for s in range(n):
        with jax.disable_jit():
            js, jmet = jstep(js, data.batch_at(s), jkey((1, s)))
        ts, tmet = tstep(ts, data.batch_at(s), (1, s))
        assert np.isfinite(float(tmet["loss"]))
        tol = dict(rtol=LOSS) if be == "sc" else steps_test.STEP
        np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]), **tol)
    if be != "sc":
        steps_test._hold_params(ts, js, tt.learning_rate, n)


class AnalogProjections:
    """Records every analog projection the port emulates (through the
    registry's override) and holds each against the reference's
    emulator on the same operands under the ADC contract."""

    def __init__(self, params):
        self.params, self.seen = params, []

    def __enter__(self):
        self.spec = spec = registry.get("analog")

        def emulate(x, w, p, rng):
            y = spec.emulate(x, w, p, rng)
            self.seen.append((x.detach().clone(), w.detach().clone(), y.detach().clone()))
            return y

        registry.register(dataclasses.replace(spec, emulate=emulate), override=True)
        return self

    def __exit__(self, *exc):
        registry.register(self.spec, override=True)

    def hold(self, jparams) -> int:
        """Every recorded projection under the ADC contract; returns how
        many there were, and forgets them."""
        a = self.params
        for x, w, y in self.seen:
            with jax.disable_jit():
                want = np.asarray(jbe._emulate_analog(jnp.asarray(x.numpy()),
                                                      jnp.asarray(w.numpy()), jparams, None))
            got = y.numpy()
            xp, xn, wp, wn, pre = tbe._array_planes(x, w, a)
            xcat = concat_planes(xp, xn).numpy()
            pos = np.concatenate([wp.numpy(), wn.numpy()])
            neg = np.concatenate([wn.numpy(), wp.numpy()])
            near = sca._near_boundary(xcat, [pos, neg], a.array_size, a.adc_bits, a.adc_range)
            sca.assert_adc_contract(got.reshape(near.shape), want.reshape(near.shape), near,
                                    -(-xcat.shape[1] // a.array_size), prescale=float(pre),
                                    adc_bits=a.adc_bits, adc_range=a.adc_range)
        n = len(self.seen)
        del self.seen[:]
        return n


def test_analog_model_steps_hold_per_projection(models):
    """Three analog MODEL steps (arrays of 16, a 4-bit ADC) from one state:
    the first loss, before any weight moves, within LOSS; every emulated
    projection of every step under the ADC contract; every loss and
    gradient norm finite."""
    jm, tm = models
    ja, ta = _cfgs("analog", TMode.MODEL)
    jt, tt = _tcfgs()
    js, ts = _states(jm, ja, seed=1)
    data = _data()
    jstep = jsteps.make_train_step(jm, ja, jt)
    tstep = tsteps.make_train_step(tm, ta, tt)
    rec = AnalogProjections(ta.analog)
    per_layer = 7 * tm.cfg.n_layers + 1
    for s in range(3):
        with jax.disable_jit():
            js, jmet = jstep(js, data.batch_at(s), jkey((1, s)))
        with rec:
            ts, tmet = tstep(ts, data.batch_at(s), (1, s))
        assert rec.hold(ja.analog) == per_layer
        assert np.isfinite(float(tmet["loss"])) and np.isfinite(float(tmet["grad_norm"]))
        if s == 0:
            np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]), rtol=LOSS)


def test_quickstart_pipeline_tracks_reference(models):
    """The quickstart's pipeline, cut to a calibration step, 3 INJECT steps,
    a calibration step, 2 MODEL steps and the hardware eval, on analog
    (arrays of 16, a 4-bit ADC), from one state: the first calibration
    and the INJECT steps within LOSS of the eager reference's losses; the
    passes that emulate (calibration, MODEL, eval) per projection under
    the ADC contract; every loss finite."""
    jm, tm = models
    ja, ta = _cfgs("analog", TMode.INJECT, calibrate_every=3)
    jt, tt = _tcfgs(total_steps=5)
    js, ts = _states(jm, ja)
    data = _data()
    plan = [("cal", 0), ("inject", 0), ("inject", 1), ("inject", 2), ("cal", 3),
            ("model", 3), ("model", 4)]
    jfns = {"cal": jsteps.make_calibration_step(jm, ja, jt),
            "inject": jsteps.make_train_step(jm, ja, jt, steps_test.JMode.INJECT),
            "model": jsteps.make_train_step(jm, ja, jt, steps_test.JMode.MODEL)}
    tfns = {"cal": tsteps.make_calibration_step(tm, ta, tt),
            "inject": tsteps.make_train_step(tm, ta, tt, TMode.INJECT),
            "model": tsteps.make_train_step(tm, ta, tt, TMode.MODEL)}
    rec = AnalogProjections(ta.analog)
    losses = []
    for i, (kind, s) in enumerate(plan):
        with jax.disable_jit():
            js, jmet = jfns[kind](js, data.batch_at(s), jkey((1, s)))
        with rec:
            ts, tmet = tfns[kind](ts, data.batch_at(s), (1, s))
        n = rec.hold(ja.analog)
        assert n == (0 if kind == "inject" else 15), (kind, n)
        losses.append((kind, float(tmet["loss"]), float(jmet["loss"])))
        assert np.isfinite(losses[-1][1])
        if i < 4:
            np.testing.assert_allclose(losses[-1][1], losses[-1][2], rtol=LOSS,
                                       err_msg=f"{kind}: {losses}")
    with jax.disable_jit():
        want = jsteps.make_eval_step(jm, ja)(js, data.batch_at(999), jkey((2,)))
    with rec:
        got = tsteps.make_eval_step(tm, ta)(ts, data.batch_at(999), (2,))
    assert rec.hold(ja.analog) == 15
    assert np.isfinite(float(got["loss"])) and np.isfinite(float(want["loss"]))
    assert ts["step"] == 5


def _run_quickstart(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.quickstart", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_quickstart_cli_on_cpu_and_asks_for_the_card():
    """``--device cpu`` runs the pipeline and prints its losses and the
    hardware-eval comparison; without ``--device`` it asks for the card
    and, where there is none, raises rather than falling back."""
    out = _run_quickstart("--smoke", "--device", "cpu", "--steps", "11", "--finetune-steps",
                          "2", "--batch", "2", "--seq-len", "8")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(l.startswith("[inject]") for l in lines) == 2
    assert sum(l.startswith("[finetune]") for l in lines) == 2
    assert any("paper pipeline" in l and "float-then-deploy" in l for l in lines)
    if not torch.cuda.is_available():
        out = _run_quickstart("--smoke", "--steps", "1", "--finetune-steps", "0")
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
