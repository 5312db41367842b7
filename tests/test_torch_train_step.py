"""The port's training steps against the JAX reference on the CPU
(qwen2.5-3b smoke config: float32, 2 layers, d 64): ``lr_at``,
``lm_loss``, one AdamW update, the train state carried across and back,
and the exact, INJECT and PROXY_ONLY train steps.  The microbatch loop,
the calibration step and the eval step are in
tests/test_torch_train_calib.py, with this file's helpers and
tolerances.

Both packages start from one state: the reference's
``init_train_state`` carried across with ``repro_torch.convert.
train_state_from_jax``.  The reference runs eagerly (``jax.disable_jit()``,
``REPRO_KERNELS=ref``).  Tolerances, each named where it is used:

* ``BITS`` (rtol 1e-6): a chain of float32 ops that are the reference's
  one for one, whose libm calls (cos, pow, exp, log) may round an ulp
  apart.
* ``ADAMW`` (rtol 2e-6): AdamW's slots and weights after a few updates,
  which carry the clip scale's and the bias corrections' last-ulp
  differences (the global norm's order of sums, ``pow``).
* ``STEP`` (rtol 1e-4, atol 1e-5): a train step's loss and updated
  weights.  The forward and backward sum their matmuls in another order
  than XLA.
* ``ADAM_FLIP``: AdamW moves a weight by about lr * m / sqrt(v), which is
  lr * sign(g) on the first step whatever |g|, so a gradient element at
  the level of the two packages' rounding (|g| ~ eps) may move its weight
  by up to lr in either direction.  At most this share (1e-3) of a
  tensor's elements (or one element) may miss STEP, and none by more
  than 2 lr a step.
* ``CALIB`` (rtol 1e-3, atol 1e-5 of the stats' scale): a calibration
  pass's fitted stats, which see the whole forward's rounding through the
  residual's sums, before the ridge fit.
* ``CALIB_ADC`` (1e-2): an analog calibration pass, whose output is the
  emulated value: an ADC level that flips at a decision boundary (ROADMAP
  section C) moves that output by a whole step, and every later layer
  with it.  A site's fitted mean error within 1e-2 of its fitted std, its
  variance within 1e-2 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import AnalogParams as JAnalogParams
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import TrainMode as JMode
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as j_build
from repro.optim import adamw as jadamw
from repro.training import losses as jlosses
from repro.training import steps as jsteps
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import AnalogParams, TrainConfig
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import train_state_from_jax, train_state_to_numpy
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model as t_build
from repro_torch.optim import adamw as tadamw
from repro_torch.training import losses as tlosses
from repro_torch.training import steps as tsteps

BITS = dict(rtol=1e-6, atol=0.0)
ADAMW = dict(rtol=2e-6, atol=1e-9)
STEP = dict(rtol=1e-4, atol=1e-5)
CALIB = dict(rtol=1e-3, atol=1e-5)
ADAM_FLIP = 1e-3
CALIB_ADC = 1e-2
SEQ, BATCH = 8, 4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jkey(path):
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    return key


@pytest.fixture(scope="module")
def models():
    return j_build(j_smoke("qwen2.5-3b")), t_build(t_smoke("qwen2.5-3b"))


def _cfgs(be, mode, **kw):
    if be == "exact":
        return JApprox(), TApprox()
    analog = dict(array_size=16, adc_bits=4)
    return (JApprox(backend=JBackend(be), mode=JMode(mode.value),
                    analog=JAnalogParams(**analog), **kw),
            TApprox(backend=TBackend(be), mode=mode, analog=AnalogParams(**analog), **kw))


def _tcfgs(**kw):
    kw = dict(dict(total_steps=10, warmup_steps=2, learning_rate=2e-3), **kw)
    return JTrainConfig(remat="none", **kw), TrainConfig(remat="none", **kw)


def _states(jm, ja, seed=0):
    """One initial state in both packages (the reference's, carried across)."""
    js = jsteps.init_train_state(jm, jax.random.PRNGKey(seed), ja)
    return js, train_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")


def _hold_params(ts, js, lr, steps):
    """The updated weights: within STEP but for ADAM_FLIP."""
    got = train_state_to_numpy(ts)["params"]
    want = jax.tree.map(np.asarray, js["params"])
    for (kp, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        d = np.abs(g - w)
        miss = d > STEP["atol"] + STEP["rtol"] * np.abs(w)
        name = jax.tree_util.keystr(kp)
        assert miss.sum() <= max(1, ADAM_FLIP * miss.size), (name, int(miss.sum()),
                                                             float(d.max()))
        assert d.max() <= 2 * lr * steps, (name, float(d.max()))


def _data():
    return SyntheticLM(512, seq_len=SEQ, global_batch=BATCH, seed=0)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def test_synthetic_lm_is_the_reference_stream():
    j = JSyntheticLM(512, seq_len=SEQ, global_batch=BATCH, seed=3)
    t = SyntheticLM(512, seq_len=SEQ, global_batch=BATCH, seed=3)
    for s in (0, 7):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(t.batch_at(s)[k], j.batch_at(s)[k])


def test_lr_at_matches_reference():
    """The warmup and cosine schedule, step by step: BITS."""
    jt, tt = _tcfgs(total_steps=50, warmup_steps=5, min_lr_ratio=0.1)
    for s in range(0, 60, 3):
        want = np.asarray(jadamw.lr_at(jnp.int32(s), jt))
        got = tadamw.lr_at(torch.tensor(s, dtype=torch.int32), tt).numpy()
        np.testing.assert_allclose(got, want, **BITS)


def test_lm_loss_and_accuracy_match_reference():
    """Cross entropy (log-sum-exp shifted by the row max) and accuracy:
    BITS for the loss, equal accuracy."""
    rnd = np.random.default_rng(0)
    logits = (rnd.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rnd.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rnd.random((3, 7)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = np.asarray(jlosses.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                          None if m is None else jnp.asarray(m)))
        got = tlosses.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, **BITS)
    np.testing.assert_array_equal(
        tlosses.accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(models, dtype):
    """One AdamW update on the smoke model's weights with random gradients
    (clipped: their global norm is above grad_clip), after a few updates
    so the moments are non-trivial: m, v, master and the weights within
    ADAMW, the learning rate within BITS, the global norm within 1e-5 (its
    sum runs over the tensors in another order); bf16 weights are their master rounded
    to nearest, which sits beside them as the reference's float32 copy."""
    jm, tm = models
    jt, tt = _tcfgs(weight_decay=0.1)
    jp = jm.init(jax.random.PRNGKey(1))
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    jopt = jadamw.adamw_init(jp)
    ts = train_state_from_jax(jax.tree.map(np.asarray, {
        "params": jp, "opt": jopt, "calib": {}, "step": 0}), device="cpu")
    named = dict(ts["params"].named_parameters())
    assert all((ts["opt"]["master"][n].data_ptr() == p.data_ptr()) == (dtype == "float32")
               for n, p in named.items())
    rnd = np.random.default_rng(2)
    for it in range(3):
        jg = jax.tree.map(lambda a: jnp.asarray(rnd.standard_normal(a.shape) * 0.1,
                                                a.dtype), jp)
        with jax.disable_jit():
            jp, jopt, jmet = jadamw.adamw_update(jg, jopt, jp, jt)
        tg = train_state_from_jax(jax.tree.map(np.asarray, {
            "params": jg, "opt": jadamw.adamw_init(jg), "calib": {}, "step": 0}), device="cpu")
        grads = {n: p.detach() for n, p in tg["params"].named_parameters()}
        tmet = tadamw.adamw_update(grads, ts["opt"], named, tt)
        np.testing.assert_allclose(tmet["grad_norm"].numpy(), np.asarray(jmet["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tmet["lr"].numpy(), np.asarray(jmet["lr"]), **BITS)
    assert float(jmet["grad_norm"]) > jt.grad_clip
    got = train_state_to_numpy(ts)
    want = jax.tree.map(np.asarray, {"params": jp, "opt": jopt})
    if dtype == "bfloat16":  # each weight is its master rounded (once, to nearest)
        for n, p in named.items():
            assert torch.equal(p.detach(), ts["opt"]["master"][n].to(torch.bfloat16)), n
        del got["params"], want["params"]
    for part in set(got) & {"params", "opt"}:
        flat_w = jax.tree_util.tree_leaves_with_path(want[part])
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got[part]))
        for kp, w in flat_w:
            g = np.asarray(flat_g[kp], np.float32)
            np.testing.assert_allclose(g, np.asarray(w, np.float32), **ADAMW,
                                       err_msg=f"{part}{jax.tree_util.keystr(kp)}")


def test_train_state_round_trip(models):
    """A reference train state, carried across and back, is itself: every
    leaf bitwise, its structure the reference's."""
    jm, _ = models
    ja, _ = _cfgs("sc", TMode.INJECT)
    js = jax.tree.map(np.asarray, jsteps.init_train_state(jm, jax.random.PRNGKey(4), ja))
    js["calib"] = jax.tree.map(lambda a: a + np.float32(0.25), js["calib"])
    js["opt"]["count"] = np.asarray(3, np.int32)
    back = train_state_to_numpy(train_state_from_jax(js, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("be,mode", [("exact", TMode.NO_MODEL), ("analog", TMode.INJECT),
                                     ("sc", TMode.INJECT), ("log_mult", TMode.INJECT),
                                     ("analog", TMode.PROXY_ONLY), ("sc", TMode.PROXY_ONLY)])
def test_train_steps_match_reference(models, be, mode):
    """Two train steps from one state: the losses and the metrics within
    STEP, the updated weights within STEP but for ADAM_FLIP.  INJECT
    starts after the port's calibration step, its stats carried into the
    reference's state, so both packages inject error from the same stats
    (a calibration pass is held apart, in tests/test_torch_train_calib.py:
    an analog one may flip ADC levels)."""
    jm, tm = models
    ja, ta = _cfgs(be, mode)
    jt, tt = _tcfgs()
    js, ts = _states(jm, ja)
    data = _data()
    jstep = jsteps.make_train_step(jm, ja, jt)
    tstep = tsteps.make_train_step(tm, ta, tt)
    with jax.disable_jit():
        if mode == TMode.INJECT:
            ts, _ = tsteps.make_calibration_step(tm, ta, tt)(ts, data.batch_at(0), (1, 0))
            js = dict(js, calib=jax.tree.map(jnp.asarray, train_state_to_numpy(ts)["calib"]))
            assert float(ts["calib"]["head"]["lm_head"]["var"].abs().max()) > 0
        for s in range(2):
            js, jmet = jstep(js, data.batch_at(s), jkey((1, s)))
            ts, tmet = tstep(ts, data.batch_at(s), (1, s))
            for k in ("loss", "total_loss", "grad_norm", "lr"):
                np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]), **STEP,
                                           err_msg=k)
    assert ts["step"] == int(js["step"]) == 2
    _hold_params(ts, js, tt.learning_rate, 2)
