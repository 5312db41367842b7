"""The port's train steps on a MoE model against the JAX reference on the
CPU (grok-1-314b smoke config: float32, 2 layers, d 64, 4 experts top 2),
and the refusals of what this family does not train yet.

Both packages start from one state (the reference's ``init_train_state``
carried across with ``repro_torch.convert.train_state_from_jax``); the
reference's steps run jitted, as it trains.  Tolerances are those of
tests/test_torch_train_step.py: ``STEP`` (rtol 1e-4, atol 1e-5) for the
losses and the updated weights, but for ``ADAM_FLIP``: AdamW's first
step moves a weight by about lr * sign(g) whatever |g|, so a gradient
element at the packages' rounding level may move its weight either way;
at most that share (1e-3) of a tensor's elements (or one) may miss STEP,
none by more than 2 lr a step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import TrainMode as JMode
from repro.models import build_model as j_build
from repro.training import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import train_state_from_jax, train_state_to_numpy
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model as t_build
from repro_torch.runtime.trainer import Trainer
from repro_torch.training import losses as tlosses
from repro_torch.training import steps as tsteps

STEP = dict(rtol=1e-4, atol=1e-5)
ADAM_FLIP = 1e-3
ARCH = "grok-1-314b"
TRAIN = dict(total_steps=10, warmup_steps=2, learning_rate=2e-3)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    return j_build(j_smoke(ARCH)), t_build(get_smoke_config(ARCH))


def _data():
    return SyntheticLM(256, seq_len=8, global_batch=4, seed=0)


def _jkey(path):
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    return key


def _hold_params(ts, js, lr, steps):
    got = train_state_to_numpy(ts)["params"]
    want = jax.tree.map(np.asarray, js["params"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (kp, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        d = np.abs(g - w)
        miss = d > STEP["atol"] + STEP["rtol"] * np.abs(w)
        name = jax.tree_util.keystr(kp)
        assert miss.sum() <= max(1, ADAM_FLIP * miss.size), (name, int(miss.sum()),
                                                             float(d.max()))
        assert d.max() <= 2 * lr * steps, (name, float(d.max()))


@pytest.mark.parametrize("be,mode", [("approx_mult", "MODEL"), ("sc", "INJECT")])
def test_train_step_matches_reference(models, be, mode):
    """One train step with ``optim_compress="none"``: ``loss`` (the LM
    loss), ``aux_loss`` (the forward's load-balance loss) and
    ``total_loss`` (their sum, the aux loss at 0.01) within STEP of the
    reference's, the updated weights (router and expert stacks included)
    within STEP but for ADAM_FLIP.  INJECT after the port's calibration
    step, its stats (``moe_experts`` ``[L, E, ...]``) carried into the
    reference's state."""
    jm, tm = models
    ja = JApprox(backend=JBackend(be), mode=JMode[mode])
    ta = TApprox(backend=TBackend(be), mode=TMode[mode])
    js = jsteps.init_train_state(jm, jax.random.PRNGKey(0), ja)
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    tt = TrainConfig(remat="none", **TRAIN)
    data = _data()
    if mode == "INJECT":
        ts, _ = tsteps.make_calibration_step(tm, ta, tt)(ts, data.batch_at(0), (1, 0))
        assert ts["calib"]["layers"]["moe_experts"]["moe_up"]["var"].shape[:2] == (2, 4)
        js = dict(js, calib=jax.tree.map(jnp.asarray, train_state_to_numpy(ts)["calib"]))
    js, jmet = jsteps.make_train_step(jm, ja, JTrainConfig(remat="none", **TRAIN))(
        js, data.batch_at(1), _jkey((1, 1)))
    ts, tmet = tsteps.make_train_step(tm, ta, tt)(ts, data.batch_at(1), (1, 1))
    for k in ("loss", "aux_loss", "total_loss", "grad_norm"):
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]), **STEP, err_msg=k)
    assert float(tmet["aux_loss"]) > 0
    _hold_params(ts, js, tt.learning_rate, 1)


def test_train_step_reports_lm_and_aux_loss(models):
    """``metrics["loss"]`` is the LM loss of the step's forward and
    ``metrics["aux_loss"]`` its load-balance loss; ``total_loss`` is the
    loss differentiated, their sum with the aux loss at 0.01 (as the
    reference reports them), averaged over microbatches alike."""
    _, tm = models
    tt = TrainConfig(remat="none", **TRAIN)
    batch = _data().batch_at(2)
    for micro in (1, 2):
        state = tsteps.init_train_state(tm, 0, TApprox(), device="cpu")
        tokens = torch.from_numpy(np.asarray(batch["tokens"])).long()
        labels = torch.from_numpy(np.asarray(batch["labels"])).long()
        parts = []
        with torch.no_grad():
            for i in range(micro):
                rows = slice(i * 4 // micro, (i + 1) * 4 // micro)
                rng = (1, 2) if micro == 1 else (1, 2, i)  # a microbatch folds in i
                out = tm.apply(state["params"], {"tokens": tokens[rows]}, rng=rng, remat="none")
                parts.append((tlosses.lm_loss(out.logits, labels[rows]), out.aux_loss))
        step = tsteps.make_train_step(tm, TApprox(), TrainConfig(remat="none", microbatches=micro,
                                                                 **TRAIN))
        _, met = step(state, batch, (1, 2))
        loss = sum(p[0] for p in parts) / micro
        aux = sum(p[1] for p in parts) / micro
        np.testing.assert_allclose(met["loss"].numpy(), loss.numpy(), rtol=1e-6)
        np.testing.assert_allclose(met["aux_loss"].numpy(), aux.numpy(), rtol=1e-6)
        assert float(met["aux_loss"]) > 0.5
        np.testing.assert_allclose(met["total_loss"].numpy(), (loss + 0.01 * aux).numpy(),
                                   rtol=1e-6)


def test_compressed_state_and_trainer_refuse_moe(models, tmp_path):
    """``optim_compress`` ``bf16`` and ``sm3`` raise on a MoE model (SM3's
    factors and the rounding over ``[L, E, ...]`` stacks are not yet held
    against the reference, ROADMAP A5), at ``init_train_state`` and at
    ``make_train_step``; so does the Trainer."""
    _, tm = models
    for compress in ("bf16", "sm3"):
        tcfg = TrainConfig(optim_compress=compress, **TRAIN)
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            tsteps.init_train_state(tm, 0, TApprox(), tcfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            tsteps.make_train_step(tm, TApprox(), tcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        Trainer(tm, TApprox(), TrainConfig(**TRAIN), _data(), str(tmp_path), device="cpu")
