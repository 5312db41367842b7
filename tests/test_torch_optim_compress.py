"""The port's compressed optimizer state (``optim.adamw``: ``adamw_init(
compress=)``, the bf16 stochastic rounding, SM3's factored second moments,
``state_bytes``; ``optim.compress.init_compression_state``; the compressed
state carried across from the reference and through a checkpoint) against
the JAX reference, on the CPU (qwen2.5-3b smoke config: 2 layers, d 64,
q/k/v biases, so SM3 factors per-layer vectors across the layers).

Contracts, each named where it is used:

* The rounding: bitwise ``jax.random``'s (``randint`` over 2^16 added to the
  float's bits), a stacked leaf's layer slice at its flat counters.
* AdamW over three steps from one state and the same gradients: m (bf16,
  stochastically rounded) and v (float32, or SM3's ``r`` and ``c``, a
  stacked vector's ``c`` shared by the layers) bitwise; the float32 master
  and the weights within ``ADAMW`` (rtol 2e-6, atol 1e-9 at lr 2e-3: a few
  ulps of the update), the last-ulp differences of the schedule's ``cos``
  and the bias corrections' ``pow`` that the uncompressed update has too
  (tests/test_torch_train_step.py); ``state_bytes`` equal.
* A checkpoint of the compressed state: written in the reference's layout
  (its key paths), restored in place bitwise, and the step after the
  restore bitwise the step after the save.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import build_model as j_build
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.training import steps as jsteps
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ApproxConfig, TrainConfig
from repro_torch.convert import (
    named_from_jax,
    train_state_from_jax,
    train_state_layout,
    train_state_to_numpy,
)
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops, prng
from repro_torch.layout import flatten
from repro_torch.models import build_model as t_build
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import init_compression_state, state_bytes
from repro_torch.training import steps as tsteps

ADAMW = dict(rtol=2e-6, atol=1e-9)


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


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# The stochastic rounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count", [1, 7, 2**31 - 1])
def test_stochastic_round_matches_reference(count):
    """The reference's ``_stochastic_round_bf16`` with leaf i's key of step
    ``count`` is the port's rounding under the path ``(0x5F3759DF, count,
    i, 1)``; layer l of a stacked leaf takes its slice's counters."""
    rnd = np.random.default_rng(count % 97)
    x = (rnd.standard_normal((3, 5, 7)) * 10.0 ** rnd.integers(-20, 20, (3, 5, 7)))
    x = x.astype(np.float32)
    x[0, 0, :3] = [0.0, -0.0, np.inf]
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0x5F3759DF), count), 4)
    for i in (0, 3):
        with jax.disable_jit():
            want = np.asarray(jadamw._stochastic_round_bf16(jnp.asarray(x), keys[i]))
        path = torch.tensor(prng.path_words((tadamw.ROUND_SEED, count, i, 1)), dtype=torch.int32)
        got = ops.stochastic_round_bf16(torch.from_numpy(x), path)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
        for l in range(3):
            part = ops.stochastic_round_bf16(torch.from_numpy(x[l]), path, offset=l * 35)
            np.testing.assert_array_equal(part.view(torch.int16).numpy(), want[l].view(np.int16))
    # unbiased: the mean of many roundings of one value is the value
    v = torch.full((200_000,), 1.0 + 2.0**-10, dtype=torch.float32)
    r = ops.stochastic_round_bf16(v, torch.tensor(prng.path_words((5, 1)), dtype=torch.int32))
    assert abs(float(r.float().mean()) - (1.0 + 2.0**-10)) < 2e-5
    assert set(r.float().unique().tolist()) == {1.0, 1.0078125}


@pytest.mark.parametrize("shape,dim", [((6, 64), -1), ((3, 1000), -1), ((2, 40000), -1),
                                       ((1000, 3), -2), ((36, 7), -2), ((2, 3, 100), -2),
                                       ((33,), -1), ((5,), -1)])
def test_xla_mean_matches_jnp_mean(shape, dim):
    a = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) ** 2
    with jax.disable_jit():
        want = np.asarray(jnp.mean(jnp.asarray(a), axis=dim))
    np.testing.assert_array_equal(tadamw.xla_mean(torch.from_numpy(a), dim).numpy(), want)


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------


def _states(jm, compress, **kw):
    jt = JTrainConfig(optim_compress=compress, warmup_steps=1, learning_rate=2e-3, **kw)
    tt = TrainConfig(optim_compress=compress, warmup_steps=1, learning_rate=2e-3, **kw)
    js = jax.tree.map(np.asarray, jsteps.init_train_state(jm, jax.random.PRNGKey(0), JApprox(),
                                                          jt))
    return jt, tt, js, train_state_from_jax(js, device="cpu")


@pytest.mark.parametrize("compress", ["none", "bf16", "sm3"])
def test_adamw_compressed_matches_reference(models, compress):
    jm, _ = models
    jt, tt, js, ts = _states(jm, compress)
    named = dict(ts["params"].named_parameters())
    params, opt = js["params"], js["opt"]
    assert state_bytes(ts["opt"]) == jadamw.state_bytes(opt)
    rnd = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: (rnd.standard_normal(p.shape) * 1e-3).astype(np.float32), params)
        with jax.disable_jit():
            params, opt, _ = jadamw.adamw_update(grads, opt, params, jt)
        params, opt = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)
        tg = {n: torch.from_numpy(np.array(a)) for n, a in named_from_jax(grads).items()}
        tadamw.adamw_update({n: tg[n] for n in named}, ts["opt"], named, tt)
        got = train_state_to_numpy(ts)
        for slot in ("m", "v"):
            g, w = flatten(got["opt"][slot]), flatten(opt[slot])
            assert [p for p, _ in g] == [p for p, _ in w]
            for (path, a), (_, b) in zip(g, w):
                assert a.dtype == b.dtype, path
                np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=f"{slot}{path}")
        for (path, a), (_, b) in zip(flatten(got["opt"]["master"]), flatten(opt["master"])):
            np.testing.assert_allclose(a, b, err_msg=path, **ADAMW)
        for (path, a), (_, b) in zip(flatten(got["params"]), flatten(params)):
            np.testing.assert_allclose(_f32(a), _f32(b), err_msg=path, **ADAMW)
        assert int(got["opt"]["count"]) == int(opt["count"])
    assert state_bytes(ts["opt"]) == jadamw.state_bytes(opt)
    v = ts["opt"]["v"]
    if compress == "sm3":
        # a stacked vector's c is one tensor for every layer; a matrix's own
        assert v["layers.0.ln1"]["c"] is v["layers.1.ln1"]["c"]
        assert v["layers.0.attn.bq"]["c"] is v["layers.1.attn.bq"]["c"]
        assert v["layers.0.attn.wq"]["c"] is not v["layers.1.attn.wq"]["c"]
        assert v["layers.0.ln1"]["r"].shape == () and v["final_norm"].shape == (64,)
        assert opt["v"]["layers"]["ln1"]["c"].shape == (64,)
    if compress != "none":
        assert all(m.dtype == torch.bfloat16 for m in ts["opt"]["m"].values())


def test_compressed_state_shrinks(models):
    """The reference's own check: strictly fewer bytes than float32 state,
    sm3 fewer than bf16."""
    _, tm = models
    params = tm.init(0, "cpu")
    named = dict(params.named_parameters())
    sizes = [state_bytes(tadamw.adamw_init(named, c)) for c in ("none", "bf16", "sm3")]
    assert sizes[0] > sizes[1] > sizes[2]
    n = sum(t.numel() for t in named.values())
    assert sizes[0] == 8 * n and sizes[1] == 6 * n
    with pytest.raises(ValueError, match="optim_compress"):
        tadamw.adamw_init(named, "fp8")


def test_train_config_optim_compress_matches_reference():
    for c in ("none", "bf16", "sm3"):
        assert TrainConfig(optim_compress=c).optim_compress == c
    with pytest.raises(ValueError) as want:
        JTrainConfig(optim_compress="int4")
    with pytest.raises(ValueError) as got:
        TrainConfig(optim_compress="int4")
    assert str(got.value) == str(want.value)


def test_init_compression_state_matches_reference(models):
    jm, tm = models
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.init(0, "cpu")
    assert init_compression_state(tp, "none") is None
    assert jcompress.init_compression_state(jp, "none") is None
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = init_compression_state(tp, "int8", dtype=dtype)
        want = named_from_jax(jax.tree.map(np.asarray, jcompress.init_compression_state(
            jp, "int8", dtype=jdtype)))
        assert set(got) == set(want)
        for n, t in got.items():
            assert t.dtype == dtype and tuple(t.shape) == want[n].shape and not t.any()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", ["bf16", "sm3"])
def test_compressed_checkpoint_restores_and_replays_bitwise(models, compress, tmp_path):
    """Three train steps, a save, a restore in place into a fresh state, and
    the fourth step from the live state and from the restored one: bitwise
    (the rounding is keyed on ``count``).  The generation carries the
    reference's key paths, and the JAX package restores it."""
    jm, tm = models
    tcfg = TrainConfig(optim_compress=compress, warmup_steps=1, learning_rate=1e-3,
                       remat="none")
    approx = ApproxConfig()
    data = SyntheticLM(512, 8, 2, seed=0)
    step = tsteps.make_train_step(tm, approx, tcfg)
    live = tsteps.init_train_state(tm, 0, approx, tcfg, device="cpu")
    for s in range(3):
        live, _ = step(live, data.batch_at(s), (1, s))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, train_state_layout(live), blocking=True)
    jlike = jsteps.init_train_state(jm, jax.random.PRNGKey(0), JApprox(),
                                    JTrainConfig(optim_compress=compress))
    assert mgr.paths() == [jax.tree_util.keystr(p) for p, _ in
                           jax.tree_util.tree_leaves_with_path(jlike)]
    jrest = JManager(str(tmp_path)).restore(jlike)
    fresh = tsteps.init_train_state(tm, 9, approx, tcfg, device="cpu")
    restored = mgr.restore(train_state_layout(fresh))
    fresh["step"] = int(restored["step"])
    want = train_state_to_numpy(live)
    for (path, a), (_, b), (_, c) in zip(flatten(train_state_to_numpy(fresh)), flatten(want),
                                         flatten(jax.tree.map(np.asarray, jrest))):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)
        np.testing.assert_array_equal(_f32(c), _f32(b), err_msg=path)
    if compress == "sm3":  # the shared c restored into the one tensor
        v = fresh["opt"]["v"]
        assert v["layers.0.ln2"]["c"] is v["layers.1.ln2"]["c"]
    live, lm = step(live, data.batch_at(3), (1, 3))
    fresh, fm = step(fresh, data.batch_at(3), (1, 3))
    assert torch.equal(lm["loss"], fm["loss"])
    for (path, a), (_, b) in zip(flatten(train_state_to_numpy(fresh)),
                                 flatten(train_state_to_numpy(live))):
        np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)


def test_train_state_from_jax_carries_compressed_state(models):
    """The reference's sm3 state after a step, carried across and back: the
    same leaves, bitwise."""
    jm, _ = models
    jt = JTrainConfig(optim_compress="sm3", warmup_steps=1, remat="none")
    js = jsteps.init_train_state(jm, jax.random.PRNGKey(0), JApprox(), jt)
    step = jax.jit(jsteps.make_train_step(jm, JApprox(), jt))
    js, _ = step(js, SyntheticLM(512, 8, 2, seed=1).batch_at(0), jax.random.PRNGKey(1))
    js = jax.tree.map(np.asarray, js)
    back = train_state_to_numpy(train_state_from_jax(js, device="cpu"))
    for (path, a), (p2, b) in zip(flatten(back), flatten(js)):
        assert path == p2 and a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=path)
