"""The port's checkpoint manager (``repro_torch.ckpt``) against the JAX
reference's, on the CPU, at the qwen2.5-3b smoke config (float32, and
bf16 weights): a generation either package writes, the other restores;
the port restores in place; the ``.tmp`` crash case, GC, the async save's
snapshot, ``latest_step`` joining a save in flight, a short disk, and a
path that needs no ``ml_dtypes``.

Tolerance: none.  A checkpoint holds the bits of every leaf, so every
restore is bitwise, dtype for dtype.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import AnalogParams as JAnalog
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import Phase as JPhase
from repro.configs.base import TrainMode as JMode
from repro.core.schedule import CalibrationController as JController
from repro.core.schedule import PhasePlan as JPlan
from repro.models import build_model as j_build
from repro.training import steps as jsteps
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import manager as tmanager
from repro_torch.configs.base import AnalogParams, ApproxConfig, Backend, Phase, TrainConfig
from repro_torch.configs.base import TrainMode
from repro_torch.convert import train_state_from_jax, train_state_layout, train_state_to_numpy
from repro_torch.core.schedule import CalibrationController, PhasePlan
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model as t_build
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.training import steps as tsteps

DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(get, dtype):
    return dataclasses.replace(get("qwen2.5-3b"), param_dtype=dtype, compute_dtype=dtype)


def _approx():
    return (JApprox(backend=JBackend.ANALOG, mode=JMode.INJECT, analog=JAnalog(array_size=16)),
            ApproxConfig(backend=Backend.ANALOG, mode=TrainMode.INJECT,
                         analog=AnalogParams(array_size=16)))


def _controllers():
    """Both packages' controllers, advanced alike to a mid-phase state."""
    ja, ta = _approx()
    jc = JController(JPlan((JPhase.exact(2), JPhase.inject(6, calibrate="adaptive"))), ja)
    tc = CalibrationController(PhasePlan((Phase.exact(2), Phase.inject(6, calibrate="adaptive"))),
                               ta)
    for c in (jc, tc):
        for s in range(5):
            if c.begin_step(s):
                c.record(s, 1.0 + 0.1 * s)
    return jc, tc


def _states(dtype, seed=0):
    """The reference's initial state and the port's copy of it, after one
    INJECT step of the port (so AdamW's slots and the step are not zero)."""
    jm = j_build(_cfg(j_smoke, dtype))
    ja, ta = _approx()
    js = jax.tree.map(np.asarray, jsteps.init_train_state(jm, jax.random.PRNGKey(seed), ja))
    ts = train_state_from_jax(js, device="cpu")
    tm = t_build(_cfg(t_smoke, dtype))
    data = SyntheticLM(512, seq_len=8, global_batch=2, seed=seed)
    ts, _ = tsteps.make_calibration_step(tm, ta, TrainConfig())(ts, data.batch_at(0), (1, 0))
    ts, _ = tsteps.make_train_step(tm, ta, TrainConfig(remat="none"))(ts, data.batch_at(0), (1, 0))
    return js, ts


def _bits(a):
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_trees_bitwise(got, want):
    gl, wl = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in gl] == [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert _bits(g) == _bits(w), jax.tree_util.keystr(path)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    """A generation the port writes (train state and controller) is the
    reference's layout: its manifest's key paths are ``jax.tree_util``'s
    of the reference's state, and the reference's manager restores it
    into the reference's state bitwise equal to ``train_state_to_numpy``."""
    js, ts = _states(dtype)
    jc, tc = _controllers()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, dict(train_state_layout(ts), sched=tc.to_tree()))
    mgr.wait()
    like = dict(js, sched=jc.to_tree())
    with open(tmp_path / "step_7" / "manifest.json") as f:
        manifest = json.load(f)
    assert [m["path"] for m in manifest["leaves"]] == [
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(like)[0]]
    assert {m["dtype"] for m in manifest["leaves"]} >= ({"bfloat16"} if dtype == "bfloat16"
                                                         else {"float32"})
    restored = JManager(str(tmp_path)).restore(like)
    sched = restored.pop("sched")
    _assert_trees_bitwise(restored, train_state_to_numpy(ts))
    _assert_trees_bitwise(sched, tc.to_tree())
    assert int(restored["step"]) == ts["step"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_checkpoint_restores_in_place(tmp_path, dtype):
    """A generation the reference writes is restored by the port into a
    train state of other values, in place: every tensor keeps its storage,
    float32 parameters stay aliased to their AdamW masters, and the state
    is then bitwise ``train_state_from_jax`` of the reference's."""
    js, _ = _states(dtype)
    jc, tc = _controllers()
    _, ts = _states(dtype, seed=3)  # other weights, slots and stats to overwrite
    JManager(str(tmp_path)).save(4, dict(js, sched=jc.to_tree()), blocking=True)
    ptrs = [t.data_ptr() for t in ts["params"].parameters()]
    layout = train_state_layout(ts)
    fresh = CalibrationController(tc.plan, tc.approx)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 4
    full = mgr.restore(dict(layout, sched=fresh.to_tree()))
    fresh.load_tree(full["sched"])
    ts["step"] = int(full["step"])
    assert [t.data_ptr() for t in ts["params"].parameters()] == ptrs
    named, master = dict(ts["params"].named_parameters()), ts["opt"]["master"]
    aliased = [n for n in named if named[n].data_ptr() == master[n].data_ptr()]
    assert len(aliased) == (len(named) if dtype == "float32" else 0)
    _assert_trees_bitwise(train_state_to_numpy(ts), js)
    _assert_trees_bitwise(fresh.to_tree(), jc.to_tree())
    assert mgr.events[-1]["op"] == "restore" and mgr.events[-1]["step"] == 4


def _small(v=1.0):
    return {"w": torch.full((4, 3), v), "h": torch.full((5,), v, dtype=torch.bfloat16),
            "n": {"count": np.asarray(3, np.int32)}}


def test_tmp_directory_of_a_crashed_write_is_never_a_generation(tmp_path, monkeypatch):
    """A ``step_<n>.tmp`` left by a crash is neither the latest step nor
    restored nor collected as a generation; a write that fails re-raises
    from ``wait`` and leaves ``LATEST`` on the previous generation."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    os.makedirs(tmp_path / "step_9.tmp")
    (tmp_path / "step_9.tmp" / "arrays.npz").write_bytes(b"partial")
    assert mgr.latest_step() is None
    mgr.save(1, _small(1.0), blocking=True)
    assert mgr.latest_step() == 1 and (tmp_path / "step_9.tmp").exists()

    def crash(*a, **k):
        raise OSError("disk went away")

    monkeypatch.setattr(tmanager.np, "savez", crash)
    mgr.save(2, _small(2.0))
    with pytest.raises(OSError, match="disk went away"):
        mgr.wait()
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    assert (tmp_path / "step_2.tmp").exists() and not (tmp_path / "step_2").exists()
    into = _small(0.0)
    mgr.restore(into)
    assert torch.equal(into["w"], torch.full((4, 3), 1.0))


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_gc_keeps_the_last_generations(tmp_path, keep):
    mgr = CheckpointManager(str(tmp_path), keep=keep)
    for s in (1, 2, 3, 4):
        mgr.save(s, _small(float(s)))
    assert mgr.latest_step() == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == [f"step_{s}" for s in (1, 2, 3, 4)[-keep:]]
    into = _small(0.0)
    out = mgr.restore(into, step=4 - keep + 1)
    assert torch.equal(into["h"], torch.full((5,), float(4 - keep + 1), dtype=torch.bfloat16))
    assert out["n"]["count"] == 3 and out["w"] is into["w"]


def test_latest_step_and_restore_join_a_save_in_flight(tmp_path, monkeypatch):
    """``save`` returns with the host copy taken: the tensors may change at
    once.  ``latest_step`` waits for the writer, so it sees the new
    generation, which holds the values of the moment of the save."""
    slow = np.savez

    def savez(*a, **k):
        time.sleep(0.5)
        slow(*a, **k)

    monkeypatch.setattr(tmanager.np, "savez", savez)
    mgr = CheckpointManager(str(tmp_path))
    state = _small(1.0)
    t0 = time.perf_counter()
    mgr.save(3, state)
    assert time.perf_counter() - t0 < 0.4
    state["w"].add_(5.0)
    assert not (tmp_path / "LATEST").exists()
    assert mgr.latest_step() == 3
    mgr.save(4, state)
    into = _small(0.0)
    mgr.restore(into, step=3)
    assert torch.equal(into["w"], torch.full((4, 3), 1.0))
    assert [e["step"] for e in mgr.events if e["op"] == "save"] == [3, 4]
    assert all("write_s" in e for e in mgr.events if e["op"] == "save")


def test_save_refuses_a_short_disk(tmp_path, monkeypatch):
    """A generation that the file system cannot hold beside the ones kept
    raises ENOSPC before anything is written."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _small(), blocking=True)
    real = tmanager.shutil.disk_usage
    monkeypatch.setattr(tmanager.shutil, "disk_usage",
                        lambda p: real(p)._replace(free=1000))
    with pytest.raises(OSError, match="needs"):
        mgr.save(2, _small())
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_1"]


@pytest.mark.parametrize("change", ["structure", "dtype", "shape"])
def test_restore_refuses_another_layout(tmp_path, change):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _small(), blocking=True)
    into = _small()
    if change == "structure":
        into["extra"] = torch.zeros(2)
    elif change == "dtype":
        into["w"] = into["w"].double()
    else:
        into["h"] = torch.zeros((6,), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mgr.restore(into)


def test_checkpoint_path_needs_no_ml_dtypes(tmp_path):
    """Save and restore a bf16 train state with ``ml_dtypes`` unimportable
    (the card's machine is not known to have it)."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import dataclasses, torch\n"
        "from repro_torch.ckpt import CheckpointManager\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.configs.base import ApproxConfig\n"
        "from repro_torch.convert import train_state_layout\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.training.steps import init_train_state\n"
        "cfg = dataclasses.replace(get_smoke_config('qwen2.5-3b'), param_dtype='bfloat16',\n"
        "                          compute_dtype='bfloat16')\n"
        "m = build_model(cfg)\n"
        "a = init_train_state(m, 0, ApproxConfig(), device='cpu')\n"
        "b = init_train_state(m, 1, ApproxConfig(), device='cpu')\n"
        f"mgr = CheckpointManager({str(tmp_path)!r})\n"
        "mgr.save(1, train_state_layout(a)); mgr.restore(train_state_layout(b))\n"
        "assert all(torch.equal(x, y) for x, y in zip(a['params'].parameters(),\n"
        "                                             b['params'].parameters()))\n"
        "assert a['params'].embed.dtype == torch.bfloat16\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
