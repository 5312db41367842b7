"""The port's engine with a chip fleet, drift and online recalibration
against the JAX reference's, on the CPU (qwen2.5-3b smoke config, the
same weights carried across as numpy, 2 slots, max_seq 24); its static
baseline; and the serving CLI's flags.

Both engines serve one seeded queue over ``Fleet(2)`` (the same chips:
the port's profiles are the reference's bit for bit) with a drift model
that moves the multiplier families' fault rates and the gain families'
gains.  Contracts:

* lanes, chip ids, chip ages, recalibration counts and the number of
  probe evaluations: equal;
* greedy tokens equal on every lane;
* serving chips raw (``correct=False``): logits allclose 1e-4 at every
  step on the exact, approx_mult and log_mult lanes, the contract of
  tests/test_torch_engine.py (the reference is jitted: XLA:CPU contracts
  the epilogue's multiply-adds);
* serving with the correction (the default), warm-started or drifting
  and refitted: the fitted stats differ from the reference's in their
  last bits (a ridge solve summed in another order), and such a
  difference can move one activation's quantisation level in a later
  layer, a logit by up to ~0.02.  So logits within 1e-4 at 7 of 8 steps
  or more, and within ``FLIP`` (0.05) at every step;
* the raw probe losses (the drift signal) allclose ``PROBE`` (rtol
  1e-4): a whole model's emulated loss on the 2 x 24 probe, summed in
  another order; the corrected probe losses within ``CORRECTED`` (rtol
  1e-3), since a correction that differs in its last bits may move a
  quantisation level there too (by ~1e-4 of the loss);
* ``run_static_baseline``'s outputs equal the reference's.

The reference's Mitchell product (``repro.kernels.ref.mitchell_mul``)
takes its powers of two from ``jnp.exp2``, which XLA:CPU computes
inexactly at some integer arguments (ROADMAP section C); the port
computes the exact product.  Served raw, the drifting fleet's logits do
not feel it (every step within 2e-6 of the unchanged reference), but its
fitted stats do, and with the correction a product off by 2^-21 can flip
a log_mult quantisation level: against the unchanged reference the
warm-started run (on the raw run's stats) is off at 6 of 25 steps (by up
to 0.018) and the drifting corrected one at 3 of 42 (up to 0.024).  So
the fleet engines' runs, and only they, give the reference's
``mitchell_mul`` an exact ``exp2`` (``ldexp``, the value it means): the
warm-started run then agrees within 3e-6 at every step, the drifting one
at 41 of 42 (the other, by 0.024, a refit's last-bit difference as
above).  On this file's queue and fleet seed (3); with fleet seeds 4 and
5 the drifting corrected run is off at 0 and 8 of 42 steps with the
exact ``exp2`` (8 and 15 without), tokens equal throughout.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.hw import DriftModel as JDrift
from repro.hw import Fleet as JFleet
from repro.kernels import ref as jref
from repro.models import build_model as j_build
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import run_static_baseline as j_static
from repro.runtime.engine import synthetic_requests as j_requests
from repro.training.steps import CompiledFnCache
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.hw import DriftModel, Fleet
from repro_torch.launch import serve
from repro_torch.models import build_model as t_build
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.engine import run_static_baseline, synthetic_requests

TOL = 1e-4
FLIP = 0.05
PROBE = dict(rtol=1e-4, atol=1e-5)
CORRECTED = dict(rtol=1e-3, atol=1e-5)
BACKENDS = ("exact", "approx_mult", "log_mult")
DRIFT = dict(gain_walk_std=0.2, offset_walk_std=0.1, fault_growth=0.5)
QUEUE = dict(prompt_lens=(3, 12), gen_lens=(3, 8), backends=BACKENDS)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _ExactExp2:
    """``jax.numpy`` with an exact ``exp2`` of integer-valued floats."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(k):
        return jnp.ldexp(jnp.ones_like(k), k.astype(jnp.int32))


@contextlib.contextmanager
def _exact_exp2():
    """The reference's ``mitchell_mul`` with an exact ``exp2`` (see the
    module docstring), for the fleet engines' runs: every JAX engine of
    this file runs (and traces its steps) under it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jref, "jnp", _ExactExp2())
        yield


@pytest.fixture(scope="module")
def setup():
    jm = j_build(j_smoke("qwen2.5-3b"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = t_build(t_smoke("qwen2.5-3b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp, CompiledFnCache()


def _engines(setup, jfleet, tfleet, drift=True, **kw):
    jm, jp, tm, tp, fns = setup
    common = dict(n_slots=2, max_seq=24, collect_logits=True, fused=True, recalibrate_every=2,
                  **kw)
    je = JEngine(jm, jp, fleet=jfleet, drift=JDrift(**DRIFT) if drift else None, fns=fns,
                 **common)
    te = TEngine(tm, tp, fleet=tfleet, drift=DriftModel(**DRIFT) if drift else None,
                 device="cpu", **common)
    return je, te


def _hold(je, te, jr, tr, corrected: bool):
    assert sorted(tr) == sorted(jr)
    steps = off = 0
    for rid in jr:
        assert tr[rid]["chip"] == jr[rid]["chip"], rid
        assert tr[rid]["tokens"] == jr[rid]["tokens"], rid
        for got, want in zip(tr[rid]["logits"], jr[rid]["logits"]):
            want = np.asarray(want, np.float32)
            steps += 1
            if corrected and not np.allclose(got, want, atol=TOL, rtol=TOL):
                off += 1
                np.testing.assert_allclose(got, want, atol=FLIP, rtol=0)
            else:
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert off * 8 <= steps, (off, steps)
    jlanes = {(str(k[0].backend), k[1]): l for k, l in je.lanes.items()}
    tlanes = {(str(k[0].backend), k[1]): l for k, l in te.lanes.items()}
    assert sorted(tlanes) == sorted(jlanes)
    jrep, trep = je.fleet_report(), te.fleet_report()
    assert len(trep) == len(jrep) > 0
    for t, j in zip(trep, jrep):
        for k in ("chip", "backend", "age_tokens", "recalibrations", "retired"):
            assert t[k] == j[k], (k, t, j)
        for k, tol in (("probe_losses", PROBE), ("corrected_losses", CORRECTED)):
            assert len(t[k]) == len(j[k]), k
            np.testing.assert_allclose(t[k], j[k], **tol, err_msg=k)
    assert te.recalibrations == je.recalibrations
    for key, lane in tlanes.items():
        jl = jlanes[key]
        assert lane.chip_id == jl.chip_id and (lane.chip is None) == (jl.chip is None)
        if lane.chip is not None:  # the drifted chip: its leaves the reference's
            assert float(lane.chip["age"]) == float(np.asarray(jl.chip["age"]))
            for fam in ("analog", "log_mult"):
                for p, v in lane.chip[fam].items():
                    assert float(v) == float(np.asarray(jl.chip[fam][p])), (fam, p)


def test_engine_fleet_matches_reference(setup):
    """Fleet(2) with drift, 8 requests over exact, approx_mult and log_mult:
    every emulated config spreads over both chips, each chip lane binds,
    recalibrates at bind and on its cadence, drifts by the tokens it
    serves (served raw); then a second engine on the same fleets
    warm-starts its chips from the fleet's mean stats and serves with
    the correction."""
    jm, _, tm, _, _ = setup
    jq = j_requests(8, jm.cfg.vocab_size, seed=2, **QUEUE)
    tq = synthetic_requests(8, tm.cfg.vocab_size, seed=2, **QUEUE)
    jfleet, tfleet = JFleet(2, seed=3), Fleet(2, seed=3)
    je, te = _engines(setup, jfleet, tfleet, correct=False)
    with _exact_exp2():
        jr = je.run(jq)
    tr = te.run(tq)
    _hold(je, te, jr, tr, corrected=False)
    chip_lanes = [l for l in te.lanes.values() if l.chip is not None]
    assert {l.chip_id for l in chip_lanes} == {0, 1}
    assert all(l.recals >= 2 for l in chip_lanes)  # at bind, then after drift
    assert all(float(l.chip["age"]) > 0 for l in chip_lanes)
    assert te.metrics()["recalibrations"] == te.recalibrations
    assert tfleet.calibrated_ids() == (0, 1)
    # warm start, serving with the correction (the chips no longer
    # drifting): the fleet's mean stats, a raw and a corrected probe at bind
    je2, te2 = _engines(setup, jfleet, tfleet, drift=False, warm_start=True)
    with _exact_exp2():
        jr2 = je2.run(jq[:5])
    tr2 = te2.run(tq[:5])
    _hold(je2, te2, jr2, tr2, corrected=True)
    for lane in te2.lanes.values():
        if lane.chip is not None:
            assert len(lane.probe_losses) >= 1 and lane.recals == len(lane.probe_losses) - 1


def test_engine_fleet_drifting_corrected_matches_reference(setup):
    """The same queue over a fresh Fleet(2) that drifts while it serves
    with the correction: every chip lane fits at bind, drifts, refits on
    its cadence and serves on its refitted stats, as the reference's."""
    jm, _, tm, _, _ = setup
    jq = j_requests(8, jm.cfg.vocab_size, seed=2, **QUEUE)
    tq = synthetic_requests(8, tm.cfg.vocab_size, seed=2, **QUEUE)
    je, te = _engines(setup, JFleet(2, seed=3), Fleet(2, seed=3))
    with _exact_exp2():
        jr = je.run(jq)
    tr = te.run(tq)
    _hold(je, te, jr, tr, corrected=True)
    chip_lanes = [l for l in te.lanes.values() if l.chip is not None]
    assert {l.chip_id for l in chip_lanes} == {0, 1}
    for lane in chip_lanes:  # refitted after drifting, each fit probed corrected
        assert lane.recals >= 2 and float(lane.chip["age"]) > 0
        assert len(lane.corrected_losses) == lane.recals


def test_engine_without_fleet_is_unchanged(setup):
    """No fleet: one lane per config, no chip, no recalibration, and the
    same results as before (held against the reference in
    tests/test_torch_engine.py)."""
    _, _, tm, tp, _ = setup
    q = synthetic_requests(5, tm.cfg.vocab_size, seed=1, **QUEUE)
    eng = TEngine(tm, tp, n_slots=2, max_seq=24, device="cpu")
    res = eng.run(q)
    assert len(eng.lanes) == 3 and all(l.chip is None for l in eng.lanes.values())
    assert eng.recalibrations == 0 and eng.fleet_report() == [] and eng.probe is None
    assert all(r["chip"] is None for r in res.values())


def test_static_baseline_matches_reference(setup):
    """Waves of 3, prompts fed token by token on the exact path: the
    outputs equal the reference's, token for token."""
    jm, jp, tm, tp, _ = setup
    jq = j_requests(7, jm.cfg.vocab_size, seed=5, prompt_lens=(2, 9), gen_lens=(2, 6))
    tq = synthetic_requests(7, tm.cfg.vocab_size, seed=5, prompt_lens=(2, 9), gen_lens=(2, 6))
    want = j_static(jm, jp, jq, batch=3)
    got = run_static_baseline(tm, tp, tq, batch=3)
    assert got["outputs"] == {int(k): v for k, v in want["outputs"].items()}
    for k in ("requests", "batch", "prefill_tokens", "decode_tokens"):
        assert got[k] == want[k], k
    assert got["warmup_s"] > 0 and got["decode_tok_s"] > 0


@pytest.mark.parametrize("argv", [
    ["--static", "--uniform", "--requests", "3"],
    ["--backends", "exact,log_mult", "--site-backend", "attn_*=approx_mult", "--stream",
     "--temperature", "0.7", "--max-seq", "40"],
    ["--backends", "approx_mult,sc", "--fleet", "2", "--variation-scale", "2",
     "--drift", "0.1", "--recalibrate-every", "2", "--fused"],
    ["--backends", "analog", "--fleet", "1", "--warm-start", "--requests", "2"],
])
def test_serve_flags_run_on_cpu(argv, tmp_path, capsys):
    """The serving CLI's flags parse and serve the smoke config on the CPU."""
    out = tmp_path / "serve.json"
    report = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--requests",
                         "4", "--slots", "2", "--prompt-len", "8", "--gen", "4", "--out",
                         str(out)] + argv)
    assert json.loads(out.read_text())["mode"] == report["mode"]
    if "--static" in argv:
        assert report["mode"] == "static" and report["requests"] == 3
        return
    want = int(argv[argv.index("--requests") + 1]) if "--requests" in argv else 4
    assert report["mode"] == "engine" and report["requests"] == want
    if "--fleet" in argv:
        assert report["fleet"] and all(c["recalibrations"] >= 1 for c in report["fleet"])
    if "--site-backend" in argv:
        assert report["site_backends"] == ["attn_*=approx_mult"]
    if "--stream" in argv:
        assert "rid=" in capsys.readouterr().out


def test_serve_refuses_engine_flags_with_static():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--static",
                    "--fleet", "2"])
