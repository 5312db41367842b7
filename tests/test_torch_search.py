"""The port's hardware-aware search (``repro_torch.search``,
``launch/dryrun.per_site_macs``, ``launch/search.py``, the ``energy`` models
of ``core/backends.py``) against the JAX reference, on the CPU.

Contracts:

* Energy models, MAC counts, map and assignment energies, the measured
  energy table: equal to the reference's as floats (the same arithmetic
  in the same order).
* Pareto utilities: the reference's own tests' invariants
  (tests/test_search.py), on the port's code.
* Search in the port: ``dispatch="switch"`` builds at most 2 steps and its
  candidates' losses are bitwise those of ``dispatch="static"``.
* Against the JAX search (its default jitted path, dispatch "switch") on
  the micro config of tests/test_search.py (paper-tinyconv cut to 2
  layers, d 32, trained 8 exact steps by the reference; log_mult,
  approx_mult): the exact loss and every probe's ``hw_delta`` within
  ``LOSS_ATOL`` = 2e-4 (log_mult's reference products carry XLA:CPU's
  inexact exp2, ROADMAP C: measured 5.8e-5 at most), every
  ``first_order`` within rtol 2e-3, atol 1e-5 (jitted against eager
  backward passes: measured 6.8e-4 relative at most), energies equal, and
  losses within ``LOSS_ATOL`` on every map both pools hold (the uniform
  seeds at least).
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs import base as jb
from repro.core import registry as jreg
from repro.data import SyntheticLM as JData
from repro.launch.dryrun import per_site_macs as j_macs
from repro.models import build_model as j_build
from repro.search import costmodel as jcost
from repro.search import pareto as jpareto
from repro.search.sensitivity import SensitivityProfile as JProfile
from repro.training.steps import CompiledFnCache as JFns
from repro.training.steps import init_train_state as j_init
from repro.training.steps import make_train_step as j_step
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import base as tb
from repro_torch.configs.base import parse_site_backends
from repro_torch.convert import params_from_jax
from repro_torch.core import registry as treg
from repro_torch.launch.dryrun import per_site_macs as t_macs
from repro_torch.models import build_model as t_build
from repro_torch.models.transformer import ALL_SITES
from repro_torch.search import costmodel as tcost
from repro_torch.search.pareto import (
    Candidate,
    SearchResult,
    dominates,
    expand_pins,
    normalize_assignment,
    pareto_front,
    search,
    spec_of,
)
from repro_torch.search.sensitivity import SensitivityProfile
from repro_torch.training.steps import CompiledFnCache

LOSS_ATOL = 2e-4
FO_RTOL, FO_ATOL = 2e-3, 1e-5


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Energy
# ---------------------------------------------------------------------------


PARAMS = [
    ("sc", dict(bits=8)), ("sc", dict(bits=64)), ("sc", dict()),
    ("analog", dict(adc_bits=2)), ("analog", dict(adc_bits=6, array_size=32)),
    ("analog", dict(array_size=256, input_bits=4)), ("analog", dict()),
    ("approx_mult", dict(perforate=3)), ("approx_mult", dict(bits=8, perforate=0)),
    ("approx_mult", dict(perforate=20)),
    ("log_mult", dict(bits=4)), ("log_mult", dict()),
]
CLS = {"sc": "SCParams", "analog": "AnalogParams", "approx_mult": "ApproxMultParams",
       "log_mult": "LogMultParams"}


@pytest.mark.parametrize("be,kw", PARAMS)
def test_energy_models_match_reference(be, kw):
    got = treg.get(be).mac_energy(getattr(tb, CLS[be])(**kw))
    assert got == jreg.get(be).mac_energy(getattr(jb, CLS[be])(**kw))
    assert treg.get("exact").mac_energy(None) == 1.0


def test_energy_model_rejects_nonpositive():
    spec = dataclasses.replace(treg.get("log_mult"), energy=lambda p: 0.0)
    with pytest.raises(ValueError, match="must be > 0"):
        spec.mac_energy(tb.LogMultParams())
    assert dataclasses.replace(spec, energy=None).mac_energy(None) == 1.0


@pytest.mark.parametrize("arch,smoke", [("qwen2.5-3b", True), ("qwen2.5-3b", False),
                                        ("paper-tinyconv", True), ("paper-resnet-tiny", True)])
def test_per_site_macs_match_reference(arch, smoke):
    jc = j_smoke(arch) if smoke else j_config(arch)
    tc = t_smoke(arch) if smoke else t_config(arch)
    for T, B in ((1, 1), (4, 2), (32, 8)):
        assert t_macs(tc, seq_len=T, batch=B) == j_macs(jc, seq_len=T, batch=B)
    assert tuple(tcost.model_sites(tc)) == tuple(jcost.model_sites(jc))


def _pair(**kw):
    out = []
    for m in (jb, tb):
        k = dict(kw)
        for f in ("sc", "analog", "approx_mult", "log_mult"):
            if f in k:
                k[f] = getattr(m, CLS[f])(**k[f])
        out.append(m.ApproxConfig(**k))
    return tuple(out)


MAPS = [
    dict(),
    dict(site_backends=(("*", "analog"),)),
    dict(site_backends=(("mlp_*", "analog"),)),
    dict(site_backends=(("*", "analog"),), skip_lm_head=True),
    dict(site_backends=(("*", "log_mult"),), poly_degree=5),
    dict(site_backends=(("attn_*", "sc"), ("mlp_*", "approx_mult")), sc=dict(bits=16)),
    dict(site_backends=(("attn_q", "analog"), ("lm_head", "log_mult")),
         analog=dict(array_size=32, adc_bits=6)),
]


@pytest.mark.parametrize("arch", ["paper-tinyconv", "qwen2.5-3b"])
@pytest.mark.parametrize("i", range(len(MAPS)))
def test_map_energies_match_reference(arch, i):
    jc, tc = j_smoke(arch), t_smoke(arch)
    ja, ta = _pair(**MAPS[i])
    measured = tcost.load_measured_energy({"analog": 0.02, "sc": {"per_mac": 0.9}})
    for kw in (dict(), dict(seq_len=16, batch=4), dict(measured=measured)):
        assert tcost.map_energy(tc, ta, **kw) == jcost.map_energy(jc, ja, **kw)
        assert tcost.energy_report(tc, ta, **kw) == jcost.energy_report(jc, ja, **kw)
    assert tcost.assignment_energy(tc, ta, ta.site_backends, seq_len=8, batch=2) == \
        jcost.assignment_energy(jc, ja, ja.site_backends, seq_len=8, batch=2)
    gate = np.zeros(len(ALL_SITES), np.int32)
    gate[[0, 4, 13]] = 1
    for g in (None, gate, {"mlp_up": 1, "attn_o": 0}):
        assert tcost.backward_map_energy(tc, ta, gate=g, seq_len=8) == \
            jcost.backward_map_energy(jc, ja, gate=g, seq_len=8)
        assert tcost.train_map_energy(tc, ta, gate=g, batch=3) == \
            jcost.train_map_energy(jc, ja, gate=g, batch=3)
    for m, c, a in ((tcost, tc, ta), (jcost, jc, ja)):
        with pytest.raises(ValueError, match="one per site"):
            m.backward_map_energy(c, a, gate=[1, 0])


def test_load_measured_energy_matches_reference(tmp_path):
    good = {"analog": 0.02, "sc": {"per_mac": 0.9}, "log_mult": 1}
    assert tcost.load_measured_energy(good) == jcost.load_measured_energy(good)
    path = tmp_path / "e.json"
    path.write_text(json.dumps(good))
    assert tcost.load_measured_energy(str(path)) == jcost.load_measured_energy(str(path))
    for bad, msg in (({"nope": 1.0}, "no backend"), ({"sc": 0.0}, "must be > 0"),
                     ({"sc": "x"}, "must be a number"), ({"sc": {"mac": 1}}, "per_mac"),
                     ([1, 2], "must be an object"), ({"sc": True}, "must be a number")):
        for m in (tcost, jcost):
            with pytest.raises(ValueError, match=msg):
                m.load_measured_energy(bad)
    with pytest.raises(ValueError, match="--energy-json"):
        tcost.load_measured_energy(str(tmp_path / "missing.json"))


# ---------------------------------------------------------------------------
# Pareto mechanics (synthetic pools): the reference's invariants
# ---------------------------------------------------------------------------


def _cand(energy, loss, assignment=(), origin="seed"):
    return Candidate(assignment=normalize_assignment(assignment), energy=energy, loss=loss,
                     origin=origin)


def test_pareto_front_nondominated():
    pool = [_cand(1.0, 1.0), _cand(0.5, 2.0), _cand(0.6, 2.5), _cand(0.2, 3.0),
            _cand(1.5, 0.9), _cand(0.5, 2.0, (("a", "sc"),))]
    front = pareto_front(pool)
    for p in front:
        assert not any(dominates(q, p) for q in pool)
    assert _cand(0.6, 2.5) not in front
    assert [p.energy for p in front] == sorted(p.energy for p in front)
    assert len(front) == 5  # duplicate objectives survive


def test_budget_query_monotone_and_json_keys():
    pool = [_cand(1.0, 1.0), _cand(0.7, 1.4), _cand(0.4, 2.2), _cand(0.1, 4.0)]
    kw = dict(arch="x", baseline_energy=1.0, exact_loss=1.0, pool=pool,
              front=pareto_front(pool), n_sites=4)
    res = SearchResult(profile=SensitivityProfile(exact_loss=1.0, entries=()), **kw)
    losses = [res.best_under_budget(f).loss for f in (0.1, 0.3, 0.4, 0.6, 0.8, 1.0, 2.0)]
    assert all(a >= b for a, b in zip(losses, losses[1:]))
    with pytest.raises(ValueError, match="cheapest found"):
        res.best_under_budget(0.05)
    with pytest.raises(ValueError, match="objective"):
        res.best_under_budget(1.0, objective="median")
    jpool = [jpareto.Candidate(assignment=p.assignment, energy=p.energy, loss=p.loss)
             for p in pool]
    jres = jpareto.SearchResult(profile=JProfile(exact_loss=1.0, entries=()),
                                **dict(kw, pool=jpool, front=jpareto.pareto_front(jpool)))
    assert res.to_json() == jres.to_json()
    worst = Candidate(assignment=(), energy=0.5, loss=1.0, loss_worst=3.0)
    assert worst.loss_worst == 3.0 and _cand(0.5, 1.0).loss_worst == 1.0


def test_assignment_spec_roundtrip_and_pins():
    assignment = normalize_assignment(
        (("mlp_gate", "log_mult"), ("attn_q", "analog"), ("mlp_up", "exact")))
    assert assignment == (("attn_q", "analog"), ("mlp_gate", "log_mult"))
    spec = spec_of(assignment)
    assert spec == ("attn_q=analog", "mlp_gate=log_mult")
    assert parse_site_backends(spec, known_sites=ALL_SITES, warn=None) == assignment
    cfg = tb.ApproxConfig(site_backends=assignment)
    assert cfg.backend_for("attn_q") == tb.Backend.ANALOG
    assert cfg.backend_for("mlp_down") == tb.Backend.EXACT
    assert normalize_assignment((("s", "sc"), ("s", "log_mult"))) == (("s", "log_mult"),)
    assert normalize_assignment((("s", "sc"), ("s", "exact"))) == ()
    sites = ("attn_q", "attn_k", "mlp_gate", "mlp_down", "lm_head")
    pins = (("attn_*", "analog"), ("attn_q", "log_mult"), ("lm_head", "exact"))
    assert expand_pins(pins, sites) == jpareto.expand_pins(pins, sites)
    assert dict(expand_pins(pins, sites)) == {"attn_q": "analog", "attn_k": "analog",
                                              "lm_head": "exact"}


# ---------------------------------------------------------------------------
# The search on the micro config, in the port and against the reference
# ---------------------------------------------------------------------------


MICRO = dict(n_layers=2, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2, vocab_size=64)
MICRO_SITES = ("attn_q", "mlp_gate", "mlp_down")
MICRO_BACKENDS = ("log_mult", "approx_mult")


@pytest.fixture(scope="module")
def micro():
    """The reference's micro fixture (8 exact jitted steps), its weights
    carried across."""
    jm = j_build(dataclasses.replace(j_smoke("paper-tinyconv"), **MICRO))
    tm = t_build(dataclasses.replace(t_smoke("paper-tinyconv"), **MICRO))
    data = JData(64, 16, 4, seed=0, branching=2)
    tcfg = jb.TrainConfig(total_steps=8, warmup_steps=1, learning_rate=2e-3)
    state = j_init(jm, jax.random.PRNGKey(0), jb.ApproxConfig())
    step = jax.jit(j_step(jm, jb.ApproxConfig(), tcfg))
    for s in range(8):
        state, _ = step(state, data.batch_at(s), jax.random.fold_in(jax.random.PRNGKey(1), s))
    jp = state["params"]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jbase = jb.ApproxConfig(sc=jb.SCParams(bits=32), analog=jb.AnalogParams(array_size=32))
    tbase = tb.ApproxConfig(sc=tb.SCParams(bits=32), analog=tb.AnalogParams(array_size=32))
    return jm, jp, tm, tp, data.batch_at(500), jbase, tbase


def test_search_switch_builds_two_steps_and_is_bitwise_static(micro):
    _, _, tm, tp, batch, _, tbase = micro
    kw = dict(sites=MICRO_SITES, seed=0, mutations=3)
    sfns, ofns = CompiledFnCache(), CompiledFnCache()
    sw = search(tm, tp, batch, tbase, MICRO_BACKENDS, fns=sfns, dispatch="switch", **kw)
    st = search(tm, tp, batch, tbase, MICRO_BACKENDS, fns=ofns, dispatch="static", **kw)
    assert sfns.stats()["built"] <= 2 < ofns.stats()["built"], (sfns.stats(), ofns.stats())
    assert sw.exact_loss == st.exact_loss
    assert sw.profile.entries == st.profile.entries
    assert [(p.assignment, p.loss, p.energy) for p in sw.pool] == \
        [(p.assignment, p.loss, p.energy) for p in st.pool]
    origins = {p.origin for p in sw.pool}
    assert "exact" in origins and {f"uniform:{b}" for b in MICRO_BACKENDS} <= origins
    for p in sw.front:
        assert not any(dominates(q, p) for q in sw.pool)
    with pytest.raises(ValueError, match="dispatch"):
        search(tm, tp, batch, tbase, MICRO_BACKENDS, fns=sfns, dispatch="banana", **kw)
    assert all(not p.requires_grad for p in tp.parameters())


def test_search_matches_reference(micro):
    jm, jp, tm, tp, batch, jbase, tbase = micro
    kw = dict(sites=MICRO_SITES, seed=0, mutations=3, dispatch="switch")
    jr = jpareto.search(jm, jp, batch, jbase, MICRO_BACKENDS, fns=JFns(), **kw)
    tr = search(tm, tp, batch, tbase, MICRO_BACKENDS, fns=CompiledFnCache(), **kw)
    assert abs(tr.exact_loss - jr.exact_loss) <= LOSS_ATOL
    assert tr.baseline_energy == jr.baseline_energy and tr.n_sites == jr.n_sites
    assert [(e.site, e.backend) for e in tr.profile.entries] == \
        [(e.site, e.backend) for e in jr.profile.entries]
    for t, j in zip(tr.profile.entries, jr.profile.entries):
        assert abs(t.hw_delta - j.hw_delta) <= LOSS_ATOL, (t, j)
        assert t.energy_saving == j.energy_saving
        assert abs(t.first_order - j.first_order) <= FO_ATOL + FO_RTOL * abs(j.first_order), \
            (t, j)
    got = {p.assignment: p for p in tr.pool}
    want = {p.assignment: p for p in jr.pool}
    common = got.keys() & want.keys()
    assert {jr.uniform(b).assignment for b in MICRO_BACKENDS} <= common
    assert () in common
    for a in common:
        assert got[a].energy == want[a].energy
        assert math.isclose(got[a].loss, want[a].loss, rel_tol=0, abs_tol=LOSS_ATOL), a
    assert sorted(tr.to_json()) == sorted(jr.to_json())
    assert sorted(tr.front[0].to_json()) == sorted(jr.front[0].to_json())
    assert sorted(json.loads(json.dumps([dataclasses.asdict(e) for e in tr.profile.entries]))[0]) \
        == sorted(dataclasses.asdict(jr.profile.entries[0]))


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


# the keys the reference's launch/search.py adds to SearchResult.to_json()
REPORT_EXTRA = {"budget_frac", "objective", "measured_energy", "winner", "winner_flags",
                "winner_energy_breakdown", "compile_stats"}


def test_search_cli_report_and_spec_roundtrip(tmp_path):
    from repro_torch.launch import search as cli

    out = tmp_path / "search.json"
    report = cli.main(["--arch", "paper-tinyconv", "--smoke", "--device", "cpu",
                       "--train-steps", "2", "--mutations", "2", "--batch", "4",
                       "--seq-len", "16", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    jkeys = set(jpareto.SearchResult(
        arch="x", baseline_energy=1.0, exact_loss=1.0, pool=[], front=[],
        profile=JProfile(exact_loss=1.0, entries=()), n_sites=0).to_json())
    assert set(report) == jkeys | REPORT_EXTRA
    assert report["compile_stats"] == {"built": 2}
    spec = report["winner"]["spec"]
    assign = parse_site_backends(spec, known_sites=ALL_SITES, warn=None)
    assert tuple(spec_of(assign)) == tuple(spec)
    assert report["winner_flags"] == " ".join(f"--site-backend '{s}'" for s in spec)
    assert sum(v["energy"] for v in report["winner_energy_breakdown"].values()) == \
        pytest.approx(report["winner"]["energy"], rel=1e-12)
    assert report["winner"]["energy"] <= 0.5 * report["baseline_energy"]
    with pytest.raises(SystemExit):
        cli.main(["--arch", "paper-tinyconv", "--smoke", "--device", "cpu",
                  "--backends", "nope"])


def test_fleet_scoring_matches_reference_and_dispatch(micro):
    """Ensemble scoring over a sampled fleet (``fleet_eval_losses``, one
    chip-aware step per closed world): switch bitwise static in the port;
    an approx_mult map's per-chip losses within ``LOSS_ATOL`` of the
    reference's on the same chips (the port's profiles are the
    reference's bit for bit, tests/test_torch_hw.py)."""
    from repro.hw import Fleet as JFleet
    from repro.search.sensitivity import fleet_eval_losses as j_fleet_losses
    from repro_torch.hw import Fleet
    from repro_torch.search.sensitivity import fleet_eval_losses

    jm, jp, tm, tp, batch, jbase, tbase = micro
    kw = dict(sites=MICRO_SITES, seed=0, mutations=1, fleet=Fleet(2, seed=5))
    sfns, ofns = CompiledFnCache(), CompiledFnCache()
    sw = search(tm, tp, batch, tbase, MICRO_BACKENDS, fns=sfns, dispatch="switch", **kw)
    st = search(tm, tp, batch, tbase, MICRO_BACKENDS, fns=ofns, dispatch="static", **kw)
    # the profile's nominal eval and blend probe, and one chip-aware eval
    assert sfns.stats()["built"] == 3
    assert [(p.assignment, p.loss, p.loss_worst) for p in sw.pool] == \
        [(p.assignment, p.loss, p.loss_worst) for p in st.pool]
    assert sw.fleet_size == 2 and all(p.loss_worst >= p.loss for p in sw.pool)
    sites = (("attn_q", "approx_mult"), ("mlp_down", "approx_mult"))
    ta = dataclasses.replace(tbase, mode=tb.TrainMode.MODEL, site_backends=sites)
    ja = dataclasses.replace(jbase, mode=jb.TrainMode.MODEL, site_backends=sites)
    got = fleet_eval_losses(tm, tp, batch, ta, (0,), CompiledFnCache(), Fleet(2, seed=5).chips)
    want = j_fleet_losses(jm, jp, batch, ja, jax.random.PRNGKey(0), JFns(),
                          JFleet(2, seed=5).chips)
    assert len(got) == 2 and got[0] != got[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


def test_recovery_fine_tune_trains_a_copy(micro):
    """``recover_steps`` fine-tunes each candidate (INJECT with calibration,
    then MODEL) on a copy of the parameters before scoring it; the search's
    own parameters are left as they were."""
    _, _, tm, tp, batch, _, tbase = micro
    from repro_torch.data import SyntheticLM

    before = [p.detach().clone() for p in tp.parameters()]
    res = search(tm, tp, batch, tbase, ("approx_mult",), sites=("mlp_gate",), seed=0,
                 mutations=0, recover_steps=3, recover_data=SyntheticLM(64, 16, 4, seed=1),
                 dispatch="static")
    assert all(torch.equal(a, b) for a, b in zip(before, tp.parameters()))
    assert all(not p.requires_grad for p in tp.parameters())
    assert {p.recovered for p in res.pool} == {False, True}  # the exact map is not fine-tuned
    with pytest.raises(ValueError, match="recover_data"):
        search(tm, tp, batch, tbase, ("approx_mult",), recover_steps=1)
