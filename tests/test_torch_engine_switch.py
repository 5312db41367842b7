"""The port's merged serving lanes (``Engine(switch=True)``, ``site_mask``,
``demote_sites``, ``launch/serve.py --switch``) against the JAX
reference's, on the CPU (qwen2.5-3b smoke config, the reference's weights
carried across; the reference's engine runs jitted, as it serves).

Contracts:

* Against the reference's merged-lane engine, on approx_mult and log_mult
  requests (uniform and heterogeneous maps) beside exact ones: greedy
  tokens equal, logits allclose ``TOL`` = 1e-4, the model-level tolerance
  of tests/test_torch_model.py (measured: 2.6e-6 at most).
* In the port, a solo request through the merged lane is bitwise its
  static lane: every backend with one slot; approx_mult and log_mult with
  idle slots too (per-token scales).  SC and analog take per-tensor scales
  over every row, and a merged lane's idle rows run exact where a static
  lane's run emulated, so with idle slots those two differ by design (the
  reference's engine docstring: solo-exact only at batch 1).
* ``demote_sites`` rewrites the live rows as the reference's does (the
  same index rows, then the same tokens), and nothing is called for the
  first time after it.
"""
import numpy as np
import pytest
import torch

import jax
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import Request as JRequest
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ApproxConfig
from repro_torch.convert import params_from_jax
from repro_torch.hw import Fleet
from repro_torch.models import build_model as t_build
from repro_torch.runtime.engine import Engine, Request

TOL = 1e-4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jm = j_build(j_smoke("qwen2.5-3b"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = t_build(t_smoke("qwen2.5-3b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _specs(n=6):
    rnd = np.random.default_rng(0)
    maps = [(), (("attn_*", "log_mult"), ("mlp_*", "approx_mult")), (("mlp_down", "log_mult"),)]
    out = []
    for i in range(n):
        out.append(dict(
            rid=i, prompt=tuple(int(t) for t in rnd.integers(0, 512, int(rnd.integers(3, 10)))),
            max_new_tokens=int(rnd.integers(2, 6)),
            backend=("approx_mult", "log_mult", "exact")[i % 3],
            site_backends=maps[i % 3] if i % 3 != 2 else ()))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_merged_lane_matches_reference(setup, fused):
    jm, jp, tm, tp = setup
    je = JEngine(jm, jp, n_slots=2, max_seq=24, collect_logits=True, fused=fused, switch=True)
    te = Engine(tm, tp, n_slots=2, max_seq=24, collect_logits=True, fused=fused, switch=True,
                device="cpu")
    jr = je.run([JRequest(**s) for s in _specs()])
    tr = te.run([Request(**s) for s in _specs()])
    assert sorted(tr) == sorted(jr)
    for rid in jr:
        assert tr[rid]["tokens"] == jr[rid]["tokens"], rid
        assert tr[rid]["emulated"] == (tr[rid]["backend"] != "exact")
        for got, want in zip(tr[rid]["logits"], jr[rid]["logits"]):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL, rtol=TOL)
    m = te.metrics()
    assert m["lanes"] == len(je.lanes) == 2 and m["switch"] is True and m["site_mask"] == []
    assert sorted(m["per_lane"]) == ["exact", "switch"]


def _solo(tm, tp, backend, n_slots, fused, switch, **kw):
    prompt = tuple(int(x) for x in np.random.default_rng(3).integers(0, 512, 6))
    eng = Engine(tm, tp, n_slots=n_slots, max_seq=32, collect_logits=True, fused=fused,
                 switch=switch, device="cpu", seed=4, **kw)
    res = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=5, backend=backend)])[0]
    return res, eng


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend,n_slots", [
    ("approx_mult", 1), ("log_mult", 1), ("sc", 1), ("analog", 1),
    ("approx_mult", 3), ("log_mult", 3),
])
def test_solo_request_merged_lane_bitwise_static(setup, backend, n_slots, fused):
    _, _, tm, tp = setup
    static, _ = _solo(tm, tp, backend, n_slots, fused, False)
    merged, eng = _solo(tm, tp, backend, n_slots, fused, True)
    assert merged["tokens"] == static["tokens"]
    for a, b in zip(merged["logits"], static["logits"]):
        np.testing.assert_array_equal(a, b)
    lane = next(iter(eng.lanes.values()))
    assert lane.switch and lane.name == "switch" and not lane.site_idx.any()  # idle: exact


def test_merged_lane_with_a_closed_backend_world(setup):
    """A base config with ``switch_backends`` resolves each slot's row
    against that sub-table."""
    _, _, tm, tp = setup
    base = ApproxConfig(switch_backends=("log_mult", "approx_mult"))
    static, _ = _solo(tm, tp, "log_mult", 2, True, False)
    merged, eng = _solo(tm, tp, "log_mult", 2, True, True, approx_base=base)
    assert merged["tokens"] == static["tokens"]
    for a, b in zip(merged["logits"], static["logits"]):
        np.testing.assert_array_equal(a, b)


def test_one_lane_for_every_map_and_no_first_call_for_a_new_map(setup):
    _, _, tm, tp = setup
    eng = Engine(tm, tp, n_slots=2, max_seq=32, min_bucket=8, switch=True, fused=True,
                 device="cpu")
    prompt = tuple(range(1, 7))
    maps = [(("attn_*", "log_mult"),), (("mlp_*", "approx_mult"),),
            (("attn_q", "sc"), ("mlp_down", "log_mult")), (("*", "analog"),)]
    queue = [Request(rid=i, prompt=prompt, max_new_tokens=3, site_backends=maps[i % 4])
             for i in range(6)] + [Request(rid=99, prompt=prompt, max_new_tokens=2)]
    res = eng.run(queue)
    assert sorted(res) == sorted(q.rid for q in queue) and len(eng.lanes) == 2
    warm = set(eng._warm)
    assert len(warm) == 4  # prefill and decode, merged and exact
    eng.run([Request(rid=100 + i, prompt=prompt, max_new_tokens=3, backend=b,
                     site_backends=(("attn_o", "approx_mult"),))
             for i, b in enumerate(("sc", "log_mult"))])
    assert eng._warm == warm and len(eng.lanes) == 2


def test_demote_sites_matches_reference(setup):
    """The reference's demotion scenario (tests/test_dispatch.py): two
    log_mult requests, a third admitted and stepped once, every site
    demoted mid-flight, then a new admission under the installed mask."""
    jm, jp, tm, tp = setup
    prompt = tuple(int(x) for x in np.random.default_rng(0).integers(0, 512, 5))
    out = {}
    for name, E, R, kw in (("jax", JEngine, JRequest, {}), ("torch", Engine, Request,
                                                          {"device": "cpu"})):
        eng = E(jm if name == "jax" else tm, jp if name == "jax" else tp, n_slots=2,
                max_seq=32, switch=True, collect_logits=True, **kw)
        eng.run([R(rid=0, prompt=prompt, max_new_tokens=12, backend="log_mult"),
                 R(rid=1, prompt=prompt, max_new_tokens=12, backend="log_mult")])
        eng.submit(R(rid=2, prompt=prompt, max_new_tokens=8, backend="log_mult"))
        eng.step()
        lane = next(l for l in eng.lanes.values() if l.switch)
        before = lane.site_idx.copy()
        warm = set(getattr(eng, "_warm", ()))
        assert lane.site_idx.max() > 0
        assert eng.demote_sites(("*",)) >= 1
        assert lane.site_idx.max() == 0
        while any(l.n_active() for l in eng.lanes.values()):
            eng.step()
        if name == "torch":
            assert eng._warm == warm  # nothing called for the first time
        res = eng.run([R(rid=3, prompt=prompt, max_new_tokens=4, backend="log_mult")])
        assert eng.metrics()["site_mask"] == ["*"]
        out[name] = (before, res)
    # the same rows, moe_router's included (skip_router folds it to exact)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    for rid in (2, 3):
        t, j = out["torch"][1][rid], out["jax"][1][rid]
        assert t["tokens"] == j["tokens"], rid
        for a, b in zip(t["logits"], j["logits"]):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=TOL, rtol=TOL)
    # demoted to exact everywhere: rid 3 is the exact lane's answer
    exact = Engine(tm, tp, n_slots=2, max_seq=32, collect_logits=True, device="cpu").run(
        [Request(rid=3, prompt=prompt, max_new_tokens=4)])[3]
    assert out["torch"][1][3]["tokens"] == exact["tokens"]


def test_switch_refuses_a_fleet_and_serves_from_the_cli(setup, capsys):
    _, _, tm, tp = setup
    with pytest.raises(ValueError, match="incompatible with a fleet"):
        Engine(tm, tp, n_slots=1, max_seq=16, switch=True, fleet=Fleet(2), device="cpu")
    from repro_torch.launch import serve

    for extra in (["--static"], ["--fleet", "2"]):
        with pytest.raises(SystemExit):
            serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--switch"] + extra)
    report = serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--switch",
                         "--requests", "4", "--backends", "exact,log_mult,sc,analog", "--fused",
                         "--site-backend", "mlp_*=approx_mult"])
    assert report["switch"] is True and report["lanes"] == 1  # every request emulated
    assert sorted(report["per_lane"]) == ["switch"]
