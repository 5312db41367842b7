"""The port's continuous-batching engine against the JAX reference's, on
the CPU: both serve the same seeded queue (mixed prompt and generation
lengths, backends exact, log_mult and approx_mult, 2 slots per lane) over
the same weights (qwen2.5-3b smoke config, carried across as numpy)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import synthetic_requests as j_requests
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.engine import Request, synthetic_requests

# logits: allclose atol=rtol=1e-4, the model-level tolerance of
# tests/test_torch_model.py (summation order, FMA contraction, libm)
TOL = 1e-4
BACKENDS = ("exact", "log_mult", "approx_mult")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_smoke("qwen2.5-3b")
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = t_build(t_smoke("qwen2.5-3b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_synthetic_requests_match_reference():
    a = synthetic_requests(7, 512, seed=4, prompt_lens=(3, 9), gen_lens=(2, 6), backends=BACKENDS)
    b = j_requests(7, 512, seed=4, prompt_lens=(3, 9), gen_lens=(2, 6), backends=BACKENDS)
    assert [(r.prompt, r.max_new_tokens, r.backend) for r in a] == [
        (r.prompt, r.max_new_tokens, r.backend) for r in b
    ]


@pytest.mark.parametrize("fused", [False, True])
def test_engine_matches_reference(setup, fused):
    """Greedy tokens equal for every request (the exact lane must agree;
    the emulated lanes agree at these inputs), logits allclose TOL."""
    jm, jp, tm, tp = setup
    kw = dict(prompt_lens=(3, 12), gen_lens=(2, 5), backends=BACKENDS)
    jq = j_requests(5, jm.cfg.vocab_size, seed=1, **kw)
    tq = synthetic_requests(5, tm.cfg.vocab_size, seed=1, **kw)
    je = JEngine(jm, jp, n_slots=2, max_seq=24, collect_logits=True, fused=fused)
    te = TEngine(tm, tp, n_slots=2, max_seq=24, collect_logits=True, fused=fused,
                 device="cpu")
    jr, tr = je.run(jq), te.run(tq)
    assert sorted(tr) == sorted(jr) == list(range(5))
    for rid in jr:
        assert tr[rid]["backend"] == jr[rid]["backend"]
        assert tr[rid]["tokens"] == jr[rid]["tokens"], rid
        assert len(tr[rid]["logits"]) == len(jr[rid]["logits"])
        for got, want in zip(tr[rid]["logits"], jr[rid]["logits"]):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL, rtol=TOL)
    m = te.metrics()
    assert m["requests"] == 5 and m["lanes"] == 3 and m["fused"] is fused


def test_engine_admits_evicts_and_streams(setup):
    """More requests than slots: later requests wait for a free slot,
    every token streams, and a freed slot is zeroed."""
    _, _, tm, tp = setup
    seen = []
    eng = TEngine(tm, tp, n_slots=2, max_seq=16, device="cpu",
                  stream=lambda rid, tok, done: seen.append((rid, tok, done)))
    reqs = [Request(rid=i, prompt=(1 + i, 2, 3), max_new_tokens=2 + i) for i in range(4)]
    res = eng.run(reqs)
    assert {r: len(v["tokens"]) for r, v in res.items()} == {0: 2, 1: 3, 2: 4, 3: 5}
    assert sum(1 for e in seen if e[2]) == 4
    assert [t for rid, t, _ in seen if rid == 2] == res[2]["tokens"]
    assert eng._bucket(3) == 8 and eng._bucket(9) == 16 and eng._bucket(40) == 16


def test_finished_slot_is_zeroed(setup):
    _, _, tm, tp = setup
    eng = TEngine(tm, tp, n_slots=1, max_seq=16, device="cpu")
    eng.run([Request(rid=0, prompt=(5, 6, 7), max_new_tokens=3)])
    lane = next(iter(eng.lanes.values()))
    assert lane.n_active() == 0
    assert not lane.cache["k"].any() and not lane.cache["v"].any()


def test_engine_rejects_overlong_request(setup):
    _, _, tm, tp = setup
    eng = TEngine(tm, tp, n_slots=1, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=0, prompt=(1,) * 6, max_new_tokens=4))
