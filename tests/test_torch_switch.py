"""The port's runtime backend switch (``repro_torch.core.switch``,
``ApproxCtx.site_idx``) and blend probe (``ApproxCtx.blend``) against the
JAX reference, on the CPU.

Contracts:

* The switch module (tables, site indices, masks, per-layer indices,
  canonical configs): equal to the reference's on the same configs.
* Switch against static dispatch in the port: bitwise, for all five
  backends, fused and composed, under a per-site index and a per-row
  index, per projection and for the whole model (both run the same
  ``_approx_branch`` eagerly).
* The port's switch dispatch against the reference's ``_switch_dense``
  (run eagerly): each backend under the contract of its existing parity
  test: approx_mult bitwise; log_mult within the reference's exp2 error
  (2^-20 K max|x_row| max|w|, tests/test_torch_model.py); SC bitwise on
  the JAX draws fed through ``ApproxCtx.draws``; analog under the ADC
  contract (tests/test_torch_sc_analog.py).
* Blend: at ``blend = 0`` the forward is bitwise the exact forward;
  d(loss)/d(blend) agrees with ``jax.grad`` run eagerly within rtol 1e-3,
  atol 1e-6 on the micro config of tests/test_search.py (paper-tinyconv
  cut to 2 layers, d 32): the two frameworks' backward passes sum in
  other orders.  (Jitted, XLA folds the emulators' divisions, which moves
  quantisation levels of the forward, ROADMAP C.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sc_analog as sca
from repro.configs import get_smoke_config as j_smoke
from repro.configs import base as jb
from repro.core import switch as jsw
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.models import build_model as j_build
from repro.search.sensitivity import _blend_grad_builder as j_blend_grad
from repro_torch.configs import base as tb
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import switch as tsw
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import _approx_branch
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.models import build_model as t_build
from repro_torch.models.transformer import ALL_SITES
from repro_torch.search.sensitivity import _blend_grad_builder as t_blend_grad

BACKENDS = ("exact", "sc", "analog", "approx_mult", "log_mult")
BLEND_RTOL, BLEND_ATOL = 1e-3, 1e-6


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(**kw):
    """One ApproxConfig in each package from the same fields."""
    out = []
    for m in (jb, tb):
        k = dict(kw)
        if "backend" in k:
            k["backend"] = m.Backend(k["backend"])
        if "mode" in k:
            k["mode"] = m.TrainMode(k["mode"])
        if "analog" in k:
            k["analog"] = m.AnalogParams(**k["analog"])
        out.append(m.ApproxConfig(**k))
    return tuple(out)


def _fields(cfg) -> dict:
    """A config's fields with enums as their values (comparable across
    packages)."""
    return {k: (v.value if hasattr(v, "value") else
                dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in ((f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg))}


MAPS = [
    dict(),
    dict(backend="sc", mode="model"),
    dict(mode="model", site_backends=(("attn_*", "sc"), ("mlp_gate", "log_mult"))),
    dict(mode="model", site_backends=(("*", "analog"),), skip_lm_head=True),
    dict(mode="inject", backend="approx_mult", site_backends=(("mlp_[ud]*", "exact"),)),
    dict(mode="model", site_backends=(("attn_[qk]", "analog"), ("lm_head", "log_mult"))),
]


# ---------------------------------------------------------------------------
# The switch module
# ---------------------------------------------------------------------------


def test_site_order_and_tables_match_reference():
    assert tsw.SITE_ORDER == jsw.SITE_ORDER == ALL_SITES
    for i, site in enumerate(tsw.SITE_ORDER):
        assert tsw.site_pos(site) == i
    assert tsw.site_pos("not_a_site") is None
    assert tsw.table() == jsw.table()
    for backends in (("log_mult", "analog"), ("exact",), ("sc", "sc", "approx_mult"),
                     jsw.subtable(("log_mult", "analog"))):
        assert tsw.subtable(backends) == jsw.subtable(backends)
    sub = tsw.subtable(("log_mult", "analog"))
    assert tsw.subtable(sub) == sub  # idempotent
    for name in tsw.table():
        assert tsw.backend_index(name) == jsw.backend_index(name)
        if name in sub:
            assert tsw.backend_index(name, sub) == jsw.backend_index(name, sub)
    assert tsw.backend_index(tb.Backend.LOG_MULT) == jsw.backend_index(jb.Backend.LOG_MULT)
    for fn in (lambda m: m.backend_index("no_such_hw"), lambda m: m.subtable(("no_such_hw",))):
        for m in (tsw, jsw):
            with pytest.raises(KeyError, match="not in the switch table"):
                fn(m)


ROUTER = tsw.site_pos("moe_router")


def _assert_indices_equal(got, want):
    """Equal on every site, ``moe_router`` included: both packages'
    ``skip_router`` fold it to exact."""
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(len(MAPS)))
def test_site_indices_masks_and_canonical_match_reference(i):
    ja, ta = _pair(**MAPS[i])
    _assert_indices_equal(tsw.site_indices(ta), jsw.site_indices(ja))
    assert tsw.site_indices(ta)[ROUTER] == 0  # skip_router: exact whatever the map
    sub = ("exact", "analog", "log_mult", "sc")
    if all(b in sub for b in ("exact",) + tuple(str(getattr(b, "value", b))
                                                 for b in ta.approx_backends)):
        _assert_indices_equal(tsw.site_indices(ta, table=sub),
                              jsw.site_indices(ja, table=sub))
    idx = tsw.site_indices(ta)
    for mask in ((), ("mlp_*",), ("attn_[qk]", "lm_head"), ("*",)):
        np.testing.assert_array_equal(tsw.mask_site_indices(idx, mask),
                                      jsw.mask_site_indices(idx, mask))
        rows = np.stack([idx, idx[::-1].copy()])
        np.testing.assert_array_equal(tsw.mask_site_indices(rows, mask),
                                      jsw.mask_site_indices(rows, mask))
    np.testing.assert_array_equal(idx, tsw.site_indices(ta))  # not mutated
    got, want = _fields(tsw.canonical(ta)), _fields(jsw.canonical(ja))
    assert got == want
    for m in (tsw, jsw):
        with pytest.raises(ValueError, match="SITE_ORDER"):
            m.mask_site_indices(idx[:3], ("mlp_*",))


def test_resolution_runs_once_per_config():
    """The same sequence of resolutions in both packages counts the same:
    one a distinct config, however often its indices are read."""
    counts = []
    for m, sw in ((tb, tsw), (jb, jsw)):
        cfg = m.ApproxConfig(site_backends=(("attn_[qk]", "analog"),), sc=m.SCParams(bits=40))
        before = sw.resolution_count()
        first = sw.site_indices(cfg)
        for _ in range(5):
            np.testing.assert_array_equal(sw.site_indices(cfg), first)
        sw.site_indices(m.ApproxConfig(site_backends=(("attn_[qk]", "analog"),),
                                       sc=m.SCParams(bits=40)))
        one = sw.resolution_count() - before
        other = dataclasses.replace(cfg, site_backends=(("mlp_[ud]*", "sc"),))
        sw.site_indices(other)
        sw.site_indices(other, table=("exact", "sc"))
        sw.site_indices(other)
        counts.append((one, sw.resolution_count() - before))
    assert counts[0] == counts[1] == (1, 3)


def test_model_indices_and_backward_gate_match_reference():
    ja, ta = _pair(site_backends=(("mlp_*", "log_mult"),))
    jcfg, tcfg = j_smoke("qwen2.5-3b"), t_smoke("qwen2.5-3b")
    lm = [None] * tcfg.n_layers
    lm[1] = (("attn_*", "sc"),)
    for kw in (dict(), dict(layer_maps=lm), dict(mask_sites=("mlp_*",)),
               dict(layer_maps=lm, mask_sites=("attn_q",), table=("exact", "log_mult", "sc"))):
        got, want = tsw.model_indices(tcfg, ta, **kw), jsw.model_indices(jcfg, ja, **kw)
        assert sorted(got) == sorted(want) == ["head", "layers"]
        for k in got:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    for m, c, a in ((tsw, tcfg, ta), (jsw, jcfg, ja)):
        with pytest.raises(ValueError, match="one entry per layer"):
            m.model_indices(c, a, layer_maps=[None])
    for kw in (dict(), dict(approx_sites=("attn_q", "lm_head")),
               dict(exact_sites=("mlp_down",)),
               dict(approx_sites=("mlp_up",), exact_sites=("mlp_up",))):
        np.testing.assert_array_equal(tsw.backward_gate(**kw), jsw.backward_gate(**kw))
    with pytest.raises(KeyError, match="unknown site"):
        tsw.backward_gate(approx_sites=("nope",))


# ---------------------------------------------------------------------------
# dense(): switch against static in the port, and against the reference
# ---------------------------------------------------------------------------


def _operands(seed=0, M=4, K=48, N=40, dtype=torch.bfloat16):
    rnd = np.random.default_rng(seed)
    x = (rnd.standard_normal((M, K)) * 0.5).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * 0.3).astype(np.float32)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)


def _tcfg(be):
    # one knob set for every backend: a merged ctx takes its knobs from its
    # own (canonical) config
    return tb.ApproxConfig(backend=tb.Backend(be), mode=tb.TrainMode.MODEL,
                           analog=tb.AnalogParams(array_size=16))


def _static(be, x, w, fused, site="attn_q"):
    return t_dense(x, w, site=site, ctx=TCtx(cfg=_tcfg(be), rng=(3,), fused=fused))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("be", BACKENDS)
def test_switch_dense_bitwise_static(be, fused):
    """A per-site index and a per-row index (this backend's rows among
    rows of every other backend) give the static path's bits."""
    x, w = _operands()
    cfg = _tcfg(be)
    ccfg = tsw.canonical(cfg)
    got = t_dense(x, w, site="attn_q", ctx=TCtx(cfg=ccfg, rng=(3,), fused=fused,
                                                  site_idx=tsw.site_indices(cfg)))
    want = _static(be, x, w, fused)
    assert torch.equal(got, want)
    # rows: this backend, then the others in turn
    order = [be] + [b for b in BACKENDS if b != be][:3]
    rows = np.stack([tsw.site_indices(_tcfg(b)) for b in order])
    mixed = t_dense(x, w, site="attn_q", ctx=TCtx(cfg=ccfg, rng=(3,), fused=fused, site_idx=rows))
    for r, b in enumerate(order):
        assert torch.equal(mixed[r], _static(b, x, w, fused)[r]), (r, b)


@pytest.mark.parametrize("fused", [False, True])
def test_switch_dense_skipping_branches_is_bitwise_compute_all(fused):
    """The port skips branches no row selects; the result is bitwise that
    of computing every branch of the table on the whole batch and picking
    rows, as the reference does."""
    x, w = _operands(1)
    names = tsw.table()
    rows = np.zeros((4, len(tsw.SITE_ORDER)), np.int32)
    rows[:, tsw.site_pos("mlp_up")] = [names.index("sc"), 0, names.index("sc"),
                                       names.index("log_mult")]
    ctx = TCtx(cfg=tsw.canonical(_tcfg("sc")), rng=(5,), fused=fused, site_idx=rows)
    got = t_dense(x, w, site="mlp_up", ctx=ctx)
    ys = [(x @ w)] + [_approx_branch(x, w, "mlp_up", n, ctx).to(x.dtype) for n in names[1:]]
    col = torch.from_numpy(rows[:, tsw.site_pos("mlp_up")]).long()
    want = torch.stack(ys)[col, torch.arange(4)]
    assert torch.equal(got, want)


def test_dense_unknown_site_and_calibration_stay_static():
    x, w = _operands(2, dtype=torch.float32)
    cfg = _tcfg("log_mult")
    idx = tsw.site_indices(cfg)
    a = t_dense(x, w, site="attn_q", ctx=TCtx(cfg=cfg, rng=(3,)))
    b = t_dense(x, w, site="custom", ctx=TCtx(cfg=cfg, rng=(3,), site_idx=idx))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rows"):
        t_dense(x, w, site="attn_q", ctx=TCtx(cfg=tsw.canonical(cfg), site_idx=np.stack([idx])))


def _j_switch(ja, x, w, idx, fused, site="mlp_up"):
    with jax.disable_jit():
        ctx = JCtx(cfg=jsw.canonical(ja), rng=jax.random.PRNGKey(9), fused=fused,
                   site_idx=jnp.asarray(idx))
        return np.asarray(j_dense(jnp.asarray(x), jnp.asarray(w), site=site, ctx=ctx),
                          np.float32)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("be", ["sc", "analog", "approx_mult", "log_mult"])
def test_switch_dense_matches_reference_switch(be, fused, per_row):
    """The port's switch dispatch against the reference's ``_switch_dense``
    on the same float32 operands: a per-site index, or rows of this
    backend among exact rows."""
    rnd = np.random.default_rng(len(be) + 2 * fused + per_row)
    K = 32 if be == "sc" else 64
    x = rnd.standard_normal((4, K)).astype(np.float32)
    w = (rnd.standard_normal((K, 48)) * 0.125).astype(np.float32)
    ja, ta = _pair(backend=be, mode="model")
    idx = tsw.site_indices(ta)
    if per_row:
        idx = np.stack([idx, np.zeros_like(idx), idx, np.zeros_like(idx)])
    want = _j_switch(ja, x, w, idx, fused)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ctx = TCtx(cfg=tsw.canonical(ta), rng=(9,), fused=fused, site_idx=idx, draws=sca.jax_draws)
    got = t_dense(tx, tw, site="mlp_up", ctx=ctx)
    rows = [0, 2] if per_row else list(range(4))
    if per_row:  # exact rows: the plain matmul, summed in another order
        np.testing.assert_allclose(got.numpy()[[1, 3]], want[[1, 3]], rtol=1e-5, atol=1e-5)
    g, wv = got.numpy()[rows], want[rows]
    if be in ("sc", "approx_mult"):
        np.testing.assert_array_equal(g, wv)
    elif be == "log_mult":
        bound = 2.0 ** -20 * K * np.abs(x[rows]).max(-1, keepdims=True) * np.abs(w).max()
        assert np.all(np.abs(g - wv) <= bound + 2.0 ** -23 * np.abs(wv))
    else:
        # the emulator's per-tensor scales span every row of the batch
        y = t_dense(tx, tw, site="mlp_up", ctx=TCtx(cfg=ta, rng=(9,), fused=fused))
        sca._analog_contract_for(tx, tw, y, torch.from_numpy(
            _j_switch(ja, x, w, tsw.site_indices(ta), fused)), 2.0 ** -23)
        assert torch.equal(got[rows], y[rows])


# ---------------------------------------------------------------------------
# The model: blend and backend_idx
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    jcfg = dataclasses.replace(j_smoke("paper-tinyconv"), n_layers=2, d_model=32, d_ff=64,
                               n_heads=2, n_kv_heads=2, vocab_size=64)
    tcfg = dataclasses.replace(t_smoke("paper-tinyconv"), n_layers=2, d_model=32, d_ff=64,
                               n_heads=2, n_kv_heads=2, vocab_size=64)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rnd = np.random.default_rng(1)
    toks = rnd.integers(0, 64, (2, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return jm, jp, tm, tp, batch


BASE = dict(mode="model", analog=dict(array_size=32))


def _logits(tm, tp, batch, approx, **kw):
    out = tm.apply(tp, {"tokens": torch.from_numpy(batch["tokens"]).long()}, approx=approx,
                   rng=(7,), remat="none", **kw)
    return out.logits


@pytest.mark.parametrize("sites", [
    (("attn_*", "log_mult"), ("mlp_*", "analog"), ("lm_head", "sc")),
    (("attn_q", "approx_mult"), ("mlp_down", "sc"), ("attn_o", "analog")),
    (("*", "log_mult"),),
])
def test_model_switch_bitwise_static(micro, sites):
    """Whole-model logits: a flat index, the per-layer index dict (every
    layer the same) and static dispatch give the same bits; a genuinely
    per-layer map differs from the uniform one."""
    _, _, tm, tp, batch = micro
    _, ta = _pair(**BASE, site_backends=sites)
    want = _logits(tm, tp, batch, ta)
    ccfg = tsw.canonical(ta)
    assert torch.equal(_logits(tm, tp, batch, ccfg, backend_idx=tsw.site_indices(ta)), want)
    assert torch.equal(_logits(tm, tp, batch, ccfg,
                               backend_idx=tsw.model_indices(tm.cfg, ta)), want)
    mi = tsw.model_indices(tm.cfg, ta, layer_maps=[(), None])
    assert not mi["layers"][0].any() and mi["layers"][1].any()
    per_layer = _logits(tm, tp, batch, ccfg, backend_idx=mi)
    assert torch.isfinite(per_layer).all() and not torch.equal(per_layer, want)


def test_blend_zero_is_the_exact_forward(micro):
    _, _, tm, tp, batch = micro
    _, ta = _pair(**BASE, site_backends=(("*", "analog"),))
    exact = _logits(tm, tp, batch, tb.ApproxConfig())
    b = torch.zeros((), requires_grad=True)
    got = _logits(tm, tp, batch, ta, blend=b)
    assert torch.equal(got.detach(), exact)
    assert got.requires_grad


@pytest.mark.parametrize("site,backend", [
    ("attn_q", "log_mult"), ("mlp_gate", "approx_mult"), ("mlp_down", "analog"),
    ("lm_head", "log_mult"), ("attn_o", "sc"),
])
def test_blend_grad_matches_jax(micro, site, backend):
    """d(loss)/d(blend) at 0 of a one-site probe, static and switch
    dispatch in the port (bitwise equal to each other), against
    ``jax.grad`` of the reference's probe (jitted)."""
    jm, jp, tm, tp, batch = micro
    ja, ta = _pair(**BASE, backend="exact", site_backends=((site, backend),))
    with jax.disable_jit():
        want = float(j_blend_grad(jm, ja)()(jp, jax.tree.map(jnp.asarray, batch),
                                            jax.random.PRNGKey(0), 0.0))
    got = float(t_blend_grad(tm, ta)()(tp, batch, (0,), 0.0))
    ccfg = tsw.canonical(ta)
    sw = float(t_blend_grad(tm, ccfg, switch_aware=True)()(tp, batch, (0,), 0.0,
                                                            tsw.site_indices(ta)))
    assert sw == got
    assert abs(got - want) <= BLEND_ATOL + BLEND_RTOL * abs(want), (got, want)
    assert all(not p.requires_grad for p in tp.parameters())  # restored as they were


@pytest.mark.parametrize("mode", ["model", "proxy_only"])
def test_switch_aware_steps_bitwise_static(micro, mode):
    """A switch-aware train step (keyed on the canonical config, the map
    its ``backend_idx``) and the static step give the same loss and the
    same updated weights, bit for bit; so do the eval steps."""
    import copy

    from repro_torch.training import steps as step_lib

    _, _, tm, tp, batch = micro
    _, ta = _pair(**dict(BASE, mode=mode),
                  site_backends=(("attn_*", "log_mult"), ("mlp_up", "analog")))
    tcfg = tb.TrainConfig(total_steps=4, warmup_steps=1, learning_rate=1e-3, remat="none")
    out = []
    for switch in (False, True):
        state = step_lib.init_train_state(tm, 0, ta, tcfg, device="cpu",
                                          params=copy.deepcopy(tp))
        cfg = tsw.canonical(ta) if switch else ta
        step = step_lib.make_train_step(tm, cfg, tcfg, switch_aware=switch)
        kw = {"backend_idx": tsw.site_indices(ta)} if switch else {}
        state, m = step(state, batch, (1, 0), **kw)
        ev = step_lib.make_eval_step(tm, cfg, switch_aware=switch)(state, batch, (2,), **kw)
        out.append((m["loss"], ev["loss"], [p.detach() for p in state["params"].parameters()]))
    (l0, e0, p0), (l1, e1, p1) = out
    assert torch.equal(l0, l1) and torch.equal(e0, e1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    with pytest.raises(TypeError, match="needs backend_idx"):
        step(state, batch, (1, 1))
    with pytest.raises(TypeError, match="switch-aware"):
        step_lib.make_eval_step(tm, ta)(state, batch, (2,), backend_idx=tsw.site_indices(ta))
