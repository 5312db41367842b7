"""The port's MoE family (``models/moe.py``, the MoE blocks of the model,
decode and engine, ``skip_router``, the dbrx-132b and grok-1-314b
configs) against the JAX reference on the CPU, at the smoke configs
(float32, 2 layers, d 64; dbrx 8 experts top 4, grok 4 experts top 2).

Weights are the reference's ``init``, carried across with
``repro_torch.convert.params_from_jax``; inputs are made with numpy from a
seed.  The reference runs its jnp oracles (``REPRO_KERNELS=ref``), jitted
where that is its own serving and training path, eagerly where its jit
folds analog's divisions (ROADMAP C).  Tolerances, each named where used:

* ``ROUTE``: the routing (top-k experts, capacity slots, drops) is equal;
  ties go to the lower expert index, as ``jax.lax.top_k`` orders them.
* ``MOE`` (atol = rtol = 1e-5): ``moe_ffn``'s output and aux loss.  The
  router's softmax and the gates' renormalisation round an ulp apart from
  XLA's, and the gates scale every expert output (measured: 3.4e-6).
* Per expert (``_run_experts`` against the reference's ``vmap``): within
  ``EXPERT`` (atol = rtol = 1e-6).  The SwiGLU's ``silu`` rounds an ulp
  apart from ``jax.nn.silu`` in about a quarter of its elements (as in
  the DENSE MLP), which moves the down projection's per-tensor scales by
  an ulp; log_mult adds its ``exp2``.  Each expert's gate projection, on
  its own key path and scales, is bitwise for SC (jitted reference) and
  analog (eager reference; a flipped ADC level would be a whole step).
* ``MODEL_TOL`` (1e-4): the model-level tolerance of
  tests/test_torch_model.py, for logits, engine logits and collected
  stats.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainMode as JMode
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.core.approx_linear import skipped_site as j_skipped
from repro.core import switch as jsw
from repro.launch.dryrun import per_site_macs as j_macs
from repro.models import build_model as j_build
from repro.models import moe as jmoe
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import synthetic_requests as j_requests
from repro.search import costmodel as jcost
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import _tensor, calib_from_jax, params_from_jax
from repro_torch.core import switch as tsw
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.core.approx_linear import skipped_site
from repro_torch.launch.dryrun import per_site_macs
from repro_torch.models import build_model as t_build
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import ALL_SITES
from repro_torch.runtime.engine import Engine, Request, synthetic_requests
from repro_torch.search import costmodel

MOE = dict(atol=1e-5, rtol=1e-5)
EXPERT = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = 1e-4
ARCHS = ("dbrx-132b", "grok-1-314b")
BACKENDS = ("exact", "approx_mult", "log_mult", "sc", "analog")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    monkeypatch.delenv("REPRO_MOE_GROUPS", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(be, mode="MODEL", **kw):
    if be == "exact":
        return JApprox(**kw), TApprox(**kw)
    return (JApprox(backend=JBackend(be), mode=JMode[mode], **kw),
            TApprox(backend=TBackend(be), mode=TMode[mode], **kw))


@pytest.fixture(scope="module")
def ffn():
    """One MoE FFN of each smoke config: (reference cfg, params, port cfg, params)."""
    out = {}
    for arch in ARCHS:
        jc = j_smoke(arch)
        jp = jmoe.init_moe(jax.random.PRNGKey(0), jc, jnp.float32)
        tp = tmoe.MoE(*[_tensor(np.asarray(jp[k]), "cpu")
                        for k in ("router", "w_gate", "w_up", "w_down")])
        out[arch] = (jc, jp, get_smoke_config(arch), tp)
    return out


def _calib(cfg, approx, seed):
    """Random stats for the experts, laid out as the reference's
    ``calib["moe_experts"]`` ([E, ...]): INJECT draws error from them."""
    rnd = np.random.default_rng(seed)
    one = tmoe._dummy_calib(cfg.n_experts, TCtx(cfg=approx), "cpu")
    out = {}
    for site, st in one.items():
        out[site] = {"mean": (0.01 * rnd.standard_normal(st["mean"].shape)).astype(np.float32),
                     "var": (0.01 * rnd.random(st["var"].shape)).astype(np.float32),
                     "scale": (1 + rnd.random(st["scale"].shape)).astype(np.float32)}
    return out


def _moe_pair(ffn, arch, be, mode, x, calib=None):
    jc, jp, tc, tp = ffn[arch]
    ja, ta = _pair(be, mode)
    jcal = None if calib is None else {"moe_experts": jax.tree.map(jnp.asarray, calib)}
    tcal = None if calib is None else {"moe_experts": calib_from_jax(calib, "cpu")}
    run = lambda x_, p_: jmoe.moe_ffn(x_, p_, jc, JCtx(cfg=ja, calib=jcal,
                                                       rng=jax.random.PRNGKey(5)))
    jo, jaux = jax.jit(run)(jnp.asarray(x), jp)
    to, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, tc, TCtx(cfg=ta, calib=tcal, rng=(5,)))
    return (np.asarray(jo), float(jaux)), (to.numpy(), float(taux))


# ---------------------------------------------------------------------------
# Configs, skip flags, counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_match_reference(arch):
    """The full and smoke configs resolve and equal the reference's field
    for field; ``param_count``, ``active_param_count`` (norms counted
    twice, as the reference does), ``per_site_macs`` and the search's
    site universe are the reference's."""
    for get_t, get_j in ((get_config, j_config), (get_smoke_config, j_smoke)):
        t, j = get_t(arch), get_j(arch)
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        assert {k: (v.value if hasattr(v, "value") else v) for k, v in tf.items()} == {
            k: (v.value if hasattr(v, "value") else v) for k, v in jf.items() if k in tf}
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert per_site_macs(t, 16, 2) == j_macs(j, 16, 2)
        assert costmodel.model_sites(t) == jcost.model_sites(j)
    assert "moe_router" in costmodel.model_sites(get_config(arch))


def test_skip_router_folds_the_router_exact():
    """``skipped_site`` is the reference's for every site under each skip
    flag, and the switch index of ``moe_router`` resolves to exact."""
    for kw in ({}, {"skip_router": False}, {"skip_lm_head": True},
               {"skip_router": False, "skip_lm_head": True}):
        ja, ta = _pair("sc", **kw)
        for site in ALL_SITES:
            assert skipped_site(site, ta) == j_skipped(site, ja), (site, kw)
        np.testing.assert_array_equal(tsw.site_indices(ta), jsw.site_indices(ja))
    assert tsw.site_indices(TApprox(backend=TBackend.SC))[tsw.site_pos("moe_router")] == 0


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("be,mode", [("exact", "MODEL")] + [
    (b, m) for b in BACKENDS[1:] for m in ("MODEL", "INJECT")])
def test_moe_ffn_matches_reference(ffn, be, mode):
    """dbrx's smoke FFN (8 experts, top 4) on 12 tokens: output and aux
    loss within MOE, in MODEL mode (no stats: the experts see
    ``_dummy_calib``'s zeros) and INJECT mode (random stats), against the
    jitted reference.  Its jit folds analog's divisions, which can flip an
    ADC level (ROADMAP C); at these inputs none flips (measured: 7.2e-7),
    and test_experts_match_reference holds analog per projection."""
    x = np.random.default_rng(1).standard_normal((2, 6, 64)).astype(np.float32)
    calib = _calib(ffn["dbrx-132b"][2], _pair(be, mode)[1], 3) if mode == "INJECT" else None
    (jo, jaux), (to, taux) = _moe_pair(ffn, "dbrx-132b", be, mode, x, calib)
    np.testing.assert_allclose(to, jo, **MOE)
    np.testing.assert_allclose(taux, jaux, **MOE)
    assert np.abs(jo).max() > 0.1


def _reference_experts(jc, jp, ja, xin, collect):
    """The reference's per-expert computation, as its ``moe_ffn`` runs it:
    split keys and a sub-context per expert under ``jax.vmap``."""
    E = jc.n_experts
    ctx = JCtx(cfg=ja, rng=jax.random.PRNGKey(5), collect=collect)
    rngs = jax.random.split(ctx.site_rng("moe_experts"), E)

    def one(xe, wg, wu, wd, rng, calib_e):
        sub = JCtx(cfg=ctx.cfg, calib=calib_e, rng=rng, collect=ctx.collect)
        return jmoe._expert_ffn(xe, wg, wu, wd, sub), sub.collected

    return jax.vmap(one)(jnp.asarray(xin), jp["w_gate"], jp["w_up"], jp["w_down"], rngs,
                         jmoe._dummy_calib(E, ctx))


def _reference_gates(jp, ja, xin, eager):
    """Each expert's gate projection under the reference's vmapped
    sub-contexts (split keys)."""
    E = xin.shape[0]

    def run():
        ctx = JCtx(cfg=ja, rng=jax.random.PRNGKey(5))
        rngs = jax.random.split(ctx.site_rng("moe_experts"), E)
        return jax.vmap(lambda xe, wg, rng: j_dense(xe, wg, site="moe_gate",
                                                    ctx=JCtx(cfg=ja, rng=rng)))(
            jnp.asarray(xin), jp["w_gate"], rngs)

    if eager:
        with jax.disable_jit():
            return run()
    return jax.jit(run)()


@pytest.mark.parametrize("be", BACKENDS[1:])
def test_experts_match_reference(ffn, be):
    """grok's smoke experts on [E, 8, 64] buffers (two zero rows, as empty
    capacity slots) in a calibration pass: each expert under its own key
    path (the parent's ``moe_experts`` path and ``e``, the reference's
    split key) and its own per-tensor scales.  SC bitwise against the
    jitted reference, analog bitwise against the eager one, the
    multipliers within EXPERT; the stats collected, stacked over the
    experts ``[E, ...]``, within MODEL_TOL of the largest."""
    jc, jp, tc, tp = ffn["grok-1-314b"]
    ja, ta = _pair(be)
    xin = np.random.default_rng(2).standard_normal((jc.n_experts, 8, 64)).astype(np.float32)
    xin[:, 6:] = 0
    if be == "analog":
        with jax.disable_jit():
            jo, jcol = _reference_experts(jc, jp, ja, xin, True)
    else:
        jo, jcol = jax.jit(lambda: _reference_experts(jc, jp, ja, xin, True))()
    ctx = TCtx(cfg=ta, rng=(5,), collect=True)
    to = tmoe._run_experts(torch.from_numpy(xin), tp, ctx).numpy()
    np.testing.assert_allclose(to, np.asarray(jo), **EXPERT)
    if be in ("sc", "analog"):
        # each expert's gate projection on its own key path and scales:
        # bitwise (the SwiGLU's silu is not in front of it)
        jgate = _reference_gates(jp, ja, xin, eager=be == "analog")
        mctx = TCtx(cfg=dataclasses.replace(ta, mode=TMode.MODEL), rng=(5,))
        base = mctx.site_path("moe_experts")
        for e in range(jc.n_experts):
            sub = tmoe._expert_ctx(mctx, base + (e,), None)
            got = t_dense(torch.from_numpy(xin[e]), tp.w_gate[e], site="moe_gate", ctx=sub)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jgate[e]), err_msg=f"expert {e}")
    got = ctx.collected["moe_experts"]
    assert sorted(got) == sorted(jcol) == sorted(tmoe.MOE_SITES)
    for site in got:
        for k, v in got[site].items():
            w = np.asarray(jcol[site][k])
            assert v.shape == w.shape and v.shape[0] == jc.n_experts
            np.testing.assert_allclose(v.numpy(), w, rtol=MODEL_TOL,
                                       atol=MODEL_TOL * np.abs(w).max(), err_msg=f"{site}.{k}")


def test_tied_router_rows_and_capacity_drops(ffn):
    """ROUTE: rows whose router probabilities tie (a zero row ties all
    experts; two equal router columns tie a pair) take the lower expert
    first, as ``jax.lax.top_k``; at ``capacity_factor`` 0.25 over 64
    tokens (capacity 8 of 32 assignments an expert on average) tokens are
    dropped, and the output and aux loss stay within MOE."""
    jc, jp, tc, tp = ffn["dbrx-132b"]
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]  # experts 2 and 5 tie on every row
    jp = dict(jp, router=jnp.asarray(router))
    tp = tmoe.MoE(torch.from_numpy(router), tp.w_gate, tp.w_up, tp.w_down)
    rnd = np.random.default_rng(4)
    x = rnd.standard_normal((2, 32, 64)).astype(np.float32)
    x[0, 0] = 0.0
    xf = x.reshape(-1, 64)
    probs, idx, _ = tmoe._route(torch.from_numpy(xf), tp, tc, None)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jc.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == list(range(jc.top_k))
    pair = [r for r in idx.tolist() if 2 in r and 5 in r]
    assert pair and all(r.index(2) < r.index(5) for r in pair)
    ffn = dict(ffn, tied=(dataclasses.replace(jc, capacity_factor=0.25), jp,
                          dataclasses.replace(tc, capacity_factor=0.25), tp))
    C = max(8, int(64 * jc.top_k * 0.25 / jc.n_experts))
    _, keep = tmoe._slots(idx.reshape(-1), jc.n_experts, C)
    assert 0 < int((~keep).sum()) < keep.numel()
    for be in ("exact", "sc"):
        (jo, jaux), (to, taux) = _moe_pair(ffn, "tied", be, "MODEL", x)
        np.testing.assert_allclose(to, jo, **MOE)
        np.testing.assert_allclose(taux, jaux, **MOE)


def test_grouped_dispatch_matches_reference(ffn, monkeypatch):
    """``REPRO_MOE_GROUPS=2``: positions and capacity per group of 32
    tokens.  Against the reference's grouped dispatch within MOE (exact
    and SC); with capacity to spare (no drops either way) the exact
    grouped output is the global one within MOE."""
    x = np.random.default_rng(5).standard_normal((2, 32, 64)).astype(np.float32)
    jc, jp, tc, tp = ffn["grok-1-314b"]
    glob, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, tc, None)
    monkeypatch.setenv("REPRO_MOE_GROUPS", "2")
    assert tmoe._dispatch_groups(64) == 2 and tmoe._dispatch_groups(63) == 0
    for be in ("exact", "sc"):
        (jo, jaux), (to, taux) = _moe_pair(ffn, "grok-1-314b", be, "MODEL", x)
        np.testing.assert_allclose(to, jo, **MOE)
        np.testing.assert_allclose(taux, jaux, **MOE)
        if be == "exact":
            np.testing.assert_allclose(to, glob.numpy(), **MOE)


# ---------------------------------------------------------------------------
# The model, decode and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = j_build(j_smoke(arch))
        jp = jm.init(jax.random.PRNGKey(3))
        out[arch] = (jm, jp, t_build(get_smoke_config(arch)),
                     params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_init_layout(models, arch):
    """The converted parameters carry every leaf of the reference's
    (``layers.moe`` included), and the port's own ``init`` lays them out
    as the reference's: same names, shapes and dtypes, the router float32;
    one seed, the same weights."""
    jm, jp, tm, tp = models[arch]
    assert sum(p.numel() for p in tp.parameters()) == sum(
        np.asarray(l).size for l in jax.tree.leaves(jp))
    np.testing.assert_array_equal(tp.layers[1].moe.w_down.numpy(),
                                  np.asarray(jp["layers"]["moe"]["w_down"][1]))
    own, again = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype) for n, p in tp.named_parameters()}
    assert own.layers[0].moe.router.dtype == torch.float32
    for (n, a), b in zip(own.named_parameters(), again.parameters()):
        assert torch.equal(a, b), n
    assert not torch.equal(own.layers[0].moe.w_up[0], own.layers[0].moe.w_up[1])
    assert not torch.equal(own.layers[0].moe.w_up[0], own.layers[1].moe.w_up[0])


@pytest.mark.parametrize("arch,be", [("dbrx-132b", "exact"), ("dbrx-132b", "log_mult"),
                                     ("grok-1-314b", "approx_mult")])
def test_apply_model_matches_reference(models, arch, be):
    """``apply_model`` on 2 x 8 tokens against the reference's (jitted):
    logits and the aux loss (the float32 sum over layers) within
    MODEL_TOL.  With an emulated backend, a calibration pass too: the
    collected stats laid out as the reference's, ``moe_experts``
    ``[L, E, ...]`` beside the attention sites, within MODEL_TOL of each
    leaf's largest value."""
    jm, jp, tm, tp = models[arch]
    ja, ta = _pair(be)
    toks = np.random.default_rng(6).integers(0, 256, (2, 8)).astype(np.int32)
    collect = be != "exact"

    def run(p, t):
        out = jm.apply(p, {"tokens": t}, approx=ja, rng=jax.random.PRNGKey(2), collect=collect)
        return out.logits, out.aux_loss, out.collected

    jlogits, jaux, jcollected = jax.jit(run)(jp, jnp.asarray(toks))
    tout = tm.apply(tp, {"tokens": torch.from_numpy(toks).long()}, approx=ta, rng=(2,),
                    collect=collect, remat="none")
    np.testing.assert_allclose(tout.logits.numpy(), np.asarray(jlogits), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    np.testing.assert_allclose(float(tout.aux_loss), float(jaux), rtol=MODEL_TOL)
    assert tout.aux_loss.dtype == torch.float32 and float(tout.aux_loss) > 0
    if not collect:
        return
    want = jax.tree_util.tree_leaves_with_path(jcollected)
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tout.collected)))
    assert set(got) == {kp for kp, _ in want}
    E, L = jm.cfg.n_experts, jm.cfg.n_layers
    assert tout.collected["layers"]["moe_experts"]["moe_gate"]["scale"].shape == (L, E)
    assert "mlp_gate" not in tout.collected["layers"]
    for kp, w in want:
        w = np.asarray(w)
        np.testing.assert_allclose(got[kp], w, rtol=MODEL_TOL,
                                   atol=MODEL_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(kp))


def test_engine_decode_matches_apply(models):
    """The port's engine on dbrx's smoke config (exact lane, 2 slots, two
    requests decoding side by side): every decode step's logits within the
    reference's own engine-against-apply tolerance (rtol 2e-2, atol 3e-3)
    of a full-sequence ``apply_model`` over the history.  At a capacity
    factor of E / K no expert can overflow in either (capacity >= tokens);
    at the config's 1.25 the full sequence drops tokens that decode, one
    token a row, keeps, and the two differ by design."""
    _, _, tm, tp = models["dbrx-132b"]
    cfg = dataclasses.replace(tm.cfg, capacity_factor=tm.cfg.n_experts / tm.cfg.top_k)
    tm = t_build(cfg)
    rnd = np.random.default_rng(7)
    prompts = [tuple(int(t) for t in rnd.integers(0, 256, n)) for n in (7, 4)]
    eng = Engine(tm, tp, n_slots=2, max_seq=32, collect_logits=True, device="cpu")
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    for rid, prompt in enumerate(prompts):
        history = list(prompt) + res[rid]["tokens"][:-1]
        full = tm.apply(tp, {"tokens": torch.tensor([history])}, remat="none").logits[0]
        for i, row in enumerate(res[rid]["logits"]):
            np.testing.assert_allclose(row, full[len(prompt) - 1 + i].numpy(), rtol=2e-2,
                                       atol=3e-3, err_msg=f"request {rid} step {i}")


def test_engine_matches_reference(models):
    """The port's engine against the reference's on one seeded queue (grok
    smoke, exact, approx_mult and SC cycled, 2 slots a lane, fused decode,
    the reference jitted): greedy tokens equal, logits within MODEL_TOL.
    The SC lane runs on the port's own draws, which are the reference's
    bits, the experts' split keys included (measured: SC bitwise here)."""
    jm, jp, tm, tp = models["grok-1-314b"]
    kw = dict(prompt_lens=(3, 8), gen_lens=(2, 4), backends=("exact", "approx_mult", "sc"))
    je = JEngine(jm, jp, n_slots=2, max_seq=16, collect_logits=True, fused=True, seed=7)
    te = Engine(tm, tp, n_slots=2, max_seq=16, collect_logits=True, fused=True, seed=7,
                device="cpu")
    jr = je.run(j_requests(6, 256, seed=2, **kw))
    tr = te.run(synthetic_requests(6, 256, seed=2, **kw))
    assert sorted(tr) == sorted(jr) == list(range(6))
    for rid in jr:
        assert tr[rid]["backend"] == jr[rid]["backend"]
        assert tr[rid]["tokens"] == jr[rid]["tokens"], rid
        for got, want in zip(tr[rid]["logits"], jr[rid]["logits"]):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=MODEL_TOL,
                                       rtol=MODEL_TOL)
    assert te.metrics()["lanes"] == 3


def test_switch_refuses_moe(models):
    """``Engine(switch=True)`` refuses a MoE model with the reference's
    reason, and so does ``serve --switch --arch dbrx-132b``."""
    _, _, tm, tp = models["dbrx-132b"]
    with pytest.raises(ValueError, match="does not support MoE"):
        Engine(tm, tp, n_slots=1, max_seq=16, switch=True, device="cpu")
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--switch"])
    report = serve.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--requests", "3",
                         "--backends", "exact,approx_mult", "--fused", "--prompt-len", "6",
                         "--gen", "3"])
    assert report["requests"] == 3 and report["arch"] == "dbrx-132b-smoke"
