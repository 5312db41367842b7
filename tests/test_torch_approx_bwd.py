"""The port's approximate backward (``proxy.int8_dequant``,
``injection._gated_vjp`` and the gated projections, ``ApproxCtx.bwd_gate``,
``apply_model(bwd_gate=)``, ``search.sensitivity.backward_gate``, the
bwd-aware steps and the Trainer's gated phases, the train CLI's
``--backward``, ``--gate-frac`` and ``--optim-compress``) against the JAX
reference, on the CPU.  Mirrors tests/test_approx_bwd.py.

The reference runs eagerly (``jax.disable_jit()``, ``REPRO_KERNELS=ref``)
where values are compared: XLA:CPU's jit folds ``s / 127.0``.  Contracts,
each named where it is used:

* ``int8_dequant``: bitwise, float32 and bfloat16, per row and per tensor.
* A projection's gated gradients, gate 0 and gate 1: bitwise for the exact
  matmul and the multiplier backends' identity proxy (MODEL, INJECT and
  PROXY_ONLY), and for analog's INJECT (its fast forward is a plain
  matmul).  ``PROXY_VJP`` (1e-6 of the gradient's largest magnitude) for
  the SC and analog proxies: measured 1.8e-7 for SC (its ``exp``), analog
  bitwise.  The fused projection (proxy, then the chip's epilogue) within
  ``F32`` (rtol 2e-5, atol 1e-6 of the scale; the epilogue's polynomial).
* The forward is bitwise the same under no gate, gate 0 and gate 1, and
  gate 0's gradients are bitwise the ungated ones.
* A whole model's gated gradients against the reference's: ``STEP`` (rtol
  1e-4, atol 1e-5 of the largest; matmuls summed in another order); in
  bfloat16 at the full vocabulary, every site open, ``BF16_GRAD`` (the
  gradient norm within 1e-2 of the reference's, the cosine within 1e-3
  of 1).
* ``backward_gate``: the sensitivities within the search tests' first-order
  tolerance (rtol 2e-3, atol 1e-5, the reference jitted) and the masks
  equal.
* The Trainer's gate refreshes and events, backward steps and steps built:
  equal to the reference's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs import base as jb
from repro.core import injection as jinj
from repro.core import proxy as jproxy
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.data import SyntheticLM as JData
from repro.models import build_model as j_build
from repro.runtime.trainer import Trainer as JTrainer
from repro.search import sensitivity as jsens
from repro.training import steps as jsteps
from repro.training.steps import CompiledFnCache as JFns
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import base as tb
from repro_torch.convert import named_from_jax, named_to_jax, params_from_jax
from repro_torch.core import injection as tinj
from repro_torch.core import proxy as tproxy
from repro_torch.core import switch as tswitch
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.data import SyntheticLM
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels.ref import const
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model as t_build
from repro_torch.runtime.trainer import Trainer
from repro_torch.search import sensitivity as tsens
from repro_torch.training import steps as tsteps
from repro_torch.training.steps import CompiledFnCache

PROXY_VJP = 1e-6
F32 = dict(rtol=2e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-5)
# a bfloat16 model's gradients: the packages round bfloat16 ops in another
# order (0.7% apart, closed gate), and the open grid turns some of those
# last-bit differences into a whole grid step (2.5%); norms within 1e-2,
# cosine within 1e-3 of 1
BF16_GRAD = 1e-2
FO_RTOL, FO_ATOL = 2e-3, 1e-5
N_SITES = len(tswitch.SITE_ORDER)
APPROX = ("sc", "analog", "approx_mult", "log_mult")
# the micro config of tests/test_torch_search.py
MICRO = dict(n_layers=2, d_model=32, d_ff=64, n_heads=2, n_kv_heads=2, vocab_size=64)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(seed, K=64, N=40, dtype=np.float32, rows=(2, 3)):
    rnd = np.random.default_rng(seed)
    x = rnd.standard_normal(rows + (K,)).astype(dtype)
    w = (rnd.standard_normal((K, N)) * 0.2).astype(dtype)
    g = rnd.standard_normal(rows + (N,)).astype(dtype)
    return x, w, g


def _hold(got, want, tol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# The operand grid and the scale floors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 0, None])
def test_int8_dequant_matches_reference(dtype, axis):
    """Bitwise the reference's, with a zero row (the eps floor), values on
    the grid's half steps (round half to even) and bf16's weak-typed
    constants."""
    rnd = np.random.default_rng(3)
    x = rnd.standard_normal((6, 40)).astype(np.float32)
    x[2] = 0.0
    x[4, :5] = np.array([127.0, 0.5, 1.5, -2.5, 3.5], np.float32)  # half steps of s/127 = 1
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with jax.disable_jit():
        want = np.asarray(jproxy.int8_dequant(jx, axis=axis).astype(jnp.float32))
    got = tproxy.int8_dequant(tx, axis=axis)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_scale_floors_keep_their_bits():
    """The floor of a dynamic scale is a 0-dim tensor made once per (value,
    dtype, device) and reused; the scales keep the bits of a floor made
    from the Python float on every call."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(5, 7).to(dtype)
        x[1] = 0.0
        old = lambda m: torch.maximum(m, torch.tensor(1e-6, dtype=dtype))  # noqa: E731
        assert torch.equal(tproxy.tensor_scale(x), old(torch.amax(torch.abs(x))))
        assert torch.equal(tproxy.row_scale(x), old(torch.amax(torch.abs(x), -1, keepdim=True)))
        assert torch.equal(tepi.row_abs_scale(x), old(torch.amax(torch.abs(x), -1, keepdim=True)))
        assert tproxy.row_scale(x)[1].item() > 0
        assert const(1e-6, x) is const(1e-6, x)


# ---------------------------------------------------------------------------
# One projection
# ---------------------------------------------------------------------------


SURROGATES = {
    "exact": (lambda a, b: a @ b, lambda a, b: a @ b, None),
    "identity": (jproxy.identity_proxy, tproxy.identity_proxy, None),
    "sc": (lambda a, b: jproxy.sc_proxy(a, b, jb.SCParams()),
           lambda a, b: tproxy.sc_proxy(a, b, tb.SCParams()), PROXY_VJP),
    "analog": (lambda a, b: jproxy.analog_proxy(a, b, jb.AnalogParams(array_size=16)),
               lambda a, b: tproxy.analog_proxy(a, b, tb.AnalogParams(array_size=16)), PROXY_VJP),
}


@pytest.mark.parametrize("gate", [0, 1])
@pytest.mark.parametrize("name", list(SURROGATES))
def test_gated_vjp_matches_reference(name, gate):
    jf, tf, tol = SURROGATES[name]
    x, w, g = _operands(7 + gate)
    with jax.disable_jit():
        jdx, jdw = jinj._gated_vjp(jf, jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                                   jnp.int32(gate))
    tdx, tdw = tinj._gated_vjp(tf, _t(x), _t(w), _t(g), gate)
    _hold(tdx.numpy(), jdx, tol)
    _hold(tdw.numpy(), jdw, tol)
    if gate:  # the gate reroutes something
        ex, ew = tinj._gated_vjp(tf, _t(x), _t(w), _t(g), 0)
        assert not torch.equal(ex, tdx) and not torch.equal(ew, tdw)


CASES = [("exact", "no_model")] + [(be, m) for be in APPROX
                                   for m in ("model", "inject", "proxy_only")]


def _bitwise(be, mode) -> bool:
    return be in ("exact", "approx_mult", "log_mult") or (be, mode) == ("analog", "inject")


@pytest.mark.parametrize("be,mode", CASES)
def test_dense_gated_grads_match_reference(be, mode):
    """``dense()`` under ``ApproxCtx.bwd_gate``, every backend and training
    mode: the gradients of the reference's dense() with the same mask
    (open at mlp_up, closed at attn_q); the forward bitwise whatever the
    mask, and gate 0 bitwise no gate."""
    sc = be == "sc"  # the reference's SC oracle loops over the ports eagerly
    x, w, g = _operands(CASES.index((be, mode)), K=16 if sc else 64, N=16 if sc else 40,
                        rows=(1, 2) if sc else (2, 3))
    kw = dict(analog=dict(array_size=16, adc_bits=4))
    ja = jb.ApproxConfig(backend=jb.Backend(be), mode=jb.TrainMode(mode),
                         analog=jb.AnalogParams(**kw["analog"]))
    ta = tb.ApproxConfig(backend=tb.Backend(be), mode=tb.TrainMode(mode),
                         analog=tb.AnalogParams(**kw["analog"]))
    mask = np.zeros(N_SITES, np.int32)
    mask[tswitch.site_pos("mlp_up")] = 1
    tol = None if _bitwise(be, mode) else PROXY_VJP
    outs = {}
    for site in ("mlp_up", "attn_q"):
        jctx = JCtx(cfg=ja, rng=jax.random.PRNGKey(3), bwd_gate=jnp.asarray(mask))
        with jax.disable_jit():
            _, vjp = jax.vjp(lambda a, b: j_dense(a, b, site=site, ctx=jctx),
                             jnp.asarray(x), jnp.asarray(w))
            jdx, jdw = vjp(jnp.asarray(g))
        for gate in (None, np.zeros(N_SITES, np.int32), mask):
            tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
            y = t_dense(tx, tw, site=site, ctx=TCtx(cfg=ta, rng=(3,), bwd_gate=gate))
            dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
            outs[(site, None if gate is None else int(gate.sum()))] = (y.detach(), dx, dw)
        _hold(outs[(site, 1)][1].numpy(), jdx, tol)
        _hold(outs[(site, 1)][2].numpy(), jdw, tol)
        for k in range(3):
            assert torch.equal(outs[(site, 0)][k], outs[(site, None)][k])
        assert torch.equal(outs[(site, 1)][0], outs[(site, None)][0])
    # open at mlp_up, closed at attn_q
    assert not torch.equal(outs[("mlp_up", 1)][2], outs[("mlp_up", 0)][2])
    assert torch.equal(outs[("attn_q", 1)][2], outs[("attn_q", 0)][2])


@pytest.mark.parametrize("gate", [None, 0, 1])
@pytest.mark.parametrize("be", ["approx_mult", "analog"])
def test_fused_model_mode_backward_matches_reference(be, gate):
    """The fused MODEL projection with a chip's column terms and a fitted
    correction in its epilogue: forward the fused emulator, backward the
    VJP of the proxy followed by the same epilogue (F32)."""
    x, w, g = _operands(30, N=16)
    rnd = np.random.default_rng(31)
    epi = {"colgain": (1 + 0.1 * rnd.standard_normal(16)).astype(np.float32),
           "coladd": (0.01 * rnd.standard_normal(16)).astype(np.float32),
           "mean_coeffs": np.array([0.01, 0.02, -0.003], np.float32),
           "mean_scale": np.float32(0.7)}
    ja = jb.ApproxConfig(backend=jb.Backend(be), mode=jb.TrainMode.MODEL,
                         analog=jb.AnalogParams(array_size=16))
    ta = tb.ApproxConfig(backend=tb.Backend(be), mode=tb.TrainMode.MODEL,
                         analog=tb.AnalogParams(array_size=16))
    jg = None if gate is None else jnp.int32(gate)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a, b: jinj.fused_model_mode_matmul(
            a, b, ja, jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in epi.items()},
            gate=jg), jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = tinj.fused_model_mode_matmul(tx, tw, ta, None, {k: _t(v) for k, v in epi.items()},
                                     gate=gate)
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    with torch.no_grad():
        plain = tinj.fused_model_mode_matmul(_t(x), _t(w), ta, None,
                                             {k: _t(v) for k, v in epi.items()})
    assert torch.equal(y.detach(), plain)
    for got, want in ((dx, jdx), (dw, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32["rtol"],
                                   atol=F32["atol"] * max(1.0, float(np.abs(want).max())))


def test_gated_exact_matmul_zero_gate_is_plain_autodiff():
    x, w, g = _operands(40)
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    want = torch.autograd.grad(tx @ tw, (tx, tw), _t(g))
    y = tinj.gated_exact_matmul(tx, tw, 0)
    got = torch.autograd.grad(y, (tx, tw), _t(g))
    assert torch.equal(y, tx @ tw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():  # no graph: a plain matmul
        assert tinj.gated_exact_matmul(tx, tw, 1).grad_fn is None


# ---------------------------------------------------------------------------
# The model and the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    """The qwen2.5-3b smoke config's reference weights in both packages."""
    jm, tm = j_build(j_smoke("qwen2.5-3b")), t_build(t_smoke("qwen2.5-3b"))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _loss_grads(tm, tp, batch, ta, gate):
    """The loss (rng path (5,)) and every weight's gradient under ``gate``."""
    tcfg = tb.TrainConfig(remat="none")
    named = dict(tp.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = tsteps._loss(tp, tsteps._batch(batch, "cpu"), tm, ta, None, (5,), tcfg, bwd_gate=gate)
    grads = torch.autograd.grad(loss, list(named.values()))
    for p in named.values():
        p.requires_grad_(False)
    return loss.detach(), dict(zip(named, grads))


def test_gate_never_touches_forward_and_zero_is_ungated(qwen):
    _, _, tm, tp = qwen
    ta = tb.ApproxConfig(backend=tb.Backend.APPROX_MULT, mode=tb.TrainMode.INJECT)
    batch = SyntheticLM(512, 8, 2, seed=0).batch_at(1)
    logits = [tm.apply(tp, tsteps._batch(batch, "cpu"), approx=ta, rng=(6,), remat="none",
                       bwd_gate=gate).logits
              for gate in (None, np.zeros(N_SITES, np.int32), np.ones(N_SITES, np.int32))]
    assert torch.equal(logits[0], logits[1]) and torch.equal(logits[0], logits[2])
    l0, g0 = _loss_grads(tm, tp, batch, ta, None)
    lz, gz = _loss_grads(tm, tp, batch, ta, np.zeros(N_SITES, np.int32))
    assert torch.equal(l0, lz)
    assert all(torch.equal(g0[n], gz[n]) for n in g0)


@pytest.mark.parametrize("be", APPROX)
def test_gated_grads_track_exact(qwen, be):
    """Gate-open gradients stay finite, differ from the exact backward's and
    keep its direction (cosine > 0.9), as the reference's own test asks of
    it; the loss is the same bits."""
    _, _, tm, tp = qwen
    ta = tb.ApproxConfig(backend=tb.Backend(be), mode=tb.TrainMode.INJECT,
                         analog=tb.AnalogParams(array_size=32), sc=tb.SCParams(bits=64))
    batch = SyntheticLM(512, 8, 2, seed=3).batch_at(APPROX.index(be))
    le, ge = _loss_grads(tm, tp, batch, ta, np.zeros(N_SITES, np.int32))
    lo, go = _loss_grads(tm, tp, batch, ta, np.ones(N_SITES, np.int32))
    assert torch.equal(le, lo)
    flat = lambda d: torch.cat([v.reshape(-1) for v in d.values()])  # noqa: E731
    e, o = flat(ge), flat(go)
    assert torch.isfinite(o).all() and not torch.equal(e, o)
    cos = float(torch.dot(e, o) / (e.norm() * o.norm() + 1e-12))
    assert cos > 0.9, cos


# ---------------------------------------------------------------------------
# The sensitivity gate, the Trainer, the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    jm = j_build(dataclasses.replace(j_smoke("paper-tinyconv"), **MICRO))
    tm = t_build(dataclasses.replace(t_smoke("paper-tinyconv"), **MICRO))
    jp = jm.init(jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp, JData(64, 16, 4, seed=0).batch_at(9)


def test_gated_model_grads_match_reference(micro):
    """The whole slice: an INJECT-mode loss and its gradients with half the
    sites gated open (exact forward at the skipped lm_head), against the
    reference's eager ``_loss_fn`` (STEP)."""
    jm, jp, tm, tp, batch = micro
    ja = jb.ApproxConfig(backend=jb.Backend.APPROX_MULT, mode=jb.TrainMode.INJECT)
    ta = tb.ApproxConfig(backend=tb.Backend.APPROX_MULT, mode=tb.TrainMode.INJECT)
    mask = tswitch.backward_gate(exact_sites=("attn_q", "attn_k", "mlp_down", "lm_head"))
    jt = jb.TrainConfig(remat="none")
    with jax.disable_jit():
        (jl, _), jg = jax.value_and_grad(lambda p: jsteps._loss_fn(
            p, batch, jm, ja, None, jax.random.PRNGKey(5), jt, bwd_gate=jnp.asarray(mask)),
            has_aux=True)(jp)
    tl, tg = _loss_grads(tm, tp, batch, ta, mask)
    np.testing.assert_allclose(float(tl), float(jl), rtol=STEP["rtol"])
    want = named_from_jax(jax.tree.map(np.asarray, jg))
    for n, g in tg.items():
        w = want[n]
        np.testing.assert_allclose(g.numpy(), w, rtol=STEP["rtol"],
                                   atol=STEP["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=n)


def test_open_gate_grads_match_reference_full_vocab_bf16():
    """The whole model with every site gated open, at the shapes where the
    micro config is small: qwen2.5-3b's vocabulary (151936 columns in the
    lm_head's per-row cotangent grid), bfloat16 weights and activations
    (the grid's arithmetic), 4 layers.  The weights first take two exact
    AdamW steps at learning rate 0.1 in the port (moved, as a training run
    moves them), then go to the reference.  The open gate raises the
    gradient norm on such weights (~2x here), and the reference's own
    ``_loss_fn`` raises it as much: the port's gradients stay within
    ``BF16_GRAD`` of the reference's under both gates."""
    over = dict(n_layers=4, vocab_size=151936, param_dtype="bfloat16",
                compute_dtype="bfloat16")
    jm = j_build(dataclasses.replace(j_smoke("qwen2.5-3b"), **over))
    tm = t_build(dataclasses.replace(t_smoke("qwen2.5-3b"), **over))
    tp = params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), device="cpu")
    data = SyntheticLM(over["vocab_size"], 16, 2, seed=0)
    tcfg = tb.TrainConfig(total_steps=3, warmup_steps=1, learning_rate=0.1, remat="none")
    state = tsteps.init_train_state(tm, 0, tb.ApproxConfig(), tcfg, device="cpu", params=tp)
    step = tsteps.make_train_step(tm, tb.ApproxConfig(), tcfg)
    for s in range(2):
        state, _ = step(state, data.batch_at(10 + s), (1, s))
    tp = state["params"]
    jp = jax.tree.map(jnp.asarray, named_to_jax(dict(tp.named_parameters())))
    ja = jb.ApproxConfig(backend=jb.Backend.ANALOG, mode=jb.TrainMode.INJECT)
    ta = tb.ApproxConfig(backend=tb.Backend.ANALOG, mode=tb.TrainMode.INJECT)
    batch = data.batch_at(1)
    norms = {}
    for name, mask in (("closed", np.zeros(N_SITES, np.int32)),
                       ("open", np.ones(N_SITES, np.int32))):
        with jax.disable_jit():
            (jl, _), jg = jax.value_and_grad(lambda p: jsteps._loss_fn(
                p, batch, jm, ja, None, jax.random.PRNGKey(5), jb.TrainConfig(remat="none"),
                bwd_gate=jnp.asarray(mask)), has_aux=True)(jp)
        tl, tg = _loss_grads(tm, tp, batch, ta, mask)
        want = named_from_jax(jax.tree.map(np.asarray, jg))
        got = np.concatenate([tg[n].float().numpy().ravel() for n in tg])
        ref = np.concatenate([np.asarray(want[n], np.float32).ravel() for n in tg])
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP["rtol"])
        cos = float(got @ ref) / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos >= 1 - BF16_GRAD / 10, (name, cos)
        norms[name] = (np.linalg.norm(got), np.linalg.norm(ref))
        np.testing.assert_allclose(*norms[name], rtol=BF16_GRAD, err_msg=name)
    rise = [o / c for o, c in zip(norms["open"], norms["closed"])]
    assert min(rise) > 1.5, rise


@pytest.fixture(scope="module")
def jgate(micro):
    """The reference's sensitivities on the micro config, and its step
    cache (one jitted blend-grad for every derivation)."""
    jm, jp, _, _, batch = micro
    fns = JFns()
    ja = jb.ApproxConfig(backend=jb.Backend.LOG_MULT)
    return ja, fns, jsens.backward_sensitivities(jm, jp, batch, ja, fns=fns)


@pytest.mark.parametrize("frac", [0.5, 0.75])
def test_backward_gate_matches_reference(micro, jgate, frac):
    jm, jp, tm, tp, batch = micro
    ja, jfns, want = jgate
    ta = tb.ApproxConfig(backend=tb.Backend.LOG_MULT)
    fns = CompiledFnCache()
    got = tsens.backward_sensitivities(tm, tp, batch, ta, fns=fns)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[s] for s in got], [want[s] for s in got], rtol=FO_RTOL,
                               atol=FO_ATOL)
    jmask = jsens.backward_gate(jm, jp, batch, ja, frac=frac, fns=jfns)
    tmask = tsens.backward_gate(tm, tp, batch, ta, frac=frac, fns=fns)
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.dtype == np.int32 and int(tmask.sum()) == len(got) - int(np.ceil((1 - frac) * len(got)))
    assert fns.stats() == {"built": 1}  # every derivation shares one blend-grad step
    assert not tsens.backward_gate(tm, tp, batch, ta, frac=0.0, fns=fns).any()


PHASES = ("exact:2", "inject:3:bwd=approx,gate=0.5", "inject:4:bwd=auto,gate=0.75,gate_every=2",
          "inject:2")


def test_trainer_gate_events_match_reference(micro, tmp_path):
    """exact -> approx -> auto -> exact backward phases through one run:
    the gate derived once at the approx phase's entry and every 2 steps of
    the auto phase; the same refreshes, events (step, open sites),
    backward steps and steps built as the reference's Trainer; one train
    step a mode, shared by the exact and gated phases."""
    jm, _, tm, _, _ = micro
    data = dict(vocab=64, seq_len=16, global_batch=2, seed=3)
    out = {}
    for pkg, base, trainer, build, dkw in (
            ("ref", jb, JTrainer, jm, {}), ("port", tb, Trainer, tm, {"device": "cpu"})):
        approx = base.ApproxConfig(backend=base.Backend.APPROX_MULT,
                                   mode=base.TrainMode.INJECT, calibrate_every=4)
        tcfg = base.TrainConfig(total_steps=11, warmup_steps=1, learning_rate=1e-3,
                                phases=base.parse_phase_specs(PHASES), checkpoint_every=100)
        ds = (JData if pkg == "ref" else SyntheticLM)(data["vocab"], data["seq_len"],
                                                      data["global_batch"], seed=data["seed"])
        out[pkg] = trainer(build, approx, tcfg, ds, str(tmp_path / pkg), **dkw).run()
    got, want = out["port"], out["ref"]
    assert got.backward_steps == want.backward_steps == {"exact": 4, "approx": 3, "auto": 4}
    assert got.gate_refreshes == want.gate_refreshes == 3
    assert got.gate_events == want.gate_events == [(2, 4), (5, 6), (7, 6)]
    assert got.compile_stats["built"] == want.compile_stats["built"] == 3
    assert all(np.isfinite(got.losses))


def test_train_cli_backward_and_compress_flags(tmp_path, capsys):
    """``--backward auto --gate-frac 0.5`` over explicit phases and
    ``--backward approx`` wrapping a run without ``--phase`` in one phase of
    the resolved mode, with ``--optim-compress``; the report carries the
    reference's keys."""
    common = ["--arch", "paper-tinyconv", "--smoke", "--device", "cpu", "--backend",
              "approx_mult", "--batch", "2", "--seq-len", "8", "--log-every", "0"]
    train_cli.main(common + ["--phase", "exact:1", "--phase", "inject:3", "--backward", "auto",
                             "--gate-frac", "0.5", "--optim-compress", "sm3",
                             "--ckpt-dir", str(tmp_path / "a"),
                             "--report", str(tmp_path / "a.json")])
    a = json.loads((tmp_path / "a.json").read_text())
    assert a["backward_steps"] == {"auto": 4} and a["optim_compress"] == "sm3"
    assert a["gate_refreshes"] == 2 and [n for _, n in a["gate_events"]] == [4, 4]
    train_cli.main(common + ["--steps", "3", "--inject-steps", "2", "--finetune-steps", "1",
                             "--backward", "approx", "--optim-compress", "bf16",
                             "--ckpt-dir", str(tmp_path / "b"),
                             "--report", str(tmp_path / "b.json")])
    b = json.loads((tmp_path / "b.json").read_text())
    assert b["schedule"] == "inject:3{bwd=approx@0.75}" and b["backward_steps"] == {"approx": 3}
    assert b["gate_refreshes"] == 1 and b["optim_compress"] == "bf16"
    with pytest.raises(SystemExit):
        train_cli.main(common + ["--optim-compress", "fp8"])
    capsys.readouterr()
