"""The port's training core against the JAX reference on the CPU: the
proxy activations and their VJPs, calibration (the ridge fit, the mean
prediction, the injected error), ``prng.normal`` against
``jax.random.normal``, and each injection path of one projection (MODEL
with its proxy backward, INJECT, PROXY_ONLY, calibration) for the five
backends.

The reference runs eagerly (``jax.disable_jit()``, ``REPRO_KERNELS=ref``),
as the ROADMAP's parity contract asks: XLA:CPU's jit folds divisions and
contracts multiply-adds, which moves analog ADC decisions.  Tolerances,
each named where it is used:

* ``F32`` (rtol 2e-5, atol 1e-6 of the output's scale): float32 rounding,
  for values and gradients whose ops are the reference's but whose
  matmuls sum in another order (torch's CPU GEMM against XLA's).
* ``NORMAL_ULPS`` (3): the port's ``erfinv`` is XLA's polynomial with its
  multiply-adds fused as XLA fuses them; XLA:CPU's own ``log1p`` rounds a
  few percent of the draws differently.
* ``FIT`` (rtol 1e-4, atol 1e-6): the ridge normal equations' sums of
  powers over 8192 points in another order, then an LU solve each.
"""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AnalogParams as JAnalogParams
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import SCParams as JSCParams
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import TrainMode as JMode
from repro.core import calibration as jcal
from repro.core import injection as jinj
from repro.core import proxy as jproxy
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro_torch.configs.base import AnalogParams, SCParams, TrainConfig
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.core import calibration as tcal
from repro_torch.core import injection as tinj
from repro_torch.core import proxy as tproxy
from repro_torch.core import registry
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.kernels import ops, prng

APPROX = ["sc", "analog", "approx_mult", "log_mult"]
BACKENDS = ["exact"] + APPROX
F32 = dict(rtol=2e-5, atol=1e-6)
NORMAL_ULPS = 3
FIT = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jkey(path):
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    return key


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, scale=None, tol=F32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    s = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * max(s, 1.0))


def _operands(seed, be, B=2, T=3, N=40):
    """x [B, T, K] and w [K, N], float32; SC takes fewer ports (the
    reference's SC oracle loops over them eagerly)."""
    K = 24 if be == "sc" else 64
    rnd = np.random.default_rng(seed)
    x = rnd.standard_normal((B, T, K)).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * 0.2).astype(np.float32)
    g = rnd.standard_normal((B, T, N)).astype(np.float32)
    return x, w, g


def _cfgs(be, mode, **kw):
    analog = dict(array_size=16, adc_bits=4)
    return (JApprox(backend=JBackend(be), mode=JMode(mode.value),
                    analog=JAnalogParams(**analog), **kw),
            TApprox(backend=TBackend(be), mode=mode, analog=AnalogParams(**analog), **kw))


def _jvp(fn, x, w, g):
    """The reference's value and VJP (dx, dw) of ``fn`` at (x, w), eagerly."""
    with jax.disable_jit():
        y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
        dx, dw = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _tvjp(fn, x, w, g):
    """The port's value and VJP (dx, dw) of ``fn`` at (x, w)."""
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = fn(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------


def test_config_fields_and_spec_degrees_match_reference():
    """The new ApproxConfig fields, the shared TrainConfig fields and every
    backend's calibration degree are the reference's."""
    ja, ta = JApprox(), TApprox()
    for f in ("proxy_in_backward", "poly_degree", "calibrate_every", "inject_std_scale"):
        assert getattr(ta, f) == getattr(ja, f), f
    jt, tt = JTrainConfig(), TrainConfig()
    for f in ("learning_rate", "min_lr_ratio", "warmup_steps", "total_steps", "weight_decay",
              "beta1", "beta2", "eps", "grad_clip", "microbatches", "optim_compress"):
        assert getattr(tt, f) == getattr(jt, f), f
    for be in BACKENDS:
        for deg in (1, 3):
            assert (tcal.effective_degree(TApprox(poly_degree=deg), TBackend(be))
                    == jcal.effective_degree(JApprox(poly_degree=deg), JBackend(be)))
        spec = registry.get(be)
        assert spec.proxy_forward is not None
        assert (spec.fast_forward is None) == (be not in ("analog",))
    site = tcal.init_site_for(TApprox(backend=TBackend.SC), "mlp_up")
    assert site["mean"].shape == (4,) and site["scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Proxies
# ---------------------------------------------------------------------------


PROXIES = {
    "sc": (lambda x, w: jproxy.sc_proxy(x, w, JSCParams()),
           lambda x, w: tproxy.sc_proxy(x, w, SCParams())),
    "analog": (lambda x, w: jproxy.analog_proxy(x, w, JAnalogParams()),
               lambda x, w: tproxy.analog_proxy(x, w, AnalogParams())),
    "identity": (jproxy.identity_proxy, tproxy.identity_proxy),
}


@pytest.mark.parametrize("name", list(PROXIES))
def test_proxy_and_its_vjp_match_reference(name):
    """Each proxy's value and VJP against ``jax.vjp`` of the reference's,
    within F32 (the contractions sum in another order).  Non-negative
    activations against weight columns biased from negative to positive
    saturate about 40% of the analog half-sums (the clamp at adc_range 4,
    one array of 128 over the 2K = 128 ports), so its zero-gradient branch
    is held too."""
    jfn, tfn = PROXIES[name]
    rnd = np.random.default_rng(1)
    x = rnd.random((2, 3, 64)).astype(np.float32)
    w = (rnd.standard_normal((64, 40)) * 0.2 + np.linspace(-0.3, 0.3, 40)).astype(np.float32)
    g = rnd.standard_normal((2, 3, 40)).astype(np.float32)
    if name == "analog":
        z_pos, z_neg, _ = tproxy.unipolar_matmuls(_t(x), _t(w), 1.0, 1.0)
        sat = float(((z_pos > 4.0).float().mean() + (z_neg > 4.0).float().mean()) / 2)
        assert 0.2 < sat < 0.8
    want = _jvp(jfn, x, w, g)
    got = _tvjp(tfn, x, w, g)
    for a, b in zip(got, want):
        _close(a, b)


def test_proxy_gradient_conventions():
    """|x| passes +g at 0 and the clamp splits a tie evenly, as JAX's abs
    and clip do (torch's abs and clamp do not)."""
    z = torch.tensor([0.0, 1.0, 4.0, 5.0, -1.0], requires_grad=True)
    (gz,) = torch.autograd.grad(tproxy.analog_clamp_act(z, 4.0).sum(), z)
    zj = jnp.asarray(z.detach().numpy())
    jg = jax.grad(lambda a: jproxy.analog_clamp_act(a, 4.0).sum())(zj)
    np.testing.assert_array_equal(gz.numpy(), np.asarray(jg))
    (ga,) = torch.autograd.grad(tproxy._abs(z).sum(), z)
    ja = jax.grad(lambda a: jnp.abs(a).sum())(zj)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))


# ---------------------------------------------------------------------------
# Random normals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path,shape", [((0,), (300, 301)), ((1, 5, 3, 977), (7, 13))])
def test_normal_matches_jax_random_normal(path, shape):
    """``prng.normal`` against ``jax.random.normal`` of the same key: within
    NORMAL_ULPS float32 ulps everywhere, bitwise for most draws; the CPU
    dispatch of ``ops.normal`` is the plain version."""
    want = np.asarray(jax.random.normal(jkey(path), shape, jnp.float32))
    got = prng.normal(prng.key_of_path(path), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS
    assert np.mean(ulps == 0) > 0.95
    np.testing.assert_array_equal(ops.normal(path, shape, "cpu").numpy(), got)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _fit_inputs(seed, n=20000):
    rnd = np.random.default_rng(seed)
    y = (rnd.standard_normal(n) * 2.0).astype(np.float32)
    r = (0.05 * y - 0.01 * y ** 2 + 0.02 * np.abs(y) * rnd.standard_normal(n)).astype(np.float32)
    return y.reshape(40, -1), r.reshape(40, -1)


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_fit_error_stats_matches_reference(degree):
    """The ridge fit on a strided subsample of at most 8192 of 20000
    points, against the reference's: FIT."""
    y, r = _fit_inputs(degree)
    with jax.disable_jit():
        want = jcal.fit_error_stats(jnp.asarray(y), jnp.asarray(r), degree)
    got = tcal.fit_error_stats(_t(y), _t(r), degree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **FIT)


def _site(seed, degree):
    rnd = np.random.default_rng(seed)
    mean = rnd.standard_normal(degree + 1).astype(np.float32) * 0.05
    var = np.abs(rnd.standard_normal(degree + 1)).astype(np.float32) * 0.01
    return ({"mean": jnp.asarray(mean), "var": jnp.asarray(var), "scale": jnp.float32(2.5)},
            {"mean": _t(mean), "var": _t(var), "scale": torch.tensor(2.5)})


@pytest.mark.parametrize("degree", [0, 3])
def test_sample_error_and_predict_mean_match_reference(degree):
    """``sample_error`` with the same key (the port's key path) and
    ``predict_mean``, against the reference's: F32 (the polynomial's
    multiply-adds and NORMAL_ULPS of noise)."""
    jsite, tsite = _site(degree, degree)
    y = np.random.default_rng(9).standard_normal((3, 5, 40)).astype(np.float32)
    path = (1, 4, 0, 77)
    with jax.disable_jit():
        want = np.asarray(jcal.sample_error(jsite, jnp.asarray(y), jkey(path), 1.5))
        want_mean = np.asarray(jcal.predict_mean(jsite, jnp.asarray(y)))
    got = tcal.sample_error(tsite, _t(y), path, 1.5)
    assert got.dtype == torch.float32 and got.shape == y.shape
    _close(got.numpy(), want)
    _close(tcal.predict_mean(tsite, _t(y)).numpy(), want_mean)


# ---------------------------------------------------------------------------
# The injection paths of one projection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proxy_in_backward", [True, False])
@pytest.mark.parametrize("be", BACKENDS)
def test_model_mode_forward_is_the_emulator_and_backward_the_proxy_vjp(be, proxy_in_backward):
    """MODEL mode's autograd.Function: its forward is bitwise the port's
    emulator on the same draws, and its gradients are ``jax.vjp`` of the
    reference's ``model_mode_matmul`` (the proxy's VJP, or x @ w's with
    ``proxy_in_backward=False``), within F32."""
    x, w, g = _operands(BACKENDS.index(be) + 10 * proxy_in_backward, be)
    ja, ta = _cfgs(be, TMode.MODEL, proxy_in_backward=proxy_in_backward)
    path = (7,)
    rng = functools.partial(ops.sc_draws, path)
    y, dx, dw = _tvjp(lambda a, b: tinj.model_mode_matmul(a, b, ta, rng), x, w, g)
    spec = registry.get(be)
    emulated = spec.emulate(_t(x), _t(w), ta.params_for(TBackend(be)), rng)
    np.testing.assert_array_equal(y, emulated.numpy())
    _, jdx, jdw = _jvp(lambda a, b: jinj.model_mode_matmul(a, b, ja, jkey(path)), x, w, g)
    _close(dx, jdx)
    _close(dw, jdw)


def test_model_mode_without_grad_is_a_plain_emulator_call():
    """Under no_grad (serving) MODEL mode builds no graph."""
    x, w, _ = _operands(3, "analog")
    _, ta = _cfgs("analog", TMode.MODEL)
    tw = _t(w).requires_grad_(True)
    with torch.no_grad():
        y = tinj.model_mode_matmul(_t(x), tw, ta, None)
    assert y.grad_fn is None


@pytest.mark.parametrize("be", APPROX)
def test_inject_mode_matches_reference(be):
    """INJECT: the fast forward plus the error drawn from the site's stats
    with the site's key, against the reference's with the same key (F32);
    the gradient is the fast forward's alone (the error is detached), as
    ``jax.vjp`` of the reference's gives it."""
    x, w, g = _operands(20 + APPROX.index(be), be)
    ja, ta = _cfgs(be, TMode.INJECT, inject_std_scale=0.7)
    degree = tcal.effective_degree(ta, TBackend(be))
    jsite, tsite = _site(be.__len__(), degree)
    path = (1, 3, 0, zlib.crc32(b"mlp_up") & 0x7FFFFFFF)
    want = _jvp(lambda a, b: jinj.inject_mode_matmul(a, b, ja, jsite, jkey(path)), x, w, g)
    got = _tvjp(lambda a, b: tinj.inject_mode_matmul(a, b, ta, tsite, path), x, w, g)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("be", APPROX)
def test_proxy_only_matches_reference(be):
    """PROXY_ONLY: the proxy's value and gradients, F32."""
    x, w, g = _operands(30 + APPROX.index(be), be)
    ja, ta = _cfgs(be, TMode.PROXY_ONLY)
    want = _jvp(lambda a, b: jinj.proxy_only_matmul(a, b, ja), x, w, g)
    got = _tvjp(lambda a, b: tinj.proxy_only_matmul(a, b, ta), x, w, g)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("be", APPROX)
def test_calibrate_matmul_matches_reference(be):
    """One calibration pass: the output is the port's emulator's, bitwise;
    the stats are the reference's fit of the port's residual against the
    port's fast forward (FIT).  Where the emulator is bitwise the
    reference's on these operands (SC on the same draws, approx_mult),
    the whole pass is held against the reference's ``calibrate_matmul``."""
    x, w, _ = _operands(40 + APPROX.index(be), be)
    ja, ta = _cfgs(be, TMode.INJECT)
    path = (2, 9)
    rng = functools.partial(ops.sc_draws, path)
    tp = ta.params_for(TBackend(be))
    y_acc, stats = tinj.calibrate_matmul(_t(x), _t(w), ta, rng)
    spec = registry.get(be)
    np.testing.assert_array_equal(y_acc.numpy(), spec.emulate(_t(x), _t(w), tp, rng).numpy())
    y_fast = spec.fast(_t(x), _t(w), tp)
    degree = jcal.effective_degree(ja, JBackend(be))
    with jax.disable_jit():
        want = jcal.fit_error_stats(jnp.asarray(y_fast.numpy()),
                                    jnp.asarray((y_acc - y_fast).numpy()), degree)
        ref_y, ref_stats = jinj.calibrate_matmul(jnp.asarray(x), jnp.asarray(w), ja, jkey(path))
    for k in want:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(want[k]), **FIT)
    if be in ("sc", "approx_mult"):
        np.testing.assert_array_equal(y_acc.numpy(), np.asarray(ref_y))
        for k in ref_stats:
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(ref_stats[k]), **FIT)


def _count_emulate_calls():
    """Wrap every approximate spec's emulate and fused_emulate through the
    registry's override; returns the call list and a restore function."""
    calls, specs = [], {n: registry.get(n) for n in APPROX}
    for name, spec in specs.items():
        def emulate(x, w, p, rng, _n=name, _s=spec):
            calls.append(_n)
            return _s.emulate(x, w, p, rng)

        def fused(x, w, p, rng, epi, _n=name, _s=spec):
            calls.append(_n)
            return _s.fused_emulate(x, w, p, rng, epi)

        registry.register(dataclasses.replace(spec, emulate=emulate, fused_emulate=fused),
                          override=True)

    def restore():
        for spec in specs.values():
            registry.register(spec, override=True)

    return calls, restore


@pytest.mark.parametrize("be", APPROX)
def test_inject_calls_no_emulator(be):
    """An INJECT projection never calls ``spec.emulate`` (the paper's cheap
    forward); MODEL and calibration passes call it once each."""
    x, w, _ = _operands(50, be)
    calls, restore = _count_emulate_calls()
    try:
        for mode, collect, n in ((TMode.INJECT, False, 0), (TMode.PROXY_ONLY, False, 0),
                                 (TMode.MODEL, False, 1), (TMode.INJECT, True, 1)):
            del calls[:]
            _, ta = _cfgs(be, mode)
            ctx = TCtx(cfg=ta, rng=(3,), collect=collect,
                       calib={"mlp_up": tcal.init_site_for(ta, "mlp_up")})
            y = t_dense(_t(x).requires_grad_(True), _t(w), site="mlp_up", ctx=ctx)
            assert y.shape == (2, 3, 40)
            assert calls == [be] * n, (mode, collect, calls)
    finally:
        restore()
    assert registry.get(be).emulate.__name__.startswith("_emulate")


def test_dense_calibration_pass_matches_reference():
    """dense() in a calibration pass with a heterogeneous map (attention on
    exact, the rest on SC): the exact site carries its previous stats
    through, the SC site is fitted, as in the reference (bitwise outputs,
    FIT stats)."""
    x, w, _ = _operands(60, "sc")
    site_backends = (("attn_*", "exact"),)
    ja, ta = _cfgs("sc", TMode.INJECT, site_backends=site_backends)
    prev_j, prev_t = _site(5, 0)
    jcalib = {"attn_q": prev_j, "mlp_up": jcal.init_site_for(ja, "mlp_up")}
    tcalib = {"attn_q": prev_t, "mlp_up": tcal.init_site_for(ta, "mlp_up")}
    jctx = JCtx(cfg=ja, calib=jcalib, rng=jkey((4,)), collect=True)
    tctx = TCtx(cfg=ta, calib=tcalib, rng=(4,), collect=True)
    for site in ("attn_q", "mlp_up"):
        with jax.disable_jit():
            want = np.asarray(j_dense(jnp.asarray(x), jnp.asarray(w), site=site, ctx=jctx))
        got = t_dense(_t(x), _t(w), site=site, ctx=tctx).numpy()
        if site == "mlp_up":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want)
    assert tctx.collected["attn_q"] is prev_t
    for k in ("mean", "var", "scale"):
        np.testing.assert_allclose(tctx.collected["mlp_up"][k].numpy(),
                                   np.asarray(jctx.collected["mlp_up"][k]), **FIT)
