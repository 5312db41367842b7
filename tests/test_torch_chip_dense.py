"""Chip-aware projections of the port against the JAX reference, on the
CPU: ``calibrate_matmul`` with a chip and the exact-reference fit,
``dense`` with a chip and the online-recalibration correction (composed
and fused), and the MODEL-mode gradient through a chip's perturbation.

The reference runs eagerly (``jax.disable_jit()``, ``REPRO_KERNELS=ref``).
Contracts:

* SC (on the port's own draws, bitwise ``jax.random``'s) and approx_mult:
  the emulated, chip-perturbed and corrected outputs bitwise the
  reference's.
* log_mult and analog: their nominal emulators are held elsewhere
  (``jnp.exp2``'s inexact Mitchell products, ROADMAP section C; analog's
  ADC contract, tests/test_torch_sc_analog.py).  Here the chip and the
  correction are held bitwise on the port's own nominal output: the
  reference's ``apply_chip`` and ``predict_mean`` applied to it give the
  port's bits.
* Fitted stats: ``FIT`` (rtol 1e-4, atol 1e-6), the ridge normal
  equations' sums in another order, as tests/test_torch_train_core.py.
* Gradients: ``F32`` (rtol 2e-5, atol 1e-6 of the largest entry), the
  proxy VJP's matmuls summed in another order, as
  tests/test_torch_train_core.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AnalogParams as JAnalogParams
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainMode as JMode
from repro.core import calibration as jcal
from repro.core import injection as jinj
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.hw import VariationModel as JVariation
from repro.hw import apply_chip as j_apply_chip
from repro.hw import sample_profile as j_sample
from repro_torch.configs.base import AnalogParams
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import calib_from_jax, chip_from_jax
from repro_torch.core import calibration as tcal
from repro_torch.core import injection as tinj
from repro_torch.core import registry
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.hw import apply_chip
from repro_torch.kernels import ops

APPROX = ["sc", "analog", "approx_mult", "log_mult"]
BITWISE_EMULATOR = ("sc", "approx_mult")
FIT = dict(rtol=1e-4, atol=1e-6)
F32 = dict(rtol=2e-5, atol=1e-6)
SITE = "mlp_up"


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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _operands(seed, be, B=2, T=3, N=40):
    K = 24 if be == "sc" else 64  # the reference's SC oracle loops over the ports
    rnd = np.random.default_rng(seed)
    x = rnd.standard_normal((B, T, K)).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * 0.2).astype(np.float32)
    g = rnd.standard_normal((B, T, N)).astype(np.float32)
    return x, w, g


def _cfgs(be, mode):
    analog = dict(array_size=16, adc_bits=4)
    return (JApprox(backend=JBackend(be), mode=JMode(mode.value), analog=JAnalogParams(**analog)),
            TApprox(backend=TBackend(be), mode=mode, analog=AnalogParams(**analog)))


def _chip(seed, scale=3.0):
    """A reference chip, scaled so that the fault families' stuck-at
    columns fire at N=40, and the same chip in the port."""
    jchip = j_sample(jax.random.PRNGKey(seed), JVariation(scale=scale))
    return jchip, chip_from_jax(jax.tree.map(np.asarray, jchip))


def _stats(seed, degree):
    """Correction stats of the given degree, as the reference's and the port's."""
    rnd = np.random.default_rng(seed)
    site = {"mean": (rnd.standard_normal(degree + 1) * 0.05).astype(np.float32),
            "var": np.abs(rnd.standard_normal(degree + 1) * 0.01).astype(np.float32),
            "scale": np.float32(1.0 + rnd.random())}
    return jax.tree.map(jnp.asarray, site), calib_from_jax(site, "cpu")


def _j_chip_and_correct(y, be, jchip, jstats):
    """The reference's composed chip and correction on an emulated output."""
    with jax.disable_jit():
        y = j_apply_chip(jnp.asarray(_np(y)), SITE, be, jchip)
        return np.asarray(y - jcal.predict_mean(jstats, y).astype(y.dtype))


@pytest.mark.parametrize("exact_ref", [False, True])
@pytest.mark.parametrize("be", APPROX)
def test_calibrate_matmul_with_chip(be, exact_ref):
    """The emulated output perturbed by the chip: bitwise the reference's
    ``apply_chip`` of the port's emulation (and the reference's whole pass
    where its emulator is bitwise); the stats the reference's fit of the
    port's residual, against the fast forward or (exact_ref) the exact
    matmul at degree max(degree, 1), within FIT."""
    x, w, _ = _operands(APPROX.index(be) + 10 * exact_ref, be)
    ja, ta = _cfgs(be, TMode.INJECT)
    jchip, tchip = _chip(4)
    path = (2, 9)
    rng = functools.partial(ops.sc_draws, path)
    y, stats = tinj.calibrate_matmul(_t(x), _t(w), ta, rng, site=SITE, chip=tchip,
                                     exact_ref=exact_ref)
    spec = registry.get(be)
    nominal = spec.emulate(_t(x), _t(w), ta.params_for(TBackend(be)), rng)
    np.testing.assert_array_equal(_np(y), _np(apply_chip(nominal, SITE, be, tchip)))
    with jax.disable_jit():
        jy = j_apply_chip(jnp.asarray(_np(nominal)), SITE, be, jchip)
    np.testing.assert_array_equal(_np(y), np.asarray(jy))
    assert not np.array_equal(_np(y), _np(nominal))  # the chip moved it
    degree = jcal.effective_degree(ja, JBackend(be))
    with jax.disable_jit():
        if exact_ref:
            want = jcal.fit_error_stats(jy, jy - jnp.asarray(x) @ jnp.asarray(w), max(degree, 1))
        else:
            jfast = jnp.asarray(_np(spec.fast(_t(x), _t(w), ta.params_for(TBackend(be)))))
            want = jcal.fit_error_stats(jfast, jy - jfast, degree)
        ref_y, ref_stats = jinj.calibrate_matmul(
            jnp.asarray(x), jnp.asarray(w), ja, jkey(path), site=SITE, chip=jchip,
            exact_ref=exact_ref)
    assert stats["mean"].shape[-1] == (max(degree, 1) if exact_ref else degree) + 1
    for k in want:
        np.testing.assert_allclose(_np(stats[k]), np.asarray(want[k]), **FIT)
    if be in BITWISE_EMULATOR:
        np.testing.assert_array_equal(_np(y), np.asarray(ref_y))
        for k in ref_stats:
            np.testing.assert_allclose(_np(stats[k]), np.asarray(ref_stats[k]), **FIT)


@pytest.mark.parametrize("be", APPROX)
def test_dense_with_chip_and_correction_composed(be):
    """dense() in MODEL mode with a chip and the correction (composed):
    the reference's composed chip and correction of the port's emulated
    output, bitwise; the reference's whole eager dense() where its
    emulator is bitwise."""
    x, w, _ = _operands(20 + APPROX.index(be), be)
    ja, ta = _cfgs(be, TMode.MODEL)
    jchip, tchip = _chip(7)
    jstats, tstats = _stats(1, 2)
    ctx = TCtx(cfg=ta, rng=(9,), chip=tchip, correct=True, calib={SITE: tstats})
    got = t_dense(_t(x), _t(w), site=SITE, ctx=ctx)
    nominal = registry.get(be).emulate(_t(x), _t(w), ta.params_for(TBackend(be)),
                                       ctx.site_rng(SITE))
    np.testing.assert_array_equal(_np(got), _j_chip_and_correct(nominal, be, jchip, jstats))
    if be in BITWISE_EMULATOR:
        jctx = JCtx(cfg=ja, rng=jax.random.PRNGKey(9), chip=jchip, correct=True,
                    calib={SITE: jstats})
        with jax.disable_jit():
            want = j_dense(jnp.asarray(x), jnp.asarray(w), site=SITE, ctx=jctx)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("be", APPROX)
def test_dense_fused_equals_composed(be, dtype):
    """The fused path (the chip's terms and the correction as the fused
    kernel's epilogue operands, on the CPU its plain version) gives the
    composed path's bits, with a gain chip, a fault chip, with and
    without the correction."""
    x, w, _ = _operands(30 + APPROX.index(be), be)
    _, ta = _cfgs(be, TMode.MODEL)
    _, tchip = _chip(11, scale=4.0)
    _, tstats = _stats(2, 3)
    for correct in (False, True):
        outs = []
        for fused in (False, True):
            ctx = TCtx(cfg=ta, rng=(3,), fused=fused, chip=tchip, correct=correct,
                       calib={SITE: tstats})
            with torch.no_grad():
                outs.append(t_dense(_t(x, dtype), _t(w, dtype), site=SITE, ctx=ctx))
        assert outs[0].dtype == dtype
        np.testing.assert_array_equal(_np(outs[1]), _np(outs[0]), err_msg=f"correct={correct}")


@pytest.mark.parametrize("be", APPROX)
def test_model_mode_grad_through_chip_matches_jax(be):
    """MODEL mode's gradients through a chip-perturbed dense(): the gain
    multiplies the incoming gradient, the additive terms ride on the
    detached row scale (the reference's stop_gradient), so dx and dw are
    ``jax.vjp``'s within F32."""
    x, w, g = _operands(40 + APPROX.index(be), be)
    ja, ta = _cfgs(be, TMode.MODEL)
    jchip, tchip = _chip(5)
    with jax.disable_jit():
        jctx = JCtx(cfg=ja, rng=jax.random.PRNGKey(6), chip=jchip)
        _, vjp = jax.vjp(lambda a, b: j_dense(a, b, site=SITE, ctx=jctx), jnp.asarray(x),
                         jnp.asarray(w))
        jdx, jdw = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = t_dense(tx, tw, site=SITE, ctx=TCtx(cfg=ta, rng=(6,), chip=tchip))
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    for got, want in ((dx, jdx), (dw, jdw)):
        np.testing.assert_allclose(_np(got), want, rtol=F32["rtol"],
                                   atol=F32["atol"] * max(np.abs(want).max(), 1.0))


def test_chip_terms_made_once_per_ctx():
    """A ctx recombines the chip's terms once per site; a layer's ctx made
    with ``with_calib`` shares them (and the SC draws) with its step."""
    _, ta = _cfgs("analog", TMode.MODEL)
    _, tchip = _chip(3)
    ctx = TCtx(cfg=ta, rng=(1,), chip=tchip)
    a = ctx.chip_terms(SITE, "analog", 40, torch.float32, "cpu")
    lctx = ctx.with_calib({SITE: tcal.init_site(1)})
    assert lctx.chip_terms(SITE, "analog", 40, torch.float32, "cpu")[0] is a[0]
    assert lctx._memo is ctx._memo and lctx.calib is not ctx.calib
    assert TCtx(cfg=ta).chip_terms(SITE, "analog", 40, torch.float32, "cpu") == (None, None)



@pytest.mark.parametrize("with_chip", [False, True])
def test_saturated_sc_correction_matches_reference(with_chip):
    """A site whose SC output saturates (every product stream all ones in
    both polarities, so the two counts cancel), as SC's sites do at full
    width.  The exact-reference fit puts the scale at its 1e-6 floor in
    both packages.  Without a chip the output is 0 everywhere, the fit is
    the constant residual, and the correction is that constant until
    (|y| / 1e-6)**3 leaves float32 and ``0 * inf`` makes it NaN.  With a
    chip the output is the chip's offset on the floored row scale, one
    value ~4e-8: t**1..3 are constant columns, so the higher coefficients
    are ill-conditioned (each package's own fit agrees at the calibration
    outputs, within FIT, not coefficient by coefficient), and at a served
    output of a few units t ~ 1e6 makes the correction ~1e14 in both: the
    overflow that ends in NaN logits downstream.  On the reference's
    stats, the port's corrected outputs are the reference's bits, NaN
    where it is NaN."""
    K, N = 64, 16
    x = np.full((2, K), 1.0, np.float32)
    w = np.sign(np.random.default_rng(8).standard_normal((K, N))).astype(np.float32)
    ja, ta = _cfgs("sc", TMode.INJECT)
    jchip, tchip = _chip(4) if with_chip else (None, None)
    path = (2, 9)
    y, stats = tinj.calibrate_matmul(_t(x), _t(w), ta, functools.partial(ops.sc_draws, path),
                                     site=SITE, chip=tchip, exact_ref=True)
    with jax.disable_jit():
        jy, jstats = jinj.calibrate_matmul(jnp.asarray(x), jnp.asarray(w), ja, jkey(path),
                                           site=SITE, chip=jchip, exact_ref=True)
    np.testing.assert_array_equal(_np(y), np.asarray(jy))
    assert np.abs(np.asarray(jy)).max() < tcal.SCALE_EPS  # saturated
    assert _np(stats["scale"]) == np.asarray(jstats["scale"]) == np.float32(tcal.SCALE_EPS)
    site = calib_from_jax(jax.tree.map(np.asarray, jstats), "cpu")
    np.testing.assert_allclose(_np(tcal.predict_mean(stats, y)),
                               _np(tcal.predict_mean(site, y)), **FIT)
    served = np.array([[0.0, 1e-6, -0.5, 3.0, 4.5, 1e3, 6e6, 7e6, -1e7]], np.float32)
    got = _t(served) - tcal.predict_mean(site, _t(served))
    with jax.disable_jit():
        want = np.asarray(jnp.asarray(served) - jcal.predict_mean(jstats, jnp.asarray(served)))
    np.testing.assert_array_equal(_np(got), want)  # NaN where the reference's is NaN
    if with_chip:
        for st in (stats, site):
            assert abs(float(tcal.predict_mean(st, _t(served[:, 4])))) > 1e12
    else:
        assert not _np(stats["mean"])[1:].any() and not np.asarray(jstats["mean"])[1:].any()
        assert np.isfinite(want[0, :7]).all() and np.isnan(want[0, 7:]).all()


def test_singular_fit_gives_nan_as_reference():
    """Outputs that take three values (-q, 0, q, as an SC site one count
    from saturation) make t and t**3 one column; at 8192 points the ridge
    is below float32's resolution, so the normal equations are singular.
    The reference's ``jnp.linalg.solve`` gives NaN stats; the port gives
    NaN too, and raises nothing."""
    rnd = np.random.default_rng(0)
    y = (rnd.integers(-1, 2, 20000) * 0.25).astype(np.float32)
    r = rnd.standard_normal(20000).astype(np.float32)
    got = tcal.fit_error_stats(_t(y), _t(r), 3)
    with jax.disable_jit():
        want = jcal.fit_error_stats(jnp.asarray(y), jnp.asarray(r), 3)
    for k in ("mean", "var"):
        assert np.isnan(np.asarray(want[k])).all() and np.isnan(_np(got[k])).all(), k
    assert float(got["scale"]) == float(want["scale"]) == 0.25
