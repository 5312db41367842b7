"""The port's stochastic-computing (SC) and analog-array backends against
the JAX reference, on the CPU: kernels K4-K7 (plain versions), the
value-domain code, the emulators, dense(), the smoke model and the
engine.

Inputs are made with numpy from a seed and handed to both frameworks.
The JAX side runs the Pallas kernels in interpret mode or its jnp
oracles (``REPRO_KERNELS=ref``); the port's CPU tensors take the plain
versions.

Random streams.  The reference draws SC's generator sequences inside
``repro.kernels.ops`` with ``jax.random.uniform``.  The port takes them
as tensors, and these tests feed it the JAX draws for the same key path
(:func:`jax_draws`), which documents the path.  The port's own draws
(``repro_torch.kernels.prng``, threefry) are the same bits, so fed or
not, both packages see identical streams (``tests/test_torch_prng.py``).

Contracts:

* SC (K4, K5, emulators, dense): bitwise.  AND, OR and popcount do not
  depend on order, and the value-domain ops are the reference's op for
  op.
* Analog (K6, K7, emulators, dense): the port sums each array's partial
  sum exactly (float64) and quantises as the reference's code reads,
  one rounding per op.  Under jit (Pallas interpret mode, and the
  ``fori_loop`` of the reference's oracle) XLA:CPU folds the ADC's
  ``t / levels * adc_range`` into ``t * (adc_range / levels)``, which
  moves some level values by one float32 ulp, and sums each partial sum
  in float32.  So outputs agree to float32 rounding of the sums of
  levels, except where an exact partial sum lies within 2^-18 adc_range
  of an ADC decision boundary: there they may differ by whole ADC steps
  (``adc_range / levels`` times the prescale), and nowhere else
  (:func:`assert_adc_contract`).
* Model and engine: SC logits allclose ``MODEL_TOL`` and greedy tokens
  equal; analog per projection under the ADC contract (see
  :func:`test_analog_model_sites_match_reference` for why not end to
  end).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import AnalogParams as JAnalogParams
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import SCParams as JSCParams
from repro.configs.base import TrainMode as JMode
from repro.core import backends as jbe
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.kernels import ref as jref
from repro.kernels.analog_matmul import _adc_quantize as j_adc_kernel
from repro.kernels.analog_matmul import analog_matmul as j_analog
from repro.kernels.analog_matmul import analog_matmul_fused as j_analog_fused
from repro.kernels.epilogue import apply_epilogue as j_apply_epilogue
from repro.kernels.sc_matmul import sc_matmul_packed as j_sc
from repro.kernels.sc_matmul import sc_matmul_packed_fused as j_sc_fused
from repro.models import build_model as j_build
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import synthetic_requests as j_requests
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import AnalogParams, SCParams
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import _tensor, params_from_jax
from repro_torch.core import backends as tbe
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.core.registry import concat_planes
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import sc_matmul as _sc
from repro_torch.kernels.analog_matmul import analog_matmul_fused_ref
from repro_torch.kernels.vpu_matmul import int_operand_quantize
from repro_torch.models import build_model as t_build
from repro_torch.runtime.engine import Engine as TEngine
from repro_torch.runtime.engine import synthetic_requests

# Model and engine logits: the model-level tolerance of
# tests/test_torch_model.py (summation order, FMA contraction, libm).
MODEL_TOL = 1e-4
NEAR = 2.0 ** -18  # an ADC decision this close (times adc_range) may flip
SC_BITS = 32
ADC = dict(array_size=128, adc_bits=4, adc_range=4.0)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_draws(path, n_ports, n_bits, device):
    """The reference's SC draws for a key path: ``PRNGKey(path[0])`` with
    ``path[1:]`` folded in, split into (kx, kw), and the uniforms that
    ``repro.kernels.ops.sc_matmul`` takes from them."""
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    kx, kw = jax.random.split(key)
    ux = jax.random.uniform(kx, (1, n_bits), dtype=jnp.float32)
    uw = jax.random.uniform(kw, (n_ports, n_bits), dtype=jnp.float32)
    return _tensor(np.asarray(ux), device), _tensor(np.asarray(uw), device)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _both(a: np.ndarray, dtype: str):
    """One numpy array as (jax, torch) arrays of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, _tensor(np.asarray(j), "cpu")


def _planes(rnd, M, K, N, zero_frac=0.3):
    x = rnd.random((M, 2 * K)).astype(np.float32)
    x[rnd.random(x.shape) < zero_frac] = 0.0
    return x, rnd.random((K, N)).astype(np.float32), rnd.random((K, N)).astype(np.float32)


def _grid(a, bits=8):
    """Unipolar values on a ``bits``-bit grid (what fake_quant_unipolar gives)."""
    levels = (1 << bits) - 1
    return (np.round(a * levels) / levels).astype(np.float32)


def _near_boundary(xcat, planes, array_size, adc_bits, adc_range):
    """[M, N] True where some array's exact partial sum, in any of the
    [2K, N] ``planes``, lies within NEAR * adc_range of an ADC decision."""
    levels = (1 << adc_bits) - 1
    bounds = (np.arange(levels) + 0.5) * adc_range / levels
    x = np.asarray(xcat, np.float64)
    near = np.zeros((x.shape[0], planes[0].shape[1]), bool)
    for w in planes:
        w = np.asarray(w, np.float64)
        for k0 in range(0, x.shape[1], array_size):
            ps = x[:, k0 : k0 + array_size] @ w[k0 : k0 + array_size]
            near |= np.abs(ps[..., None] - bounds).min(-1) <= NEAR * adc_range
    return near


def assert_adc_contract(got, want, near, n_arrays, prescale=1.0, adc_bits=4,
                        adc_range=4.0, rel=2.0 ** -23):
    """Analog outputs against the reference (see module docstring): the
    difference is whole ADC steps plus float32 rounding of the sums of
    levels, and whole steps only where ``near``.  ``rel`` is the output
    dtype's unit roundoff."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    step = adc_range / ((1 << adc_bits) - 1) * abs(prescale)
    d = np.abs(got - want)
    k = np.round(d / step)
    sums = 2 * n_arrays * (n_arrays + 1) * adc_range * 2.0 ** -23 * abs(prescale)
    resid = d - k * step
    assert np.all(np.abs(resid) <= sums + 4 * rel * np.maximum(np.abs(want), np.abs(got)))
    assert not np.any((k > 0) & ~near), "whole-step differences away from ADC boundaries"


# ---------------------------------------------------------------------------
# K4 / K5: SC stream contractions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [32, 64])
def test_sc_pack_streams_bitwise(L):
    """Packing against a shared sequence ([1, L]) and per-row sequences
    ([K, 1, L]): the reference's uint32 words bit for bit."""
    rnd = np.random.default_rng(L)
    p = rnd.random((6, 40)).astype(np.float32)
    p[0, :4] = [0.0, 1.0, 0.5, 0.25]
    u = rnd.random((40, L)).astype(np.float32)
    u[0, :4] = [0.0, 0.5, 0.5, 0.999]  # ties: p > u is strict
    for uu in (u[:1], u[:, None, :]):
        pp = p if uu.ndim == 2 else p.T
        want = np.asarray(jref.sc_pack_streams(jnp.asarray(pp), jnp.asarray(uu))).view(np.int32)
        got = ref.sc_pack_streams(torch.from_numpy(pp), torch.from_numpy(uu)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,K,N,L", [(5, 24, 19, 64), (16, 70, 33, 32)])
def test_k4_bitwise(M, K, N, L):
    """The plain K4 (threshold, pack, contract from the plane halves)
    against the Pallas kernel in interpret mode on the reference's own
    packing; the packed contractions against the reference oracle."""
    rnd = np.random.default_rng(M + K + N)
    x, wa, wb = _planes(rnd, M, K, N)
    ux, uw = rnd.random((1, L)).astype(np.float32), rnd.random((2 * K, L)).astype(np.float32)
    xbits = jref.sc_pack_streams(jnp.asarray(x), jnp.asarray(ux))
    wbits = jref.sc_pack_streams(jnp.concatenate([wa, wb]), jnp.asarray(uw)[:, None, :])
    want = np.asarray(j_sc(xbits, wbits, L, interpret=True, block_m=8, block_n=16, block_k=16))
    t = torch.from_numpy
    got = ops.sc_matmul(t(x), (t(wa), t(wb)), L, (t(ux), t(uw))).numpy()
    np.testing.assert_array_equal(got, want)

    counts = np.asarray(jref.sc_matmul_packed_ref(xbits, wbits))
    tx, tw = t(np.asarray(xbits).view(np.int32)), t(np.asarray(wbits).view(np.int32))
    np.testing.assert_array_equal(ref.sc_matmul_packed_ref(tx, tw).numpy(), counts)
    np.testing.assert_array_equal(ref.sc_matmul_packed_chunked_ref(tx, tw, chunk=7).numpy(), counts)


@pytest.mark.parametrize("out_dtype,case", [("float32", "none"), ("bfloat16", "none"),
                                            ("float32", "all")])
def test_k5_bitwise(out_dtype, case):
    """The plain K5 against the Pallas fused kernel in interpret mode:
    bitwise without epilogue operands.  With them, bitwise to the
    reference composed op by op (the Pallas kernel runs under jit, where
    XLA:CPU contracts the epilogue into FMAs; see
    tests/test_torch_kernels.py::test_k2_fused_f32)."""
    M, K, N = 4, 40, 24
    rnd = np.random.default_rng(len(out_dtype) + len(case))
    x, wa, wb = _planes(rnd, M, K, N)
    ux, uw = rnd.random((1, SC_BITS)).astype(np.float32), rnd.random((2 * K, SC_BITS)).astype(np.float32)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    jpre, tpre = _both(np.float32(0.0371), "bfloat16")
    epi = {} if case == "none" else {
        "colgain": (1.0 + 0.05 * rnd.standard_normal(N)).astype(np.float32),
        "coladd": (0.02 * rnd.standard_normal(N)).astype(np.float32),
        "mean_coeffs": np.asarray([0.01, -0.02, 0.003, -0.0004], np.float32),
        "mean_scale": np.float32(1.7),
    }
    jepi = {k: jnp.asarray(v) for k, v in epi.items()}
    t = torch.from_numpy
    tepi = {k: t(np.asarray(v)) for k, v in epi.items()}
    got = _f32(ops.sc_matmul_fused(t(x), (t(wa), t(wb)), SC_BITS, (t(ux), t(uw)), tpre, tepi,
                                   tdt))

    xbits = jref.sc_pack_streams(jnp.asarray(x), jnp.asarray(ux))
    u = jnp.asarray(uw)[:, None, :]
    wpos = jref.sc_pack_streams(jnp.concatenate([wa, wb]), u)
    wneg = jref.sc_pack_streams(jnp.concatenate([wb, wa]), u)
    if case == "none":
        want = j_sc_fused(xbits, wpos, wneg, SC_BITS, jpre, {}, jdt, interpret=True, block_m=8,
                          block_k=16)
        np.testing.assert_array_equal(got, _f32(want))
    r = (j_sc(xbits, wpos, SC_BITS, interpret=True, block_m=8, block_n=8, block_k=16)
         - j_sc(xbits, wneg, SC_BITS, interpret=True, block_m=8, block_n=8, block_k=16))
    with jax.disable_jit():
        composed = j_apply_epilogue((r * jpre).astype(jdt), **jepi)
    np.testing.assert_array_equal(got, _f32(composed))


# ---------------------------------------------------------------------------
# K6 / K7: analog arrays with ADC partial-sum quantisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adc_bits", [1, 4, 8])
def test_adc_quantize(adc_bits):
    """Bitwise to the reference's quantiser run eagerly, with and without
    its trailing min (a no-op: every level k/L * R is at most R, checked
    over all levels); under jit the same level everywhere and the value
    within one float32 ulp (XLA:CPU folds the constants)."""
    R = 4.0
    levels = (1 << adc_bits) - 1
    bounds = (np.arange(levels) + 0.5) * R / levels
    near = np.concatenate([np.nextafter(bounds, -np.inf), bounds, np.nextafter(bounds, np.inf)])
    ps = np.concatenate([np.linspace(-1, 5, 20001), near]).astype(np.float32)
    got = ref.adc_quantize(torch.from_numpy(ps), adc_bits, R).numpy()
    j = jnp.asarray(ps)
    with jax.disable_jit():
        np.testing.assert_array_equal(got, np.asarray(jref.adc_quantize(j, adc_bits, R)))
        np.testing.assert_array_equal(got, np.asarray(j_adc_kernel(j, adc_bits, R)))
    jitted = np.asarray(jax.jit(lambda v: j_adc_kernel(v, adc_bits, R))(j))
    np.testing.assert_array_equal(np.round(got / R * levels), np.round(jitted / R * levels))
    np.testing.assert_allclose(got, jitted, rtol=2.0 ** -23, atol=0)
    k = torch.arange(levels + 1, dtype=torch.float32)
    top = ref._div(k, levels) * R
    assert bool((top <= R).all()), "a level above adc_range: the trailing min would bite"


@pytest.mark.parametrize("M,K,N", [(5, 96, 19), (4, 200, 40)])
def test_k6_contract(M, K, N):
    """The plain K6 against the Pallas kernel in interpret mode, on
    operands on 8-bit grids (ragged last array when 2K % 128 != 0)."""
    rnd = np.random.default_rng(K)
    x, wa, wb = (_grid(a) for a in _planes(rnd, M, K, N))
    t = torch.from_numpy
    got = ops.analog_matmul(t(x), (t(wa), t(wb)), **ADC).numpy()
    plane = np.concatenate([wa, wb])
    want = np.asarray(j_analog(jnp.asarray(x), jnp.asarray(plane), **ADC, interpret=True,
                               block_m=8, block_n=16))
    n_arrays = -(-2 * K // ADC["array_size"])
    assert_adc_contract(got, want, _near_boundary(x, [plane], **ADC), n_arrays)


@pytest.mark.parametrize("case", ["none", "all"])
def test_k7_contract(case):
    """The plain K7 against the Pallas fused kernel in interpret mode
    without epilogue operands (ADC contract); with them, bitwise to the
    plain K6 of each polarity composed with the epilogue."""
    M, K, N = 4, 130, 24
    rnd = np.random.default_rng(3 + len(case))
    x, wp, wn = (_grid(a) for a in _planes(rnd, M, K, N))
    t = torch.from_numpy
    pre = np.float32(0.8125)
    epi = {} if case == "none" else {
        "colgain": t((1.0 + 0.05 * rnd.standard_normal(N)).astype(np.float32)),
        "coladd": t((0.02 * rnd.standard_normal(N)).astype(np.float32)),
        "mean_coeffs": torch.tensor([0.01, -0.02, 0.003, -0.0004]),
        "mean_scale": torch.tensor(1.7),
    }
    got = ops.analog_matmul_fused(t(x), (t(wp), t(wn)), **ADC, prescale=torch.tensor(pre),
                                  epi=epi, out_dtype=torch.float32).numpy()
    if case == "none":
        pos, neg = np.concatenate([wp, wn]), np.concatenate([wn, wp])
        want = np.asarray(j_analog_fused(
            jnp.asarray(x), jnp.asarray(pos), jnp.asarray(neg), **ADC, prescale=jnp.asarray(pre),
            epi={}, out_dtype=jnp.float32, interpret=True, block_m=8, block_n=8))
        assert_adc_contract(got, want, _near_boundary(x, [pos, neg], **ADC), -(-2 * K // 128),
                            prescale=pre)
    composed = (ops.analog_matmul(t(x), (t(wp), t(wn)), **ADC)
                - ops.analog_matmul(t(x), (t(wn), t(wp)), **ADC))
    want = analog_matmul_fused_ref(t(x), (t(wp), t(wn)), **ADC, prescale=torch.tensor(pre),
                                   epi=epi, out_dtype=torch.float32)
    np.testing.assert_array_equal(got, want.numpy())
    from repro_torch.kernels.epilogue import apply_epilogue

    np.testing.assert_array_equal(got, apply_epilogue(composed * pre, **epi).numpy())


def _emulator_planes(seed, M, K, N):
    """The analog emulator's operands from random bf16 activations and
    fan-in-scaled weights: x [M, 2K] and the halves (wp, wn), bf16."""
    rnd = np.random.default_rng(seed)
    x = torch.from_numpy(rnd.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rnd.standard_normal((K, N)) * K ** -0.5).astype(np.float32))
    xp, xn, wp, wn, pre = tbe._array_planes(x, w.to(torch.bfloat16), AnalogParams())
    return concat_planes(xp, xn), wp, wn, pre


@pytest.mark.parametrize("seed,M,K,N", [(0, 4, 256, 48), (1, 9, 130, 33)])
def test_analog_operands_grid_and_order_free_array_sums(seed, M, K, N):
    """What K7's exactness rests on: every operand the emulator makes is a
    bf16 multiple of 2^-15 in [0, 1], and one array's float64 partial sum
    has the same bits under any order of its ports."""
    x, wp, wn, _ = _emulator_planes(seed, M, K, N)
    for t in (x, wp, wn):
        assert t.dtype == torch.bfloat16
        v = t.double()
        assert bool(((v >= 0) & (v <= 1)).all())
        assert torch.equal(v * 2.0 ** 15, torch.round(v * 2.0 ** 15))
    rnd = np.random.default_rng(seed + 100)
    plane = torch.cat([wp, wn]).double()
    x64 = x.double()
    for c in range(-(-2 * K // 128)):
        ports = np.arange(c * 128, min(2 * K, (c + 1) * 128))
        want = x64[:, ports] @ plane[ports]
        for _ in range(3):
            acc = torch.zeros_like(want)
            for p in rnd.permutation(ports):  # one port at a time
                acc = acc + x64[:, p, None] * plane[p]
            assert torch.equal(acc, want)


def _k7_schedule(x, wp, wn, array_size, adc_bits, adc_range, prescale, out_dtype, upw):
    """K7's schedule in plain torch: each warp streams the rows [r0, r1) of
    its units once, every row r of both halves feeding ports r and r + K of
    both polarities; a finished array's level goes to its slot, the
    straddling array (K not a multiple of array_size) adds its two pieces
    first; the levels add in array order at the end.  The warps run in
    reverse order, as nothing orders them on the card."""
    K, N = wp.shape
    A = array_size
    C = -(-2 * K // A)
    x64, p64, n64 = x.double(), wp.double(), wn.double()
    levels = torch.full((2, C, x.shape[0], N), float("nan"))
    unit_rows = A if K % A == 0 else K
    U = K // unit_rows
    straddle = K % A != 0
    adc = lambda s: ref.adc_quantize(s.to(torch.float32), adc_bits, adc_range)
    for u0 in reversed(range(0, U, upw)):
        r0, r1 = u0 * unit_rows, min(U, u0 + upw) * unit_rows
        sp_t, sn_t, sp_b, sn_b = (torch.zeros_like(levels[0, 0], dtype=torch.float64)
                                  for _ in range(4))
        top_end, bot_end = min(K, (r0 // A + 1) * A), min(K, ((r0 + K) // A + 1) * A - K)
        for r in range(r0, r1):
            xt, xb = x64[:, r, None], x64[:, K + r, None]
            sp_t, sn_t = sp_t + xt * p64[r], sn_t + xt * n64[r]
            sp_b, sn_b = sp_b + xb * n64[r], sn_b + xb * p64[r]
            if r + 1 == bot_end:
                cb = (r + K) // A
                if straddle and cb == K // A:
                    carry = (sp_b, sn_b)
                else:
                    levels[0, cb], levels[1, cb] = adc(sp_b), adc(sn_b)
                sp_b, sn_b = torch.zeros_like(sp_b), torch.zeros_like(sn_b)
                bot_end = min(K, (cb + 2) * A - K)
            if r + 1 == top_end:
                ct = r // A
                if straddle and r + 1 == K:
                    sp_t, sn_t = sp_t + carry[0], sn_t + carry[1]
                levels[0, ct], levels[1, ct] = adc(sp_t), adc(sn_t)
                sp_t, sn_t = torch.zeros_like(sp_t), torch.zeros_like(sn_t)
                top_end = min(K, (ct + 2) * A)
    assert not bool(levels.isnan().any())  # every array of both polarities, once
    sums = torch.zeros((2,) + levels.shape[2:])
    for c in range(C):
        sums = sums + levels[:, c]
    return ((sums[0] - sums[1]) * prescale).to(out_dtype)


@pytest.mark.parametrize("K,array_size,upw", [(256, 128, 1), (256, 64, 3), (130, 128, 1),
                                              (7, 128, 1), (200, 64, 1)])
def test_k7_schedule_matches_plain_version(K, array_size, upw):
    """The kernel's schedule (each weight row read once, whole arrays per
    warp, the straddling array carried, levels added in array order) is
    bitwise the plain K7, for K a multiple of array_size and not."""
    x, wp, wn, pre = _emulator_planes(K, 4, K, 40)
    got = _k7_schedule(x, wp, wn, array_size, 4, 4.0, pre, torch.bfloat16, upw)
    want = analog_matmul_fused_ref(x, (wp, wn), array_size, 4, 4.0, pre, {}, torch.bfloat16)
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Value-domain code
# ---------------------------------------------------------------------------


def test_fake_quant_unipolar_bf16_exhaustive():
    """Every bfloat16 value in [0, 1] (and a float32 sample): bitwise to
    the reference run eagerly.  The reference's straight-through form
    x + (q - x), rounded in bfloat16, equals q for every bfloat16 input
    in [0, 1] at 8 bits (a fact of the reference, held here)."""
    bits = np.arange(0, 0x3F81, dtype=np.uint16)  # +0 .. 1.0
    jx = jnp.asarray(bits.view(jnp.bfloat16))
    tx = _tensor(np.asarray(jx), "cpu")
    with jax.disable_jit():
        want = _f32(jbe.fake_quant_unipolar(jx, 8))
        q = _f32(jnp.round(jx * 255) / 255)
    got = _f32(tbe.fake_quant_unipolar(tx, 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, q)
    f = np.random.default_rng(0).random(1 << 16).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jbe.fake_quant_unipolar(jnp.asarray(f), 8))
    np.testing.assert_array_equal(tbe.fake_quant_unipolar(torch.from_numpy(f), 8).numpy(), want)


def test_value_domain_dtypes_and_bits():
    """bfloat16 operands: ``g / sx``, the planes and ``(sx*sw)/(g*g)`` are
    bfloat16 and ``r * rescale`` float32, as JAX's weak typing makes them,
    and every one is bitwise the reference's run eagerly; the same holds
    for the multiplier-error prescale ``sx*sw / levels^2`` (levels^2 is
    rounded to bfloat16 first, as in the reference)."""
    rnd = np.random.default_rng(7)
    jx, tx = _both(rnd.standard_normal((3, 48)).astype(np.float32) * 2.5, "bfloat16")
    jw, tw = _both(rnd.standard_normal((48, 20)).astype(np.float32) * 0.3, "bfloat16")
    g = 0.25
    with jax.disable_jit():
        sx, sw = jnp.max(jnp.abs(jx)), jnp.max(jnp.abs(jw))
        j_ratio, j_rescale = g / sx, (sx * sw) / (g * g)
        jxp = jnp.clip(jnp.maximum(jx * j_ratio, 0.0), 0.0, 1.0)
        j_an = jbe.fake_quant_unipolar(jnp.maximum(jx / sx, 0.0), 8)
        _, _, j_pre = jbe._int_operand_quantize(jx, jw, 7)
    xp, xn, wp, wn, rescale = tbe._stream_planes(tx, tw, SCParams())
    axp, _, _, _, prescale = tbe._array_planes(tx, tw, AnalogParams())
    _, _, t_pre = int_operand_quantize(tx, tw, 7)
    assert j_ratio.dtype == j_rescale.dtype == jxp.dtype == jnp.bfloat16
    assert rescale.dtype == xp.dtype == wn.dtype == prescale.dtype == torch.bfloat16
    assert (torch.ones(2) * rescale).dtype == torch.float32  # r * rescale
    np.testing.assert_array_equal(_f32(rescale), _f32(j_rescale))
    np.testing.assert_array_equal(_f32(xp), _f32(jxp))
    np.testing.assert_array_equal(_f32(axp), _f32(j_an))
    np.testing.assert_array_equal(_f32(prescale), _f32(sx * sw))
    np.testing.assert_array_equal(_f32(t_pre), _f32(j_pre))


# ---------------------------------------------------------------------------
# Emulators and dense() with the reference's draws fed in
# ---------------------------------------------------------------------------


def _operands(seed, dtype, B=2, T=3, K=72, N=40):
    rnd = np.random.default_rng(seed)
    x = rnd.standard_normal((B, T, K)).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * 0.2).astype(np.float32)
    return _both(x, dtype), _both(w, dtype)


def _emulate_pair(be, fused, jx, tx, jw, tw, seed):
    jfn = {("sc", False): jbe._emulate_sc, ("sc", True): jbe._fused_emulate_sc,
           ("analog", False): jbe._emulate_analog,
           ("analog", True): jbe._fused_emulate_analog}[(be, fused)]
    tfn = {("sc", False): tbe._emulate_sc, ("sc", True): tbe._fused_emulate_sc,
           ("analog", False): tbe._emulate_analog,
           ("analog", True): tbe._fused_emulate_analog}[(be, fused)]
    jp = JSCParams() if be == "sc" else JAnalogParams()
    tp = SCParams() if be == "sc" else AnalogParams()
    extra = ({},) if fused else ()
    with jax.disable_jit():
        want = jfn(jx, jw, jp, jax.random.PRNGKey(seed), *extra)
    got = tfn(tx, tw, tp, functools.partial(jax_draws, (seed,)), *extra)
    return got, want


def _analog_contract_for(tx, tw, got, want, rel):
    """The ADC contract for one analog projection, on the port's planes
    (held bitwise to the reference's by test_value_domain_dtypes_and_bits)."""
    xp, xn, wp, wn, pre = tbe._array_planes(tx, tw, AnalogParams())
    xcat = _f32(concat_planes(xp, xn))
    pos = np.concatenate([_f32(wp), _f32(wn)])
    neg = np.concatenate([_f32(wn), _f32(wp)])
    near = _near_boundary(xcat, [pos, neg], **ADC)
    assert_adc_contract(_f32(got).reshape(near.shape), _f32(want).reshape(near.shape), near,
                        -(-xcat.shape[1] // 128), prescale=float(_f32(pre)), rel=rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("be", ["sc", "analog"])
def test_emulator_matches_reference(be, fused, dtype):
    """``_emulate_*`` and ``_fused_emulate_*`` against the reference's,
    run eagerly with the same key (its draws fed to the port): SC
    bitwise, analog under the ADC contract."""
    # the reference's SC oracle loops over the 2K ports eagerly: fewer ports
    (jx, tx), (jw, tw) = _operands(11 + fused, dtype, K=24 if be == "sc" else 72)
    got, want = _emulate_pair(be, fused, jx, tx, jw, tw, seed=5)
    assert got.dtype == getattr(torch, dtype) and got.shape == tuple(want.shape)
    if be == "sc":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        _analog_contract_for(tx, tw, got, want, 2.0 ** -23 if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("be", ["sc", "analog"])
def test_dense_matches_reference(be, fused):
    """dense() with a bias, through ``ApproxCtx.site_rng``: the port's key
    path (seed, crc32(site)) gives the reference's site key, so SC is
    bitwise; analog under the ADC contract."""
    (jx, tx), (jw, tw) = _operands(3, "float32", K=32 if be == "sc" else 64, N=96)
    b = np.random.default_rng(4).standard_normal(96).astype(np.float32)
    ja = JApprox(backend=JBackend(be), mode=JMode.MODEL)
    ta = TApprox(backend=TBackend(be), mode=TMode.MODEL)
    with jax.disable_jit():
        want = j_dense(jx, jw, jnp.asarray(b), site="mlp_up",
                       ctx=JCtx(cfg=ja, rng=jax.random.PRNGKey(9), fused=fused))
    got = t_dense(tx, tw, torch.from_numpy(b), site="mlp_up",
                  ctx=TCtx(cfg=ta, fused=fused, rng=(9,), draws=jax_draws))
    if be == "sc":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        y = tbe._emulate_analog(tx, tw, AnalogParams(), None)
        with jax.disable_jit():
            wy = jbe._emulate_analog(jx, jw, JAnalogParams(), None)
        _analog_contract_for(tx, tw, y, wy, 2.0 ** -23)
        np.testing.assert_array_equal(_f32(got), _f32(y + torch.from_numpy(b)))


def test_port_draws_are_deterministic_and_statistically_the_reference():
    """Without fed draws the port draws its own sequences, from the key
    path alone: the same path gives the same draws, another path others.
    Over 48 key paths the mean SC output of one projection agrees with
    the reference's mean over 48 keys within 4 standard errors of their
    difference, element by element (3 sigma misses ~1% of 300 outputs)."""
    a = ops.sc_draws((1, 2, 3), 8, 32, "cpu")
    b = ops.sc_draws((1, 2, 3), 8, 32, "cpu")
    c = ops.sc_draws((1, 2, 4), 8, 32, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    assert 0.0 <= float(a[1].min()) and float(a[1].max()) < 1.0

    (jx, tx), (jw, tw) = _operands(21, "float32", B=1, T=6, K=24, N=50)
    n = 48
    port = np.stack([_f32(tbe._emulate_sc(tx, tw, SCParams(),
                                          functools.partial(ops.sc_draws, (s,))))
                     for s in range(n)])
    emulate = jax.jit(lambda key: jbe._emulate_sc(jx, jw, JSCParams(), key))
    refr = np.stack([_f32(emulate(jax.random.PRNGKey(1000 + s))) for s in range(n)])
    se = np.sqrt(port.var(0) / n + refr.var(0) / n) + 1e-6
    z = np.abs(port.mean(0) - refr.mean(0)) / se
    assert np.mean(z < 4.0) >= 0.99, np.sort(z.ravel())[-5:]


# ---------------------------------------------------------------------------
# The smoke model and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_smoke("qwen2.5-3b"), t_smoke("qwen2.5-3b")
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_sc_prefill_and_decode_match_reference(models):
    """SC: prefill's last logits (per-layer keys, the head's key; the
    composed path), then a fused + flash decode step at per-row positions
    (one key per step for every layer), the reference's draws fed in:
    allclose MODEL_TOL against the reference's compiled model."""
    jm, jp, tm, tp = models
    ja = JApprox(backend=JBackend.SC, mode=JMode.MODEL)
    ta = TApprox(backend=TBackend.SC, mode=TMode.MODEL)
    rnd = np.random.default_rng(2)
    B, T, S = 3, 8, 16
    toks = rnd.integers(0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
    lengths = np.asarray([8, 5, 3], np.int32)
    jl, jcache = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lengths), max_seq=S,
                            approx=ja, rng=jax.random.PRNGKey(4))
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks).long(), lengths=torch.from_numpy(lengths),
                            max_seq=S, approx=ta, rng=(4,), draws=jax_draws)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
    nxt = rnd.integers(0, jm.cfg.vocab_size, (B, 1)).astype(np.int32)
    jctx = JCtx(cfg=ja, rng=jax.random.fold_in(jax.random.PRNGKey(4), 1), fused=True)
    tctx = TCtx(cfg=ta, fused=True, rng=(4, 1), draws=jax_draws)
    jl, _ = jm.serve_step(jp, jcache, jnp.asarray(nxt), jnp.asarray(lengths), ctx=jctx,
                          flash=True)
    tl, _ = tm.serve_step(tp, tcache, torch.from_numpy(nxt).long(),
                          torch.from_numpy(lengths), ctx=tctx, flash=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.fixture
def analog_sites(monkeypatch):
    """Record every analog projection the port runs: (x, w, y, fused)."""
    from repro_torch.core import registry

    spec = registry.get("analog")
    seen = []

    def emulate(x, w, p, rng):
        y = spec.emulate(x, w, p, rng)
        seen.append((x, w, y, False))
        return y

    def fused_emulate(x, w, p, rng, epi):
        y = spec.fused_emulate(x, w, p, rng, epi)
        seen.append((x, w, y, True))
        return y

    monkeypatch.setitem(registry._REGISTRY, "analog", dataclasses.replace(
        spec, emulate=emulate, fused_emulate=fused_emulate))
    return seen


def test_analog_model_sites_match_reference(models, analog_sites):
    """Analog through the smoke model: prefill (composed), then a fused
    decode step.  Every analog projection the port runs (7 per layer and
    the head, per call) is held under the ADC contract against the
    reference's compiled emulator on the same operands (whose folded
    constants move operands and levels by an ulp, far inside the
    contract's margin), and the logits are finite and shaped.

    The end-to-end logits are not compared with the reference's: a
    partial sum at an ADC decision boundary flips by a whole step when
    the last bit of any upstream op differs, and the flip moves the
    per-tensor scales of every later layer.  The reference disagrees with
    itself that way: under jit XLA:CPU rewrites the divisions by
    constants of the fake-quantiser and the ADC (``/ 255``, ``/ 15``)
    into multiplications, and on this model only ~7% of the compiled
    prefill's logits agree within 1e-4 with the same function run op by
    op (ROADMAP.md section C)."""
    jm, jp, tm, tp = models
    ta = TApprox(backend=TBackend.ANALOG, mode=TMode.MODEL)
    rnd = np.random.default_rng(5)
    B, T, S = 3, 8, 16
    toks = torch.from_numpy(rnd.integers(0, jm.cfg.vocab_size, (B, T)))
    lengths = torch.tensor([8, 5, 3])
    logits = [tm.prefill(tp, toks, lengths=lengths, max_seq=S, approx=ta)]
    nxt = torch.from_numpy(rnd.integers(0, jm.cfg.vocab_size, (B, 1)))
    logits.append(tm.serve_step(tp, logits[0][1], nxt, lengths, ctx=TCtx(cfg=ta, fused=True),
                                flash=True))
    for out, _ in logits:
        assert out.shape == (B, jm.cfg.vocab_size) and bool(torch.isfinite(out).all())
    n_sites = 7 * jm.cfg.n_layers + 1
    assert [f for *_, f in analog_sites] == [False] * n_sites + [True] * n_sites
    compiled = {
        False: jax.jit(lambda x, w: jbe._emulate_analog(x, w, JAnalogParams(), None)),
        True: jax.jit(lambda x, w: jbe._fused_emulate_analog(x, w, JAnalogParams(), None, {})),
    }
    for x, w, y, fused in analog_sites:
        want = compiled[fused](jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
        _analog_contract_for(x.reshape(-1, x.shape[-1]), w, y.reshape(-1, y.shape[-1]),
                             np.asarray(want).reshape(-1, y.shape[-1]), 2.0 ** -23)


BACKENDS = ("exact", "log_mult", "approx_mult", "sc", "analog")


def test_engine_matches_reference(models):
    """The port's engine with the reference's draws fed in, against the
    reference's engine on the same queue (five backends cycled, 2 slots
    per lane, fused decode): the ticks line up, so every exact, multiplier-error and SC
    request's greedy tokens are equal and its logits allclose MODEL_TOL.
    An analog request gets its tokens and finite logits; its values are
    held per projection by test_analog_model_sites_match_reference (an
    ADC decision at a boundary may flip, see there)."""
    jm, jp, tm, tp = models
    kw = dict(prompt_lens=(3, 8), gen_lens=(2, 4), backends=BACKENDS)
    jq = j_requests(6, jm.cfg.vocab_size, seed=2, **kw)
    tq = synthetic_requests(6, tm.cfg.vocab_size, seed=2, **kw)
    je = JEngine(jm, jp, n_slots=2, max_seq=16, collect_logits=True, fused=True, seed=7)
    te = TEngine(tm, tp, n_slots=2, max_seq=16, collect_logits=True, fused=True, seed=7,
                 device="cpu", draws=jax_draws)
    jr, tr = je.run(jq), te.run(tq)
    assert sorted(tr) == sorted(jr) == list(range(6))
    for rid in jr:
        assert tr[rid]["backend"] == jr[rid]["backend"] == BACKENDS[rid % 5]
        assert len(tr[rid]["tokens"]) == len(jr[rid]["tokens"]) == tq[rid].max_new_tokens
        if tr[rid]["backend"] == "analog":
            assert all(np.isfinite(row).all() for row in tr[rid]["logits"])
            continue
        assert tr[rid]["tokens"] == jr[rid]["tokens"], rid
        for got, want in zip(tr[rid]["logits"], jr[rid]["logits"]):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=MODEL_TOL,
                                       rtol=MODEL_TOL)
    assert te.metrics()["lanes"] == 5


def test_engine_own_draws_are_reproducible(models):
    """Served with the port's own draws, two engines with one seed give
    the same tokens and logits; the SC and analog lanes run no CUDA
    kernel on the CPU."""
    _, _, tm, tp = models
    q = synthetic_requests(4, tm.cfg.vocab_size, seed=3, prompt_lens=(3, 8), gen_lens=(2, 4),
                           backends=("sc", "analog"))
    build.reset_launches()
    runs = [TEngine(tm, tp, n_slots=2, max_seq=16, collect_logits=True, fused=True, seed=5,
                    device="cpu").run(q) for _ in range(2)]
    assert sum(build.LAUNCHES.values()) == 0
    for rid in runs[0]:
        assert runs[0][rid]["tokens"] == runs[1][rid]["tokens"]
        for a, b in zip(runs[0][rid]["logits"], runs[1][rid]["logits"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K5's threshold tables and word build, rendered in plain torch; the draw
# memo of ApproxCtx
# ---------------------------------------------------------------------------


def _stream_words(rows, p):
    """sc_matmul.cu's ``stream_words`` in plain torch: for table rows
    [..., ROW] (int32) and probabilities ``p`` [...], p's bucket entry
    [start, end), c = start plus the bucket's thresholds below p (a prefix
    of them), then the mask pair at c: (word against the row's top
    sequence, word against its bottom one), int32 each."""
    keys = rows[..., :_sc.KEYS].contiguous().view(torch.float32)
    p = p.to(torch.float32)[..., None]
    half = _sc.bucket_of(p)
    words = torch.gather(rows[..., _sc.BUCKETS_AT:_sc.BUCKETS_AT + _sc.BUCKETS // 2], -1,
                         half // 2).to(torch.int64) & 0xFFFFFFFF
    e = (words >> (16 * (half % 2))) & 0xFFFF
    c, end = e & 0xFF, e >> 8
    while True:
        more = (c < end) & (torch.gather(keys, -1, c.clamp(max=_sc.KEYS - 1)) < p)
        if not bool(more.any()):
            break
        c = c + more.to(torch.int64)
    masks = rows[..., _sc.MASKS_AT:_sc.BUCKETS_AT]
    return torch.gather(masks, -1, 2 * c)[..., 0], torch.gather(masks, -1, 2 * c + 1)[..., 0]


def _tied_draws(rnd, K, n_bits):
    """Draws with ties: half the thresholds on a grid of sixteenths (0 and
    1 included), the rest bf16 values, so probabilities can equal them."""
    u = rnd.random((2 * K + 1, n_bits)).astype(np.float32)
    u = np.where(rnd.random(u.shape) < 0.5, np.round(u * 16) / 16,
                 np.asarray(torch.from_numpy(u).to(torch.bfloat16).float())).astype(np.float32)
    u[0, :4] = [0.0, -0.0, 1.0, 0.5]
    return torch.from_numpy(u[-1:]), torch.from_numpy(u[:-1])


def test_sc_table_buckets():
    """Each row's thresholds are sorted (NaN last, -0.0 tied with 0.0), and
    bucket b's entry spans exactly the sorted positions of the thresholds
    in [b / 256, (b + 1) / 256): buckets tile the 64 positions in order."""
    ux, uw = _tied_draws(np.random.default_rng(1), 3, 64)
    uw[1, :3] = torch.tensor([float("nan"), float("inf"), -1.0])
    rows = _sc.sc_tables_ref(ux, uw).reshape(-1, _sc.ROW)
    keys = rows[:, :_sc.KEYS].contiguous().view(torch.float32)
    entries = rows[:, _sc.BUCKETS_AT:_sc.BUCKETS_AT + _sc.BUCKETS // 2].contiguous()
    entries = entries.view(torch.int16).to(torch.int64) & 0xFFFF
    start, end = entries & 0xFF, entries >> 8
    assert torch.equal(start[:, 1:], end[:, :-1])
    assert bool((start[:, 0] == 0).all()) and bool((end[:, -1] == _sc.KEYS).all())
    for row, s, e in zip(keys, start, end):
        finite = row[~torch.isnan(row)]
        assert bool((finite[1:] >= finite[:-1]).all())
        for b in torch.nonzero(e > s).flatten().tolist():
            inside = row[s[b]:e[b]]
            assert bool((torch.where(torch.isnan(inside), _sc.BUCKETS - 1,
                                     _sc.bucket_of(inside)) == b).all())


@pytest.mark.parametrize("n_bits", [32, 64])
def test_sc_table_words_are_p_greater_than_u_for_every_bf16(n_bits):
    """The new table format and word build, as the kernels run them: for
    every bfloat16 bit pattern (all of [0, 1], -0.0, NaN, infinities and
    negatives), against draws with ties, each row's two words are bit for
    bit the packed p > u_j of ports k and k + K, and row K's of ux."""
    K = 3
    ux, uw = _tied_draws(np.random.default_rng(0), K, n_bits)
    p = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    p = p.to(torch.float32)
    tab = _sc.sc_tables_ref(ux, uw).reshape(n_bits // 32, K + 1, _sc.ROW)
    for k in range(K + 1):
        top, bottom = (ux, ux) if k == K else (uw[k:k + 1], uw[K + k:K + k + 1])
        want_t, want_b = ref.sc_pack_streams(p, top), ref.sc_pack_streams(p, bottom)
        for w in range(n_bits // 32):
            got_t, got_b = _stream_words(tab[w, k].expand(p.shape[0], -1), p)
            assert torch.equal(got_t, want_t[:, w]), (k, w)
            assert torch.equal(got_b, want_b[:, w]), (k, w)


def _k5_render(x, wp, wn, ux, uw, n_bits, prescale, out_dtype, splits):
    """K5's contraction as fused_contract runs it: the tables, activation
    words from the activation row, two searches per weight pair giving its
    4 words, K split into ``splits`` ranges ORed together, then
    PlaneDifference's arithmetic (no epilogue)."""
    K, N = wp.shape
    W = n_bits // 32
    tab = _sc.sc_tables_ref(ux, uw).reshape(W, K + 1, _sc.ROW)
    cuts = np.linspace(0, K, splits + 1).astype(int)
    counts = []
    for w in range(W):
        xw = _stream_words(tab[w, K].expand(*x.shape, -1), x)[0]  # [M, 2K]
        acc_p = torch.zeros((x.shape[0], N), dtype=torch.int32)
        acc_n = torch.zeros_like(acc_p)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            part_p, part_n = torch.zeros_like(acc_p), torch.zeros_like(acc_n)
            for k in range(lo, hi):
                at, ab = _stream_words(tab[w, k].expand(N, -1), wp[k])
                bt, bb = _stream_words(tab[w, k].expand(N, -1), wn[k])
                xt, xb = xw[:, k, None], xw[:, k + K, None]
                part_p |= (xt & at) | (xb & bb)
                part_n |= (xt & bt) | (xb & ab)
            acc_p |= part_p
            acc_n |= part_n
        counts.append((ref._popcount(acc_p), ref._popcount(acc_n)))
    cp = sum(c[0] for c in counts).to(torch.float32)
    cn = sum(c[1] for c in counts).to(torch.float32)
    r = ref._div(cp, n_bits) - ref._div(cn, n_bits)
    return (r * prescale).to(out_dtype)


@pytest.mark.parametrize("n_bits,splits,dtype", [(32, 1, torch.bfloat16), (32, 3, torch.bfloat16),
                                                 (64, 2, torch.float32)])
def test_k5_schedule_matches_plain_version(n_bits, splits, dtype):
    """The kernel's arithmetic (merged tables, two searches per weight
    pair for its four words, split K ORed) is bitwise the plain K5, on
    the SC emulator's planes with edge probabilities: 0, -0.0, 1 and
    values equal to a threshold."""
    rnd = np.random.default_rng(n_bits + splits)
    M, K, N = 5, 9, 24
    x = torch.from_numpy(rnd.standard_normal((M, K)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rnd.standard_normal((K, N)) * K ** -0.5).astype(np.float32)).to(dtype)
    xp, xn, wp, wn, pre = tbe._stream_planes(x, w, SCParams(bits=n_bits))
    ux, uw = _tied_draws(rnd, K, n_bits)
    wp, wn, xcat = wp.clone(), wn.clone(), concat_planes(xp, xn).clone()
    wp[0, :6] = torch.tensor([0.0, -0.0, 1.0, 0.5, 0.25, 0.0625])
    wn[1, :3] = uw[1, :3].to(dtype)  # equal to thresholds of port 1
    wn[2, :3] = uw[K + 2, :3].to(dtype)  # and of port K + 2
    xcat[0, :3] = torch.tensor([-0.0, 1.0, 0.0])
    xcat[1, :2] = ux[0, :2].to(dtype)
    got = _k5_render(xcat, wp, wn, ux, uw, n_bits, pre, dtype, splits)
    want = _sc.sc_matmul_fused_ref(xcat, (wp, wn), n_bits, (ux, uw), pre, {}, dtype)
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)


def _sc_decode(tm, tp, cache, nxt, lengths, draws):
    ctx = TCtx(cfg=TApprox(backend=TBackend.SC, mode=TMode.MODEL), fused=True, rng=(4, 1),
               draws=draws)
    cache = {k: v.clone() for k, v in cache.items()}
    return tm.serve_step(tp, cache, nxt, lengths, ctx=ctx, flash=True)[0]


def test_sc_draw_memo_one_draw_per_path_per_decode_step(models, monkeypatch):
    """A decode step with SC on every site draws once per distinct key
    path (7 sites and the LM head: 8), not once per layer, and its logits
    are bitwise those of a step that draws anew at every layer; the JAX
    draws fed in."""
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.kernels.sc_matmul import SCDraws

    _, _, tm, tp = models
    rnd = np.random.default_rng(5)
    toks = torch.from_numpy(rnd.integers(0, tm.cfg.vocab_size, (2, 6))).long()
    lengths = torch.tensor([6, 4])
    _, cache = tm.prefill(tp, toks, lengths=lengths, max_seq=12,
                          approx=TApprox(backend=TBackend.SC, mode=TMode.MODEL), rng=(4,),
                          draws=jax_draws)
    nxt = torch.from_numpy(rnd.integers(0, tm.cfg.vocab_size, (2, 1))).long()
    paths = []

    def counted(path, n_ports, n_bits, device):
        paths.append(path)
        return jax_draws(path, n_ports, n_bits, device)

    memo = _sc_decode(tm, tp, cache, nxt, lengths, counted)
    assert len(paths) == len(set(paths)) == 8
    paths.clear()
    # the ctx without its memo: every projection draws anew
    monkeypatch.setattr(ApproxCtx, "_site_draws",
                        lambda self, path, *shape: SCDraws(*self.draws(path, *shape)))
    fresh = _sc_decode(tm, tp, cache, nxt, lengths, counted)
    assert len(paths) == 7 * tm.cfg.n_layers + 1 and len(set(paths)) == 8
    assert torch.equal(memo, fresh)


def test_sc_draw_memo_prefill_keeps_at_most_its_bound(models):
    """In prefill every layer has its own key paths, so nothing repeats:
    every projection draws, and each layer's ctx keeps its own draws, so
    no more than one layer's 7 are alive at any draw."""
    import weakref

    _, _, tm, tp = models
    alive, peak = [], [0]

    def tracked(path, n_ports, n_bits, device):
        ux, uw = jax_draws(path, n_ports, n_bits, device)
        alive.append(weakref.ref(uw))
        peak[0] = max(peak[0], sum(r() is not None for r in alive))
        return ux, uw

    toks = torch.from_numpy(np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (2, 5)))
    tm.prefill(tp, toks.long(), lengths=torch.tensor([5, 3]), max_seq=8,
               approx=TApprox(backend=TBackend.SC, mode=TMode.MODEL), rng=(4,), draws=tracked)
    assert len(alive) == 7 * tm.cfg.n_layers + 1
    assert peak[0] == 7
