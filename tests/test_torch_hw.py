"""The port's chip model (``repro_torch.hw``) against the JAX reference's
(``repro.hw``), on the CPU.

Contract: bitwise.  Profiles (every leaf, the drift seed included),
``chip_epilogue``'s vectors for every family, ``apply_chip`` and
``advance`` are the reference's to the bit on the same keys (both draw
with threefry2x32; both run their elementwise ops one at a time, so no
contraction moves a rounding).  ``Fleet`` behaves as the reference's
``tests/test_hw.py`` has it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hw import DriftModel as JDrift
from repro.hw import Fleet as JFleet
from repro.hw import VariationModel as JVariation
from repro.hw import advance as j_advance
from repro.hw import apply_chip as j_apply_chip
from repro.hw import nominal_profile as j_nominal
from repro.hw import sample_profile as j_sample
from repro.hw.variation import chip_epilogue as j_chip_epilogue
from repro_torch.convert import chip_from_jax
from repro_torch.hw import (
    DriftModel,
    Fleet,
    VariationModel,
    advance,
    apply_chip,
    chip_epilogue,
    nominal_profile,
    sample_profile,
)
from repro_torch.kernels import prng

FAMILIES = ("sc", "analog", "approx_mult", "log_mult")
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def assert_profile_equal(got, want):
    """A port profile against a reference one (numpy leaves), leaf by leaf
    and bit for bit, the key as a pair of ints."""
    assert set(got) - {"draws"} == set(want)
    assert got["key"] == tuple(int(v) for v in np.asarray(want["key"]))
    assert got["seed"].dtype == torch.int32 and int(got["seed"]) == int(want["seed"])
    for k in set(want) - {"key", "seed"}:
        if isinstance(want[k], dict):
            sub = want[k]
            flat = {f"{f}.{p}": (got[k][f][p], sub[f][p]) for f in sub for p in sub[f]} \
                if k == "base" else {p: (got[k][p], sub[p]) for p in sub}
        else:
            flat = {k: (got[k], want[k])}
        for name, (g, w) in flat.items():
            assert g.dtype == torch.float32 and g.dim() == 0, (k, name)
            assert np.array_equal(_np(g).view(np.int32), np.asarray(w, np.float32).view(np.int32)), \
                (k, name, float(g), float(w))


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (3, 1.0), (17, 2.5), (2**31 - 1, 0.3),
                                        (123456, 40.0)])
def test_sample_profile_bitwise(seed, scale):
    model = VariationModel().scaled(scale)
    jmodel = JVariation().scaled(scale)
    for i in range(3):
        got = sample_profile(prng.fold_in(prng.prng_key(seed), i), model)
        want = _jtree(j_sample(jax.random.fold_in(jax.random.PRNGKey(seed), i), jmodel))
        assert_profile_equal(got, want)


def test_nominal_profile_bitwise():
    assert_profile_equal(nominal_profile(), _jtree(j_nominal()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [7, 256, 11008, 151936])
def test_chip_epilogue_bitwise(n, dtype):
    """Every family's (colgain, coladd), at a scale large enough that some
    stuck-at columns fire, and on the nominal chip (gain 1, no fault)."""
    jchip = j_sample(jax.random.PRNGKey(5), JVariation(scale=3.0))
    chips = [(chip_from_jax(_jtree(jchip)), jchip), (nominal_profile(), j_nominal())]
    for chip, jc in chips:
        for fam in FAMILIES + ("exact",):
            for site in ("mlp_up", "lm_head"):
                g, a = chip_epilogue(site, fam, chip, n, dtype)
                jg, ja = j_chip_epilogue(site, fam, jc, n, JDTYPE[dtype])
                assert (g is None) == (jg is None) and (a is None) == (ja is None)
                for t, j in ((g, jg), (a, ja)):
                    if t is not None:
                        assert t.dtype == dtype and tuple(t.shape) == np.shape(j)
                        np.testing.assert_array_equal(_np(t), _jnp(j), err_msg=f"{fam} {site}")
    # the draws are made once per (site, width, dtype): a second call reuses them
    chip = chips[0][0]
    before = len(chip["draws"])
    chip_epilogue("mlp_up", "analog", chip, n, dtype)
    assert len(chip["draws"]) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_chip_bitwise(dtype):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((3, 5, 96)).astype(np.float32)
    yt = torch.from_numpy(y).to(dtype)
    yj = jnp.asarray(y).astype(JDTYPE[dtype])
    jchip = j_sample(jax.random.PRNGKey(11), JVariation(scale=4.0))
    chip = chip_from_jax(_jtree(jchip))
    for fam in FAMILIES:
        got = apply_chip(yt, "attn_o", fam, chip)
        want = j_apply_chip(yj, "attn_o", fam, jchip)
        assert got.dtype == dtype
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=fam)
    assert apply_chip(yt, "attn_o", "exact", chip) is yt
    assert apply_chip(yt, "attn_o", "analog", None) is yt


def test_advance_bitwise_and_chunking():
    model = DriftModel(gain_walk_std=0.2, offset_walk_std=0.1, temp_cycle_amp=0.02,
                       temp_cycle_period=700, fault_growth=0.01)
    jmodel = JDrift(gain_walk_std=0.2, offset_walk_std=0.1, temp_cycle_amp=0.02,
                    temp_cycle_period=700, fault_growth=0.01)
    jchip = j_sample(jax.random.PRNGKey(9))
    chip = sample_profile(prng.prng_key(9))
    one = advance(chip, 2500, model)
    assert_profile_equal(one, _jtree(j_advance(jchip, 2500, jmodel)))
    chunked = chip
    for tokens in (7, 493, 1000, 900, 100):  # crosses kilotoken buckets
        chunked = advance(chunked, tokens, model)
    assert_profile_equal(chunked, _jtree(j_advance(jchip, 2500, jmodel)))
    assert float(one["analog"]["gain"]) != float(chip["analog"]["gain"])
    assert chunked["draws"] is chip["draws"]  # the per-column draws live as long as the chip
    assert advance(chip, 0, model) is chip and advance(chip, 10, None) is chip
    aged = advance(chip, 10_000_000, DriftModel(fault_growth=1.0))
    assert float(aged["log_mult"]["fault_rate"]) == 0.5


def test_fleet_matches_reference():
    f = Fleet(4, seed=11, variation=VariationModel(scale=2.0))
    jf = JFleet(4, seed=11, variation=JVariation(scale=2.0))
    for i in range(4):
        assert_profile_equal(f.chip(i), _jtree(jf.chip(i)))
        assert f.chip_for_step(i + 8) is f.chip(i)
    assert Fleet(4, seed=11, variation=VariationModel(scale=2.0)).chip(2)["key"] == f.chip(2)["key"]
    assert Fleet(4, seed=12).chip(0)["key"] != f.chip(0)["key"]
    sub = Fleet.of([f.chip(i) for i in (1, 3)])
    assert len(sub) == 2 and sub.chip(1) is f.chip(3) and sub.calibrated_ids() == ()
    with pytest.raises(ValueError, match="at least one chip"):
        Fleet.of([])
    with pytest.raises(ValueError):
        Fleet(0)


def test_fleet_counters_retirement_and_calib():
    fleet = Fleet(3, seed=0)
    assert fleet.note_tokens(0, 5) == 5.0 and fleet.note_tokens(0, 7) == 12.0
    assert fleet.tokens_served(0) == 12.0 and fleet.tokens_served(1) == 0.0
    with pytest.raises(IndexError):
        fleet.note_tokens(9, 1)
    fleet.note_tokens(1, 100)
    entry = fleet.retire(1, reason="slo")
    assert entry["chip"] == 1 and entry["reason"] == "slo" and entry["tokens_served"] == 100.0
    assert fleet.is_retired(1) and fleet.active_ids() == (0, 2)
    assert fleet.retire(1, reason="other") is entry
    assert [e["chip"] for e in fleet.retirement_log()] == [1]
    assert fleet.calib_for(0) is None
    assert fleet.calib_for(0, init=lambda: {"x": 1}) == {"x": 1}
    with pytest.raises(IndexError):
        fleet.set_calib(7, {})


def test_fleet_mean_calib_matches_reference():
    """The tree mean over calibrated chips, the reference's to the bit on
    nested stats."""
    rng = np.random.default_rng(3)
    trees = [{"layers": {"attn_q": {"mean": rng.standard_normal((2, 4)).astype(np.float32),
                                    "scale": rng.random(2).astype(np.float32)}},
              "head": {"lm_head": {"mean": rng.standard_normal(4).astype(np.float32)}}}
             for _ in range(3)]
    f, jf = Fleet(3, seed=0), JFleet(3, seed=0)
    assert f.mean_calib() is None
    for i, t in enumerate(trees):
        f.set_calib(i, jax.tree.map(torch.from_numpy, t))
        jf.set_calib(i, jax.tree.map(jnp.asarray, t))
        got, want = f.mean_calib(), jax.tree.map(np.asarray, jf.mean_calib())
        jax.tree.map(lambda g, w: np.testing.assert_array_equal(g.numpy(), w), got, want)
    assert f.calibrated_ids() == (0, 1, 2)


@pytest.mark.parametrize("seed,shape", [(0, (1_000_000,)), (7, (300, 301))])
def test_normal_bitwise_on_cpu(seed, shape):
    """The plain ``prng.normal`` on the CPU (the chips' spread patterns, and
    INJECT's noise there) is ``jax.random.normal``'s to the bit: its
    ``log1p`` is XLA:CPU's (``prng.xla_log1p``) and its square root
    correctly rounded."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    x = -np.linspace(0.0, 0.999, 4099, dtype=np.float32) ** 2
    np.testing.assert_array_equal(prng.xla_log1p(torch.from_numpy(x)).numpy().view(np.int32),
                                  np.asarray(jax.jit(jnp.log1p)(x)).view(np.int32))
