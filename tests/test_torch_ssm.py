"""The port's SSM family (``models/ssm.py``, the SSM model, its decode cache
and engine, the tied LM head, the mamba2-130m config) against the JAX
reference on the CPU, at the smoke config (float32, 2 layers, d 64, 4
heads of 32, state 16, chunk 32, vocab 256, tied embeddings).

Weights are the reference's ``init``, carried across with
``repro_torch.convert.params_from_jax``; inputs are made with numpy from a
seed.  The reference runs its jnp oracles (``REPRO_KERNELS=ref``), jitted
where that is its serving path, eagerly where its jit folds analog's
divisions (ROADMAP C).  Tolerances, each named where used:

* ``NORM`` (atol = rtol = 1e-6): ``gated_rmsnorm``.  ``F.silu`` rounds an
  ulp apart from ``jax.nn.silu`` in some elements (measured: 2.4e-7).
* ``CONV`` (atol = rtol = 1e-6): ``_causal_conv``; XLA contracts the
  taps' multiply-adds into FMAs (measured: 2.4e-7).
* ``SSD`` (1e-5 of the largest value, as atol and rtol): ``_ssd_chunked``'s
  output and final state.  The einsums and the cumulative sums of the
  decay add in another order than XLA's dot products and ``cumsum``
  (measured: 2.3e-6 of the largest, 1.3e-4 at values up to 54).
* ``BLOCK`` (1e-5 of the largest value): ``ssm_block`` and
  ``ssm_decode_step`` (the SSD's order, ``softplus``'s ``log1p``, silu;
  the cache's conv window is the in projection's output, whose sums run
  in another order).  The decode step's conv window is bitwise (a shift
  of the window it was given and the step's new row).
* ``MODEL_TOL`` (1e-4): the model-level tolerance of
  tests/test_torch_model.py, for logits and engine logits.  Analog's
  model logits: within MODEL_TOL once whole output steps of the head's ADC
  are taken off, at most ``ADC_FLIPS`` (5%) of them moved (measured: 2.0%
  on mamba's smoke config, 1 or 2 steps each, residue 3e-7): the SSD's
  sums leave the head's operands an ulp apart, which moves ADC decisions
  (ROADMAP C; every projection is still held on its own operands).
* ``LEVEL_MOVES`` (25% of the positions): a multiplier backend's logits
  are held at the positions before the first one of their row where a
  quantisation level of some projection's operand moved between the two
  runs (an operand an ulp apart, e.g. from ``rmsnorm``'s sum, on a level
  boundary of the 7 or 8-bit grid; measured: 1 of 24 positions, from the
  first projection of the hybrid's log_mult run); the moved positions are
  found by recording both runs' operands (``moved_rows``).
* ``LOG_SUM`` (2^-22 of the largest output): a log_mult projection, whose
  reference sums its Mitchell products in float32 in another order at
  fan-ins of 128 (measured: one ulp).
* Every other emulated projection is bitwise the reference's on
  the same operands and key path: SC against the jitted reference,
  approx_mult against the eager one (its jit moves the rescale by an
  ulp); analog under the ADC contract of tests/test_torch_sc_analog.py
  against the eager reference (whole ADC steps only at decision
  boundaries).  The reference's log_mult runs with its ``mitchell_mul``
  given an exact ``exp2`` (XLA:CPU's ``exp2`` is off at some integer
  arguments; ROADMAP C).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_sc_analog as sca
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainMode as JMode
from repro.core import registry as jreg
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.kernels import ref as jref
from repro.launch.dryrun import per_site_macs as j_macs
from repro.models import build_model as j_build
from repro.models import decode as jD
from repro.models import layers as jL
from repro.models import ssm as jS
from repro.runtime.engine import Engine as JEngine
from repro.runtime.engine import synthetic_requests as j_requests
from repro.search import costmodel as jcost
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import _tensor, params_from_jax
from repro_torch.core import backends as tbe
from repro_torch.core import registry as treg
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.kernels import ops as kops
from repro_torch.kernels.vpu_matmul import int_operand_quantize
from repro_torch.launch.dryrun import per_site_macs
from repro_torch.models import build_model as t_build
from repro_torch.models import decode as tD
from repro_torch.models import layers as tL
from repro_torch.models import ssm as tS
from repro_torch.runtime.engine import Engine, synthetic_requests
from repro_torch.search import costmodel

NORM = dict(atol=1e-6, rtol=1e-6)
CONV = dict(atol=1e-6, rtol=1e-6)
SSD = 1e-5
BLOCK = 1e-5
MODEL_TOL = 1e-4
ADC_FLIPS = 0.05
LEVEL_MOVES = 0.25
LOG_SUM = 2.0 ** -22
ARCH = "mamba2-130m"
BACKENDS = ("exact", "approx_mult", "log_mult", "sc", "analog")
EMULATED = BACKENDS[1:]
# the reference's emulators held eagerly: its jit folds analog's divisions
# into multiplications (ROADMAP C) and moves approx_mult's rescale by an ulp
EAGER = ("approx_mult", "analog")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    monkeypatch.delenv("REPRO_SSM_PAD", raising=False)
    monkeypatch.delenv("REPRO_PAD_VOCAB", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def pair(be, **kw):
    if be == "exact":
        return JApprox(**kw), TApprox(**kw)
    return (JApprox(backend=JBackend(be), mode=JMode.MODEL, **kw),
            TApprox(backend=TBackend(be), mode=TMode.MODEL, **kw))


class _ExactExp2:
    """``jax.numpy`` with an exact ``exp2`` of integer-valued floats."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(k):
        return jnp.ldexp(jnp.ones_like(k), k.astype(jnp.int32))


@contextlib.contextmanager
def exact_exp2():
    """The reference's ``mitchell_mul`` with an exact ``exp2`` (the value
    it means): log_mult's projections are then the port's bit for bit."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jref, "jnp", _ExactExp2())
        yield


def jkey(path):
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    return key


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(jnp.asarray(tree).astype(jnp.float32))


def close(got, want, rel, **kw):
    """``got`` within ``rel`` of ``want``, relative and of ``want``'s largest
    magnitude."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()), **kw)


def assert_trees_close(got, want, **tol):
    got, want = numpy_tree(got), numpy_tree(want)
    assert sorted(got) == sorted(want) if isinstance(got, dict) else True
    if isinstance(got, dict):
        for k in got:
            assert_trees_close(got[k], want[k], **tol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


@contextlib.contextmanager
def recorded_projections():
    """Every emulated projection the port runs: (backend, fused, x, w, key
    path, epi, y)."""
    seen, specs = [], {n: treg.get(n) for n in EMULATED}
    for name, spec in specs.items():
        def emulate(x, w, p, rng, _n=name, _s=spec):
            y = _s.emulate(x, w, p, rng)
            seen.append((_n, False, x, w, rng.args[0], None, y))
            return y

        def fused(x, w, p, rng, epi, _n=name, _s=spec):
            y = _s.fused_emulate(x, w, p, rng, epi)
            seen.append((_n, True, x, w, rng.args[0], epi, y))
            return y

        treg.register(dataclasses.replace(spec, emulate=emulate, fused_emulate=fused),
                      override=True)
    try:
        yield seen
    finally:
        for spec in specs.values():
            treg.register(spec, override=True)


@contextlib.contextmanager
def recorded_reference_projections():
    """The operands (backend, x, w) of every emulated projection the
    reference runs, in call order (ordered debug callbacks: jitted calls
    too)."""
    seen, specs = [], {n: jreg.get(n) for n in EMULATED}

    def record(name, x, w):
        jax.debug.callback(lambda a, b: seen.append((name, np.asarray(a), np.asarray(b))), x, w,
                           ordered=True)

    for name, spec in specs.items():
        def emulate(x, w, p, rng, _n=name, _s=spec):
            record(_n, x, w)
            return _s.emulate(x, w, p, rng)

        def fused(x, w, p, rng, epi, _n=name, _s=spec):
            record(_n, x, w)
            return _s.fused_emulate(x, w, p, rng, epi)

        jreg.register(dataclasses.replace(spec, emulate=emulate, fused_emulate=fused),
                      override=True)
    try:
        yield seen
    finally:
        for spec in specs.values():
            jreg.register(spec, override=True)


def moved_rows(seen, ref_seen, ta):
    """Per projection call (the two runs call theirs in one order), the rows
    of its activations [B, T] (or [B, 1]) where a multiplier backend's
    quantisation level of an operand moved between the port's run and the
    reference's: an operand an ulp apart (upstream sums in another order)
    on a level boundary of the 7 or 8-bit grid."""
    assert [(n, tuple(x.shape)) for n, _, x, *_ in seen] == [
        (n, x.shape) for n, x, _ in ref_seen]
    out = []
    for (name, _, x, w, *_), (_, rx, rw) in zip(seen, ref_seen):
        rows = x.shape[:-1]
        if name not in ("approx_mult", "log_mult"):
            out.append(np.zeros(rows, bool))
            continue
        bits = ta.params_for(TBackend(name)).bits
        a = int_operand_quantize(x.reshape(-1, x.shape[-1]), w, bits)[0]
        b = int_operand_quantize(torch.tensor(rx.reshape(-1, rx.shape[-1])), torch.tensor(rw),
                                 bits)[0]
        out.append((a != b).any(-1).numpy().reshape(rows))
    return out


def hold_projections(seen, ja):
    """Each recorded projection bitwise the reference's emulator on the same
    operands and key path (approx_mult eagerly, log_mult with an exact
    exp2); analog's under the ADC contract of tests/test_torch_sc_analog.py
    (whole steps only at decision boundaries: its partial sums of 128
    products round in another order than the reference's eager ones);
    log_mult's within ``LOG_SUM``.  Returns the key paths seen."""
    paths, jitted = [], {}
    for name, fused, x, w, path, epi, y in seen:
        assert not fused or not any(v is not None for v in epi.values())
        spec = jreg.get(name)
        p = ja.params_for(JBackend(name))
        fn = lambda x_, w_, k_, _s=spec, _p=p: _s.emulate(x_, w_, _p, k_)
        xj, wj = jnp.asarray(x.numpy()), jnp.asarray(w.contiguous().numpy())
        if name in EAGER:
            with jax.disable_jit():
                want = fn(xj, wj, jkey(path))
        else:
            with exact_exp2():  # log_mult's exp2, at trace time
                want = jitted.setdefault(name, jax.jit(fn))(xj, wj, jkey(path))
        if name == "analog":
            sca._analog_contract_for(x.reshape(-1, x.shape[-1]), w, y.reshape(-1, y.shape[-1]),
                                     np.asarray(want).reshape(-1, y.shape[-1]), 2.0 ** -23)
        elif name == "log_mult":
            close(y, want, LOG_SUM, err_msg=f"{name} {tuple(x.shape)}x{tuple(w.shape)}")
        else:
            np.testing.assert_array_equal(
                y.numpy(), np.asarray(want), err_msg=f"{name} {tuple(x.shape)}x{tuple(w.shape)}")
        paths.append(path)
    return paths


def models_for(arch, seed=3, **changes):
    """The reference's smoke model of ``arch`` (its config with
    ``changes``), its ``init(seed)``, and the port's model with those
    weights."""
    jm = j_build(dataclasses.replace(j_smoke(arch), **changes))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = t_build(dataclasses.replace(get_smoke_config(arch), **changes))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return models_for(ARCH)


# ---------------------------------------------------------------------------
# Configs and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", (ARCH, "zamba2-1.2b"))
def test_configs_and_counts_match_reference(arch):
    """The full and smoke configs resolve and equal the reference's field
    for field; ``param_count`` (the reference's SSM arithmetic),
    ``is_attention_free``, ``supports_long_context``, the SSM widths,
    ``per_site_macs`` and the search's site universe are the reference's."""
    for get_t, get_j in ((get_config, j_config), (get_smoke_config, j_smoke)):
        t, j = get_t(arch), get_j(arch)
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        val = lambda v: v.value if hasattr(v, "value") else v
        assert {k: val(v) for k, v in tf.items()} == {k: val(v) for k, v in jf.items() if k in tf}
        assert set(jf) - set(tf) == {"frontend", "frontend_tokens"}
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        for attr in ("is_attention_free", "supports_long_context", "ssm_d_inner",
                     "ssm_n_heads"):
            assert getattr(t, attr) == getattr(j, attr), attr
        for T, B in ((1, 1), (16, 2)):
            assert per_site_macs(t, T, B) == j_macs(j, T, B)
        assert costmodel.model_sites(t) == jcost.model_sites(j)


# ---------------------------------------------------------------------------
# The SSM pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_reference(dtype):
    rnd = np.random.default_rng(0)
    x, g = (rnd.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rnd.standard_normal(64)).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = jL.gated_rmsnorm(jnp.asarray(x, jd), jnp.asarray(g, jd), jnp.asarray(w, jd))
    td = getattr(torch, dtype)
    got = tL.gated_rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(g).to(td),
                           torch.from_numpy(w).to(td))
    assert got.dtype == td
    tol = NORM if dtype == "float32" else dict(atol=0.0, rtol=2 ** -7)  # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_causal_conv_matches_reference():
    rnd = np.random.default_rng(1)
    x = rnd.standard_normal((2, 11, 160)).astype(np.float32)
    w = (0.3 * rnd.standard_normal((4, 160))).astype(np.float32)
    b = rnd.standard_normal(160).astype(np.float32)
    want = jS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tS._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV)


def _ssd_inputs(rnd, T, h=4, p=32, n=16):
    x = rnd.standard_normal((2, T, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rnd.standard_normal((2, T, h)))).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    Bm, Cm = (rnd.standard_normal((2, T, n)).astype(np.float32) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("T", [20, 64, 69])
def test_ssd_chunked_matches_reference(T):
    """Chunk 32: one chunk padded (T < chunk, the reference's single-chunk
    branch, its state the chunk state), two whole chunks, and three with
    the last one padded: the output and the final state within SSD."""
    args = _ssd_inputs(np.random.default_rng(T), T)
    jy, js = jax.jit(lambda *a: jS._ssd_chunked(*a, chunk=32))(*map(jnp.asarray, args))
    ty, ts = tS._ssd_chunked(*map(torch.from_numpy, args), chunk=32)
    assert ty.shape == (2, T, 4, 32) and ts.shape == (2, 4, 16, 32)
    close(ty, jy, SSD)
    close(ts, js, SSD)
    assert np.isfinite(ty.numpy()).all() and np.abs(ts.numpy()).max() > 1


def test_ssm_block_padded_mask_and_cache(models):
    """``ssm_block`` on right-padded rows (lengths 37, 30, 5 of 37: the
    padded row's tail is random tokens) with ``return_cache``: the output
    within BLOCK of the reference's, the state and the conv window at each
    row's length too; each row's state and window equal those of the row
    run alone, unpadded (BLOCK), so the padding is not absorbed."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rnd = np.random.default_rng(4)
    x = rnd.standard_normal((3, 37, 64)).astype(np.float32)
    lengths = np.asarray([37, 30, 5])
    mask = np.arange(37)[None, :] < lengths[:, None]
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
    jo, jc = jax.jit(lambda x_, m_: jS.ssm_block(x_, jlayer, jm.cfg, None, mask=m_,
                                                 return_cache=True))(
        jnp.asarray(x), jnp.asarray(mask))
    to, tc = tS.ssm_block(torch.from_numpy(x), tp.layers[0].ssm, cfg, None,
                          mask=torch.from_numpy(mask), return_cache=True)
    for r, n in enumerate(lengths):
        close(to[r, :n], np.asarray(jo)[r, :n], BLOCK)
    close(tc["state"], jc["state"], BLOCK)
    close(tc["conv"], jc["conv"], BLOCK)
    assert tc["state"].dtype == torch.float32 and tc["conv"].shape == (3, 3, 160)
    for r, n in enumerate(lengths):
        _, alone = tS.ssm_block(torch.from_numpy(x[r:r + 1, :n]), tp.layers[0].ssm, cfg, None,
                                return_cache=True)
        close(tc["state"][r], alone["state"][0], BLOCK)
        close(tc["conv"][r], alone["conv"][0], BLOCK)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_reference(models, dtype):
    """Three decode steps from a prefilled cache: output within BLOCK
    (bf16: one bf16 ulp of the output's scale), the state within BLOCK,
    the conv window bitwise; the cache is updated in place.  In bf16 the
    conv's tap sum rounds as XLA's (products in bf16, summed in float32,
    rounded once): the conv output bitwise."""
    jm, jp, tm, tp = models
    cfg = dataclasses.replace(tm.cfg, compute_dtype=dtype)
    jcfg = dataclasses.replace(jm.cfg, compute_dtype=dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rnd = np.random.default_rng(5)
    jlayer = jax.tree.map(lambda a: a[1], jp["layers"]["ssm"])
    # the parameter dtype's tensors in dtype, A_log, D_skip and dt_bias float32
    jlayer = {k: v if k in ("A_log", "D_skip", "dt_bias") else v.astype(jd)
              for k, v in jlayer.items()}
    tlayer = tS.SSM(**{k: _tensor(np.asarray(v), "cpu") for k, v in jlayer.items()})
    jcache = {"state": jnp.asarray(rnd.standard_normal((2, 4, 16, 32)).astype(np.float32)),
              "conv": jnp.asarray(rnd.standard_normal((2, 3, 160)).astype(np.float32)).astype(jd)}
    tcache = {"state": _tensor(np.asarray(jcache["state"]), "cpu"),
              "conv": _tensor(np.asarray(jcache["conv"]), "cpu")}
    step = jax.jit(lambda x_, c_: jS.ssm_decode_step(x_, jlayer, jcfg, None, c_))
    for i in range(3):
        x = rnd.standard_normal((2, 1, 64)).astype(np.float32)
        jo, jcache = step(jnp.asarray(x).astype(jd), jcache)
        state_before = tcache["state"]
        to = tS.ssm_decode_step(torch.from_numpy(x).to(td), tlayer, cfg, None, tcache)
        assert tcache["state"] is state_before  # in place
        rel = BLOCK if dtype == "float32" else 2 ** -7  # bf16: an ulp of the largest
        close(to, jo.astype(jnp.float32), rel, err_msg=f"step {i}")
        close(tcache["state"], jcache["state"], rel, err_msg=f"step {i}")
        np.testing.assert_array_equal(tcache["conv"].float().numpy(),
                                      np.asarray(jcache["conv"].astype(jnp.float32)))
    if dtype == "bfloat16":
        window = rnd.standard_normal((2, 4, 160)).astype(np.float32)
        jw = jnp.asarray(window).astype(jd)
        want = (jw * jlayer["conv_w"]).sum(1) + jlayer["conv_b"]
        got = tS._conv_step(_tensor(np.asarray(jw), "cpu"), tlayer.conv_w, tlayer.conv_b)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jax.jit(lambda: want)().astype(jnp.float32)))


def test_dt_padding_serves_the_same(monkeypatch):
    """``REPRO_SSM_PAD=1`` widens ``in_proj`` by dead dt columns (24 heads
    of mamba2-130m pad to 32; the smoke config's 4 to 32); the mixer reads
    dt as the first H columns of its block, so a converted padded tree
    serves the reference's logits (MODEL_TOL), and the port's own padded
    init has the reference's shapes."""
    monkeypatch.setenv("REPRO_SSM_PAD", "1")
    jm, jp, tm, tp = models_for(ARCH, seed=6)
    d_in, H, _, N, _ = tS._dims(tm.cfg)
    assert tp.layers[0].ssm.in_proj.shape == (64, 2 * d_in + 2 * N + 32)
    assert tS._dt_pad(get_config(ARCH).ssm_n_heads) == 8
    toks = np.random.default_rng(6).integers(0, 256, (2, 9)).astype(np.int32)
    want = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}).logits)(jp, jnp.asarray(toks))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks).long()}, remat="none").logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    own = tm.init(0, device="cpu")
    assert {n: tuple(p.shape) for n, p in own.named_parameters()} == {
        n: tuple(p.shape) for n, p in tp.named_parameters()}


# ---------------------------------------------------------------------------
# The tied LM head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("be", EMULATED)
@pytest.mark.parametrize("fused", [False, True])
def test_tied_head_matches_reference(models, be, fused):
    """mamba's head is the view ``embed.T``: prefill (10 rows) and fused
    decode (4 rows) projections through approx_mult, log_mult, SC and
    analog, bitwise the reference's on ``embed.T`` (analog against its
    eager run, log_mult with an exact ``exp2``), and the weight reaches
    the kernel op as a view of ``embed``, no copy (K1, K2 and K4 read it
    in place; SC's and analog's decode planes, formed in plain torch, are
    row-major [K, N])."""
    jm, jp, tm, tp = models
    ja, ta = pair(be)
    rows = 4 if fused else 10
    x = np.random.default_rng(7 + rows).standard_normal((rows, 64)).astype(np.float32)
    emb = tp.embed
    handed = []

    def spy(name):
        orig = getattr(kops, name)

        def wrapped(*args, **kw):
            handed.append((name, args[1]))
            return orig(*args, **kw)
        return wrapped

    names = ("approx_mult_matmul_quantized", "log_matmul_quantized", "sc_matmul_quantized",
             "sc_matmul_fused", "analog_matmul_fused", "analog_matmul")
    with pytest.MonkeyPatch.context() as mp:
        for n in names:
            mp.setattr(kops, n, spy(n))
        got = t_dense(torch.from_numpy(x), emb.T, site="lm_head",
                      ctx=TCtx(cfg=ta, rng=(3,), fused=fused))
    run = lambda x_, e_: j_dense(x_, e_.T, site="lm_head",
                                 ctx=JCtx(cfg=ja, rng=jax.random.PRNGKey(3), fused=fused))
    xj, ej = jnp.asarray(x), jp["embed"]["tok"]
    if be in EAGER:
        with jax.disable_jit():
            want = run(xj, ej)
    elif be == "log_mult":
        with exact_exp2():
            want = jax.jit(run)(xj, ej)
    else:
        want = jax.jit(run)(xj, ej)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert handed, "no kernel op was handed the head"
    for name, w in handed:
        if name in ("sc_matmul_fused", "analog_matmul_fused", "analog_matmul"):
            assert all(t.is_contiguous() for t in w), name  # the planes, row-major
        else:
            assert w.data_ptr() == emb.data_ptr() and w.shape == (64, 256), name
            assert w.stride() == (1, 64), name  # embed.T itself


# ---------------------------------------------------------------------------
# The model, decode, slot ops and the engine
# ---------------------------------------------------------------------------


def test_params_and_init_layout(models):
    """The converted parameters carry every leaf of the reference's; the
    port's own ``init`` lays them out alike (names, shapes, dtypes, no
    ``lm_head``: tied), ``A_log`` is the reference's bit for bit, and one
    seed gives the same weights, each layer's tensors its own."""
    jm, jp, tm, tp = models
    assert sum(p.numel() for p in tp.parameters()) == sum(
        np.asarray(l).size for l in jax.tree.leaves(jp))
    np.testing.assert_array_equal(tp.layers[1].ssm.in_proj.numpy(),
                                  np.asarray(jp["layers"]["ssm"]["in_proj"][1]))
    own, again = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype) for n, p in tp.named_parameters()}
    assert own.lm_head is None and own.layers[0].ssm.A_log.dtype == torch.float32
    np.testing.assert_array_equal(own.layers[0].ssm.A_log.numpy(),
                                  np.asarray(jp["layers"]["ssm"]["A_log"][0]))
    for (n, a), b in zip(own.named_parameters(), again.parameters()):
        assert torch.equal(a, b), n
    assert not torch.equal(own.layers[0].ssm.out_proj, own.layers[1].ssm.out_proj)


def hold_logits(got, want, be, seen, ta, ref_seen):
    """Logits [B, T, V] within MODEL_TOL of the reference's.  Multiplier
    backends: at every position before the first one of its row where a
    quantisation level moved in some projection (``moved_rows``; attention
    and the SSD carry it to the later positions only), at most
    ``LEVEL_MOVES`` of the positions excluded.  Analog: up to whole output
    steps of the head's ADC (``ADC_FLIPS``)."""
    got, want = got.numpy(), np.asarray(want)
    if be == "analog":
        name, _, x, w, _, _, _ = seen[-1]
        assert name == "analog" and w.shape[-1] == want.shape[-1]  # the head, last
        p = ta.params_for(ta.backend)
        step = p.adc_range / ((1 << p.adc_bits) - 1) * float(tbe._array_planes(x, w, p)[4])
        k = np.round((got - want) / step)
        np.testing.assert_allclose(got - k * step, want, atol=MODEL_TOL, rtol=MODEL_TOL)
        assert (k != 0).mean() <= ADC_FLIPS, (k != 0).mean()
        return
    moved = np.zeros(got.shape[:2], bool)
    for rows in moved_rows(seen, ref_seen, ta):
        moved |= rows
    moved = np.cumsum(moved, axis=1) > 0
    assert moved.mean() <= LEVEL_MOVES, moved.mean()
    np.testing.assert_allclose(got[~moved], want[~moved], atol=MODEL_TOL, rtol=MODEL_TOL)


def reference_logits(jm, jp, ja, be, toks):
    """The reference's MODEL-mode logits of ``toks`` (key ``PRNGKey(2)``;
    analog eagerly, log_mult with the exact ``exp2``) and the operands of
    its emulated projections."""
    run = lambda p, t: jm.apply(p, {"tokens": t}, approx=ja, rng=jax.random.PRNGKey(2)).logits
    with recorded_reference_projections() as ref_seen, exact_exp2():
        if be == "analog":  # its jit folds the divisions (ROADMAP C)
            with jax.disable_jit():
                want = run(jp, jnp.asarray(toks))
        else:
            want = jax.jit(run)(jp, jnp.asarray(toks))
        want = np.asarray(want)
    return want, ref_seen


@pytest.mark.parametrize("be", BACKENDS)
def test_apply_model_matches_reference(models, be):
    """``apply_model`` in MODEL mode on 2 x 12 tokens: logits within
    MODEL_TOL of the reference's (analog: up to whole steps of the head's
    ADC, ``hold_logits``; the reference eager, its jit folds the
    divisions); every emulated projection bitwise the reference's emulator
    on the same operands and key path, layer ``l`` folding ``l`` and the
    head ``2**20``."""
    jm, jp, tm, tp = models
    ja, ta = pair(be)
    toks = np.random.default_rng(8).integers(0, 256, (2, 12)).astype(np.int32)
    want, ref_seen = reference_logits(jm, jp, ja, be, toks)
    with recorded_projections() as seen:
        got = tm.apply(tp, {"tokens": torch.from_numpy(toks).long()}, approx=ta, rng=(2,),
                       remat="none").logits
    hold_logits(got, want, be, seen, ta, ref_seen)
    paths = hold_projections(seen, ja)
    if be != "exact":
        assert len(paths) == 2 * tm.cfg.n_layers + 1
        assert sorted({p[1] for p in paths}) == [0, 1, 2 ** 20]


def test_padded_prefill_then_decode_equals_unpadded_forward(models):
    """A prompt of 5 padded to its bucket of 8 (``lengths``), prefilled into
    a slot, then 4 decode steps: every step's logits within MODEL_TOL of a
    full-sequence forward over the unpadded history, at every position.
    Without the lengths the padded tokens' updates reach the state and the
    first decode step moves (by more than 1e-3)."""
    _, _, tm, tp = models
    rnd = np.random.default_rng(9)
    prompt = rnd.integers(0, 256, 5)
    toks = torch.zeros((1, 8), dtype=torch.long)
    toks[0, :5] = torch.from_numpy(prompt)
    toks[0, 5:] = torch.from_numpy(rnd.integers(1, 256, 3))
    cache = tm.init_cache(2, 16, device="cpu")
    last, sub = tm.prefill(tp, toks, lengths=[5], max_seq=16)
    tm.slot_insert(cache, sub, 1)
    history = list(prompt)
    steps = [last[0]]
    nxt = int(last[0].argmax())
    for i in range(4):
        history.append(nxt)
        tokens = torch.tensor([[0], [nxt]])
        logits, _ = tm.serve_step(tp, cache, tokens, torch.tensor([0, 5 + i], dtype=torch.int32))
        steps.append(logits[1])
        nxt = int(logits[1].argmax())
    full = tm.apply(tp, {"tokens": torch.tensor([history])}, remat="none").logits[0]
    for i, row in enumerate(steps):
        np.testing.assert_allclose(row.numpy(), full[4 + i].numpy(), atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=f"position {4 + i}")
    _, unmasked = tm.prefill(tp, toks, max_seq=16)
    c2 = tm.init_cache(1, 16, device="cpu")
    tm.slot_insert(c2, unmasked, 0)
    bad, _ = tm.serve_step(tp, c2, torch.tensor([[history[5]]]), 5)
    assert float((bad[0] - steps[1]).abs().max()) > 1e-3


def slot_roundtrip(jm, tm, seed):
    """Slot insert, extract, reset and pad against the reference's on one
    random cache of each layout (numpy both sides), and the port's slot
    ops in place."""
    rnd = np.random.default_rng(seed)
    jcfg, tcfg = jm.cfg, tm.cfg
    jcache = jax.tree.map(lambda a: jnp.asarray(rnd.standard_normal(a.shape).astype(np.float32)),
                          jD.init_cache(jcfg, 3, 6))
    tcache = jax.tree.map(lambda a: _tensor(np.asarray(a), "cpu"), jcache)
    jsub = jax.tree.map(lambda a: jnp.asarray(rnd.standard_normal(a.shape).astype(np.float32)),
                        jD.init_cache(jcfg, 1, 6))
    tsub = jax.tree.map(lambda a: _tensor(np.asarray(a), "cpu"), jsub)
    axes = tD.cache_axes(tcfg)
    assert axes == jax.tree.map(int, jD.cache_axes(jcfg))
    ids = {id(t) for t in jax.tree.leaves(tcache)}
    assert tD.slot_insert(tcfg, tcache, tsub, 2) is tcache
    assert {id(t) for t in jax.tree.leaves(tcache)} == ids  # in place
    jcache = jD.slot_insert(jcfg, jcache, jsub, 2)
    assert_trees_close(tcache, jcache, atol=0, rtol=0)
    assert_trees_close(tD.slot_extract(tcfg, tcache, 1, 2), jD.slot_extract(jcfg, jcache, 1, 2),
                       atol=0, rtol=0)
    assert_trees_close(tD.slot_extract(tcfg, tcache, 2), tsub, atol=0, rtol=0)
    tD.slot_reset(tcfg, tcache, 0)
    jcache = jD.slot_reset(jcfg, jcache, 0)
    assert_trees_close(tcache, jcache, atol=0, rtol=0)
    assert_trees_close(tD.pad_cache_to(tcfg, tcache, 9), jD.pad_cache_to(jcfg, jcache, 9),
                       atol=0, rtol=0)
    return tcache


def test_slot_ops_match_reference(models):
    jm, _, tm, _ = models
    cache = slot_roundtrip(jm, tm, 10)
    assert set(cache) == {"state", "conv"} and cache["state"].shape == (2, 3, 4, 16, 32)


def engine_pair(jm, jp, tm, tp, backends, seed=7):
    """The port's engine and the reference's (jitted, log_mult with the
    exact ``exp2``) on one seeded queue, 2 slots a lane, fused decode.
    Every request's greedy tokens equal and every logit row within
    MODEL_TOL, but: an analog request gets its token count and finite
    logits (an ADC decision at a boundary flips end to end; its
    projections are held under the ADC contract by the apply_model
    tests), and a request in whose rows a multiplier's quantisation level
    moved between the two runs (``moved_rows``; the calls are matched to
    requests by the engines' common order) gets its token count and
    finite logits, at most half the requests (measured: 2 of 6, the
    hybrid's log_mult requests)."""
    kw = dict(prompt_lens=(3, 12), gen_lens=(2, 5), backends=backends)
    je = JEngine(jm, jp, n_slots=2, max_seq=24, collect_logits=True, fused=True, seed=seed)
    te = Engine(tm, tp, n_slots=2, max_seq=24, collect_logits=True, fused=True, seed=seed,
                device="cpu")
    n = 2 * len(backends)
    owners = []  # per projection call of the port's engine: {row of its batch: rid}
    admit, decode = te._admit, te._decode_lane

    def own(fn, rows, *args):
        n0 = len(seen)
        out = fn(*args)
        owners.extend([rows] * (len(seen) - n0))
        return out

    te._admit = lambda lane, slot, req, approx: own(admit, {0: req.rid}, lane, slot, req, approx)
    te._decode_lane = lambda lane: own(decode, {i: st.req.rid for i, st in enumerate(lane.slots)
                                                if st is not None}, lane)
    with recorded_reference_projections() as ref_seen, exact_exp2():
        jr = je.run(j_requests(n, 256, seed=2, **kw))
    with recorded_projections() as seen:
        tr = te.run(synthetic_requests(n, 256, seed=2, **kw))
    moved = set()
    for rows, mask in zip(owners, moved_rows(seen, ref_seen, TApprox())):
        moved |= {rows[i] for i in np.flatnonzero(mask.reshape(mask.shape[0], -1).any(-1))
                  if i in rows}
    assert len(moved) <= n // 2, moved
    assert sorted(tr) == sorted(jr) == list(range(n))
    for rid in jr:
        assert tr[rid]["backend"] == jr[rid]["backend"]
        assert len(tr[rid]["tokens"]) == len(jr[rid]["tokens"])
        if tr[rid]["backend"] == "analog" or rid in moved:
            assert all(np.isfinite(row).all() for row in tr[rid]["logits"])
            continue
        assert tr[rid]["tokens"] == jr[rid]["tokens"], rid
        for got, want in zip(tr[rid]["logits"], jr[rid]["logits"]):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=MODEL_TOL,
                                       rtol=MODEL_TOL, err_msg=f"request {rid}")
    assert te.metrics()["lanes"] == len(backends)
    return tr, moved


@pytest.mark.parametrize("backends", [("exact", "approx_mult", "log_mult"), ("sc", "analog")])
def test_engine_matches_reference(models, backends):
    """The port's engine against the reference's on one seeded queue, padded
    bulk prefill (``engine_pair``): the five backends.  Idle slots' SSM
    states evolve as the reference's do."""
    jm, jp, tm, tp = models
    engine_pair(jm, jp, tm, tp, backends)


def test_serve_cli_smoke():
    from repro_torch.launch import serve

    report = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5",
                         "--backends", "exact,log_mult,approx_mult,sc,analog", "--fused",
                         "--prompt-len", "6", "--gen", "3"])
    assert report["requests"] == 5 and report["arch"] == "mamba2-130m-smoke"


# ---------------------------------------------------------------------------
# What this slice refuses
# ---------------------------------------------------------------------------


def check_guards(arch):
    """Training, the Trainer, the search, the sensitivity profile and the
    backward gate, merged and chip-bound engine lanes, and their serve
    flags raise for ``arch``, naming ROADMAP A5."""
    from repro_torch.hw import Fleet
    from repro_torch.launch import serve
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.search import sensitivity
    from repro_torch.training import steps

    tm = t_build(get_smoke_config(arch))
    tp = tm.init(0, device="cpu")
    ta = pair("approx_mult")[1]
    tcfg = TrainConfig()
    batch = {"tokens": np.zeros((2, 8), np.int32), "labels": np.zeros((2, 8), np.int32)}
    for fn in (lambda: steps.make_train_step(tm, ta, tcfg),
               lambda: steps.init_train_state(tm, 0, ta, tcfg, device="cpu"),
               lambda: steps.make_calibration_step(tm, ta, tcfg),
               lambda: steps.make_eval_step(tm, ta),
               lambda: Trainer(tm, ta, tcfg, None, ckpt_dir="/nonexistent", device="cpu"),
               lambda: sensitivity.profile_sensitivity(tm, tp, batch, ta, ["approx_mult"]),
               lambda: sensitivity.backward_gate(tm, tp, batch, ta),
               lambda: Engine(tm, tp, n_slots=1, max_seq=16, switch=True, device="cpu"),
               lambda: Engine(tm, tp, n_slots=1, max_seq=16, fleet=Fleet(2), device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            fn()
    for flag in (["--switch"], ["--fleet", "2"]):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu", *flag])


def test_unported_paths_raise():
    check_guards(ARCH)
