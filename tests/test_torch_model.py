"""The port's dense(), model, decode and serve CLI against the JAX
reference on the CPU (qwen2.5-3b smoke config: float32, 2 layers, d 64).

Inputs and weights are made on the JAX side from a seed and carried
across as numpy (``repro_torch.convert.params_from_jax``).  The JAX side
runs its jnp oracles (``REPRO_KERNELS=ref``); the port's CPU tensors take
the plain versions of its kernels.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainMode as JMode
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.models import build_model as j_build
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.convert import params_from_jax
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.models import build_model as t_build

BACKENDS = ["exact", "log_mult", "approx_mult"]
# Model-level logits: allclose atol=rtol=1e-4 (measured max |diff| ~2.4e-6
# on logits of magnitude ~4).  Layers sum in another order than XLA, XLA
# contracts multiply-adds into FMAs, RoPE's pow/sin/cos come from another
# math library, and any of these can flip one quantisation level of an
# emulated operand.
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _approx(be):
    if be == "exact":
        return JApprox(), TApprox()
    return (JApprox(backend=JBackend(be), mode=JMode.MODEL),
            TApprox(backend=TBackend(be), mode=TMode.MODEL))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("site,bias", [("mlp_gate", False), ("attn_q", True)])
def test_dense_matches_reference(be, fused, site, bias):
    """dense() against the reference's dense() run eagerly (op by op):
    bitwise for approx_mult; log_mult within the reference's exp2 error
    (2^-20 of sum |x_i w_i| scaled back: 2^-20 * K * max|x_row| * max|w|,
    see tests/test_torch_kernels.py), plus one float32 ulp of the output;
    exact allclose 1e-5 (matmul summation order)."""
    rnd = np.random.default_rng(len(site) + 7 * BACKENDS.index(be) + fused)
    x = rnd.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rnd.standard_normal((64, 96)) * 0.125).astype(np.float32)
    b = rnd.standard_normal(96).astype(np.float32) if bias else None
    ja, ta = _approx(be)
    with jax.disable_jit():
        want = np.asarray(j_dense(
            jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
            site=site, ctx=JCtx(cfg=ja, rng=jax.random.PRNGKey(0), fused=fused),
        ))
    got = t_dense(
        torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
        site=site, ctx=TCtx(cfg=ta, fused=fused),
    ).numpy()
    if be == "approx_mult":
        np.testing.assert_array_equal(got, want)
    elif be == "log_mult":
        bound = 2.0 ** -20 * 64 * np.abs(x).max(-1, keepdims=True) * np.abs(w).max()
        assert np.all(np.abs(got - want) <= bound + 2.0 ** -23 * np.abs(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_smoke("qwen2.5-3b"), t_smoke("qwen2.5-3b")
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_params_from_jax_carries_every_leaf(models):
    jm, jp, tm, tp = models
    n_jax = sum(np.asarray(l).size for l in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_jax
    np.testing.assert_array_equal(
        tp.layers[1].attn.wk.numpy(), np.asarray(jp["layers"]["attn"]["wk"][1])
    )
    np.testing.assert_array_equal(tp.lm_head.numpy(), np.asarray(jp["head"]["lm_head"]))


def test_params_from_jax_bfloat16():
    """bfloat16 leaves are reinterpreted bit for bit."""
    a = jnp.asarray(np.random.default_rng(0).standard_normal(8), jnp.bfloat16)
    from repro_torch.convert import _tensor

    t = _tensor(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.to(torch.float32).numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("be", BACKENDS)
def test_prefill_and_decode_match_reference(models, be):
    """Prefill's last logits, then decode steps at per-row positions
    (composed, then fused + flash), against the reference: allclose
    MODEL_TOL; the KV caches agree to the same tolerance."""
    jm, jp, tm, tp = models
    ja, ta = _approx(be)
    rnd = np.random.default_rng(BACKENDS.index(be))
    B, T, S = 3, 8, 16
    toks = rnd.integers(0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
    lengths = np.asarray([8, 5, 3], np.int32)
    jl, jcache = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lengths),
                            max_seq=S, approx=ja)
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks).long(), lengths=torch.from_numpy(lengths),
                            max_seq=S, approx=ta)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
    pos = lengths.copy()
    for fused in (False, True):
        nxt = rnd.integers(0, jm.cfg.vocab_size, (B, 1)).astype(np.int32)
        jctx = None if be == "exact" else JCtx(cfg=ja, rng=jax.random.PRNGKey(0), fused=fused)
        tctx = None if be == "exact" else TCtx(cfg=ta, fused=fused)
        jl, jcache = jm.serve_step(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                                   ctx=jctx, flash=fused)
        tl, tcache = tm.serve_step(tp, tcache, torch.from_numpy(nxt).long(),
                                   torch.from_numpy(pos), ctx=tctx, flash=fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL, rtol=MODEL_TOL)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


def test_padded_vocab_is_sliced(monkeypatch):
    """REPRO_PAD_VOCAB=1 pads the embedding and head to a multiple of 256,
    as in the reference, and logits come back at the true vocab."""
    monkeypatch.setenv("REPRO_PAD_VOCAB", "1")
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), vocab_size=500)
    m = t_build(cfg)
    p = m.init(0, device="cpu")
    assert p.embed.shape[0] == p.lm_head.shape[1] == 512
    last, _ = m.prefill(p, torch.arange(4)[None], max_seq=8)
    logits, _ = m.serve_step(p, m.init_cache(1, 8, device="cpu"), torch.zeros((1, 1), dtype=torch.long), 0)
    assert last.shape == logits.shape == (1, 500)


def test_slot_ops_round_trip(models):
    _, _, tm, tp = models
    cache = tm.init_cache(3, 8, device="cpu")
    _, sub = tm.prefill(tp, torch.arange(5)[None], max_seq=8)
    tm.slot_insert(cache, sub, 1)
    got = tm.slot_extract(cache, 1)
    torch.testing.assert_close(got["k"], sub["k"], rtol=0, atol=0)
    tm.slot_reset(cache, 1)
    assert not cache["k"].any() and not cache["v"].any()


def test_cuda_without_a_card_raises():
    """Entry points default to cuda and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_build(t_smoke("qwen2.5-3b")).init(0)


def test_site_backends_route_per_site():
    """A site map sends matching sites to their backend and leaves the
    rest on the default (exact) path, as in the reference."""
    rnd = np.random.default_rng(5)
    x = torch.from_numpy(rnd.standard_normal((3, 64)).astype(np.float32))
    w = torch.from_numpy(rnd.standard_normal((64, 32)).astype(np.float32))
    cfg = TApprox(mode=TMode.MODEL, site_backends=(("mlp_*", "log_mult"),))
    assert cfg.backend_for("mlp_up") == TBackend.LOG_MULT
    ctx = TCtx(cfg=cfg)
    torch.testing.assert_close(t_dense(x, w, site="attn_q", ctx=ctx), x @ w, rtol=0, atol=0)
    want = t_dense(x, w, site="mlp_up", ctx=TCtx(cfg=_approx("log_mult")[1]))
    torch.testing.assert_close(t_dense(x, w, site="mlp_up", ctx=ctx), want, rtol=0, atol=0)


def test_unported_parts_raise():
    """Archs and training options the port does not run yet raise (every
    backend is ported: sc and analog since the second slice; every train
    mode since the training slice; every remat policy since the Trainer
    slice; calibration against the exact matmul and on a chip since the
    chip-fleet slice; the compressed optimizer state since the approximate
    backward's slice)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import injection, registry

    with pytest.raises(NotImplementedError):
        get_config("yi-6b")
    assert set(registry.names()) == {b.value for b in TBackend}
    assert TrainConfig(optim_compress="bf16").optim_compress == "bf16"  # ported with A6
    with pytest.raises(ValueError, match="optim_compress"):
        TrainConfig(optim_compress="int4")
    with pytest.raises(ValueError):  # every remat policy is ported; a bad name raises
        TrainConfig(remat="blocks")
    x, w = torch.ones((2, 8)), torch.ones((8, 4))
    cfg = TApprox(backend=TBackend.ANALOG, mode=TMode.MODEL)
    _, stats = injection.calibrate_matmul(x, w, cfg, None, exact_ref=True)
    assert stats["mean"].shape == (2,)  # analog's degree 0, floored at 1


def test_serve_cli_batch_is_slots(tmp_path):
    """The reference's hidden ``--batch N`` (the old static driver's flag)
    serves as ``--slots N``."""
    from repro_torch.launch import serve

    out = tmp_path / "serve.json"
    serve.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--requests", "3",
                "--backends", "exact", "--batch", "2", "--gen", "2", "--prompt-len", "4",
                "--out", str(out)])
    import json

    assert json.loads(out.read_text())["n_slots"] == 2


def test_serve_cli_smoke(tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b",
         "--smoke", "--device", "cpu", "--requests", "4",
         "--backends", "exact,log_mult,approx_mult", "--fused", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    import json

    report = json.loads(out.read_text())
    assert report["requests"] == 4
    assert sum(report["per_backend_requests"].values()) == 4
    assert report["device"] == "cpu"
