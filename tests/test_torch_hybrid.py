"""The port's HYBRID family (zamba2-style: groups of mamba layers with one
shared attention+MLP block applied after each group, and a tail) against
the JAX reference on the CPU: zamba2-1.2b's smoke config (float32, d 64,
4 heads, shared block every 2 mamba layers) at 5 layers, so the layout
has 2 groups of 2 and a tail of 1 (the smoke config's own 4 layers have
no tail; it is served by the CLI test).

Weights are the reference's ``init``, carried across with
``repro_torch.convert.params_from_jax``; inputs are made with numpy from a
seed; the reference runs its jnp oracles (``REPRO_KERNELS=ref``).  The
tolerances and the per-projection holds are those of
tests/test_torch_ssm.py (``MODEL_TOL``, ``ADC_FLIPS``, bitwise
projections, analog's ADC contract), named there with their measured
reasons.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_ssm as ssm_test
import torch

from repro.core import switch as jsw
from repro_torch.core import switch as tsw
from repro_torch.models import ssm as tS
from repro_torch.models.transformer import Block, hybrid_layout

ARCH = "zamba2-1.2b"
MODEL_TOL = ssm_test.MODEL_TOL
BACKENDS = ssm_test.BACKENDS
_env = ssm_test._env


@pytest.fixture(scope="module")
def models():
    return ssm_test.models_for(ARCH, seed=4, n_layers=5)


def test_layout_and_init(models):
    """``hybrid_layout`` (2 groups of 2, a tail of 1); the converted
    parameters carry every leaf of the reference's, the groups, the shared
    block and the tail in place; the port's own ``init`` has the same
    names, shapes and dtypes, one seed the same weights, and each mamba
    layer its own; ``named_paths`` lays the names out as the reference's
    tree (``layers`` [G, k, ...], ``shared``, ``tail`` [t, ...])."""
    from repro_torch.convert import named_layout, named_to_jax

    jm, jp, tm, tp = models
    assert hybrid_layout(tm.cfg) == (2, 2, 1)
    assert sum(p.numel() for p in tp.parameters()) == sum(
        np.asarray(l).size for l in jax.tree.leaves(jp))
    assert isinstance(tp.shared, Block) and len(tp.layers) == 2 and len(tp.tail) == 1
    np.testing.assert_array_equal(tp.layers[1][0].ssm.in_proj.numpy(),
                                  np.asarray(jp["layers"]["ssm"]["in_proj"][1, 0]))
    np.testing.assert_array_equal(tp.tail[0].ssm.out_proj.numpy(),
                                  np.asarray(jp["tail"]["ssm"]["out_proj"][0]))
    np.testing.assert_array_equal(tp.shared.mlp.w_down.numpy(),
                                  np.asarray(jp["shared"]["mlp"]["w_down"]))
    own, again = tm.init(0, device="cpu"), tm.init(0, device="cpu")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype) for n, p in tp.named_parameters()}
    for (n, a), b in zip(own.named_parameters(), again.parameters()):
        assert torch.equal(a, b), n
    blocks = [b for g in own.layers for b in g] + list(own.tail)
    assert len({bytes(b.ssm.in_proj.numpy()) for b in blocks}) == 5
    back = named_to_jax(dict(tp.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert named_layout(dict(tp.named_parameters()))["layers"]["ln1"].shape == (2, 2, 64)


@pytest.mark.parametrize("be", BACKENDS)
def test_apply_model_matches_reference(models, be):
    """``apply_model`` in MODEL mode on 2 x 12 tokens: logits within
    MODEL_TOL of the reference's (analog: whole steps of the head's ADC
    off, ``ssm_test.hold_logits``); every emulated projection held against
    the reference's emulator on the same operands and key path, the key
    paths those of the reference's scans: group g's mamba layer j folds
    ``g (k + 1) + j``, its shared block ``g (k + 1) + k``, tail layer j
    ``G (k + 1) + j``, the head ``2**20``."""
    jm, jp, tm, tp = models
    ja, ta = ssm_test.pair(be)
    toks = np.random.default_rng(8).integers(0, 256, (2, 12)).astype(np.int32)
    want, ref_seen = ssm_test.reference_logits(jm, jp, ja, be, toks)
    with ssm_test.recorded_projections() as seen:
        got = tm.apply(tp, {"tokens": torch.from_numpy(toks).long()}, approx=ta, rng=(2,),
                       remat="none").logits
    ssm_test.hold_logits(got, want, be, seen, ta, ref_seen)
    paths = ssm_test.hold_projections(seen, ja)
    if be != "exact":
        folds = [p[1] for p in paths]
        ssm_fold = lambda f: [f, f]
        want_folds = (ssm_fold(0) + ssm_fold(1) + [2] * 7 + ssm_fold(3) + ssm_fold(4) + [5] * 7
                      + ssm_fold(6) + [2 ** 20])
        assert folds == want_folds


def test_calibration_pass_layout_matches_reference(models):
    """A calibration pass (approx_mult, ``collect``): the stats laid out as
    the reference's (``layers`` [G, k, ...], ``shared`` [G, ...] one set
    per application, ``tail`` [t, ...], ``head``), each leaf within
    MODEL_TOL of its largest value; ``init_calibration`` has the same
    tree."""
    jm, jp, tm, tp = models
    ja, ta = ssm_test.pair("approx_mult")
    toks = np.random.default_rng(9).integers(0, 256, (2, 8)).astype(np.int32)
    jcol = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}, approx=ja, collect=True,
                                         rng=jax.random.PRNGKey(1)).collected)(
        jp, jnp.asarray(toks))
    tcol = tm.apply(tp, {"tokens": torch.from_numpy(toks).long()}, approx=ta, collect=True,
                    rng=(1,), remat="none").collected
    want = jax.tree_util.tree_leaves_with_path(jcol)
    got = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), tcol)))
    assert set(got) == {kp for kp, _ in want}
    for kp, w in want:
        w = np.asarray(w)
        np.testing.assert_allclose(got[kp], w, rtol=MODEL_TOL,
                                   atol=MODEL_TOL * max(np.abs(w).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(kp))
    assert tcol["layers"]["ssm_in"]["scale"].shape == (2, 2)
    assert tcol["shared"]["attn_q"]["scale"].shape == (2,)
    init = tm.init_calibration(ta, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, init)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, tcol))


def test_padded_prefill_then_decode_equals_unpadded_forward(models):
    """A prompt of 6 padded to 8 and prefilled into slot 0 of 2, then 4
    decode steps (the shared block's attention over the cache of each
    group, K3's plain version): every step's logits within MODEL_TOL of a
    full-sequence forward over the unpadded history."""
    _, _, tm, tp = models
    rnd = np.random.default_rng(11)
    prompt = rnd.integers(0, 256, 6)
    toks = torch.zeros((1, 8), dtype=torch.long)
    toks[0, :6] = torch.from_numpy(prompt)
    toks[0, 6:] = torch.from_numpy(rnd.integers(1, 256, 2))
    cache = tm.init_cache(2, 16, device="cpu")
    last, sub = tm.prefill(tp, toks, lengths=[6], max_seq=16)
    tm.slot_insert(cache, sub, 0)
    history, steps = list(prompt), [last[0]]
    nxt = int(last[0].argmax())
    for i in range(4):
        history.append(nxt)
        logits, _ = tm.serve_step(tp, cache, torch.tensor([[nxt], [0]]),
                                  torch.tensor([6 + i, 0], dtype=torch.int32), flash=True)
        steps.append(logits[0])
        nxt = int(logits[0].argmax())
    full = tm.apply(tp, {"tokens": torch.tensor([history])}, remat="none").logits[0]
    for i, row in enumerate(steps):
        np.testing.assert_allclose(row.numpy(), full[5 + i].numpy(), atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=f"position {5 + i}")


def test_slot_ops_match_reference(models):
    """Insert, extract, reset and pad on the hybrid cache, whose slot axis
    is 2 in ``mamba`` ([G, k, B, ...]) and 1 in ``shared`` and ``tail``:
    the reference's results, in place."""
    jm, _, tm, _ = models
    cache = ssm_test.slot_roundtrip(jm, tm, 12)
    assert set(cache) == {"mamba", "shared", "tail"}
    assert cache["mamba"]["state"].shape == (2, 2, 3, 4, 16, 32)
    assert cache["shared"]["k"].shape == (2, 3, 6, 4, 16)


@pytest.mark.parametrize("backends", [("exact", "approx_mult", "log_mult"), ("sc", "analog")])
def test_engine_matches_reference(models, backends):
    """The port's engine against the reference's on one seeded queue
    (``ssm_test.engine_pair``): fused decode (K3's plain version in the
    shared block), padded bulk prefill, the five backends."""
    jm, jp, tm, tp = models
    ssm_test.engine_pair(jm, jp, tm, tp, backends)


def test_model_indices_and_switch_dispatch(models):
    """``model_indices`` for HYBRID equals the reference's (``layers`` [G, k,
    S], ``shared`` [G, S], ``tail`` [t, S]; layer maps group-major then the
    tail; masks and sub-tables).  Per-part switch dispatch: a uniform index
    tree is bitwise static dispatch; a tree whose mamba layers, shared block
    and tail run other backends equals the reference's apply on the same
    tree (MODEL_TOL)."""
    jm, jp, tm, tp = models
    ja, ta = ssm_test.pair("approx_mult")
    lm = [None] * 5
    lm[1] = (("ssm_*", "sc"),)
    lm[4] = (("ssm_out", "log_mult"),)
    for kw in (dict(), dict(layer_maps=lm), dict(mask_sites=("ssm_in",)),
               dict(layer_maps=lm, table=("exact", "approx_mult", "log_mult", "sc"))):
        got, want = tsw.model_indices(tm.cfg, ta, **kw), jsw.model_indices(jm.cfg, ja, **kw)
        assert sorted(got) == sorted(want) == ["head", "layers", "shared", "tail"]
        for k in got:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    toks = np.random.default_rng(13).integers(0, 256, (2, 8)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    canon = tsw.canonical(ta)
    static = tm.apply(tp, {"tokens": tt}, approx=ta, rng=(3,), remat="none").logits
    switched = tm.apply(tp, {"tokens": tt}, approx=canon, rng=(3,), remat="none",
                        backend_idx=tsw.model_indices(tm.cfg, ta)).logits
    assert torch.equal(static, switched)
    idx = tsw.model_indices(tm.cfg, ta, layer_maps=lm)
    idx["shared"][1] = tsw.site_indices(ssm_test.pair("sc")[1])
    jidx = jax.tree.map(jnp.asarray, idx)
    with ssm_test.exact_exp2():
        want = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}, approx=jsw.canonical(ja),
                                             rng=jax.random.PRNGKey(3), backend_idx=jidx).logits)(
            jp, jnp.asarray(toks))
    got = tm.apply(tp, {"tokens": tt}, approx=canon, rng=(3,), remat="none",
                   backend_idx=idx).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=MODEL_TOL)
    assert not torch.equal(got, static)


def test_serve_cli_smoke():
    """The smoke config itself (4 layers: 2 groups, no tail) served by the
    CLI on the five backends."""
    from repro_torch.launch import serve

    report = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5",
                         "--backends", "exact,log_mult,approx_mult,sc,analog", "--fused",
                         "--prompt-len", "6", "--gen", "3"])
    assert report["requests"] == 5 and report["arch"] == "zamba2-1.2b-smoke"
    assert tS.SSM_SITES == ("ssm_in", "ssm_out")


def test_unported_paths_raise():
    ssm_test.check_guards(ARCH)
