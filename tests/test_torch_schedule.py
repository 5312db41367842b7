"""The port's phase schedule against the JAX reference's, on the CPU:
``Phase`` and its checks, ``parse_phase_specs``, ``parse_site_backends``,
the ``TrainConfig`` schedule fields, ``PhasePlan`` (``from_configs``,
``phase_at``, ``mode_counts``, ``describe``), ``paper_schedule`` and the
``CalibrationController`` fed one loss sequence; the ``StepCache``'s keys
and ``wrap_block``'s policies.

Tolerance: none.  The schedule is plain Python and numpy in both
packages, so every lookup, decision and ``to_tree`` value is equal, and
an input one package refuses the other refuses with the same exception
type.
"""
import dataclasses
import enum

import numpy as np
import pytest
import torch

from repro.configs import base as jb
from repro.core import schedule as js
from repro_torch.configs import base as tb
from repro_torch.core import schedule as ts


def _approx(backend="analog", mode="inject", every=4, sites=()):
    """One ApproxConfig in each package."""
    return tuple(
        m.ApproxConfig(backend=m.Backend(backend), mode=m.TrainMode(mode),
                       analog=m.AnalogParams(array_size=16), calibrate_every=every,
                       site_backends=sites)
        for m in (jb, tb))


def _plain(obj):
    """A Phase (or a tuple of them) as plain values, enums by value."""
    if isinstance(obj, tuple):
        return [_plain(p) for p in obj]
    return {f.name: (v.value if isinstance(v, enum.Enum) else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def _both(fn_j, fn_t):
    """The two packages' results, or their exception types."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            out.append(type(e))
    return out


# ---------------------------------------------------------------------------
# Phase, the spec DSL, the site map, TrainConfig
# ---------------------------------------------------------------------------

PHASES = [
    ("exact", 10, {}),
    ("finetune", 5, {}),
    ("proxy", 3, {"lr_scale": 0.5}),
    ("inject", 8, {"calibrate": "adaptive", "drift_threshold": 0.1, "max_calibrate_every": 9}),
    ("model", 2, {"microbatches": 2, "name": "tail"}),
    ("inject", 4, {"fleet": 3}),
    ("inject", 4, {"backward": "auto", "gate_frac": 0.5, "gate_every": 7}),
    ("inject", 0, {}),
    ("inject", 5, {"lr_scale": 0.0}),
    ("not_a_mode", 5, {}),
    ("inject", 5, {"calibrate": "sometimes"}),
    ("inject", 5, {"backward": "sideways"}),
    ("inject", 5, {"gate_frac": 1.5}),
    ("inject", 5, {"gate_every": 0}),
    ("inject", 5, {"microbatches": -1}),
]


@pytest.mark.parametrize("mode,steps,kw", PHASES)
def test_phase_fields_and_checks_match_reference(mode, steps, kw):
    j, t = _both(lambda: jb.Phase(mode, steps, **kw), lambda: tb.Phase(mode, steps, **kw))
    if isinstance(j, type):
        assert t is j
    else:
        assert _plain(t) == _plain(j)


def test_phase_constructors_and_aliases_match_reference():
    assert {k: v.value for k, v in tb.PHASE_MODE_ALIASES.items()} == \
        {k: v.value for k, v in jb.PHASE_MODE_ALIASES.items()}
    assert [p.value for p in tb.CalibPolicy] == [p.value for p in jb.CalibPolicy]
    for ctor in ("exact", "proxy", "inject", "model"):
        assert _plain(getattr(tb.Phase, ctor)(6)) == _plain(getattr(jb.Phase, ctor)(6))


SPECS = [
    ["exact:10", "inject:40:calib=adaptive,drift=0.1", "model:8:lr=0.5,micro=2"],
    ["inject:12:calib=3", "finetune:4"],
    ["inject:12:every=5", "proxy:2:name=ab"],
    ["inject:6:calib=off", "model:2:fleet=4"],
    ["inject:6:bwd=approx,gate=0.25,gate_every=3"],
    ["inject:6:calib=every_n,every=2,drift=0.3"],
    [],
    ["inject"],
    [":5"],
    ["inject:x"],
    ["inject:5:calib"],
    ["inject:5:calib=sometimes"],
    ["inject:5:colour=red"],
    ["inject:0"],
    ["nope:5"],
]


@pytest.mark.parametrize("specs", SPECS, ids=lambda s: "|".join(s) or "none")
def test_parse_phase_specs_matches_reference(specs):
    j, t = _both(lambda: jb.parse_phase_specs(specs), lambda: tb.parse_phase_specs(specs))
    if isinstance(j, type):
        assert t is j
    else:
        assert _plain(t) == _plain(j)


SITE_SPECS = [
    ["attn_*=sc"],
    ["attn_*=sc", "mlp_down=log_mult", "lm_head=exact"],
    ["nothing_*=analog"],
    ["attn_q"],
    ["=sc"],
    ["attn_q="],
    [],
]


@pytest.mark.parametrize("specs", SITE_SPECS, ids=lambda s: "|".join(s) or "none")
def test_parse_site_backends_matches_reference(specs):
    from repro.models.transformer import ALL_SITES as J_SITES
    from repro_torch.models.transformer import ALL_SITES as T_SITES

    assert T_SITES == J_SITES
    warned = ([], [])
    j, t = _both(
        lambda: jb.parse_site_backends(specs, known_sites=J_SITES, warn=warned[0].append),
        lambda: tb.parse_site_backends(specs, known_sites=T_SITES, warn=warned[1].append))
    assert t == j
    assert warned[1] == warned[0]


def test_train_config_schedule_fields_match_reference():
    jt, tt = jb.TrainConfig(), tb.TrainConfig()
    for f in ("remat", "checkpoint_every", "keep_checkpoints", "phases", "inject_steps",
              "finetune_steps", "microbatches"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert tt.remat == "block"
    for remat in ("none", "full", "block", "group:2"):
        assert tb.TrainConfig(remat=remat).remat == remat
    for bad in ("group", "group:0", "group:x", "blocks", ""):
        with pytest.raises(ValueError):
            tb.TrainConfig(remat=bad)
    for kw in ({"phases": (tb.Phase.inject(3),), "inject_steps": 2},
               {"phases": ("inject:3",)}):
        jkw = dict(kw, phases=tuple(jb.Phase.inject(3) if isinstance(p, tb.Phase) else p
                                    for p in kw["phases"]))
        j, t = _both(lambda: jb.TrainConfig(**jkw), lambda: tb.TrainConfig(**kw))
        assert t is j and isinstance(j, type)


# ---------------------------------------------------------------------------
# PhasePlan and paper_schedule
# ---------------------------------------------------------------------------

PLANS = {
    "explicit": (dict(phases="exact:3|inject:8:calib=adaptive|model:4:lr=0.5"), "analog", "inject"),
    "interleaved": (dict(phases="exact:1|inject:3:calib=2|model:2|inject:1"), "approx_mult",
                    "inject"),
    "legacy": (dict(inject_steps=7, finetune_steps=3), "analog", "inject"),
    "legacy_inject_only": (dict(inject_steps=5), "sc", "inject"),
    "single_inject": (dict(total_steps=9), "analog", "inject"),
    "single_model": (dict(total_steps=6), "log_mult", "model"),
    "inactive": (dict(total_steps=5, inject_steps=3), "exact", "inject"),
    "exact_mode": (dict(total_steps=4), "analog", "no_model"),
}


def _plans(name):
    kw, backend, mode = PLANS[name]
    ja, ta = _approx(backend, mode)
    tkw = dict(kw)
    if "phases" in tkw:
        specs = tkw.pop("phases").split("|")
        jt = jb.TrainConfig(phases=jb.parse_phase_specs(specs), **tkw)
        tt = tb.TrainConfig(phases=tb.parse_phase_specs(specs), **tkw)
    else:
        jt, tt = jb.TrainConfig(**tkw), tb.TrainConfig(**tkw)
    return (js.PhasePlan.from_configs(ja, jt), ts.PhasePlan.from_configs(ta, tt), ja, ta)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_reference(name):
    jp, tp, _, _ = _plans(name)
    assert _plain(tp.phases) == _plain(jp.phases)
    assert tp.total_steps == jp.total_steps
    assert tp.describe() == jp.describe()
    assert tp.mode_counts() == jp.mode_counts()
    assert tp.mode_counts(jp.total_steps + 3) == jp.mode_counts(jp.total_steps + 3)
    assert tp.any_gated_backward == jp.any_gated_backward
    for i in range(len(jp.phases)):
        assert tp.phase_start(i) == jp.phase_start(i)
    for step in range(-1, jp.total_steps + 3):
        a, b = jp.phase_at(step), tp.phase_at(step)
        assert (b.index, _plain(b.phase), b.step_in_phase) == \
            (a.index, _plain(a.phase), a.step_in_phase), step
        assert tp.mode_at(step).value == jp.mode_at(step).value


def test_empty_plan_raises_as_reference():
    j, t = _both(lambda: js.PhasePlan(()), lambda: ts.PhasePlan(()))
    assert t is j is ValueError


PAPER = [
    (10, {}),
    (100, {}),
    (3, {}),
    (37, {"warmup_frac": 0.2, "tail_frac": 0.3, "calibrate": "every_n"}),
    (50, {"drift_threshold": 0.1, "tail_lr_scale": 0.5}),
    (2, {}),
    (100, {"warmup_frac": 0.6, "tail_frac": 0.5}),
]


@pytest.mark.parametrize("total,kw", PAPER)
def test_paper_schedule_matches_reference(total, kw):
    j, t = _both(lambda: js.paper_schedule(total, **kw), lambda: ts.paper_schedule(total, **kw))
    if isinstance(j, type):
        assert t is j
    else:
        assert _plain(t) == _plain(j)
        assert ts.PhasePlan(t).describe() == js.PhasePlan(j).describe()


# ---------------------------------------------------------------------------
# CalibrationController
# ---------------------------------------------------------------------------

LOSSES = {
    "constant": lambda rng, s: 1.0,
    "drifting": lambda rng, s: 1.2 ** s,
    "noisy": lambda rng, s: 2.0 + 0.1 * rng.standard_normal(),
    "nan_first": lambda rng, s: float("nan") if s == 0 else 1.0 + 0.03 * s,
}


def _tree(ctrl):
    """The controller's state, each value's dtype and bytes (nan == nan)."""
    return {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes())
            for k, v in ctrl.to_tree().items()}


@pytest.mark.parametrize("losses", sorted(LOSSES))
@pytest.mark.parametrize("name", ["explicit", "interleaved", "legacy", "single_inject",
                                  "inactive"])
def test_calibration_controller_matches_reference(name, losses):
    """Both controllers, fed one loss sequence (and chip keys -1 and 0),
    decide alike at every step and hold equal state; each package's state
    loads into the other's controller and decides alike from there."""
    jp, tp, ja, ta = _plans(name)
    jc, tc = js.CalibrationController(jp, ja), ts.CalibrationController(tp, ta)
    rng = np.random.default_rng(7)
    decisions = []
    for step in range(jp.total_steps + 2):
        a, b = jc.begin_step(step), tc.begin_step(step)
        assert a == b, step
        if a:
            loss, key = LOSSES[losses](rng, step), (step // 3) % 2 - 1
            jc.record(step, loss, key=key)
            tc.record(step, loss, key=key)
            decisions.append(step)
        assert _tree(tc) == _tree(jc), step
        if step == jp.total_steps // 2:
            jc2, tc2 = js.CalibrationController(jp, ja), ts.CalibrationController(tp, ta)
            jc2.load_tree(tc.to_tree())
            tc2.load_tree(jc.to_tree())
    for step in range(jp.total_steps // 2 + 1, jp.total_steps + 2):
        assert jc2.begin_step(step) == tc2.begin_step(step)
        jc2.record(step, 1.0)
        tc2.record(step, 1.0)
        assert _tree(tc2) == _tree(jc2)
    if name == "inactive":
        assert decisions == []


# ---------------------------------------------------------------------------
# StepCache keys and remat policies
# ---------------------------------------------------------------------------


def test_step_cache_keys_and_refusals():
    """Phases that share (mode, lr scale, microbatches) share one built
    step; a chip-aware step is an entry of its own, one for every chip;
    a switch-aware step is keyed on the canonical config, so every map
    shares it; a backward-gate-aware step is an entry of its own, one for
    every gate; ``stats`` counts built steps only."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.training.steps import StepCache

    _, ta = _approx("approx_mult", "inject")
    cache = StepCache(build_model(get_smoke_config("qwen2.5-3b")), ta, tb.TrainConfig())
    a = cache.train(tb.TrainMode.INJECT)
    assert cache.train(None) is a and cache.train(tb.TrainMode.INJECT, microbatches=1) is a
    assert cache.train(tb.TrainMode.MODEL) is not a
    assert cache.train(tb.TrainMode.INJECT, lr_scale=0.5) is not a
    assert cache.calibration() is cache.calibration()
    assert cache.eval() is cache.eval()
    assert cache.stats() == {"built": 5}
    chip_step = cache.train(tb.TrainMode.MODEL, chip_aware=True)
    assert chip_step is cache.train(tb.TrainMode.MODEL, chip_aware=True)
    assert chip_step is not cache.train(tb.TrainMode.MODEL)
    assert cache.calibration(chip_aware=True) is not cache.calibration()
    assert cache.stats() == {"built": 7}
    # switch-aware steps are keyed on the canonical config: one per mode,
    # whatever the map (the map is the step's backend_idx argument)
    sw = cache.train(tb.TrainMode.MODEL, switch_aware=True)
    assert sw is not cache.train(tb.TrainMode.MODEL)
    other = StepCache(cache.model, dataclasses.replace(ta, site_backends=(("mlp_*", "sc"),)),
                      tb.TrainConfig())
    other._fns = cache._fns  # one store: the canonical keys collide, the static ones do not
    assert other.train(tb.TrainMode.MODEL, switch_aware=True) is sw
    assert other.eval(switch_aware=True) is cache.eval(switch_aware=True)
    assert cache.stats() == {"built": 9}
    # a bwd-aware step is keyed only on taking a gate: exact and gated
    # phases share it
    gated = cache.train(tb.TrainMode.MODEL, bwd_aware=True)
    assert gated is cache.train(tb.TrainMode.MODEL, bwd_aware=True)
    assert gated is not cache.train(tb.TrainMode.MODEL)
    assert cache.stats() == {"built": 10}


def test_wrap_block_policies():
    from repro_torch.core.checkpoint_policy import wrap_block

    fn = lambda x: torch.sin(x) @ torch.ones((3, 2))  # noqa: E731
    assert wrap_block(fn, "none") is fn
    x = torch.linspace(-1, 1, 12).reshape(4, 3).requires_grad_(True)
    want = torch.autograd.grad(fn(x).sum(), x)[0]
    for remat in ("full", "block", "group:4"):
        y = wrap_block(fn, remat)(x)
        assert torch.equal(y, fn(x))
        assert torch.equal(torch.autograd.grad(y.sum(), x)[0], want)
    with torch.no_grad():
        assert torch.equal(wrap_block(fn, "block")(x), fn(x))
    with pytest.raises(ValueError):
        wrap_block(fn, "sometimes")
