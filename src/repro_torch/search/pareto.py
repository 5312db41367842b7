"""Pareto search over site->backend assignments (port of
``repro.search.pareto``).

Strategy (every score through one shared ``CompiledFnCache``):

1. **Seeds** — the all-exact map and one uniform map per candidate
   backend (the baselines the searched map must beat).
2. **Greedy ratchet** — from all-exact, apply the sensitivity profile's
   best remaining energy-saving move (most energy saved per unit of
   swap-one-site hardware-loss hurt) one at a time, scoring each
   cumulative map: a ladder of heterogeneous maps down the energy axis.
3. **Mutations** — seeded random single-site flips of pool members
   (biased toward the current front).
4. Optional **recovery fine-tune**: a candidate fine-tuned for a few steps
   (INJECT with calibration, then a MODEL tail) before it is scored, on a
   copy of the parameters.

The result is the evaluated pool, its non-dominated (energy, hw-eval loss)
front, and a budget query: the best map under X% of the all-exact energy,
monotone in X.  Assignments are emitted as ``site=backend`` specs that
round-trip through ``parse_site_backends`` and feed every
``--site-backend`` flag unchanged.

With a :class:`repro_torch.hw.Fleet`, each map's ``loss`` is the mean
bit-accurate eval loss over the sampled device instances and
``loss_worst`` the worst chip.  ``measured=`` prices MACs with measured
per-backend numbers (``costmodel.load_measured_energy``).
"""
from __future__ import annotations

import copy
import dataclasses
import fnmatch
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
from repro_torch.models.model import Model
from repro_torch.search import costmodel
from repro_torch.search.sensitivity import (
    SensitivityProfile,
    check_searchable,
    eval_loss,
    fleet_eval_losses,
    profile_sensitivity,
)
from repro_torch.training.steps import (
    CompiledFnCache,
    init_train_state,
    make_calibration_step,
    make_train_step,
)

Assignment = Tuple[Tuple[str, str], ...]  # ((site, backend-name), ...) sorted


def normalize_assignment(pairs) -> Assignment:
    """Sorted, deduped (last entry per site wins), exact-entries-dropped
    canonical form (the pool dedup key)."""
    d: Dict[str, str] = {}
    for s, b in pairs:
        d[str(s)] = str(b)
    return tuple(
        sorted((s, b) for s, b in d.items() if b != Backend.EXACT.value)
    )


def expand_pins(pinned, sites) -> Assignment:
    """Resolve fnmatch-pattern pins (the ``--site-backend`` form) into
    literal per-site entries over ``sites`` — first pattern wins, exactly
    like ``ApproxConfig.backend_for``.  Literal pins pass through; an
    ``exact`` pin resolves to pinning the site exact (the site is then
    excluded from search moves but carries no spec entry)."""
    out = []
    for site in sites:
        for pattern, backend in pinned:
            if fnmatch.fnmatchcase(site, pattern):
                out.append((site, str(backend)))
                break
    return tuple(out)


def spec_of(assignment: Assignment) -> Tuple[str, ...]:
    """``site=backend`` strings — the ``--site-backend`` flag values.
    Site names are fnmatch-literal, so the spec round-trips through
    ``parse_site_backends`` exactly."""
    return tuple(f"{site}={backend}" for site, backend in assignment)


@dataclasses.dataclass(frozen=True)
class Candidate:
    assignment: Assignment
    energy: float            # joules-equivalents of one forward pass
    loss: float              # hardware-eval loss; with a fleet: the MEAN
                             # over the sampled device instances
    origin: str = "seed"     # exact | uniform:<b> | ratchet | mutation
    recovered: bool = False  # scored after a recovery fine-tune?
    loss_worst: float = float("nan")  # fleet worst-case; == loss nominal

    def __post_init__(self):
        if math.isnan(self.loss_worst):
            object.__setattr__(self, "loss_worst", self.loss)

    @property
    def backends_used(self) -> Tuple[str, ...]:
        return tuple(sorted({b for _, b in self.assignment}))

    def heterogeneous(self, n_sites: int) -> bool:
        """More than one distinct hardware target across the model's
        sites (exact counts when any site is left unassigned)."""
        used = set(self.backends_used)
        if len(self.assignment) < n_sites:
            used.add(Backend.EXACT.value)
        return len(used) >= 2 and bool(self.assignment)

    def to_json(self) -> Dict:
        return {
            "spec": list(spec_of(self.assignment)),
            "energy": self.energy,
            "loss": self.loss,
            "loss_worst": self.loss_worst,
            "origin": self.origin,
            "recovered": self.recovered,
        }


def dominates(a: Candidate, b: Candidate) -> bool:
    return (
        a.energy <= b.energy
        and a.loss <= b.loss
        and (a.energy < b.energy or a.loss < b.loss)
    )


def pareto_front(points: Sequence[Candidate]) -> List[Candidate]:
    """Non-dominated subset, ascending energy (ties keep the first)."""
    front = [
        p for p in points if not any(dominates(q, p) for q in points)
    ]
    return sorted(front, key=lambda p: (p.energy, p.loss))


@dataclasses.dataclass
class SearchResult:
    arch: str
    baseline_energy: float          # all-exact joules-equivalents
    exact_loss: float
    pool: List[Candidate]
    front: List[Candidate]
    profile: SensitivityProfile
    n_sites: int
    fleet_size: int = 0             # chips per ensemble score (0 = nominal)

    def best_under_budget(
        self, budget_frac: float, objective: str = "mean"
    ) -> Candidate:
        """Lowest hw-eval loss map with energy <= budget_frac x all-exact.

        Monotone in ``budget_frac``: a larger budget can only enlarge the
        feasible pool, so the returned loss never increases.  With a
        fleet-scored pool, ``objective="worst"`` ranks by the worst chip
        instead of the fleet mean — the SLO deployment query ("no user's
        chip may exceed this loss"); without a fleet the two coincide.
        """
        if objective not in ("mean", "worst"):
            raise ValueError(
                f"objective must be 'mean' or 'worst'; got {objective!r}"
            )
        budget = budget_frac * self.baseline_energy
        feasible = [p for p in self.pool if p.energy <= budget]
        if not feasible:
            cheapest = min(self.pool, key=lambda p: p.energy)
            raise ValueError(
                f"no evaluated map fits {budget_frac:.2f}x the exact energy; "
                f"cheapest found needs {cheapest.energy / self.baseline_energy:.3f}x"
            )
        if objective == "worst":
            return min(feasible, key=lambda p: (p.loss_worst, p.energy))
        return min(feasible, key=lambda p: (p.loss, p.energy))

    def uniform(self, backend: str) -> Candidate:
        for p in self.pool:
            if p.origin == f"uniform:{backend}":
                return p
        raise KeyError(f"no uniform baseline for {backend!r}")

    def to_json(self) -> Dict:
        return {
            "arch": self.arch,
            "baseline_energy": self.baseline_energy,
            "exact_loss": self.exact_loss,
            "n_sites": self.n_sites,
            "fleet_size": self.fleet_size,
            "front": [p.to_json() for p in self.front],
            "pool": [p.to_json() for p in self.pool],
            "sensitivity": [
                dataclasses.asdict(e) for e in self.profile.entries
            ],
        }


# ---------------------------------------------------------------------------
# Recovery fine-tune (short paper_schedule()-style phase plan)
# ---------------------------------------------------------------------------


def _recover_params(
    model: Model,
    params,
    approx: ApproxConfig,
    data,
    steps: int,
    seed: int,
    fns: CompiledFnCache,
):
    """Fine-tune a copy of ``params`` for ``steps`` under ``approx``: an
    INJECT phase (a calibration batch first and every N steps) then a short
    MODEL-mode tail, the paper's recipe compressed per candidate.  The
    port's steps train in place, so ``params`` itself is left as it was."""
    from repro_torch.configs.base import TrainConfig

    tail = max(steps // 3, 1)
    inject_steps = max(steps - tail, 0)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=1, learning_rate=5e-4)
    state = init_train_state(model, seed, approx, tcfg, device=params.device,
                             params=copy.deepcopy(params))
    inject_cfg = dataclasses.replace(approx, mode=TrainMode.INJECT)
    model_cfg = dataclasses.replace(approx, mode=TrainMode.MODEL)
    calib_fn = fns.get(("recover_calib", inject_cfg),
                       lambda: make_calibration_step(model, inject_cfg, tcfg))
    inject_fn = fns.get(("recover_train", inject_cfg),
                        lambda: make_train_step(model, inject_cfg, tcfg))
    model_fn = fns.get(("recover_train", model_cfg),
                       lambda: make_train_step(model, model_cfg, tcfg))
    every = max(inject_steps // 2, 1)
    for s in range(steps):
        rng = (seed + 23, s)  # the reference's fold_in(PRNGKey(seed + 23), s)
        batch = data.batch_at(s)
        if s < inject_steps:
            if s % every == 0:
                state, _ = calib_fn(state, batch, rng)
            state, _ = inject_fn(state, batch, rng)
        else:
            state, _ = model_fn(state, batch, rng)
    for p in state["params"].parameters():
        p.requires_grad_(False)
    return state["params"]


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def search(
    model: Model,
    params,
    batch,
    base: ApproxConfig,
    backends: Sequence[str],
    *,
    sites: Optional[Sequence[str]] = None,
    pinned: Assignment = (),
    seed: int = 0,
    mutations: int = 8,
    recover_steps: int = 0,
    recover_data=None,
    fns: Optional[CompiledFnCache] = None,
    profile: Optional[SensitivityProfile] = None,
    fleet=None,
    measured=None,
    dispatch: str = "switch",
) -> SearchResult:
    """Search site->backend maps on a profiling batch.

    ``dispatch`` selects how candidates are evaluated: ``"switch"`` (the
    default) scores every probe and candidate through runtime backend
    dispatch (:mod:`repro_torch.core.switch`), so the whole search builds
    at most two steps (one hw-eval, one blend-grad) and each map is an
    index-array swap; ``"static"`` builds a step per map.  In the port the
    two give bitwise equal losses.  Recovery fine-tunes
    (``recover_steps>0``) always train static: the per-candidate INJECT
    phase needs the candidate's own calibration-stat shapes.

    ``pinned`` entries are forced into every candidate (and their sites
    excluded from moves); ``recover_steps > 0`` fine-tunes each candidate
    from ``params`` on ``recover_data`` before hardware-eval scoring.

    ``fleet`` (a :class:`repro_torch.hw.Fleet`) switches scoring to the
    *ensemble*: each candidate's ``loss`` is the mean hardware-eval loss
    over the sampled device instances and ``loss_worst`` the worst chip,
    so the front reflects maps robust across the population.  Chip
    profiles are arguments of one step per map.  ``measured``
    (:func:`repro_torch.search.costmodel.load_measured_energy`) prices MACs
    with measured per-backend numbers instead of the analytic models.
    """
    check_searchable(model)
    fns = fns if fns is not None else CompiledFnCache()
    cfg = model.cfg
    B, T = batch["tokens"].shape
    costs = costmodel.site_costs(cfg, seq_len=T, batch=B)
    all_sites = tuple(costs)
    sites = tuple(sites) if sites is not None else all_sites
    # pins may be fnmatch patterns (the --site-backend form): expand them
    # to literal sites first, or pattern pins would neither exclude their
    # sites from moves nor survive normalize_assignment's literal sort
    expanded_pins = expand_pins(pinned, all_sites)
    pinned_sites = {s for s, _ in expanded_pins}
    pinned = normalize_assignment(expanded_pins)
    free_sites = tuple(
        s for s in sites if s in costs and s not in pinned_sites
    )
    backends = tuple(str(b) for b in backends)
    if recover_steps > 0 and recover_data is None:
        raise ValueError("recover_steps > 0 requires recover_data")

    if dispatch not in ("switch", "static"):
        raise ValueError(
            f"dispatch must be 'switch' or 'static'; got {dispatch!r}"
        )
    # the search's backend world is closed (candidates + pins), so switch
    # tables only need those backends, and the profile and candidate evals
    # share one key
    closed = (
        backends + tuple(str(b) for _, b in pinned)
        if dispatch == "switch" else None
    )
    if profile is None:
        profile = profile_sensitivity(
            model, params, batch, base, backends,
            sites=free_sites, seed=seed, fns=fns, measured=measured,
            dispatch=dispatch, switch_backends=closed,
        )

    rng = (seed,)  # the reference's PRNGKey(seed)
    rnd = np.random.default_rng(seed)
    scored: Dict[Assignment, Candidate] = {}

    def score(pairs, origin: str) -> Candidate:
        assignment = normalize_assignment(tuple(pairs) + pinned)
        hit = scored.get(assignment)
        if hit is not None:
            return hit
        approx = dataclasses.replace(
            base,
            backend=Backend.EXACT,
            mode=TrainMode.MODEL,
            site_backends=assignment,
        )
        p = params
        recovered = False
        if recover_steps > 0 and assignment:
            p = _recover_params(
                model, params, approx, recover_data, recover_steps, seed, fns
            )
            recovered = True
        if fleet is not None and assignment:
            losses = fleet_eval_losses(
                model, p, batch, approx, rng, fns, fleet.chips, dispatch,
                switch_backends=closed,
            )
            loss = float(np.mean(losses))
            loss_worst = float(np.max(losses))
        else:
            # all-exact maps have no hardware for variation to act on —
            # one nominal eval is the whole ensemble
            loss = eval_loss(model, p, batch, approx, rng, fns, dispatch,
                             switch_backends=closed)
            loss_worst = loss
        energy = costmodel.assignment_energy(
            cfg, base, assignment, seq_len=T, batch=B, costs=costs,
            measured=measured,
        )
        cand = Candidate(
            assignment=assignment, energy=energy, loss=loss,
            origin=origin, recovered=recovered, loss_worst=loss_worst,
        )
        scored[assignment] = cand
        return cand

    baseline_energy = costmodel.assignment_energy(
        cfg, base, (), seq_len=T, batch=B, costs=costs, measured=measured,
    )

    # 1. seeds: all-exact + one uniform map per backend
    score((), "exact")
    for b in backends:
        score(tuple((s, b) for s in free_sites), f"uniform:{b}")

    # 2. greedy ratchet over the profile's best per-site moves
    moves = [m for m in (profile.best_move(s) for s in free_sites) if m]
    moves.sort(key=lambda m: -m.score)
    current: List[Tuple[str, str]] = []
    for m in moves:
        current.append((m.site, m.backend))
        score(tuple(current), "ratchet")

    # 3. seeded mutations of (preferentially) the current front — skipped
    # when every site is pinned (nothing to flip; the seeds already
    # scored the one reachable map)
    options = backends + (Backend.EXACT.value,)
    for _ in range(max(mutations, 0) if free_sites else 0):
        pool = list(scored.values())
        front = pareto_front(pool)
        source = front if (front and rnd.random() < 0.7) else pool
        parent = source[int(rnd.integers(len(source)))]
        site = free_sites[int(rnd.integers(len(free_sites)))]
        new_b = options[int(rnd.integers(len(options)))]
        mutated = dict(parent.assignment)
        mutated.pop(site, None)
        if new_b != Backend.EXACT.value:
            mutated[site] = new_b
        score(tuple(mutated.items()), "mutation")

    pool = sorted(scored.values(), key=lambda p: (p.energy, p.loss))
    return SearchResult(
        arch=cfg.name,
        baseline_energy=baseline_energy,
        exact_loss=profile.exact_loss,
        pool=pool,
        front=pareto_front(pool),
        profile=profile,
        n_sites=len(free_sites),
        fleet_size=len(fleet) if fleet is not None else 0,
    )
