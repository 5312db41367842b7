"""Continuous-batching serving engine with per-request approximate-hardware
emulation (port of ``repro.runtime.engine``: ``Request``,
``resolve_approx``, ``synthetic_requests``, lanes, slot admit/evict,
bucketed bulk prefill, per-slot positions, ``fused``, ``collect_logits``,
``stream``, chip fleets with drift and online recalibration, merged switch
lanes with ``site_mask`` and ``demote_sites``, and
``run_static_baseline``).

* **Lanes.**  Each distinct serving config (an ``ApproxConfig`` resolved
  from the request's backend) owns a lane: one decode cache whose batch
  dimension is ``n_slots`` fixed slots.  Requests are admitted into free
  slots and evicted on completion.
* **Bulk prefill.**  A prompt is prefilled in one full-sequence forward,
  right-padded to a power-of-two bucket, and its cache rows written into
  the lane's slot.
* **Per-request backends.**  A request naming an approximate backend is
  served with bit-accurate MODEL-mode emulation (per-token operand scales,
  so a request's logits do not depend on what shares its batch); exact
  requests share the engine with it.
* **Fused decode.**  ``fused=True`` decodes emulated lanes through the
  fused kernels (K2, K5, K7) and every lane's attention through the flash
  decode kernel (K3); prefill stays on the composed path (K1, K4, K6).
* **Chip fleets, drift, online recalibration** (``fleet=``).  Each
  emulated lane is bound to one chip of a :class:`repro_torch.hw.Fleet`,
  up to one lane per active chip for each serving config, so a queue fans
  out over physical chips.  Binding a chip fits its correction stats
  (a calibration pass on the probe batch against the exact matmul) or
  warm-starts them from the fleet's mean.  A ``drift=``
  :class:`~repro_torch.hw.DriftModel` ages each chip by the tokens it
  serves (the fleet's counter); each lane's adaptive
  :class:`~repro_torch.core.schedule.CalibrationController` watches the
  drifting probe loss and refits the stats, which prefill and decode
  subtract from every projection (``correct``).  Decode takes the chip and
  the correction in the fused kernels' epilogues.
* **Merged lanes** (``switch=True``).  Every emulated request, whatever
  its backend or site map, shares one lane keyed on the canonical config
  (:func:`repro_torch.core.switch.canonical`); each slot keeps a host
  index row over ``switch.SITE_ORDER`` (idle slots at exact), prefill runs
  on the request's row and decode on the ``[n_slots, n_sites]`` matrix
  (``ApproxCtx.site_idx``).  Exact requests keep their own lane.
  ``site_mask`` / :meth:`Engine.demote_sites` turn matching sites exact on
  every slot, a rewrite of the index rows.  Incompatible with a fleet.
* **Random streams.**  Every prefill, lane decode step, recalibration and
  probe takes the next engine tick; its key path ``(seed, tick)`` seeds
  the SC generator sequences of that call (see
  :class:`repro_torch.core.approx_linear.ApproxCtx`), in the order the
  reference's ``_next_rng`` folds ticks into its key.  SC and analog
  quantise with per-tensor activation scales, so their emulated logits
  depend on everything that shares the batch (padded prefill positions,
  idle decode rows), exactly as in the reference.

The reference's fabric hooks (``external_recal``, ``push_calib``) wait for
ROADMAP A7.  PyTorch runs eagerly, so there is no compile step: the first
call of each (kind, shape, config) carries kernel loading and allocator
warm-up instead, and is timed apart as ``warmup_s``, as the reference
times compiling calls apart.

``run_static_baseline`` is the static-batch driver the reference's
serving benchmark compares the engine against: waves of padded requests,
prompts fed token by token, exact path only.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (
    ApproxConfig,
    Backend,
    CalibPolicy,
    Phase,
    TrainMode,
    resolve_backend,
)
from repro_torch.core import registry
from repro_torch.core import switch as switch_lib
from repro_torch.core.approx_linear import ApproxCtx
from repro_torch.core.schedule import CalibrationController, PhasePlan
from repro_torch.hw import DriftModel, Fleet
from repro_torch.hw import drift as drift_lib
from repro_torch.models import decode as D
from repro_torch.models.model import Model, resolve_device
from repro_torch.models.transformer import SERVING_ONLY
from repro_torch.training.losses import lm_loss


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``backend`` names the approximate hardware
    the request's deployed model targets (``"exact"`` for the plain
    path); ``site_backends`` overrides it per projection site.  With
    ``emulate=False`` a non-exact request is served on the exact path."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    backend: str = "exact"
    site_backends: Tuple[Tuple[str, str], ...] = ()
    emulate: bool = True
    temperature: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(int(t) for t in self.prompt))
        object.__setattr__(
            self, "site_backends",
            tuple((str(p), str(n)) for p, n in self.site_backends),
        )
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")


def resolve_approx(req: Request, base: ApproxConfig) -> ApproxConfig:
    """The serving ApproxConfig a request runs under (its lane key).
    Exact or non-emulated requests resolve to one shared inactive config."""
    wants_approx = req.backend != Backend.EXACT.value or bool(req.site_backends)
    if not (wants_approx and req.emulate):
        return dataclasses.replace(
            base, backend=Backend.EXACT, mode=TrainMode.NO_MODEL, site_backends=()
        )
    return dataclasses.replace(
        base, backend=resolve_backend(req.backend), mode=TrainMode.MODEL,
        site_backends=req.site_backends,
    )


def synthetic_requests(
    n: int,
    vocab_size: int,
    *,
    seed: int = 0,
    prompt_lens: Tuple[int, int] = (4, 16),
    gen_lens: Tuple[int, int] = (4, 16),
    backends: Sequence[str] = ("exact",),
    temperature: float = 0.0,
) -> List[Request]:
    """A mixed-length, mixed-backend request queue; the same draws as the
    reference's for the same arguments."""
    rnd = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        P = int(rnd.integers(prompt_lens[0], prompt_lens[1] + 1))
        G = int(rnd.integers(gen_lens[0], gen_lens[1] + 1))
        prompt = tuple(int(t) for t in rnd.integers(0, vocab_size, size=P))
        out.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=G,
            backend=backends[rid % len(backends)], temperature=temperature,
        ))
    return out


@dataclasses.dataclass
class _Active:
    """Per-slot state of an admitted request."""

    req: Request
    prefill_s: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    latencies: List[float] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)


class _Lane:
    """All slots sharing one serving config (one decode cache).

    With a fleet, a lane is also bound to one device instance: ``chip`` is
    its (drifting) profile, ``calib`` the chip's correction stats that
    online recalibration refits, ``controller`` the adaptive cadence."""

    def __init__(self, approx: ApproxConfig, cache, n_slots: int, chip_id: int = -1,
                 chip=None, switch: bool = False):
        self.approx = approx
        self.cache = cache
        self.slots: List[Optional[_Active]] = [None] * n_slots
        self.tokens = np.zeros((n_slots, 1), np.int64)
        self.pos = np.zeros((n_slots,), np.int32)
        # a merged lane (approx is the canonical config): each slot's
        # backend index row, idle slots at exact
        self.switch = switch
        self.site_idx = (np.zeros((n_slots, len(switch_lib.SITE_ORDER)), np.int32)
                         if switch else None)
        # steady-state accounting of this lane (first calls excluded)
        self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_tokens = self.decode_steps = 0
        # device-instance state (fleet serving)
        self.chip_id = chip_id
        self.chip = chip
        self.calib = None
        self.controller: Optional[CalibrationController] = None
        self.tick = 0  # engine steps seen: the recalibration clock
        self.recals = 0
        self.probe_losses: List[Tuple[int, float]] = []      # uncorrected
        self.corrected_losses: List[Tuple[int, float]] = []  # after each recalibration

    @property
    def backend(self) -> str:
        b = self.approx.backend
        return b.value if isinstance(b, Backend) else str(b)

    @property
    def name(self) -> str:
        """The lane's backend, its site map when it has one, and its chip
        (``switch`` for a merged lane)."""
        a = self.approx
        if self.switch:
            return "switch"
        if not a.active:
            return Backend.EXACT.value
        sites = ",".join(f"{p}={b}" for p, b in a.site_backends)
        chip = f"@chip{self.chip_id}" if self.chip is not None else ""
        return self.backend + (f"[{sites}]" if sites else "") + chip

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)


class Engine:
    """Continuous-batching serving engine over one model + params.

    ``submit`` enqueues requests; ``step`` runs one engine iteration
    (admissions, then one decode step per active lane, each chip-bound
    lane recalibrating first when its controller says so); ``run`` drives
    the queue to completion and returns per-request results.  Tokens
    stream through the optional ``stream(rid, token, done)`` callback.
    The engine runs on ``device`` (``cuda`` unless the caller asks for the
    CPU), where ``params`` must live.

    ``fleet`` binds every emulated lane to a chip (one chip per lane, up to
    the fleet's active chips per serving config) and ``drift`` ages the
    chips as they serve.  ``probe`` (``{'tokens', 'labels'}``, [B, T]) is
    the recalibration batch: its emulated loss is the drift signal each
    lane's adaptive controller watches (base cadence
    ``recalibrate_every`` engine steps, halving when the loss moves by more
    than ``recal_drift_threshold`` relative), and each recalibration refits
    the lane's correction stats against the exact matmul.  Without one, a
    random-token batch from ``seed + 101`` (the reference's).
    ``correct=False`` serves chip lanes raw while still refitting;
    ``probe_corrected=False`` skips the corrected probe after each
    recalibration (it only feeds ``fleet_report``); ``warm_start`` seeds a
    newly bound chip's stats from ``Fleet.mean_calib`` instead of fitting
    them at bind time (while some chip is calibrated).

    ``switch`` merges every emulated request into one lane whatever its
    backend or site map (see the module docstring); ``site_mask`` (fnmatch
    patterns, with ``switch``) demotes matching sites to exact on every
    admitted request, and :meth:`demote_sites` swaps it at run time.
    """

    def __init__(
        self,
        model: Model,
        params,
        *,
        n_slots: int = 4,
        max_seq: int = 128,
        approx_base: Optional[ApproxConfig] = None,
        min_bucket: int = 8,
        seed: int = 0,
        collect_logits: bool = False,
        stream: Optional[Callable[[int, int, bool], None]] = None,
        fused: bool = False,
        device="cuda",
        draws: Optional[Callable] = None,
        fleet: Optional[Fleet] = None,
        drift: Optional[DriftModel] = None,
        probe: Optional[Dict[str, Any]] = None,
        recalibrate_every: int = 8,
        recal_drift_threshold: float = 0.02,
        correct: bool = True,
        probe_corrected: bool = True,
        warm_start: bool = False,
        switch: bool = False,
        site_mask: Sequence[str] = (),
    ):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine on {self.device}")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.min_bucket = int(min_bucket)
        self.approx_base = approx_base if approx_base is not None else ApproxConfig()
        self.collect_logits = collect_logits
        self.stream = stream
        self.fused = bool(fused)
        self.seed = int(seed)
        self.draws = draws  # None: the port's own SC draws (kernels.ops.sc_draws)
        self._tick = 0
        self.fleet = fleet
        self.drift = drift
        self.recalibrate_every = max(int(recalibrate_every), 1)
        self.recal_drift_threshold = float(recal_drift_threshold)
        self.correct = bool(correct)
        self.probe_corrected = bool(probe_corrected)
        self.warm_start = bool(warm_start)
        self.switch = bool(switch)
        self.site_mask: Tuple[str, ...] = tuple(site_mask)
        if self.switch and fleet is not None:
            raise ValueError(
                "Engine(switch=True) is incompatible with a fleet: merged lanes no longer "
                "map 1:1 onto chips (per-chip recalibration needs one config per lane)"
            )
        if self.switch and model.cfg.n_experts:
            raise ValueError(
                "Engine(switch=True) does not support MoE models: expert routing couples "
                "slot rows, so per-slot backend selection is ill-defined"
            )
        if model.cfg.family in SERVING_ONLY and (self.switch or fleet is not None):
            raise NotImplementedError(
                f"{'merged (switch) lanes' if self.switch else 'chip-bound lanes (a fleet)'} "
                f"on the {model.cfg.family.value} family are not yet ported (ROADMAP A5); "
                "serve it on static lanes")
        if probe is None and fleet is not None:
            rnd = np.random.default_rng(seed + 101)
            shape = (2, min(32, self.max_seq))
            probe = {"tokens": rnd.integers(0, self.cfg.vocab_size, shape, np.int32),
                     "labels": rnd.integers(0, self.cfg.vocab_size, shape, np.int32)}
        self.probe = None if probe is None else {
            k: torch.as_tensor(np.asarray(v), dtype=torch.int64, device=self.device)
            for k, v in probe.items()}

        # (serving config, lane index): with a fleet, one emulated config
        # spreads over several lanes, one per bound chip
        self.lanes: Dict[Tuple[ApproxConfig, int], _Lane] = {}
        self.pending: deque = deque()
        self.results: Dict[int, Dict[str, Any]] = {}
        self._sampler = np.random.default_rng(seed)
        self._warm: set = set()  # (kind, shape, config) keys already called once

        # accounting (steady-state timers exclude first calls)
        self.warmup_s = 0.0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.recalibrations = 0
        self._util: List[Tuple[int, int]] = []  # (active, capacity) per step

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt({len(req.prompt)}) + "
                f"gen({req.max_new_tokens}) exceeds max_seq={self.max_seq}"
            )
        approx = resolve_approx(req, self.approx_base)
        for backend in approx.approx_backends if approx.active else ():
            registry.get(backend)  # unported backends fail here, not mid-run
        self.pending.append((req, approx))

    def _call(self, key, fn, *args):
        """Run one step; returns (out, seconds, first_call?).  The clock
        stops after the device has finished all the step's work."""
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        first = key not in self._warm
        if first:
            self._warm.add(key)
            self.warmup_s += dt
        return out, dt, first

    def _next_rng(self):
        """The key path of the next prefill or lane decode step."""
        self._tick += 1
        return (self.seed, self._tick)

    def _bucket(self, prompt_len: int) -> int:
        b = self.min_bucket
        while b < prompt_len:
            b *= 2
        return min(b, self.max_seq)

    def _lane_key(self, approx: ApproxConfig) -> ApproxConfig:
        """The config a request's lane is keyed on: under ``switch`` every
        emulated config collapses onto its canonical form, one merged lane
        for every map (the map becomes the slot's index row at admit)."""
        if self.switch and approx.active:
            return switch_lib.canonical(approx)
        return approx

    def _max_lanes(self, approx: ApproxConfig) -> int:
        """How many lanes a serving config may spread over: one per active
        chip when a fleet serves it, else one (nominal)."""
        if self.fleet is not None and approx.active:
            return len(self.fleet.active_ids())
        return 1

    def _new_lane(self, approx: ApproxConfig, index: int, switch: bool = False) -> _Lane:
        cache = D.init_cache(self.cfg, self.n_slots, self.max_seq, self.device)
        chip, chip_id = None, index
        if self.fleet is not None and approx.active:
            # the index-th active chip: retired chips never serve again
            chip_id = self.fleet.active_ids()[index]
            chip = self.fleet.chip(chip_id)
        lane = self.lanes[(approx, index)] = _Lane(approx, cache, self.n_slots, chip_id, chip,
                                                   switch=switch)
        if chip is not None:
            lane.controller = CalibrationController(
                PhasePlan((Phase(TrainMode.MODEL, steps=2**31 - 1,
                                 calibrate=CalibPolicy.ADAPTIVE,
                                 calibrate_every=self.recalibrate_every,
                                 drift_threshold=self.recal_drift_threshold),)),
                approx,
            )
            warm = self.fleet.mean_calib() if self.warm_start else None
            if warm is not None:
                # warm start: the fleet's mean stats, no bind-time fit; the
                # raw probe is still the drift baseline
                lane.calib = warm
                loss = self._probe_raw(lane)
                lane.probe_losses.append((lane.tick, loss))
                if self.probe_corrected:
                    lane.corrected_losses.append((lane.tick, self._probe_corrected_loss(lane)))
            else:
                # bind-time recalibration: the fresh chip's stats and its
                # probe loss, the baseline recalibration recovers toward
                loss = self._recalibrate(lane)
            lane.controller.begin_step(lane.tick)  # consume the "due now"
            lane.controller.record(lane.tick, loss)
        return lane

    def _lane_for(self, approx: ApproxConfig, switch: bool = False) -> Optional[_Lane]:
        """A lane of this config with a free slot, growing the set chip by
        chip until the fleet is exhausted; None when saturated."""
        lanes = [l for (a, _), l in self.lanes.items() if a == approx]
        for lane in lanes:
            if lane.free_slots():
                return lane
        if len(lanes) < self._max_lanes(approx):
            return self._new_lane(approx, len(lanes), switch=switch)
        return lanes[0] if lanes else None

    # -- online recalibration ---------------------------------------------
    @torch.no_grad()
    def _recalib_pass(self, lane: _Lane, rng):
        out = self.model.apply(
            self.params, {"tokens": self.probe["tokens"]}, approx=lane.approx, rng=rng,
            draws=self.draws, collect=True, remat="none", chip=lane.chip, calib_exact_ref=True,
        )
        return out.collected, lm_loss(out.logits, self.probe["labels"])

    @torch.no_grad()
    def _probe_pass(self, lane: _Lane, rng, corrected: bool):
        out = self.model.apply(
            self.params, {"tokens": self.probe["tokens"]}, approx=lane.approx, rng=rng,
            draws=self.draws, remat="none", chip=lane.chip,
            calib=lane.calib if corrected else None, correct=corrected,
        )
        return lm_loss(out.logits, self.probe["labels"])

    def _probe_key(self, kind: str, lane: _Lane):
        return (kind, tuple(self.probe["tokens"].shape), lane.approx)

    def _recalibrate(self, lane: _Lane) -> float:
        """Refit the lane's correction stats on its (drifted) chip; returns
        the uncorrected probe loss, the drift signal."""
        (calib, loss), _, _ = self._call(self._probe_key("recalib", lane), self._recalib_pass,
                                         lane, self._next_rng())
        lane.calib = calib
        # the chip's stats outlive this engine (Fleet.calib_for)
        if self.fleet is not None and 0 <= lane.chip_id < len(self.fleet):
            self.fleet.set_calib(lane.chip_id, calib)
        loss = float(loss)
        lane.recals += 1
        self.recalibrations += 1
        lane.probe_losses.append((lane.tick, loss))
        if self.probe_corrected:
            lane.corrected_losses.append((lane.tick, self._probe_corrected_loss(lane)))
        return loss

    def _probe_raw(self, lane: _Lane) -> float:
        loss, _, _ = self._call(self._probe_key("probe_raw", lane), self._probe_pass, lane,
                                self._next_rng(), False)
        return float(loss)

    def _probe_corrected_loss(self, lane: _Lane) -> float:
        loss, _, _ = self._call(self._probe_key("probe", lane), self._probe_pass, lane,
                                self._next_rng(), True)
        return float(loss)

    def _advance_chip(self, lane: _Lane, tokens: int) -> None:
        """Age the lane's chip by ``tokens`` served.  The age is the chip's
        fleet-wide token count, so two lanes on one chip agree on its drift
        (drift is a pure function of the age)."""
        if lane.chip is None or tokens <= 0:
            return
        if self.fleet is not None and 0 <= lane.chip_id < len(self.fleet):
            total = self.fleet.note_tokens(lane.chip_id, tokens)
            if self.drift is not None:
                delta = total - float(lane.chip["age"])
                if delta > 0:
                    lane.chip = drift_lib.advance(lane.chip, delta, self.drift)
        elif self.drift is not None:
            lane.chip = drift_lib.advance(lane.chip, tokens, self.drift)

    def demote_sites(self, patterns: Sequence[str]) -> int:
        """Install a site demotion mask (``switch`` engines): matching sites
        serve exact (index 0) on every current and future slot, the
        per-chip stuck-at-fault containment.  A rewrite of the host index
        rows, nothing rebuilt; returns how many lanes were rewritten."""
        self.site_mask = tuple(patterns)
        rewritten = 0
        for lane in self.lanes.values():
            if lane.switch:
                lane.site_idx = switch_lib.mask_site_indices(lane.site_idx, self.site_mask)
                rewritten += 1
        return rewritten

    def _sample(self, req: Request, logits_row: np.ndarray) -> int:
        if req.temperature <= 0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / req.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._sampler.choice(len(p), p=p))

    def _emit(self, st: _Active, events: List[Dict[str, Any]], done: bool):
        tok = st.tokens[-1]
        events.append({"rid": st.req.rid, "token": tok, "done": done})
        if self.stream is not None:
            self.stream(st.req.rid, tok, done)

    def _finish(self, lane: _Lane, slot: int) -> None:
        st = lane.slots[slot]
        self.results[st.req.rid] = {
            "tokens": list(st.tokens),
            "prefill_s": st.prefill_s,
            "latencies_s": list(st.latencies),
            "backend": st.req.backend,
            "emulated": lane.approx.active or lane.switch,
            "chip": lane.chip_id if lane.chip is not None else None,
            "logits": st.logits if self.collect_logits else None,
        }
        lane.slots[slot] = None
        # evict: a freed slot decodes as a canonical idle row (zero cache,
        # token 0, position 0), never a finished request's KV: a batch-coupled
        # computation (MoE expert capacity, the per-tensor scales of the SC
        # and analog emulators) sees the same idle row every time.  An SSM
        # row's state still evolves while the slot sits idle, as in the
        # reference
        D.slot_reset(self.cfg, lane.cache, slot)
        lane.tokens[slot, 0] = 0
        lane.pos[slot] = 0
        if lane.switch:
            lane.site_idx[slot] = 0  # idle rows decode exact

    def _prefill(self, lane: _Lane, toks, length: int, slot: int, rng, idx_row=None):
        # a chip-bound lane prefills on its chip, with its correction (a
        # nominal lane has neither); a merged lane on the request's row
        last, sub = D.prefill(
            self.params, toks, self.cfg, lengths=[length], max_seq=self.max_seq,
            approx=lane.approx, rng=rng, draws=self.draws, chip=lane.chip, calib=lane.calib,
            correct=self.correct, backend_idx=idx_row,
        )
        D.slot_insert(self.cfg, lane.cache, sub, slot)
        return last[0]

    def _admit(self, lane: _Lane, slot: int, req: Request,
               approx: ApproxConfig) -> List[Dict[str, Any]]:
        P = len(req.prompt)
        L = self._bucket(P)
        toks = torch.zeros((1, L), dtype=torch.int64, device=self.device)
        toks[0, :P] = torch.tensor(req.prompt, dtype=torch.int64)
        idx_row = None
        if lane.switch:
            # the request's resolved map becomes the slot's index row, which
            # its prefill runs on; masked sites serve exact
            sub = lane.approx.switch_backends  # the lane's closed backend world, if any
            table = switch_lib.subtable(sub) if sub else None
            idx_row = switch_lib.mask_site_indices(switch_lib.site_indices(approx, table=table),
                                                   self.site_mask)
        # the key holds no map: a new map is no first call
        key = ("prefill", L, lane.approx, lane.chip is not None)
        last, dt, first = self._call(key, self._prefill, lane, toks, P, slot, self._next_rng(),
                                     idx_row)
        self._advance_chip(lane, P)
        if not first:  # steady-state accounting: first calls are excluded
            self.prefill_s += dt  # from both time AND tokens
            self.prefill_tokens += P
            lane.prefill_s += dt
            lane.prefill_tokens += P

        st = _Active(req=req, prefill_s=0.0 if first else dt)
        logits_row = last.to(torch.float32).cpu().numpy()
        if self.collect_logits:
            st.logits.append(logits_row)
        st.tokens.append(self._sample(req, logits_row))
        lane.slots[slot] = st
        lane.tokens[slot, 0] = st.tokens[-1]
        lane.pos[slot] = P
        if lane.switch:
            lane.site_idx[slot] = idx_row

        events: List[Dict[str, Any]] = []
        done = len(st.tokens) >= req.max_new_tokens
        self._emit(st, events, done)
        if done:
            self._finish(lane, slot)
        return events

    def _decode(self, lane: _Lane, rng):
        ctx = None
        if lane.switch:
            # every row on its own map (idle rows exact)
            ctx = ApproxCtx(cfg=lane.approx, fused=self.fused, rng=rng, draws=self.draws,
                            site_idx=lane.site_idx)
        elif lane.approx.active:
            # a chip-bound lane: the chip and its correction (in the fused
            # kernels' epilogues when fused)
            ctx = ApproxCtx(cfg=lane.approx, fused=self.fused, rng=rng, draws=self.draws,
                            chip=lane.chip, correct=self.correct)
        tokens = torch.from_numpy(lane.tokens).to(self.device)
        pos = torch.from_numpy(lane.pos).to(self.device)
        logits, _ = D.serve_step(
            self.params, lane.cache, tokens, pos, self.cfg, ctx=ctx, flash=self.fused,
            calib=lane.calib,
        )
        return logits

    def _decode_lane(self, lane: _Lane) -> List[Dict[str, Any]]:
        key = ("decode", lane.approx, lane.chip is not None)
        logits, dt, first = self._call(key, self._decode, lane, self._next_rng())
        self._advance_chip(lane, lane.n_active())  # the tokens the chip produced
        logits_np = logits.to(torch.float32).cpu().numpy()

        events: List[Dict[str, Any]] = []
        n_active = 0
        for i, st in enumerate(lane.slots):
            if st is None:
                continue
            n_active += 1
            row = logits_np[i]
            if self.collect_logits:
                st.logits.append(row)
            st.tokens.append(self._sample(st.req, row))
            if not first:
                st.latencies.append(dt)
            lane.tokens[i, 0] = st.tokens[-1]
            lane.pos[i] += 1
            done = len(st.tokens) >= st.req.max_new_tokens
            self._emit(st, events, done)
            if done:
                self._finish(lane, i)
        if not first:
            self.decode_s += dt
            self.decode_tokens += n_active
            lane.decode_s += dt
            lane.decode_tokens += n_active
            lane.decode_steps += 1
        return events

    def step(self) -> List[Dict[str, Any]]:
        """One engine iteration: admit what fits, then decode every lane,
        running a chip-bound lane's recalibration first when its adaptive
        controller says it is due (the drift signal moved, or the cadence
        came round)."""
        events: List[Dict[str, Any]] = []
        deferred: deque = deque()
        while self.pending:
            req, approx = self.pending.popleft()
            lane = self._lane_for(self._lane_key(approx), switch=self.switch and approx.active)
            free = lane.free_slots() if lane is not None else []
            if free:
                events += self._admit(lane, free[0], req, approx)
            else:
                deferred.append((req, approx))
        self.pending = deferred

        active = sum(l.n_active() for l in self.lanes.values())
        capacity = max(1, self.n_slots * len(self.lanes))
        if active:
            self._util.append((active, capacity))
        for lane in list(self.lanes.values()):
            if lane.controller is not None and lane.n_active():
                lane.tick += 1
                if lane.controller.begin_step(lane.tick):
                    lane.controller.record(lane.tick, self._recalibrate(lane))
            if lane.n_active():
                events += self._decode_lane(lane)
        return events

    def run(self, requests: Optional[Sequence[Request]] = None) -> Dict[int, Dict]:
        """Drive the queue to completion; returns {rid: result}."""
        for r in requests or ():
            self.submit(r)
        while self.pending or any(l.n_active() for l in self.lanes.values()):
            self.step()
        return self.results

    def reset_metrics(self) -> None:
        """Zero the accounting (times, tokens, utilisation, finished
        results) and keep everything warm: lanes, caches and the set of
        first calls already made, so a queue served next is measured in
        steady state throughout."""
        self.warmup_s = self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_tokens = 0
        self._util = []
        self.results = {}
        for lane in self.lanes.values():
            lane.prefill_s = lane.decode_s = 0.0
            lane.prefill_tokens = lane.decode_tokens = lane.decode_steps = 0

    def metrics(self) -> Dict[str, Any]:
        lat = [t for r in self.results.values() for t in r["latencies_s"]]
        util = float(np.mean([a / c for a, c in self._util])) if self._util else 0.0
        total_s = self.prefill_s + self.decode_s
        total_tok = self.prefill_tokens + self.decode_tokens
        return {
            "requests": len(self.results),
            "n_slots": self.n_slots,
            "lanes": len(self.lanes),
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "prefill_tok_s": self.prefill_tokens / max(self.prefill_s, 1e-9),
            "decode_tok_s": self.decode_tokens / max(self.decode_s, 1e-9),
            "total_tok_s": total_tok / max(total_s, 1e-9),
            "warmup_s": self.warmup_s,
            "fused": self.fused,
            "switch": self.switch,
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat else 0.0,
            "slot_util": util,
            "recalibrations": self.recalibrations,
            "site_mask": list(self.site_mask),
            "fleet_chips": len(self.fleet) if self.fleet is not None else 0,
            "device": str(self.device),
            "per_lane": {
                lane.name: {
                    "prefill_tokens": lane.prefill_tokens,
                    "prefill_tok_s": lane.prefill_tokens / max(lane.prefill_s, 1e-9),
                    "decode_tokens": lane.decode_tokens,
                    "decode_steps": lane.decode_steps,
                    "decode_tok_s": lane.decode_tokens / max(lane.decode_s, 1e-9),
                    "ms_per_decode_step": 1e3 * lane.decode_s / max(lane.decode_steps, 1),
                }
                for lane in self.lanes.values()
            },
        }

    def fleet_report(self) -> List[Dict[str, Any]]:
        """Per chip-bound lane: the chip, its backend, its age (the fleet's
        token count of the chip), recalibrations, whether it is retired,
        and the raw and corrected probe losses over its life."""
        out = []
        for (_, idx), lane in sorted(self.lanes.items(), key=lambda kv: kv[0][1]):
            if lane.chip is None:
                continue
            if self.fleet is not None and 0 <= lane.chip_id < len(self.fleet):
                age = self.fleet.tokens_served(lane.chip_id)
                retired = self.fleet.is_retired(lane.chip_id)
            else:
                age, retired = float(lane.chip["age"]), False
            out.append({
                "chip": lane.chip_id,
                "backend": lane.backend,
                "age_tokens": age,
                "recalibrations": lane.recals,
                "retired": retired,
                "probe_losses": [l for _, l in lane.probe_losses],
                "corrected_losses": [l for _, l in lane.corrected_losses],
            })
        return out


def run_static_baseline(model: Model, params, requests: Sequence[Request], *,
                        batch: int) -> Dict[str, Any]:
    """Serve ``requests`` the static-batch way, on the exact path: waves of
    ``batch`` requests, prompts right-padded to the wave's longest and fed
    token by token through ``serve_step`` (the cache updated in place),
    then decoded until the wave's longest request finishes.  Runs where
    ``params`` live.

    A shorter prompt in a mixed wave starts generating from the wave's
    longest position, with the pad tokens in its context: its output is
    not its own prompt's continuation.  That, and the padded time, is what
    the engine removes; this driver is the throughput baseline.  The first
    step of each (wave size, length) runs on a scratch cache outside the
    timers (``warmup_s``), and each clock stops after the device has
    finished."""
    device = params.device
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    warmup_s = prefill_s = decode_s = 0.0
    prefill_tokens = decode_tokens = 0
    warm = set()
    outputs: Dict[int, List[int]] = {}
    with torch.no_grad():
        for w0 in range(0, len(requests), batch):
            wave = list(requests[w0:w0 + batch])
            B = len(wave)
            P = max(len(r.prompt) for r in wave)
            G = max(r.max_new_tokens for r in wave)
            S = P + G
            prompts = torch.zeros((B, P), dtype=torch.int64)
            for i, r in enumerate(wave):
                prompts[i, :len(r.prompt)] = torch.tensor(r.prompt, dtype=torch.int64)
            prompts = prompts.to(device)
            if (B, S) not in warm:  # warm up outside the timers
                warm.add((B, S))
                scratch = model.init_cache(B, S, device)
                t0 = time.perf_counter()
                model.serve_step(params, scratch, prompts[:, :1], 0)
                sync()
                warmup_s += time.perf_counter() - t0
                del scratch

            cache = model.init_cache(B, S, device)
            t0 = time.perf_counter()
            logits = None
            for i in range(P):
                logits, cache = model.serve_step(params, cache, prompts[:, i:i + 1], i)
            sync()
            prefill_s += time.perf_counter() - t0
            # tok/s counts the requests' own tokens, as the engine does
            prefill_tokens += sum(len(r.prompt) for r in wave)

            wave_tokens: List[torch.Tensor] = []
            t0 = time.perf_counter()
            cur = torch.argmax(logits, -1)[:, None]
            for g in range(G):
                wave_tokens.append(cur[:, 0].cpu())
                if g == G - 1:
                    break
                logits, cache = model.serve_step(params, cache, cur, P + g)
                cur = torch.argmax(logits, -1)[:, None]
            sync()
            decode_s += time.perf_counter() - t0
            # G - 1 decode steps ran (the first token is the prefill's)
            decode_tokens += sum(r.max_new_tokens - 1 for r in wave)

            stacked = torch.stack(wave_tokens, dim=1)  # [B, G]
            for i, r in enumerate(wave):
                outputs[r.rid] = [int(t) for t in stacked[i, :r.max_new_tokens]]

    total_s = prefill_s + decode_s
    total_tok = prefill_tokens + decode_tokens
    return {
        "requests": len(requests),
        "batch": batch,
        "prefill_tokens": prefill_tokens,
        "decode_tokens": decode_tokens,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "warmup_s": warmup_s,
        "prefill_tok_s": prefill_tokens / max(prefill_s, 1e-9),
        "decode_tok_s": decode_tokens / max(decode_s, 1e-9),
        "total_tok_s": total_tok / max(total_s, 1e-9),
        "device": str(device),
        "outputs": outputs,
    }
