"""Continuous-batching serving engine with per-request approximate-hardware
emulation (port of ``repro.runtime.engine``: ``Request``,
``resolve_approx``, ``synthetic_requests``, lanes, slot admit/evict,
bucketed bulk prefill, per-slot positions, ``fused``, ``collect_logits``,
``stream``).

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
* **Random streams.**  Every prefill and every lane decode step takes the
  next engine tick; its key path ``(seed, tick)`` seeds the SC generator
  sequences of that call (see
  :class:`repro_torch.core.approx_linear.ApproxCtx`), in the order the
  reference's ``_next_rng`` folds ticks into its key.  SC and analog
  quantise with per-tensor activation scales, so their emulated logits
  depend on everything that shares the batch (padded prefill positions,
  idle decode rows), exactly as in the reference.

The reference's fleets, drift, online recalibration, one-compile switch
and fabric hooks are not ported yet.  PyTorch runs eagerly, so there is
no compile step: the first call of each (kind, shape, config) carries
kernel loading and allocator warm-up instead, and is timed apart as
``warmup_s``, as the reference times compiling calls apart.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ApproxConfig, Backend, TrainMode, resolve_backend
from repro_torch.core import registry
from repro_torch.core.approx_linear import ApproxCtx
from repro_torch.models import decode as D
from repro_torch.models.model import Model, resolve_device


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
    """All slots sharing one serving config (one decode cache)."""

    def __init__(self, approx: ApproxConfig, cache, n_slots: int):
        self.approx = approx
        self.cache = cache
        self.slots: List[Optional[_Active]] = [None] * n_slots
        self.tokens = np.zeros((n_slots, 1), np.int64)
        self.pos = np.zeros((n_slots,), np.int32)
        # steady-state accounting of this lane (first calls excluded)
        self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_tokens = self.decode_steps = 0

    @property
    def name(self) -> str:
        """The lane's backend, and its site map when it has one."""
        a = self.approx
        if not a.active:
            return Backend.EXACT.value
        sites = ",".join(f"{p}={b}" for p, b in a.site_backends)
        name = a.backend.value if isinstance(a.backend, Backend) else str(a.backend)
        return name + (f"[{sites}]" if sites else "")

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)


class Engine:
    """Continuous-batching serving engine over one model + params.

    ``submit`` enqueues requests; ``step`` runs one engine iteration
    (admissions, then one decode step per active lane); ``run`` drives the
    queue to completion and returns per-request results.  Tokens stream
    through the optional ``stream(rid, token, done)`` callback.  The
    engine runs on ``device`` (``cuda`` unless the caller asks for the
    CPU), where ``params`` must live.
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

        self.lanes: Dict[ApproxConfig, _Lane] = {}
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

    def _lane_for(self, approx: ApproxConfig) -> _Lane:
        lane = self.lanes.get(approx)
        if lane is None:
            cache = D.init_cache(self.cfg, self.n_slots, self.max_seq, self.device)
            lane = self.lanes[approx] = _Lane(approx, cache, self.n_slots)
        return lane

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
            "emulated": lane.approx.active,
            "logits": st.logits if self.collect_logits else None,
        }
        lane.slots[slot] = None
        # evict: a freed slot decodes as a canonical idle row (zero cache,
        # token 0, position 0), never a finished request's KV
        D.slot_reset(self.cfg, lane.cache, slot)
        lane.tokens[slot, 0] = 0
        lane.pos[slot] = 0

    def _prefill(self, lane: _Lane, toks, length: int, slot: int, rng):
        last, sub = D.prefill(
            self.params, toks, self.cfg, lengths=[length], max_seq=self.max_seq,
            approx=lane.approx, rng=rng, draws=self.draws,
        )
        D.slot_insert(self.cfg, lane.cache, sub, slot)
        return last[0]

    def _admit(self, lane: _Lane, slot: int, req: Request) -> List[Dict[str, Any]]:
        P = len(req.prompt)
        L = self._bucket(P)
        toks = torch.zeros((1, L), dtype=torch.int64, device=self.device)
        toks[0, :P] = torch.tensor(req.prompt, dtype=torch.int64)
        key = ("prefill", L, lane.approx)
        last, dt, first = self._call(key, self._prefill, lane, toks, P, slot, self._next_rng())
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

        events: List[Dict[str, Any]] = []
        done = len(st.tokens) >= req.max_new_tokens
        self._emit(st, events, done)
        if done:
            self._finish(lane, slot)
        return events

    def _decode(self, lane: _Lane, rng):
        ctx = None
        if lane.approx.active:
            ctx = ApproxCtx(cfg=lane.approx, fused=self.fused, rng=rng, draws=self.draws)
        tokens = torch.from_numpy(lane.tokens).to(self.device)
        pos = torch.from_numpy(lane.pos).to(self.device)
        logits, _ = D.serve_step(
            self.params, lane.cache, tokens, pos, self.cfg, ctx=ctx, flash=self.fused
        )
        return logits

    def _decode_lane(self, lane: _Lane) -> List[Dict[str, Any]]:
        key = ("decode", lane.approx)
        logits, dt, first = self._call(key, self._decode, lane, self._next_rng())
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
        """One engine iteration: admit what fits, then decode every lane."""
        events: List[Dict[str, Any]] = []
        deferred: deque = deque()
        while self.pending:
            req, approx = self.pending.popleft()
            lane = self._lane_for(approx)
            free = lane.free_slots()
            if free:
                events += self._admit(lane, free[0], req)
            else:
                deferred.append((req, approx))
        self.pending = deferred

        active = sum(l.n_active() for l in self.lanes.values())
        capacity = max(1, self.n_slots * len(self.lanes))
        if active:
            self._util.append((active, capacity))
        for lane in list(self.lanes.values()):
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
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat else 0.0,
            "slot_util": util,
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
