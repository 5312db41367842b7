"""Seeded chip fleets: the population a deployment runs on (port of
``repro.hw.fleet``).

A :class:`Fleet` samples ``n_chips`` device instances from one
:class:`~repro_torch.hw.variation.VariationModel` under one seed, chip
``i`` from ``fold_in(PRNGKey(seed), i)``: the reference's chips, bit for
bit.  It also holds each chip's fitted correction statistics (two chips
of one backend have different error curves), its fleet-global token
counter (the drift age: two lanes on one chip age it once, together),
and the retirement ledger.

Consumers: the Trainer round-robins ``chip_for_step`` through a fleet in
variation-aware phases; the serving engine binds each emulated lane to a
chip and parks the lane's recalibrated statistics back through
``set_calib``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.hw.variation import ChipProfile, VariationModel, sample_profile
from repro_torch.kernels import prng


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


class Fleet:
    def __init__(self, n_chips: int, seed: int = 0, variation: VariationModel = VariationModel()):
        if n_chips < 1:
            raise ValueError(f"Fleet needs n_chips >= 1; got {n_chips}")
        self.seed = int(seed)
        self.variation = variation
        base = prng.prng_key(self.seed)
        self.chips: List[ChipProfile] = [
            sample_profile(prng.fold_in(base, i), variation) for i in range(n_chips)
        ]
        self._calib: Dict[int, Any] = {}      # chip id -> fitted correction stats
        self._tokens: Dict[int, float] = {}   # chip id -> tokens served (the drift age)
        self._retired: Dict[int, Dict[str, Any]] = {}

    @classmethod
    def of(cls, chips: Sequence[ChipProfile], seed: int = 0,
           variation: VariationModel = VariationModel()) -> "Fleet":
        """A fleet over chips already sampled (no resampling)."""
        if not chips:
            raise ValueError("Fleet.of needs at least one chip")
        f = cls.__new__(cls)
        f.seed = int(seed)
        f.variation = variation
        f.chips = list(chips)
        f._calib, f._tokens, f._retired = {}, {}, {}
        return f

    def __len__(self) -> int:
        return len(self.chips)

    def chip(self, chip_id: int) -> ChipProfile:
        return self.chips[chip_id]

    def _check(self, chip_id: int) -> None:
        if not 0 <= chip_id < len(self.chips):
            raise IndexError(f"no chip {chip_id} in a fleet of {len(self.chips)}")

    # ---- fleet-global token counters (the drift age) ------------------
    def note_tokens(self, chip_id: int, tokens: int) -> float:
        """Credit ``tokens`` served on this chip; returns its new total."""
        self._check(chip_id)
        total = self._tokens.get(chip_id, 0.0) + float(tokens)
        self._tokens[chip_id] = total
        return total

    def tokens_served(self, chip_id: int) -> float:
        return self._tokens.get(chip_id, 0.0)

    # ---- retirement ----------------------------------------------------
    def retire(self, chip_id: int, reason: str = "") -> Dict[str, Any]:
        """Mark a chip retired (idempotent); returns its ledger entry.  A
        retired chip keeps its profile and stats but leaves
        ``active_ids``."""
        self._check(chip_id)
        entry = self._retired.get(chip_id)
        if entry is None:
            entry = self._retired[chip_id] = {
                "chip": chip_id, "reason": reason,
                "tokens_served": self.tokens_served(chip_id), "t": time.time(),
            }
        return entry

    def is_retired(self, chip_id: int) -> bool:
        return chip_id in self._retired

    def active_ids(self):
        return tuple(i for i in range(len(self.chips)) if i not in self._retired)

    def retirement_log(self) -> List[Dict[str, Any]]:
        return [self._retired[i] for i in sorted(self._retired)]

    def chip_for_step(self, step: int) -> ChipProfile:
        """Round-robin for variation-aware training: step ``s`` trains
        against chip ``s % n``."""
        return self.chips[step % len(self.chips)]

    # ---- per-chip calibration state ------------------------------------
    def calib_for(self, chip_id: int, init: Optional[Callable[[], Any]] = None) -> Any:
        """This chip's calibration state (``init()``-built on first use)."""
        state = self._calib.get(chip_id)
        if state is None and init is not None:
            state = self._calib[chip_id] = init()
        return state

    def set_calib(self, chip_id: int, state: Any) -> None:
        self._check(chip_id)
        self._calib[chip_id] = state

    def calibrated_ids(self):
        return tuple(sorted(self._calib))

    def mean_calib(self) -> Optional[Any]:
        """The leaf-wise mean of every calibrated chip's stats (the
        fleet-typical error polynomials, with which the engine may
        warm-start a newly bound chip); None while no chip is calibrated."""
        states = [self._calib[i] for i in sorted(self._calib)]
        if not states:
            return None
        if len(states) == 1:
            return states[0]
        # jnp.mean's arithmetic: the sum, times float32(1 / n)
        inv = 1.0 / len(states)
        return tree_map(lambda *xs: torch.stack(xs).sum(dim=0) * inv, *states)
