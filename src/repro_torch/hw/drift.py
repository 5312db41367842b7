"""Temporal drift over a chip's lifetime (port of ``repro.hw.drift``).

A deployed chip's profile is not static: analog conductances and ADC
references drift as a random walk with use, ambient temperature cycles
modulate offsets, and multiplier aging slowly grows the stuck-at fault
population.  :func:`advance` moves a :class:`~repro_torch.hw.variation.
ChipProfile` forward by a number of tokens served.

The walk is a frozen path: each field's trajectory ``W(age)`` is built
from per-kilotoken unit draws of numpy's ``default_rng((seed, stream,
k))`` keyed on the chip's ``seed`` leaf, and an advance writes ``base +
rate * W(new_age)`` from the profile's fabrication-time ``base``.  So a
chip's state is a pure function of (chip, tokens served), bitwise the
reference's, however the tokens were chunked into calls.  It runs on the
host, on the profile's scalar leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.hw.variation import FAULT_FAMILIES, GAIN_FAMILIES, ChipProfile, f32


@dataclasses.dataclass(frozen=True)
class DriftModel:
    """Drift rates, per 1k tokens served: the random-walk std of the gain
    and offset of the gain families (sc, analog) per sqrt(kilotoken); a
    sinusoidal offset of amplitude ``temp_cycle_amp`` and period
    ``temp_cycle_period`` tokens; and the growth of the multiplier
    families' stuck-at fault rate per kilotoken, clamped at 0.5."""

    gain_walk_std: float = 0.02
    offset_walk_std: float = 0.01
    temp_cycle_amp: float = 0.0
    temp_cycle_period: float = 4096.0
    fault_growth: float = 0.0

    def scaled(self, factor: float) -> "DriftModel":
        return dataclasses.replace(
            self,
            gain_walk_std=self.gain_walk_std * factor,
            offset_walk_std=self.offset_walk_std * factor,
            temp_cycle_amp=self.temp_cycle_amp * factor,
            fault_growth=self.fault_growth * factor,
        )


def _cycle(model: DriftModel, age: float) -> float:
    if not model.temp_cycle_amp:
        return 0.0
    return model.temp_cycle_amp * math.sin(2.0 * math.pi * age / max(model.temp_cycle_period, 1.0))


_BUCKET = 1000.0  # one kilotoken per unit-variance draw


def _walk(seed: int, stream: int, age: float) -> float:
    """``W(age)`` of one drift stream: a unit draw per full kilotoken, the
    partial bucket's draw scaled by sqrt(fraction)."""
    bucket, frac = divmod(age / _BUCKET, 1.0)
    total = 0.0
    for k in range(int(bucket) + 1):
        z = float(np.random.default_rng((seed, stream, k)).standard_normal())
        total += z if k < int(bucket) else z * math.sqrt(frac)
    return total


def advance(chip: ChipProfile, tokens: int, model: Optional[DriftModel] = None) -> ChipProfile:
    """The chip after serving ``tokens`` more tokens (a new profile; the
    chip's per-column draws are shared with it, its key being the same).
    Every drifting field is written from ``base``, never from its current
    value."""
    if model is None or tokens <= 0:
        return chip
    t1 = float(chip["age"]) + float(tokens)
    seed = int(chip["seed"])
    base = chip["base"]

    out = dict(chip)
    out["age"] = f32(t1)
    for si, name in enumerate(GAIN_FAMILIES):
        fam = dict(chip[name])
        fam["gain"] = f32(float(base[name]["gain"]) + model.gain_walk_std * _walk(seed, 2 * si, t1))
        fam["offset"] = f32(float(base[name]["offset"])
                            + model.offset_walk_std * _walk(seed, 2 * si + 1, t1)
                            + _cycle(model, t1))
        out[name] = fam
    if model.fault_growth:
        for name in FAULT_FAMILIES:
            fam = dict(chip[name])
            fam["fault_rate"] = f32(min(float(base[name]["fault_rate"])
                                        + model.fault_growth * t1 / _BUCKET, 0.5))
            out[name] = fam
    return out
