"""Parametric chip-to-chip variation models, per backend family (port of
``repro.hw.variation``).

SC stream generators have seed bias and stream correlation (a gain and
offset error on the output), analog arrays ADC gain and offset error and
a conductance spread across columns, and the approximate and log
multipliers stuck-at bit faults in single multiplier units.
:func:`sample_profile` draws one device, a :class:`ChipProfile`, from the
population a :class:`VariationModel` describes, bitwise the reference's
for the same key (the threefry of :mod:`repro_torch.kernels.prng`).

A profile is ``{"key", "seed", "age", <family>: {<param>: scalar},
"base"}``: ``key`` is the chip's threefry key (a pair of ints),
``seed`` an int32 0-d tensor, every other leaf a float32 0-d tensor on
the host, where drift rewrites them (:mod:`repro_torch.hw.drift`).

The per-column patterns (the conductance spread, which columns hold a
stuck-at fault and its sign) depend only on the chip's key, the site and
the width: the same chip has the same mismatch in every forward, in
prefill and decode alike.  They are drawn once per (site, width, dtype,
device) on the host by the plain threefry (so every device holds the
reference's values to the bit), moved to the device and kept in the
profile's ``"draws"`` dict for the chip's life; each call recombines
them with the chip's current, drifting scalars.

The multiplicative (gain) part of a perturbation is differentiable, so
variation-aware MODEL-mode training feels each chip in its backward; the
additive parts ride on detached row scales
(:func:`repro_torch.kernels.epilogue.row_abs_scale`).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional

import torch

from repro_torch.kernels import prng
from repro_torch.kernels.epilogue import apply_epilogue

ChipProfile = Dict[str, Any]

# families whose perturbation is (gain, offset, spread) on the emulated
# output, and those with (fault_rate, fault_mag) stuck-at faults
GAIN_FAMILIES = ("sc", "analog")
FAULT_FAMILIES = ("approx_mult", "log_mult")
CHIP_KEY_FOLD = 0x5EED
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class VariationModel:
    """Population statistics of chip-to-chip variation, per family;
    ``scale`` multiplies every sigma."""

    scale: float = 1.0
    # stochastic computing: generator seed bias and stream correlation
    sc_gain_std: float = 0.03
    sc_offset_std: float = 0.02
    sc_spread: float = 0.01
    # analog arrays: ADC gain and offset error, conductance spread
    analog_gain_std: float = 0.05
    analog_offset_std: float = 0.03
    analog_spread: float = 0.02
    # approximate and log multipliers: stuck-at bit faults per unit
    mult_fault_rate: float = 0.02
    mult_fault_mag: float = 0.05

    def scaled(self, factor: float) -> "VariationModel":
        return dataclasses.replace(self, scale=self.scale * factor)


def f32(x) -> torch.Tensor:
    """A float32 0-d tensor on the host (a Python float rounds once)."""
    return torch.as_tensor(x, dtype=torch.float32).clone()


def _normal(key) -> torch.Tensor:
    return prng.normal(key, ())


def sample_profile(key, model: VariationModel = VariationModel()) -> ChipProfile:
    """Draw one chip from the population (deterministic in ``key``, a
    threefry key pair)."""
    ks = prng.split(key, 8)
    s = model.scale

    def gain_family(k, gain_std, offset_std, spread):
        kg, ko = prng.split(k)
        return {
            "gain": f32(1.0 + (s * gain_std) * _normal(kg)),
            "offset": f32((s * offset_std) * _normal(ko)),
            "spread": f32(abs(s * spread)),
        }

    def fault_family(k, rate, mag):
        # the fault magnitude is itself a chip draw (which bit is stuck)
        return {
            "fault_rate": f32(min(abs(s * rate), 0.5)),
            "fault_mag": f32(abs(s * mag) * (0.5 + torch.abs(_normal(k)))),
        }

    profile = {
        # identity key of the per-column patterns, apart from the draws above
        "key": prng.fold_in(key, CHIP_KEY_FOLD),
        # the seed of the chip's drift paths (repro_torch.hw.drift)
        "seed": prng.randint(ks[6], (), 0, INT32_MAX),
        "age": f32(0.0),  # tokens served: the drift clock
        "sc": gain_family(ks[0], model.sc_gain_std, model.sc_offset_std, model.sc_spread),
        "analog": gain_family(ks[1], model.analog_gain_std, model.analog_offset_std,
                              model.analog_spread),
        "approx_mult": fault_family(ks[2], model.mult_fault_rate, model.mult_fault_mag),
        "log_mult": fault_family(ks[3], model.mult_fault_rate, model.mult_fault_mag),
    }
    return _with_base(profile)


def _with_base(profile: ChipProfile) -> ChipProfile:
    # the fabrication-time snapshot of every family: drift writes base +
    # W(age) absolutely, so a chip's state at an age does not depend on how
    # its tokens were chunked
    profile["base"] = {name: dict(profile[name]) for name in GAIN_FAMILIES + FAULT_FAMILIES}
    profile["draws"] = {}
    return profile


def nominal_profile() -> ChipProfile:
    """The identity chip: a ChipProfile with the nominal device's values
    (gain 1, offset 0, spread 0, fault rate 0)."""
    zero = f32(0.0)
    gain = {"gain": f32(1.0), "offset": zero, "spread": zero}
    fault = {"fault_rate": zero, "fault_mag": zero}
    return _with_base({
        "key": prng.prng_key(0),
        "seed": torch.tensor(0, dtype=torch.int32),
        "age": zero,
        "sc": dict(gain),
        "analog": dict(gain),
        "approx_mult": dict(fault),
        "log_mult": dict(fault),
    })


def site_key(chip: ChipProfile, site: str):
    return prng.fold_in(chip["key"], zlib.crc32(site.encode()) & 0x7FFFFFFF)


def _pattern(chip: ChipProfile, site: str, kind: str, n: int, dtype, device):
    """The chip's per-column draws at ``site``: ``eps`` (a gain family's
    spread pattern, in ``dtype`` as the reference casts it, held as
    float32) or ``(u, sign)`` (a fault family's), made once and kept."""
    memo = chip.setdefault("draws", {})
    device = torch.device(device)
    k = (site, kind, n, dtype if kind == "gain" else None, str(device))
    if k not in memo:
        key = site_key(chip, site)
        if kind == "gain":
            eps = prng.normal(key, (n,)).to(dtype).to(torch.float32)
            memo[k] = eps.to(device)
        else:
            ku, ks = prng.split(key)
            u = prng.uniform(ku, (n,))
            sgn = torch.sign(prng.normal(ks, (n,))) + 0.0
            memo[k] = (u.to(device), sgn.to(device))
    return memo[k]


def chip_epilogue(site: str, backend_name: str, chip: Optional[ChipProfile], n: int, dtype,
                  device="cpu"):
    """The chip's perturbation as epilogue operands ``(colgain, coladd)``
    on ``device``: a gain family gives a per-column gain [n] and the scalar
    offset (``y * colgain + coladd * row_scale(y)``), a fault family
    ``colgain=None`` and the per-column signed error [n] (``y + coladd *
    row_scale(y)``).  Nominal (no chip, a family the profile lacks, the
    exact backend) is ``(None, None)``.  The one definition of the chip's
    terms: the composed path (:func:`apply_chip`) and the fused kernels
    both take it.

    Types follow the reference's: the spread times ``eps`` (already in
    ``dtype``) is float32, since the profile's leaves are float32, and the
    sum is cast to ``dtype`` only then.  The profile's host scalars enter
    the device's ops as 0-d operands, with no copy; the offset is filled in
    on ``device``, where the kernels read it (a copy of a host tensor would
    wait for the device's queue)."""
    if chip is None:
        return None, None
    fam = chip.get(backend_name)
    if fam is None:
        return None, None
    device = torch.device(device)
    if "gain" in fam:
        eps = _pattern(chip, site, "gain", n, dtype, device)
        gain = (fam["gain"] + fam["spread"] * eps).to(dtype)
        return gain, torch.full((), float(fam["offset"].to(dtype)), dtype=dtype, device=device)
    u, sgn = _pattern(chip, site, "fault", n, dtype, device)
    mask = (u < fam["fault_rate"]).to(dtype)
    err = (mask * sgn.to(dtype)) * fam["fault_mag"].to(dtype)
    return None, err


def apply_chip(y, site: str, backend_name: str, chip: Optional[ChipProfile]):
    """What the chip computes for the nominal emulated output ``y`` of a
    projection at ``site`` on ``backend_name``; ``y`` itself when the chip
    is nominal.  The additive terms are in units of the detached per-token
    row scale, so a request sees the same chip error whatever shares its
    batch."""
    colgain, coladd = chip_epilogue(site, backend_name, chip, y.shape[-1], y.dtype, y.device)
    if coladd is None:
        return y
    return apply_epilogue(y, colgain=colgain, coladd=coladd)
