"""Device instances: chip-to-chip variation, fleets and drift (port of
``repro.hw``).

Every backend in the registry describes a *nominal* device.  Real SC,
analog and approximate-multiplier silicon is a population of imperfect
instances, varied at fabrication and drifting in the field.  This
package models that population:

* :mod:`repro_torch.hw.variation`: per-family variation models sampled
  into a :class:`ChipProfile` of 0-d tensors, and the chip's
  perturbation of an emulated output (``apply_chip``, or as epilogue
  operands of the fused kernels, ``chip_epilogue``);
* :mod:`repro_torch.hw.fleet`: a seeded chip sampler with per-chip
  calibration state, token counters and retirement;
* :mod:`repro_torch.hw.drift`: drift of a chip's profile as a pure
  function of the tokens it served.

Consumers: variation-aware training (``Phase(fleet=N)`` trains each step
against a chip of the fleet) and the serving engine (each emulated lane
bound to a chip, drifting as it serves, recalibrated online).
"""
from repro_torch.hw.drift import DriftModel, advance
from repro_torch.hw.fleet import Fleet
from repro_torch.hw.variation import (
    ChipProfile,
    VariationModel,
    apply_chip,
    chip_epilogue,
    nominal_profile,
    sample_profile,
)

__all__ = [
    "ChipProfile",
    "DriftModel",
    "Fleet",
    "VariationModel",
    "advance",
    "apply_chip",
    "chip_epilogue",
    "nominal_profile",
    "sample_profile",
]
