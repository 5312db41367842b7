"""Energy pricing of ``site_backends`` maps in joules-equivalents (copy of
``repro.search.costmodel``; pure arithmetic).

The unit is one exact digital MAC.  Every :class:`~repro_torch.core.
registry.BackendSpec` carries a parametric ``energy`` model (the paper's
Tab. 1 relative op costs, scaled by the backend's knobs), and
:func:`repro_torch.launch.dryrun.per_site_macs` gives the per-site MAC
counts, so the price of an assignment is

    sum_site  macs(site) * e_mac(backend(site), params)
            + macs(site)/k(site) * poly_cost(calib degree)

The second term is the deployed error-correction polynomial (~2 * degree
exact MACs per output element, amortised over the site's contraction
dim).  Sites the config's skip flags keep exact are priced exact, as
``dense()`` runs them.

**Measured energy** (:func:`load_measured_energy`): every pricing entry
point takes an optional ``measured`` table of per-backend per-MAC numbers
(a JSON file, ``launch/search.py --energy-json``) that overrides the
analytic models backend by backend; the correction polynomial is charged
either way.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

from repro_torch.configs.base import ApproxConfig, Backend, ModelConfig
from repro_torch.core import calibration, registry
from repro_torch.core.approx_linear import skipped_site
from repro_torch.launch.dryrun import per_site_macs

_POLY_MACS_PER_COEFF = 2.0  # Horner step: one multiply + one add per degree

# Per-MAC price of a backward matmul routed through the int8 datapath (the
# gated VJP of repro_torch.core.injection).  An 8-bit multiply-accumulate is ~4x
# cheaper than the fp32 exact MAC in the paper's Tab. 1 op-cost scale
# (multiplier energy quadratic in operand width); the int8 quantisation of
# the operands is amortised over the contraction dim like the correction
# polynomial, and folded into this constant.
INT8_BWD_MAC_ENERGY = 0.25


def site_costs(
    cfg: ModelConfig, seq_len: int = 1, batch: int = 1
) -> Dict[str, Dict[str, float]]:
    """``{site: {"macs", "bwd_macs", "k"}}`` for one training step's
    forward (``macs``) and backward (``bwd_macs``) passes (see dryrun)."""
    return per_site_macs(cfg, seq_len=seq_len, batch=batch)


def model_sites(cfg: ModelConfig) -> Tuple[str, ...]:
    """The projection sites this architecture executes: the universe a
    search assigns backends over (a subset of ``transformer.ALL_SITES``)."""
    return tuple(site_costs(cfg, 1, 1))


def backend_for_pricing(approx: ApproxConfig, site: str):
    """The backend a site is *priced* at: the resolved per-site backend,
    unless a skip_* flag pins the site exact (same rule as ``dense()``)."""
    if skipped_site(site, approx):
        return Backend.EXACT
    return approx.backend_for(site)


MeasuredEnergy = Dict[str, float]  # backend registry name -> per-MAC energy


def load_measured_energy(source: Union[str, Mapping]) -> MeasuredEnergy:
    """Load + schema-validate a measured per-MAC energy table.

    ``source`` is a JSON file path or an already-parsed mapping.  Schema:
    a JSON object mapping backend registry names to positive numbers (or
    ``{"per_mac": number}`` objects, so richer measurement reports can be
    fed in unchanged).  Unknown backends, non-numeric or non-positive
    values fail with a message naming the offending entry — a silently
    mispriced search is worse than no search.
    """
    if isinstance(source, (str, os.PathLike)):
        try:
            with open(source) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(f"--energy-json {source!r}: {e}") from None
    else:
        doc = source
    if not isinstance(doc, Mapping):
        raise ValueError(
            "measured-energy JSON must be an object mapping backend names "
            f"to per-MAC energies; got {type(doc).__name__}"
        )
    out: MeasuredEnergy = {}
    for name, value in doc.items():
        try:
            registry.get(name)  # unknown backends fail, listing what's known
        except KeyError as e:
            raise ValueError(f"measured-energy JSON: {e.args[0]}") from None
        if isinstance(value, Mapping):
            if "per_mac" not in value:
                raise ValueError(
                    f"measured-energy JSON: {name!r} object needs a "
                    f"'per_mac' field; got keys {sorted(value)}"
                )
            value = value["per_mac"]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(
                f"measured-energy JSON: {name!r} must be a number "
                f"(per-MAC energy, exact MAC = 1.0); got {value!r}"
            )
        if not value > 0.0:
            raise ValueError(
                f"measured-energy JSON: {name!r} per-MAC energy must be "
                f"> 0; got {value} (zero-cost hardware breaks Pareto search)"
            )
        out[str(name)] = float(value)
    return out


def site_mac_energy(
    approx: ApproxConfig,
    site: str,
    k_dim: float,
    measured: Optional[MeasuredEnergy] = None,
) -> float:
    """Relative energy per MAC at ``site`` under ``approx`` (exact = 1.0),
    including the amortized deployed error-correction polynomial.
    ``measured`` entries override the analytic backend energy models."""
    backend = backend_for_pricing(approx, site)
    spec = registry.get(backend)
    name = backend.value if isinstance(backend, Backend) else str(backend)
    if measured is not None and name in measured:
        e = measured[name]
    else:
        e = spec.mac_energy(approx.params_for(backend))
    if backend != Backend.EXACT:
        degree = calibration.effective_degree(approx, backend)
        e += _POLY_MACS_PER_COEFF * degree / max(k_dim, 1.0)
    return e


def map_energy(
    cfg: ModelConfig,
    approx: ApproxConfig,
    *,
    seq_len: int = 1,
    batch: int = 1,
    costs: Optional[Dict[str, Dict[str, float]]] = None,
    measured: Optional[MeasuredEnergy] = None,
) -> float:
    """Total joules-equivalents of one forward pass under ``approx``."""
    costs = costs if costs is not None else site_costs(cfg, seq_len, batch)
    return sum(
        c["macs"] * site_mac_energy(approx, site, c["k"], measured=measured)
        for site, c in costs.items()
    )


def backward_map_energy(
    cfg: ModelConfig,
    approx: ApproxConfig,
    *,
    gate=None,
    seq_len: int = 1,
    batch: int = 1,
    costs: Optional[Dict[str, Dict[str, float]]] = None,
    measured: Optional[MeasuredEnergy] = None,
) -> float:
    """Modeled joules-equivalents of one backward pass under ``gate``.

    ``gate`` selects which sites run their gradient matmuls on the int8
    datapath (:data:`INT8_BWD_MAC_ENERGY` per MAC) instead of exact fp32
    (1.0 per MAC): either a runtime ``[S]`` mask over
    ``switch.SITE_ORDER`` (:func:`repro_torch.core.switch.backward_gate`),
    a ``{site: 0/1}`` mapping, or ``None`` for
    the all-exact backward.  The backward MAC counts come from
    ``per_site_macs``'s ``bwd_macs`` (2x forward).  ``measured``
    only prices the forward pass and is accepted for signature symmetry
    with :func:`map_energy`.
    """
    del approx, measured  # backward pricing is exact-vs-int8, not backend
    costs = costs if costs is not None else site_costs(cfg, seq_len, batch)
    if gate is None:
        open_sites = frozenset()
    elif isinstance(gate, Mapping):
        open_sites = frozenset(s for s, v in gate.items() if int(v))
    else:
        from repro_torch.core import switch as switch_lib

        gate = [int(v) for v in gate]
        if len(gate) != len(switch_lib.SITE_ORDER):
            raise ValueError(
                f"gate mask has {len(gate)} entries; expected one per "
                f"site in switch.SITE_ORDER ({len(switch_lib.SITE_ORDER)})"
            )
        open_sites = frozenset(
            s for s, v in zip(switch_lib.SITE_ORDER, gate) if v
        )
    return sum(
        c.get("bwd_macs", 2.0 * c["macs"])
        * (INT8_BWD_MAC_ENERGY if site in open_sites else 1.0)
        for site, c in costs.items()
    )


def train_map_energy(
    cfg: ModelConfig,
    approx: ApproxConfig,
    *,
    gate=None,
    seq_len: int = 1,
    batch: int = 1,
    costs: Optional[Dict[str, Dict[str, float]]] = None,
    measured: Optional[MeasuredEnergy] = None,
) -> float:
    """One training step's modeled energy: forward under ``approx`` plus
    backward under ``gate`` (see :func:`backward_map_energy`)."""
    costs = costs if costs is not None else site_costs(cfg, seq_len, batch)
    return map_energy(
        cfg, approx, seq_len=seq_len, batch=batch, costs=costs,
        measured=measured,
    ) + backward_map_energy(
        cfg, approx, gate=gate, seq_len=seq_len, batch=batch, costs=costs,
    )


def assignment_energy(
    cfg: ModelConfig,
    base: ApproxConfig,
    assignment: Iterable[Tuple[str, str]],
    *,
    seq_len: int = 1,
    batch: int = 1,
    costs: Optional[Dict[str, Dict[str, float]]] = None,
    measured: Optional[MeasuredEnergy] = None,
) -> float:
    """Energy of a concrete site->backend assignment on top of ``base``
    (default backend forced exact: unassigned sites are priced exact)."""
    approx = dataclasses.replace(
        base, backend=Backend.EXACT, site_backends=tuple(assignment)
    )
    return map_energy(
        cfg, approx, seq_len=seq_len, batch=batch, costs=costs,
        measured=measured,
    )


def energy_report(
    cfg: ModelConfig,
    approx: ApproxConfig,
    *,
    seq_len: int = 1,
    batch: int = 1,
    measured: Optional[MeasuredEnergy] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-site pricing breakdown (for CLI reports / JSON artifacts)."""
    costs = site_costs(cfg, seq_len, batch)
    out: Dict[str, Dict[str, float]] = {}
    for site, c in costs.items():
        backend = backend_for_pricing(approx, site)
        e = site_mac_energy(approx, site, c["k"], measured=measured)
        out[site] = {
            "backend": backend.value if isinstance(backend, Backend) else str(backend),
            "macs": c["macs"],
            "energy_per_mac": e,
            "energy": c["macs"] * e,
        }
    return out
