"""One-compile heterogeneous dispatch: backend choice as a runtime index
(copy of ``repro.core.switch``; numpy only).

The static path resolves each projection site's backend from the config
(``ApproxConfig.backend_for``), so every distinct ``site_backends`` map is
a distinct step (in the reference a distinct compiled graph) and a
distinct serving lane.  This module makes the choice a runtime operand
instead:

* :func:`table` — the registry-ordered switch table, ``("exact",) +
  registry.approx_names()``: exact at 0, the approximate backends after it
  in sorted registry order (backends registered later join it).
* :func:`site_indices` — one cached pure-Python pass resolving a config's
  ``site_backends`` fnmatch map over :data:`SITE_ORDER` into an int32
  ``[n_sites]`` index array (skip flags folded to exact), once per
  distinct config (:func:`resolution_count` counts the passes).
* :func:`canonical` — the config with backend and site map erased: the key
  under which every map of one mode shares one step or serving lane.
* :func:`model_indices` — per-layer index arrays, ``{"layers": [L, S],
  "head": [S]}``, laid out like the calibration tree.

``dense()`` (:mod:`repro_torch.core.approx_linear`) consumes the index
through ``ApproxCtx.site_idx``: a per-site scalar picks one branch on the
host; a per-row matrix ``[rows, n_sites]`` runs the selected branches over
the whole batch and picks rows (the engine's merged lanes).  Backend knob
params stay those of the canonical config.

Equivalence: a switch branch and the static path run the same
``_approx_branch``, op for op and eagerly, so in the port switch dispatch is
bitwise equal to static dispatch per projection and per model (the
reference's contract is per projection only: XLA fuses a whole-model graph
differently around a ``lax.switch``).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ApproxConfig, Backend, Family, ModelConfig

# Every dense() call-site name across the reference's model zoo, in fixed
# order: the axis the index arrays are laid out over.  Must stay equal to
# repro_torch.models.transformer.ALL_SITES (tests/test_torch_switch.py
# asserts it; defined here too because core must not import models).
SITE_ORDER: Tuple[str, ...] = (
    "attn_q", "attn_k", "attn_v", "attn_o",
    "mlp_gate", "mlp_up", "mlp_down",
    "moe_gate", "moe_up", "moe_down",
    "ssm_in", "ssm_out",
    "moe_router", "lm_head",
)
_SITE_POS: Dict[str, int] = {s: i for i, s in enumerate(SITE_ORDER)}


def site_pos(site: str) -> Optional[int]:
    """Index of ``site`` along the SITE_ORDER axis (None if unknown)."""
    return _SITE_POS.get(site)


def table() -> Tuple[str, ...]:
    """The switch table: exact at 0, then every registered approximate
    backend in sorted (registry) order.  Computed per call so backends
    registered after import still join; sorted order keeps the indices
    stable for a fixed registry population."""
    from repro_torch.core import registry  # deferred: registry pulls in backends

    return (Backend.EXACT.value,) + registry.approx_names()


def subtable(backends: Sequence[str]) -> Tuple[str, ...]:
    """A restricted switch table over ``backends`` (exact always at 0,
    the rest in sorted order — the same ordering rule as :func:`table`).

    A closed candidate set (the search's) carries the result on
    ``ApproxConfig.switch_backends`` and resolves index arrays with
    ``site_indices(..., table=...)`` against the same sub-table."""
    full = table()
    names = []
    for b in backends:
        name = b.value if isinstance(b, Backend) else str(b)
        if name not in full:
            raise KeyError(
                f"backend {name!r} is not in the switch table {full}; "
                "register it before the first switch-dispatched trace"
            )
        if name != Backend.EXACT.value:
            names.append(name)
    return (Backend.EXACT.value,) + tuple(sorted(set(names)))


def backend_index(backend, table_: Optional[Tuple[str, ...]] = None) -> int:
    """Switch-table index of a backend (enum member or registry name),
    in the full table or a :func:`subtable`."""
    name = backend.value if isinstance(backend, Backend) else str(backend)
    t = table_ or table()
    try:
        return t.index(name)
    except ValueError:
        raise KeyError(
            f"backend {name!r} is not in the switch table {t}; register it "
            "before the first switch-dispatched trace"
        ) from None


# ---------------------------------------------------------------------------
# Cached site resolution (the one fnmatch pass per config)
# ---------------------------------------------------------------------------

_RESOLUTIONS = 0


def resolution_count() -> int:
    """How many full site-map resolutions have run (cache misses): tests
    assert one resolution per distinct config no matter how often the
    indices are consumed."""
    return _RESOLUTIONS


@functools.lru_cache(maxsize=None)
def _site_indices_cached(
    cfg: ApproxConfig, table_: Optional[Tuple[str, ...]]
) -> Tuple[int, ...]:
    global _RESOLUTIONS
    _RESOLUTIONS += 1
    from repro_torch.core.approx_linear import skipped_site  # deferred, no cycle

    t = table_ or table()
    out = []
    for site in SITE_ORDER:
        if skipped_site(site, cfg):
            out.append(0)
            continue
        b = cfg.backend_for(site)
        name = b.value if isinstance(b, Backend) else str(b)
        out.append(t.index(name))
    return tuple(out)


def site_indices(
    cfg: ApproxConfig, table: Optional[Sequence[str]] = None
) -> np.ndarray:
    """Per-site switch-table indices for a config — int32 ``[n_sites]``
    over :data:`SITE_ORDER`, with the config's ``skip_*`` flags folded to
    exact.  One cached pure-Python pass per distinct config; the array is
    a step's argument, so maps swap without building a step.  ``table``
    resolves against a :func:`subtable` instead of the full registry
    table; it must match the ``switch_backends`` of the config consuming
    the indices."""
    t = tuple(table) if table is not None else None
    return np.asarray(_site_indices_cached(cfg, t), np.int32)


def backward_gate(
    approx_sites: Optional[Sequence[str]] = None,
    exact_sites: Sequence[str] = (),
) -> np.ndarray:
    """Runtime int8-backward gate mask — int32 ``[n_sites]`` over
    :data:`SITE_ORDER`, 1 = approximate (int8) backward, 0 = exact VJP.

    ``approx_sites=None`` opens every site (then ``exact_sites`` closes
    the named ones — the sensitivity-ranked protection list); otherwise
    only the named ``approx_sites`` open.  ``ApproxCtx.bwd_gate`` reads it
    (:func:`repro_torch.search.sensitivity.backward_gate` derives one from
    the sites' sensitivities).
    """
    if approx_sites is None:
        out = np.ones(len(SITE_ORDER), np.int32)
    else:
        out = np.zeros(len(SITE_ORDER), np.int32)
        for s in approx_sites:
            pos = _SITE_POS.get(s)
            if pos is None:
                raise KeyError(f"unknown site {s!r} (not in SITE_ORDER)")
            out[pos] = 1
    for s in exact_sites:
        pos = _SITE_POS.get(s)
        if pos is None:
            raise KeyError(f"unknown site {s!r} (not in SITE_ORDER)")
        out[pos] = 0
    return out


def mask_site_indices(idx, mask_sites: Sequence[str]) -> np.ndarray:
    """``idx`` with every site matching a ``mask_sites`` fnmatch pattern
    demoted to exact (index 0).

    ``idx`` is any index array whose LAST axis runs over
    :data:`SITE_ORDER` (``[S]`` rows, the engine's per-slot ``[B, S]``
    matrices, :func:`model_indices`' ``[L, S]`` stacks).  This is the
    per-chip fault-demotion seam: a chip with stuck-at faults confined to
    a few projection sites keeps serving with just those sites forced
    exact (a runtime index-array swap) instead of the whole chip being
    retired.  Returns a new int32 array; the input
    is not mutated."""
    arr = np.array(idx, dtype=np.int32, copy=True)
    if arr.shape[-1] != len(SITE_ORDER):
        raise ValueError(
            f"last axis must run over SITE_ORDER ({len(SITE_ORDER)} sites); "
            f"got shape {arr.shape}"
        )
    if not mask_sites:
        return arr
    hit = np.zeros(len(SITE_ORDER), bool)
    for i, site in enumerate(SITE_ORDER):
        if any(fnmatch.fnmatch(site, p) for p in mask_sites):
            hit[i] = True
    arr[..., hit] = 0
    return arr


def canonical(cfg: ApproxConfig) -> ApproxConfig:
    """The switch-dispatch cache key: ``cfg`` with the backend map erased
    (default backend exact, no site overrides) but mode, per-backend
    knob params, and skip flags kept: every map of one mode and knob set
    shares the one step (or serving lane) keyed on this."""
    return dataclasses.replace(
        cfg, backend=Backend.EXACT, site_backends=()
    )


# ---------------------------------------------------------------------------
# Per-layer index arrays (laid out like the calibration tree)
# ---------------------------------------------------------------------------


def model_indices(
    cfg: ModelConfig,
    approx: ApproxConfig,
    layer_maps: Optional[Sequence[Optional[Tuple[Tuple[str, str], ...]]]] = None,
    table: Optional[Sequence[str]] = None,
    mask_sites: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """Index arrays for a whole model, laid out as the calibration tree:
    ``{"layers": [L, S], "head": [S]}``; a HYBRID model's ``"layers"`` are
    ``[G, k, S]``, beside ``"shared": [G, S]`` (and ``"tail": [t, S]``).

    ``layer_maps`` (optional, length ``cfg.n_layers``) gives each layer
    its own ``site_backends`` tuple; ``None`` entries (or no
    ``layer_maps``) inherit ``approx``'s map.  A HYBRID model's maps index
    its mamba layers group-major, then the tail; its shared block takes
    ``approx``'s map.  Pass the result as ``apply_model(backend_idx=...)``.
    ``mask_sites`` (fnmatch patterns) demotes matching sites to exact in
    every entry, after the layer maps resolve (:func:`mask_site_indices`).
    """
    base = site_indices(approx, table=table)
    n = cfg.n_layers
    if layer_maps is None:
        per_layer = [base] * n
    else:
        if len(layer_maps) != n:
            raise ValueError(
                f"layer_maps must have one entry per layer ({n}); "
                f"got {len(layer_maps)}"
            )
        per_layer = [
            base if m is None
            else site_indices(
                dataclasses.replace(approx, site_backends=tuple(m)),
                table=table,
            )
            for m in layer_maps
        ]
    stacked = np.stack(per_layer).astype(np.int32)  # [L, S]
    out: Dict[str, np.ndarray] = {"head": base}
    if cfg.family == Family.HYBRID:
        k = cfg.shared_attn_every
        G, tail = n // k, n % k
        out["layers"] = stacked[: G * k].reshape(G, k, len(SITE_ORDER))
        out["shared"] = np.tile(base, (G, 1))
        if tail:
            out["tail"] = stacked[G * k:]
    else:
        out["layers"] = stacked
    if mask_sites:
        out = {k: mask_site_indices(v, mask_sites) for k, v in out.items()}
    return out
