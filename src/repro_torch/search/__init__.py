"""Hardware-aware approximation search (port of ``repro.search``): which
projection sites of a model should run on which approximate hardware.

* :mod:`repro_torch.search.costmodel`   — prices a ``site_backends`` map
  in joules-equivalents (each ``BackendSpec.energy`` model times the
  per-site MAC counts of ``launch/dryrun.per_site_macs``).
* :mod:`repro_torch.search.sensitivity` — per-(site, backend) loss
  sensitivity: first-order grad·Δ through the ``blend`` probe, checked by
  swap-one-site hardware-eval deltas.
* :mod:`repro_torch.search.pareto`      — greedy ratchet and mutation
  search over site->backend maps; a non-dominated (energy, hw-eval loss)
  front, budget queries, and specs for every ``--site-backend`` flag.

Command line: ``python -m repro_torch.launch.search``.
"""
from repro_torch.search.costmodel import (  # noqa: F401
    assignment_energy,
    map_energy,
    model_sites,
    site_costs,
)
from repro_torch.search.pareto import Candidate, SearchResult, pareto_front, search  # noqa: F401
from repro_torch.search.sensitivity import SensitivityProfile, profile_sensitivity  # noqa: F401
