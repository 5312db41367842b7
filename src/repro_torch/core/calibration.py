"""Error-statistics calibration (port of ``repro.core.calibration``:
``effective_degree``, ``init_site``, ``init_site_for``, ``fit_error_stats``,
``predict_mean`` and ``sample_error``).

Type 1 (SC, approximate and log multipliers): the residual between the
bit-accurate emulation and the fast proxy forward is modelled per layer as
two polynomials of the fast output value, mean(err | y) and var(err | y),
fitted on a calibration batch (paper Sec. 3.2).  Type 2 (analog): one
scalar mean and variance per layer, a degree-0 fit.  A site's degree comes
from its backend's ``calib_degree`` (else ``ApproxConfig.poly_degree``),
so a heterogeneous config keys its stats per (site, backend).

A site is ``{"mean": [deg+1], "var": [deg+1], "scale": []}``, float32.
The polynomials go through :func:`repro_torch.kernels.epilogue.eval_poly`,
the same sequential evaluator the fused kernels' epilogue uses, as the
reference's do.  INJECT mode's noise is ``jax.random.normal`` of the
site's key path (:func:`repro_torch.kernels.ops.normal`: the plain
threefry on the CPU, one launch of ``csrc/prng.cu`` on the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ApproxConfig, Backend
from repro_torch.core import registry
from repro_torch.kernels import ops as kops
from repro_torch.kernels.epilogue import eval_poly, ipow

CalibSite = Dict[str, torch.Tensor]

MAX_FIT_POINTS = 8192
RIDGE = 1e-4
SCALE_EPS = 1e-6


def effective_degree(cfg: ApproxConfig, backend: Optional[Backend] = None) -> int:
    """The error polynomial's degree for a backend: its spec's
    ``calib_degree``, else the config's ``poly_degree``."""
    backend = backend if backend is not None else cfg.backend
    spec_degree = registry.get(backend).calib_degree
    return cfg.poly_degree if spec_degree is None else spec_degree


def init_site(degree: int, device="cpu") -> CalibSite:
    return {
        "mean": torch.zeros((degree + 1,), dtype=torch.float32, device=device),
        "var": torch.zeros((degree + 1,), dtype=torch.float32, device=device),
        "scale": torch.ones((), dtype=torch.float32, device=device),
    }


def init_site_for(cfg: ApproxConfig, site: str, device="cpu") -> CalibSite:
    """Zero stats shaped for the backend ``site`` resolves to."""
    return init_site(effective_degree(cfg, cfg.backend_for(site)), device)


def _basis(t, degree: int):
    """[N, degree+1] power basis, ``t**i`` as ``jax.lax.integer_pow``."""
    cols = [torch.ones_like(t)] + [ipow(t, i) for i in range(1, degree + 1)]
    return torch.stack(cols, dim=-1)


def _subsample(x):
    flat = x.reshape(-1).to(torch.float32)
    stride = max(1, flat.shape[0] // MAX_FIT_POINTS)
    return flat[::stride][:MAX_FIT_POINTS]


def fit_error_stats(y_fast, resid, degree: int) -> CalibSite:
    """Fit mean(resid | y_fast) and var(resid | y_fast) polynomials: ridge
    normal equations on a strided subsample of at most 8192 points."""
    y = _subsample(y_fast)
    r = _subsample(resid)
    scale = torch.clamp_min(torch.amax(torch.abs(y)), SCALE_EPS)
    t = y / scale
    V = _basis(t, degree)  # [N, P]
    eye = torch.eye(degree + 1, dtype=torch.float32, device=y.device)
    G = V.T @ V + RIDGE * eye
    # a singular system (at 8192 points the ridge is below float32's
    # resolution: a site whose outputs take three values makes t and t**3
    # one column) gives NaN coefficients, as jnp.linalg.solve does, and
    # raises nothing (nor waits on the device to check)
    c_mean = torch.linalg.solve_ex(G, V.T @ r, check_errors=False).result
    r2 = torch.square(r - V @ c_mean)
    c_var = torch.linalg.solve_ex(G, V.T @ r2, check_errors=False).result
    return {"mean": c_mean, "var": c_var, "scale": scale}


def predict_mean(site: CalibSite, y):
    """The fitted conditional mean error at output values ``y`` (float32)."""
    t = y.to(torch.float32) / site["scale"]
    return eval_poly(site["mean"], t)


def sample_error(site: CalibSite, y_fast, path: Sequence[int], std_scale: float = 1.0):
    """The injected error for a fast-forward output (paper Sec. 3.2): the
    mean polynomial plus Gaussian noise of the fitted value-dependent std,
    the noise ``jax.random.normal`` of the key path ``path``."""
    t = y_fast.to(torch.float32) / site["scale"]
    mean = eval_poly(site["mean"], t)
    var = torch.clamp_min(eval_poly(site["var"], t), 0.0)
    noise = kops.normal(path, y_fast.shape, y_fast.device)
    err = mean + torch.sqrt(var) * noise * std_scale
    return err.to(y_fast.dtype)
