"""Configuration dataclasses (copy of the parts of ``repro.configs.base``
the serving slice needs).

* :class:`ModelConfig`  — architecture definition (one per ``--arch``).
* :class:`ApproxConfig` — which approximate-hardware backend a model is
  served for, with each backend's hardware parameters, and which mode
  (bit-accurate MODEL emulation or none).
"""
from __future__ import annotations

import dataclasses
import enum
import fnmatch
import functools
from typing import Tuple


class Backend(str, enum.Enum):
    """Which approximate hardware the model will execute on; the value
    doubles as the registry key and the per-backend params field name."""

    EXACT = "exact"            # plain floating point (baseline)
    SC = "sc"                  # stochastic computing (OR-accumulation)
    APPROX_MULT = "approx_mult"  # approximate multiplier (mul7u_09Y family)
    ANALOG = "analog"          # analog array + low-bit ADC partial sums
    LOG_MULT = "log_mult"      # Mitchell log-domain multiplier


@dataclasses.dataclass(frozen=True)
class SCParams:
    """Stochastic computing: split-unipolar streams, OR accumulation."""

    bits: int = 32             # stream length (split-unipolar => 2x streams)
    gain: float = 0.25         # value->probability gain before streaming


@dataclasses.dataclass(frozen=True)
class ApproxMultParams:
    """Behavioural truncated approximate multiplier (mul7u_* family)."""

    bits: int = 7              # operand bits (mul7u_*)
    perforate: int = 2         # low partial-product rows dropped (error model)


@dataclasses.dataclass(frozen=True)
class AnalogParams:
    """Analog crossbar arrays with low-bit ADC partial-sum readout."""

    adc_bits: int = 4          # partial-sum quantizer resolution
    array_size: int = 128      # accumulations per analog array (K-block)
    adc_range: float = 4.0     # clamp range of a partial sum, in units of
                               # the input scale (HardTanh saturation point)
    weight_bits: int = 8       # operand quantization on the array
    input_bits: int = 8


@dataclasses.dataclass(frozen=True)
class LogMultParams:
    """Mitchell log-domain multiplier: log2-add, piecewise-linear antilog."""

    bits: int = 8              # operand magnitude bits


class TrainMode(str, enum.Enum):
    """How the approximate hardware is treated.  Serving uses MODEL
    (bit-accurate emulation) or NO_MODEL (exact); PROXY_ONLY and INJECT
    belong to training and are not ported yet."""

    NO_MODEL = "no_model"
    MODEL = "model"
    PROXY_ONLY = "proxy_only"
    INJECT = "inject"


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    backend: Backend = Backend.EXACT   # default backend for every site
    mode: TrainMode = TrainMode.NO_MODEL

    # per-backend hardware parameters (field name == Backend value)
    sc: SCParams = SCParams()
    approx_mult: ApproxMultParams = ApproxMultParams()
    analog: AnalogParams = AnalogParams()
    log_mult: LogMultParams = LogMultParams()

    # ordered (site-pattern, backend-name) pairs; first fnmatch match wins
    site_backends: Tuple[Tuple[str, str], ...] = ()

    skip_lm_head: bool = False  # keep the LM head exact

    def __post_init__(self):
        for entry in self.site_backends:
            if len(tuple(entry)) != 2:
                raise ValueError(
                    "site_backends entries must be (site-pattern, backend-name) "
                    f"pairs, e.g. ('attn_*', 'log_mult'); got {entry!r}"
                )
            Backend(entry[1])  # unknown names fail here, not mid-forward

    def backend_for(self, site: str) -> Backend:
        """The backend a projection site executes on (override map first)."""
        hit = _match_backend(self.site_backends, site)
        return self.backend if hit is None else hit

    def params_for(self, backend):
        """The per-backend params instance (None for exact)."""
        backend = Backend(backend)
        if backend == Backend.EXACT:
            return None
        return getattr(self, backend.value)

    @property
    def approx_backends(self) -> Tuple[Backend, ...]:
        """Every non-exact backend this config can route a site to."""
        out = [] if self.backend == Backend.EXACT else [self.backend]
        for _, name in self.site_backends:
            b = Backend(name)
            if b != Backend.EXACT and b not in out:
                out.append(b)
        return tuple(out)

    @property
    def active(self) -> bool:
        return bool(self.approx_backends) and self.mode != TrainMode.NO_MODEL


@functools.lru_cache(maxsize=4096)
def _match_backend(site_backends: Tuple, site: str):
    for pattern, name in site_backends:
        if fnmatch.fnmatchcase(site, pattern):
            return Backend(name)
    return None


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    AUDIO = "audio"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                    # 0 => d_model // n_heads

    qkv_bias: bool = False             # qwen2.5 style
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
