"""Configuration dataclasses (copy of the parts of ``repro.configs.base``
the serving and training slices need).

* :class:`ModelConfig`  — architecture definition (one per ``--arch``).
* :class:`ApproxConfig` — which approximate-hardware backend a model is
  served or trained for, with each backend's hardware parameters, the
  mode (MODEL, INJECT, PROXY_ONLY or none) and the calibration knobs.
* :class:`TrainConfig`  — the optimizer's schedule and the memory policy
  the training steps read.
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
    """How the approximate hardware is treated: MODEL (bit-accurate
    emulated forward, proxy backward; also what serving runs), INJECT
    (fast forward plus calibrated error), PROXY_ONLY (the proxy forward
    and backward, an ablation) or NO_MODEL (exact)."""

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

    # --- ablations ---
    proxy_in_backward: bool = True  # False => backprop through plain matmul
                                    # (the paper's Tab. 2 "without activation")

    # --- error injection / calibration (Sec. 3.2) ---
    poly_degree: int = 3         # degree of mean/std error polynomials (Type 1)
    calibrate_every: int = 10    # steps between calibration batches
    inject_std_scale: float = 1.0

    skip_lm_head: bool = False  # keep the LM head exact

    def __post_init__(self):
        # a params object of the wrong class fails here, not by running the
        # experiment on default hardware knobs
        for field_name, cls in (
            ("sc", SCParams),
            ("approx_mult", ApproxMultParams),
            ("analog", AnalogParams),
            ("log_mult", LogMultParams),
        ):
            value = getattr(self, field_name)
            if not isinstance(value, cls):
                raise TypeError(
                    f"ApproxConfig.{field_name} must be a {cls.__name__}; "
                    f"got {type(value).__name__}"
                )
        for entry in self.site_backends:
            if len(tuple(entry)) != 2:
                raise ValueError(
                    "site_backends entries must be (site-pattern, backend-name) "
                    f"pairs, e.g. ('attn_*', 'log_mult'); got {entry!r}"
                )
            try:
                resolve_backend(entry[1])  # unknown names fail here, not mid-forward
            except KeyError as e:
                raise ValueError(f"site_backends: {e.args[0]}") from None

    def backend_for(self, site: str):
        """The backend a projection site executes on (override map first):
        a :class:`Backend` member, or the registry name of a backend
        registered outside the enum."""
        hit = _match_backend(self.site_backends, site)
        return self.backend if hit is None else hit

    def params_for(self, backend):
        """The per-backend params instance (None for exact).  Built-in
        backends read the config field of their name; a backend registered
        outside the enum gets its spec's params class's defaults."""
        if backend == Backend.EXACT:
            return None
        name = backend.value if isinstance(backend, Backend) else str(backend)
        from repro_torch.core import registry  # deferred: registry imports this module

        cls = registry.get(name).params_cls
        # a registered name that collides with an unrelated field ('mode',
        # ...) must not be handed that field as its params
        params = getattr(self, name, None)
        if isinstance(params, cls):
            return params
        return None if cls is type(None) else cls()

    @property
    def approx_backends(self) -> Tuple:
        """Every non-exact backend this config can route a site to."""
        out = [] if self.backend == Backend.EXACT else [self.backend]
        for _, name in self.site_backends:
            b = resolve_backend(name)
            if b != Backend.EXACT and b not in out:
                out.append(b)
        return tuple(out)

    @property
    def active(self) -> bool:
        return bool(self.approx_backends) and self.mode != TrainMode.NO_MODEL


def resolve_backend(name: str):
    """The :class:`Backend` member of a built-in name, else the name itself
    once it is found in the backend registry (raises ``KeyError``, listing
    what is registered, for an unknown name)."""
    try:
        return Backend(name)
    except ValueError:
        from repro_torch.core import registry  # deferred: registry imports this module

        registry.get(name)
        return str(name)


@functools.lru_cache(maxsize=4096)
def _match_backend(site_backends: Tuple, site: str):
    for pattern, name in site_backends:
        if fnmatch.fnmatchcase(site, pattern):
            return resolve_backend(name)
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


# ---------------------------------------------------------------------------
# Training configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the reference's ``TrainConfig`` that the training
    steps read.  ``remat`` and ``optim_compress`` take only ``"none"``:
    activation checkpointing and the compressed optimizer state come with
    later slices, and a config asking for them raises here rather than
    training without them."""

    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0

    microbatches: int = 1            # gradient accumulation factor
    remat: str = "none"              # the reference also takes block | group:<k>
    optim_compress: str = "none"     # the reference also takes bf16 | sm3

    def __post_init__(self):
        if self.remat != "none":
            raise NotImplementedError(
                f"TrainConfig.remat={self.remat!r} is not yet ported to repro_torch "
                "(only 'none')"
            )
        if self.optim_compress != "none":
            raise NotImplementedError(
                f"TrainConfig.optim_compress={self.optim_compress!r} is not yet ported to "
                "repro_torch (only 'none')"
            )
        if self.microbatches < 1:
            raise ValueError(f"TrainConfig.microbatches must be >= 1; got {self.microbatches}")
