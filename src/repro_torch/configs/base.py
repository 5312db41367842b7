"""Configuration dataclasses (copy of the parts of ``repro.configs.base``
the serving and training slices need).

* :class:`ModelConfig`  — architecture definition (one per ``--arch``).
* :class:`ApproxConfig` — which approximate-hardware backend a model is
  served or trained for, with each backend's hardware parameters, the
  mode (MODEL, INJECT, PROXY_ONLY or none) and the calibration knobs.
* :class:`Phase` and :class:`CalibPolicy` — one segment of a declarative
  training schedule and its calibration policy; :func:`parse_phase_specs`
  and :func:`parse_site_backends` read them from the command line.
* :class:`TrainConfig`  — the optimizer's schedule, the memory policy,
  checkpointing and the phase schedule the Trainer reads.
"""
from __future__ import annotations

import dataclasses
import enum
import fnmatch
import functools
from typing import Optional, Tuple


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


# ---------------------------------------------------------------------------
# Declarative phase schedule (paper Sec. 3.2 / 3.3).
#
# The paper's 18x training-cost lever is *scheduling*: most steps run in
# cheap modes (proxy / injection), a small well-placed fraction in the
# expensive bit-accurate MODEL emulation and calibration.  A schedule is a
# tuple of Phase specs on TrainConfig; the resolver / calibration policy
# machinery lives in repro_torch.core.schedule.
# ---------------------------------------------------------------------------


class CalibPolicy(str, enum.Enum):
    """When calibration batches run within a phase.

    EVERY_N  — fixed cadence (phase's ``calibrate_every`` or the config's).
    ADAPTIVE — drift-triggered: the interval halves when consecutive
               calibration losses move more than ``drift_threshold``
               (relative), and doubles (up to ``max_calibrate_every``)
               while they hold steady — spending calibration budget only
               where the error statistics are actually drifting.
    OFF      — no calibration in this phase.
    """

    OFF = "off"
    EVERY_N = "every_n"
    ADAPTIVE = "adaptive"


# CLI / spec-string aliases for phase modes ("exact:100" reads better than
# "no_model:100"; "finetune" is the paper's name for the MODEL tail).
PHASE_MODE_ALIASES = {
    "exact": TrainMode.NO_MODEL,
    "no_model": TrainMode.NO_MODEL,
    "proxy": TrainMode.PROXY_ONLY,
    "proxy_only": TrainMode.PROXY_ONLY,
    "inject": TrainMode.INJECT,
    "model": TrainMode.MODEL,
    "finetune": TrainMode.MODEL,
}


@dataclasses.dataclass(frozen=True)
class Phase:
    """One segment of a multi-phase training schedule.

    Frozen/hashable: phases participate in the step cache's key, so two
    phases that share (mode, lr_scale, microbatches) reuse one built step
    function regardless of step budgets or calibration policy.

    ``fleet > 0`` trains each step against a chip of a sampled fleet
    (variation-aware training).  ``backward`` gates the approximate
    backward: ``"approx"`` derives the sensitivity gate once at the
    phase's entry, ``"auto"`` every ``gate_every`` steps, and the open
    sites run their gradient matmuls on the int8 grid.
    """

    mode: TrainMode
    steps: int
    calibrate: CalibPolicy = CalibPolicy.OFF
    calibrate_every: int = 0       # 0 => ApproxConfig.calibrate_every
    drift_threshold: float = 0.02  # ADAPTIVE: relative calib-loss delta
    max_calibrate_every: int = 0   # ADAPTIVE back-off cap; 0 => 8x base
    lr_scale: float = 1.0          # per-phase LR multiplier
    microbatches: int = 0          # 0 => TrainConfig.microbatches
    fleet: int = 0                 # variation-aware: round-robin a chip
                                   # per step over a fleet of this many
                                   # sampled device instances;
                                   # 0 => nominal hardware
    backward: str = "exact"        # "exact" | "approx" | "auto": gated
                                   # int8 backward;
                                   # "auto" re-derives the sensitivity
                                   # gate every `gate_every` steps
    gate_frac: float = 0.75        # fraction of sites gated approximate
                                   # (the rest — the most sensitive —
                                   # keep exact backward)
    gate_every: int = 25           # "auto": gate refresh cadence (steps)
    name: str = ""                 # label for logs / reports

    def __post_init__(self):
        if not isinstance(self.mode, TrainMode):
            mode = PHASE_MODE_ALIASES.get(str(self.mode))
            if mode is None:
                mode = TrainMode(self.mode)  # raises with the enum's message
            object.__setattr__(self, "mode", mode)
        if not isinstance(self.calibrate, CalibPolicy):
            object.__setattr__(self, "calibrate", CalibPolicy(self.calibrate))
        if self.steps < 1:
            raise ValueError(f"Phase.steps must be >= 1; got {self.steps}")
        if self.lr_scale <= 0:
            raise ValueError(f"Phase.lr_scale must be > 0; got {self.lr_scale}")
        if self.calibrate_every < 0 or self.microbatches < 0 or self.fleet < 0:
            raise ValueError(
                "Phase.calibrate_every / microbatches / fleet must be >= 0"
            )
        if self.backward not in ("exact", "approx", "auto"):
            raise ValueError(
                "Phase.backward must be 'exact', 'approx' or 'auto'; "
                f"got {self.backward!r}"
            )
        if not 0.0 <= self.gate_frac <= 1.0:
            raise ValueError(
                f"Phase.gate_frac must be in [0, 1]; got {self.gate_frac}"
            )
        if self.gate_every < 1:
            raise ValueError(
                f"Phase.gate_every must be >= 1; got {self.gate_every}"
            )
        if not self.name:
            object.__setattr__(self, "name", self.mode.value)

    # -- convenience constructors (the spec DSL's readable form) ---------
    @classmethod
    def exact(cls, steps: int, **kw) -> "Phase":
        return cls(TrainMode.NO_MODEL, steps, **kw)

    @classmethod
    def proxy(cls, steps: int, **kw) -> "Phase":
        return cls(TrainMode.PROXY_ONLY, steps, **kw)

    @classmethod
    def inject(cls, steps: int, calibrate="every_n", **kw) -> "Phase":
        return cls(TrainMode.INJECT, steps, calibrate=calibrate, **kw)

    @classmethod
    def model(cls, steps: int, **kw) -> "Phase":
        return cls(TrainMode.MODEL, steps, **kw)


def parse_phase_specs(entries) -> Tuple[Phase, ...]:
    """Parse CLI ``MODE:STEPS[:key=val,...]`` strings into a phases tuple.

    Modes accept the aliases in :data:`PHASE_MODE_ALIASES` (``exact``,
    ``proxy``, ``inject``, ``model``/``finetune``).  Keys: ``calib``
    (off | every_n | adaptive | an integer, which means every_n at that
    cadence), ``every``, ``drift``, ``lr``, ``micro``, ``fleet``
    (variation-aware training over N sampled chips), ``backward`` (or
    ``bwd``: exact | approx | auto — gated int8 backward), ``gate``
    (fraction of sites gated approximate), ``gate_every`` (auto-refresh
    cadence), ``name``.

    Example — the paper recipe with adaptive calibration::

        --phase exact:20 --phase inject:60:calib=adaptive,drift=0.05 \\
        --phase model:20:lr=0.5
    """
    phases = []
    for entry in entries or ():
        head, _, opts = str(entry).partition(":")
        steps_str, _, kv = opts.partition(":")
        if not head or not steps_str:
            raise ValueError(
                f"--phase expects MODE:STEPS[:key=val,...] "
                f"(e.g. 'inject:80:calib=adaptive'); got {entry!r}"
            )
        try:
            steps = int(steps_str)
        except ValueError:
            raise ValueError(
                f"--phase {entry!r}: STEPS must be an integer; got {steps_str!r}"
            ) from None
        kwargs = {}
        for pair in filter(None, kv.split(",")):
            key, sep, val = pair.partition("=")
            if not sep or not key or not val:
                raise ValueError(
                    f"--phase {entry!r}: options must be key=val; got {pair!r}"
                )
            if key == "calib":
                if val.isdigit():
                    kwargs["calibrate"] = CalibPolicy.EVERY_N
                    kwargs["calibrate_every"] = int(val)
                else:
                    try:
                        kwargs["calibrate"] = CalibPolicy(val)
                    except ValueError:
                        raise ValueError(
                            f"--phase {entry!r}: calib must be one of "
                            f"{[p.value for p in CalibPolicy]} or an integer "
                            f"cadence; got {val!r}"
                        ) from None
            elif key == "every":
                kwargs["calibrate_every"] = int(val)
                kwargs.setdefault("calibrate", CalibPolicy.EVERY_N)
            elif key == "drift":
                kwargs["drift_threshold"] = float(val)
                kwargs.setdefault("calibrate", CalibPolicy.ADAPTIVE)
            elif key == "lr":
                kwargs["lr_scale"] = float(val)
            elif key == "micro":
                kwargs["microbatches"] = int(val)
            elif key == "fleet":
                kwargs["fleet"] = int(val)
            elif key in ("backward", "bwd"):
                kwargs["backward"] = val
            elif key == "gate":
                kwargs["gate_frac"] = float(val)
            elif key == "gate_every":
                kwargs["gate_every"] = int(val)
            elif key == "name":
                kwargs["name"] = val
            else:
                raise ValueError(
                    f"--phase {entry!r}: unknown option {key!r} (expected "
                    "calib/every/drift/lr/micro/fleet/backward/gate/"
                    "gate_every/name)"
                )
        kwargs.setdefault("name", head)  # keep the user's alias as the label
        try:
            phases.append(Phase(head, steps, **kwargs))
        except ValueError as e:
            raise ValueError(f"--phase {entry!r}: {e}") from None
    return tuple(phases)


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

    # one-compile runtime dispatch (repro_torch.core.switch): when set, a
    # switch-dispatched projection has branches only for these backends
    # (exact always at index 0) instead of the whole registry table, and
    # index arrays are resolved against the same sub-table
    # (switch.site_indices(..., table=...)).  The static path ignores it.
    switch_backends: Optional[Tuple[str, ...]] = None

    # --- ablations ---
    proxy_in_backward: bool = True  # False => backprop through plain matmul
                                    # (the paper's Tab. 2 "without activation")

    # --- error injection / calibration (Sec. 3.2) ---
    poly_degree: int = 3         # degree of mean/std error polynomials (Type 1)
    calibrate_every: int = 10    # steps between calibration batches
    inject_std_scale: float = 1.0

    # which projections get the treatment: the router and the embedding
    # stay exact (the paper keeps accuracy-critical small layers exact);
    # every large matmul participates
    skip_embedding: bool = True
    skip_router: bool = True
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


def parse_site_backends(entries, known_sites=(), warn=None):
    """Parse CLI ``PATTERN=BACKEND`` strings into a ``site_backends`` tuple.

    Shared by every driver that exposes ``--site-backend``.  Raises
    ``ValueError`` with a flag-shaped message on malformed entries (no
    ``=``, empty halves); when ``known_sites`` is given, patterns matching
    none of them are reported through ``warn`` (likely a typo — the run
    would silently stay exact at those sites).
    """
    out = []
    for entry in entries or ():
        pattern, sep, name = str(entry).partition("=")
        if not sep or not pattern or not name:
            raise ValueError(
                f"--site-backend expects PATTERN=BACKEND (e.g. 'attn_*=sc'); "
                f"got {entry!r}"
            )
        if known_sites and warn is not None:
            if not any(fnmatch.fnmatchcase(s, pattern) for s in known_sites):
                warn(
                    f"--site-backend pattern {pattern!r} matches no projection "
                    f"site (known: {', '.join(known_sites)}); those matmuls "
                    "will stay on the default backend"
                )
        out.append((pattern, name))
    return tuple(out)


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

    # --- MoE ---
    n_experts: int = 0                 # 0 => dense FFN
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0                 # d_state; 0 => no ssm blocks
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256               # SSD chunk length
    ssm_conv_width: int = 4

    # --- hybrid (zamba2-style): shared attn block every k ssm layers ---
    shared_attn_every: int = 0         # 0 => not hybrid

    qkv_bias: bool = False             # qwen2.5 style
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == Family.SSM

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs (SSM, hybrid): the reference runs its 500k
        decode shape on them."""
        return self.family in (Family.SSM, Family.HYBRID)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding, blocks, head), the
        reference's arithmetic as it stands: it counts each attention
        block's norms twice (ROADMAP C), and an SSM block as ``3 d d_in +
        d_in d + d_in W`` (the in projection's x, z and dt pieces, roughly;
        it feeds rooflines only)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        per_attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        if self.qkv_bias:
            per_attn += (h + 2 * kv) * dh
        per_ffn = 3 * d * f  # SwiGLU
        if self.n_experts:
            per_ffn = self.n_experts * 3 * d * f + d * self.n_experts
        di = self.ssm_d_inner
        per_ssm = d * di * 2 + d * di + di * d + di * self.ssm_conv_width
        norms = 2 * d
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        if self.family == Family.SSM:
            n += self.n_layers * (per_ssm + norms)
        elif self.family == Family.HYBRID:
            # one shared attention+MLP block
            n += self.n_layers * (per_ssm + norms) + per_attn + per_ffn + 2 * norms
        else:
            n += self.n_layers * (per_attn + per_ffn + 2 * norms)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: only its top-k experts)."""
        if not self.n_experts:
            return self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Training configuration
# ---------------------------------------------------------------------------


def check_remat(remat: str) -> str:
    """``remat`` if it names a memory policy: ``none``, ``full``, ``block``
    or ``group:<k>`` (k >= 1); else a ``ValueError``."""
    head, sep, k = str(remat).partition(":")
    ok = (not sep and head in ("none", "full", "block")) or (
        head == "group" and k.isdigit() and int(k) >= 1)
    if not ok:
        raise ValueError(
            f"TrainConfig.remat must be 'none', 'full', 'block' or 'group:<k>'; got {remat!r}"
        )
    return remat


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the reference's ``TrainConfig`` that the training
    steps and the Trainer read.

    ``remat`` is the activation-checkpointing policy of each layer
    (:func:`repro_torch.core.checkpoint_policy.wrap_block`): ``none``,
    ``full`` (recompute the whole layer in the backward), ``block`` (keep
    the plain matmuls' outputs, recompute the rest) or ``group:<k>``,
    which the reference's ``wrap_block`` treats exactly as ``block``, and
    so does the port.  ``optim_compress`` is AdamW's state: ``none``
    (float32), ``bf16`` (a stochastically rounded bf16 first moment) or
    ``sm3`` (that and factored second moments; :mod:`repro_torch.optim.
    adamw`)."""

    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0

    # memory policy ------------------------------------------------------
    microbatches: int = 1            # gradient accumulation factor
    remat: str = "block"             # none | full | block | group:<k>
    optim_compress: str = "none"     # none | bf16 | sm3

    # fault tolerance ------------------------------------------------------
    checkpoint_every: int = 200
    keep_checkpoints: int = 3

    # declarative phase schedule -------------------------------------------
    # The resolver (repro_torch.core.schedule.PhasePlan) picks, in order:
    #   1. ``phases`` when non-empty (the general multi-phase pipeline),
    #   2. the legacy two-phase inject/finetune split below,
    #   3. a single phase of ``total_steps`` in the config's mode.
    phases: Tuple[Phase, ...] = ()

    # legacy two-phase split (kept for the classic paper recipe / old CLIs)
    inject_steps: int = 0            # steps trained with error injection
    finetune_steps: int = 0          # steps fine-tuned with accurate model

    def __post_init__(self):
        check_remat(self.remat)
        if self.optim_compress not in ("none", "bf16", "sm3"):
            raise ValueError(
                "TrainConfig.optim_compress must be 'none', 'bf16' or "
                f"'sm3'; got {self.optim_compress!r}"
            )
        if self.microbatches < 1:
            raise ValueError(f"TrainConfig.microbatches must be >= 1; got {self.microbatches}")
        for i, p in enumerate(self.phases):
            if not isinstance(p, Phase):
                raise TypeError(
                    f"TrainConfig.phases[{i}] must be a Phase; got "
                    f"{type(p).__name__} (use parse_phase_specs for strings)"
                )
        if self.phases and (self.inject_steps or self.finetune_steps):
            raise ValueError(
                "TrainConfig: give either `phases` or the legacy "
                "inject_steps/finetune_steps split, not both"
            )
