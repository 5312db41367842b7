"""End-to-end training driver (port of ``repro.launch.train``).

Legacy two-phase split, on the CPU at the smoke config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \\
      --device cpu --backend analog --inject-steps 8 --finetune-steps 2

Declarative multi-phase pipeline (paper recipe with adaptive calibration),
on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \\
      --backend analog --phase exact:2 \\
      --phase inject:7:calib=adaptive,drift=0.05 --phase model:2:lr=0.5

Variation-aware training, each step against a chip of a sampled fleet:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \
      --device cpu --backend analog --phase inject:6:calib=adaptive \
      --phase model:2 --fleet 2 --variation-scale 2

``--device`` defaults to ``cuda`` and raises where there is no card.
``--fleet N`` makes every phase that touches the hardware (all but exact
ones, and those that set their own ``fleet=``) train against a fleet of N
chips, sigmas times ``--variation-scale``, sampled from ``--fleet-seed``
(default ``--seed`` + 7919).

The approximate backward and the compressed optimizer state:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \
      --device cpu --backend approx_mult --phase exact:2 \
      --phase inject:4:bwd=approx --backward auto --gate-frac 0.5 \
      --optim-compress sm3

``--backward`` gates every phase that does not set its own (``--phase
...:backward=``): ``approx`` opens the ``--gate-frac`` least sensitive
sites' gradient matmuls to the int8 grid, the gate derived once at a
phase's entry; ``auto`` derives it again every ``gate_every`` steps.
Without ``--phase`` it wraps the run in one phase of the resolved mode.
``--optim-compress`` stores AdamW's first moment in bf16 (``bf16``) and
factors its second moments (``sm3``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import (
    AnalogParams,
    ApproxConfig,
    Backend,
    Phase,
    TrainConfig,
    TrainMode,
    parse_phase_specs,
    parse_site_backends,
)
from repro_torch.data import SyntheticLM
from repro_torch.hw import VariationModel
from repro_torch.models import build_model
from repro_torch.models.transformer import ALL_SITES
from repro_torch.runtime.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--backend", default="exact",
                    choices=["exact", "sc", "approx_mult", "analog", "log_mult"])
    ap.add_argument("--site-backend", action="append", default=None,
                    metavar="PATTERN=BACKEND", dest="site_backend",
                    help="per-site backend override (repeatable), e.g. "
                         "--site-backend 'attn_*=sc'")
    ap.add_argument("--phase", action="append", default=None, dest="phase",
                    metavar="MODE:STEPS[:key=val,...]",
                    help="declarative schedule phase (repeatable, ordered); "
                         "modes: exact|proxy|inject|model; keys: calib "
                         "(off|every_n|adaptive|N), every, drift, lr, micro "
                         "— e.g. --phase inject:80:calib=adaptive,drift=0.05. "
                         "Overrides --inject-steps/--finetune-steps.")
    ap.add_argument("--fleet", type=int, default=0,
                    help="variation-aware training: round-robin a sampled device "
                         "instance per step over a fleet of N chips (every non-exact "
                         "phase; per phase: --phase ...:fleet=N)")
    ap.add_argument("--variation-scale", type=float, default=1.0,
                    help="multiplier on every chip-variation sigma")
    ap.add_argument("--fleet-seed", type=int, default=None,
                    help="chip-sampling seed (default: --seed + 7919)")
    ap.add_argument("--backward", default=None, choices=["exact", "approx", "auto"],
                    help="approximate-backward gating for every phase (sensitivity-gated "
                         "int8 gradient matmuls; per phase: --phase ...:backward=...)")
    ap.add_argument("--gate-frac", type=float, default=0.75,
                    help="fraction of sites gated onto the approximate backward (the most "
                         "sensitive rest keep the exact one)")
    ap.add_argument("--optim-compress", default="none", choices=["none", "bf16", "sm3"],
                    help="quantized optimizer state: bf16 momentum (stochastic rounding), "
                         "or sm3 factored second moments on top")
    ap.add_argument("--inject-steps", type=int, default=80)
    ap.add_argument("--finetune-steps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=None, help="total (exact mode)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--calibrate-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--report", default=None, help="write JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)

    backend = Backend(args.backend)
    try:
        site_backends = parse_site_backends(
            args.site_backend, known_sites=ALL_SITES,
            warn=lambda m: print(f"[train] warning: {m}"),
        )
        # gate on the WHOLE config, not just the default backend: a per-site
        # override can make an exact-default run approximate (and vice versa
        # an all-exact override map adds nothing)
        approx = ApproxConfig(
            backend=backend,
            mode=TrainMode.NO_MODEL,
            calibrate_every=args.calibrate_every,
            analog=AnalogParams(array_size=min(128, cfg.d_model)),
            site_backends=site_backends,
        )
    except ValueError as e:
        ap.error(str(e))
    if approx.approx_backends:
        approx = dataclasses.replace(approx, mode=TrainMode.INJECT)
    try:
        phases = parse_phase_specs(args.phase)
    except ValueError as e:
        ap.error(str(e))
    if args.fleet:
        # every phase that touches the hardware trains against the fleet
        # (phases with their own fleet= keep it)
        phases = tuple(dataclasses.replace(p, fleet=args.fleet)
                       if p.mode != TrainMode.NO_MODEL and not p.fleet else p
                       for p in phases)
    explicit_phases = bool(phases)
    if args.backward and not phases:
        # the gated backward rides on the phase pipeline: one phase of the
        # resolved mode
        phases = (Phase(approx.mode, args.steps or (args.inject_steps + args.finetune_steps)),)
    if args.backward:
        # as --fleet: every phase that does not set its own
        phases = tuple(dataclasses.replace(p, backward=args.backward, gate_frac=args.gate_frac)
                       if p.backward == "exact" else p for p in phases)
    if phases:
        if args.steps is not None and explicit_phases:
            ap.error("--steps conflicts with --phase: the total is the sum "
                     "of the phase budgets")
        total = sum(p.steps for p in phases)
        tcfg = TrainConfig(
            learning_rate=args.lr,
            total_steps=total,
            warmup_steps=max(total // 20, 1),
            phases=phases,
            checkpoint_every=max(total // 4, 1),
            optim_compress=args.optim_compress,
        )
    elif args.fleet and approx.approx_backends:
        # the legacy two-phase split, made variation-aware: the fleet rides
        # on explicit phases
        total = args.steps or (args.inject_steps + args.finetune_steps)
        legacy = []
        if args.inject_steps:
            legacy.append(Phase.inject(args.inject_steps, fleet=args.fleet))
        if args.finetune_steps:
            legacy.append(Phase.model(args.finetune_steps, fleet=args.fleet))
        tcfg = TrainConfig(
            learning_rate=args.lr,
            total_steps=total,
            warmup_steps=max(total // 20, 1),
            phases=tuple(legacy),
            checkpoint_every=max(total // 4, 1),
            optim_compress=args.optim_compress,
        )
    else:
        total = args.steps or (args.inject_steps + args.finetune_steps)
        tcfg = TrainConfig(
            learning_rate=args.lr,
            total_steps=total,
            warmup_steps=max(total // 20, 1),
            inject_steps=args.inject_steps if approx.approx_backends else 0,
            finetune_steps=args.finetune_steps if approx.approx_backends else 0,
            checkpoint_every=max(total // 4, 1),
            optim_compress=args.optim_compress,
        )
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed)
    trainer = Trainer(
        model, approx, tcfg, data, args.ckpt_dir,
        seed=args.seed, log_every=args.log_every, device=args.device,
        variation=VariationModel(scale=args.variation_scale), fleet_seed=args.fleet_seed,
    )
    report = trainer.run(total)
    summary = {
        "arch": cfg.name,
        "backend": backend.value,
        "schedule": trainer.plan.describe(),
        "steps": len(report.losses),
        "first_loss": report.losses[0],
        "final_loss": sum(report.losses[-5:]) / max(len(report.losses[-5:]), 1),
        "mean_step_s": sum(report.step_times) / max(len(report.step_times), 1),
        "restarts": report.restarts,
        "calibrations": report.calibrations,
        "final_calib_loss": report.calib_losses[-1][1] if report.calib_losses else None,
        "mode_steps": report.mode_steps,
        "compile_stats": report.compile_stats,
        "fleet_steps": report.fleet_steps,
        "backward_steps": report.backward_steps,
        "gate_refreshes": report.gate_refreshes,
        "gate_events": report.gate_events,
        "optim_compress": tcfg.optim_compress,
    }
    print(json.dumps(summary, indent=2))
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
