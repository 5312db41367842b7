"""Hardware-aware approximation-search driver (port of
``repro.launch.search``).

Pre-trains a base model with a few exact steps on synthetic data,
profiles per-site sensitivity, runs the Pareto search over site->backend
maps, and emits the winning map under the energy budget as a
``--site-backend`` spec that ``launch/train.py`` and ``launch/serve.py``
take unchanged.

  PYTHONPATH=src python -m repro_torch.launch.search --arch paper-tinyconv \\
      --smoke --device cpu --budget 0.5 --out results/search_smoke.json
  PYTHONPATH=src python -m repro_torch.launch.search --arch qwen2.5-3b \\
      --train-steps 2 --mutations 2 --out results/search_qwen.json

``--device`` defaults to ``cuda`` and raises where there is no card.
Weights are random, made from ``--seed``.  The JSON report has the
reference's keys: the sensitivity table, the evaluated pool, the
non-dominated (energy, hw-eval loss) front, the winner with its per-site
energy breakdown and flag line, and ``compile_stats`` (``{"built": n}``,
the steps the search built: at most 2 under ``--dispatch switch``); on
the card also ``device_name``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import (
    AnalogParams,
    ApproxConfig,
    Backend,
    TrainConfig,
    parse_site_backends,
)
from repro_torch.core import registry
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.models.model import resolve_device
from repro_torch.models.transformer import ALL_SITES
from repro_torch.search import costmodel
from repro_torch.search.pareto import search, spec_of
from repro_torch.training.steps import CompiledFnCache, init_train_state, make_train_step


def train_base(model, data, steps: int, lr: float, seed: int, *, device="cuda", params=None):
    """Short exact pre-training so hardware-eval losses mean something:
    ``model.init(seed)`` on ``device`` (or ``params``, trained in place).
    Returns the parameters, out of autograd's graph."""
    approx = ApproxConfig()
    tcfg = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1), learning_rate=lr)
    state = init_train_state(model, seed, approx, tcfg, device=device, params=params)
    step = make_train_step(model, approx, tcfg)
    loss = float("nan")
    for s in range(steps):
        state, metrics = step(state, data.batch_at(s), (seed + 1, s))
        loss = float(metrics["loss"])
    print(f"[search] base model: {steps} exact steps, loss {loss:.4f}")
    params = state["params"]
    for p in params.parameters():
        p.requires_grad_(False)
    return params


def search_base(cfg, pinned=()) -> ApproxConfig:
    """The hardware knobs the search runs under: analog arrays of
    ``min(64, d_model)``, the pins as the site map."""
    return ApproxConfig(analog=AnalogParams(array_size=min(64, cfg.d_model)),
                        site_backends=tuple(pinned))


def report_of(result, winner, *, cfg, base, eval_shape, budget, objective, measured,
              fns) -> dict:
    """The reference's JSON report of a search and its winner."""
    spec = spec_of(winner.assignment)
    eval_B, eval_T = eval_shape
    return dict(
        result.to_json(),
        budget_frac=budget,
        objective=objective,
        measured_energy=measured,
        winner=winner.to_json(),
        winner_flags=" ".join(f"--site-backend '{s}'" for s in spec),
        # priced under the same knobs the search used, so the per-site
        # breakdown sums to the winner's energy
        winner_energy_breakdown=costmodel.energy_report(
            cfg, dataclasses.replace(base, backend=Backend.EXACT,
                                     site_backends=winner.assignment),
            seq_len=eval_T, batch=eval_B, measured=measured,
        ),
        compile_stats=fns.stats(),
    )


def check_spec(spec, assignment) -> None:
    """The emitted spec must round-trip through the CLIs' validator."""
    reparsed = parse_site_backends(
        spec, known_sites=ALL_SITES,
        warn=lambda m: (_ for _ in ()).throw(AssertionError(m)),
    )
    if reparsed != assignment:
        raise AssertionError(f"spec {spec} reparses to {reparsed}, not {assignment}")
    ApproxConfig(site_backends=reparsed)  # construction validates the names


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-tinyconv")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--backends", default="analog,log_mult,approx_mult",
                    help="comma list of candidate backends (registry names)")
    ap.add_argument("--budget", type=float, default=0.5,
                    help="energy budget as a fraction of all-exact energy")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="exact pre-training steps (default 60, smoke 25)")
    ap.add_argument("--mutations", type=int, default=None,
                    help="mutation-search iterations (default 12, smoke 6)")
    ap.add_argument("--recover-steps", type=int, default=0,
                    help="per-candidate recovery fine-tune steps (0 = off)")
    ap.add_argument("--site-backend", action="append", default=None,
                    metavar="PATTERN=BACKEND", dest="site_backend",
                    help="pin sites to a backend before searching (repeatable), "
                         "e.g. --site-backend 'lm_head=exact'")
    ap.add_argument("--energy-json", default=None,
                    help="measured per-MAC energy JSON overriding the analytic backend "
                         "models: {\"sc\": 0.9, \"analog\": {\"per_mac\": 0.02}, ...}")
    ap.add_argument("--fleet", type=int, default=0,
                    help="ensemble scoring: hardware-eval every candidate over a fleet of "
                         "N sampled device instances (loss = fleet mean, loss_worst = "
                         "worst chip)")
    ap.add_argument("--variation-scale", type=float, default=1.0,
                    help="chip-variation sigma multiplier (with --fleet)")
    ap.add_argument("--objective", choices=["mean", "worst"], default="mean",
                    help="budget-query ranking: fleet-mean or worst-chip hw-eval loss")
    ap.add_argument("--dispatch", choices=["switch", "static"], default="switch",
                    help="candidate evaluation: 'switch' = runtime backend indices (at "
                         "most 2 steps for the whole search), 'static' = a step per map")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    args = ap.parse_args(argv)

    for name in args.backends.split(","):
        try:
            registry.get(name)  # unknown candidate backends fail up front
        except KeyError as e:
            ap.error(str(e.args[0]))
    backends = tuple(args.backends.split(","))
    try:
        pinned = parse_site_backends(args.site_backend, known_sites=ALL_SITES,
                                     warn=lambda m: print(f"[search] warning: {m}"))
    except ValueError as e:
        ap.error(str(e))
    measured = None
    if args.energy_json:
        try:
            measured = costmodel.load_measured_energy(args.energy_json)
        except ValueError as e:
            ap.error(str(e))
        print(f"[search] measured per-MAC energy overrides: {measured}")
    device = resolve_device(args.device)
    fleet = None
    if args.fleet:
        from repro_torch.hw import Fleet, VariationModel

        fleet = Fleet(args.fleet, seed=args.seed + 7919,
                      variation=VariationModel(scale=args.variation_scale))

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    train_steps = args.train_steps if args.train_steps is not None else (
        25 if args.smoke else 60)  # 0 is a valid choice: search raw weights
    mutations = args.mutations if args.mutations is not None else (6 if args.smoke else 12)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed)
    params = train_base(model, data, train_steps, lr=2e-3, seed=args.seed, device=device)
    eval_batch = data.batch_at(10_000)

    base = search_base(cfg, pinned)
    fns = CompiledFnCache()
    result = search(
        model, params, eval_batch, base, backends, pinned=pinned, seed=args.seed,
        mutations=mutations, recover_steps=args.recover_steps, recover_data=data, fns=fns,
        fleet=fleet, measured=measured, dispatch=args.dispatch,
    )

    fleet_note = f" (ensemble over {args.fleet} chips)" if args.fleet else ""
    print(f"\n[search] {len(result.pool)} maps scored over {result.n_sites} sites{fleet_note}; "
          f"exact loss {result.exact_loss:.4f}, exact energy {result.baseline_energy:.3e}")
    print(f"{'energy_frac':>11s} {'hw_loss':>8s} {'worst':>8s}  {'origin':12s} spec")
    for p in result.front:
        print(f"{p.energy / result.baseline_energy:11.3f} {p.loss:8.4f} {p.loss_worst:8.4f}  "
              f"{p.origin:12s} {','.join(spec_of(p.assignment)) or '(exact)'}")

    winner = result.best_under_budget(args.budget, objective=args.objective)
    check_spec(spec_of(winner.assignment), winner.assignment)
    report = report_of(result, winner, cfg=cfg, base=base,
                       eval_shape=tuple(eval_batch["tokens"].shape), budget=args.budget,
                       objective=args.objective, measured=measured, fns=fns)
    smoke = " --smoke" if args.smoke else ""
    print(f"\n[search] best map under {args.budget:.0%} energy budget: "
          f"{winner.energy / result.baseline_energy:.3f}x exact energy, "
          f"hw-eval loss {winner.loss:.4f} (exact {result.exact_loss:.4f})")
    print(f"[search] train it:  python -m repro_torch.launch.train --arch {args.arch}{smoke} "
          f"{report['winner_flags']}")
    print(f"[search] serve it:  python -m repro_torch.launch.serve --arch {args.arch}{smoke} "
          f"{report['winner_flags']}")
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[search] wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
