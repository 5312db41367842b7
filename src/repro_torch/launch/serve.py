"""Serving driver: the continuous-batching engine over a synthetic request
queue, or the static-batch baseline (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --requests 8 --slots 4 --prompt-len 64 --gen 32 \\
      --backends exact,log_mult,approx_mult,sc,analog --fused --out serve.json

Weights are random, made from ``--seed``.  ``--device`` defaults to
``cuda``; ``--device cpu`` runs the plain versions of the kernels.
``--backends`` takes any of exact, log_mult, approx_mult, sc and analog,
cycled over the requests; ``--site-backend PATTERN=BACKEND`` (repeatable)
gives every request a per-site map.  Prompt and generation lengths are
drawn from [len/4, len] (``--uniform``: every request at the full
lengths); ``--max-seq`` is the serving window (default prompt-len + gen);
``--temperature`` samples instead of taking the argmax.  ``--fused``
decodes through the fused emulation kernels and the flash decode
attention kernel; ``--no-fused`` (the default) through the composed path.
SC's generator sequences come from ``--seed``.  ``--stream`` prints
tokens as they are produced.

``--fleet N`` binds each emulated lane to one of N sampled chips
(``repro_torch.hw``, sigmas times ``--variation-scale``); ``--drift``
ages them as they serve (gain walk std per sqrt(kilotoken), half of it on
the offsets), with online recalibration every ``--recalibrate-every``
engine steps at most (adaptive); ``--warm-start`` seeds a newly bound
chip's correction from the fleet's mean.  The report's ``fleet`` field
has each chip's probe losses.

``--switch`` merges every emulated request into one lane whatever its
backend or site map (per-slot backend indices, ``Engine(switch=True)``);
it refuses ``--static`` and ``--fleet``, as the reference does, and MoE
archs (``--arch dbrx-132b``, ``grok-1-314b``), whose engine refuses it.  The
reference's ``--fabric`` waits for ROADMAP A7.  The SSM and HYBRID archs
(``--arch mamba2-130m``, ``zamba2-1.2b``) serve on static lanes: their
``--switch`` and ``--fleet`` wait for ROADMAP A5.

``--static`` runs the static-batch baseline instead (exact path only).
Prefill/decode tok/s are steady-state: the first call of each shape is
timed apart as ``warmup_s``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ApproxConfig, parse_site_backends
from repro_torch.hw import DriftModel, Fleet, VariationModel
from repro_torch.models import build_model
from repro_torch.models.transformer import ALL_SITES, SERVING_ONLY
from repro_torch.runtime.engine import Engine, run_static_baseline, synthetic_requests


def build_queue(args, vocab_size: int, site_backends=()):
    lo_p = max(2, args.prompt_len // 4) if args.mixed else args.prompt_len
    lo_g = max(2, args.gen // 4) if args.mixed else args.gen
    queue = synthetic_requests(
        args.requests, vocab_size, seed=args.seed,
        prompt_lens=(lo_p, args.prompt_len), gen_lens=(lo_g, args.gen),
        backends=tuple(args.backends.split(",")), temperature=args.temperature,
    )
    if site_backends:
        # every request deploys the map; its --backends entry is the default
        # backend of the sites the map does not match
        queue = [dataclasses.replace(r, site_backends=site_backends) for r in queue]
    return queue


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="serving window (default prompt-len + gen)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="longest prompt; prompts are drawn from [len/4, len]")
    ap.add_argument("--gen", type=int, default=32,
                    help="most new tokens; drawn from [gen/4, gen]")
    ap.add_argument("--mixed", action="store_true", default=True,
                    help="mixed prompt/gen lengths (default)")
    ap.add_argument("--uniform", dest="mixed", action="store_false",
                    help="every request at --prompt-len and --gen")
    ap.add_argument("--backends", default="exact",
                    help="comma list cycled over requests, of exact, log_mult, "
                         "approx_mult, sc, analog")
    ap.add_argument("--site-backend", action="append", default=None,
                    metavar="PATTERN=BACKEND", dest="site_backend",
                    help="per-site backend map applied to every request (repeatable)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve emulated requests over a fleet of N sampled chips "
                         "(one chip per lane)")
    ap.add_argument("--variation-scale", type=float, default=1.0,
                    help="multiplier on the chip-variation sigmas (with --fleet)")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="gain random-walk drift std per sqrt(kilotoken) "
                         "(0: static chips; with --fleet)")
    ap.add_argument("--recalibrate-every", type=int, default=8,
                    help="base online-recalibration cadence in engine steps "
                         "(adaptive: halves when the probe loss drifts)")
    ap.add_argument("--warm-start", action="store_true",
                    help="with --fleet: seed a newly bound chip's correction from the "
                         "fleet mean instead of a bind-time fit")
    ap.add_argument("--fused", action="store_true", default=False,
                    help="decode through the fused kernels and flash decode attention")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="decode through the composed path (default)")
    ap.add_argument("--switch", action="store_true",
                    help="runtime backend dispatch: merge every emulated request into one "
                         "lane, per-slot backend indices; incompatible with --fleet")
    ap.add_argument("--static", action="store_true",
                    help="run the static-batch baseline instead of the engine")
    ap.add_argument("--stream", action="store_true", help="print tokens as they are generated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="", help="write the report JSON here")
    # the old static driver's flag, kept as an alias of --slots
    ap.add_argument("--batch", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.batch:
        args.slots = args.batch

    try:
        site_backends = parse_site_backends(
            args.site_backend, known_sites=ALL_SITES,
            warn=lambda m: print(f"[serve] warning: {m}"),
        )
        ApproxConfig(site_backends=site_backends)
    except ValueError as e:
        ap.error(str(e))
    if site_backends and args.static:
        ap.error("--site-backend needs the engine (the static baseline never serves "
                 "emulation); drop --static")
    if args.fleet and args.static:
        ap.error("--fleet needs the engine (the static baseline never serves emulation); "
                 "drop --static")
    if args.switch and args.static:
        ap.error("--switch needs the engine; drop --static")
    if args.switch and args.fleet:
        ap.error("--switch merges lanes across site maps, which is incompatible with "
                 "per-chip fleet lanes; drop one")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.switch and cfg.n_experts:
        ap.error(f"--switch does not support MoE models ({args.arch}): expert routing "
                 "couples slot rows, so per-slot backend selection is ill-defined")
    if (args.switch or args.fleet) and cfg.family in SERVING_ONLY:
        ap.error(f"--switch and --fleet on the {cfg.family.value} family ({args.arch}) are "
                 "not yet ported (ROADMAP A5)")
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    queue = build_queue(args, cfg.vocab_size, site_backends)
    max_seq = args.max_seq or (args.prompt_len + args.gen)

    if args.static:
        report = run_static_baseline(model, params, queue, batch=args.slots)
        report["mode"] = "static"
        report["outputs"] = {rid: toks[:8] for rid, toks in report["outputs"].items()}
        # shorter prompts of a mixed wave generate from the padded wave-max position
        report["outputs_note"] = ("static padding: outputs of shorter-prompt requests are "
                                  "conditioned on zero-pad context (use the engine for "
                                  "fidelity)")
    else:
        stream = None
        if args.stream:
            stream = lambda rid, tok, done: print(f"  rid={rid} tok={tok}"
                                                  f"{' <done>' if done else ''}")
        fleet = drift = None
        if args.fleet:
            fleet = Fleet(args.fleet, seed=args.seed + 7919,
                          variation=VariationModel(scale=args.variation_scale))
            if args.drift > 0:
                drift = DriftModel(gain_walk_std=args.drift, offset_walk_std=args.drift / 2)
        engine = Engine(
            model, params, n_slots=args.slots, max_seq=max_seq, approx_base=ApproxConfig(),
            seed=args.seed, stream=stream, fused=args.fused, device=args.device,
            fleet=fleet, drift=drift, recalibrate_every=args.recalibrate_every,
            warm_start=args.warm_start, switch=args.switch,
        )
        results = engine.run(queue)
        report = dict(engine.metrics())
        report["mode"] = "engine"
        if fleet is not None:
            report["fleet"] = engine.fleet_report()
        report["per_backend_requests"] = {}
        for r in results.values():
            report["per_backend_requests"][r["backend"]] = (
                report["per_backend_requests"].get(r["backend"], 0) + 1
            )
        if queue:
            report["sample_tokens"] = results[queue[0].rid]["tokens"][:16]
    report["arch"] = cfg.name
    if params.device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(params.device)
    if site_backends:
        report["site_backends"] = [f"{p}={b}" for p, b in site_backends]
    print(json.dumps(report, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
