"""Serving driver: the continuous-batching engine over a synthetic request
queue (port of the engine branch of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --requests 8 --slots 4 --prompt-len 64 --gen 32 \\
      --backends exact,log_mult,approx_mult,sc,analog --fused --out serve.json

Weights are random, made from ``--seed``.  ``--device`` defaults to
``cuda``; ``--device cpu`` runs the plain versions of the kernels.
``--backends`` takes any of exact, log_mult, approx_mult, sc and analog.
``--fused`` decodes through the fused emulation kernels and the flash
decode attention kernel; ``--no-fused`` (the default) through the
composed path.  SC's generator sequences come from ``--seed``.  Prefill/decode tok/s are steady-state: the first call of
each shape is timed apart as ``warmup_s``.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ApproxConfig
from repro_torch.models import build_model
from repro_torch.runtime.engine import Engine, synthetic_requests


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="longest prompt; prompts are drawn from [len/4, len]")
    ap.add_argument("--gen", type=int, default=32,
                    help="most new tokens; drawn from [gen/4, gen]")
    ap.add_argument("--backends", default="exact",
                    help="comma list cycled over requests, of exact, log_mult, "
                         "approx_mult, sc, analog")
    ap.add_argument("--fused", action="store_true", default=False,
                    help="decode through the fused kernels and flash decode attention")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="decode through the composed path (default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="", help="write the report JSON here")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    queue = synthetic_requests(
        args.requests, cfg.vocab_size, seed=args.seed,
        prompt_lens=(max(2, args.prompt_len // 4), args.prompt_len),
        gen_lens=(max(2, args.gen // 4), args.gen),
        backends=tuple(args.backends.split(",")),
    )
    engine = Engine(
        model, params, n_slots=args.slots, max_seq=args.prompt_len + args.gen,
        approx_base=ApproxConfig(), seed=args.seed, fused=args.fused,
        device=args.device,
    )
    results = engine.run(queue)
    report = dict(engine.metrics())
    report["arch"] = cfg.name
    if engine.device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(engine.device)
    report["per_backend_requests"] = {}
    for r in results.values():
        report["per_backend_requests"][r["backend"]] = (
            report["per_backend_requests"].get(r["backend"], 0) + 1
        )
    if queue:
        report["sample_tokens"] = results[queue[0].rid]["tokens"][:16]
    print(json.dumps(report, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
