#!/usr/bin/env python3
"""Which site's int8 backward moves the gradient norm, at qwen2.5-3b width:

  python3 tools/bwd_site_norms.py [--layers 36,2] [--base-steps N] [--out FILE]
  python3 tools/bwd_site_norms.py --smoke --device cpu --layers 2

Builds the model's random weights (seed 0, as chip_smoke.py does); with
``--base-steps N`` they first take the N exact AdamW steps of
chip_smoke.py's ``[search]`` phase (``launch.search.train_base``, 8 x 32
tokens, learning rate 2e-3), which train the weights that its later
phases, ``[bwd]`` among them, inherit.  Then it takes the
batch of chip_smoke.py's ``[bwd]`` phase (4 x 64 tokens, ``SyntheticLM``
seed 3), then takes the loss's gradients (the train step's loss, remat
off) under the backward gates: all closed, all open, and each site open
alone, and all open but mlp_down or lm_head (the two sites the
sensitivity gate keeps exact at full width).  Two steps: MODEL mode on approx_mult (the K1 forward) and INJECT
mode on analog without calibration stats (the exact forward plus no
error, so only the backward differs from exact training).  For each gate
it prints the global gradient norm and the norms by parameter group
(embedding, each projection's weight and bias over the layers, norms,
lm_head) and by layer, and writes every record as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up", "mlp_down", "lm_head")


def _group(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "layers" else parts[0]


def _norms(grads) -> dict:
    groups, layers = {}, {}
    for n, g in grads.items():
        sq = float(g.float().square().sum())
        groups[_group(n)] = groups.get(_group(n), 0.0) + sq
        if n.startswith("layers."):
            layer = int(n.split(".")[1])
            layers[layer] = layers.get(layer, 0.0) + sq
    return {"total": sum(groups.values()) ** 0.5,
            "by_group": {k: v ** 0.5 for k, v in sorted(groups.items())},
            "by_layer": [layers[k] ** 0.5 for k in sorted(layers)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="36,2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--base-steps", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the smoke config (a CPU check)")
    ap.add_argument("--out", default="chiprun_out/bwd_site_norms.json")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import AnalogParams, ApproxConfig, Backend, TrainConfig
    from repro_torch.configs.base import TrainMode
    from repro_torch.core import switch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import search
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.training import steps

    base = get_smoke_config("qwen2.5-3b") if args.smoke else get_config("qwen2.5-3b")
    model = build_model(base)
    params = model.init(0, device=args.device)
    if args.base_steps:
        search.train_base(model, SyntheticLM(base.vocab_size, 32, 8, seed=0), args.base_steps,
                          lr=2e-3, seed=0, device=args.device, params=params)
        gc.collect()  # the base steps' AdamW state
        if args.device != "cpu":
            torch.cuda.empty_cache()
    batch = steps._batch(SyntheticLM(base.vocab_size, seq_len=64, global_batch=4,
                                     seed=3).batch_at(0), args.device)
    tcfg = TrainConfig(remat="none")
    gates = {"closed": switch.backward_gate(approx_sites=()),
             "open": switch.backward_gate()}
    gates.update({f"only {s}": switch.backward_gate(approx_sites=(s,)) for s in SITES})
    gates.update({f"all but {s}": switch.backward_gate(exact_sites=(s,))
                  for s in ("mlp_down", "lm_head")})
    runs = (("model/approx_mult", TrainMode.MODEL, "approx_mult"),
            ("inject/analog", TrainMode.INJECT, "analog"))
    records = []
    for depth in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(base, n_layers=depth)
        m = build_model(cfg)
        p = Transformer(params.embed, params.final_norm, list(params.layers[:depth]),
                        params.lm_head)
        named = dict(p.named_parameters())
        for name, mode, be in runs:
            approx = ApproxConfig(backend=Backend(be), mode=mode,
                                  analog=AnalogParams(array_size=16, adc_bits=4))
            for gname, gate in gates.items():
                t0 = time.perf_counter()
                for t in named.values():
                    t.requires_grad_(True)
                loss = steps._loss(p, batch, m, approx, None, (1, 0), tcfg, bwd_gate=gate)
                grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
                for t in named.values():
                    t.requires_grad_(False)
                rec = {"layers": depth, "base_steps": args.base_steps, "step": name,
                       "gate": gname,
                       "loss": float(loss.detach()), **_norms(grads),
                       "wall_s": time.perf_counter() - t0}
                del grads
                records.append(rec)
                short = {k: round(v, 4) for k, v in rec["by_group"].items()}
                print(f"[norms] L{depth} {name} {gname}: loss {rec['loss']:.6g} "
                      f"total {rec['total']:.6g} {json.dumps(short)}", flush=True)
                if gname in ("closed", "open"):
                    layers = [round(v, 4) for v in rec["by_layer"]]
                    print(f"[norms]   by layer {layers}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f)
    if args.device != "cpu":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip())
    return 0 if all(np.isfinite(r["total"]) for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
