"""Where one emulated decode step (or prefill) spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode --arch qwen2.5-3b \\
      --backends exact,log_mult,approx_mult,sc,analog --out profile.json

For each backend, the engine's batch of ``SLOTS`` rows decodes through
the fused path (``serve_step`` with ``fused`` and flash attention) at
position ``POS``, random weights from ``--seed``.  With
``--prefill-tokens N[,N...]`` a step is instead one prefill of a request
of N tokens (``apply_model`` in MODEL mode with per-layer keys, as the
engine's prefill runs it), for each N.  After ``WARMUP`` steps
it times ``STEPS`` steps on the host clock (each ending in
``torch.cuda.synchronize``), then traces as many with ``torch.profiler``
(``measure.kernel_times``: two traces, each after a warm-up step, a
kernel's launches from the fullest and its time the mean of its kept
records, as the card's tracer can drop some) and sums the device time of
every kernel.  It prints, per backend: wall
ms per step, device ms per step, the device's busy share (device time /
wall time), and the device time and launches by group (the card's name
and power limit head the report): the port's hand-written
kernels (K1-K7 and their finishing passes), PyTorch's elementwise and
reduction kernels (the plain-torch value-domain code: scales, planes,
quantisation), GEMMs, and the rest.

Needs a CUDA device; it does not fall back to the CPU.  To time another
tree's package with this report, run this file by its path with that
tree's ``src`` as ``PYTHONPATH``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import time
from pathlib import Path

import torch

SLOTS, POS, MAX_SEQ = 4, 48, 96  # chip_smoke.py's engine: 4 slots, 96 positions
WARMUP, STEPS = 2, 3

GROUPS = (  # (group, substrings of a kernel's name), first match wins
    # the CUDA sources name their namespaces; a finishing pass carries its
    # kernel's functor type in its name
    ("SC tables sc_matmul.cu", ("build_tables",)),  # apart from the K4/K5 row below
    ("K4/K5 sc_matmul.cu", ("repro_sc::",)),
    ("K6/K7 analog_matmul.cu", ("repro_analog::",)),
    ("K1/K2 vpu_matmul.cu", ("repro_vpu::",)),
    ("K3 flash_decode.cu", ("flash_decode",)),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv", "nvjet")),
    ("PyTorch reductions", ("reduce",)),
    ("SC draws prng.cu", ("repro_prng::",)),
    ("PyTorch elementwise", ("elementwise", "unrolled", "vectorized")),
    ("memset and copies", ("memset", "memcpy")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _steps(params, cfg, backend: str, seed: int, prefill_tokens: int):
    """The step to profile: one fused decode step of the engine's batch,
    or one prefill of ``prefill_tokens`` tokens."""
    from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import apply_model

    dev = params.device
    gen = torch.Generator().manual_seed(seed)  # on the CPU: the same inputs on every device
    approx = ApproxConfig(backend=Backend(backend), mode=TrainMode.MODEL)
    tick = [0]
    if prefill_tokens:
        tokens = torch.randint(0, cfg.vocab_size, (1, prefill_tokens), generator=gen).to(dev)

        @torch.no_grad()
        def prefill():
            tick[0] += 1
            return apply_model(params, {"tokens": tokens}, cfg, approx=approx,
                               rng=(seed, tick[0])).logits
        return prefill

    cache = D.init_cache(cfg, SLOTS, MAX_SEQ, dev)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen, dtype=cache[key].dtype))
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS, 1), generator=gen).to(dev)
    pos = torch.full((SLOTS,), POS, dtype=torch.int32, device=dev)

    def step():
        tick[0] += 1
        ctx = None
        if approx.active:
            ctx = ApproxCtx(cfg=approx, fused=True, rng=(seed, tick[0]))
        logits, _ = D.serve_step(params, cache, tokens, pos, cfg, ctx=ctx, flash=True)
        return logits
    return step


def _measure():
    """``measure.py`` beside this file, loaded by its path: this file may
    run by its path against another tree's package (module note)."""
    spec = importlib.util.spec_from_file_location(
        "_measure", Path(__file__).resolve().with_name("measure.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def profile_backend(params, cfg, backend: str, seed: int, prefill_tokens: int = 0) -> dict:
    step = _steps(params, cfg, backend, seed, prefill_tokens)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # name -> (launches a step, mean device ms a launch)
    times = _measure().kernel_times(step, STEPS)
    by_kernel = {name: n * ms for name, (n, ms) in times.items()}
    launches = {name: n for name, (n, _) in times.items()}
    device_ms = sum(by_kernel.values())
    groups: dict = {}
    group_launches: dict = {}
    for name, ms in by_kernel.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
        group_launches[g] = group_launches.get(g, 0) + launches[name]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    wall_ms = 1e3 * sum(walls) / len(walls)
    return {
        "backend": backend,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "launches_per_step_by_group": group_launches,
        # (name, device ms per step, launches per step)
        "top_kernels": [(n[:120], ms, launches[n]) for n, ms in top],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--backends", default="exact,log_mult,approx_mult,sc,analog")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-tokens", default="",
                    help="profile one prefill of each of these many tokens (comma-separated) "
                         "instead of a decode step")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    prefill = [int(n) for n in args.prefill_tokens.split(",") if n]
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cfg = get_config(args.arch)
    t0 = time.perf_counter()
    params = build_model(cfg).init(args.seed, device="cuda")
    torch.cuda.synchronize()
    report = {
        "arch": cfg.name,
        "init_s": time.perf_counter() - t0,  # weights drawn on the CPU, moved to the card
        "device": torch.cuda.get_device_name(0),
        **({} if prefill else {"slots": SLOTS, "pos": POS}),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0],
        "backends": [{**({"prefill_tokens": n} if n else {}),
                      **profile_backend(params, cfg, b, args.seed, n)}
                     for b in args.backends.split(",") for n in prefill or [0]],
    }
    print(json.dumps(report, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
