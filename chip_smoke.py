#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one, and when run outside a
checkout of the repository.  Phases, each synchronised before the next:

1. Build every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (qwen2.5-3b full width): K1 and K2 for
   both multipliers must be bitwise equal (K2 also with random epilogue
   operands); K3 within 1e-4.  Each is timed with CUDA events beside its
   plain version, its roofline bound and, for K3, a masked
   ``scaled_dot_product_attention`` call (timed here only; the port never
   calls it).
3. Serve a seeded queue through the engine on the qwen2.5-3b smoke config
   on the card and on the CPU: greedy tokens must match and logits agree
   within 1e-3.
4. Serve 8 requests at qwen2.5-3b full width (bf16, random weights from
   the seed; backends exact, log_mult, approx_mult; fused decode) and
   check every kernel of the path was launched.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
CUDA_CORE_OPS_S = 67e12  # H100 SXM float32 rate outside the tensor cores
PREFILL_M = 64           # largest prompt bucket of the engine phase
DECODE_M = 4             # slots of the engine phase
MAX_SEQ = 96             # engine phase: prompts <= 64 + <= 32 new tokens


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / CUDA_CORE_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, cfg):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.vpu_matmul import (
        elementwise_matmul_cuda,
        elementwise_matmul_fused_cuda,
        elementwise_matmul_fused_ref,
    )

    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KVd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    # (K, N) of every dense() site: q/o, k/v, gate/up, down, lm_head
    shapes = [(D, H), (D, KVd), (D, F_), (F_, D), (D, V)]
    rep = (D, F_)  # the shape each kernel's summary entry reports
    g = torch.Generator(device=dev).manual_seed(0)
    mults = {
        "approx_mult": (127, 4, lambda a, b: ref.approx_mul(a, b, 4)),
        "log_mult": (255, 0, ref.mitchell_mul),
    }
    summary = {}
    for mul, (hi, drop, mulf) in mults.items():
        for K, N in shapes:
            for kname, M in (("elementwise_matmul", PREFILL_M),
                             ("elementwise_matmul_fused", DECODE_M)):
                x = torch.randint(-hi, hi + 1, (M, K), generator=g, device=dev).to(torch.bfloat16)
                w = torch.randint(-hi, hi + 1, (K, N), generator=g, device=dev).to(torch.bfloat16)
                if kname == "elementwise_matmul":
                    run = lambda: elementwise_matmul_cuda(x, w, mul, drop)
                    plain = lambda: ref.elementwise_matmul_ref(x, w, mulf)
                    out_bytes = 4 * M * N
                    epis = [{}]
                else:
                    pre = (torch.rand((M, 1), generator=g, device=dev) * 1e-4).to(torch.bfloat16)
                    epis = [{}, {
                        "colgain": (1 + 0.05 * torch.randn(N, generator=g, device=dev)).to(torch.bfloat16),
                        "coladd": (0.02 * torch.randn(N, generator=g, device=dev)).to(torch.bfloat16),
                        "mean_coeffs": torch.tensor([0.01, -0.02, 0.003, -0.0004], device=dev),
                        "mean_scale": torch.tensor(1.7, device=dev),
                    }]
                    out_bytes = 2 * M * N + 2 * M
                err = 0.0
                for epi in epis:
                    if kname == "elementwise_matmul":
                        got, want = run(), plain()
                    else:
                        got = elementwise_matmul_fused_cuda(x, w, mul, pre, epi, torch.bfloat16, drop)
                        want = elementwise_matmul_fused_ref(x, w, mulf, pre, epi, torch.bfloat16)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        diff = (got.float() - want.float()).abs().max().item()
                        raise AssertionError(
                            f"{kname}[{mul}] {M}x{K}x{N} epi={sorted(epi)}: not bitwise "
                            f"equal to its plain version (max |diff| {diff})"
                        )
                    err = max(err, (got.float() - want.float()).abs().max().item())
                if kname == "elementwise_matmul_fused":
                    run = lambda: elementwise_matmul_fused_cuda(x, w, mul, pre, {}, torch.bfloat16, drop)
                    plain = lambda: elementwise_matmul_fused_ref(x, w, mulf, pre, {}, torch.bfloat16)
                ms = cuda_ms(run, 3 if M * K * N > 2e9 else 10)
                plain_ms = cuda_ms(plain, 1)
                b_ms, b_by = bound(2 * (M * K + K * N) + out_bytes, 2.0 * M * K * N)
                row = {"name": f"{kname}[{mul}]", "shape": [M, K, N], "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None}
                print(f"[kernels] {json.dumps(row)}", flush=True)
                if (K, N) == rep:
                    summary[row["name"]] = row
                del x, w
                torch.cuda.empty_cache()

    # K3 at the decode shape: B slots, S = serving window, per-row positions
    B, KV, G, dh = DECODE_M, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    q = torch.randn((B, KV, G, dh), generator=g, device=dev).to(torch.bfloat16)
    ck = torch.randn((B, MAX_SEQ, KV, dh), generator=g, device=dev).to(torch.bfloat16)
    cv = torch.randn((B, MAX_SEQ, KV, dh), generator=g, device=dev).to(torch.bfloat16)
    pos = torch.randint(16, MAX_SEQ, (B,), generator=g, device=dev).to(torch.int32)
    got, want = flash_decode(q, ck, cv, pos), flash_decode_ref(q, ck, cv, pos)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"flash_decode: max |diff| {err} > 1e-4 against its plain version")
    # library yardstick: masked SDPA over the same inputs, heads expanded
    qh = q.reshape(B, KV * G, 1, dh)
    kh = ck.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = cv.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    mask = (torch.arange(MAX_SEQ, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib_err = (lib().float().reshape(B, KV, G, dh) - want).abs().max().item()
    keys = int((pos.long() + 1).sum())
    nbytes = 2 * q.numel() + 2 * 2 * keys * KV * dh + 4 * B + 4 * got.numel()
    b_ms, b_by = bound(nbytes, 4.0 * keys * KV * G * dh)
    row = {"name": "flash_decode", "shape": [B, MAX_SEQ, KV, G, dh], "max_abs_err": err,
           "ms": cuda_ms(lambda: flash_decode(q, ck, cv, pos), 50),
           "plain_ms": cuda_ms(lambda: flash_decode_ref(q, ck, cv, pos), 50),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, 50),
           "library_max_abs_err": lib_err}
    summary["flash_decode"] = row
    print(f"[kernels] {json.dumps(row)}", flush=True)
    return summary


def phase_reference(dev):
    """The smoke config served on the card and on the CPU from the same
    weights: greedy tokens equal, logits within 1e-3 (float32; cuBLAS and
    the CPU sum in other orders, and the card runs the kernels)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg = get_smoke_config("qwen2.5-3b")
    model = build_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_dev = model.init(0, device="cpu").to(dev)
    queue = synthetic_requests(6, cfg.vocab_size, seed=0, prompt_lens=(3, 20),
                               gen_lens=(4, 10), backends=("exact", "log_mult", "approx_mult"))
    res = {}
    for name, params, device in (("cpu", p_cpu, "cpu"), ("cuda", p_dev, dev)):
        eng = Engine(model, params, n_slots=2, max_seq=32, fused=True,
                     collect_logits=True, device=device)
        res[name] = eng.run(queue)
    worst = 0.0
    for rid, want in res["cpu"].items():
        got = res["cuda"][rid]
        if got["tokens"] != want["tokens"]:
            raise AssertionError(f"smoke request {rid}: tokens {got['tokens']} != {want['tokens']}")
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)
            worst = max(worst, float(np.abs(a - b).max()))
    print(f"[reference] smoke engine on card == CPU: {len(res['cpu'])} requests, "
          f"tokens equal, max |logit diff| {worst}", flush=True)


def phase_engine(dev, cfg, card: str):
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, synthetic_requests

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[engine] {cfg.name}: {n_params} params (bf16) on {dev} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    queue = synthetic_requests(8, cfg.vocab_size, seed=0, prompt_lens=(16, 64),
                               gen_lens=(16, 32), backends=("exact", "log_mult", "approx_mult"))
    eng = Engine(model, params, n_slots=DECODE_M, max_seq=MAX_SEQ, fused=True,
                 collect_logits=True, device=dev)
    build.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(queue)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if sorted(results) != list(range(len(queue))):
        raise AssertionError(f"served {sorted(results)} of {len(queue)} requests")
    for req in queue:
        r = results[req.rid]
        if len(r["tokens"]) != req.max_new_tokens:
            raise AssertionError(f"request {req.rid}: {len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            raise AssertionError(f"request {req.rid}: token out of range")
        for row in r["logits"]:
            if row.shape != (cfg.vocab_size,) or not np.isfinite(row).all():
                raise AssertionError(f"request {req.rid}: bad logits row {row.shape}")
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    metrics = dict(eng.metrics(), wall_s=wall, card=card)
    print(f"[engine] metrics {json.dumps(metrics)}", flush=True)
    print(f"[engine] launches {json.dumps(launches)}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.build import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    cfg = get_config("qwen2.5-3b")
    summary = phase_kernels(dev, cfg)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = phase_engine(dev, cfg, card)
    torch.cuda.synchronize()

    kernels = []
    for name in LAUNCHES:
        row = summary[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/flash_decode.cu" if name == "flash_decode"
                       else "src/repro_torch/kernels/csrc/vpu_matmul.cu"),
            "replaces": {
                "elementwise_matmul[approx_mult]": "src/repro/kernels/vpu_matmul.py:48",
                "elementwise_matmul[log_mult]": "src/repro/kernels/vpu_matmul.py:48",
                "elementwise_matmul_fused[approx_mult]": "src/repro/kernels/vpu_matmul.py:161",
                "elementwise_matmul_fused[log_mult]": "src/repro/kernels/vpu_matmul.py:161",
                "flash_decode": "src/repro/kernels/flash_decode.py:85",
            }[name],
            "launches": launches[name],
            "shape": row["shape"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
