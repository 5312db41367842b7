#!/usr/bin/env python3
"""Time K7 (``analog_matmul_fused``) at every serving shape of qwen2.5-3b
on the card, for the ``repro_torch`` package under ``--src``, so that two
trees can be timed in turns in one run on one card:

  python3 tools/time_k7.py --label change
  python3 tools/time_k7.py --src parent/src --label parent

Needs a CUDA device.  Operands are the analog emulator's own (its
value-domain code on random bf16 activations and fan-in-scaled weights,
seed 1), M = 4 (the engine's decode slots), empty epilogue, bf16 out.
Times: CUDA events over ``--iters`` calls of the wrapper after one
warm-up, no L2 flush (``ms``: the host time of a call bounds it at small
shapes), and the device time of the kernels of ``analog_matmul.cu`` per
call from a ``torch.profiler`` trace of as many calls (``device_ms``).
Prints the card's name and power limit, then one JSON line per shape with
the bytes bound (each input read once, the output written once, at
3.35 TB/s) and the device time's share of it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
M = 4
# (K, N) of every dense() site of qwen2.5-3b: q/o, k/v, gate/up, down, lm_head
SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (2048, 151936)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k7: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.base import AnalogParams
    from repro_torch.core.backends import _array_planes
    from repro_torch.kernels.analog_matmul import analog_matmul_fused_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    p = AnalogParams()
    g = torch.Generator(device=dev).manual_seed(1)
    for K, N in SHAPES:
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        xp, xn, wp, wn, pre = _array_planes(x, w, p)
        xcat = torch.cat([xp, xn], dim=-1).contiguous()
        run = lambda: analog_matmul_fused_cuda(xcat, (wp, wn), p.array_size, p.adc_bits,
                                               p.adc_range, pre, {}, torch.bfloat16)
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.iters
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
        device_ms = sum(ev.time_range.elapsed_us() for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA
                        and "repro_analog::" in ev.name) / 1e3 / args.iters
        bound_ms = (2 * M * 2 * K + 2 * 2 * K * N + 2 * M * N) / HBM_BYTES_S * 1e3
        print(json.dumps({"label": args.label, "shape": [M, K, N], "ms": ms,
                          "device_ms": device_ms, "bound_ms": bound_ms,
                          "share": bound_ms / device_ms, "card": card}), flush=True)
        del w, x, xp, xn, wp, wn, xcat
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
