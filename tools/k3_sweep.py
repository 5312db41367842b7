#!/usr/bin/env python3
"""K3 (``flash_decode``) over split lengths, on the card: the device time
of the kernel at each of ``tools/time_kernel.py``'s K3 shapes when its key
range is cut into splits of 32, 64, 96, ... keys, beside the split length
that ``repro_torch.kernels.flash_decode.geometry`` chooses, so that the
rule can be checked (or re-tuned) after a change to the kernel:

  python3 tools/k3_sweep.py

Needs a CUDA device.  Each row: the shape, the split length, the splits a
row and blocks of the launch, whether it is the rule's choice, the largest
difference from the plain version, and the device ms a call
(``repro_torch.launch.measure.device_ms`` over ``--iters`` calls).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from time_kernel import K3_SHAPES  # noqa: E402

from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch.measure import device_ms  # noqa: E402

MULTIPLES = (1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 128)  # of a block pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True
                         ).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    rule = fd.geometry
    try:
        for name, (B, S, KV, G, dh, (lo, hi)) in K3_SHAPES.items():
            bf = torch.bfloat16
            q = torch.randn((B, KV, G, dh), generator=g, device=dev).to(bf)
            ck = torch.randn((B, S, KV, dh), generator=g, device=dev).to(bf)
            cv = torch.randn((B, S, KV, dh), generator=g, device=dev).to(bf)
            pos = torch.randint(lo, hi, (B,), generator=g, device=dev).to(torch.int32)
            want = fd.flash_decode_ref(q, ck, cv, pos)
            chosen = rule(B, S, KV, G, dh, 2, torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
            block_pass = fd.WARPS * (32 // chosen.lpr) * chosen.steps
            seen = set()
            for k in sorted(set(MULTIPLES) | {chosen.split_len // block_pass}):
                split_len = k * block_pass
                geo = chosen._replace(split_len=split_len, n_splits=-(-S // split_len))
                if geo.n_splits in seen and geo != chosen:
                    continue
                seen.add(geo.n_splits)
                fd.geometry = lambda *_, geo=geo: geo
                run = lambda: fd.flash_decode(q, ck, cv, pos)
                err = (run() - want).abs().max().item()
                print(json.dumps({"shape": name, "split_len": split_len,
                                  "n_splits": geo.n_splits, "blocks": geo.blocks,
                                  "rule": geo == chosen, "max_abs_err": err,
                                  "device_ms": device_ms(run, args.iters, "flash_decode")}),
                      flush=True)
                if split_len >= S:
                    break
            del q, ck, cv
            torch.cuda.empty_cache()
    finally:
        fd.geometry = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
