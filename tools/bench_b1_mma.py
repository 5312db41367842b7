#!/usr/bin/env python3
"""Rate of the binary tensor-core product against the ALU pipe's LOP3 on
the card:

  python3 tools/bench_b1_mma.py

Builds ``tools/b1_mma.cu`` with nvcc for sm_90a into the gitignored
``build/`` and times, with CUDA events, a grid of warps that each issue
``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`` back to
back (16 x 8 x 256 AND+POPC bit products an instruction), and the same
grid issuing ``lop3.b32`` ((a & b) | acc, 32 bit-ANDs and ORs an
instruction), at several blocks per SM.  The SC contractions are an OR
of ANDs of stream words; as a product over k of stream bit j,
[sum_k x_j[m, k] w_j[k, n] > 0], they could run on the binary tensor
cores, and that pays only where their AND+POPC rate is well above the
ALU pipe's bit rate.  Prints the card's name and power limit, then one
JSON line per setting and a summary line with the best of each, in T
bit-ops/s.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tools" / "b1_mma.cu"
LIB = ROOT / "build" / "b1_mma.so"
MMA_BIT_OPS = 16 * 8 * 256  # AND+POPC bit products of one m16n8k256 b1 mma
LOP3_BIT_OPS = 32           # bit-ANDs (each with its OR) of one lop3.b32


def build() -> ctypes.CDLL:
    LIB.parent.mkdir(parents=True, exist_ok=True)
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(LIB), str(SRC)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    print(out.stdout + out.stderr, flush=True)
    out.check_returncode()
    lib = ctypes.CDLL(str(LIB))
    for fn in ("b1_mma", "lop3_loop"):
        getattr(lib, fn).argtypes = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2
        getattr(lib, fn).restype = ctypes.c_int
    lib.b1_chains.restype = ctypes.c_int
    return lib


def timed(fn, blocks, threads, iters, out) -> float:
    """Seconds of one launch, the best of three after a warm-up."""
    stream = torch.cuda.current_stream().cuda_stream
    if fn(blocks, threads, iters, out.data_ptr(), stream) != 0:
        raise RuntimeError("launch failed")
    best = float("inf")
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(blocks, threads, iters, out.data_ptr(), stream)
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_b1_mma: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = build()
    chains = lib.b1_chains()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best = {"b1_mma": 0.0, "lop3": 0.0}
    for per_sm in (1, 2, 4, 8):
        for threads in (128, 256):
            blocks = sms * per_sm
            out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
            for name, fn, iters, per in (
                    ("b1_mma", lib.b1_mma, 2000, MMA_BIT_OPS * (threads // 32)),
                    ("lop3", lib.lop3_loop, 20000, LOP3_BIT_OPS * threads)):
                sec = timed(fn, blocks, threads, iters, out)
                rate = blocks * iters * chains * per / sec / 1e12
                best[name] = max(best[name], rate)
                print(json.dumps({"op": name, "blocks_per_sm": per_sm, "threads": threads,
                                  "chains": chains, "iters": iters, "s": sec,
                                  "T_bit_ops_s": rate, "card": card}), flush=True)
    print(json.dumps({"best_T_bit_ops_s": best,
                      "b1_over_lop3": best["b1_mma"] / best["lop3"], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
