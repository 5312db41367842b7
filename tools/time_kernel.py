#!/usr/bin/env python3
"""Time an emulation kernel at every serving shape of qwen2.5-3b on the
card, K5 (``sc_matmul_packed_fused``), K7 (``analog_matmul_fused``), K4
(``sc_matmul_packed``, the SC prefill), K6 (``analog_matmul``, prefill), K2
(``elementwise_matmul_fused``), K1 (``elementwise_matmul``, prefill) or
the SC draws (``prng``), both multipliers for K1 and K2, or K3
(``flash_decode``, ``--kernel k3``: at ``K3_SHAPES``), for the
``repro_torch`` package under ``--src``, so that two trees can be timed in
turns in one run on one card:

  python3 tools/time_kernel.py --kernel k5 --label change
  python3 tools/time_kernel.py --kernel k5 --src parent/src --label parent

Needs a CUDA device.  Operands are the emulator's own (its value-domain
code on random bf16 activations and fan-in-scaled weights, seed 1), M = 4
(the engine's decode slots; K1, K4 and K6: ``--m``, default 64, the
largest prompt bucket of ``chip_smoke.py``), empty epilogue, bf16 out;
the SC draws are the port's own, ``--bits`` long (K4 and K5).  K6 is one polarity's call, as
``split_unipolar_contract`` makes it twice per prefill projection; its
row adds the float64 tensor-core bound (a multiply-add per row, port and
column at 67 TFLOP/s).  ``prng`` times ``ops.sc_draws`` for a decode
site's key path and 2K ports (``device_ms`` counts every kernel of the
call: in a tree that draws with ``torch.rand``, those).  K5 takes the threshold tables of its draws built beforehand, as on
the decode path, where a tree has them (``SCDraws``); a tree without
them builds its tables inside every call, as K4 does in every tree here.
K4 is timed on two routes: ``entry``, its one-polarity entry on the
emulator's planes, and ``quantized``, the SC prefill projection through
the backend's emulator on bf16 activations and fan-in-scaled weights,
draws whose tables each call builds (a tree that makes the planes in
plain torch and calls K4 once per polarity is timed with all of that:
``device_ms`` counts every kernel of the call); its row adds the ALU
bound (``alu_bound_ms``: a LOP3 per row, port, column, stream word and
polarity) and the same AND+POPC work at the binary tensor cores' rate
that ``tools/bench_b1_mma.py`` measured (``b1_bound_ms``).  Times: CUDA events
over ``--iters`` calls of the wrapper after one warm-up, no L2 flush
(``ms``: the host time of a call bounds it at small shapes), and the
device time of the kernel's source file per call from ``torch.profiler``
traces of as many calls, each after a warm-up call (``device_ms``:
``repro_torch.launch.measure``, which counts a kernel's launches by the
fullest trace and times it by the mean of its kept records, as the card's
tracer can drop some).  For K5
with tables, ``tables_device_ms`` is one table build.  K2 is timed as the
fused decode path calls it, through the backend's fused emulator on bf16
activations and fan-in-scaled weights (seed 1): in a tree that quantises
in plain torch in front of the kernel, the call's device time is that
prologue's kernels and K2's together, so ``device_ms`` counts every
kernel of the call and ``launches`` how many there were; ``by_kernel``
splits the device time by kernel (the first word of its name that
identifies it).  K1 is timed on two routes at M = ``--m`` (default 64): ``int``,
the integer entry on random integer operands (|x| <= 127 and 7 bits for the
truncated multiplier, 255 and 8 bits for Mitchell's; at M <= 4 it runs K2's
decode contraction), and ``quantized``, the prefill projection through the
backend's emulator on bf16 activations and fan-in-scaled weights (as K2: in
a tree that quantises in plain torch in front of K1, that prologue is in the
call's device time); its row adds the operations bound (``ops_bound_ms``:
the truncated product as int8 tensor-core multiply-adds over 16 slots a k,
Mitchell's as 3 instructions a product and 2 a weight at the dispatch
rate).  Prints the card's name and power limit, then one JSON line per shape with the bytes bound
(each plane, x and the output once, at 3.35 TB/s), the device time's
share of it and, for K5, the word-build floor: ``K5_INSTR_PER_PAIR``
instructions per weight pair at the dispatch rate (``INSTR_S``).  K3's
rows (bf16; pos drawn from each shape's range) give its bound as the larger
of its bytes (q, the keys and values up to pos, the float32 output) and its
float32 multiply-adds at 67 TFLOP/s, its launches and device time by
kernel, and masked ``scaled_dot_product_attention``'s device time
(``library_device_ms``, every kernel of the call) and CUDA-event time on
the same inputs.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

# the card's rates and the profiler's device time (src/repro_torch/launch/
# measure.py), loaded by path from this tree whatever --src names
_spec = importlib.util.spec_from_file_location(
    "_measure", Path(__file__).resolve().parents[1] / "src/repro_torch/launch/measure.py")
measure = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(measure)
HBM_BYTES_S, INSTR_S, ALU_S = measure.HBM_BYTES_S, measure.INSTR_S, measure.ALU_S
F64_TENSOR_OPS_S, INT8_TENSOR_OPS_S = measure.F64_TENSOR_OPS_S, measure.INT8_TENSOR_OPS_S
B1_BIT_OPS_S, device_ms = measure.B1_BIT_OPS_S, measure.device_ms

K5_INSTR_PER_PAIR = 63  # K5's word build and OR-accumulation per weight pair (sc_matmul.cu)
DECODE_M, PREFILL_M = 4, 64
# Mitchell's product in K1's CUDA-core contraction: an integer add, a LOP3
# and an FADD (SASS of csrc/vpu_matmul.cu's contract<1, ...>), none of
# whose pipes is busier than dispatch; and each weight's preparation, shared
# by the M rows (its level-table load and the fold of its sign)
MITCHELL_INSTR_PER_PRODUCT = 3
INSTR_PER_WEIGHT = 2
BITS = [32]  # SC stream length (--bits)
# (K, N) of every dense() site of qwen2.5-3b: q/o, k/v, gate/up, down, lm_head
SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (2048, 151936)]


def sc_operands(M, K, N, g, dev):
    from repro_torch.configs.base import SCParams
    from repro_torch.core.backends import _stream_planes
    from repro_torch.kernels import ops

    p = SCParams(bits=BITS[0])
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    xp, xn, wp, wn, pre = _stream_planes(x, w, p)
    xcat = torch.cat([xp, xn], dim=-1).contiguous()
    ux, uw = ops.sc_draws((1, K, N, M), 2 * K, p.bits, dev)
    return p, xcat, wp, wn, pre, ux, uw


def k4_call(K, N, g, dev, route, M):
    """K4 at one shape: its one-polarity entry on the emulator's planes
    (route "entry"; tables built in the call), or the SC prefill
    projection through the backend's emulator on bf16 activations and
    fan-in-scaled weights (route "quantized": draws whose tables are built
    in the call, as each prefill projection builds its own; in a tree that
    makes the planes in plain torch and calls K4 twice, all of that).  Any
    tree."""
    from repro_torch.kernels import sc_matmul as sc

    if route == "quantized":
        from repro_torch.configs.base import SCParams
        from repro_torch.core import backends
        from repro_torch.kernels import ops

        p = SCParams(bits=BITS[0])
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        ux, uw = ops.sc_draws((1, K, N, M), 2 * K, p.bits, dev)
        rng = lambda n_ports, n_bits, device: sc.SCDraws(ux, uw)
        return lambda: backends._emulate_sc(x, w, p, rng), None
    p, xcat, wp, wn, _, ux, uw = sc_operands(M, K, N, g, dev)
    if not hasattr(sc, "SCDraws"):
        return lambda: sc.sc_matmul_cuda(xcat, (wp, wn), p.bits, ux, uw), None
    return lambda: sc.sc_matmul_cuda(xcat, (wp, wn), p.bits, (ux, uw)), None


def k5_call(K, N, g, dev):
    """The K5 call at one shape and, where the tree has them, a table build."""
    from repro_torch.kernels import sc_matmul as sc

    p, xcat, wp, wn, pre, ux, uw = sc_operands(DECODE_M, K, N, g, dev)
    if not hasattr(sc, "SCDraws"):
        return lambda: sc.sc_matmul_fused_cuda(xcat, (wp, wn), p.bits, ux, uw, pre, {},
                                               torch.bfloat16), None
    draws = sc.SCDraws(ux, uw)
    draws.tables  # built now, as once per decode step
    return (lambda: sc.sc_matmul_fused_cuda(xcat, (wp, wn), p.bits, draws, pre, {},
                                            torch.bfloat16),
            lambda: sc.sc_tables_cuda(ux, uw))


def k7_call(K, N, g, dev):
    from repro_torch.configs.base import AnalogParams
    from repro_torch.core.backends import _array_planes
    from repro_torch.kernels.analog_matmul import analog_matmul_fused_cuda

    p = AnalogParams()
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((DECODE_M, K), generator=g, device=dev).to(torch.bfloat16)
    xp, xn, wp, wn, pre = _array_planes(x, w, p)
    xcat = torch.cat([xp, xn], dim=-1).contiguous()
    return lambda: analog_matmul_fused_cuda(xcat, (wp, wn), p.array_size, p.adc_bits,
                                            p.adc_range, pre, {}, torch.bfloat16), None


def k6_call(K, N, g, dev, M):
    """One K6 call at one shape: the positive polarity of a prefill
    projection of M tokens, on the emulator's planes."""
    from repro_torch.configs.base import AnalogParams
    from repro_torch.core.backends import _array_planes
    from repro_torch.kernels.analog_matmul import analog_matmul_cuda

    p = AnalogParams()
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    xp, xn, wp, wn, _ = _array_planes(x, w, p)
    xcat = torch.cat([xp, xn], dim=-1).contiguous()
    return lambda: analog_matmul_cuda(xcat, (wp, wn), p.array_size, p.adc_bits,
                                      p.adc_range), None


def prng_call(K, N, g, dev):
    """The SC draws of one decode site's key path for 2K ports (any tree)."""
    from repro_torch.kernels import ops

    path = (0, 7, 1583461021)
    return lambda: ops.sc_draws(path, 2 * K, BITS[0], dev), None


def k2_call(K, N, g, dev, mul):
    """The fused decode projection of a multiplier-error backend, from the
    operands themselves (any tree)."""
    from repro_torch.configs.base import ApproxMultParams, LogMultParams
    from repro_torch.core import backends

    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((DECODE_M, K), generator=g, device=dev).to(torch.bfloat16)
    if mul == "approx_mult":
        return lambda: backends._fused_emulate_approx_mult(x, w, ApproxMultParams(), None, {})
    return lambda: backends._fused_emulate_log_mult(x, w, LogMultParams(), None, {})


def k1_call(K, N, g, dev, mul, route, M):
    """K1 on integer operands (route "int"), or the prefill projection of a
    multiplier-error backend through its emulator on bf16 activations and
    fan-in-scaled weights (route "quantized": in a tree that quantises in
    plain torch in front of K1, that prologue and K1; any tree)."""
    import inspect

    from repro_torch.configs.base import ApproxMultParams, LogMultParams
    from repro_torch.core import backends
    from repro_torch.kernels.vpu_matmul import elementwise_matmul_cuda

    if route == "quantized":
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        if mul == "approx_mult":
            return lambda: backends._emulate_approx_mult(x, w, ApproxMultParams(), None)
        return lambda: backends._emulate_log_mult(x, w, LogMultParams(), None)
    bits, drop = (7, 4) if mul == "approx_mult" else (8, 0)
    hi = (1 << bits) - 1
    x = torch.randint(-hi, hi + 1, (M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-hi, hi + 1, (K, N), generator=g, device=dev).to(torch.bfloat16)
    if "bits" in inspect.signature(elementwise_matmul_cuda).parameters:
        return lambda: elementwise_matmul_cuda(x, w, mul, drop, bits)
    return lambda: elementwise_matmul_cuda(x, w, mul, drop)


# K3's shapes: (B, S, KV, G, dh, pos drawn from [lo, hi)), bf16
K3_SHAPES = {
    "serving": (4, 96, 2, 8, 128, (16, 96)),  # chip_smoke.py's engine window
    "qwen-4k": (4, 4096, 2, 8, 128, (3900, 4096)),
    "batch-32": (32, 2048, 2, 8, 128, (1800, 2048)),
    "granite-group": (4, 96, 1, 48, 128, (16, 96)),
}


def k3_call(name, g, dev):
    """K3 at one of K3_SHAPES (any tree), and the library yardstick: one
    masked ``scaled_dot_product_attention`` call on the same inputs, heads
    expanded beforehand (timed only; the port never calls it).  Returns
    the two calls and K3's bytes (q, the keys and values up to pos, pos,
    the float32 output) and float32 operations (a multiply-add for each
    logit and each P.V term)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import flash_decode

    B, S, KV, G, dh, (lo, hi) = K3_SHAPES[name]
    bf = torch.bfloat16
    q = torch.randn((B, KV, G, dh), generator=g, device=dev).to(bf)
    ck = torch.randn((B, S, KV, dh), generator=g, device=dev).to(bf)
    cv = torch.randn((B, S, KV, dh), generator=g, device=dev).to(bf)
    pos = torch.randint(lo, hi, (B,), generator=g, device=dev).to(torch.int32)
    qh = q.reshape(B, KV * G, 1, dh)
    kh = ck.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = cv.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
    keys = int((pos.clamp(max=S - 1).long() + 1).sum())
    nbytes = 2 * q.numel() + 2 * 2 * keys * KV * dh + 4 * B + 4 * q.numel()
    return (lambda: flash_decode(q, ck, cv, pos),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            nbytes, 4.0 * keys * KV * G * dh)


# kernel -> (call maker, name key of its kernels in a trace; "" counts every kernel)
KERNELS = {"k4": (k4_call, "repro_sc::"), "k5": (k5_call, "repro_sc::"),
           "k6": (k6_call, "repro_analog::"), "k7": (k7_call, "repro_analog::"),
           "k2": (k2_call, ""), "k1": (k1_call, "repro_vpu::"), "prng": (prng_call, ""),
           "k3": (k3_call, "flash_decode")}
BY_KERNEL = ("scale_pass", "decode_contract", "mma_contract", "expand_slots", "contract",
             "sum_levels", "finish", "to_float", "flash_decode_split", "flash_decode_kernel")


def k1_ops_bound_ms(mul, M, K, N) -> float:
    """K1's operations bound: the truncated product as int8 tensor-core
    multiply-adds over 16 slots a k (2 operations each); Mitchell's as its
    instructions at the dispatch rate (MITCHELL_INSTR_PER_PRODUCT a product,
    INSTR_PER_WEIGHT a weight; as chip_smoke.py counts them)."""
    if mul == "approx_mult":
        return 2.0 * M * 16 * K * N / INT8_TENSOR_OPS_S * 1e3
    return (M * MITCHELL_INSTR_PER_PRODUCT + INSTR_PER_WEIGHT) * K * N / INSTR_S * 1e3


def trace_split(fn, iters: int):
    """Kernels per call, and device ms per call by kernel (the first of
    BY_KERNEL in its name, else the start of its name), from profiler
    traces of ``iters`` calls (``measure.kernel_times``)."""
    launches, split = 0, {}
    for name, (n, ms) in measure.kernel_times(fn, iters).items():
        group = next((k for k in BY_KERNEL if k in name), name[:40])
        launches += n
        split[group] = split.get(group, 0.0) + n * ms
    return launches, split


def events_ms(fn, iters: int) -> float:
    """Mean ms a call by CUDA events over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_k3(args, card: str, g, dev) -> None:
    """One row per K3_SHAPES entry: K3's time beside its bound and SDPA's."""
    for name in K3_SHAPES:
        run, lib, nbytes, n_ops = k3_call(name, g, dev)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = n_ops / measure.CUDA_CORE_OPS_S * 1e3
        dev_ms = device_ms(run, args.iters, "flash_decode")
        launches, split = trace_split(run, args.iters)
        row = {"label": args.label, "kernel": "k3", "shape": name,
               "B_S_KV_G_dh": list(K3_SHAPES[name][:5]), "ms": events_ms(run, args.iters),
               "device_ms": dev_ms, "launches": launches, "by_kernel": split,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "share": max(t_bytes, t_ops) / dev_ms,
               "library_device_ms": device_ms(lib, args.iters, ""),
               "library_ms": events_ms(lib, args.iters), "card": card}
        print(json.dumps(row), flush=True)
        del run, lib
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--m", type=int, default=PREFILL_M, help="K1's and K6's rows")
    ap.add_argument("--bits", type=int, default=32, help="SC stream length (K4, K5, prng)")
    args = ap.parse_args()
    BITS[0] = args.bits
    if not torch.cuda.is_available():
        print("time_kernel: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    make, key = KERNELS[args.kernel]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    if args.kernel == "k3":
        time_k3(args, card, g, dev)
        return 0
    two_muls = args.kernel in ("k1", "k2")
    variants = [("approx_mult",), ("log_mult",)] if two_muls else [()]
    if args.kernel == "k1":
        variants = [(mul, route) for mul in ("approx_mult", "log_mult")
                    for route in ("int", "quantized")]
    if args.kernel == "k4":
        variants = [("entry",), ("quantized",)]
    for (K, N), extra in ((shape, v) for shape in SHAPES for v in variants):
        if args.kernel == "k2":
            run, tables = make(K, N, g, dev, *extra), None
        elif args.kernel == "k1":
            run, tables = make(K, N, g, dev, *extra, args.m), None
            key = "repro_vpu::" if extra[1] == "int" else ""
        elif args.kernel == "k4":
            run, tables = make(K, N, g, dev, *extra, args.m)
            key = "repro_sc::" if extra[0] == "entry" else ""
        elif args.kernel == "k6":
            run, tables = make(K, N, g, dev, args.m)
        else:
            run, tables = make(K, N, g, dev)
        ms = events_ms(run, args.iters)
        dev_ms = device_ms(run, args.iters, key)
        M = {"k4": args.m, "k6": args.m, "k1": args.m}.get(args.kernel, DECODE_M)
        if args.kernel == "k2":  # x, w and the output, bf16
            bound_ms = (2 * M * K + 2 * K * N + 2 * M * N) / HBM_BYTES_S * 1e3
        elif args.kernel == "k1":  # x, w (bf16) and the output (int: float32)
            bound_ms = (2 * M * K + 2 * K * N + (4 if extra[1] == "int" else 2) * M * N) \
                / HBM_BYTES_S * 1e3
        elif args.kernel == "k6":  # x [M, 2K] and two halves (bf16), the float32 output
            bound_ms = (2 * M * 2 * K + 2 * 2 * K * N + 4 * M * N) / HBM_BYTES_S * 1e3
        elif args.kernel == "k4" and extra[0] == "quantized":  # x, w and the output, bf16
            bound_ms = (2 * M * K + 2 * K * N + 2 * M * N) / HBM_BYTES_S * 1e3
        elif args.kernel == "prng":  # ux and uw written once, float32
            bound_ms = 4 * (2 * K + 1) * args.bits / HBM_BYTES_S * 1e3
        else:  # x [M, 2K] and two weight halves
            bound_ms = (2 * M * 2 * K + 2 * 2 * K * N + 2 * M * N) / HBM_BYTES_S * 1e3
        row = {"label": args.label, "kernel": args.kernel, "shape": [M, K, N], "ms": ms,
               "device_ms": dev_ms, "bound_ms": bound_ms, "share": bound_ms / dev_ms,
               "card": card}
        if two_muls or args.kernel in ("k4", "k6", "prng"):
            if two_muls:
                row["mul"] = extra[0]
            row["launches"], row["by_kernel"] = trace_split(run, args.iters)
        if args.kernel == "k1":
            row["route"] = extra[1]
            row["ops_bound_ms"] = k1_ops_bound_ms(extra[0], M, K, N)
        if args.kernel == "k6":
            row["f64_ops_bound_ms"] = 2.0 * M * 2 * K * N / F64_TENSOR_OPS_S * 1e3
        if args.kernel in ("k4", "k5", "prng"):
            row["bits"] = args.bits
        if args.kernel == "k4":
            # a LOP3 per row, port, column, stream word and polarity on the
            # ALU pipe (as chip_smoke.py counts it), and the same AND+POPC
            # work at the binary tensor cores' rate (tools/bench_b1_mma.py)
            pol = 2 if extra[0] == "quantized" else 1
            bit_ops = pol * M * 2 * K * N * args.bits
            row["route"] = extra[0]
            row["alu_bound_ms"] = bit_ops / 32 / ALU_S * 1e3
            row["b1_bound_ms"] = bit_ops / B1_BIT_OPS_S * 1e3
        if args.kernel == "k5":
            row["instr_floor_ms"] = K * N * K5_INSTR_PER_PAIR / INSTR_S * 1e3
            if tables is not None:
                tables()
                row["tables_device_ms"] = device_ms(tables, args.iters, key)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
