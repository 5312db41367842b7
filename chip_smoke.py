#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one, and when run outside a
checkout of the repository.  Phases, each synchronised before the next:

1. Build every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (qwen2.5-3b full width): K1 and K2 for
   both multipliers, K4 and K5 (SC), K6 and K7 (analog) must be bitwise
   equal (the fused ones also with random epilogue operands); K3 within
   1e-4, also at G * dh = 6144 (granite-20b's attention group) and at a
   4096-key context.  K1 (the prefill projection, 64 rows) and K2
   (decode) run as the serving path calls them, on bf16 activations and
   weights that they quantise themselves, and on their integer-operand
   entries (K1's truncated
   product on the int8 tensor cores).  So does the SC prefill projection
   (K4's function for both polarities, the planes formed in its loads),
   held at 32 and 512-bit streams at every site.  K4's one-polarity entry,
   K5, K6 and K7 take operands from the emulators' own value-domain code
   on random bf16 activations and weights.  K5 takes
   the threshold tables of its draws built beforehand, as on the decode
   path, and the tables kernel is held bitwise against its plain version
   at each K5 site, as is the draws kernel (threefry, bitwise
   ``jax.random``) against its plain version on the card and the CPU.  K4
   and K5 are also held and timed at gate/up with 512-bit streams.  Each
   kernel
   is timed with CUDA events over calls of its wrapper (``ms``, which the
   host time of a call bounds at small shapes) and by a ``torch.profiler``
   trace of its own kernels (``device_ms``), beside its plain version, its
   roofline bound and, for K3, a masked ``scaled_dot_product_attention``
   call (its device time, timed here only; the port never calls it).
3. Serve a seeded queue through the engine on the qwen2.5-3b smoke config
   on the card and on the CPU, backends exact, log_mult, approx_mult, sc
   and analog, each device with its own ``init(0)`` (held equal, tensor
   by tensor) and its own SC draws.  Exact and multiplier-error
   requests: greedy tokens equal, logits within 1e-3.  Every emulated
   projection the card ran, recomputed on the CPU by the plain version
   from the same operands and key path (the CPU drawing its own), is
   bitwise equal (end to end, a stream bit or ADC level at a decision
   boundary may flip when an upstream op differs in its last bit, so SC
   and analog tokens are reported, not required equal).
4. Serve 10 requests at qwen2.5-3b full width (bf16, random weights from
   the seed; backends exact, log_mult, approx_mult, sc, analog cycled;
   fused decode) and check every kernel of the path was launched; then
   serve the same queue again on the warm engine for per-lane
   steady-state rates.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the card's rates and the profiler's device time, shared with
# tools/time_kernel.py, profile_decode and the card tests
from repro_torch.launch.measure import (  # noqa: E402
    ALU_S,
    B1_BIT_OPS_S,
    CUDA_CORE_OPS_S,
    F64_TENSOR_OPS_S,
    HBM_BYTES_S,
    INSTR_S,
    INT8_TENSOR_OPS_S,
    INT_OPS_S,
    device_ms,
)

# instructions a product, (all, on the ALU pipe), from the SASS of
# csrc/vpu_matmul.cu: Mitchell's product as the add of float32 bit patterns
# of K1's contraction (an integer add, a LOP3, an FADD; the least count of
# the function, so K2's bound takes it too) and K2's truncated product
# (IMAD, LOP3, IADD3)
PRODUCT_INSTR = {"log_mult": (3, 1), "approx_mult": (3, 2)}
# instructions a weight, shared by the M rows that use it: its level-table
# load and the fold of its sign
WEIGHT_INSTR = (2, 1)


def product_bound(nbytes: float, mul: str, M: int, K: int, N: int):
    """The bytes, or the M K N products and the K N weights' preparation at
    the busier of dispatch and the ALU pipe, whichever takes longer."""
    (p_all, p_alu), (w_all, w_alu) = PRODUCT_INSTR[mul], WEIGHT_INSTR
    t_ops = K * N * max((M * p_all + w_all) / INSTR_S, (M * p_alu + w_alu) / ALU_S)
    return bound(nbytes, t_ops * INSTR_S, INSTR_S)


THREEFRY_OPS = 72        # integer ops of one threefry2x32 block (prng.cu)
SC_LONG_BITS = 512       # the stream length of the K4/K5 rows beyond the old 256-bit cap
PREFILL_M = 64           # largest prompt bucket of the engine phase
DECODE_M = 4             # slots of the engine phase
MAX_SEQ = 96             # engine phase: prompts <= 64 + <= 32 new tokens
K3_LONG_S = 4096         # K3's serving-context row: qwen2.5-3b at a 4k context

# kernel (launch-count name) -> (CUDA source, the TPU kernel's pl.pallas_call)
KERNEL_SOURCES = {
    # K1's function on the operands themselves (the prefill projection, the
    # quantisation in front of the reference's pallas_call taken in)
    "elementwise_matmul[approx_mult,quantized]": ("vpu_matmul.cu", "vpu_matmul.py:79"),
    "elementwise_matmul[log_mult,quantized]": ("vpu_matmul.cu", "vpu_matmul.py:79"),
    "elementwise_matmul_fused[approx_mult]": ("vpu_matmul.cu", "vpu_matmul.py:228"),
    "elementwise_matmul_fused[log_mult]": ("vpu_matmul.cu", "vpu_matmul.py:228"),
    "flash_decode": ("flash_decode.cu", "flash_decode.py:98"),
    # K4's function for both polarities on the operands themselves (the SC
    # prefill projection, the value-domain code in front of the reference's
    # pallas_call taken in)
    "sc_matmul_packed[quantized]": ("sc_matmul.cu", "sc_matmul.py:89"),
    "sc_matmul_packed_fused": ("sc_matmul.cu", "sc_matmul.py:235"),
    "analog_matmul": ("analog_matmul.cu", "analog_matmul.py:87"),
    "analog_matmul_fused": ("analog_matmul.cu", "analog_matmul.py:233"),
    # the threshold tables in front of K4/K5: the stream generation of the
    # reference's ops.sc_matmul_fused (jnp, not a Pallas kernel)
    "sc_tables": ("sc_matmul.cu", "ops.py:177"),
    # the SC generator draws: the reference's jax.random.uniform (not a
    # Pallas kernel)
    "sc_draws": ("prng.cu", "ops.py:97"),
}
# the kernels the serving path launches (the integer-operand entries of K1
# and K2, K4's one-polarity entry on given planes and its packed-words
# entry are checks off the path)
PATH_KERNELS = tuple(KERNEL_SOURCES)
EMULATED = ("log_mult", "approx_mult", "sc", "analog")


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


def bound(nbytes: float, ops: float, ops_s: float = CUDA_CORE_OPS_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _chip_epilogue(g, dev, N, dtype):
    return {
        "colgain": (1 + 0.05 * torch.randn(N, generator=g, device=dev)).to(dtype),
        "coladd": (0.02 * torch.randn(N, generator=g, device=dev)).to(dtype),
        "mean_coeffs": torch.tensor([0.01, -0.02, 0.003, -0.0004], device=dev),
        "mean_scale": torch.tensor(1.7, device=dev),
    }


def _hold(kname, shape, got, want) -> None:
    """Fail unless the kernel's output is bitwise its plain version's."""
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{kname} {shape}: not bitwise equal to its plain version "
                             f"(max |diff| {diff})")


def phase_kernels(dev, cfg):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.vpu_matmul import (
        elementwise_matmul_cuda,
        elementwise_matmul_fused_cuda,
        elementwise_matmul_fused_ref,
        int_operand_matmul_fused_cuda,
        int_operand_matmul_fused_ref,
        plain_multiplier,
    )

    rep = (cfg.d_model, cfg.d_ff)  # the shape each kernel's summary entry reports
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    # (largest integer operand, dropped bits, operand bits of the backend)
    mults = {"approx_mult": (127, 4, 7), "log_mult": (255, 0, 8)}
    summary = {}

    def report(name, M, K, N, err, run, plain, nbytes, key="repro_vpu::"):
        iters = 3 if M * K * N > 2e9 else 10
        if name.startswith("elementwise_matmul[approx_mult"):
            # the slot formulation: an int8 multiply-add per row, slot, k and column
            b_ms, b_by = bound(nbytes, 2.0 * M * 16 * K * N, INT8_TENSOR_OPS_S)
        else:  # the products' instructions
            mul = "log_mult" if "log_mult" in name else "approx_mult"
            b_ms, b_by = product_bound(nbytes, mul, M, K, N)
        row = {"name": name, "shape": [M, K, N], "max_abs_err": err,
               "ms": cuda_ms(run, iters), "device_ms": device_ms(run, iters, key),
               "plain_ms": cuda_ms(plain, 1), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        print(f"[kernels] {json.dumps(row)}", flush=True)
        if (K, N) == rep:
            summary[name] = row

    for mul, (hi, drop, bits) in mults.items():
        mulf = plain_multiplier(mul, drop)
        for K, N in _site_shapes(cfg):
            # K1 (prefill) on integer operands: a check entry
            M = PREFILL_M
            x = torch.randint(-hi, hi + 1, (M, K), generator=g, device=dev).to(bf)
            w = torch.randint(-hi, hi + 1, (K, N), generator=g, device=dev).to(bf)
            run = lambda: elementwise_matmul_cuda(x, w, mul, drop, bits)
            plain = lambda: ref.elementwise_matmul_ref(x, w, mulf)
            _hold(f"elementwise_matmul[{mul}]", (M, K, N), run(), plain())
            report(f"elementwise_matmul[{mul}]", M, K, N, 0.0, run, plain,
                   2 * (M * K + K * N) + 4 * M * N)
            # the prefill projection as the serving path calls it: bf16
            # activations and fan-in-scaled weights, quantised in the kernel
            xq = torch.randn((M, K), generator=g, device=dev).to(bf)
            wq = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
            run = lambda: int_operand_matmul_fused_cuda(xq, wq, bits, mul, {}, bf, drop)
            plain = lambda: int_operand_matmul_fused_ref(xq, wq, bits, mulf, {}, bf)
            _hold(f"elementwise_matmul[{mul},quantized]", (M, K, N), run(), plain())
            report(f"elementwise_matmul[{mul},quantized]", M, K, N, 0.0, run, plain,
                   2 * (M * K + K * N) + 2 * M * N)
            del xq, wq
            # K2's integer-operand entry (the reference kernel's interface)
            M = DECODE_M
            x, w = x[:M].contiguous(), w
            pre = (torch.rand((M, 1), generator=g, device=dev) * 1e-4).to(bf)
            for epi in ({}, _chip_epilogue(g, dev, N, bf)):
                _hold(f"elementwise_matmul_fused[{mul},int]", (M, K, N),
                      elementwise_matmul_fused_cuda(x, w, mul, pre, epi, bf, drop),
                      elementwise_matmul_fused_ref(x, w, mulf, pre, epi, bf))
            if (K, N) == rep:
                report(f"elementwise_matmul_fused[{mul},int]", M, K, N, 0.0,
                       lambda: elementwise_matmul_fused_cuda(x, w, mul, pre, {}, bf, drop),
                       lambda: elementwise_matmul_fused_ref(x, w, mulf, pre, {}, bf),
                       2 * (M * K + K * N) + 2 * M * N + 2 * M)
            # K2 as the serving path calls it: bf16 activations and
            # fan-in-scaled weights, quantised in the kernel
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
            for epi in ({}, _chip_epilogue(g, dev, N, bf)):
                _hold(f"elementwise_matmul_fused[{mul}]", (M, K, N),
                      int_operand_matmul_fused_cuda(x, w, bits, mul, epi, bf, drop),
                      int_operand_matmul_fused_ref(x, w, bits, mulf, epi, bf))
            report(f"elementwise_matmul_fused[{mul}]", M, K, N, 0.0,
                   lambda: int_operand_matmul_fused_cuda(x, w, bits, mul, {}, bf, drop),
                   lambda: int_operand_matmul_fused_ref(x, w, bits, mulf, {}, bf),
                   2 * (M * K + K * N) + 2 * M * N)
            del x, w
            torch.cuda.empty_cache()

    # K3 at the decode shape: B slots, S = serving window, per-row
    # positions; at granite-20b's group (48 query heads of one KV head, 6 G
    # tiles); and at a 4k context (the keys split across the card's SMs)
    B = DECODE_M
    serving = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head)
    for S, (KV, G, dh), lo in ((MAX_SEQ, serving, 16), (MAX_SEQ, (1, 48, 128), 16),
                               (K3_LONG_S, serving, K3_LONG_S - 196)):
        q = torch.randn((B, KV, G, dh), generator=g, device=dev).to(bf)
        ck = torch.randn((B, S, KV, dh), generator=g, device=dev).to(bf)
        cv = torch.randn((B, S, KV, dh), generator=g, device=dev).to(bf)
        pos = torch.randint(lo, S, (B,), generator=g, device=dev).to(torch.int32)
        got, want = flash_decode(q, ck, cv, pos), flash_decode_ref(q, ck, cv, pos)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"flash_decode S={S} G*dh={G * dh}: max |diff| {err} > 1e-4 "
                                 f"against its plain version")
        # library yardstick: masked SDPA over the same inputs, heads expanded
        qh = q.reshape(B, KV * G, 1, dh)
        kh = ck.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        vh = cv.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        lib_err = (lib().float().reshape(B, KV, G, dh) - want).abs().max().item()
        keys = int((pos.long() + 1).sum())
        nbytes = 2 * q.numel() + 2 * 2 * keys * KV * dh + 4 * B + 4 * got.numel()
        b_ms, b_by = bound(nbytes, 4.0 * keys * KV * G * dh)
        run = lambda: flash_decode(q, ck, cv, pos)
        # library_ms: SDPA's device time (every kernel of the call), as the
        # kernel's; its CUDA-event time, which the host bounds, beside it
        row = {"name": "flash_decode", "shape": [B, S, KV, G, dh], "max_abs_err": err,
               "ms": cuda_ms(run, 50), "device_ms": device_ms(run, 50, "flash_decode"),
               "plain_ms": cuda_ms(lambda: flash_decode_ref(q, ck, cv, pos), 50),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(lib, 50, ""),
               "library_events_ms": cuda_ms(lib, 50), "library_max_abs_err": lib_err}
        if "flash_decode" not in summary:  # the serving shape
            summary["flash_decode"] = row
        print(f"[kernels] {json.dumps(row)}", flush=True)
        del q, ck, cv, kh, vh, got, want
    torch.cuda.empty_cache()
    return summary


def _site_shapes(cfg):
    """(K, N) of every dense() site: q/o, k/v, gate/up, down, lm_head."""
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KVd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    return [(D, H), (D, KVd), (D, F_), (F_, D), (D, V)]


def _sc_work(kname, M, K, N, bits):
    """Bytes (each input read once, each output written once), AND bit
    products (row, port, column, stream bit, polarity) and stream words
    built (a table lookup each) of K4's or K5's function."""
    P, W = 2 * K, bits // 32
    pol = 1 if kname == "sc_matmul_packed" else 2
    draws = 4 * bits + 4 * P * bits  # ux and uw, float32: the draws, not their tables
    if "quantized" in kname:  # the raw bf16 x [M, K] and w, the bf16 output
        nbytes = 2 * M * K + 2 * K * N + draws + 2 * M * N
        built = K * N * W  # one word pair a weight for both polarities
    else:  # x [M, 2K] and the two bf16 weight halves
        nbytes = 2 * M * P + 2 * K * N * 2 + draws + (2 if kname.endswith("fused") else 4) * M * N
        built = pol * P * N * W
    return nbytes, pol * M * P * N * bits, built + M * P * W


def _sc_alu_ms(kname, M, K, N, bits):
    """K4's or K5's operations on the ALU pipe alone, as their kernels do
    them: a LOP3 (AND, then OR) per 32 bit products, one per word built."""
    _, products, built = _sc_work(kname, M, K, N, bits)
    return (products / 32 + built) / ALU_S * 1e3


def _sc_analog_bound(kname, M, K, N, bits):
    """Bytes each input read once and each output written once; the
    operations each kernel's function needs (see PERF.md)."""
    from repro_torch.kernels.sc_matmul import table_words

    if kname == "sc_tables":
        # rank of each of a row's 64 thresholds among the 64, and its 65
        # masks of 64 bits each: comparisons per row
        W = bits // 32
        return bound(4 * bits + 4 * 2 * K * bits + 4 * table_words(K, bits),
                     (K + 1) * W * (64 * 64 + 65 * 64))
    if kname.startswith("sc"):
        # the bit products at the binary tensor cores' rate, the card's
        # fastest unit for them; the words built on the ALU pipe (seconds,
        # so at a rate of 1)
        nbytes, products, built = _sc_work(kname, M, K, N, bits)
        return bound(nbytes, max(products / B1_BIT_OPS_S, built / ALU_S), 1.0)
    return bound(*_analog_work(kname, M, K, N), F64_TENSOR_OPS_S)


def _analog_work(kname, M, K, N):
    """Bytes and operations of K6 (one polarity) or K7 (both): x and the
    two bf16 halves read once, the output written once; a multiply-add (2
    ops) per (row, port, column) per polarity, on the float64 tensor
    cores (the array sums must be exact)."""
    fused = kname.endswith("fused")
    nbytes = 2 * M * 2 * K + 2 * K * N * 2 + (2 if fused else 4) * M * N
    return nbytes, (2 if fused else 1) * 2.0 * M * 2 * K * N


def phase_sc_analog(dev, cfg):
    """K4-K7 against their plain versions at every serving shape, on the
    operands the emulators make (value-domain code of core/backends.py on
    random bf16 activations and fan-in-scaled weights)."""
    from repro_torch.configs.base import AnalogParams, SCParams
    from repro_torch.core.backends import _array_planes, _stream_planes
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.analog_matmul import (
        analog_matmul_cuda,
        analog_matmul_fused_cuda,
        analog_matmul_fused_ref,
    )
    from repro_torch.kernels.sc_matmul import (
        SCDraws,
        sc_matmul_cuda,
        sc_matmul_fused_cuda,
        sc_matmul_fused_ref,
        sc_matmul_quantized_cuda,
        sc_matmul_quantized_ref,
        sc_matmul_words_cuda,
        sc_tables_cuda,
        sc_tables_ref,
    )

    def _tables_row(K, N, ux, uw, bits):
        """The tables kernel against its plain version (bitwise) for the
        draws of a K5 site, timed."""
        got, want = sc_tables_cuda(ux, uw), sc_tables_ref(ux, uw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"sc_tables K={K} bits={bits}: not bitwise equal to its plain "
                                 f"version ({int((got != want).sum())} words differ)")
        b_ms, b_by = _sc_analog_bound("sc_tables", DECODE_M, K, N, bits)
        row = {"name": "sc_tables", "shape": [K, bits], "max_abs_err": 0.0,
               "ms": cuda_ms(lambda: sc_tables_cuda(ux, uw), 10),
               "device_ms": device_ms(lambda: sc_tables_cuda(ux, uw), 10, "repro_sc::"),
               "plain_ms": cuda_ms(lambda: sc_tables_ref(ux, uw), 1), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        print(f"[kernels] {json.dumps(row)}", flush=True)
        return row

    def _prefill_rows(K, N, w):
        """The SC prefill projection as the serving path calls it (raw bf16
        activations and weights, draws whose tables it builds) against its
        plain version, bitwise, at 32 and 512-bit streams; timed at 32 bits
        (and 512 at the reported shape), where each call builds its tables
        as each prefill projection does."""
        kname, M, rows = "sc_matmul_packed[quantized]", PREFILL_M, {}
        x = torch.randn((M, K), generator=g, device=dev).to(bf)
        for bits in (sc_p.bits, SC_LONG_BITS):
            ux, uw = ops.sc_draws((3, K, N, M), 2 * K, bits, dev)
            run = lambda: sc_matmul_quantized_cuda(x, w, sc_p.gain, bits, SCDraws(ux, uw))
            plain = lambda: sc_matmul_quantized_ref(x, w, sc_p.gain, bits, (ux, uw))
            want = plain()
            _hold(kname if bits == sc_p.bits else f"{kname}@{bits}", (M, K, N), run(), want)
            if not bool(want.float().abs().max() > 0):
                raise AssertionError(f"{kname} {M}x{K}x{N}: every output is zero")
            del want
            if bits != sc_p.bits and (K, N) != rep:
                continue
            iters = 3 if bits != sc_p.bits or M * 2 * K * N > 2e9 else 10
            b_ms, b_by = _sc_analog_bound(kname, M, K, N, bits)
            row = {"name": kname if bits == sc_p.bits else f"{kname}@{bits}",
                   "shape": [M, K, N], "max_abs_err": 0.0, "ms": cuda_ms(run, iters),
                   "device_ms": device_ms(run, iters, "repro_sc::"),
                   "plain_ms": cuda_ms(plain, 1), "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": None, "alu_bound_ms": _sc_alu_ms(kname, M, K, N, bits)}
            print(f"[kernels] {json.dumps(row)}", flush=True)
            rows[bits] = row
        return rows[sc_p.bits]

    def _draws_row(K, N, path, bits):
        """The draws kernel against its plain version on the card and on
        the CPU (bitwise) for one K5 site's key path, timed.  Bound: the
        draws written once; one threefry block per element, and per launch
        one per folded path word and two for the split, at the integer
        instruction rate."""
        from repro_torch.kernels import prng

        run = lambda: ops.sc_draws(path, 2 * K, bits, dev)
        plain = lambda: prng.sc_draws_ref(path, 2 * K, bits, dev)
        got, want, cpu = run(), plain(), prng.sc_draws_ref(path, 2 * K, bits)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, cpu):
            if not (torch.equal(a.view(torch.int32), b.view(torch.int32))
                    and torch.equal(a.cpu().view(torch.int32), c.view(torch.int32))):
                raise AssertionError(f"sc_draws {path} K={K}: not bitwise equal to its plain "
                                     f"version (card and CPU)")
        n = (2 * K + 1) * bits
        b_ms, b_by = bound(4 * n, (n + len(path) + 1) * THREEFRY_OPS, INT_OPS_S)
        row = {"name": "sc_draws", "shape": [2 * K, bits], "max_abs_err": 0.0,
               "ms": cuda_ms(run, 10), "device_ms": device_ms(run, 10, "repro_prng::"),
               "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        print(f"[kernels] {json.dumps(row)}", flush=True)
        return row

    sc_p, an_p = SCParams(), AnalogParams()
    adc = (an_p.array_size, an_p.adc_bits, an_p.adc_range)
    rep = (cfg.d_model, cfg.d_ff)
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    summary = {}
    for K, N in _site_shapes(cfg):
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
        row = _prefill_rows(K, N, w)
        if (K, N) == rep:
            summary["sc_matmul_packed[quantized]"] = row
        for kname, M in (("sc_matmul_packed", PREFILL_M), ("sc_matmul_packed_fused", DECODE_M),
                         ("analog_matmul", PREFILL_M), ("analog_matmul_fused", DECODE_M)):
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            fused = kname.endswith("fused")
            if kname.startswith("sc"):
                xp, xn, wp, wn, pre = _stream_planes(x, w, sc_p)
                ux, uw = ops.sc_draws((1, K, N, M), 2 * K, sc_p.bits, dev)
                if fused:  # the decode path: tables built once per step
                    draws = SCDraws(ux, uw)
                    draws.tables  # built now, as once per decode step
                    args = (sc_p.bits, draws)
                    kern, plain = sc_matmul_fused_cuda, sc_matmul_fused_ref
                else:  # a plain pair: the tables built in the call
                    args = (sc_p.bits, (ux, uw))
                    kern = sc_matmul_cuda
                    plain = lambda x_, w_, n_bits, d: ref.sc_matmul_ref(x_, w_, n_bits, *d)
            else:
                xp, xn, wp, wn, pre = _array_planes(x, w, an_p)
                args = adc
                kern, plain = ((analog_matmul_fused_cuda, analog_matmul_fused_ref) if fused
                               else (analog_matmul_cuda, ref.analog_matmul_ref))
            xcat = torch.cat([xp, xn], dim=-1).contiguous()
            halves = (wp, wn)
            epis = [None]
            if fused:
                epis = [{}, {
                    "colgain": (1 + 0.05 * torch.randn(N, generator=g, device=dev)).to(bf),
                    "coladd": (0.02 * torch.randn(N, generator=g, device=dev)).to(bf),
                    "mean_coeffs": torch.tensor([0.01, -0.02, 0.003, -0.0004], device=dev),
                    "mean_scale": torch.tensor(1.7, device=dev),
                }]

            def call(f, e):
                if not fused:
                    return f(xcat, halves, *args)
                return f(xcat, halves, *args, pre, e, bf)

            err = 0.0
            for epi in epis:
                got, want = call(kern, epi), call(plain, epi)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    diff = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(
                        f"{kname} {M}x{K}x{N} epi={sorted(epi or {})}: not bitwise equal to "
                        f"its plain version (max |diff| {diff})")
                if kname == "analog_matmul" and not bool(want.abs().max() > 0):
                    raise AssertionError(f"{kname} {M}x{K}x{N}: every output is zero")
            if kname == "sc_matmul_packed" and (K, N) == (cfg.d_model, cfg.d_model):
                # the packed-words entry on the reference kernel's interface
                xbits = ref.sc_pack_streams(xcat, ux)
                wbits = ref.sc_pack_streams(torch.cat(halves), uw[:, None, :])
                words = sc_matmul_words_cuda(xbits, wbits, sc_p.bits)
                want = ref.sc_matmul_packed_chunked_ref(xbits, wbits) / sc_p.bits
                if not (torch.equal(words, want) and torch.equal(words, got)):
                    raise AssertionError("sc_matmul_packed on pre-packed words disagrees")
            if fused and kname.startswith("sc"):
                row = _tables_row(K, N, ux, uw, sc_p.bits)
                drow = _draws_row(K, N, (1, K, N, M), sc_p.bits)
                if (K, N) == rep:
                    summary["sc_tables"], summary["sc_draws"] = row, drow
            iters = 3 if M * 2 * K * N > 2e9 else 10
            ms = cuda_ms(lambda: call(kern, {}), iters)
            dev_ms = device_ms(lambda: call(kern, {}), iters,
                               "repro_sc::" if kname.startswith("sc") else "repro_analog::")
            plain_ms = cuda_ms(lambda: call(plain, {}), 1)
            b_ms, b_by = _sc_analog_bound(kname, M, K, N, sc_p.bits)
            row = {"name": kname, "shape": [M, K, N], "max_abs_err": err, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}
            if kname.startswith("analog"):  # both terms of the bound
                nbytes, n_ops = _analog_work(kname, M, K, N)
                row["bound_terms_ms"] = {"bytes": nbytes / HBM_BYTES_S * 1e3,
                                         "operations": n_ops / F64_TENSOR_OPS_S * 1e3}
            else:
                row["alu_bound_ms"] = _sc_alu_ms(kname, M, K, N, sc_p.bits)
            print(f"[kernels] {json.dumps(row)}", flush=True)
            if (K, N) == rep:
                summary[kname] = row
            if (K, N) == rep and kname.startswith("sc"):
                # the same kernel on 512-bit streams (16 words a stream):
                # a check printed as a row of its own, off the serving path
                # (so not in the kernels line, which counts its launches)
                long = SC_LONG_BITS
                ldraws = SCDraws(*ops.sc_draws((2, K, N, M), 2 * K, long, dev))
                largs = (long, ldraws) if fused else (long, tuple(ldraws))
                lcall = lambda f, e: (f(xcat, halves, *largs, pre, e, bf) if fused
                                      else f(xcat, halves, *largs))
                got, want = lcall(kern, {}), lcall(plain, {})
                _hold(f"{kname}@{long}", (M, K, N), got, want)
                b_ms, b_by = _sc_analog_bound(kname, M, K, N, long)
                row = {"name": f"{kname}@{long}", "shape": [M, K, N], "max_abs_err": 0.0,
                       "ms": cuda_ms(lambda: lcall(kern, {}), 3),
                       "device_ms": device_ms(lambda: lcall(kern, {}), 3, "repro_sc::"),
                       "plain_ms": cuda_ms(lambda: lcall(plain, {}), 1), "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": None,
                       "alu_bound_ms": _sc_alu_ms(kname, M, K, N, long)}
                print(f"[kernels] {json.dumps(row)}", flush=True)
                del ldraws, got, want
            del x, xp, xn, wp, wn, xcat, halves
            torch.cuda.empty_cache()
        del w
    return summary


BACKENDS = ("exact", "log_mult", "approx_mult", "sc", "analog")


def _record_projections(names):
    """Wrap the registry specs of ``names`` so every emulated projection is
    kept as (name, fused, x, w, params, rng, epi, y); returns the list and
    a function that restores the specs."""
    from repro_torch.core import registry

    seen, specs = [], {n: registry.get(n) for n in names}
    for name, spec in specs.items():
        def emulate(x, w, p, rng, _n=name, _s=spec):
            y = _s.emulate(x, w, p, rng)
            seen.append((_n, False, x, w, p, rng, None, y))
            return y

        def fused_emulate(x, w, p, rng, epi, _n=name, _s=spec):
            y = _s.fused_emulate(x, w, p, rng, epi)
            seen.append((_n, True, x, w, p, rng, epi, y))
            return y

        registry.register(dataclasses.replace(spec, emulate=emulate, fused_emulate=fused_emulate),
                          override=True)

    def restore():
        for spec in specs.values():
            registry.register(spec, override=True)

    return seen, restore


def phase_reference(dev):
    """The smoke config served on the card and on the CPU, each device
    with its own weights (``init``) and its own SC draws (the kernel on the
    card, the plain threefry on the CPU).  The weights: equal, tensor by
    tensor.  Exact and multiplier-error requests: greedy tokens equal,
    logits within 1e-3 (float32; cuBLAS and the CPU sum in other orders,
    and the card runs the kernels).  SC and analog: each projection the
    card ran equals the plain version's on the CPU from the same operands
    and key path (the CPU drawing its own), bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import registry
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg = get_smoke_config("qwen2.5-3b")
    model = build_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_dev = model.init(0, device=dev)
    cpu_named = dict(p_cpu.named_parameters())
    for name, t in p_dev.named_parameters():
        if t.device.type != "cuda" or not torch.equal(t.cpu(), cpu_named[name]):
            raise AssertionError(f"init(0) on the card != on the CPU at {name}")
    print(f"[reference] init(0) on the card == CPU: {len(cpu_named)} tensors bitwise",
          flush=True)
    queue = synthetic_requests(10, cfg.vocab_size, seed=0, prompt_lens=(3, 20),
                               gen_lens=(4, 10), backends=BACKENDS)
    res, seen = {}, []
    for name, params, device in (("cpu", p_cpu, "cpu"), ("cuda", p_dev, dev)):
        eng = Engine(model, params, n_slots=2, max_seq=32, fused=True, collect_logits=True,
                     device=device)
        if name == "cuda":
            seen, restore = _record_projections(EMULATED)
        try:
            res[name] = eng.run(queue)
        finally:
            if name == "cuda":
                restore()
    worst, agree, total = 0.0, 0, 0
    for rid, want in res["cpu"].items():
        got = res["cuda"][rid]
        if len(got["tokens"]) != len(want["tokens"]):
            raise AssertionError(f"smoke request {rid}: {len(got['tokens'])} tokens")
        if got["backend"] in ("sc", "analog"):
            agree += sum(a == b for a, b in zip(got["tokens"], want["tokens"]))
            total += len(want["tokens"])
            continue
        if got["tokens"] != want["tokens"]:
            raise AssertionError(f"smoke request {rid}: tokens {got['tokens']} != {want['tokens']}")
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)
            worst = max(worst, float(np.abs(a - b).max()))
    kinds = {(n, f) for n, f, *_ in seen}
    if kinds != {(n, f) for n in EMULATED for f in (False, True)}:
        raise AssertionError(f"smoke run projections: {sorted(kinds)}")
    for name, fused, x, w, p, rng, epi, y in seen:
        spec = registry.get(name)
        xc, wc = x.cpu(), w.cpu()
        want = spec.fused_emulate(xc, wc, p, rng, epi) if fused else spec.emulate(xc, wc, p, rng)
        if not torch.equal(y.cpu(), want):
            diff = (y.cpu().float() - want.float()).abs().max().item()
            raise AssertionError(f"smoke {name} projection {tuple(x.shape)}x{tuple(w.shape)} "
                                 f"fused={fused}: card != CPU (max |diff| {diff})")
    print(f"[reference] smoke engine on card == CPU: {len(res['cpu'])} requests; exact and "
          f"multiplier-error tokens equal, max |logit diff| {worst}; {len(seen)} emulated "
          f"projections ({', '.join(EMULATED)}) bitwise equal; SC/analog tokens equal end "
          f"to end: {agree}/{total}",
          flush=True)


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
    queue = synthetic_requests(10, cfg.vocab_size, seed=0, prompt_lens=(16, 64),
                               gen_lens=(16, 32), backends=BACKENDS)
    eng = Engine(model, params, n_slots=DECODE_M, max_seq=MAX_SEQ, fused=True,
                 collect_logits=True, device=dev, seed=0)
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
    missing = [k for k in PATH_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    metrics = dict(eng.metrics(), wall_s=wall, card=card)
    print(f"[engine] metrics {json.dumps(metrics)}", flush=True)
    print(f"[engine] launches {json.dumps(launches)}", flush=True)
    # the same queue again on the warm engine: every call in steady state,
    # so each lane's prefill and decode rates are measured
    eng.reset_metrics()
    again = [dataclasses.replace(r, rid=r.rid + len(queue)) for r in queue]
    t0 = time.perf_counter()
    eng.run(again)
    torch.cuda.synchronize()
    metrics = dict(eng.metrics(), wall_s=time.perf_counter() - t0, card=card)
    print(f"[engine] steady-state metrics {json.dumps(metrics)}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

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
    summary.update(phase_sc_analog(dev, cfg))
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = phase_engine(dev, cfg, card)
    torch.cuda.synchronize()

    kernels = []
    for name in PATH_KERNELS:
        row = summary[name]
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name],
            "shape": row["shape"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{k: row[k] for k in ("bound_terms_ms", "alu_bound_ms") if k in row},
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
