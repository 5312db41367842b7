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
5. Train (the training slice's path, on the engine phase's weights):
   the quickstart's pipeline at qwen2.5-3b full width, analog (arrays of
   16, a 4-bit ADC): a calibration step, INJECT steps, MODEL steps and a
   hardware eval, batch 4 x 64 tokens, each step's loss, wall ms, device
   ms (a profiler trace) and launches, and the peak memory.  K6 must
   launch in the calibration, MODEL and eval steps and not in an INJECT
   step, whose forward is a plain matmul and whose error draws are the
   normal entry of ``prng.cu`` (held bitwise against its plain version on
   the card at the INJECT shapes).  Then one MODEL step on each of sc,
   approx_mult and log_mult at full width with 2 layers (K4, K1 and K1
   must launch, the grads be finite), and the smoke config's
   calibrate, INJECT and MODEL steps on analog and SC on the card against
   the CPU: the INJECT step's loss and weights within the CPU tests'
   tolerances, the emulated steps' losses within their 1e-3 (but analog's
   calibration, where an ADC level at a decision boundary may flip end to
   end, ROADMAP section C: printed), every emulated projection of the
   calibration and MODEL steps bitwise the plain version's on the same
   operands.  These phases run with ``remat="none"``, as before the
   default became ``"block"``, so their figures stay comparable.
6. The phase-plan Trainer (``repro_torch.runtime.trainer``) on the engine
   phase's weights, the old states freed first: qwen2.5-3b at full width
   with its first 4 layers (the run saves two checkpoint generations here
   and two in phase 12, and the card's host takes at most 45 GiB of disk
   writes a run; a generation of the 36-layer state is 47.6 GB, of 4
   layers 13.0 GB; the phase checks the disk first and fails if two do
   not fit), analog (arrays of 16, a 4-bit ADC), batch 4 x 64 tokens,
   ``paper_schedule(10)`` (exact 1, INJECT 7 with adaptive calibration,
   MODEL 2), ``remat="block"``, a checkpoint every 5 steps keeping one,
   and a fault injected once at step 7.  One ``[trainer]`` line a step
   (phase, mode, loss, wall ms, whether a calibration ran, launches),
   each save's and the restore's bytes and seconds, then a summary: peak
   memory of the run and of one MODEL step under ``"block"`` and under
   ``"none"`` (beside phase 5's 36-layer peak under ``"none"``), and K6's
   launches in each.  It asserts one restart; the restore from step 5;
   the replayed steps 5 and 6 with their first losses and calibration
   decisions, bitwise; every loss finite; steps by mode the plan's (and
   the replays'); K6 in every MODEL, calibration and eval step and none in
   an INJECT step, which launches the normal entry.  It removes its
   checkpoint directory (under the gitignored ``build/``) at the end.

7. Serve over a chip fleet at full width on the engine phase's weights,
   their first 6 of 36 layers (fused decode): ``Fleet(2)``, a ``DriftModel`` strong enough that each
   chip's probe loss moves within the run, recalibration every 3 engine
   steps at most, the engine's default probe (2 x 32 random tokens), 2
   slots a lane and 15 requests over the five backends, so every emulated
   backend serves on both chips.  Every chip-bound lane must bind its chip
   (a recalibration), drift, and recalibrate again; every kernel of the
   path must launch.  One decode step of each chip-bound lane after such
   a recalibration is recorded, and each of its fused projections (the
   chip's real column gains, offset or stuck-at columns and the lane's
   fitted mean-error correction in K2's, K5's or K7's epilogue) is held
   bitwise against its plain fused version on the card and against the
   composed path (the emulator's kernel, then the chip, then the
   correction).  Counts the served logit rows that are not finite, per
   lane, and fails if a lane other than SC's serves one (SC's corrected
   lanes overflow at full width, ROADMAP section C).  Prints
   ``fleet_report()``, those counts, the launches, the wall time of
   each bind and recalibration, and, per backend, the device ms (profiler
   traces), the host's waits for the card (torch's sync debug mode) and
   the wall ms (median of 7, the two in turns) of a chip-bound decode
   step beside a nominal one.
8. The static-batch baseline (``run_static_baseline``, waves of 4
   padded prompts fed token by token) against the engine (warm, fused) on
   one queue of 6 exact requests at full width, 6 of 36 layers: tok/s of
   each.
9. A variation-aware Trainer phase at full width with its first 4 layers
   (as phase 6): analog, INJECT 2 steps calibrating every step, then
   ``Phase(MODEL, fleet=2)`` for 3 steps, ``remat="none"``, no checkpoint
   written.  It asserts 3 fleet steps, the chips 0, 1, 0 of the fleet
   (round robin by step), K6 in every MODEL step, finite losses; prints
   each step's wall ms and launches.

10. The search of the search-and-deploy loop at full width and depth, on
   the engine phase's weights after phase 8 (``repro_torch.launch.search``
   and ``repro_torch.search``): 2 exact base steps (the weights trained in
   place), then ``profile_sensitivity`` and ``search`` under
   ``dispatch="switch"`` over analog (arrays of 64, the CLI's
   ``min(64, d_model)``), log_mult and approx_mult, batch 8 x 32 tokens, 2
   mutations, the winner under half the exact energy.  Prints each
   profile entry, the pool, the front, the winner's spec and energy
   fraction, ``compile_stats`` (``built`` must be at most 2), the device
   ms and launches of one blend probe and one hw eval (profiler traces),
   and the peak memory; then re-scores every front map with static
   dispatch, each loss bitwise its switch loss.  Cut: the base steps (2,
   the CLI's default 60) and mutations (2, of 12), for time; no depth.
11. Merged serving lanes (``Engine(switch=True)``) at full width with the
   first 12 of 36 layers, fused decode, 4 slots: uniform approx_mult,
   log_mult, SC and analog requests, the search's winner map, a
   heterogeneous map (``attn_*=approx_mult``, ``mlp_*=log_mult``) and an
   exact request.  Asserts one merged lane for
   every emulated request (the exact one in its own); K1-K7 (and the SC
   tables and draws) launched; every fused projection of the first merged
   decode step (rows on all four backends) bitwise its plain fused
   version on the card; ``demote_sites(["mlp_*"])``, once every request
   is admitted, turns those sites exact on every slot and nothing is
   called for the first time after it; a solo request through the merged
   lane bitwise its static lane on two fresh engines (every backend with
   1 slot; approx_mult and log_mult also with 4: SC and analog take
   per-tensor scales over every row, and a merged lane's idle rows run
   exact).  Prints the steady-state rates (the queue served twice), and
   the device ms, host waits and wall of a merged decode step (rows on
   all four backends; on approx_mult and log_mult only, which must wait
   for the host 0 times) beside the static lanes' steps.

12. The approximate backward and the compressed optimizer state at full
   width, on the engine phase's weights (``[bwd]`` lines).  (b) The
   sensitivity gate (``search.sensitivity.backward_gate``, analog probes,
   4 x 64 tokens, 3 of 4 sites opened), derived twice through one step
   cache: the wall seconds, the mask, one step built.  (a) Train steps
   with the gate as an argument (``make_train_step(bwd_aware=True)``,
   bf16 optimizer state, learning rate 0 so every step starts from the
   same weights) at 4 layers (the first 4 of the weights; 36 until phase
   13, the MoE family, took their time, as for the norms and AdamW
   below): MODEL on approx_mult (K1) and on analog
   (arrays of 16, K6), INJECT on analog, each under the gate closed, open
   and the sensitivity gate: the loss bitwise across the gates, the
   gradient norm finite and moved by the open gate, wall and device ms,
   launches, device ms by kernel group, host waits (an open gate adds
   none) and peak memory.  (d) The Trainer with ``optim_compress="sm3"``
   at 4 layers: exact 2 steps, INJECT 3 with calibration every 2 and
   ``backward="approx"``, MODEL 3 with ``backward="auto"`` refreshing
   every 2, a checkpoint every 4 steps and a fault at step 6: one
   restart, the restore from step 4, steps 4 and 5 replayed bitwise, the
   gate's refreshes and events the reference's rule, one rounding launch
   per parameter a step.  (c) One AdamW update under each of ``none``,
   ``bf16`` and ``sm3`` at 4 layers on one exact backward's gradients:
   ``state_bytes``, wall and device ms of the update, peak memory, and
   a middle layer's attn_q first moment held bitwise against the plain
   rounding on the CPU from the same float32 EMA.  The rounding entry of
   ``prng.cu`` is held bitwise against its plain version in phase 2.

13. The MoE family (``[moe]`` lines), run after phase 3, before the
   qwen2.5-3b weights are made.  In phase 2 (``[kernels] moe`` rows), K1
   (both multipliers), K4 (32 and 512-bit streams) and K6 are held
   bitwise at dbrx-132b's expert projections ([M, 6144] x [6144, 10752],
   [M, 10752] x [10752, 6144], M 8 and 20: a decode step's and a 64-token
   prefill's expert capacity), K2, K5 and K7 at its attention
   projections and LM head (4 rows, with and without a chip's epilogue),
   K3 at 48 / 8 heads of 128.  Then (a) phase 3's holds on dbrx-132b's
   smoke config; (b) dbrx-132b at full width with its first 2 of 40
   layers (7.75 G parameters; the 40 layers do not fit one card) through
   phase 4's engine run (init's wall time, 10 requests, 4 slots, the five
   backends, fused decode, every kernel launched, the queue again warm),
   then one decode step of each lane: wall and device ms, ms by kernel
   group, host waits (0 in ``moe_ffn``'s routing, dispatch and combine),
   every expert projection bitwise its plain version on the card; (c) one
   MODEL forward and backward of ``apply_model`` on approx_mult at 4 x 64
   tokens, no optimizer state: loss, aux loss, the router's and expert
   stacks' gradients finite, peak memory.

14. The SSM and HYBRID families (``[ssm]`` lines), run after phase 13.  In
   phase 2 (``[kernels] ssm`` rows), K1 and K2 (both multipliers), K4,
   K5, K6 and K7 are held bitwise at every projection of mamba2-130m and
   zamba2-1.2b (64 rows prefill, 4 decode; the fan-ins 768, 1536, 4096
   and the widths 3352, 8384, 50280); the tied head through the [N, K]
   entries of K1, K2 and K4 (``embed.T`` read in place), each also
   bitwise the call on the contiguous weight; K3 within 1e-4 at zamba's 32
   / 32 heads.  Then (b) phase 3's holds on both smoke configs; (c)
   mamba2-130m, then zamba2-1.2b, at full width and full depth through
   phase 4's engine run (init's wall time, 10 requests, 4 slots, the five
   backends, fused decode; every kernel of the path launched, K3 on zamba
   only and the [N, K] entries on mamba only; a non-finite logit row fails
   any lane but SC's), then one fused decode step of each lane: device ms,
   ms by kernel group, wall ms (median of 3), host waits, launches; the
   peak memory.  ``python3 chip_smoke.py --only ssm`` builds and runs this
   phase alone (a probe).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
(launches per phase, ``search_launches``, ``switch_launches``,
``bwd_launches``, ``moe_launches`` and ``ssm_launches`` included; the
[N, K] entries have rows of their own), and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings
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
# the Gaussian noise of INJECT mode: the reference's jax.random.normal in
# calibration.sample_error (not a Pallas kernel); on the training path only
TRAIN_KERNELS = {"normal_draws": ("prng.cu", "../core/calibration.py:118"),
                 # AdamW's stochastically rounded bf16 first moment: the
                 # reference's jax.random.randint and bit ops (not a Pallas
                 # kernel); on the training path only
                 "sr_bf16": ("prng.cu", "../optim/adamw.py:86")}
# the kernels the serving path launches (the integer-operand entries of K1
# and K2, K4's one-polarity entry on given planes and its packed-words
# entry are checks off the path)
PATH_KERNELS = tuple(KERNEL_SOURCES)
# the entries of K1, K2 and K4 that read the weight as [N, K] row-major: a
# tied LM head (mamba2-130m's) reads the embedding in place
TIED_KERNELS = {
    "elementwise_matmul[approx_mult,quantized,nk]": ("vpu_matmul.cu", "vpu_matmul.py:79"),
    "elementwise_matmul[log_mult,quantized,nk]": ("vpu_matmul.cu", "vpu_matmul.py:79"),
    "elementwise_matmul_fused[approx_mult,nk]": ("vpu_matmul.cu", "vpu_matmul.py:228"),
    "elementwise_matmul_fused[log_mult,nk]": ("vpu_matmul.cu", "vpu_matmul.py:228"),
    "sc_matmul_packed[quantized,nk]": ("sc_matmul.cu", "sc_matmul.py:89"),
}
TRAIN_B, TRAIN_T = 4, 64  # a training batch at full width: rows x tokens
# the CPU tests' tolerances (tests/test_torch_train_step.py and
# test_torch_train_pipeline.py, which import jax and so do not run here):
# a train step's loss and weights, the share of a tensor's weights that
# AdamW's sign-like first steps may move apart when their gradient is at
# the rounding level, and the loss of an emulated (SC, analog MODEL) step
STEP_RTOL, STEP_ATOL, ADAM_FLIP, LOSS_RTOL = 1e-4, 1e-5, 1e-3, 1e-3
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


# phase_kernels_moe's shapes: dbrx-132b's expert projections at a decode
# step's capacity (4 slots: max(8, int(4 * 4 * 1.25 / 16)) = 8 rows) and at
# a 64-token prefill's (int(64 * 4 * 1.25 / 16) = 20 rows)
MOE_EXPERT_M = (8, 20)


def phase_kernels_moe(dev, mcfg):
    """K1-K7 against their plain versions at dbrx-132b's shapes, the fan-ins
    6144 and 10752 new to every kernel: K1 (both multipliers), K4 (32 and
    512-bit streams) and K6 at the expert projections [M, 6144] x [6144,
    10752] and [M, 10752] x [10752, 6144], M 8 and 20; K2, K5 and K7 at the
    attention projections and the LM head, 4 rows; bitwise (the fused ones
    also with a chip's epilogue).  K3 at 48 query and 8 KV heads of 128,
    within 1e-4.  One ``[kernels] moe`` row each, timed at its first
    shape."""
    from repro_torch.configs.base import AnalogParams, SCParams
    from repro_torch.core.backends import _array_planes, _stream_planes
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.analog_matmul import (
        analog_matmul_cuda,
        analog_matmul_fused_cuda,
        analog_matmul_fused_ref,
    )
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.sc_matmul import (
        SCDraws,
        sc_matmul_fused_cuda,
        sc_matmul_fused_ref,
        sc_matmul_quantized_cuda,
        sc_matmul_quantized_ref,
    )
    from repro_torch.kernels.vpu_matmul import (
        int_operand_matmul_fused_cuda,
        int_operand_matmul_fused_ref,
        plain_multiplier,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    D, F_, V = mcfg.d_model, mcfg.d_ff, mcfg.vocab_size
    H, KVd = mcfg.n_heads * mcfg.d_head, mcfg.n_kv_heads * mcfg.d_head
    experts, attn = ((D, F_), (F_, D)), ((D, H), (D, KVd), (D, V))
    sc_p, an_p = SCParams(), AnalogParams()
    adc = (an_p.array_size, an_p.adc_bits, an_p.adc_range)
    mults = {"approx_mult": (4, 7), "log_mult": (0, 8)}  # (dropped bits, operand bits)
    timed, held = set(), []

    def row(name, shape, run, plain, b_ms, b_by, tol=0.0):
        t_plain = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        t_plain = (time.perf_counter() - t_plain) * 1e3
        got = run()
        torch.cuda.synchronize()
        if tol:
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {shape}: max |diff| {err} > {tol}")
        else:
            _hold(name, shape, got, want)
            err = 0.0
        held.append(name)
        if name in timed:
            return
        timed.add(name)
        r = {"name": name, "shape": list(shape), "max_abs_err": err, "ms": cuda_ms(run, 3),
             "plain_ms": t_plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(f"[kernels] moe {json.dumps(r)}", flush=True)

    for K, N in experts:
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
        for M in MOE_EXPERT_M:
            x = torch.randn((M, K), generator=g, device=dev).to(bf)
            nbytes = 2 * (M * K + K * N) + 2 * M * N
            for mul, (drop, bits) in mults.items():
                mulf = plain_multiplier(mul, drop)
                if mul == "approx_mult":
                    b = bound(nbytes, 2.0 * M * 16 * K * N, INT8_TENSOR_OPS_S)
                else:
                    b = product_bound(nbytes, mul, M, K, N)
                row(f"elementwise_matmul[{mul},quantized]", (M, K, N),
                    lambda: int_operand_matmul_fused_cuda(x, w, bits, mul, {}, bf, drop),
                    lambda: int_operand_matmul_fused_ref(x, w, bits, mulf, {}, bf), *b)
            for bits in (sc_p.bits, SC_LONG_BITS):
                ux, uw = ops.sc_draws((4, K, N, M), 2 * K, bits, dev)
                name = "sc_matmul_packed[quantized]"
                row(name if bits == sc_p.bits else f"{name}@{bits}", (M, K, N),
                    lambda: sc_matmul_quantized_cuda(x, w, sc_p.gain, bits, SCDraws(ux, uw)),
                    lambda: sc_matmul_quantized_ref(x, w, sc_p.gain, bits, (ux, uw)),
                    *_sc_analog_bound(name, M, K, N, bits))
            xp, xn, wp, wn, _ = _array_planes(x, w, an_p)
            xcat = torch.cat([xp, xn], dim=-1).contiguous()
            row("analog_matmul", (M, K, N), lambda: analog_matmul_cuda(xcat, (wp, wn), *adc),
                lambda: ref.analog_matmul_ref(xcat, (wp, wn), *adc),
                *_sc_analog_bound("analog_matmul", M, K, N, sc_p.bits))
            del x, xp, xn, wp, wn, xcat
        del w
        torch.cuda.empty_cache()

    M = DECODE_M
    for K, N in attn:
        w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
        x = torch.randn((M, K), generator=g, device=dev).to(bf)
        for epi in ({}, _chip_epilogue(g, dev, N, bf)):
            for mul, (drop, bits) in mults.items():
                mulf = plain_multiplier(mul, drop)
                row(f"elementwise_matmul_fused[{mul}]", (M, K, N),
                    lambda: int_operand_matmul_fused_cuda(x, w, bits, mul, epi, bf, drop),
                    lambda: int_operand_matmul_fused_ref(x, w, bits, mulf, epi, bf),
                    *product_bound(2 * (M * K + K * N) + 2 * M * N, mul, M, K, N))
            xp, xn, wp, wn, pre = _stream_planes(x, w, sc_p)
            xcat = torch.cat([xp, xn], dim=-1).contiguous()
            draws = SCDraws(*ops.sc_draws((5, K, N, M), 2 * K, sc_p.bits, dev))
            row("sc_matmul_packed_fused", (M, K, N),
                lambda: sc_matmul_fused_cuda(xcat, (wp, wn), sc_p.bits, draws, pre, epi, bf),
                lambda: sc_matmul_fused_ref(xcat, (wp, wn), sc_p.bits, tuple(draws), pre, epi,
                                            bf),
                *_sc_analog_bound("sc_matmul_packed_fused", M, K, N, sc_p.bits))
            xp, xn, wp, wn, pre = _array_planes(x, w, an_p)
            xcat = torch.cat([xp, xn], dim=-1).contiguous()
            row("analog_matmul_fused", (M, K, N),
                lambda: analog_matmul_fused_cuda(xcat, (wp, wn), *adc, pre, epi, bf),
                lambda: analog_matmul_fused_ref(xcat, (wp, wn), *adc, pre, epi, bf),
                *_sc_analog_bound("analog_matmul_fused", M, K, N, sc_p.bits))
        del w, x, xp, xn, wp, wn, xcat, draws
        torch.cuda.empty_cache()

    KV, G, dh = mcfg.n_kv_heads, mcfg.n_heads // mcfg.n_kv_heads, mcfg.d_head
    q = torch.randn((M, KV, G, dh), generator=g, device=dev).to(bf)
    ck = torch.randn((M, MAX_SEQ, KV, dh), generator=g, device=dev).to(bf)
    cv = torch.randn((M, MAX_SEQ, KV, dh), generator=g, device=dev).to(bf)
    pos = torch.randint(16, MAX_SEQ, (M,), generator=g, device=dev).to(torch.int32)
    keys = int((pos.long() + 1).sum())
    row("flash_decode", (M, MAX_SEQ, KV, G, dh), lambda: flash_decode(q, ck, cv, pos),
        lambda: flash_decode_ref(q, ck, cv, pos),
        *bound(2 * q.numel() + 4 * keys * KV * dh + 4 * M + 4 * q.numel(),
               4.0 * keys * KV * G * dh), tol=1e-4)
    print(f"[kernels] moe held at {mcfg.name}'s shapes: {len(held)} calls of "
          f"{sorted(set(held))}", flush=True)


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


def _record_projections(names, keep=None):
    """Wrap the registry specs of ``names`` so every emulated projection is
    kept as (name, fused, x, w, params, rng, epi, y), the operands copied
    (a train step updates its weights in place); returns the list and a
    function that restores the specs.  With ``keep`` (a callable), only the
    projections it accepts are kept, their operands by reference (serving
    changes no weight)."""
    from repro_torch.core import registry

    seen, specs = [], {n: registry.get(n) for n in names}
    own = (lambda t: t.detach().clone()) if keep is None else (lambda t: t)
    kept = keep if keep is not None else (lambda fused: True)
    for name, spec in specs.items():
        def emulate(x, w, p, rng, _n=name, _s=spec):
            y = _s.emulate(x, w, p, rng)
            if kept(False):
                seen.append((_n, False, own(x), own(w), p, rng, None, y))
            return y

        def fused_emulate(x, w, p, rng, epi, _n=name, _s=spec):
            y = _s.fused_emulate(x, w, p, rng, epi)
            if kept(True):
                seen.append((_n, True, own(x), own(w), p, rng, epi, y))
            return y

        registry.register(dataclasses.replace(spec, emulate=emulate, fused_emulate=fused_emulate),
                          override=True)

    def restore():
        for spec in specs.values():
            registry.register(spec, override=True)

    return seen, restore


def _level_flips(cpu_seen, card_seen):
    """The multiplier-error backends' quantisation levels that the card's
    run and the CPU's give one projection apart, by backend: the two runs
    call their projections in one order, and an operand that their exact
    parts (cuBLAS or the CPU, K3 or the plain attention) leave an ulp apart
    can sit on a level boundary of the 7 or 8-bit grid."""
    from repro_torch.kernels.vpu_matmul import int_operand_quantize

    if [(n, f, tuple(x.shape)) for n, f, x, *_ in cpu_seen] != [
            (n, f, tuple(x.shape)) for n, f, x, *_ in card_seen]:
        raise AssertionError("the card's and the CPU's runs called other projections")
    flips = {}
    for (name, _, xc, wc, p, *_), (_, _, xd, wd, *_) in zip(cpu_seen, card_seen):
        if name in ("approx_mult", "log_mult"):
            a = int_operand_quantize(xc.reshape(-1, xc.shape[-1]), wc, p.bits)[0]
            b = int_operand_quantize(xd.cpu().reshape(-1, xd.shape[-1]), wd.cpu(), p.bits)[0]
            flips[name] = flips.get(name, 0) + int((a != b).sum())
    return flips


def phase_reference(dev, arch="qwen2.5-3b", tag="reference", level_flips_ok=False,
                    token_flips_ok=False):
    """``arch``'s smoke config served on the card and on the CPU, each device
    with its own weights (``init``) and its own SC draws (the kernel on the
    card, the plain threefry on the CPU).  The weights: equal, tensor by
    tensor.  Every emulated projection the card ran equals the plain
    version's on the CPU from the same operands and key path (the CPU
    drawing its own), bit for bit.  Exact and multiplier-error requests:
    greedy tokens equal, logits within 1e-3 (float32; cuBLAS and the CPU
    sum in other orders, and the card runs the kernels).  With
    ``level_flips_ok`` (the MoE family's run) a multiplier-error request's
    logits may lie beyond it where its backend's quantisation levels moved
    between the two runs (:func:`_level_flips`, printed each run); with
    ``token_flips_ok`` (the SSM and HYBRID families' runs) its greedy tokens
    may differ too there, and are reported.  SC and analog tokens are
    reported: a stream bit or an ADC level flips the same way."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import registry
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, synthetic_requests

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_dev = model.init(0, device=dev)
    cpu_named = dict(p_cpu.named_parameters())
    for name, t in p_dev.named_parameters():
        if t.device.type != "cuda" or not torch.equal(t.cpu(), cpu_named[name]):
            raise AssertionError(f"init(0) on the card != on the CPU at {name}")
    print(f"[{tag}] {cfg.name} init(0) on the card == CPU: {len(cpu_named)} tensors bitwise",
          flush=True)
    queue = synthetic_requests(10, cfg.vocab_size, seed=0, prompt_lens=(3, 20),
                               gen_lens=(4, 10), backends=BACKENDS)
    res, seen = {}, {}
    for name, params, device in (("cpu", p_cpu, "cpu"), ("cuda", p_dev, dev)):
        eng = Engine(model, params, n_slots=2, max_seq=32, fused=True, collect_logits=True,
                     device=device)
        # the card's operands copied; the CPU's kept (serving changes no weight)
        seen[name], restore = _record_projections(
            EMULATED, keep=(lambda fused: True) if name == "cpu" else None)
        try:
            res[name] = eng.run(queue)
        finally:
            restore()
    kinds = {(n, f) for n, f, *_ in seen["cuda"]}
    if kinds != {(n, f) for n in EMULATED for f in (False, True)}:
        raise AssertionError(f"smoke run projections: {sorted(kinds)}")
    for name, fused, x, w, p, rng, epi, y in seen["cuda"]:
        spec = registry.get(name)
        xc, wc = x.cpu(), w.cpu()
        want = spec.fused_emulate(xc, wc, p, rng, epi) if fused else spec.emulate(xc, wc, p, rng)
        if not torch.equal(y.cpu(), want):
            diff = (y.cpu().float() - want.float()).abs().max().item()
            raise AssertionError(f"smoke {name} projection {tuple(x.shape)}x{tuple(w.shape)} "
                                 f"fused={fused}: card != CPU (max |diff| {diff})")
    flips = _level_flips(seen["cpu"], seen["cuda"])
    worst, agree, total, diffs, moved_tokens = {}, 0, 0, {}, []
    for rid, want in res["cpu"].items():
        got = res["cuda"][rid]
        if len(got["tokens"]) != len(want["tokens"]):
            raise AssertionError(f"smoke request {rid}: {len(got['tokens'])} tokens")
        diffs[rid] = (got["backend"], got["tokens"] == want["tokens"],
                      max(float(np.abs(a - b).max()) for a, b in zip(got["logits"],
                                                                    want["logits"])))
    print(f"[{tag}] (backend, tokens equal, max |logit diff|) by request {json.dumps(diffs)}; "
          f"quantisation levels moved between the runs: {json.dumps(flips)}", flush=True)
    for rid, want in res["cpu"].items():
        got, backend = res["cuda"][rid], res["cuda"][rid]["backend"]
        if backend in ("sc", "analog"):
            agree += sum(a == b for a, b in zip(got["tokens"], want["tokens"]))
            total += len(want["tokens"])
            continue
        if got["tokens"] != want["tokens"]:
            if not (token_flips_ok and flips.get(backend)):
                raise AssertionError(
                    f"smoke request {rid}: tokens {got['tokens']} != {want['tokens']}")
            moved_tokens.append(rid)
        worst[backend] = max(worst.get(backend, 0.0), diffs[rid][2])
        if diffs[rid][2] > 1e-3 and not (level_flips_ok and flips.get(backend)):
            for a, b in zip(got["logits"], want["logits"]):
                np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3,
                                           err_msg=f"smoke request {rid} ({backend})")
    n_seen = len(seen["cuda"])
    del seen
    print(f"[{tag}] smoke engine on card == CPU: {len(res['cpu'])} requests; exact and "
          f"multiplier-error tokens equal (but requests {moved_tokens}, where levels moved), "
          f"max |logit diff| by backend {json.dumps(worst)}; "
          f"{n_seen} emulated projections ({', '.join(EMULATED)}) bitwise equal; SC/analog "
          f"tokens equal end to end: {agree}/{total}",
          flush=True)


def phase_engine(dev, cfg, card: str, tag="engine", expect=PATH_KERNELS, nonfinite_ok=()):
    """10 requests at ``cfg``'s full width through the engine (4 slots,
    the five backends, fused decode), then the same queue again warm.
    Fails unless every kernel of ``expect`` launched, and on a non-finite
    logit row of a lane not in ``nonfinite_ok`` (whose rows are counted).
    Returns the first run's launches and the weights."""
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, synthetic_requests

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[{tag}] {cfg.name}: {n_params} params (bf16) on {dev}, {cfg.n_layers} layers, in "
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
    nonfinite = {}
    for req in queue:
        r = results[req.rid]
        if len(r["tokens"]) != req.max_new_tokens:
            raise AssertionError(f"request {req.rid}: {len(r['tokens'])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            raise AssertionError(f"request {req.rid}: token out of range")
        for row in r["logits"]:
            if row.shape != (cfg.vocab_size,):
                raise AssertionError(f"request {req.rid}: bad logits row {row.shape}")
            if not np.isfinite(row).all():
                if r["backend"] not in nonfinite_ok:
                    raise AssertionError(f"request {req.rid} ({r['backend']}): non-finite logits")
                nonfinite[r["backend"]] = nonfinite.get(r["backend"], 0) + 1
    missing = [k for k in expect if launches[k] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    metrics = dict(eng.metrics(), wall_s=wall, card=card, nonfinite_rows=nonfinite)
    print(f"[{tag}] metrics {json.dumps(metrics)}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    # the same queue again on the warm engine: every call in steady state,
    # so each lane's prefill and decode rates are measured
    eng.reset_metrics()
    again = [dataclasses.replace(r, rid=r.rid + len(queue)) for r in queue]
    t0 = time.perf_counter()
    eng.run(again)
    torch.cuda.synchronize()
    metrics = dict(eng.metrics(), wall_s=time.perf_counter() - t0, card=card)
    print(f"[{tag}] steady-state metrics {json.dumps(metrics)}", flush=True)
    return launches, params


# phase_moe: dbrx-132b at full width with its first 2 of 40 layers (7.75 G
# parameters, 15.5 GB in bf16; the 40 layers, 264 GB, do not fit one card)
MOE_LAYERS = 2


def _hold_expert_projections(seen, mcfg) -> int:
    """Every composed (expert) projection of a recorded decode step against
    the plain version on the card, bitwise; returns how many."""
    from repro_torch.core import registry

    n = 0
    for name, fused, x, w, p, rng, epi, y in seen:
        if fused:
            continue
        if tuple(w.shape) not in ((mcfg.d_model, mcfg.d_ff), (mcfg.d_ff, mcfg.d_model)):
            raise AssertionError(f"[moe] a composed {name} projection of shape {tuple(w.shape)} "
                                 f"in a fused decode step")
        with _plain_on_card():
            want = registry.get(name).emulate(x, w, p, rng)
        _hold(f"[moe] {name} expert projection", (tuple(x.shape), tuple(w.shape)), y, want)
        n += 1
    return n


def phase_moe(dev, card: str):
    """The MoE family on the card (``[moe]`` lines): (a) dbrx-132b's smoke
    config served on the card and the CPU (phase_reference's holds); (b)
    dbrx-132b at full width with its first 2 layers through the engine
    (phase_engine: init's wall time, 10 requests over the five backends,
    4 slots, fused decode, every kernel of the path launched, the queue
    again warm), then one decode step of each lane: wall and device ms, ms
    by kernel group, host waits (and none in ``moe_ffn``'s routing,
    dispatch and combine, run alone on the exact lane), and every expert
    projection of the step held bitwise against its plain version on the
    card; (c) one MODEL forward and backward of ``apply_model`` on
    approx_mult, 4 x 64 tokens, no optimizer state: the loss, the aux loss,
    the gradients of the router and of each expert stack finite, the peak
    memory.  Returns the engine run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainMode
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.data import SyntheticLM
    from repro_torch.models import decode as D
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import apply_model
    from repro_torch.training.losses import lm_loss

    t_phase = time.perf_counter()
    # an operand an ulp apart on a level boundary of a multiplier's grid
    # moves one request's logits by 7.3e-3 on this config (PERF.md section 6)
    phase_reference(dev, "dbrx-132b", "moe", level_flips_ok=True)
    mcfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_LAYERS)
    launches, params = phase_engine(dev, mcfg, card, tag="moe")
    t_ref = time.perf_counter()

    # one decode step of each lane, 4 slots at position 20
    cache = D.init_cache(mcfg, DECODE_M, MAX_SEQ, dev)
    tokens = torch.arange(DECODE_M, device=dev)[:, None] * 7
    pos = torch.full((DECODE_M,), 20, dtype=torch.int32, device=dev)
    x = torch.randn((DECODE_M, 1, mcfg.d_model), device=dev).to(torch.bfloat16)
    moe_waits = _syncs(lambda: M.moe_ffn(x, params.layers[0].moe, mcfg, None))
    if moe_waits:
        raise AssertionError(f"[moe] moe_ffn's routing, dispatch and combine wait for the host "
                             f"{moe_waits} times")
    for backend in BACKENDS:
        def step(_b=backend):
            ctx = (None if _b == "exact" else
                   ApproxCtx(cfg=_serving_approx(_b), fused=True, rng=(0, 1)))
            return D.serve_step(params, cache, tokens, pos, mcfg, ctx=ctx, flash=True)[0]

        dev_ms, by_group = _traced_ms(step)
        syncs = _syncs(step)
        walls = [cuda_ms(step, 1) for _ in range(3)]
        held = 0
        if backend != "exact":
            seen, restore = _record_projections(EMULATED, keep=lambda fused: True)
            try:
                logits = step()
            finally:
                restore()
            held = _hold_expert_projections(seen, mcfg)
            if held != 3 * mcfg.n_experts * mcfg.n_layers:
                raise AssertionError(f"[moe] {backend}: {held} expert projections in a step")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"[moe] {backend}: non-finite logits")
            del seen
        row = {"lane": backend, "slots": DECODE_M, "wall_ms": float(np.median(walls)),
               "wall_ms_all": walls, "device_ms": dev_ms, "by_group_ms": by_group,
               "host_waits": syncs, "moe_routing_host_waits": moe_waits,
               "expert_projections_held": held, "card": card}
        print(f"[moe] decode-step {json.dumps(row)}", flush=True)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    t_steps = time.perf_counter()

    # (c) a MODEL forward and backward at full width, no optimizer state
    data = SyntheticLM(mcfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B, seed=0)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev, torch.long)
             for k, v in data.batch_at(0).items()}
    wrt = {f"layers.{l}.moe.{n}": getattr(p.moe, n) for l, p in enumerate(params.layers)
           for n in ("router", "w_gate", "w_up", "w_down")}
    for t in wrt.values():
        t.requires_grad_(True)
    approx = _train_approx("approx_mult", TrainMode.MODEL)

    def fwd_bwd():
        out = apply_model(params, {"tokens": batch["tokens"]}, mcfg, approx=approx, rng=(1, 0),
                          remat="none")
        loss = lm_loss(out.logits, batch["labels"])
        grads = torch.autograd.grad(loss + 0.01 * out.aux_loss, list(wrt.values()))
        return loss.detach(), out.aux_loss.detach(), grads

    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    (loss, aux, grads), wall, step_launches = _timed(fwd_bwd)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for t in wrt.values():
        t.requires_grad_(False)
    norms = {n: float(g.float().norm()) for n, g in zip(wrt, grads)}
    del grads
    if not (np.isfinite(float(loss)) and np.isfinite(float(aux))
            and all(np.isfinite(v) and v > 0 for v in norms.values())):
        raise AssertionError(f"[moe] train: loss {float(loss)}, aux {float(aux)}, norms {norms}")
    if not step_launches.get("elementwise_matmul[approx_mult,quantized]"):
        raise AssertionError(f"[moe] train: launches {step_launches}")
    row = {"step": "model/approx_mult forward+backward", "layers": mcfg.n_layers,
           "batch": [TRAIN_B, TRAIN_T], "loss": float(loss), "aux_loss": float(aux),
           "grad_norms": norms, "wall_ms": wall, "launches": step_launches, "peak_gib": peak,
           "card": card}
    print(f"[moe] train {json.dumps(row)}", flush=True)
    del params, batch, wrt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] the phase: {time.perf_counter() - t_phase:.1f}s (reference, init and serving "
          f"{t_ref - t_phase:.1f}s, decode steps {t_steps - t_ref:.1f}s, forward and backward "
          f"{time.perf_counter() - t_steps:.1f}s)", flush=True)
    return launches


# phase_ssm: the SSM and hybrid families at full width and full depth
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")


def _ssm_site_shapes(cfg):
    """(K, N) of every projection an SSM or HYBRID model serves: ssm_in,
    ssm_out, the hybrid's shared attention (q, k, v and o are square at
    zamba2-1.2b's 32 / 32 heads) and MLP, and the LM head, last."""
    D, d_in = cfg.d_model, cfg.ssm_d_inner
    out = [(D, 2 * d_in + 2 * cfg.ssm_state + cfg.ssm_n_heads), (d_in, D)]
    if cfg.shared_attn_every:
        H = cfg.n_heads * cfg.d_head
        out += [(D, H), (H, D), (D, cfg.d_ff), (cfg.d_ff, D)]
    return out + [(D, cfg.vocab_size)]


def phase_kernels_ssm(dev):
    """K1 and K2 (both multipliers), K4, K5, K6 and K7 bitwise against their
    plain versions at every projection shape of mamba2-130m and zamba2-1.2b
    (64 rows prefill, 4 decode), the fan-ins 768, 1536 and 4096 and the
    widths 3352 and 50280 (multiples of 8, not of 16) new to them.  The
    tied head [4 or 64, 768] x embed.T ([50280, 768] row-major) goes
    through the [N, K] entries of K1, K2 and K4, each also bitwise the
    same call on the contiguous [K, N] copy; K5, K6 and K7 take its planes
    row-major.  K3 within 1e-4 at zamba's 32 / 32 heads of 64.  One
    ``[kernels] ssm`` row a kernel, timed at its first shape; returns the
    [N, K] entries' summary rows."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AnalogParams, SCParams
    from repro_torch.core.backends import _array_planes, _stream_planes
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.analog_matmul import (
        analog_matmul_cuda,
        analog_matmul_fused_cuda,
        analog_matmul_fused_ref,
    )
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    from repro_torch.kernels.sc_matmul import (
        SCDraws,
        sc_matmul_fused_cuda,
        sc_matmul_fused_ref,
        sc_matmul_quantized_cuda,
        sc_matmul_quantized_ref,
    )
    from repro_torch.kernels.vpu_matmul import (
        int_operand_matmul_fused_cuda,
        int_operand_matmul_fused_ref,
        plain_multiplier,
    )

    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    sc_p, an_p = SCParams(), AnalogParams()
    adc = (an_p.array_size, an_p.adc_bits, an_p.adc_range)
    mults = {"approx_mult": (4, 7), "log_mult": (0, 8)}  # (dropped bits, operand bits)
    timed, held, summary = set(), [], {}

    def row(name, shape, run, plain, b_ms, b_by, key, tol=0.0, contiguous=None):
        t_plain = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        t_plain = (time.perf_counter() - t_plain) * 1e3
        got = run()
        torch.cuda.synchronize()
        if tol:
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {shape}: max |diff| {err} > {tol}")
        else:
            _hold(name, shape, got, want)
            err = 0.0
        if contiguous is not None:  # the [N, K] entry: bitwise the [K, N] call
            _hold(f"{name} against the contiguous weight", shape, got, contiguous())
        held.append(name)
        if name in timed:
            return
        timed.add(name)
        r = {"name": name, "shape": list(shape), "max_abs_err": err, "ms": cuda_ms(run, 3),
             "device_ms": device_ms(run, 3, key), "plain_ms": t_plain,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if contiguous is not None:  # the [K, N] entry on the contiguous copy, beside it
            r["contiguous_device_ms"] = device_ms(contiguous, 3, key)
        print(f"[kernels] ssm {json.dumps(r)}", flush=True)
        if name in TIED_KERNELS:
            summary[name] = r

    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        for K, N in _ssm_site_shapes(cfg):
            tied = cfg.tie_embeddings and N == cfg.vocab_size
            if tied:  # the head is the view embed.T of the [V, D] embedding
                emb = (torch.randn((N, K), generator=g, device=dev) * K ** -0.5).to(bf)
                w, w_kn = emb.T, emb.T.contiguous()
            else:
                w = w_kn = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
            nk = ",nk" if tied else ""
            for M in (PREFILL_M, DECODE_M):
                x = torch.randn((M, K), generator=g, device=dev).to(bf)
                nbytes = 2 * (M * K + K * N) + 2 * M * N
                for mul, (drop, bits) in mults.items():
                    mulf = plain_multiplier(mul, drop)
                    if M == PREFILL_M:
                        name = f"elementwise_matmul[{mul},quantized{nk}]"
                        b = (bound(nbytes, 2.0 * M * 16 * K * N, INT8_TENSOR_OPS_S)
                             if mul == "approx_mult" else product_bound(nbytes, mul, M, K, N))
                    else:
                        name = f"elementwise_matmul_fused[{mul}{nk}]"
                        b = product_bound(nbytes, mul, M, K, N)
                    row(name, (M, K, N),
                        lambda: int_operand_matmul_fused_cuda(x, w, bits, mul, {}, bf, drop),
                        lambda: int_operand_matmul_fused_ref(x, w, bits, mulf, {}, bf), *b,
                        "repro_vpu::", contiguous=(lambda: int_operand_matmul_fused_cuda(
                            x, w_kn, bits, mul, {}, bf, drop)) if tied else None)
                if M == PREFILL_M:
                    ux, uw = ops.sc_draws((6, K, N, M), 2 * K, sc_p.bits, dev)
                    draws = SCDraws(ux, uw)
                    row(f"sc_matmul_packed[quantized{nk}]", (M, K, N),
                        lambda: sc_matmul_quantized_cuda(x, w, sc_p.gain, sc_p.bits, draws),
                        lambda: sc_matmul_quantized_ref(x, w, sc_p.gain, sc_p.bits, (ux, uw)),
                        *_sc_analog_bound("sc_matmul_packed[quantized]", M, K, N, sc_p.bits),
                        "repro_sc::", contiguous=(lambda: sc_matmul_quantized_cuda(
                            x, w_kn, sc_p.gain, sc_p.bits, draws)) if tied else None)
                    xp, xn, wp, wn, _ = _array_planes(x, w, an_p)
                    if not (wp.is_contiguous() and wn.is_contiguous()):
                        raise AssertionError(f"analog planes of {(K, N)} not row-major")
                    xcat = torch.cat([xp, xn], dim=-1).contiguous()
                    row("analog_matmul", (M, K, N),
                        lambda: analog_matmul_cuda(xcat, (wp, wn), *adc),
                        lambda: ref.analog_matmul_ref(xcat, (wp, wn), *adc),
                        *_sc_analog_bound("analog_matmul", M, K, N, sc_p.bits), "repro_analog::")
                else:
                    xp, xn, wp, wn, pre = _stream_planes(x, w, sc_p)
                    if not (wp.is_contiguous() and wn.is_contiguous()):
                        raise AssertionError(f"SC planes of {(K, N)} not row-major")
                    xcat = torch.cat([xp, xn], dim=-1).contiguous()
                    draws = SCDraws(*ops.sc_draws((7, K, N, M), 2 * K, sc_p.bits, dev))
                    row("sc_matmul_packed_fused", (M, K, N),
                        lambda: sc_matmul_fused_cuda(xcat, (wp, wn), sc_p.bits, draws, pre, {},
                                                     bf),
                        lambda: sc_matmul_fused_ref(xcat, (wp, wn), sc_p.bits, tuple(draws),
                                                    pre, {}, bf),
                        *_sc_analog_bound("sc_matmul_packed_fused", M, K, N, sc_p.bits),
                        "repro_sc::")
                    xp, xn, wp, wn, pre = _array_planes(x, w, an_p)
                    xcat = torch.cat([xp, xn], dim=-1).contiguous()
                    row("analog_matmul_fused", (M, K, N),
                        lambda: analog_matmul_fused_cuda(xcat, (wp, wn), *adc, pre, {}, bf),
                        lambda: analog_matmul_fused_ref(xcat, (wp, wn), *adc, pre, {}, bf),
                        *_sc_analog_bound("analog_matmul_fused", M, K, N, sc_p.bits),
                        "repro_analog::")
                del x, xp, xn, wp, wn, xcat
            del w, w_kn
            torch.cuda.empty_cache()
    zcfg = get_config("zamba2-1.2b")
    M, KV, G, dh = DECODE_M, zcfg.n_kv_heads, zcfg.n_heads // zcfg.n_kv_heads, zcfg.d_head
    q = torch.randn((M, KV, G, dh), generator=g, device=dev).to(bf)
    ck = torch.randn((M, MAX_SEQ, KV, dh), generator=g, device=dev).to(bf)
    cv = torch.randn((M, MAX_SEQ, KV, dh), generator=g, device=dev).to(bf)
    pos = torch.randint(16, MAX_SEQ, (M,), generator=g, device=dev).to(torch.int32)
    keys = int((pos.long() + 1).sum())
    row("flash_decode", (M, MAX_SEQ, KV, G, dh), lambda: flash_decode(q, ck, cv, pos),
        lambda: flash_decode_ref(q, ck, cv, pos),
        *bound(2 * q.numel() + 4 * keys * KV * dh + 4 * M + 4 * q.numel(),
               4.0 * keys * KV * G * dh), "repro_flash_decode::", tol=1e-4)
    print(f"[kernels] ssm held at mamba2-130m's and zamba2-1.2b's shapes: {len(held)} calls of "
          f"{sorted(set(held))}", flush=True)
    return summary


def phase_ssm(dev, card: str):
    """The SSM and HYBRID families on the card (``[ssm]`` lines): (b) each
    smoke config served on the card and the CPU (phase_reference's
    holds); (c) mamba2-130m, then zamba2-1.2b, at full width and full
    depth through the engine (phase_engine: init's wall time, 10 requests
    over the five backends, 4 slots, fused decode; every kernel of the
    path launched: K3 on zamba only, the [N, K] entries on mamba only; a
    non-finite row fails any lane but SC's), then one fused decode step of
    each lane: device ms, ms by kernel group, wall ms (median of 3), host
    waits; ``init`` s and peak GiB.  Returns the engine runs' launches,
    summed."""
    from repro_torch.configs import get_config
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.models import decode as D

    t_phase = time.perf_counter()
    for arch in SSM_ARCHS:
        # an operand an ulp apart on a level boundary of a multiplier's grid
        # moves a request's logits, as on dbrx's smoke config
        phase_reference(dev, arch, "ssm", level_flips_ok=True, token_flips_ok=True)
    t_ref = time.perf_counter()
    total = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        path = [k for k in PATH_KERNELS if cfg.shared_attn_every or k != "flash_decode"]
        if cfg.tie_embeddings:
            path += list(TIED_KERNELS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        launches, params = phase_engine(dev, cfg, card, tag=f"ssm {arch}", expect=path,
                                        nonfinite_ok=("sc",))
        t_serve = time.perf_counter() - t0
        off_path = ([] if cfg.shared_attn_every else ["flash_decode"]) + (
            [] if cfg.tie_embeddings else list(TIED_KERNELS))
        wrong = [k for k in off_path if launches.get(k)]
        if wrong:
            raise AssertionError(f"[ssm] {arch}: launched {wrong}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        # one fused decode step of each lane: 4 slots at position 20
        cache = D.init_cache(cfg, DECODE_M, MAX_SEQ, dev)
        tokens = torch.arange(DECODE_M, device=dev)[:, None] * 7
        pos = torch.full((DECODE_M,), 20, dtype=torch.int32, device=dev)
        for backend in BACKENDS:
            def step(_b=backend):
                ctx = (None if _b == "exact" else
                       ApproxCtx(cfg=_serving_approx(_b), fused=True, rng=(0, 1)))
                return D.serve_step(params, cache, tokens, pos, cfg, ctx=ctx, flash=True)[0]

            dev_ms, by_group = _traced_ms(step)
            syncs = _syncs(step)
            walls = [cuda_ms(step, 1) for _ in range(3)]
            (logits,), _, step_launches = _timed(lambda: (step(),))
            finite = bool(torch.isfinite(logits).all())
            if not finite and backend != "sc":
                raise AssertionError(f"[ssm] {arch} {backend}: non-finite logits")
            r = {"arch": arch, "lane": backend, "slots": DECODE_M,
                 "wall_ms": float(np.median(walls)), "wall_ms_all": walls, "device_ms": dev_ms,
                 "by_group_ms": by_group, "host_waits": syncs, "launches": step_launches,
                 "finite": finite, "card": card}
            print(f"[ssm] decode-step {json.dumps(r)}", flush=True)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[ssm] {arch}: serving {t_serve:.1f}s (init included), peak {peak:.2f} GiB, "
              f"{cfg.n_layers} layers, d {cfg.d_model}, card {card}", flush=True)
        del cache, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ssm] the phase: {time.perf_counter() - t_phase:.1f}s (smoke references "
          f"{t_ref - t_phase:.1f}s)", flush=True)
    return total


def _timed(fn):
    """(fn(), wall ms, the launches of the port's kernels) of one call."""
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, {k: v for k, v in build.LAUNCHES.items() if v}


def _kernel_group(name: str) -> str:
    port = re.search(r"repro_[a-z]+::", name)  # the port's kernels, by CUDA namespace
    if port:
        return port.group(0)[:-2]
    low = name.lower()
    for key, group in (("gemm", "gemm"), ("nvjet", "gemm"), ("xmma", "gemm"),
                       ("cutlass", "gemm"), ("reduce", "reduction"), ("elementwise", "elementwise"),
                       ("memcpy", "copy"), ("memset", "copy"), ("copy", "copy")):
        if key in low:
            return group
    return "other"


def _syncs(fn) -> int:
    """How many times one call of ``fn`` makes the host wait for the card
    (torch's sync debug mode: a read back, a blocking copy from the host,
    a stream synchronisation)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature and does not yet detect
    # all synchronizing operations", once a process) is no wait
    return sum("synchronizing" in str(w.message) and "prototype" not in str(w.message)
               for w in caught)


def _traced_ms(fn):
    """Device ms of one call of ``fn`` (every kernel's own time, from a
    profiler trace after a warm-up call: fn runs twice), and the ms by
    kernel group (the port's kernels by CUDA namespace, PyTorch's GEMMs,
    elementwise and reduction kernels, copies)."""
    from repro_torch.launch.measure import traced

    groups = {}
    records = traced(fn, 1)
    for name, us in records:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    return sum(us for _, us in records) / 1e3, dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def phase_normal(dev):
    """The normal entry of prng.cu against its plain version on the card,
    bitwise, at the INJECT path's output shapes (and within 3 float32
    ulps of the CPU's, whose log1p is another libm's); timed."""
    from repro_torch.kernels import ops, prng
    from repro_torch.launch.measure import INT_OPS_S

    rows = TRAIN_B * TRAIN_T
    summary = None
    for shape in ((rows, 2048), (rows, 11008), (rows, 151936), (7, 13)):
        path = (1, 3, 17, 2**31 - 5)
        got = ops.normal(path, shape, dev)
        want = prng.normal(prng.key_of_path(path), shape, dev)
        _hold("normal_draws", shape, got, want)
        cpu = prng.normal(prng.key_of_path(path), shape).view(torch.int32).long()
        ulps = int((got.cpu().view(torch.int32).long() - cpu).abs().max())
        if ulps > 3:
            raise AssertionError(f"normal_draws {shape}: {ulps} ulps from the CPU's plain version")
        n = shape[0] * shape[1]
        b_ms, b_by = bound(4.0 * n, THREEFRY_OPS * n, INT_OPS_S)
        row = {"name": "normal_draws", "shape": list(shape), "max_abs_err": 0.0,
               "cpu_max_ulps": ulps, "ms": cuda_ms(lambda: ops.normal(path, shape, dev), 10),
               "device_ms": device_ms(lambda: ops.normal(path, shape, dev), 10, "repro_prng::"),
               "plain_ms": cuda_ms(lambda: prng.normal(prng.key_of_path(path), shape, dev), 1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(f"[kernels] {json.dumps(row)}", flush=True)
        if shape == (rows, 11008):
            summary = row
    return {"normal_draws": summary}


def _train_approx(be, mode):
    from repro_torch.configs.base import AnalogParams, ApproxConfig, Backend

    return ApproxConfig(backend=Backend(be), mode=mode,
                        analog=AnalogParams(array_size=16, adc_bits=4), calibrate_every=10)


def phase_train(dev, cfg, params, card: str):
    """The quickstart's pipeline at full width on the engine phase's
    weights (see the module docstring, phase 5).  Returns the launches of
    the pipeline's steps, summed."""
    from repro_torch.configs.base import TrainConfig, TrainMode
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.training import steps as step_lib

    model = build_model(cfg)
    approx = _train_approx("analog", TrainMode.INJECT)
    tcfg = TrainConfig(total_steps=48, warmup_steps=2, learning_rate=2e-3, remat="none")
    data = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B, seed=0)
    gc.collect()  # the engine phase's cycles (its KV cache) go before the peak is taken
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30
    t0 = time.perf_counter()
    state = step_lib.init_train_state(model, 0, approx, tcfg, device=dev, params=params)
    torch.cuda.synchronize()
    print(f"[train] state (AdamW float32 master, m, v; calibration) in "
          f"{time.perf_counter() - t0:.1f}s: {held:.2f} GiB held before it (the weights), "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB after", flush=True)
    fns = {"calibrate": step_lib.make_calibration_step(model, approx, tcfg),
           "inject": step_lib.make_train_step(model, approx, tcfg, TrainMode.INJECT),
           "model": step_lib.make_train_step(model, approx, tcfg, TrainMode.MODEL)}
    hw_eval = step_lib.make_eval_step(model, approx)
    box = {"state": state, "s": 0}

    def call(kind):
        s = box["s"]
        batch, key = data.batch_at(s), (1, s)
        if kind == "eval":
            return hw_eval(box["state"], data.batch_at(999), (2,))
        box["state"], m = fns[kind](box["state"], batch, key)
        if kind != "calibrate":
            box["s"] += 1
        return m

    rows, total = [], {}
    for kind, untraced in (("calibrate", 1), ("inject", 2), ("model", 2), ("eval", 1)):
        walls = []
        for _ in range(untraced):
            m, wall, launches = _timed(lambda: call(kind))
            walls.append(wall)
            loss = float(m["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"[train] {kind}: loss {loss}")
            k6, normal = launches.get("analog_matmul", 0), launches.get("normal_draws", 0)
            if kind == "inject" and (k6 or not normal):
                raise AssertionError(f"[train] an INJECT step launched K6 {k6} times and the "
                                     f"normal entry {normal} times: {launches}")
            if kind != "inject" and (not k6 or normal):
                raise AssertionError(f"[train] {kind}: K6 {k6}, normal {normal}: {launches}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        dev_ms, by_group = _traced_ms(lambda: call(kind))
        row = {"step": kind, "loss": loss, "wall_ms": walls, "device_ms": dev_ms,
               "busy": dev_ms / min(walls), "by_group_ms": by_group, "launches": launches,
               "grad_norm": float(m["grad_norm"]) if "grad_norm" in m else None}
        rows.append(row)
        print(f"[train] {json.dumps(row)}", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    inject, model_row = rows[1], rows[2]
    summary = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [TRAIN_B, TRAIN_T],
               "backend": "analog(array 16, adc 4 bits)", "peak_gib": peak,
               "model_over_inject_wall": min(model_row["wall_ms"]) / min(inject["wall_ms"]),
               "model_over_inject_device": model_row["device_ms"] / inject["device_ms"],
               "steps_run": box["s"], "card": card}
    print(f"[train] summary {json.dumps(summary)}", flush=True)
    del state, box
    torch.cuda.empty_cache()
    return total, peak


def phase_train_backends(dev, cfg, params):
    """One MODEL step on each of sc, approx_mult and log_mult at full width
    with 2 layers (the engine phase's embedding, head and first layers):
    K4 or K1 launches, the loss and the grads are finite."""
    from repro_torch.configs.base import TrainConfig, TrainMode
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.training import steps as step_lib

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = Transformer(params.embed, params.final_norm, list(params.layers[:2]),
                          params.lm_head)
    model = build_model(cfg2)
    data = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B, seed=1)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=2e-3, remat="none")
    want = {"sc": "sc_matmul_packed[quantized]",
            "approx_mult": "elementwise_matmul[approx_mult,quantized]",
            "log_mult": "elementwise_matmul[log_mult,quantized]"}
    total = {}
    for be, kernel in want.items():
        approx = _train_approx(be, TrainMode.MODEL)
        state = step_lib.init_train_state(model, 0, approx, tcfg, device=dev, params=params2)
        step = step_lib.make_train_step(model, approx, tcfg)
        (state, m), wall, launches = _timed(lambda: step(state, data.batch_at(0), (1, 0)))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not launches.get(kernel) or not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"[train] {be} MODEL step: loss {loss}, grad norm {gnorm}, "
                                 f"launches {launches}")
        dev_ms, by_group = _traced_ms(lambda: step(state, data.batch_at(1), (1, 1)))
        row = {"step": "model", "backend": be, "layers": 2, "loss": loss, "grad_norm": gnorm,
               "wall_ms": wall, "device_ms": dev_ms, "by_group_ms": by_group,
               "launches": launches}
        print(f"[train] {json.dumps(row)}", flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del state, step
        torch.cuda.empty_cache()
    return total


# the depth of phase_trainer's model.  The run saves two generations of
# its train state, and phase_bwd two of its own, and the card's host takes
# at most WRITE_BUDGET bytes of disk writes in one run (deleted files count
# too): at 4 layers a generation is 13.0 GB, at 6 15.2 GB; at 36 it would
# be 47.6 GB
TRAINER_LAYERS = 4
WRITE_BUDGET = 45 * 2**30
DISK = {"written": 0}  # checkpoint bytes written in this run, deleted ones included
TRAINER_FAULT_STEP = 7


def _step_recorder(trainer, log):
    """Wrap every step the trainer's cache builds: each call appends its
    kind, mode, wall ms and the port's kernel launches to ``log``."""
    from repro_torch.kernels import build

    get = trainer.steps.get

    def recording_get(key, build_fn):
        fn = get(key, build_fn)

        def recorded(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(build.LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append({"kind": key[0], "mode": key[1].mode.value,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "launches": {k: v - before[k] for k, v in build.LAUNCHES.items()
                                     if v != before[k]}})
            return out

        return recorded

    trainer.steps.get = recording_get


def phase_trainer(dev, cfg, params, card: str, train_peak_gib: float):
    """The phase-plan Trainer at full width (see the module docstring,
    phase 6).  Returns the launches of the port's kernels in its run."""
    import shutil

    from repro_torch.configs.base import TrainConfig, TrainMode
    from repro_torch.convert import train_state_layout
    from repro_torch.core.schedule import paper_schedule
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.training import steps as step_lib

    cfg_l = dataclasses.replace(cfg, n_layers=TRAINER_LAYERS)
    params_l = Transformer(params.embed, params.final_norm,
                           list(params.layers[:TRAINER_LAYERS]), params.lm_head)
    model = build_model(cfg_l)
    approx = _train_approx("analog", TrainMode.INJECT)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=2e-3,
                       phases=paper_schedule(10), remat="block", checkpoint_every=5,
                       keep_checkpoints=1)
    data = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B, seed=0)
    ckpt_dir = Path(__file__).resolve().parent / "build" / "trainer_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    state = step_lib.init_train_state(model, 0, approx, tcfg, device=dev, params=params_l)
    generation = sum(int(np.prod(leaf.shape)) * torch.empty((), dtype=leaf.dtype).element_size()
                     for leaf in _layout_leaves(train_state_layout(state)))
    free = shutil.disk_usage(ckpt_dir).free
    print(f"[trainer] qwen2.5-3b full width, {TRAINER_LAYERS} layers: a generation "
          f"{generation} bytes, {free} free on the disk", flush=True)
    if 2 * generation > min(free, WRITE_BUDGET * 2 // 3):
        raise AssertionError(f"[trainer] the disk cannot take two checkpoint generations "
                             f"({2 * generation} bytes) in {ckpt_dir}: {free} free, "
                             f"{WRITE_BUDGET} bytes of writes a run")

    def fault(step):
        if step == TRAINER_FAULT_STEP and not faults:
            faults.append(step)
            raise RuntimeError(f"injected fault at step {step}")

    faults, log = [], []
    trainer = Trainer(model, approx, tcfg, data, str(ckpt_dir), seed=0, fault_hook=fault,
                      state=state)
    _step_recorder(trainer, log)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        build.reset_launches()
        t0 = time.perf_counter()
        report = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        peak_run = torch.cuda.max_memory_allocated(dev) / 2**30
        events = list(trainer.ckpt.events)
        DISK["written"] += sum(e["bytes"] for e in events if e["op"] == "save")
        plan = trainer.plan
        # one attempt a row: its calibration (if any) and its train step
        rows, calls = [], iter(log)
        for i, (s, loss, dt, cal) in enumerate(zip(report.steps, report.losses,
                                                   report.step_times, report.calibrated)):
            _, phase, _ = plan.phase_at(s)
            cal_call = next(calls) if cal else None
            call = next(calls)
            rows.append({"step": s, "phase": phase.name, "mode": phase.mode.value, "loss": loss,
                         "wall_ms": dt * 1e3, "calibrated": cal,
                         "calib_launches": cal_call["launches"] if cal_call else None,
                         "launches": call["launches"]})
            print(f"[trainer] {json.dumps(rows[-1])}", flush=True)
        for e in events:
            print(f"[trainer] checkpoint {json.dumps(e)}", flush=True)
        # the emulated steps launch K6; INJECT launches the normal entry, not K6
        for r in rows:
            k6, normal = (r["launches"].get("analog_matmul", 0),
                          r["launches"].get("normal_draws", 0))
            if r["mode"] == "inject" and (k6 or not normal):
                raise AssertionError(f"[trainer] INJECT step {r['step']}: K6 {k6}, normal "
                                     f"{normal}")
            if r["mode"] == "model" and (not k6 or normal):
                raise AssertionError(f"[trainer] MODEL step {r['step']}: K6 {k6}, normal {normal}")
            if r["calibrated"] and not r["calib_launches"].get("analog_matmul", 0):
                raise AssertionError(f"[trainer] calibration at step {r['step']} without K6")
        if report.restarts != len(faults) or report.restarts != 1:
            raise AssertionError(f"[trainer] {report.restarts} restarts for {len(faults)} faults")
        if not all(np.isfinite(report.losses)):
            raise AssertionError(f"[trainer] losses {report.losses}")
        # the plan's steps by mode, and the replayed steps' modes again
        want_modes = {}
        for s in report.steps:
            want_modes[plan.mode_at(s).value] = want_modes.get(plan.mode_at(s).value, 0) + 1
        if report.mode_steps != want_modes or sorted(set(report.steps)) != list(range(10)):
            raise AssertionError(f"[trainer] mode steps {report.mode_steps} for steps "
                                 f"{report.steps} of the plan's {plan.mode_counts()}")
        if not any(r["calibrated"] for r in rows):
            raise AssertionError("[trainer] no calibration ran")
        restored = [e["step"] for e in events if e["op"] == "restore"]
        if restored != [5]:
            raise AssertionError(f"[trainer] restored {restored}, not step 5")
        # the replayed steps repeat the first pass: losses and calibrations, bitwise
        first = {}
        for r in rows:
            key = (r["step"], r["loss"], r["calibrated"])
            if r["step"] in first and first[r["step"]] != key:
                raise AssertionError(f"[trainer] replayed step {r['step']}: {key} != "
                                     f"{first[r['step']]}")
            first.setdefault(r["step"], key)
        replayed = sorted({s for s in report.steps if report.steps.count(s) > 1})
        if replayed != [5, 6]:
            raise AssertionError(f"[trainer] replayed {replayed}, not steps 5 and 6")
        cals = {}
        for s, loss in report.calib_losses:
            if cals.setdefault(s, loss) != loss:
                raise AssertionError(f"[trainer] calibration at step {s}: {loss} != {cals[s]}")

        # device time by phase: each kind of step once more after the run
        # (a profiler trace after a warm-up call), the train steps under
        # each remat policy with their peak memory and launches
        kinds = [("calibration", None, lambda b, k: trainer.steps.calibration()(
            trainer._state, b, k)), ("eval", None, lambda b, k: trainer.steps.eval()(
                trainer._state, b, k))]
        for mode in (TrainMode.NO_MODEL, TrainMode.INJECT, TrainMode.MODEL):
            for policy in ("block", "none") + (("full",) if mode != TrainMode.NO_MODEL else ()):
                fn = step_lib.make_train_step(model, approx, dataclasses.replace(
                    tcfg, remat=policy), mode)
                kinds.append((mode.value, policy, lambda b, k, fn=fn: fn(trainer._state, b, k)))
        by_kind = []
        for i, (kind, policy, fn) in enumerate(kinds):
            batch, key = data.batch_at(10 + i), (17, 10 + i)
            gc.collect()
            torch.cuda.reset_peak_memory_stats(dev)
            out, step_wall, step_launches = _timed(lambda: fn(batch, key))
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            dev_ms, by_group = _traced_ms(lambda: fn(batch, key))
            k6, normal = (step_launches.get("analog_matmul", 0),
                          step_launches.get("normal_draws", 0))
            if ((kind in ("inject", "no_model") and k6) or (kind == "inject" and not normal)
                    or (kind not in ("inject", "no_model") and not k6)):
                raise AssertionError(f"[trainer] {kind} step: launches {step_launches}")
            row = {"kind": kind, "remat": policy, "wall_ms": step_wall, "device_ms": dev_ms,
                   "busy": dev_ms / step_wall, "peak_gib": peak, "launches": step_launches,
                   "by_group_ms": by_group}
            by_kind.append(row)
            print(f"[trainer] step-kind {json.dumps(row)}", flush=True)
        remat = {r["kind"] + "/" + r["remat"]: {"k6_launches": r["launches"].get(
            "analog_matmul", 0), "normal_launches": r["launches"].get("normal_draws", 0),
            "peak_gib": r["peak_gib"], "wall_ms": r["wall_ms"], "device_ms": r["device_ms"]}
            for r in by_kind if r["remat"]}
        summary = {
            "arch": cfg.name, "layers": TRAINER_LAYERS, "batch": [TRAIN_B, TRAIN_T],
            "backend": "analog(array 16, adc 4 bits)", "plan": plan.describe(),
            "remat": tcfg.remat, "restarts": report.restarts, "calibrations": report.calibrations,
            "mode_steps": report.mode_steps, "phase_steps": report.phase_steps,
            "compile_stats": report.compile_stats, "replayed": replayed,
            "run_wall_s": wall, "peak_gib_run": peak_run,
            "steps_by_remat": remat, "phase_train_peak_gib_none_36_layers": train_peak_gib,
            "saves": [e for e in events if e["op"] == "save"],
            "restore": [e for e in events if e["op"] == "restore"], "card": card,
        }
        print(f"[trainer] summary {json.dumps(summary)}", flush=True)
    finally:
        trainer.ckpt.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del state, trainer
    torch.cuda.empty_cache()
    return launches


def _layout_leaves(tree):
    """The tensors and Stacked leaves of a train state's layout."""
    from repro_torch.convert import Stacked

    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _layout_leaves(tree[k])]
    return [tree] if isinstance(tree, (torch.Tensor, Stacked)) else []


def _hold_weights(name, got, want, lr, steps):
    """The CPU tests' rule for weights after train steps: within STEP but
    for ADAM_FLIP of a tensor's elements (or one), none by more than 2 lr
    a step."""
    from repro_torch.convert import named_from_jax

    g, w = named_from_jax(got["params"]), named_from_jax(want["params"])
    for n in w:
        d = np.abs(g[n] - w[n])
        miss = d > STEP_ATOL + STEP_RTOL * np.abs(w[n])
        if miss.sum() > max(1, ADAM_FLIP * miss.size) or d.max() > 2 * lr * steps:
            raise AssertionError(f"{name}: weight {n}: {int(miss.sum())} beyond the step "
                                 f"tolerance, max |diff| {float(d.max())}")


def phase_train_reference(dev):
    """The smoke config's calibrate, INJECT and MODEL steps on analog and
    SC, on the card against the CPU (see the module docstring, phase 5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig, TrainMode
    from repro_torch.convert import train_state_from_jax, train_state_to_numpy
    from repro_torch.core import registry
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.training import steps as step_lib

    cfg = get_smoke_config("qwen2.5-3b")
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=4, seed=2)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=2e-3, remat="none")
    for be in ("analog", "sc"):
        approx = _train_approx(be, TrainMode.INJECT)
        cpu = step_lib.init_train_state(model, 0, approx, tcfg, device="cpu")
        report = {"backend": be}
        for s, kind in enumerate(("calibrate", "inject", "model")):
            if kind == "calibrate":
                fn = step_lib.make_calibration_step(model, approx, tcfg)
            else:
                fn = step_lib.make_train_step(model, approx, tcfg, TrainMode(kind))
            # each step from the CPU's state, carried to the card: the
            # calibration step's stats feed both INJECT steps
            card = train_state_from_jax(train_state_to_numpy(cpu), device=dev)
            seen, restore = _record_projections([be])
            try:
                card, mc = fn(card, data.batch_at(s), (1, s))
            finally:
                restore()
            cpu, mh = fn(cpu, data.batch_at(s), (1, s))
            lc, lh = float(mc["loss"]), float(mh["loss"])
            if not (np.isfinite(lc) and np.isfinite(lh)):
                raise AssertionError(f"[train-ref] {be} {kind}: losses {lc}, {lh}")
            for name, fused, x, w, p, rng, epi, y in seen:
                want = registry.get(name).emulate(x.detach().cpu(), w.detach().cpu(), p, rng)
                if not torch.equal(y.cpu(), want):
                    raise AssertionError(f"[train-ref] {be} {kind}: a projection "
                                         f"{tuple(x.shape)}x{tuple(w.shape)} card != CPU")
            if kind == "inject":
                if seen:
                    raise AssertionError(f"[train-ref] {be}: an INJECT step emulated")
                if not abs(lc - lh) <= STEP_ATOL + STEP_RTOL * abs(lh):
                    raise AssertionError(f"[train-ref] {be} INJECT: loss {lc} != {lh}")
                _hold_weights(f"[train-ref] {be} INJECT", train_state_to_numpy(card),
                              train_state_to_numpy(cpu), tcfg.learning_rate, 1)
            elif len(seen) != 7 * cfg.n_layers + 1:
                raise AssertionError(f"[train-ref] {be} {kind}: {len(seen)} projections")
            elif (be == "sc" or kind == "model") and abs(lc - lh) > LOSS_RTOL * abs(lh):
                # (analog's calibration loss is printed only: card and CPU
                # have been seen to flip an ADC level there, 1.3e-3 apart)
                raise AssertionError(f"[train-ref] {be} {kind}: loss {lc} != {lh}")
            report[kind] = {"loss_card": lc, "loss_cpu": lh, "rel": abs(lc - lh) / abs(lh),
                            "projections_bitwise": len(seen)}
        print(f"[train-ref] {json.dumps(report)}", flush=True)


def phase_epilogue(dev, cfg):
    """K2 (both multipliers), K5 and K7 at qwen2.5-3b's decode shape (M 4,
    K 2048, N 11008), each through its backend's fused projection (what a
    decode step calls), with the empty epilogue and with a sampled chip's
    terms (sigmas tripled, so that stuck-at columns fire) and correction
    stats fitted against the exact product: CUDA events over calls, and
    from traces the kernel's own device time and every kernel's of the
    call.  Returns {kernel: its chip-epilogue times}."""
    from repro_torch.configs.base import ApproxConfig, Backend, TrainMode
    from repro_torch.core import calibration, registry
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.hw import VariationModel, chip_epilogue, sample_profile
    from repro_torch.kernels import prng

    M, K, N, bf = DECODE_M, cfg.d_model, cfg.d_ff, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((M, K), generator=g, device=dev).to(bf)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(bf)
    exact = x.float() @ w.float()
    chip = sample_profile(prng.fold_in(prng.prng_key(0), 0), VariationModel(scale=3.0))
    kernels = {"approx_mult": ("elementwise_matmul_fused[approx_mult]", "repro_vpu::"),
               "log_mult": ("elementwise_matmul_fused[log_mult]", "repro_vpu::"),
               "sc": ("sc_matmul_packed_fused", "repro_sc::"),
               "analog": ("analog_matmul_fused", "repro_analog::")}
    out = {}
    for be, (kname, ns) in kernels.items():
        approx = ApproxConfig(backend=Backend(be), mode=TrainMode.MODEL)
        spec, p = registry.get(be), approx.params_for(Backend(be))
        rng = ApproxCtx(cfg=approx, rng=(0,)).site_rng("mlp_up")
        colgain, coladd = chip_epilogue("mlp_up", be, chip, N, bf, dev)
        y = spec.fused_emulate(x, w, p, rng, {"colgain": colgain, "coladd": coladd}
                               if colgain is not None else {"coladd": coladd})
        stats = calibration.fit_error_stats(y, y.float() - exact, 3)
        epi = {"coladd": coladd, "mean_coeffs": stats["mean"], "mean_scale": stats["scale"]}
        if colgain is not None:
            epi["colgain"] = colgain
        row = {"name": kname, "shape": [M, K, N]}
        for case, e in (("empty", {}), ("chip", epi)):
            run = lambda e=e: spec.fused_emulate(x, w, p, rng, e)
            row[f"{case}_ms"] = cuda_ms(run, 10)
            row[f"{case}_device_ms"] = device_ms(run, 10, ns)
            row[f"{case}_call_device_ms"] = device_ms(run, 10)
        print(f"[kernels] epilogue {json.dumps(row)}", flush=True)
        out[kname] = {"chip_epilogue_ms": row["chip_ms"],
                      "chip_epilogue_device_ms": row["chip_device_ms"]}
    return out


# phase_fleet's chips and drift: the drift is strong enough that every lane
# sees its probe loss move within the run, and the recalibration cadence
# short enough that every chip-bound lane refits after drifting
FLEET_CHIPS = 2
# the fleet and static phases run the first 6 of qwen2.5-3b's 36 layers
# since the SSM and hybrid families' phase (cut for time; full depth before)
FLEET_LAYERS = 6
FLEET_DRIFT = dict(gain_walk_std=0.5, offset_walk_std=0.25, fault_growth=1.0)
FLEET_RECAL_EVERY = 3
FLEET_SLOTS = 2  # three requests of a backend need a second lane, on the second chip
FLEET_WALL_TURNS = 7  # nominal and chip-bound decode steps timed in turns


@contextlib.contextmanager
def _plain_on_card():
    """The kernel wrappers take their plain versions on the card's tensors
    too, for the hold of a served projection (never on the served path)."""
    from repro_torch.kernels import ops

    on_cuda = ops._on_cuda
    ops._on_cuda = lambda *tensors: False
    try:
        yield
    finally:
        ops._on_cuda = on_cuda


def _hold_fleet_projection(rec) -> None:
    """A fused decode projection with a chip's terms and a lane's fitted
    correction in its epilogue, against the plain fused version on the card
    and the composed path (the emulator's kernel, then the chip, then the
    mean error subtracted), bitwise."""
    from repro_torch.core import calibration, registry
    from repro_torch.kernels.epilogue import apply_epilogue

    name, _, x, w, p, rng, epi, y = rec
    spec = registry.get(name)
    if "coladd" not in epi or "mean_coeffs" not in epi:
        raise AssertionError(f"[fleet] {name} projection without chip or correction: {sorted(epi)}")
    with _plain_on_card():
        plain = spec.fused_emulate(x, w, p, rng, epi)
    composed = apply_epilogue(spec.emulate(x, w, p, rng), colgain=epi.get("colgain"),
                              coladd=epi["coladd"])
    stats = {"mean": epi["mean_coeffs"], "scale": epi["mean_scale"]}
    composed = composed - calibration.predict_mean(stats, composed).to(composed.dtype)
    for what, want in (("plain fused version", plain), ("composed path", composed)):
        # bitwise, and NaN where the other is NaN: a lane whose corrected
        # activations overflowed upstream (ROADMAP section C: SC at full
        # width) serves NaN rows
        if not (torch.equal(torch.isnan(y), torch.isnan(want))
                and torch.equal(torch.nan_to_num(y, nan=0.0), torch.nan_to_num(want, nan=0.0))):
            _hold(f"{name} fused decode projection with a chip, against its {what}",
                  (tuple(x.shape), tuple(w.shape)), y, want)
    return int((~torch.isfinite(x)).any())


def phase_fleet(dev, cfg, params, card: str):
    """Serving over a chip fleet at full width (see the module docstring,
    phase 7).  Returns the launches of the port's kernels in the engine
    run."""
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.hw import DriftModel, Fleet
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.runtime.engine import Engine, synthetic_requests

    model = build_model(cfg)
    queue = synthetic_requests(15, cfg.vocab_size, seed=3, prompt_lens=(16, 48),
                               gen_lens=(8, 14), backends=BACKENDS)
    eng = Engine(model, params, n_slots=FLEET_SLOTS, max_seq=MAX_SEQ, fused=True, device=dev,
                 seed=0, fleet=Fleet(FLEET_CHIPS, seed=0), drift=DriftModel(**FLEET_DRIFT),
                 recalibrate_every=FLEET_RECAL_EVERY)
    timings, held, gate = [], set(), {"on": False}

    def timed(kind, fn, backend_of):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timings.append((kind, backend_of(*args), time.perf_counter() - t0))
            return out
        return call

    # a bind's wall time holds its recalibration, which is also timed alone
    eng._new_lane = timed("bind", eng._new_lane,
                          lambda approx, index: approx.backend.value if approx.active else None)
    eng._recalibrate = timed("recalibrate", eng._recalibrate, lambda lane: lane.backend)
    decode_lane = eng._decode_lane

    def decode_once_after_drift(lane):
        # record one decode step of each chip lane once it has refitted
        # after drifting: every projection with its chip and its stats
        gate["on"] = lane.chip is not None and lane.recals >= 2 and lane.name not in held
        try:
            return decode_lane(lane)
        finally:
            if gate["on"]:
                held.add(lane.name)
            gate["on"] = False

    eng._decode_lane = decode_once_after_drift
    # the served logit rows that are not finite, per lane: only SC's
    # corrected lanes may serve them (ROADMAP section C)
    bad_rows, decode, prefill = {}, eng._decode, eng._prefill

    def count_bad(lane, rows):
        bad = int((~torch.isfinite(rows)).any(dim=-1).sum())
        bad_rows[lane.name] = bad_rows.get(lane.name, 0) + bad
        if bad and lane.backend != "sc":
            raise AssertionError(f"[fleet] {lane.name} served {bad} non-finite logit rows")

    def counted_decode(lane, rng):
        logits = decode(lane, rng)
        count_bad(lane, logits[[i for i, st in enumerate(lane.slots) if st is not None]])
        return logits

    def counted_prefill(lane, *args):
        last = prefill(lane, *args)
        count_bad(lane, last[None])
        return last

    eng._decode, eng._prefill = counted_decode, counted_prefill
    seen, restore = _record_projections(EMULATED, keep=lambda fused: fused and gate["on"])
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        results = eng.run(queue)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        restore()
    if sorted(results) != list(range(len(queue))):
        raise AssertionError(f"[fleet] served {sorted(results)} of {len(queue)} requests")
    for req in queue:
        toks = results[req.rid]["tokens"]
        if len(toks) != req.max_new_tokens or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"[fleet] request {req.rid}: tokens {toks}")
    missing = [k for k in PATH_KERNELS if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"[fleet] kernels never launched: {missing}")
    chip_lanes = [l for l in eng.lanes.values() if l.chip is not None]
    if ({l.backend for l in chip_lanes} != set(EMULATED)
            or {l.chip_id for l in chip_lanes} != set(range(FLEET_CHIPS))):
        raise AssertionError(f"[fleet] chip lanes {[l.name for l in chip_lanes]}")
    for lane in chip_lanes:
        # bound (a recalibration at bind), drifted, refitted after drifting
        if lane.recals < 2 or float(lane.chip["age"]) <= 0 or lane.probe_losses[1][0] <= 0:
            raise AssertionError(f"[fleet] {lane.name}: {lane.recals} recalibrations, age "
                                 f"{float(lane.chip['age'])}, probes {lane.probe_losses}")
    if held != {l.name for l in chip_lanes}:
        raise AssertionError(f"[fleet] decode steps held for {sorted(held)} only")
    t0 = time.perf_counter()
    by_backend, nonfinite = {}, {}
    for rec in seen:
        by_backend[rec[0]] = by_backend.get(rec[0], 0) + 1
        nonfinite[rec[0]] = nonfinite.get(rec[0], 0) + _hold_fleet_projection(rec)
    print(f"[fleet] {len(seen)} fused decode projections with a chip and fitted correction "
          f"bitwise their plain version and the composed path on the card: "
          f"{json.dumps(by_backend)}; of which with a non-finite input: "
          f"{json.dumps(nonfinite)} ({time.perf_counter() - t0:.1f}s)", flush=True)
    del seen
    metrics = dict(eng.metrics(), wall_s=wall, card=card)
    print(f"[fleet] metrics {json.dumps(metrics)}", flush=True)
    print(f"[fleet] fleet_report {json.dumps(eng.fleet_report())}", flush=True)
    print(f"[fleet] non-finite logit rows served per lane {json.dumps(bad_rows)}", flush=True)
    print(f"[fleet] launches {json.dumps(launches)}", flush=True)
    for kind in ("bind", "recalibrate"):
        for be in EMULATED:
            secs = [t for k, b, t in timings if k == kind and b == be]
            print(f"[fleet] {kind} {be}: wall s {json.dumps(secs)}", flush=True)

    # one decode step of a chip-bound lane (chip and correction in the
    # epilogues, the stats sliced per layer) against a nominal one (no
    # chip, no stats), per backend, from profiler traces
    tokens = torch.zeros((FLEET_SLOTS, 1), dtype=torch.int64, device=dev)
    pos = torch.zeros((FLEET_SLOTS,), dtype=torch.int32, device=dev)
    for lane in sorted(chip_lanes, key=lambda l: (l.backend, l.chip_id)):
        if lane.chip_id:
            continue

        def step(chip, _lane=lane):
            ctx = ApproxCtx(cfg=_lane.approx, fused=True, rng=(0, 1),
                            chip=_lane.chip if chip else None, correct=chip)
            D.serve_step(params, _lane.cache, tokens, pos, cfg, ctx=ctx,
                         calib=_lane.calib if chip else None, flash=True)

        row = {"backend": lane.backend, "slots": FLEET_SLOTS, "card": card}
        for kind, chip in (("nominal", False), ("chip", True)):
            row[f"{kind}_device_ms"], row[f"{kind}_by_group_ms"] = _traced_ms(lambda: step(chip))
            row[f"{kind}_syncs"] = _syncs(lambda: step(chip))
        # wall: the two in turns (the host is shared, and its load drifts)
        walls = {False: [], True: []}
        for _ in range(FLEET_WALL_TURNS):
            for chip in (False, True):
                walls[chip].append(cuda_ms(lambda: step(chip), 1))
        for kind, chip in (("nominal", False), ("chip", True)):
            row[f"{kind}_wall_ms"] = float(np.median(walls[chip]))
            row[f"{kind}_wall_ms_all"] = walls[chip]
        row["chip_over_nominal_device_ms"] = row["chip_device_ms"] - row["nominal_device_ms"]
        print(f"[fleet] decode-step {json.dumps(row)}", flush=True)
    return launches


def phase_static(dev, cfg, params, card: str):
    """The static-batch baseline against the engine on one exact queue at
    full width (see the module docstring, phase 8)."""
    from repro_torch.models import build_model
    from repro_torch.runtime.engine import Engine, run_static_baseline, synthetic_requests

    model = build_model(cfg)
    queue = synthetic_requests(6, cfg.vocab_size, seed=4, prompt_lens=(16, 64),
                               gen_lens=(16, 32))
    eng = Engine(model, params, n_slots=DECODE_M, max_seq=MAX_SEQ, fused=True, device=dev,
                 seed=0)
    eng.run(queue)  # warm: every call of the measured run below in steady state
    eng.reset_metrics()
    again = [dataclasses.replace(r, rid=r.rid + len(queue)) for r in queue]
    t0 = time.perf_counter()
    res = eng.run(again)
    torch.cuda.synchronize()
    engine = dict(eng.metrics(), wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    static = run_static_baseline(model, params, queue, batch=DECODE_M)
    static_wall = time.perf_counter() - t0
    outputs = static.pop("outputs")
    for req in queue:
        toks = outputs[req.rid]
        if len(toks) != req.max_new_tokens or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"[static] request {req.rid}: tokens {toks}")
        if len(res[req.rid + len(queue)]["tokens"]) != req.max_new_tokens:
            raise AssertionError(f"[static] the engine's request {req.rid}")
    row = {"requests": len(queue), "card": card, "static": dict(static, wall_s=static_wall),
           "engine": {k: engine[k] for k in ("prefill_tokens", "decode_tokens", "prefill_tok_s",
                                             "decode_tok_s", "total_tok_s", "p50_ms", "p99_ms",
                                             "slot_util", "wall_s")}}
    print(f"[static] {json.dumps(row)}", flush=True)


def phase_trainer_fleet(dev, cfg, params, card: str):
    """A variation-aware Trainer phase at full width with its first
    TRAINER_LAYERS layers (see the module docstring, phase 9).  Returns the
    launches of the port's kernels in its run."""
    import shutil

    from repro_torch.configs.base import TrainConfig, TrainMode, parse_phase_specs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.training import steps as step_lib

    cfg_l = dataclasses.replace(cfg, n_layers=TRAINER_LAYERS)
    params_l = Transformer(params.embed, params.final_norm,
                           list(params.layers[:TRAINER_LAYERS]), params.lm_head)
    model = build_model(cfg_l)
    approx = _train_approx("analog", TrainMode.INJECT)
    phases = parse_phase_specs(("inject:2:calib=1", "model:3:fleet=2"))
    tcfg = TrainConfig(total_steps=5, warmup_steps=1, learning_rate=2e-3, phases=phases,
                       remat="none")
    data = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B, seed=2)
    ckpt_dir = Path(__file__).resolve().parent / "build" / "trainer_fleet_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    state = step_lib.init_train_state(model, 0, approx, tcfg, device=dev, params=params_l)
    trainer = Trainer(model, approx, tcfg, data, str(ckpt_dir), seed=0, state=state)
    # no checkpoint: the card's host takes 45 GiB of disk writes a run, and
    # phase_trainer's two generations take most of them
    trainer._save = lambda step, state: None
    chips, log = [], []
    chip_for = trainer._chip_for

    def recording(phase, step):
        chip = chip_for(phase, step)
        chips.append(None if chip is None else list(chip["key"]))
        return chip

    trainer._chip_for = recording
    _step_recorder(trainer, log)
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        report = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    fleet = trainer._fleets[2]
    want = [None, None] + [list(fleet.chip(s % 2)["key"]) for s in (2, 3, 4)]
    if report.fleet_steps != 3 or chips != want:
        raise AssertionError(f"[trainer-fleet] fleet steps {report.fleet_steps}, chips {chips}")
    for entry in log:
        k6 = entry["launches"].get("analog_matmul", 0)
        if entry["mode"] == "model" and not k6:
            raise AssertionError(f"[trainer-fleet] a MODEL step without K6: {entry}")
        print(f"[trainer-fleet] {json.dumps(entry)}", flush=True)
    if not all(np.isfinite(report.losses)):
        raise AssertionError(f"[trainer-fleet] losses {report.losses}")
    summary = {"arch": cfg.name, "layers": TRAINER_LAYERS, "batch": [TRAIN_B, TRAIN_T],
               "schedule": trainer.plan.describe(), "fleet_steps": report.fleet_steps,
               "chips": chips, "losses": report.losses, "step_s": report.step_times,
               "calibrations": report.calibrations, "wall_s": wall,
               "k6_launches": launches.get("analog_matmul", 0), "card": card}
    print(f"[trainer-fleet] summary {json.dumps(summary)}", flush=True)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the approximate backward's phase: the sensitivity gate's open share,
# the depth of its Trainer (two checkpoint generations of the sm3 state,
# 7.4 GB each at 4 layers, beside phase_trainer's; the card's host takes
# WRITE_BUDGET bytes of writes a run) and the step its fault comes at
BWD_GATE_FRAC = 0.75
BWD_TRAINER_LAYERS = 4
# the depth of the gated steps, the gradient norms and the AdamW updates:
# 4 of qwen2.5-3b's 36 layers, to make room for the [moe] phase (36 before
# it)
BWD_STEP_LAYERS = 4
BWD_FAULT_STEP = 6
BWD_PLAN = ("exact:2", "inject:3:calib=every_n,every=2,bwd=approx,gate=0.75",
            "model:3:bwd=auto,gate=0.75,gate_every=2")
ROUND_OPS = THREEFRY_OPS + 4  # integer ops an element: its block, the add, mask and shift


def phase_round(dev):
    """The rounding entry of prng.cu (AdamW's bf16 first moment, rounded
    stochastically) against its plain version, bitwise: on the card at a
    layer's attention and MLP shapes (a layer's slice of its stacked leaf,
    at the slice's counters), on the CPU at a small shape; the kernel alone
    also at the embedding's [151936, 2048].  Timed."""
    from repro_torch.kernels import ops, prng

    words = (0x5F3759DF, 3, 5, 1)
    path = torch.tensor(prng.path_words(words), dtype=torch.int32, device=dev)
    key = prng.key_of_path(words)
    g = torch.Generator(device=dev).manual_seed(3)
    summary = None
    for shape, offset in (((2048, 2048), 7 * 2048 * 2048), ((2048, 11008), 0),
                          ((151936, 2048), 0), ((7, 13), 2**32 - 40)):
        x = torch.randn(shape, generator=g, device=dev) * 1e-3
        got = ops.stochastic_round_bf16(x, path, offset)
        n = x.numel()
        plain_ms = None
        if n < 2**25:
            _hold("sr_bf16", shape, got, prng.stochastic_round_bf16(x, key, offset))
            plain_ms = cuda_ms(lambda: prng.stochastic_round_bf16(x, key, offset), 1)
        if n < 2**10:
            _hold("sr_bf16", shape, got.cpu(), ops.stochastic_round_bf16(x.cpu(), path.cpu(),
                                                                         offset))
        b_ms, b_by = bound(6.0 * n, ROUND_OPS * n, INT_OPS_S)
        row = {"name": "sr_bf16", "shape": list(shape), "offset": offset, "max_abs_err": 0.0,
               "ms": cuda_ms(lambda: ops.stochastic_round_bf16(x, path, offset), 10),
               "device_ms": device_ms(lambda: ops.stochastic_round_bf16(x, path, offset), 10,
                                      "repro_prng::"),
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_terms_ms": {"bytes": 6.0 * n / HBM_BYTES_S * 1e3,
                                  "operations": ROUND_OPS * n / INT_OPS_S * 1e3},
               "library_ms": None}
        print(f"[kernels] {json.dumps(row)}", flush=True)
        if shape == (2048, 11008):
            summary = row
        del x, got
    return {"sr_bf16": summary}


def _gate_events(plan, steps):
    """The reference's rule for the sensitivity gate over the steps a run
    took (replays included): a phase with ``backward="approx"`` derives it
    at its first step, ``"auto"`` at the first step of every ``gate_every``
    of the phase; each phase keeps its last (epoch, mask)."""
    cached, events = {}, []
    for s in steps:
        index, phase, sip = plan.phase_at(s)
        if phase.backward == "exact":
            continue
        epoch = sip // phase.gate_every if phase.backward == "auto" else 0
        if cached.get(index) != epoch:
            cached[index] = epoch
            events.append(s)
    return events


def phase_bwd(dev, cfg, params, card: str):
    """The approximate backward and the compressed optimizer state at full
    width (see the module docstring, phase 12).  Returns the launches of
    the port's kernels in its runs."""
    import shutil

    from repro_torch.configs.base import TrainConfig, TrainMode, parse_phase_specs
    from repro_torch.convert import train_state_layout
    from repro_torch.core import switch as switch_lib
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build, prng
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.search import sensitivity
    from repro_torch.training import steps as step_lib

    total = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_T, global_batch=TRAIN_B, seed=3)
    batch = data.batch_at(0)
    n_sites = len(switch_lib.SITE_ORDER)
    gc.collect()
    torch.cuda.empty_cache()

    parts = {}  # wall seconds of each part of the phase
    t_part = time.perf_counter()
    # (b) the sensitivity gate, twice through one step cache
    base = _train_approx("analog", TrainMode.INJECT)
    fns = step_lib.CompiledFnCache()
    masks, walls = [], []
    for _ in range(2):
        mask, wall, launches = _timed(lambda: sensitivity.backward_gate(
            model, params, batch, base, frac=BWD_GATE_FRAC, fns=fns))
        masks.append(mask)
        walls.append(wall / 1e3)
        count(launches)
        built = fns.stats()["built"]
    if built != 1 or not np.array_equal(masks[0], masks[1]):
        raise AssertionError(f"[bwd] gate: built {fns.stats()}, masks {masks}")
    open_sites = [s for s in switch_lib.SITE_ORDER if masks[0][switch_lib.site_pos(s)]]
    row = {"frac": BWD_GATE_FRAC, "probe": "analog(array 16, adc 4 bits)", "wall_s": walls,
           "built": built, "open_sites": open_sites, "mask": masks[0].tolist(),
           "launches": launches, "card": card}
    print(f"[bwd] gate {json.dumps(row)}", flush=True)
    if len(open_sites) != 8 - int(np.ceil((1 - BWD_GATE_FRAC) * 8)):
        raise AssertionError(f"[bwd] gate opens {open_sites}")

    parts["gate"], t_part = time.perf_counter() - t_part, time.perf_counter()
    # from here on the first BWD_STEP_LAYERS layers of the weights (shared)
    cfg = dataclasses.replace(cfg, n_layers=BWD_STEP_LAYERS)
    model = build_model(cfg)
    params = Transformer(params.embed, params.final_norm, list(params.layers[:BWD_STEP_LAYERS]),
                         params.lm_head)
    # (a) gated train steps under three gates; learning rate 0, so every
    # step starts from the same weights and the losses must agree bit for bit
    gates = {"closed": np.zeros(n_sites, np.int32), "open": np.ones(n_sites, np.int32),
             "sensitivity": masks[0]}
    tcfg = TrainConfig(total_steps=10, warmup_steps=1, learning_rate=0.0, weight_decay=0.0,
                       remat="none", optim_compress="bf16")
    inject = _train_approx("analog", TrainMode.INJECT)
    state = step_lib.init_train_state(model, 0, inject, tcfg, device=dev, params=params)
    state, _ = step_lib.make_calibration_step(model, inject, tcfg)(state, batch, (1, 0))
    steps = []
    for mode, be in ((TrainMode.MODEL, "approx_mult"), (TrainMode.MODEL, "analog"),
                     (TrainMode.INJECT, "analog")):
        step = step_lib.make_train_step(model, _train_approx(be, mode), tcfg, bwd_aware=True)
        by_gate = {}
        for gname, gate in gates.items():
            def call(_step=step, _gate=gate):
                return _step(state, batch, (1, 0), bwd_gate=_gate)[1]

            gc.collect()
            torch.cuda.reset_peak_memory_stats(dev)
            m, wall, launches = _timed(call)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            count(launches)
            dev_ms, by_group = _traced_ms(call)
            syncs = _syncs(call)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"[bwd] {be} {mode.value} gate {gname}: loss {loss}, "
                                     f"grad norm {gnorm}")
            by_gate[gname] = row = {
                "step": f"{mode.value}/{be}", "gate": gname,
                "open_sites": int(np.asarray(gate).sum()), "loss": loss, "grad_norm": gnorm,
                "wall_ms": wall, "device_ms": dev_ms, "busy": dev_ms / wall,
                "by_group_ms": by_group, "launches": launches, "host_waits": syncs,
                "peak_gib": peak, "card": card}
            print(f"[bwd] step {json.dumps(row)}", flush=True)
        rows = list(by_gate.values())
        if len({r["loss"] for r in rows}) != 1:
            raise AssertionError(f"[bwd] {mode.value}/{be}: the losses differ across gates: "
                                 f"{[r['loss'] for r in rows]}")
        if any(r["host_waits"] != by_gate["closed"]["host_waits"] for r in rows):
            raise AssertionError(f"[bwd] {mode.value}/{be}: an open gate waits for the host "
                                 f"{[r['host_waits'] for r in rows]}")
        if by_gate["open"]["grad_norm"] == by_gate["closed"]["grad_norm"]:
            raise AssertionError(f"[bwd] {mode.value}/{be}: the open gate changed no gradient")
        kernel = ("analog_matmul" if be == "analog" else
                  "elementwise_matmul[approx_mult,quantized]")
        need = {"normal_draws", "sr_bf16"} if mode == TrainMode.INJECT else {kernel, "sr_bf16"}
        if any(not r["launches"].get(k) for r in rows for k in need):
            raise AssertionError(f"[bwd] {mode.value}/{be}: launches {rows[0]['launches']}")
        steps.extend(rows)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    # the loss's gradient norm by parameter group and by layer under the
    # gates, on the weights this phase inherits (the earlier phases trained
    # them in place): where the open gate's rise comes from
    # (tools/bwd_site_norms.py does the same on seed weights)
    named = dict(params.named_parameters())
    probe = _train_approx("approx_mult", TrainMode.MODEL)
    for gname, gate in (("closed", gates["closed"]), ("open", gates["open"]),
                        ("only lm_head", switch_lib.backward_gate(approx_sites=("lm_head",))),
                        ("all but lm_head", switch_lib.backward_gate(exact_sites=("lm_head",)))):
        for p in named.values():
            p.requires_grad_(True)
        loss = step_lib._loss(params, step_lib._batch(batch, dev), model, probe, None, (1, 0),
                              TrainConfig(remat="none"), bwd_gate=gate)
        grads = torch.autograd.grad(loss, list(named.values()))
        for p in named.values():
            p.requires_grad_(False)
        groups, layers = {}, [0.0] * cfg.n_layers
        for n, g in zip(named, grads):
            sq = float(g.float().square().sum())
            parts_n = n.split(".")
            key = ".".join(parts_n[2:]) if parts_n[0] == "layers" else n
            groups[key] = groups.get(key, 0.0) + sq
            if parts_n[0] == "layers":
                layers[int(parts_n[1])] += sq
        del grads
        row = {"step": "model/approx_mult", "gate": gname, "loss": float(loss.detach()),
               "grad_norm": sum(groups.values()) ** 0.5,
               "by_group": {k: v ** 0.5 for k, v in sorted(groups.items())},
               "by_layer": [v ** 0.5 for v in layers], "card": card}
        del loss
        print(f"[bwd] norms {json.dumps(row)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    parts["steps"], t_part = time.perf_counter() - t_part, time.perf_counter()
    # (d) the Trainer under sm3 with exact, approx and auto backward phases,
    # a fault after a checkpoint, the restore and the replay
    cfg_l = dataclasses.replace(cfg, n_layers=BWD_TRAINER_LAYERS)
    params_l = Transformer(params.embed, params.final_norm,
                           list(params.layers[:BWD_TRAINER_LAYERS]), params.lm_head)
    model_l = build_model(cfg_l)
    tcfg = TrainConfig(total_steps=8, warmup_steps=1, learning_rate=2e-3,
                       phases=parse_phase_specs(BWD_PLAN), remat="none", checkpoint_every=4,
                       keep_checkpoints=1, optim_compress="sm3")
    ckpt_dir = Path(__file__).resolve().parent / "build" / "bwd_trainer_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    state = step_lib.init_train_state(model_l, 0, inject, tcfg, device=dev, params=params_l)
    generation = sum(int(np.prod(leaf.shape)) * torch.empty((), dtype=leaf.dtype).element_size()
                     for leaf in _layout_leaves(train_state_layout(state)))
    free = shutil.disk_usage(ckpt_dir).free
    print(f"[bwd] trainer: qwen2.5-3b full width, {BWD_TRAINER_LAYERS} layers, sm3: a "
          f"generation {generation} bytes, {DISK['written']} written before, {free} free",
          flush=True)
    if DISK["written"] + 2 * generation > min(free, WRITE_BUDGET * 9 // 10):
        raise AssertionError(f"[bwd] two generations of {generation} bytes exceed the disk "
                             f"({free} free) or the run's writes ({DISK['written']} of "
                             f"{WRITE_BUDGET})")

    def fault(s):
        if s == BWD_FAULT_STEP and not faults:
            faults.append(s)
            raise RuntimeError(f"injected fault at step {s}")

    faults, log = [], []
    trainer = Trainer(model_l, inject, tcfg, data, str(ckpt_dir), seed=0, fault_hook=fault,
                      state=state)
    _step_recorder(trainer, log)
    try:
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        report = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        count(launches)
        peak_run = torch.cuda.max_memory_allocated(dev) / 2**30
        events = list(trainer.ckpt.events)
        DISK["written"] += sum(e["bytes"] for e in events if e["op"] == "save")
    finally:
        trainer.ckpt.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    plan = trainer.plan
    for entry in log:
        print(f"[bwd] trainer call {json.dumps(entry)}", flush=True)
    for e in events:
        print(f"[bwd] trainer checkpoint {json.dumps(e)}", flush=True)
    want_events = _gate_events(plan, report.steps)
    want_bwd = {}
    for s in report.steps:
        b = plan.phase_at(s)[1].backward
        want_bwd[b] = want_bwd.get(b, 0) + 1
    first = {}
    for s, loss in zip(report.steps, report.losses):
        if first.setdefault(s, loss) != loss:
            raise AssertionError(f"[bwd] trainer: replayed step {s}: {loss} != {first[s]}")
    replayed = sorted({s for s in report.steps if report.steps.count(s) > 1})
    restored = [e["step"] for e in events if e["op"] == "restore"]
    train_calls = [e for e in log if e["kind"] == "train"]
    if (report.restarts != 1 or restored != [4] or replayed != [4, 5]
            or [s for s, _ in report.gate_events] != want_events
            or report.gate_refreshes != len(want_events)
            or report.backward_steps != want_bwd or report.compile_stats["built"] != 5
            or not all(np.isfinite(report.losses))
            or any(e["launches"].get("sr_bf16", 0) != len(list(params_l.parameters()))
                   for e in train_calls)):
        raise AssertionError(f"[bwd] trainer: restarts {report.restarts}, restored {restored}, "
                             f"replayed {replayed}, gate events {report.gate_events} (the "
                             f"rule: {want_events}), backward steps {report.backward_steps}, "
                             f"built {report.compile_stats}, losses {report.losses}")
    trainer_summary = {
        "layers": BWD_TRAINER_LAYERS, "plan": plan.describe(), "optim_compress": "sm3",
        "steps": report.steps, "losses": report.losses, "step_s": report.step_times,
        "restarts": report.restarts, "replayed": replayed,
        "gate_refreshes": report.gate_refreshes, "gate_events": report.gate_events,
        "gate_events_rule": want_events, "backward_steps": report.backward_steps,
        "compile_stats": report.compile_stats, "run_wall_s": wall, "peak_gib": peak_run,
        "generation_bytes": generation, "launches": launches, "card": card}
    print(f"[bwd] trainer summary {json.dumps(trainer_summary)}", flush=True)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    parts["trainer"], t_part = time.perf_counter() - t_part, time.perf_counter()
    # (c) one AdamW update a compression, on the gradients of
    # one exact backward; one layer's attn_q m held against the plain
    # rounding on the CPU from the same float32 EMA
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    exact = _train_approx("exact", TrainMode.NO_MODEL)
    loss = step_lib._loss(params, step_lib._batch(batch, dev), model, exact, None, (1, 0),
                          TrainConfig(remat="none"))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    del loss
    for p in named.values():
        p.requires_grad_(False)
    layer = cfg.n_layers // 2
    name = f"layers.{layer}.attn.wq"
    adam_rows = []
    for compress in ("none", "bf16", "sm3"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tc = TrainConfig(optim_compress=compress, learning_rate=2e-3, warmup_steps=1)
        opt = adamw.adamw_init(named, compress)
        nbytes = adamw.state_bytes(opt)
        _, wall, launches = _timed(lambda: adamw.adamw_update(grads, opt, named, tc))
        count(launches)
        m_prev = opt["m"][name].float().cpu()
        gnorm = adamw.tree_global_norm(grads[n] for n in named)
        scale = torch.clamp_max(adamw._f32(tc.grad_clip, gnorm) / (gnorm + 1e-9), 1.0).cpu()
        adamw.adamw_update(grads, opt, named, tc)
        if compress != "none":
            leaf, sl = adamw._leaf_slots(tuple(named))[name]
            m_f32 = tc.beta1 * m_prev + (1 - tc.beta1) * (grads[name].float().cpu() * scale)
            words = (adamw.ROUND_SEED, int(opt["count"]), leaf, 1)
            want = prng.stochastic_round_bf16(m_f32, prng.key_of_path(words),
                                              sl * m_f32.numel())
            _hold("sr_bf16", f"m of {name}", opt["m"][name].cpu(), want)
        dev_ms, by_group = _traced_ms(lambda: adamw.adamw_update(grads, opt, named, tc))
        row = {"optim_compress": compress, "state_bytes": nbytes, "update_wall_ms": wall,
               "update_device_ms": dev_ms, "by_group_ms": by_group, "launches": launches,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "m_slice_held": None if compress == "none" else name, "card": card}
        adam_rows.append(row)
        print(f"[bwd] adamw {json.dumps(row)}", flush=True)
        del opt
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    parts["adamw"] = time.perf_counter() - t_part
    sizes = [r["state_bytes"] for r in adam_rows]
    if not sizes[0] > sizes[1] > sizes[2]:
        raise AssertionError(f"[bwd] state bytes {sizes}")
    summary = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [TRAIN_B, TRAIN_T],
               "gate_wall_s": walls, "state_bytes": dict(zip(("none", "bf16", "sm3"), sizes)),
               "trainer_layers": BWD_TRAINER_LAYERS, "parts_s": parts, "launches": total,
               "card": card}
    print(f"[bwd] summary {json.dumps(summary)}", flush=True)
    return total


SEARCH_BACKENDS = ("analog", "log_mult", "approx_mult")  # the search CLI's default world
SEARCH_B, SEARCH_T = 8, 32  # the search CLI's profiling batch
SEARCH_BASE_STEPS = 2       # exact base steps (the CLI's default is 60)
SEARCH_MUTATIONS = 2        # mutation steps (the CLI's default is 12)
SEARCH_BUDGET = 0.5


def phase_search(dev, cfg, params, card: str):
    """The search-and-deploy loop's search at full width and depth (see
    the module docstring, phase 10).  Trains ``params`` in place (the base
    steps).  Returns the launches of the port's kernels in the profile and
    the search, and the winner's site map."""
    from repro_torch.configs.base import Backend, TrainMode
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch import search as search_cli
    from repro_torch.models import build_model
    from repro_torch.search import pareto
    from repro_torch.search import sensitivity as sens
    from repro_torch.training.steps import CompiledFnCache

    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, SEARCH_T, SEARCH_B, seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    search_cli.train_base(model, data, SEARCH_BASE_STEPS, lr=2e-3, seed=0, device=dev,
                          params=params)
    gc.collect()  # the base steps' AdamW state goes before the search's peak
    torch.cuda.synchronize()
    base_s, base_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    batch = data.batch_at(10_000)
    base = search_cli.search_base(cfg)
    fns = CompiledFnCache()
    build.reset_launches()
    t0 = time.perf_counter()
    profile = sens.profile_sensitivity(model, params, batch, base, SEARCH_BACKENDS, seed=0,
                                       fns=fns, dispatch="switch",
                                       switch_backends=SEARCH_BACKENDS)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = pareto.search(model, params, batch, base, SEARCH_BACKENDS, seed=0,
                           mutations=SEARCH_MUTATIONS, fns=fns, profile=profile,
                           dispatch="switch")
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    stats = fns.stats()
    if stats["built"] > 2:
        raise AssertionError(f"[search] the switch search built {stats}")
    for e in profile.entries:
        if not (np.isfinite(e.first_order) and np.isfinite(e.hw_delta)):
            raise AssertionError(f"[search] profile entry {e}")
        print(f"[search] profile {json.dumps(dataclasses.asdict(e))}", flush=True)
    winner = result.best_under_budget(SEARCH_BUDGET)
    search_cli.check_spec(pareto.spec_of(winner.assignment), winner.assignment)
    for k in ("analog_matmul", "elementwise_matmul[approx_mult,quantized]",
              "elementwise_matmul[log_mult,quantized]"):
        if not launches.get(k):
            raise AssertionError(f"[search] {k} never launched: {launches}")
    front = [dict(p.to_json(), energy_frac=p.energy / result.baseline_energy)
             for p in result.front]
    summary = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [SEARCH_B, SEARCH_T],
               "backends": list(SEARCH_BACKENDS), "base_steps": SEARCH_BASE_STEPS,
               "base_s": base_s, "base_peak_gib": base_peak, "profile_s": profile_s,
               "search_s": search_s, "exact_loss": result.exact_loss,
               "pool": len(result.pool), "n_sites": result.n_sites, "front": front,
               "winner": pareto.spec_of(winner.assignment),
               "winner_energy_frac": winner.energy / result.baseline_energy,
               "winner_loss": winner.loss, "compile_stats": stats, "peak_gib": peak,
               "card": card}
    print(f"[search] summary {json.dumps(summary)}", flush=True)

    # one blend probe and one hardware eval, each traced (device ms) and
    # counted (launches), on the steps the search built
    probe = sens.one_site_config(base, "mlp_gate", "analog")
    ccfg = sens._switch_cfg(probe, SEARCH_BACKENDS)
    grad_fn = fns.get(("blend_grad_switch", ccfg), None)
    idx = sens._switch_idx(probe, ccfg)
    calls = {
        "blend_probe": lambda: grad_fn(params, batch, (0,), 0.0, idx),
        "hw_eval": lambda: sens.eval_loss(model, params, batch, probe, (0,), fns, "switch",
                                          switch_backends=SEARCH_BACKENDS),
    }
    for kind, fn in calls.items():
        _, wall, step_launches = _timed(fn)
        dev_ms, by_group = _traced_ms(fn)
        row = {"call": kind, "site": "mlp_gate", "backend": "analog", "wall_ms": wall,
               "device_ms": dev_ms, "busy": dev_ms / wall, "by_group_ms": by_group,
               "launches": step_launches, "card": card}
        print(f"[search] {json.dumps(row)}", flush=True)
    if fns.stats()["built"] != stats["built"]:
        raise AssertionError(f"[search] the traced calls built steps: {fns.stats()}")

    # every front map re-scored with static dispatch: bitwise the switch loss
    static_fns = CompiledFnCache()
    for p in result.front:
        approx = dataclasses.replace(base, backend=Backend.EXACT, mode=TrainMode.MODEL,
                                     site_backends=p.assignment)
        loss = sens.eval_loss(model, params, batch, approx, (0,), static_fns, "static")
        if loss != p.loss:
            raise AssertionError(f"[search] {pareto.spec_of(p.assignment)}: static loss {loss} "
                                 f"!= switch loss {p.loss}")
    print(f"[search] {len(result.front)} front maps re-scored with static dispatch: every loss "
          f"bitwise the switch loss ({static_fns.stats()['built']} static steps)", flush=True)
    return launches, winner.assignment


SWITCH_SLOTS = 4
# the merged lanes run the first 12 of qwen2.5-3b's 36 layers since the SSM
# and hybrid families' phase (cut for time; full depth before)
SWITCH_LAYERS = 12
SWITCH_HETERO = (("attn_*", "approx_mult"), ("mlp_*", "log_mult"))
SWITCH_DEMOTE = ("mlp_*",)


def _hold_switch_projection(rec) -> None:
    """A fused decode projection of a merged step against its plain fused
    version on the same operands and key path, on the card, bitwise."""
    from repro_torch.core import registry

    name, _, x, w, p, rng, epi, y = rec
    with _plain_on_card():
        want = registry.get(name).fused_emulate(x, w, p, rng, epi)
    _hold(f"{name} fused projection of a merged decode step",
          (tuple(x.shape), tuple(w.shape)), y, want)


def phase_switch(dev, cfg, params, card: str, winner):
    """Merged serving lanes at full width (see the module docstring, phase
    11).  Returns the launches of the port's kernels in the engine run."""
    from repro_torch.core import switch as switch_lib
    from repro_torch.core.approx_linear import ApproxCtx
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.runtime.engine import Engine, Request

    model = build_model(cfg)
    rnd = np.random.default_rng(11)

    def req(rid, backend="exact", sites=(), gen=None):
        prompt = tuple(int(t) for t in rnd.integers(0, cfg.vocab_size, int(rnd.integers(16, 49))))
        return Request(rid=rid, prompt=prompt, max_new_tokens=gen or int(rnd.integers(8, 15)),
                       backend=backend, site_backends=sites)

    # the first four fill the merged lane's four slots: one decode step
    # with every emulated backend's rows
    queue = [req(i, b) for i, b in enumerate(EMULATED)]
    queue += [req(4, sites=winner), req(5, sites=SWITCH_HETERO), req(6)]
    queue += [req(7 + i, b) for i, b in enumerate(EMULATED)]
    eng = Engine(model, params, n_slots=SWITCH_SLOTS, max_seq=MAX_SEQ, fused=True, device=dev,
                 seed=0, switch=True, collect_logits=True)
    gate = {"on": False, "done": False}
    decode_lane = eng._decode_lane

    def record_first_merged_step(lane):
        gate["on"] = lane.switch and not gate["done"]
        try:
            return decode_lane(lane)
        finally:
            gate["done"] |= gate["on"]
            gate["on"] = False

    eng._decode_lane = record_first_merged_step
    seen, restore = _record_projections(EMULATED, keep=lambda fused: fused and gate["on"])
    demoted = {}
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        for r in queue:
            eng.submit(r)
        while eng.pending or any(l.n_active() for l in eng.lanes.values()):
            eng.step()
            lane = next(l for l in eng.lanes.values() if l.switch)
            if not eng.pending and not demoted and lane.n_active():
                # e) every request admitted: demote the MLP sites mid-flight
                demoted.update(warm=set(eng._warm), lane=lane, cache=lane.cache,
                               n=eng.demote_sites(SWITCH_DEMOTE))
                cols = [switch_lib.site_pos(s) for s in switch_lib.SITE_ORDER
                        if s.startswith("mlp_")]
                if demoted["n"] != 1 or lane.site_idx[:, cols].any():
                    raise AssertionError(f"[switch] demotion: {demoted['n']} lanes, "
                                         f"rows {lane.site_idx.tolist()}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        restore()
    results = eng.results
    if sorted(results) != list(range(len(queue))):
        raise AssertionError(f"[switch] served {sorted(results)} of {len(queue)} requests")
    for r in queue:
        res = results[r.rid]
        if len(res["tokens"]) != r.max_new_tokens or not all(
                np.isfinite(row).all() for row in res["logits"]):
            raise AssertionError(f"[switch] request {r.rid}: {len(res['tokens'])} tokens")
    # a) every emulated request in one merged lane, the exact one in its own
    names = sorted(l.name for l in eng.lanes.values())
    if names != ["exact", "switch"]:
        raise AssertionError(f"[switch] lanes {names}")
    # b) K1-K7 (and the SC tables and draws) launched
    missing = [k for k in PATH_KERNELS if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"[switch] kernels never launched: {missing}")
    # c) the recorded merged step's fused projections, bitwise
    kinds = sorted({rec[0] for rec in seen})
    if kinds != sorted(EMULATED):
        raise AssertionError(f"[switch] the recorded merged step ran {kinds}")
    for rec in seen:
        _hold_switch_projection(rec)
    print(f"[switch] {len(seen)} fused projections of one merged decode step (rows "
          f"{', '.join(EMULATED)}) bitwise their plain fused versions on the card", flush=True)
    del seen
    # e) nothing rebuilt after the demotion: the same lane and cache, no
    # first call
    if (eng._warm != demoted["warm"] or demoted["lane"] is not next(
            l for l in eng.lanes.values() if l.switch) or demoted["cache"] is not demoted[
            "lane"].cache):
        raise AssertionError("[switch] the demotion rebuilt something")
    metrics = dict(eng.metrics(), wall_s=wall, card=card)
    print(f"[switch] metrics {json.dumps(metrics)}", flush=True)
    print(f"[switch] launches {json.dumps(launches)}", flush=True)
    # steady state: the same queue again on the warm engine
    eng.demote_sites(())
    eng.reset_metrics()
    t0 = time.perf_counter()
    eng.run([dataclasses.replace(r, rid=r.rid + 100) for r in queue])
    torch.cuda.synchronize()
    metrics = dict(eng.metrics(), wall_s=time.perf_counter() - t0, card=card)
    print(f"[switch] steady-state metrics {json.dumps(metrics)}", flush=True)
    del eng

    # d) a solo request through the merged lane, bitwise its static lane:
    # every backend with one slot; approx_mult and log_mult with idle slots
    # too (SC and analog take per-tensor scales over every row, and a
    # merged lane's idle rows run exact)
    for backend, slots in [(b, 1) for b in EMULATED] + [("approx_mult", SWITCH_SLOTS),
                                                         ("log_mult", SWITCH_SLOTS)]:
        solo = req(50, backend, gen=8)
        out = {}
        for switch in (False, True):
            e = Engine(model, params, n_slots=slots, max_seq=MAX_SEQ, fused=True, device=dev,
                       seed=0, switch=switch, collect_logits=True)
            out[switch] = e.run([solo])[50]
        same = out[True]["tokens"] == out[False]["tokens"] and all(
            np.array_equal(a, b, equal_nan=True)
            for a, b in zip(out[True]["logits"], out[False]["logits"]))
        if not same:
            raise AssertionError(f"[switch] solo {backend} at {slots} slots: merged lane != "
                                 f"static lane")
        print(f"[switch] solo {backend}, {slots} slots: merged lane bitwise the static lane "
              f"({len(solo.prompt)}-token prompt, {solo.max_new_tokens} tokens)", flush=True)

    # one merged decode step beside the static lanes' steps of the same
    # backends: device ms (traces) and host waits (sync debug mode)
    cache = D.init_cache(cfg, SWITCH_SLOTS, MAX_SEQ, dev)
    tokens = torch.zeros((SWITCH_SLOTS, 1), dtype=torch.int64, device=dev)
    pos = torch.full((SWITCH_SLOTS,), 20, dtype=torch.int32, device=dev)
    canon = switch_lib.canonical(_serving_approx("log_mult"))

    def rows(backends):
        return np.stack([switch_lib.site_indices(_serving_approx(b)) for b in backends])

    steps = {f"static {b}": (_serving_approx(b), None) for b in EMULATED}
    steps["merged all four"] = (canon, rows(EMULATED))
    steps["merged approx_mult+log_mult"] = (canon, rows(("approx_mult", "log_mult") * 2))
    for kind, (approx, idx) in steps.items():
        def step(_approx=approx, _idx=idx):
            ctx = ApproxCtx(cfg=_approx, fused=True, rng=(0, 1), site_idx=_idx)
            D.serve_step(params, cache, tokens, pos, cfg, ctx=ctx, flash=True)

        dev_ms, by_group = _traced_ms(step)
        syncs = _syncs(step)
        walls = [cuda_ms(step, 1) for _ in range(3)]
        if kind == "merged approx_mult+log_mult" and syncs:
            raise AssertionError(f"[switch] a merged approx_mult/log_mult step waited for the "
                                 f"host {syncs} times")
        row = {"step": kind, "slots": SWITCH_SLOTS, "device_ms": dev_ms, "host_waits": syncs,
               "wall_ms": float(np.median(walls)), "wall_ms_all": walls,
               "by_group_ms": by_group, "card": card}
        print(f"[switch] decode-step {json.dumps(row)}", flush=True)
    return launches


def _serving_approx(backend):
    from repro_torch.configs.base import ApproxConfig, Backend, TrainMode

    return ApproxConfig(backend=Backend(backend), mode=TrainMode.MODEL)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of the port")
    ap.add_argument("--only", choices=("ssm",),
                    help="build, then run only this phase (a probe; the full run takes no "
                         "argument and prints the kernels line and the last line)")
    args = ap.parse_args(argv)
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
    t_run = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    if args.only == "ssm":
        t0 = time.perf_counter()
        phase_kernels_ssm(dev)
        print(f"[kernels] ssm holds: {time.perf_counter() - t0:.1f}s", flush=True)
        ssm = phase_ssm(dev, card)
        print(f"[ssm] launches {json.dumps(ssm)}", flush=True)
        print(f"[run] {time.perf_counter() - t_run:.1f}s", flush=True)
        return 0

    cfg = get_config("qwen2.5-3b")
    summary = phase_kernels(dev, cfg)
    torch.cuda.synchronize()
    summary.update(phase_sc_analog(dev, cfg))
    torch.cuda.synchronize()
    for name, times in phase_epilogue(dev, cfg).items():
        summary[name].update(times)
    t0 = time.perf_counter()
    phase_kernels_moe(dev, get_config("dbrx-132b"))
    print(f"[kernels] moe holds: {time.perf_counter() - t0:.1f}s", flush=True)
    phase_reference(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    moe_launches = phase_moe(dev, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    summary.update(phase_kernels_ssm(dev))
    print(f"[kernels] ssm holds: {time.perf_counter() - t0:.1f}s", flush=True)
    ssm_launches = phase_ssm(dev, card)
    torch.cuda.empty_cache()
    launches, params = phase_engine(dev, cfg, card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # [fleet] and [static] on the first FLEET_LAYERS layers (cut for time:
    # [ssm] took their place in the run's budget)
    from repro_torch.models.transformer import Transformer

    cfg_f = dataclasses.replace(cfg, n_layers=FLEET_LAYERS)
    params_f = Transformer(params.embed, params.final_norm, list(params.layers[:FLEET_LAYERS]),
                           params.lm_head)
    fleet_launches = phase_fleet(dev, cfg_f, params_f, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_static(dev, cfg_f, params_f, card)
    del params_f
    print(f"[fleet] the fleet and static phases: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    search_launches, winner = phase_search(dev, cfg, params, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[search] the phase: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    # [switch] on the first SWITCH_LAYERS layers (cut for time, as [fleet])
    switch_launches = phase_switch(
        dev, dataclasses.replace(cfg, n_layers=SWITCH_LAYERS), Transformer(
            params.embed, params.final_norm, list(params.layers[:SWITCH_LAYERS]),
            params.lm_head), card, winner)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[switch] the phase: {time.perf_counter() - t0:.1f}s", flush=True)
    summary.update(phase_normal(dev))
    summary.update(phase_round(dev))
    train_launches, train_peak = phase_train(dev, cfg, params, card)
    for k, v in phase_train_backends(dev, cfg, params).items():
        train_launches[k] = train_launches.get(k, 0) + v
    trainer_launches = phase_trainer(dev, cfg, params, card, train_peak)
    t0 = time.perf_counter()
    trainer_fleet_launches = phase_trainer_fleet(dev, cfg, params, card)
    print(f"[trainer-fleet] the phase: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    bwd_launches = phase_bwd(dev, cfg, params, card)
    print(f"[bwd] the phase: {time.perf_counter() - t0:.1f}s", flush=True)
    del params
    torch.cuda.empty_cache()
    phase_train_reference(dev)
    torch.cuda.synchronize()
    print(f"[train] launches {json.dumps(train_launches)}", flush=True)
    print(f"[trainer] launches {json.dumps(trainer_launches)}", flush=True)
    print(f"[trainer-fleet] launches {json.dumps(trainer_fleet_launches)}", flush=True)
    print(f"[search] launches {json.dumps(search_launches)}", flush=True)
    print(f"[bwd] launches {json.dumps(bwd_launches)}", flush=True)
    print(f"[ssm] launches {json.dumps(ssm_launches)}", flush=True)

    kernels = []
    for name in PATH_KERNELS + tuple(TIED_KERNELS) + tuple(TRAIN_KERNELS):
        row = summary[name]
        source, replaces = {**KERNEL_SOURCES, **TIED_KERNELS, **TRAIN_KERNELS}[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": os.path.normpath(f"src/repro/kernels/{replaces}"),
            "launches": sum(d.get(name, 0) for d in (launches, train_launches, trainer_launches,
                                                      fleet_launches, trainer_fleet_launches,
                                                      search_launches, switch_launches,
                                                      bwd_launches, moe_launches,
                                                      ssm_launches)),
            "engine_launches": launches.get(name, 0),
            "moe_launches": moe_launches.get(name, 0),
            "ssm_launches": ssm_launches.get(name, 0),
            "train_launches": train_launches.get(name, 0),
            "trainer_launches": trainer_launches.get(name, 0),
            "fleet_launches": fleet_launches.get(name, 0),
            "trainer_fleet_launches": trainer_fleet_launches.get(name, 0),
            "search_launches": search_launches.get(name, 0),
            "switch_launches": switch_launches.get(name, 0),
            "bwd_launches": bwd_launches.get(name, 0),
            "shape": row["shape"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{k: row[k] for k in ("bound_terms_ms", "alu_bound_ms", "chip_epilogue_ms",
                                   "chip_epilogue_device_ms") if k in row},
        })
    # the port's path imports none of jax, the JAX package or ml_dtypes
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
    if foreign:
        raise AssertionError(f"modules imported that the port must not need: {foreign[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[run] {time.perf_counter() - t_run:.1f}s", flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
