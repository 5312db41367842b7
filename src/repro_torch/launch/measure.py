"""The H100's peak rates, and the device time of a call from profiler
traces: one place for ``chip_smoke.py``, ``tools/time_kernel.py``,
``profile_decode`` and the card tests.

It imports nothing but torch, so ``tools/time_kernel.py`` and
``profile_decode`` load it by its path and time another tree's package
with it.

The card's ``torch.profiler`` can drop kernel records, the first that
a process traces most of all, and never adds any.  So a trace starts with a
warm-up step of one call (``traced``), and ``kernel_times`` takes a
kernel's launches a call as the most that any trace shows (exact while a
trace drops fewer than ``calls`` of its records) and its time as the mean
of the records that were kept.
"""
from __future__ import annotations

from collections import Counter, defaultdict

import torch

HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
CUDA_CORE_OPS_S = 67e12      # H100 SXM float32 rate outside the tensor cores
F64_TENSOR_OPS_S = 67e12     # H100 SXM float64 tensor-core rate (data sheet)
# 32-bit integer instructions a second: at most half the float32 rate,
# which counts each FMA as two operations
INT_OPS_S = CUDA_CORE_OPS_S / 2
INT8_TENSOR_OPS_S = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)
# H100 SXM instruction rates: SMs x lanes a clock x boost clock, for all
# instructions dispatched (128 lanes an SM) and for the ALU pipe (64:
# LOP3, IADD3, ISETP, SEL)
INSTR_S = 132 * 128 * 1.98e9
ALU_S = 132 * 64 * 1.98e9
# AND+POPC bit products a second of mma.m16n8k256.b1.and.popc, measured by
# tools/bench_b1_mma.py on an H100 80GB HBM3 at 700 W: 10x the bit rate of
# LOP3 on the ALU pipe (ALU_S x 32), so the fastest unit of the card for
# the SC contractions' OR of ANDs
B1_BIT_OPS_S = 5118e12

# traces pooled by kernel_times; most taken while all are empty (on the
# H100 four empty traces of one call in a row have been seen in a
# chip_smoke.py run, so a run tries harder before it calls a kernel absent)
TRACES, TRACE_TRIES = 2, 12


def traced(fn, calls: int, key: str = "") -> list:
    """(name, device microseconds) of each kernel whose name contains
    ``key`` in ``calls`` calls of ``fn``: the active step of a
    ``torch.profiler`` schedule whose warm-up step runs one call first."""
    from torch.autograd import DeviceType

    events = []
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=schedule,
                                on_trace_ready=lambda p: events.extend(p.events())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [(ev.name, ev.time_range.elapsed_us()) for ev in events
            if ev.device_type == DeviceType.CUDA and key in ev.name]


def pool(traces: list, calls: int) -> dict:
    """name -> (launches a call, mean device ms a launch) from traces of
    ``calls`` calls each: the launches the most that any trace shows,
    rounded up, the time the mean of every record of the name."""
    launches, times = Counter(), defaultdict(list)
    for trace in traces:
        for name, n in Counter(name for name, _ in trace).items():
            launches[name] = max(launches[name], -(-n // calls))
        for name, us in trace:
            times[name].append(us)
    return {name: (launches[name], sum(us) / len(us) / 1e3) for name, us in times.items()}


def kernel_times(fn, calls: int, key: str = "") -> dict:
    """``pool`` of ``TRACES`` traces of ``calls`` calls of ``fn``; more,
    up to ``TRACE_TRIES``, while every trace is empty.  Raises if all
    were: a call that launches no kernel named ``key`` is not measured."""
    traces = []
    for _ in range(TRACE_TRIES):
        traces.append(traced(fn, calls, key))
        if len(traces) >= TRACES and any(traces):
            return pool(traces, calls)
    raise RuntimeError(f"{len(traces)} traces of {calls} calls held no kernel named {key!r}")


def device_ms(fn, calls: int, key: str = "") -> float:
    """Device milliseconds a call of the kernels whose names contain
    ``key`` (a CUDA source's namespace; "" for every kernel): the kernels'
    own time, without the host time between calls that CUDA events see."""
    return sum(n * ms for n, ms in kernel_times(fn, calls, key).values())
