"""Build, load and launch the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use (or all at once, in parallel, through
:func:`build_all`) into ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the sources and flags so an edited source is
never served from a stale library.  Importing this module needs neither
``nvcc`` nor CUDA.

:func:`launch` is the one place a kernel is started: it calls the C entry
point, raises if it returned a CUDA error, and adds one to that kernel's
launch count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> {C entry point: argtypes}
SIGNATURES = {
    "vpu_matmul": {
        # mul, in_bf16, x, w, aslots, acc, out, M, N, K, bits, drop_bits, stream
        "vpu_matmul": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # mul, M, K, bits, drop_bits -> 16-byte words of A' scratch
        "vpu_slot_words": (_I, _I, _I, _I, _I),
        # mul, M, N, K, bits, drop_bits -> split planes of int32 sums
        "vpu_plane_count": (_I, _I, _I, _I, _I, _I),
        # mul, in_bf16, out_bf16, x, w, pre, gain, add, coeffs (P of them,
        # then the correction's scale), P, eps, acc, out, M, N, K, drop_bits,
        # stream
        "vpu_matmul_fused": (
            _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P,
            _I, _I, _I, _I, _P,
        ),
        # M -> words of vpu_quantize_matmul_fused's scales buffer
        "vpu_scales_words": (_I,),
        # mul, in_bf16, out_bf16, x, w, hold, scales, aslots, bits, lev,
        # lev2, eps_in, gain, add, coeffs, P, eps, acc, out, M, N, K,
        # drop_bits, w_nk (w given as [N, K]), stream
        "vpu_quantize_matmul_fused": (
            _I, _I, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F, _P, _P, _P, _I, _F,
            _P, _P, _I, _I, _I, _I, _I, _P,
        ),
    },
    "flash_decode": {
        # in_bf16, q, ck, cv, pos, out, part, count, B, S, KV, G, dh, gt,
        # maxg, lpr, nv, steps, split_len, n_splits, scale, stream
        "flash_decode": (
            _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _I, _I, _F, _P,
        ),
    },
    "sc_matmul": {
        # ux, uw, tab, K, bits, stream
        "sc_tables": (_P, _P, _P, _I, _I, _P),
        # in_bf16, x, wa, wb, tab, acc, out, M, N, K, bits, stream
        "sc_matmul": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # xbits, wbits, acc, out, M, N, ports, bits, stream
        "sc_matmul_words": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        # in_bf16, x, w, tab, hold, scales, acc_p, acc_n, out, M, N, K, bits,
        # eps, gain, gain2, w_nk (w given as [N, K]), stream
        "sc_matmul_quantized": (
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P,
        ),
        # in_bf16, out_bf16, x, wp, wn, tab, acc_p, acc_n, pre, gain, add,
        # coeffs, P, eps, out, M, N, K, bits, stream
        "sc_matmul_fused": (
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P,
            _I, _I, _I, _I, _P,
        ),
    },
    "prng": {
        # path, n_path, ux, uw, ports, bits, stream
        "sc_draws": (_P, _I, _P, _P, _I, _I, _P),
        # path, n_path, out, n, stream
        "normal_draws": (_P, _I, _P, ctypes.c_longlong, _P),
        # path, n_path, x, out, n, offset, stream
        "sr_bf16": (_P, _I, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P),
    },
    "analog_matmul": {
        # M, N, K, array_size, adc_bits
        "analog_scratch_bytes": (_I, _I, _I, _I, _I),
        # M, N, K, array_size, adc_bits
        "analog_fused_scratch_bytes": (_I, _I, _I, _I, _I),
        # in_bf16, x, wa, wb, q, out, M, N, K, array_size, adc_bits, adc_range, stream
        "analog_matmul": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        # in_bf16, out_bf16, x, wp, wn, scratch, pre, gain, add, coeffs, P,
        # eps, out, M, N, K, array_size, adc_bits, adc_range, stream
        "analog_matmul_fused": (
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P,
            _I, _I, _I, _I, _I, _F, _P,
        ),
    },
}

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    # K1 on integer-valued operands, the reference kernel's own interface:
    # a check entry, off the serving path
    "elementwise_matmul[approx_mult]": 0,
    "elementwise_matmul[log_mult]": 0,
    # K1's function on the operands themselves, quantising them on load
    # (more than 4 rows): the serving path's prefill
    "elementwise_matmul[approx_mult,quantized]": 0,
    "elementwise_matmul[log_mult,quantized]": 0,
    # K2 on the operands themselves, quantising them on load (at most 4
    # rows): the serving path's decode
    "elementwise_matmul_fused[approx_mult]": 0,
    "elementwise_matmul_fused[log_mult]": 0,
    # K1's and K2's entries that read the weight as [N, K] row-major (a tied
    # LM head reads the embedding in place): the serving path of a model
    # with tied embeddings
    "elementwise_matmul[approx_mult,quantized,nk]": 0,
    "elementwise_matmul[log_mult,quantized,nk]": 0,
    "elementwise_matmul_fused[approx_mult,nk]": 0,
    "elementwise_matmul_fused[log_mult,nk]": 0,
    # K2 on integer-valued operands, the reference kernel's own interface:
    # a check entry, off the serving path
    "elementwise_matmul_fused[approx_mult,int]": 0,
    "elementwise_matmul_fused[log_mult,int]": 0,
    "flash_decode": 0,
    # K4 on given probability planes, one polarity (the reference kernel's
    # function): a check entry, off the serving path
    "sc_matmul_packed": 0,
    # K4's function for both polarities on the operands themselves, the SC
    # value-domain code taken in: the serving path's prefill
    "sc_matmul_packed[quantized]": 0,
    # its [N, K] entry (a tied LM head)
    "sc_matmul_packed[quantized,nk]": 0,
    "sc_matmul_packed_fused": 0,
    # the generator draws of an SC key path (threefry), in front of the tables
    "sc_draws": 0,
    # the Gaussian noise of an INJECT-mode projection (threefry, erfinv)
    "normal_draws": 0,
    # AdamW's first moment stochastically rounded to bf16 (threefry)
    "sr_bf16": 0,
    # the threshold tables of a set of SC draws, in front of K4 and K5
    "sc_tables": 0,
    "analog_matmul": 0,
    "analog_matmul_fused": 0,
    # K4's contraction on pre-packed words: a check entry, off the serving path
    "sc_matmul_packed[words]": 0,
}
# library -> nvcc's output (register and shared-memory use per kernel)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels build on a machine with the CUDA toolkit"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the .cu and the shared headers
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=tuple(SIGNATURES)) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the wall seconds spent; raises on a failed build."""
    t0 = time.perf_counter()
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[name])  # atomic: readers never see half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    if name not in _LIBS:
        build_all((name,))
        so = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        err = getattr(so, f"{name}_error_string")
        err.argtypes = (ctypes.c_int,)
        err.restype = ctypes.c_char_p
        _LIBS[name] = so
    return _LIBS[name]


def launch(kernel: str, library: str, entry: str, *args) -> None:
    """Call ``entry`` of ``library``; raise on a CUDA error, else count one
    launch of ``kernel``."""
    so = lib(library)
    rc = getattr(so, entry)(*args)
    if rc != 0:
        msg = getattr(so, f"{library}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch: {msg}")
    LAUNCHES[kernel] += 1
