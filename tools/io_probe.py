#!/usr/bin/env python3
"""The rates a checkpoint of the train state goes through on the card's
host, for sizing the Trainer's saves and restores:

  python3 tools/io_probe.py

Prints the Python and PyTorch versions, the free space of the file
systems under the checkout, ``/tmp`` and ``/dev/shm``, the host's memory
and cores; then, on one 2 GiB float32 array: ``zlib.crc32`` (which a
zip member's write and read compute), ``np.savez`` into the gitignored
``build/`` with the file system synced and ``np.load`` back (the
checkpoint manager's write and read), and a host-to-device and
device-to-host copy of it (pageable memory), each in GB/s.  The file is removed at the end.  Needs a CUDA
device.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("io_probe: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version, torch.__version__, torch.version.cuda)
    print(subprocess.run(["df", "-h", ".", "/tmp", "/dev/shm"], capture_output=True,
                         text=True).stdout)
    print(subprocess.run(["free", "-g"], capture_output=True, text=True).stdout)
    print("cpus", os.cpu_count())
    a = np.random.default_rng(0).standard_normal(2**29, dtype=np.float32)  # 2 GiB
    t0 = time.perf_counter()
    zlib.crc32(a)
    print("crc32 GB/s", a.nbytes / (time.perf_counter() - t0) / 1e9)
    d = os.path.join("build", "io_probe")
    os.makedirs(d, exist_ok=True)
    try:
        t0 = time.perf_counter()
        np.savez(os.path.join(d, "a.npz"), leaf_0=a)
        os.sync()
        print("savez GB/s", a.nbytes / (time.perf_counter() - t0) / 1e9)
        t0 = time.perf_counter()
        b = np.load(os.path.join(d, "a.npz"))["leaf_0"]
        print("load GB/s", a.nbytes / (time.perf_counter() - t0) / 1e9, bool((a == b).all()))
    finally:
        shutil.rmtree(d)
    x = torch.empty(a.shape, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    x.copy_(torch.from_numpy(b))
    torch.cuda.synchronize()
    print("H2D GB/s", a.nbytes / (time.perf_counter() - t0) / 1e9)
    t0 = time.perf_counter()
    x.cpu()
    print("D2H GB/s", a.nbytes / (time.perf_counter() - t0) / 1e9)
    return 0


if __name__ == "__main__":
    sys.exit(main())
