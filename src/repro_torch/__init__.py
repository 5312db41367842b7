"""PyTorch/CUDA port of :mod:`repro` (the JAX/Pallas reference package).

The layout mirrors ``src/repro/`` so each module names its reference by
path.  The port imports ``torch`` and never ``jax`` or ``repro``: what it
needs from the reference it keeps as its own copy.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written
Hopper kernels live in ``repro_torch.kernels`` (CUDA C++ under
``kernels/csrc/``), each beside its plain PyTorch version.
"""
