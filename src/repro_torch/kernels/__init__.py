"""Hand-written Hopper kernels for the emulation hot loops.

Layout per kernel: ``<name>.py`` holds the plain PyTorch version and the
wrapper that launches the CUDA kernel from ``csrc/``; ``ops.py`` picks one
by the input's device (CPU tensor: plain version; CUDA tensor: kernel,
or raise); ``build.py`` compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
