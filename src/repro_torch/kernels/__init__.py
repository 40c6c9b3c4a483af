"""Hand-written CUDA kernels for Hopper (``sm_90a``), one package per kernel
family, each with ``ref.py`` (the plain PyTorch version), ``kernel.py`` (the
ctypes launcher and its launch counter) and ``ops.py`` (the wrapper that
takes the plain version for a CPU tensor and launches the kernel for a CUDA
one).  Sources live in ``repro_torch/csrc``."""
