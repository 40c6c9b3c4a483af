"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same subpackage names as the reference (``core``, ``data``, ``ops``,
``kernels``, ``trees``, ``configs``); the hot ops run as hand-written CUDA
kernels built from ``repro_torch/csrc`` on first use.  Entry points run on
the card: with no CUDA device, dispatch raises unless the caller pins the
``numpy`` or ``torch`` backend (``ops.backend_override``, ``backend=`` or the
``REPRO_TORCH_OPS_BACKEND`` environment variable).  Imports ``torch`` and
numpy only — never ``jax`` or ``repro``.
"""
from . import configs, core, data, ops, trees

__all__ = ["configs", "core", "data", "ops", "trees"]
