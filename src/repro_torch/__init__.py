"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same subpackage names as the reference (``core``, ``data``, ``ops``,
``kernels``, ``trees``, ``configs``, ``models``, ``train``, ``checkpoint``,
``runtime``, ``launch``, ``sharding``); the hot ops
run as hand-written CUDA kernels built from ``repro_torch/csrc`` on first
use.  Entry points run on the card: with no CUDA device, dispatch raises
unless the caller pins the ``numpy`` or ``torch`` backend
(``ops.backend_override``, ``backend=`` or the ``REPRO_TORCH_OPS_BACKEND``
environment variable), and the LM path raises unless it is given
``attn_impl="torch"`` (``models``) or ``--device cpu`` (``launch.serve``,
``launch.train``); training runs the plain attention, which the kernel
(forward only) leaves to autograd.
Imports ``torch`` and numpy only — never ``jax`` or ``repro``.
"""
from . import (checkpoint, configs, core, data, launch, models, obs, ops,
               runtime, sharding, train, trees)

__all__ = ["checkpoint", "configs", "core", "data", "launch", "models", "obs",
           "ops", "runtime", "sharding", "train", "trees"]
