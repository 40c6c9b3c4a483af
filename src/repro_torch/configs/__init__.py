"""Configurations: the paper's signal-tree config (``CONFIG``) and the LM
arch pool with its registry, copies of the reference's dataclasses."""
from .base import ArchConfig
from .registry import ARCHS, SHAPES, get_arch, get_shape, runnable_cells
from .shapes import input_specs, reduced_config
from .signal_tree import CONFIG, SignalTreeConfig

__all__ = ["CONFIG", "SignalTreeConfig", "ArchConfig", "ARCHS", "SHAPES",
           "get_arch", "get_shape", "runnable_cells", "input_specs",
           "reduced_config"]
