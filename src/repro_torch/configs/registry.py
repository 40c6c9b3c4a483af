"""Architecture registry (one module per assigned arch) + input shapes; a
copy of the reference's ``configs/registry.py``."""
from __future__ import annotations

from .base import ArchConfig
from . import (deepseek_v2_236b, falcon_mamba_7b, granite_20b, musicgen_medium,
               phi3_medium_14b, pixtral_12b, qwen2_0p5b, qwen3_moe_235b,
               yi_9b, zamba2_1p2b)

__all__ = ["ARCHS", "get_arch", "SHAPES", "get_shape", "runnable_cells"]


ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (pixtral_12b, zamba2_1p2b, qwen2_0p5b, yi_9b, phi3_medium_14b,
              granite_20b, deepseek_v2_236b, qwen3_moe_235b, falcon_mamba_7b,
              musicgen_medium)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


# -------------------------------------------------------------------- shapes
SHAPES: dict[str, dict] = {
    # kind: train -> train_step; prefill -> serve prefill; decode -> serve_step
    "train_4k":    {"kind": "train",   "seq_len": 4096,    "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768,   "global_batch": 32},
    "decode_32k":  {"kind": "decode",  "seq_len": 32768,   "global_batch": 128},
    "long_500k":   {"kind": "decode",  "seq_len": 524288,  "global_batch": 1},
}

# long_500k needs sub-quadratic sequence mixing: run only for SSM/hybrid
# (full-attention archs are skipped per the brief; see DESIGN.md §5).
_LONG_OK = ("ssm", "hybrid")


def get_shape(name: str) -> dict:
    return dict(SHAPES[name], name=name)


def runnable_cells() -> list[tuple[str, str, bool]]:
    """All 40 (arch, shape) cells with a runnable flag (long_500k skips)."""
    cells = []
    for a, cfg in ARCHS.items():
        for s in SHAPES:
            ok = (s != "long_500k") or (cfg.family in _LONG_OK)
            cells.append((a, s, ok))
    return cells
