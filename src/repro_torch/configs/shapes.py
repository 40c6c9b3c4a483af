"""``reduced_config``: the CPU-test-sized variant of an arch, a copy of the
reference's ``configs/shapes.py::reduced_config``.  ``input_specs`` (the
dry-run's abstract inputs) comes with the dry-run."""
from __future__ import annotations

import dataclasses

from .base import ArchConfig

__all__ = ["reduced_config"]


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """CPU-smoke-test-sized variant of the same family: tiny widths/layers,
    few experts, small vocab — same code paths."""
    small = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(max(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 1), 4),
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32 if cfg.head_dim else 0,
    )
    if cfg.is_moe:
        small.update(n_experts=4, moe_top_k=2, d_ff_expert=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.is_mla:
        # v_head_dim deliberately != qk_nope+qk_rope (catches mixed-head-dim
        # attention bugs, as in the full DeepSeek config: 128 vs 192)
        small.update(kv_lora_rank=32, q_lora_rank=48 if cfg.q_lora_rank else 0,
                     qk_rope_dim=16, qk_nope_dim=16, v_head_dim=48)
    if cfg.is_ssm:
        small.update(ssm_state=min(cfg.ssm_state, 16), ssm_chunk=16,
                     mamba_headdim=16)
    if cfg.attn_every:
        small.update(attn_every=2)
    if cfg.n_patches:
        small.update(n_patches=8)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
