"""Input specs, the dry run's abstract inputs for every (arch x shape)
cell, and ``reduced_config``, the CPU-test-sized variant of an arch: the
reference's ``configs/shapes.py``.

``input_specs`` gives meta-device tensors where the reference has
``ShapeDtypeStruct``s (a shape and a dtype, no storage).  Frontends are
stubs as there: pixtral gets precomputed patch embeddings, musicgen a
(B, L, n_codebooks) token grid.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ArchConfig
from .registry import get_shape

__all__ = ["input_specs", "reduced_config"]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name) -> dict:
    """Meta tensors for the cell's entry point (``shape_name`` a shape's
    name, or a shape's dict of ``kind``, ``seq_len`` and ``global_batch``).

    train:   {"tokens", "targets"} full-sequence batches
    prefill: {"tokens"} full-sequence batch
    decode:  {"tokens"} single-token batch (cache is built separately)
    """
    sh = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    B, L = sh["global_batch"], sh["seq_len"]
    i32 = torch.int32
    tok_len = 1 if sh["kind"] == "decode" else L

    if cfg.frontend == "audio_codebooks":
        toks = _spec((B, tok_len, cfg.n_codebooks), i32)
    elif cfg.frontend == "vision_stub" and sh["kind"] != "decode":
        # patch embeddings replace the first n_patches positions
        text_len = max(tok_len - cfg.n_patches, 1)
        return {
            "patch_embeds": _spec((B, cfg.n_patches, cfg.d_model), torch.bfloat16),
            "tokens": _spec((B, text_len), i32),
            **({"targets": _spec((B, cfg.n_patches + text_len), i32)}
               if sh["kind"] == "train" else {}),
        }
    else:
        toks = _spec((B, tok_len), i32)

    specs = {"tokens": toks}
    if sh["kind"] == "train":
        specs["targets"] = _spec(toks.shape, i32)
    return specs


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
