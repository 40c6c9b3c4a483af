"""Model assembly: init / forward / prefill / decode for the dense GQA
decoder (qwen2, yi, phi3, granite):

  [norm -> attention -> norm -> SwiGLU] x L, final norm, logits head

The reference scans one stacked layer body over a leading L axis; here the
layers are a Python list of per-layer parameter dicts, run in a loop (so
the reference's ``unroll``, a dry-run costing switch that turns its scans
into loops, has no counterpart).  With ``cfg.remat``, a layer whose input
autograd tracks runs through ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` on its scanned body); a serving prefill tracks nothing
and runs every layer plainly, at no cost.  The KV cache keeps the
reference's stacked layout ``(L, B, Hkv, S, hd)`` and is written in place
by ``decode_step`` (the returned cache is the same object, its position
advanced), which saves a copy of the cache per token.

The MoE, MLA, SSM, hybrid, audio and vision branches of the reference raise
``NotImplementedError`` naming the slice of the port they wait for.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..tree import tree_map
from . import attention as attn
from .layers import (embed, init_embed, init_linear, init_rmsnorm, init_swiglu,
                     linear, rms_norm, swiglu, torch_dtype)

__all__ = ["init_params", "embed_inputs", "forward", "prefill", "init_cache",
           "decode_step", "cast_params", "Model"]

# the later slices of the port, by what the reference's branch needs
_LATER = {"moe": "MoE/MLA", "mla": "MoE/MLA", "ssm": "SSM", "hybrid": "SSM",
          "audio": "audio/vision frontend", "vlm": "audio/vision frontend"}


def _check_ported(cfg) -> None:
    kind = ("mla" if cfg.is_mla else "moe" if cfg.is_moe else
            cfg.family if cfg.family in _LATER else None)
    if kind is not None:
        raise NotImplementedError(
            f"{cfg.name} ({kind}) is not ported yet: it comes with the port's "
            f"{_LATER[kind]} slice (ROADMAP.md); the dense GQA decoder runs")


# ================================================================== layer init
def _init_layer(gen: torch.Generator, cfg) -> dict:
    dt = torch_dtype(cfg)
    return {"ln1": init_rmsnorm(cfg.d_model, dt, gen.device),
            "attn": attn.init_gqa(gen, cfg),
            "ln2": init_rmsnorm(cfg.d_model, dt, gen.device),
            "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dt)}


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights on ``gen``'s device, drawn from ``gen``."""
    _check_ported(cfg)
    dt = torch_dtype(cfg)
    return {"embed": init_embed(gen, cfg.vocab, cfg.d_model, dt),
            "head": init_linear(gen, cfg.d_model, cfg.vocab, dt,
                                scale=cfg.d_model ** -0.5),
            "layers": [_init_layer(gen, cfg) for _ in range(cfg.n_layers)],
            "final_ln": init_rmsnorm(cfg.d_model, dt, gen.device)}


def cast_params(params, dtype: torch.dtype):
    """The same parameter tree with every tensor in ``dtype``."""
    return tree_map(lambda t: t.to(dtype), params)


# ================================================================ embeddings
def embed_inputs(cfg, params, batch: dict) -> torch.Tensor:
    """batch {"tokens": (B, L) ints} -> (B, L, d) hidden states."""
    _check_ported(cfg)
    return embed(params["embed"], batch["tokens"])


# ==================================================================== forward
def _layer_apply(cfg, lp, x, positions, attn_impl):
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(lp["attn"], cfg, h, positions, attn_impl)
    h2 = rms_norm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2)


def forward(cfg, params, batch: dict, attn_impl: str | None = None,
            return_hidden: bool = False) -> tuple:
    """-> (logits, aux_loss), or (hidden, aux_loss) with return_hidden=True:
    the hidden states after the final norm, which training feeds to a
    chunked cross-entropy so that the (B, L, V) logits never exist at once.
    ``attn_impl`` None runs the flash-attention kernel on the card and
    raises without one; ``"torch"`` pins the plain attention, the one that
    trains (the kernel has no backward)."""
    attn_impl = attn.resolve_attn_impl(attn_impl)
    x = embed_inputs(cfg, params, batch)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    for lp in params["layers"]:
        if cfg.remat and x.requires_grad:
            x = torch.utils.checkpoint.checkpoint(
                _layer_apply, cfg, lp, x, positions, attn_impl, use_reentrant=False)
        else:
            x = _layer_apply(cfg, lp, x, positions, attn_impl)
    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return linear(params["head"], x), aux


# ===================================================================== decode
def init_cache(cfg, batch_size: int, max_len: int, device=None) -> dict:
    """Stacked KV cache ``{"layers": {"k", "v"}: (L, B, Hkv, max_len, hd),
    "pos": 0}``."""
    _check_ported(cfg)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.hd)
    dt = torch_dtype(cfg)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)},
            "pos": 0}


def decode_step(cfg, params, cache: dict, batch: dict) -> tuple:
    """One new token for every sequence. batch["tokens"]: (B, 1).  Returns
    (logits, cache): the cache is written in place at its position, which
    advances by one."""
    x = embed_inputs(cfg, params, batch)
    pos = cache["pos"]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(lp["ln1"], x, cfg.norm_eps)
        y, _ = attn.gqa_decode(lp["attn"], cfg, h, {"k": ck[i], "v": cv[i]}, pos)
        x = x + y
        x = x + swiglu(lp["mlp"], rms_norm(lp["ln2"], x, cfg.norm_eps))
    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return linear(params["head"], x), cache


def prefill(cfg, params, batch: dict, attn_impl: str | None = None):
    """Prefill = forward pass producing logits (cache omitted, as in the
    reference: decode builds its own)."""
    return forward(cfg, params, batch, attn_impl)


class Model:
    """Convenience OO wrapper over the functional API."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, gen: torch.Generator):
        return init_params(self.cfg, gen)

    def apply(self, params, batch, attn_impl: str | None = None):
        return forward(self.cfg, params, batch, attn_impl)

    def decode(self, params, cache, batch):
        return decode_step(self.cfg, params, cache, batch)

    def init_cache(self, batch_size: int, max_len: int, device=None):
        return init_cache(self.cfg, batch_size, max_len, device)
