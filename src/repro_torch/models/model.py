"""Model assembly: init / forward / prefill / decode for the dense GQA
decoder (qwen2, yi, phi3, granite, and behind their frontends pixtral and
musicgen), the MoE families and the state-space families:

  dense/vlm/audio:  [norm -> attention -> norm -> SwiGLU] x L
  moe (incl. MLA):  [norm -> GQA|MLA -> norm -> MoE] x L       (qwen3-moe,
                    deepseek-v2)
  ssm (falcon):     [norm -> Mamba1] x L                       (no MLP)
  hybrid (zamba2):  [norm -> Mamba2] x L, with one *shared* GQA block
                    (its own norm) after every cfg.attn_every-th layer

then a final norm and the logits head.

The reference scans one stacked layer body over a leading L axis; here the
layers are a Python list of per-layer parameter dicts, run in a loop (so
the reference's ``unroll``, a dry-run costing switch that turns its scans
into loops, has no counterpart).  With ``cfg.remat``, a layer whose input
autograd tracks runs through ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` on its scanned body); a serving prefill tracks nothing
and runs every layer plainly, at no cost.  The KV cache keeps the
reference's stacked layout ``(L, B, Hkv, S, hd)`` (MLA's the compressed
``c_kv`` (L, B, S, kv_lora) and ``k_rope`` (L, B, S, dr)), and the SSM
cache its ``(L, B, W-1, d_inner)`` conv windows and float32 states
(``h`` for Mamba1, ``S`` for Mamba2; the hybrid's shared block a KV cache
of one slot an application); ``decode_step`` writes all of them in place
(the returned cache is the same object, its position advanced), which
saves a copy of the cache per token.

``forward`` returns the sum of the MoE layers' aux losses (0 for the
other families), which the training loss adds.  The modality frontends are
the reference's stubs: pixtral (``vision_stub``) takes precomputed patch
embeddings ``"patch_embeds"`` (B, P, d) before its text tokens, musicgen
(``audio_codebooks``) (B, L, C) codebook tokens whose C embeddings are
summed, and its logits come out (..., C, vocab), one head a codebook.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..tree import tree_map
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import (embed, head_shape, init_embed, init_linear, init_rmsnorm,
                     init_swiglu, rms_norm, swiglu, torch_dtype, truncated_normal,
                     unembed)

__all__ = ["init_params", "embed_inputs", "forward", "prefill", "init_cache",
           "decode_step", "cast_params", "param_shapes", "Model"]

# ================================================================== layer init
def _init_layer(gen: torch.Generator, cfg) -> dict:
    dt = torch_dtype(cfg)
    p = {"ln1": init_rmsnorm(cfg.d_model, dt, gen.device)}
    if cfg.is_ssm:
        init = ssm.init_mamba1 if cfg.mamba_version == 1 else ssm.init_mamba2
        p["mixer"] = init(gen, cfg)
        return p
    p["attn"] = attn.init_mla(gen, cfg) if cfg.is_mla else attn.init_gqa(gen, cfg)
    p["ln2"] = init_rmsnorm(cfg.d_model, dt, gen.device)
    p["mlp"] = (moe_mod.init_moe(gen, cfg) if cfg.is_moe
                else init_swiglu(gen, cfg.d_model, cfg.d_ff, dt))
    return p


def _has_shared(cfg) -> bool:
    return cfg.family == "hybrid" and cfg.attn_every > 0


def _shared_after(cfg, i: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``i``."""
    return _has_shared(cfg) and (i + 1) % cfg.attn_every == 0


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights on ``gen``'s device, drawn from ``gen``.  The audio
    frontend's embedding is a (C, vocab, d) table, a codebook a slice, and
    its head a (d, C·vocab) matrix."""
    dt = torch_dtype(cfg)
    if cfg.frontend == "audio_codebooks":
        emb = {"table": truncated_normal(gen, (cfg.n_codebooks, cfg.vocab, cfg.d_model),
                                         1.0, dt)}
    else:
        emb = init_embed(gen, cfg.vocab, cfg.d_model, dt)
    p = {"embed": emb,
         "head": init_linear(gen, cfg.d_model, head_shape(cfg), dt,
                             scale=cfg.d_model ** -0.5),
         "layers": [_init_layer(gen, cfg) for _ in range(cfg.n_layers)]}
    if _has_shared(cfg):
        p["shared_attn"] = attn.init_gqa(gen, cfg)
        p["shared_ln"] = init_rmsnorm(cfg.d_model, dt, gen.device)
    p["final_ln"] = init_rmsnorm(cfg.d_model, dt, gen.device)
    return p


class _MetaDraws:
    """``init_params``'s generator for ``param_shapes``: its device is the
    meta device, where the init makes tensors of a shape and a dtype and
    draws nothing."""
    device = torch.device("meta")


def param_shapes(cfg) -> dict:
    """``init_params``'s tree on the meta device: each leaf's shape and
    dtype without storage, at any size (the reference's
    ``jax.eval_shape(lambda: init_params(cfg, key))``)."""
    return init_params(cfg, _MetaDraws())


def cast_params(params, dtype: torch.dtype):
    """The same parameter tree with every tensor in ``dtype``."""
    return tree_map(lambda t: t.to(dtype), params)


# ================================================================ embeddings
def embed_inputs(cfg, params, batch: dict) -> torch.Tensor:
    """batch -> (B, L, d) hidden states.  ``{"tokens": (B, L) ints}``; for
    the audio frontend (B, L, C) codebook tokens, their C embeddings
    summed; for the vision frontend an optional ``"patch_embeds"`` (B, P,
    d), cast to the text's dtype and put before its (B, Lt) tokens' (a
    decode step carries none), so that L = P + Lt."""
    if cfg.frontend == "audio_codebooks":
        return _codebook_embed(params["embed"]["table"], batch["tokens"])
    x = embed(params["embed"], batch["tokens"])
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        return torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def _codebook_embed(table: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """table (C, V, d), toks (B, L, C) -> the sum over c of
    ``table[c][toks[..., c]]``, added c = 0, 1, ... in the table's dtype as
    the reference's ``sum`` does (so the bf16 sums are its op-by-op bits)."""
    x = embed({"table": table[0]}, toks[..., 0])
    for c in range(1, table.shape[0]):
        x = x + embed({"table": table[c]}, toks[..., c])
    return x


# ==================================================================== forward
def _mlp(cfg, lp, h):
    """The layer's MLP on its normed input: (y, aux), aux None but for MoE."""
    if cfg.is_moe:
        return moe_mod.moe_forward(lp["mlp"], cfg, h)
    return swiglu(lp["mlp"], h), None


def _layer_apply(cfg, lp, x, positions, attn_impl, shared=None):
    """One layer, then the hybrid's shared block where ``shared`` (its
    ``{"attn", "ln"}`` parameters) is given.  Returns (x, the layer's aux
    loss or None)."""
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    aux = None
    if cfg.is_ssm:
        mix = ssm.mamba1_forward if cfg.mamba_version == 1 else ssm.mamba2_forward
        x = x + mix(lp["mixer"], cfg, h)
    else:
        mix = attn.mla_forward if cfg.is_mla else attn.gqa_forward
        x = x + mix(lp["attn"], cfg, h, positions, attn_impl)
        y, aux = _mlp(cfg, lp, rms_norm(lp["ln2"], x, cfg.norm_eps))
        x = x + y
    if shared is not None:
        h = rms_norm(shared["ln"], x, cfg.norm_eps)
        x = x + attn.gqa_forward(shared["attn"], cfg, h, positions, attn_impl)
    return x, aux


def forward(cfg, params, batch: dict, attn_impl: str | None = None,
            return_hidden: bool = False) -> tuple:
    """-> (logits, aux_loss), or (hidden, aux_loss) with return_hidden=True:
    the hidden states after the final norm, which training feeds to a
    chunked cross-entropy so that the (B, L, V) logits never exist at once;
    aux_loss is the sum of the MoE layers' (a float32 0 for the others).
    ``attn_impl`` None runs the flash-attention kernel on the card and
    raises without one; ``"torch"`` pins the plain attention, the one that
    trains (the kernel has no backward), and the only one MLA runs."""
    attn_impl = attn.resolve_attn_impl(attn_impl)
    x = embed_inputs(cfg, params, batch)
    B, L, _ = x.shape
    positions = torch.arange(L, device=x.device)[None].expand(B, L)
    shared = ({"attn": params["shared_attn"], "ln": params["shared_ln"]}
              if _has_shared(cfg) else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        sh = shared if _shared_after(cfg, i) else None
        if cfg.remat and x.requires_grad:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer_apply, cfg, lp, x, positions, attn_impl, sh, use_reentrant=False)
        else:
            x, a = _layer_apply(cfg, lp, x, positions, attn_impl, sh)
        if a is not None:
            aux = aux + a
    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return unembed(params["head"], x, head_shape(cfg)), aux


# ===================================================================== decode
def _kv(cfg, n: int, batch_size: int, max_len: int, device) -> dict:
    shape = (n, batch_size, cfg.n_kv_heads, max_len, cfg.hd)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg, batch_size: int, max_len: int, device=None) -> dict:
    """Stacked cache ``{"layers": ..., "pos": 0}``: the KV cache
    ``{"k", "v"}: (L, B, Hkv, max_len, hd)``; MLA's compressed cache
    ``{"c_kv": (L, B, max_len, kv_lora), "k_rope": (L, B, max_len, dr)}``
    in the model's dtype; for the SSM families the
    conv windows ``"conv"`` (L, B, W-1, d_inner) in the model's dtype and
    the float32 states ``"h"`` (L, B, d_inner, s) (Mamba1) or ``"S"``
    (L, B, H, s, P) (Mamba2), and the hybrid's ``"shared"`` KV cache of
    ``n_layers // attn_every`` slots."""
    if cfg.is_mla:
        dt = dict(dtype=torch_dtype(cfg), device=device)
        shape = (cfg.n_layers, batch_size, max_len)
        return {"layers": {"c_kv": torch.zeros(shape + (cfg.kv_lora_rank,), **dt),
                           "k_rope": torch.zeros(shape + (cfg.qk_rope_dim,), **dt)},
                "pos": 0}
    if not cfg.is_ssm:
        return {"layers": _kv(cfg, cfg.n_layers, batch_size, max_len, device), "pos": 0}
    L, B = cfg.n_layers, batch_size
    f32 = dict(dtype=torch.float32, device=device)
    layer = {"conv": torch.zeros((L, B, cfg.ssm_conv - 1, cfg.d_inner),
                                 dtype=torch_dtype(cfg), device=device)}
    if cfg.mamba_version == 1:
        layer["h"] = torch.zeros((L, B, cfg.d_inner, cfg.ssm_state), **f32)
    else:
        layer["S"] = torch.zeros((L, B, cfg.ssm_heads, cfg.ssm_state,
                                  cfg.mamba_headdim), **f32)
    cache = {"layers": layer, "pos": 0}
    if _has_shared(cfg):
        cache["shared"] = _kv(cfg, cfg.n_layers // cfg.attn_every, B, max_len, device)
    return cache


def decode_step(cfg, params, cache: dict, batch: dict) -> tuple:
    """One new token for every sequence. batch["tokens"]: (B, 1), or
    (B, 1, C) for the audio frontend.  Returns (logits, cache): logits
    (B, 1, vocab), or (B, 1, C, vocab); the cache is written in place (the
    KV caches at its position, the SSM windows and states whole), and its
    position advances by one."""
    x = embed_inputs(cfg, params, batch)
    pos = cache["pos"]
    layers = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(lp["ln1"], x, cfg.norm_eps)
        if cfg.is_ssm:
            mix = ssm.mamba1_decode if cfg.mamba_version == 1 else ssm.mamba2_decode
            y, _ = mix(lp["mixer"], cfg, h, {k: t[i] for k, t in layers.items()})
            x = x + y
        else:
            dec = attn.mla_decode if cfg.is_mla else attn.gqa_decode
            y, _ = dec(lp["attn"], cfg, h, {k: t[i] for k, t in layers.items()}, pos)
            x = x + y
            x = x + _mlp(cfg, lp, rms_norm(lp["ln2"], x, cfg.norm_eps))[0]
        if _shared_after(cfg, i):
            si = (i + 1) // cfg.attn_every - 1
            sc = cache["shared"]
            h = rms_norm(params["shared_ln"], x, cfg.norm_eps)
            y, _ = attn.gqa_decode(params["shared_attn"], cfg, h,
                                   {"k": sc["k"][si], "v": sc["v"][si]}, pos)
            x = x + y
    x = rms_norm(params["final_ln"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return unembed(params["head"], x, head_shape(cfg)), cache


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
