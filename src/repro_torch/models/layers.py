"""Foundational layers: norms, RoPE, MLPs, embeddings, logits.

Plain functions over parameter dicts of tensors, as in the reference
(``repro.models.layers``), with the reference's dtype promotions: ``rms_norm``
and ``rope`` compute in float32 and return the input's dtype, ``linear``'s
product and bias stay in the inputs' dtype.  Initializers take a
``torch.Generator`` and create their tensors on its device; a weight
``(d_in, *d_out)`` of the reference is stored flattened as
``(d_in, prod(d_out))`` (and its bias as ``(prod(d_out),)``), which is the
matrix the reference multiplies by.  ``linear`` returns the flat
``(..., prod(d_out))``; the logits head goes through ``unembed``, which
gives back the reference's trailing dims (musicgen's ``(n_codebooks,
vocab)``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "rope", "swiglu", "init_linear", "init_rmsnorm",
           "init_swiglu", "linear", "embed", "unembed", "head_shape",
           "init_embed", "truncated_normal", "torch_dtype"]


def torch_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def head_shape(cfg) -> tuple:
    """The logits' trailing dims: ``(n_codebooks, vocab)`` for the audio
    frontend (one head a codebook), ``(vocab,)`` otherwise."""
    if cfg.frontend == "audio_codebooks":
        return (cfg.n_codebooks, cfg.vocab)
    return (cfg.vocab,)


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """scale x a standard normal truncated to [-2, 2], drawn in float32."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.is_meta:   # shapes only (``param_shapes``): nothing to draw
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


# ------------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype: torch.dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., L, D) with D even; positions: (..., L) int."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs                # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- linears
def init_linear(gen: torch.Generator, d_in: int, d_out, dtype: torch.dtype,
                bias: bool = False, scale: float | None = None) -> dict:
    n_out = math.prod(d_out) if isinstance(d_out, (tuple, list)) else d_out
    p = {"w": truncated_normal(gen, (d_in, n_out), scale or (d_in ** -0.5), dtype)}
    if bias:
        p["b"] = torch.zeros((n_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) -> (..., d_out) flattened; callers reshape heads."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# ------------------------------------------------------------------- MLPs
def init_swiglu(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {"wi": init_linear(gen, d, d_ff, dtype),
            "wg": init_linear(gen, d, d_ff, dtype),
            "wo": init_linear(gen, d_ff, d, dtype, scale=d_ff ** -0.5)}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["wo"], torch.nn.functional.silu(linear(p["wg"], x))
                  * linear(p["wi"], x))


# ------------------------------------------------------- embedding / logits
def init_embed(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> dict:
    return {"table": truncated_normal(gen, (vocab, d), 1.0, dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    # the rows ``table[tokens]``; through ``embedding``, whose backward sums
    # a repeated token's rows in one fixed order (indexing's backward,
    # index_put_ with accumulate, sums them in a thread-dependent order on
    # the CPU), so a replayed training step gives the same bits
    return torch.nn.functional.embedding(tokens.long(), p["table"])


def unembed(p: dict, x: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """The logits head: x (..., d) -> (..., *out_shape), the reference's
    ``linear`` keeping the weight's output dims (the weight stays flat)."""
    return linear(p, x).reshape(*x.shape[:-1], *out_shape)
