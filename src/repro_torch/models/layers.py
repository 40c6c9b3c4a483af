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
           "init_embed", "truncated_normal", "torch_dtype", "settle",
           "on_shards", "keep_shards"]


class _GradAt(torch.autograd.Function):
    """The identity, whose backward puts the gradient on ``placements``."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def settle(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """In a partitioned step (DTensors), ``y`` redistributed onto ``like``'s
    placements, and its gradient too: the hidden states and their gradients
    kept where the batch rows are, whole over the other mesh dims (the sum
    of a row-parallel product's partial sums, Megatron's all-reduce), so
    that the partitioner never cuts them another way; plain tensors as they
    are."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return y
    if y.placements != like.placements:
        y = y.redistribute(like.device_mesh, like.placements)
    return _GradAt.apply(y, tuple(like.placements)) if y.requires_grad else y


def on_shards(fn, args: tuple, in_placements: tuple, out_placements,
              grad_placements: tuple):
    """``fn`` on each rank's local blocks of DTensor ``args``
    (``local_map``): the args redistributed onto ``in_placements`` first,
    the result a DTensor of ``out_placements``, each arg's gradient one of
    its ``grad_placements`` (``Partial`` where the ranks' local gradients
    are parts of a sum).  One output's placements are a list; several
    outputs', a tuple of one tuple each.  For a step a mesh dim cuts in a
    way DTensor's own rules would gather or mis-shard (a loop over a
    sharded dim, a sort, a scan)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements,
                     device_mesh=args[0].device_mesh, redistribute_inputs=True)(*args)


def keep_shards(t: torch.Tensor, dims) -> tuple:
    """``t``'s placements with a ``Shard`` of a dim in ``dims`` kept and
    every other placement ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in t.placements)


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
    """x (..., d_in) -> (..., d_out) flattened; callers reshape heads.  A
    weight held in its reference view ``(d_in, H, hd)`` (a partitioned
    state's, where the mesh cuts ``hd``; its bias ``(H, hd)``) gives
    ``(..., H, hd)``: one product a head, so that the cut dim is never
    merged with another."""
    w = p["w"]
    if w.dim() == 3:
        y = _heads_linear(x, w)
    else:
        y = torch.matmul(x, w)
    if "b" in p:
        y = y + p["b"]
    return y


def _heads_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) times w (d, H, hd) -> (..., H, hd), as H products of
    (N, d) by (d, hd)."""
    lead, d = x.shape[:-1], x.shape[-1]
    H = w.shape[1]
    x2 = x.reshape(-1, d)
    y = torch.bmm(x2.unsqueeze(0).expand(H, *x2.shape), w.permute(1, 0, 2))
    return y.permute(1, 0, 2).reshape(*lead, H, w.shape[2])


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
    from torch.distributed.tensor import DTensor
    if isinstance(p["table"], DTensor):
        return _embed_partitioned(p["table"], tokens)
    return torch.nn.functional.embedding(tokens.long(), p["table"])


class SumOverGroup(torch.autograd.Function):
    """The sum of a tensor over a process group whose ranks then all use it
    alike: the backward passes the gradient through as it is (each rank's
    share of the sum has the gradient of the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _embed_partitioned(table, tokens):
    """``embed`` of a DTensor table whose vocab (dim 0) a mesh dim may cut:
    each rank looks up the tokens in its block of rows (zeros for the
    others') and the lookups are summed over the ranks that cut the vocab,
    so that the rows come out whole where the tokens are."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    cut = [i for i, pl in enumerate(table.placements)
           if isinstance(pl, Shard) and pl.dim == 0]
    if len(cut) > 1:
        raise NotImplementedError("a vocab cut over more than one mesh dim")

    def local(tl, tok):
        tok = tok.long()
        if not cut:
            return torch.nn.functional.embedding(tok, tl)
        V = tl.shape[0]
        t = tok - mesh.get_local_rank(cut[0]) * V
        hit = (t >= 0) & (t < V)
        rows = torch.nn.functional.embedding(t.clamp(0, V - 1), tl)
        return SumOverGroup.apply(torch.where(hit[..., None], rows, 0),
                                  mesh.get_group(cut[0]))

    rows = [i for i, pl in enumerate(tokens.placements) if isinstance(pl, Shard)]
    out = tuple(pl if isinstance(pl, Shard) else Replicate() for pl in tokens.placements)
    t_grad = tuple(Partial() if i in rows else pl for i, pl in enumerate(table.placements))
    return on_shards(local, (table, tokens), (table.placements, tokens.placements),
                     list(out), (t_grad, tokens.placements))


def unembed(p: dict, x: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """The logits head: x (..., d) -> (..., *out_shape), the reference's
    ``linear`` keeping the weight's output dims (the weight stays flat)."""
    return linear(p, x).reshape(*x.shape[:-1], *out_shape)
