"""Mixture-of-Experts: top-k routing with capacity, sort-based dispatch.

The reference's layer (``repro.models.moe``): the router runs in float32,
picks each token's ``moe_top_k`` experts and renormalises their gates; the
picks are sorted by expert (a *stable* sort, so that over capacity the
assignments that drop are the reference's: the later tokens of an
expert's run), placed into an (E, C, d) buffer, run through a batched
expert SwiGLU, and gathered back weighted by their gates.  The aux
load-balancing loss is Switch/GShard's, ``coef · E · Σ_e f_e · p̄_e``.

Dispatch runs in groups, one a data-parallel shard of the mesh the caller
passes (G = pod x data, halved until it divides the tokens, as in the
reference's ``_dispatch_groups``): each group of ``Tg`` contiguous tokens
sorts and places its own picks, at a capacity ``max(int(Tg·k·cf/E), 4)``
an expert, while the aux loss's ``f`` and ``p̄`` are taken over all the
tokens.  Without a mesh G is 1, as the reference's is without one.

``combine`` sums each token's contributions in the reference's order: its
scatter-add visits the sorted picks in turn, so a token's ``top_k`` rows
add from zeros in ascending expert id, each add rounded to the model's
dtype.  Here they are gathered as (T, top_k, d) in that order and added one
at a time, which gives the same bits on the CPU and the card (an
``index_add_`` of bfloat16 rows runs in atomics on the card, whose order
changes from run to run).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import init_swiglu, on_shards, swiglu, torch_dtype, truncated_normal

__all__ = ["init_moe", "moe_forward", "dispatch_groups"]


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = torch_dtype(cfg)
    p = {"router": {"w": truncated_normal(gen, (d, E), d ** -0.5, torch.float32)},
         "wi": truncated_normal(gen, (E, d, dff), d ** -0.5, dt),
         "wg": truncated_normal(gen, (E, d, dff), d ** -0.5, dt),
         "wo": truncated_normal(gen, (E, dff, d), dff ** -0.5, dt)}
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(gen, d, cfg.n_shared_experts * dff, dt)
    return p


def capacity(cfg, T: int) -> int:
    """Slots an expert for ``T`` tokens in a group."""
    return max(int(T * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts), 4)


def dispatch(x: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
             E: int, C: int):
    """One group's sort-by-expert and capacity placement, the reference's
    ``dispatch_one``.  x: (T, d); experts, gates: (T, top_k).  Returns the
    (E, C, d) buffer and ``(slot, t_s, g_s, keep)`` over the picks in the
    sorted order: each pick's slot ``e · C + pos`` (``e · C`` where it
    drops), its token, its gate and whether it is within capacity."""
    T, k = experts.shape
    dev = x.device
    flat_e = experts.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_s, g_s, t_s = flat_e[order], gates.reshape(-1)[order], flat_t[order]
    # each expert's first sorted position (the reference's cumsum of the
    # counts less the counts), found in the sorted picks: no count goes to
    # the host, so dispatch never waits for the card
    starts = torch.searchsorted(e_s, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[e_s]
    keep = pos < C
    slot = e_s * C + torch.where(keep, pos, 0)
    # the dropped picks go to one extra row, cut off below (the reference
    # adds zeros into their slot e·C, which leaves it as it is)
    buf = torch.zeros((E * C + 1, x.shape[-1]), dtype=x.dtype, device=dev)
    buf = buf.index_copy(0, torch.where(keep, slot, E * C), x[t_s])
    return buf[:E * C].reshape(E, C, -1), (slot, t_s, g_s, keep)


def combine(y: torch.Tensor, meta, T: int, first: int | None = None) -> torch.Tensor:
    """The reference's ``combine_one``: each kept pick's expert output times
    its gate (in ``y``'s dtype), summed a token at a time in ascending
    expert id.  y: (E, C, d); ``meta`` from ``dispatch``.  Returns (T, d).
    ``first``: ``y`` holds experts ``first .. first + E - 1`` only (a rank's
    block of them), and the sum is of their picks only."""
    slot, t_s, g_s, keep = meta
    E, C, d = y.shape
    if first is not None:
        slot = slot - first * C
        keep = keep & (slot >= 0) & (slot < E * C)
        slot = slot.clamp(0, E * C - 1)
    contrib = torch.where(keep[:, None],
                          y.reshape(E * C, d)[slot] * g_s[:, None].to(y.dtype), 0)
    k = slot.numel() // T
    # a stable sort by token keeps each token's picks in expert order
    by_token = contrib[torch.argsort(t_s, stable=True)].reshape(T, k, d)
    out = torch.zeros((T, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + by_token[:, j]
    return out


def route(p: dict, cfg, xt: torch.Tensor):
    """The float32 router on (T, d) tokens: (probs (T, E), gates and experts
    (T, top_k), the gates renormalised)."""
    probs = torch.softmax(torch.matmul(xt.float(), p["router"]["w"]), dim=-1)
    gates, experts = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def dispatch_groups(mesh, T: int) -> int:
    """The dispatch groups for ``T`` tokens on ``mesh`` (a ``DeviceMesh``,
    an ``AbstractMesh`` or None): its pod x data shards, halved until they
    divide T."""
    G = 1
    if mesh is not None:
        names = getattr(mesh, "mesh_dim_names", None)
        sizes = (dict(zip(names, mesh.shape)) if names is not None
                 else dict(mesh.shape))
        G = max(sizes.get("pod", 1) * sizes.get("data", 1), 1)
    while T % G:
        G //= 2
    return max(G, 1)


def _experts(p: dict, h: torch.Tensor) -> torch.Tensor:
    """The batched expert SwiGLU on (E, N, d) rows."""
    y = torch.bmm(h, p["wi"]) * F.silu(torch.bmm(h, p["wg"]))
    return torch.bmm(y, p["wo"])


def _moe_partitioned(p: dict, cfg, x, G: int):
    """``moe_forward`` of DTensor hidden states whose rows the data axes cut:
    each rank sorts and places its own groups' picks (``dispatch`` and
    ``combine`` on its blocks, no gather), the experts' product runs where
    the expert weights are (the "model" axis cuts the experts), and the aux
    loss takes its counts and mean probabilities over every rank's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    B, L, d = x.shape
    E, topk = cfg.n_experts, cfg.moe_top_k
    T = B * L
    xt = x.reshape(T, d)
    mesh = xt.device_mesh
    rows = tuple(pl if pl == Shard(0) else Replicate() for pl in xt.placements)
    n_rows = math.prod(mesh.size(i) for i, pl in enumerate(rows) if pl == Shard(0))
    if G % n_rows:
        raise NotImplementedError(f"{G} dispatch groups over {n_rows} row shards")
    G_loc, Tg = G // n_rows, T // G
    C = capacity(cfg, Tg)
    probs, gates, experts = route(p, cfg, xt)
    part = tuple(Partial() if pl == Shard(0) else Replicate() for pl in rows)

    def counts(e):
        pk = e.reshape(-1)
        return torch.zeros(E, device=e.device).index_add_(
            0, pk, torch.ones(pk.shape, device=e.device))
    f = on_shards(counts, (experts,), (rows,), list(part), (rows,)) / (T * topk)
    aux = cfg.router_aux_coef * E * torch.sum(f * probs.mean(dim=0))

    def dispatch_local(xl, el, gl):
        parts = [dispatch(xl[g * Tg:(g + 1) * Tg], el[g * Tg:(g + 1) * Tg],
                          gl[g * Tg:(g + 1) * Tg], E, C) for g in range(G_loc)]
        h = torch.stack([hg for hg, _ in parts], dim=1).reshape(E, G_loc * C, d)
        meta = [torch.stack([m[i] for _, m in parts]) for i in range(4)]
        return (h, *meta)
    hs = tuple(Shard(1) if pl == Shard(0) else Replicate() for pl in rows)
    h, *meta = on_shards(dispatch_local, (xt, experts, gates), (rows, rows, rows),
                         (hs, rows, rows, rows, rows), (rows, rows, rows))
    y = _experts(p, h)
    # each rank sums the picks of the experts it holds: a partial sum over
    # the dims that cut the experts
    ys = tuple(Shard(0) if pl == Shard(0) else h_pl
               for pl, h_pl in zip(y.placements, hs))
    cut = [i for i, pl in enumerate(ys) if pl == Shard(0)]
    if len(cut) > 1:
        raise NotImplementedError("experts cut over more than one mesh dim")
    outp = tuple(Partial() if i in cut else pl for i, pl in enumerate(rows))

    def combine_local(yl, slot, t_s, g_s, keep):
        E_loc = yl.shape[0]
        first = mesh.get_local_rank(cut[0]) * E_loc if cut else None
        yl = yl.reshape(E_loc, G_loc, C, d)
        return torch.cat([combine(yl[:, g], (slot[g], t_s[g], g_s[g], keep[g]), Tg, first)
                          for g in range(G_loc)])
    # a rank's gates take the gradient of its own experts' picks only: a
    # partial sum over the dims that cut the experts, as the output
    out = on_shards(combine_local, (y, *meta), (ys, rows, rows, rows, rows), list(outp),
                    (ys, rows, rows, outp, rows)).to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(B, L, d), aux


def moe_forward(p: dict, cfg, x: torch.Tensor, mesh=None):
    """x: (B, L, d) -> (y, aux_loss), dispatched in ``mesh``'s groups (a
    DTensor ``x``'s own mesh where none is given)."""
    from torch.distributed.tensor import DTensor
    B, L, d = x.shape
    E, topk = cfg.n_experts, cfg.moe_top_k
    T = B * L
    if isinstance(x, DTensor):
        return _moe_partitioned(p, cfg, x, dispatch_groups(mesh or x.device_mesh, T))
    G = dispatch_groups(mesh, T)
    Tg = T // G
    xt = x.reshape(T, d)
    probs, gates, experts = route(p, cfg, xt)

    picks = experts.reshape(-1)
    f = torch.zeros(E, device=x.device).index_add_(
        0, picks, torch.ones(picks.shape, device=x.device)) / (T * topk)
    aux = cfg.router_aux_coef * E * torch.sum(f * probs.mean(dim=0))

    C = capacity(cfg, Tg)
    if G == 1:
        h, meta = dispatch(xt, experts, gates, E, C)
        out = combine(_experts(p, h), meta, T)
    else:
        # every group's picks placed apart; the experts run on all the
        # groups' rows at once, (E, G·C, d)
        parts = [dispatch(xt[g * Tg:(g + 1) * Tg], experts[g * Tg:(g + 1) * Tg],
                          gates[g * Tg:(g + 1) * Tg], E, C) for g in range(G)]
        h = torch.stack([hg for hg, _ in parts], dim=1).reshape(E, G * C, d)
        y = _experts(p, h).reshape(E, G, C, d)
        out = torch.cat([combine(y[:, g], m, Tg) for g, (_, m) in enumerate(parts)])
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(B, L, d), aux
