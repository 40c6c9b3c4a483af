"""Mixture-of-Experts: top-k routing with capacity, sort-based dispatch.

The reference's layer (``repro.models.moe``): the router runs in float32,
picks each token's ``moe_top_k`` experts and renormalises their gates; the
picks are sorted by expert (a *stable* sort, so that over capacity the
assignments that drop are the reference's: the later tokens of an
expert's run), placed into an (E, C, d) buffer, run through a batched
expert SwiGLU, and gathered back weighted by their gates.  The aux
load-balancing loss is Switch/GShard's, ``coef · E · Σ_e f_e · p̄_e``.

Dispatch runs in one group (G = 1): the reference makes one group a
data-parallel shard from its mesh, which the port has not yet (ROADMAP
queue 1 item 5); without a mesh the reference's G is 1 too.

``combine`` sums each token's contributions in the reference's order: its
scatter-add visits the sorted picks in turn, so a token's ``top_k`` rows
add from zeros in ascending expert id, each add rounded to the model's
dtype.  Here they are gathered as (T, top_k, d) in that order and added one
at a time, which gives the same bits on the CPU and the card (an
``index_add_`` of bfloat16 rows runs in atomics on the card, whose order
changes from run to run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import init_swiglu, swiglu, torch_dtype, truncated_normal

__all__ = ["init_moe", "moe_forward"]


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


def combine(y: torch.Tensor, meta, T: int) -> torch.Tensor:
    """The reference's ``combine_one``: each kept pick's expert output times
    its gate (in ``y``'s dtype), summed a token at a time in ascending
    expert id.  y: (E, C, d); ``meta`` from ``dispatch``.  Returns (T, d)."""
    slot, t_s, g_s, keep = meta
    E, C, d = y.shape
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


def moe_forward(p: dict, cfg, x: torch.Tensor):
    """x: (B, L, d) -> (y, aux_loss)."""
    B, L, d = x.shape
    E, topk = cfg.n_experts, cfg.moe_top_k
    T = B * L
    xt = x.reshape(T, d)
    probs, gates, experts = route(p, cfg, xt)

    picks = experts.reshape(-1)
    f = torch.zeros(E, device=x.device).index_add_(
        0, picks, torch.ones(picks.shape, device=x.device)) / (T * topk)
    aux = cfg.router_aux_coef * E * torch.sum(f * probs.mean(dim=0))

    h, meta = dispatch(xt, experts, gates, E, capacity(cfg, T))
    y = torch.bmm(h, p["wi"]) * F.silu(torch.bmm(h, p["wg"]))
    y = torch.bmm(y, p["wo"])
    out = combine(y, meta, T).to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(B, L, d), aux
