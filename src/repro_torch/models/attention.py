"""Attention: GQA (+bias), the chunked online-softmax path, decode.

Two execution paths for a full sequence, chosen by ``impl``:
  * ``"torch"``: the plain online-softmax scan over KV chunks, the
    reference's XLA path (``chunked_attention(impl="xla")``) with its dtype
    promotions: in bfloat16 the score and ``P·V`` products round to
    bfloat16 before the float32 softmax arithmetic.
  * ``"cuda"``: the hand-written flash-attention kernel
    (``repro_torch.kernels.flash_attention``), the counterpart of the
    reference's ``impl="pallas"``.  On a CPU tensor its wrapper runs the
    kernel's plain version.
``None`` resolves to ``"cuda"`` when a card is present and raises otherwise:
the CPU is pinned with ``impl="torch"``.

Decode is single-query attention against a KV cache (a memory-bound einsum,
outside any kernel in the reference too).

MLA (DeepSeek-V2) attends with a query/key head of ``qk_nope + qk_rope``
and a narrower value head, which the flash-attention kernel does not take
(nor does the reference's Pallas kernel): its forward runs only on the
plain attention, and asks for ``impl="torch"``.  Its decode is the
*absorbed* form: the per-head K/V up-projections fold into the query and
output projections, so a step attends over the compressed (kv_lora + rope)
cache.
"""
from __future__ import annotations

import torch

from .layers import (init_linear, init_rmsnorm, linear, on_shards, rms_norm, rope,
                     settle, torch_dtype)

__all__ = ["init_gqa", "gqa_forward", "gqa_decode", "init_mla", "mla_forward",
           "mla_decode", "chunked_attention", "resolve_attn_impl", "ATTN_IMPLS"]

_NEG = -1e30
ATTN_IMPLS = ("torch", "cuda")


def resolve_attn_impl(impl: str | None) -> str:
    """``impl`` itself if given; else ``"cuda"`` with a card, else raise."""
    if impl is None:
        if torch.cuda.is_available():
            return "cuda"
        raise RuntimeError("no CUDA device for attention: pass attn_impl='torch' "
                           "to run the plain attention on the CPU")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; have {ATTN_IMPLS}")
    return impl


# --------------------------------------------------- chunked online softmax
def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      k_chunk: int = 1024, impl: str | None = None,
                      q_offset: int | None = None):
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D).  Returns (B, Hq, Lq, D).
    ``impl="torch"``: online softmax over KV chunks of ``k_chunk``, query
    chunks of ``q_chunk``, K/V repeated per chunk for the GQA groups.
    ``q_offset``: the first query's position among the keys (default
    ``Lk - Lq``, the queries the last of the keys).  DTensors run
    partitioned (``_attention_partitioned``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _attention_partitioned(q, k, v, causal=causal, q_chunk=q_chunk,
                                      k_chunk=k_chunk, impl=impl)
    if resolve_attn_impl(impl) == "cuda":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=causal)
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    group = Hq // Hkv
    scale = 1.0 / D ** 0.5
    if q_offset is None:
        q_offset = Lk - Lq
    qc, kc = min(q_chunk, Lq), min(k_chunk, Lk)
    dev = q.device
    outs = []
    for q0 in range(0, Lq, qc):
        q_blk = q[:, :, q0:q0 + qc]
        if q_blk.shape[2] < qc:
            q_blk = torch.nn.functional.pad(q_blk, (0, 0, 0, qc - q_blk.shape[2]))
        qi_abs = q0 + torch.arange(qc, device=dev)[:, None] + q_offset
        m = l = acc = None
        for k0 in range(0, Lk, kc):
            k_blk, v_blk = k[:, :, k0:k0 + kc], v[:, :, k0:k0 + kc]
            if k_blk.shape[2] < kc:
                pad = kc - k_blk.shape[2]
                k_blk = torch.nn.functional.pad(k_blk, (0, 0, 0, pad))
                v_blk = torch.nn.functional.pad(v_blk, (0, 0, 0, pad))
            if group > 1:
                k_blk = k_blk.repeat_interleave(group, dim=1)
                v_blk = v_blk.repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", q_blk, k_blk).float() * scale
            ki = k0 + torch.arange(kc, device=dev)[None, :]
            mask = (ki <= qi_abs) & (ki < Lk) if causal \
                else (ki < Lk).expand(qc, kc)
            s = torch.where(mask, s, _NEG)
            if m is None:
                # the first block starts the running max, sum and product
                # (as from -inf, 0 and 0: the same values, and no state made
                # before the scores, so that it lies where the scores do)
                m = s.amax(dim=-1)
                p = torch.exp(s - m[..., None])
                l = p.sum(dim=-1)
                acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
                continue
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :Lq]


def _attention_partitioned(q, k, v, *, causal, q_chunk, k_chunk, impl):
    """The plain attention of DTensor q, k, v on each rank's blocks.  A
    mesh dim that cuts the batch, or the heads of q, k and v alike, keeps
    its cut (each rank attends its own rows or heads); one that cuts them
    otherwise (the head_dim fallback) cuts the queries' sequence instead,
    the keys and values whole on its ranks (their gradients partial sums),
    each rank its block of query rows against every key, as the plain
    attention runs them all, the output's rows then gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if resolve_attn_impl(impl) != "torch":
        raise ValueError("a partitioned step attends with attn_impl='torch'")
    mesh = q.device_mesh
    qp, kvp, kvg = [], [], []
    seq = None
    for i, (a, b, c) in enumerate(zip(q.placements, k.placements, v.placements)):
        if a == b == c and isinstance(a, Shard) and a.dim in (0, 1):
            qp.append(a), kvp.append(a), kvg.append(a)
        elif seq is None and not all(isinstance(x, Replicate) for x in (a, b, c)) \
                and q.shape[2] % mesh.size(i) == 0:
            seq = i
            qp.append(Shard(2)), kvp.append(Replicate()), kvg.append(Partial())
        else:
            qp.append(Replicate()), kvp.append(Replicate()), kvg.append(Replicate())
    Lq, Lk = q.shape[2], k.shape[2]

    def local(ql, kl, vl):
        off = Lk - Lq
        if seq is not None:
            off += mesh.get_local_rank(seq) * ql.shape[2]
        return chunked_attention(ql, kl, vl, causal=causal, q_chunk=q_chunk,
                                 k_chunk=k_chunk, impl="torch", q_offset=off)

    o = on_shards(local, (q, k, v), (tuple(qp), tuple(kvp), tuple(kvp)),
                  list(qp), (tuple(qp), tuple(kvg), tuple(kvg)))
    if seq is not None:
        # the rows gathered back (a sequence cut would meet the batch's in
        # the heads' merge and the output projection's flattened rows)
        o = o.redistribute(mesh, [Replicate() if i == seq else pl
                                  for i, pl in enumerate(qp)])
    return o


# ---------------------------------------------------------------------- GQA
def init_gqa(gen: torch.Generator, cfg) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = torch_dtype(cfg)
    return {
        "wq": init_linear(gen, d, (H, hd), dt, bias=cfg.qkv_bias),
        "wk": init_linear(gen, d, (Hkv, hd), dt, bias=cfg.qkv_bias),
        "wv": init_linear(gen, d, (Hkv, hd), dt, bias=cfg.qkv_bias),
        "wo": init_linear(gen, H * hd, d, dt, scale=(H * hd) ** -0.5),
    }


def _heads(y: torch.Tensor, n: int) -> torch.Tensor:
    """(B, L, n * hd), or (B, L, n, hd) from a weight held in its head
    view, -> (B, n, L, hd).  (A partitioned step's gradient of it lies as
    the projection's output does.)"""
    B, L = y.shape[:2]
    return settle(y, y).reshape(B, L, n, -1).transpose(1, 2)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(B, n, L, hd) -> (B, L, n * hd).  In a partitioned step a cut of hd
    (the head_dim fallback) is gathered first: the flat dim keeps no cut
    that is not a block of it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    o = o.transpose(1, 2)
    if isinstance(o, DTensor) and any(isinstance(p, Shard) and p.dim == 3
                                      for p in o.placements):
        o = o.redistribute(o.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 3 else p
            for p in o.placements])
    o = o.reshape(*o.shape[:2], -1)
    return settle(o, o)     # (its gradient whole where it is, to unflatten)


def gqa_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                attn_impl: str | None = None, return_kv: bool = False):
    """x: (B, L, d). Returns (B, L, d) (+ (k, v) for prefill)."""
    B, L, _ = x.shape
    q = rope(_heads(linear(p["wq"], x), cfg.n_heads), positions[:, None, :],
             cfg.rope_theta)
    k = rope(_heads(linear(p["wk"], x), cfg.n_kv_heads), positions[:, None, :],
             cfg.rope_theta)
    v = _heads(linear(p["wv"], x), cfg.n_kv_heads)
    o = chunked_attention(q, k, v, causal=True, impl=attn_impl,
                          q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    out = linear(p["wo"], _merge_heads(o))
    if return_kv:
        return out, (k, v)
    return out


def gqa_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: int):
    """One-token decode. x: (B, 1, d); cache: {"k","v"}: (B, Hkv, S, hd),
    written at ``pos`` in place; pos: the current position.  Returns
    (out, cache)."""
    B = x.shape[0]
    posv = torch.full((B, 1, 1), pos, dtype=torch.int64, device=x.device)
    q = rope(_heads(linear(p["wq"], x), cfg.n_heads), posv, cfg.rope_theta)
    k1 = rope(_heads(linear(p["wk"], x), cfg.n_kv_heads), posv, cfg.rope_theta)
    v1 = _heads(linear(p["wv"], x), cfg.n_kv_heads)
    ck, cv = cache["k"], cache["v"]
    ck[:, :, pos:pos + 1] = k1.to(ck.dtype)
    cv[:, :, pos:pos + 1] = v1.to(cv.dtype)
    S = ck.shape[2]
    group = cfg.n_heads // cfg.n_kv_heads
    kk = ck.repeat_interleave(group, dim=1) if group > 1 else ck
    vv = cv.repeat_interleave(group, dim=1) if group > 1 else cv
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() / cfg.hd ** 0.5
    mask = torch.arange(S, device=x.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, _NEG)
    w = torch.softmax(s, dim=-1).to(vv.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w, vv)
    out = linear(p["wo"], _merge_heads(o))
    return out, cache


# ---------------------------------------------------------------------- MLA
def init_mla(gen: torch.Generator, cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = torch_dtype(cfg)
    p = {"wkv_a": init_linear(gen, d, r_kv + dr, dt),
         "kv_norm": init_rmsnorm(r_kv, dt, gen.device),
         "wk_b": init_linear(gen, r_kv, (H, dn), dt),
         "wv_b": init_linear(gen, r_kv, (H, dv), dt),
         "wo": init_linear(gen, H * dv, d, dt, scale=(H * dv) ** -0.5)}
    if r_q:
        p["wq_a"] = init_linear(gen, d, r_q, dt)
        p["q_norm"] = init_rmsnorm(r_q, dt, gen.device)
        p["wq_b"] = init_linear(gen, r_q, (H, dn + dr), dt)
    else:
        p["wq"] = init_linear(gen, d, (H, dn + dr), dt)
    return p


def _mla_q(p, cfg, x, positions):
    """(q_nope (B, H, L, dn), q_rope (B, H, L, dr) with RoPE applied)."""
    if "wq_a" in p:
        q = linear(p["wq_b"], rms_norm(p["q_norm"], linear(p["wq_a"], x), cfg.norm_eps))
    else:
        q = linear(p["wq"], x)
    q = _heads(q, cfg.n_heads)
    dn = cfg.qk_nope_dim
    return q[..., :dn], rope(q[..., dn:], positions[:, None, :], cfg.rope_theta)


def mla_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                attn_impl: str | None = None, return_kv: bool = False):
    """x: (B, L, d). Returns (B, L, d) (+ the compressed cache ``(c_kv
    (B, L, kv_lora), k_rope (B, L, dr))`` for prefill).  Only the plain
    attention takes MLA's heads: ``attn_impl`` must be ``"torch"``."""
    if resolve_attn_impl(attn_impl) == "cuda":
        raise ValueError(
            f"MLA's {cfg.qk_nope_dim + cfg.qk_rope_dim}-wide query/key heads and "
            f"{cfg.v_head_dim}-wide value heads are not a shape the flash-attention "
            "kernel takes (nor the reference's Pallas kernel): pass "
            "attn_impl=\"torch\"")
    B, L, _ = x.shape
    H, r_kv, dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    kv = linear(p["wkv_a"], x)                                 # (B, L, r_kv + dr)
    c_kv = rms_norm(p["kv_norm"], kv[..., :r_kv], cfg.norm_eps)
    k_rope = rope(kv[:, None, :, r_kv:], positions[:, None, :], cfg.rope_theta)
    k_nope = _heads(linear(p["wk_b"], c_kv), H)                # (B, H, L, dn)
    v = _heads(linear(p["wv_b"], c_kv), H)                     # (B, H, L, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # (a partitioned step's shared rope key cut as the heads are)
    k = torch.cat([k_nope, settle(k_rope.expand(B, H, L, dr), k_nope)], dim=-1)
    o = chunked_attention(q, k, v, causal=True, impl="torch",
                          q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    out = linear(p["wo"], _merge_heads(o))
    if return_kv:
        return out, (c_kv, k_rope[:, 0])
    return out


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: int):
    """Absorbed-matmul decode over the compressed cache.  x: (B, 1, d);
    cache: {"c_kv": (B, S, kv_lora), "k_rope": (B, S, dr)}, written at
    ``pos`` in place.  Returns (out, cache)."""
    B = x.shape[0]
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    H, r_kv = cfg.n_heads, cfg.kv_lora_rank
    posv = torch.full((B, 1, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, posv[:, 0])
    kv = linear(p["wkv_a"], x)                                 # (B, 1, r_kv + dr)
    c_new = rms_norm(p["kv_norm"], kv[..., :r_kv], cfg.norm_eps)
    kr_new = rope(kv[:, None, :, r_kv:], posv, cfg.rope_theta)[:, 0]   # (B, 1, dr)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, pos:pos + 1] = c_new.to(c_kv.dtype)
    k_rope[:, pos:pos + 1] = kr_new.to(k_rope.dtype)
    # absorb wk_b into the query: (B, H, 1, r_kv)
    q_abs = torch.einsum("bhqn,rhn->bhqr", q_nope, p["wk_b"]["w"].reshape(r_kv, H, dn))
    # the two score products summed in the model's dtype, then float32
    s = (torch.einsum("bhqr,bsr->bhqs", q_abs, c_kv)
         + torch.einsum("bhqr,bsr->bhqs", q_rope, k_rope)).float()
    s = s / (dn + dr) ** 0.5
    S = c_kv.shape[1]
    mask = torch.arange(S, device=x.device)[None, None, None, :] <= pos
    w = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
    ctx = torch.einsum("bhqs,bsr->bhqr", w.to(c_kv.dtype), c_kv)
    # absorb wv_b into the output projection
    o = torch.einsum("bhqr,rhv->bhqv", ctx, p["wv_b"]["w"].reshape(r_kv, H, dv))
    out = linear(p["wo"], _merge_heads(o))
    return out, cache
