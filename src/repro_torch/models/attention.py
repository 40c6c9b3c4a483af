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
outside any kernel in the reference too).  MLA (DeepSeek-V2) waits for the
port's MLA slice.
"""
from __future__ import annotations

import torch

from .layers import init_linear, linear, rope, torch_dtype

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
                      k_chunk: int = 1024, impl: str | None = None):
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D).  Returns (B, Hq, Lq, D).
    ``impl="torch"``: online softmax over KV chunks of ``k_chunk``, query
    chunks of ``q_chunk``, K/V repeated per chunk for the GQA groups."""
    if resolve_attn_impl(impl) == "cuda":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=causal)
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    group = Hq // Hkv
    scale = 1.0 / D ** 0.5
    q_offset = Lk - Lq
    qc, kc = min(q_chunk, Lq), min(k_chunk, Lk)
    dev = q.device
    outs = []
    for q0 in range(0, Lq, qc):
        q_blk = q[:, :, q0:q0 + qc]
        if q_blk.shape[2] < qc:
            q_blk = torch.nn.functional.pad(q_blk, (0, 0, 0, qc - q_blk.shape[2]))
        qi_abs = q0 + torch.arange(qc, device=dev)[:, None] + q_offset
        m = torch.full((B, Hq, qc), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hq, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hq, qc, Dv), dtype=torch.float32, device=dev)
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
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :Lq]


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
    """(B, L, n * hd) -> (B, n, L, hd)."""
    B, L, _ = y.shape
    return y.reshape(B, L, n, -1).transpose(1, 2)


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
    out = linear(p["wo"], o.transpose(1, 2).reshape(B, L, -1))
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
    out = linear(p["wo"], o.transpose(1, 2).reshape(B, 1, -1))
    return out, cache


# ---------------------------------------------------------------------- MLA
def _mla_later(*_args, **_kw):
    raise NotImplementedError(
        "MLA attention (DeepSeek-V2) is not ported yet: it comes with the "
        "port's MoE/MLA slice (ROADMAP.md)")


init_mla = mla_forward = mla_decode = _mla_later
