"""Plain PyTorch versions of causal GQA attention.

``attention_ref`` is the dense oracle (the reference's ``attention_ref``);
``flash_attention_plain`` is the plain version of the flash-attention kernel
(``csrc/flash_attention.cu``), with the Pallas kernel's arithmetic: the
online softmax over key tiles of ``min(256, Lk)``, scores from a
float32-accumulated product times ``scale``, masks filled with -1e30 (not
-inf), ``P`` rounded to V's dtype before the ``P·V`` product while ``l``
sums the float32 ``P``, and the output ``acc / max(l, 1e-30)`` cast to q's
dtype.  Causal alignment is decode-style: query i sees keys
``<= i + Lk - Lq``.

A query row that sees no key (causal with Lq > Lk) keeps ``m = -1e30``, so
every key slot of every tile, padded ones included, adds ``P = 1``: the row
is the sum of V over the padded key count, the Pallas kernel's result (the
dense oracle gives NaN there).
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref", "flash_attention_plain", "TILE_K", "NEG"]

NEG = -1e30
# the Pallas kernel's key tile (flash_attention_call's tile_k)
TILE_K = 256


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D) with Hq % Hkv == 0."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        # the reference divides in q's dtype, by sqrt(D) rounded to it
        scale = (1.0 / torch.sqrt(torch.tensor(float(D))).to(q.dtype)).item()
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        ki = torch.arange(Lk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D).  Returns (B, Hq, Lq, D) in
    q's dtype; query head h reads KV head h // (Hq / Hkv)."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / float(D) ** 0.5
    tk = min(TILE_K, Lk)
    q_pos = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
    qf = q.float()
    m = torch.full((B, Hq, Lq, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hq, Lq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Lk, tk):
        kb, vb = k[:, :, k0:k0 + tk], v[:, :, k0:k0 + tk]
        pad = tk - kb.shape[2]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
        if group > 1:
            kb = kb.repeat_interleave(group, dim=1)
            vb = vb.repeat_interleave(group, dim=1)
        s = torch.matmul(qf, kb.float().transpose(-1, -2)) * scale
        ki = k0 + torch.arange(tk, device=q.device)[None, :]
        valid = ki < Lk
        if causal:
            valid = valid & (ki <= q_pos)
        s = torch.where(valid, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
