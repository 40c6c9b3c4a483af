"""Public wrapper of the flash-attention kernel: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors (which launches or raises)."""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import flash_attention_plain

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA flash attention; q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
