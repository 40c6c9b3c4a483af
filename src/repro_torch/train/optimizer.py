"""AdamW (hand-rolled, over the parameter tree) with float32 master weights.

State layout per parameter: {master fp32, m fp32, v fp32} — 12 bytes/param
on top of the bf16 params — and an int32 step.  The update follows the
reference's arithmetic in float32 term by term, ``beta ** step`` and the
cosine schedule included.  It is functional: ``adamw_apply`` returns new
tensors and leaves its arguments as they were (the reference donates its
buffers to the jitted step instead; here the old ones are freed when the
caller drops them).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import leaves, tree_map, unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_apply", "global_norm",
           "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def adamw_init(params) -> dict:
    """Masters (float32 copies of the params), m and v (float32 zeros) on
    each param's device, and step 0 (int32) on the first param's."""
    first = leaves(params)[0]
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves(tree)))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32, from an
    int32 step tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


@torch.no_grad()
def adamw_apply(ocfg: AdamWConfig, grads, opt_state, params, gnorm=None):
    """One AdamW step. Returns (new_params, new_opt_state, metrics): new
    params in each param's own dtype, the masters, m and v in float32, the
    metrics ``grad_norm`` and ``lr`` (float32 tensors).  ``gnorm``: the
    norm to clip by, where ``grads`` are a part of the gradients (a ZeRO-1
    rank's); default ``global_norm(grads)``."""
    step = opt_state["step"] + 1
    lr = cosine_lr(ocfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.tensor(ocfg.beta1, dtype=torch.float32, device=step.device) ** stepf
    bc2 = 1 - torch.tensor(ocfg.beta2, dtype=torch.float32, device=step.device) ** stepf

    def upd(g, m, v, master):
        g = g.to(torch.float32) * scale
        m_new = ocfg.beta1 * m + (1 - ocfg.beta1) * g
        v_new = ocfg.beta2 * v + (1 - ocfg.beta2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        u = mhat / (torch.sqrt(vhat) + ocfg.eps) + ocfg.weight_decay * master
        return m_new, v_new, master - lr * u

    out = [upd(g, m, v, w) for g, m, v, w in zip(
        leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]),
        leaves(opt_state["master"]))]
    new_master = [o[2] for o in out]
    new_params = unflatten(params, [w.to(p.dtype) for w, p in
                                    zip(new_master, leaves(params))])
    new_state = {"master": unflatten(params, new_master),
                 "m": unflatten(params, [o[0] for o in out]),
                 "v": unflatten(params, [o[1] for o in out]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
