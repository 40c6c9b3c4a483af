"""Training step: CE (+z-loss), remat'd backward, AdamW, optional
microbatch gradient accumulation.

The reference's step is one jitted program whose gradients come from
``jax.value_and_grad``; here autograd records the forward and
``torch.autograd.grad`` takes the gradients, and microbatches run one after
another, their float32 gradients summed.  The step trains through the plain
attention (``attn_impl="torch"``): the flash-attention kernel has no
backward, and refuses tensors that ask for a gradient.
"""
from __future__ import annotations

import torch

from ..models import forward
from ..models.layers import head_shape, unembed
from ..tree import leaves, tree_map, unflatten
from .optimizer import AdamWConfig, adamw_apply

__all__ = ["cross_entropy", "loss_fn", "make_grad_fn", "make_train_step"]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_coef: float = 0.0) -> torch.Tensor:
    """logits: (..., V) (extra codebook dims fold into ...); targets ints.

    Float32 logsumexp minus the true-class logit, averaged, plus ``z_coef``
    times the mean squared logsumexp.  The reference picks the true-class
    logit by an iota-compare masked sum (so that vocab shards reduce
    locally); a gather picks the same value.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = (lse - true).mean()
    if z_coef:
        nll = nll + z_coef * torch.square(lse).mean()
    return nll


def chunked_xent(cfg, head_p: dict, hidden: torch.Tensor, targets: torch.Tensor,
                 n_chunks: int = 8) -> torch.Tensor:
    """Fused CE: the unembedding matmul runs per sequence chunk, so no
    (B, L, V) logits tensor is ever made; the mean of the chunks' losses.
    ``n_chunks`` halves until it divides L, as in the reference, so the
    chunks are the reference's.  targets: (B, L), or (B, L, C) for the
    audio frontend, whose codebook axis folds into the cross-entropy's
    leading axes; with patch embeddings L counts their positions too."""
    L = hidden.shape[1]
    while L % n_chunks:
        n_chunks //= 2
    n_chunks = max(n_chunks, 1)
    c = L // n_chunks
    losses = torch.stack([
        cross_entropy(unembed(head_p, hidden[:, i * c:(i + 1) * c], head_shape(cfg)),
                      targets[:, i * c:(i + 1) * c], cfg.z_loss_coef)
        for i in range(n_chunks)])
    return losses.mean()


def loss_fn(cfg, params, batch: dict, attn_impl: str = "torch"):
    """-> (loss, {"ce", "aux"}), as the reference's (its "ce" is the loss
    with the aux term in it)."""
    hidden, aux = forward(cfg, params, batch, attn_impl=attn_impl,
                          return_hidden=True)
    loss = chunked_xent(cfg, params["head"], hidden, batch["targets"]) + aux
    return loss, {"ce": loss, "aux": aux}


def make_grad_fn(cfg, attn_impl: str = "torch", num_microbatches: int = 1):
    """Returns grads(params, batch) -> (loss, grads, {"ce", "aux"}).
    Gradients come in each param's dtype; with microbatches, as contiguous
    slices of the batch's leading dim, they are summed in float32 and
    averaged, the loss too, and ``ce``/``aux`` are the last microbatch's."""

    def grad_fn(params, batch):
        with torch.enable_grad():
            ps = [t.detach().requires_grad_(True) for t in leaves(params)]
            loss, met = loss_fn(cfg, unflatten(params, ps), batch, attn_impl)
            grads = torch.autograd.grad(loss, ps)
        return (loss.detach(), unflatten(params, list(grads)),
                {k: v.detach() for k, v in met.items()})

    def compute_grads(params, batch):
        n = num_microbatches
        if n <= 1:
            return grad_fn(params, batch)
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} microbatches")
        size = B // n
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grads_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, grads, met = grad_fn(params, mb)
            loss_sum = loss_sum + loss
            grads_sum = tree_map(torch.add, grads_sum, grads)
        inv = 1.0 / n
        return loss_sum * inv, tree_map(lambda g: g * inv, grads_sum), met

    return compute_grads


def make_train_step(cfg, ocfg: AdamWConfig, attn_impl: str = "torch",
                    num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-d
    tensors), the gradients as ``make_grad_fn`` takes them."""
    compute_grads = make_grad_fn(cfg, attn_impl, num_microbatches)

    def train_step(params, opt_state, batch):
        loss, grads, met = compute_grads(params, batch)
        params, opt_state, opt_met = adamw_apply(ocfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **met, **opt_met}

    return train_step
