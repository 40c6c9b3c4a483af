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
from ..models.layers import SumOverGroup, head_shape, linear, on_shards, unembed
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
    if _is_dtensor(hidden):
        return _xent_partitioned(cfg, head_p["w"], hidden, targets, n_chunks)
    losses = torch.stack([
        cross_entropy(unembed(head_p, hidden[:, i * c:(i + 1) * c], head_shape(cfg)),
                      targets[:, i * c:(i + 1) * c], cfg.z_loss_coef)
        for i in range(n_chunks)])
    return losses.mean()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _xent_partitioned(cfg, w, hidden, targets, n_chunks: int):
    """``chunked_xent`` over DTensors: the logits of a chunk never exist
    whole.  Each rank makes its rows' logits over its block of the vocab
    (the head's placements), and the log-sum-exp and the true class's logit
    are summed over the ranks that cut the vocab (a max, a sum of exps and
    a masked pick, each one all-reduce over those ranks).  Returns the mean
    loss, replicated where the rows are and partial (a sum) over the ranks
    that cut the rows, as the losses of the plain path averaged."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = hidden.device_mesh
    vdim = w.dim() - 1
    vocab_dims = [i for i, p in enumerate(w.placements)
                  if isinstance(p, Shard) and p.dim == vdim]
    row_dims = [i for i, p in enumerate(hidden.placements) if isinstance(p, Shard)]
    if any(not isinstance(p, (Shard, Replicate)) for p in hidden.placements):
        raise ValueError(f"hidden states placed {hidden.placements}")
    n_rows = hidden.shape[0] * hidden.shape[1]
    C = cfg.n_codebooks if cfg.frontend == "audio_codebooks" else 1
    if len(vocab_dims) > 1:
        raise NotImplementedError("a vocab cut over more than one mesh dim")
    group = mesh.get_group(vocab_dims[0]) if vocab_dims else None

    def local(h, wl, t):
        # the vocab this rank holds (the audio head's flat weight holds C of
        # them side by side)
        V = wl.shape[-1] if wl.dim() == 3 else wl.shape[-1] // C
        off = mesh.get_local_rank(vocab_dims[0]) * V if vocab_dims else 0
        B, Lc = h.shape[0], h.shape[1] // n_chunks
        total = None
        for i in range(n_chunks):
            logits = linear({"w": wl}, h[:, i * Lc:(i + 1) * Lc])
            lf = logits.float().reshape(B, Lc, C, V) if C > 1 else logits.float()
            tt = t[:, i * Lc:(i + 1) * Lc].long()
            if group is None:
                lse = torch.logsumexp(lf, dim=-1)
                true = torch.gather(lf, -1, tt[..., None])[..., 0]
            else:
                mx = lf.detach().amax(dim=-1)
                mx = funcol.wait_tensor(funcol.all_reduce(mx, "max", group))
                se = torch.exp(lf - mx[..., None]).sum(dim=-1)
                lse = torch.log(SumOverGroup.apply(se, group)) + mx
                tl = tt - off
                hit = (tl >= 0) & (tl < V)
                pick = torch.gather(lf, -1, tl.clamp(0, V - 1)[..., None])[..., 0]
                true = SumOverGroup.apply(torch.where(hit, pick, 0.0), group)
            nll = (lse - true).sum()
            if cfg.z_loss_coef:
                nll = nll + cfg.z_loss_coef * torch.square(lse).sum()
            total = nll if total is None else total + nll
        # the mean over every row (and codebook) of every rank
        return total / (n_rows * C)

    row = tuple(Partial() if i in row_dims else Replicate() for i in range(mesh.ndim))
    h_grad = tuple(Partial() if i in vocab_dims else p
                   for i, p in enumerate(hidden.placements))
    w_grad = tuple(Partial() if i in row_dims else p for i, p in enumerate(w.placements))
    return on_shards(local, (hidden, w, targets),
                     (hidden.placements, w.placements, targets.placements), list(row),
                     (h_grad, w_grad, targets.placements))


def loss_fn(cfg, params, batch: dict, attn_impl: str = "torch", mesh=None):
    """-> (loss, {"ce", "aux"}), as the reference's (its "ce" is the loss
    with the aux term in it).  ``mesh``: the mesh of a partitioned step."""
    hidden, aux = forward(cfg, params, batch, attn_impl=attn_impl,
                          return_hidden=True, mesh=mesh)
    loss = chunked_xent(cfg, params["head"], hidden, batch["targets"]) + aux
    return loss, {"ce": loss, "aux": aux}


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch leaf: contiguous rows of its
    leading dim; of a DTensor, of each rank's own rows (so that no rank
    takes another's)."""
    if not _is_dtensor(v):
        size = v.shape[0] // n
        return v[i * size:(i + 1) * size]
    from torch.distributed.tensor import DTensor
    loc = v.to_local()
    size = loc.shape[0] // n
    shape = (v.shape[0] // n,) + tuple(v.shape[1:])
    return DTensor.from_local(loc[i * size:(i + 1) * size], v.device_mesh,
                              v.placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def make_grad_fn(cfg, attn_impl: str = "torch", num_microbatches: int = 1,
                 mesh=None):
    """Returns grads(params, batch) -> (loss, grads, {"ce", "aux"}).
    Gradients come in each param's dtype; with microbatches, as contiguous
    slices of the batch's leading dim (of each rank's rows, on a mesh), they
    are summed in float32 and averaged, the loss too, and ``ce``/``aux`` are
    the last microbatch's.  ``mesh``: the mesh of a partitioned step (the
    params and batch DTensors on it)."""

    def grad_fn(params, batch):
        with torch.enable_grad():
            ps = [t.detach().requires_grad_(True) for t in leaves(params)]
            loss, met = loss_fn(cfg, unflatten(params, ps), batch, attn_impl, mesh)
            # a leaf the loss does not reach (the hybrid's shared block in a
            # model cut shallower than its period) has a zero gradient
            grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(
                torch.autograd.grad(loss, ps, allow_unused=True), ps)]
        return (loss.detach(), unflatten(params, list(grads)),
                {k: v.detach() for k, v in met.items()})

    def compute_grads(params, batch):
        n = num_microbatches
        if n <= 1:
            return grad_fn(params, batch)
        tok = batch["tokens"]
        B = tok.to_local().shape[0] if _is_dtensor(tok) else tok.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} microbatches")
        loss_sum = grads_sum = None
        if not _is_dtensor(tok):
            loss_sum = torch.zeros((), dtype=torch.float32, device=tok.device)
            grads_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
        for i in range(n):
            mb = {k: _microbatch(v, i, n) for k, v in batch.items()}
            loss, grads, met = grad_fn(params, mb)
            if grads_sum is None:
                # a partitioned step sums from the first microbatch's, in
                # the placements the backward gave them (zeros made apart
                # would be whole on every rank)
                loss_sum, grads_sum = loss, tree_map(lambda g: g.float(), grads)
                continue
            loss_sum = loss_sum + loss
            grads_sum = tree_map(torch.add, grads_sum, grads)
        inv = 1.0 / n
        return loss_sum * inv, tree_map(lambda g: g * inv, grads_sum), met

    return compute_grads


def make_train_step(cfg, ocfg: AdamWConfig, attn_impl: str = "torch",
                    num_microbatches: int = 1, donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-d
    tensors), the gradients as ``make_grad_fn`` takes them.  ``donate``: the
    step updates ``params`` and ``opt_state`` in place (``adamw_apply``'s)."""
    compute_grads = make_grad_fn(cfg, attn_impl, num_microbatches)

    def train_step(params, opt_state, batch):
        loss, grads, met = compute_grads(params, batch)
        params, opt_state, opt_met = adamw_apply(ocfg, grads, opt_state, params,
                                                 donate=donate)
        return params, opt_state, {"loss": loss, **met, **opt_met}

    return train_step
