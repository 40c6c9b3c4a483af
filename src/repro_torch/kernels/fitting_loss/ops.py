"""Public wrappers of the Algorithm-5 loss kernels: the plain version for
CPU tensors, the CUDA kernel for CUDA tensors (which launches or raises),
and the coreset adapters the ``repro_torch.ops`` backends register.
``coreset_loss_many`` is a deprecated shim over the dispatched batched op;
new code calls ``repro_torch.ops.fitting_loss_batched``."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .kernel import (fitting_loss_batched_cuda, fitting_loss_cuda,
                     pack_blocks, pack_trees)
from .ref import fitting_loss_batched_ref, fitting_loss_ref

__all__ = ["fitting_loss", "fitting_loss_batched", "coreset_loss",
           "coreset_loss_batched", "coreset_loss_many"]

_MANY_DEPRECATION_WARNED = False


def fitting_loss(rects, labels4, weights4, seg_rects, seg_labels) -> torch.Tensor:
    """0-d float32 loss of one tree: rects/labels4/weights4 (B, 4);
    seg_rects (K, 4); seg_labels (K,)."""
    if rects.device.type == "cpu":
        return fitting_loss_ref(rects, labels4, weights4, seg_rects, seg_labels)
    return fitting_loss_cuda(pack_blocks(rects, labels4, weights4),
                             pack_trees(seg_rects, seg_labels))


def fitting_loss_batched(rects, labels4, weights4, seg_rects,
                         seg_labels) -> torch.Tensor:
    """(T,) float32 losses: seg_rects (T, K, 4); seg_labels (T, K)."""
    if rects.device.type == "cpu":
        return fitting_loss_batched_ref(rects, labels4, weights4, seg_rects,
                                        seg_labels)
    return fitting_loss_batched_cuda(pack_blocks(rects, labels4, weights4),
                                     pack_trees(seg_rects, seg_labels))


def _tensors(device, *arrays):
    return [torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in arrays]


def coreset_loss(cs, seg_rects, seg_labels, device="cuda") -> float:
    """Algorithm-5 loss of one tree against a SignalCoreset, float32 on
    ``device``."""
    args = _tensors(device, cs.rects, cs.labels, cs.weights,
                    np.asarray(seg_rects).reshape(-1, 4), seg_labels)
    return float(fitting_loss(*args))


def coreset_loss_batched(cs, seg_rects, seg_labels, device="cuda") -> np.ndarray:
    """(T,) float64 copies of the float32 losses of T trees on ``device``."""
    args = _tensors(device, cs.rects, cs.labels, cs.weights, seg_rects,
                    seg_labels)
    return fitting_loss_batched(*args).cpu().numpy().astype(np.float64)


def coreset_loss_many(cs, seg_rects_batch, seg_labels_batch,
                      backend: str | None = None) -> np.ndarray:
    """Deprecated: use ``repro_torch.ops.fitting_loss_batched``.

    (T,) losses of a list of trees, through the dispatched batched op (one
    fused evaluation) where every tree has the same number of leaves, and
    one dispatched ``fitting_loss`` a tree where the leaf counts differ.
    ``backend`` pins the ops' backend, as their own argument does.  Warns
    once a process."""
    global _MANY_DEPRECATION_WARNED
    if not _MANY_DEPRECATION_WARNED:
        _MANY_DEPRECATION_WARNED = True
        warnings.warn("coreset_loss_many is deprecated; use "
                      "repro_torch.ops.fitting_loss_batched",
                      DeprecationWarning, stacklevel=2)
    from repro_torch import ops
    rs = [np.asarray(r, np.float64) for r in seg_rects_batch]
    ls = [np.asarray(lab, np.float64) for lab in seg_labels_batch]
    if len({r.shape for r in rs}) > 1:
        return np.asarray([ops.fitting_loss(cs, r, lab, backend=backend)
                           for r, lab in zip(rs, ls)], np.float64)
    return np.asarray(ops.fitting_loss_batched(cs, np.stack(rs), np.stack(ls),
                                               backend=backend), np.float64)
