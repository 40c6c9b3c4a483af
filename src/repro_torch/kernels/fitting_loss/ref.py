"""Plain PyTorch version of the Algorithm-5 loss kernels.

The dense form of ``csrc/fitting_loss.cu`` over every (tree, block, leaf,
point): rectangle overlaps z, their running sum Z in leaf order, the
overlap of [Z - z, Z) with each point's [U - w, U), weighted by the squared
label difference.  Same arithmetic as the reference's ``fitting_loss_ref``;
the sums run in torch's order, not the kernel's.
"""
from __future__ import annotations

import torch

__all__ = ["overlaps", "fitting_loss_ref", "fitting_loss_batched_ref"]


def overlaps(rects, seg_rects):
    """(T, B, K) areas z of block b's rectangle within tree t's leaf k:
    rects (B, 4), seg_rects (T, K, 4), rows (r0, r1, c0, c1)."""
    br = rects[None, :, None, :]                      # (1, B, 1, 4)
    sr = seg_rects[:, None, :, :]                     # (T, 1, K, 4)
    z_r = (torch.minimum(br[..., 1], sr[..., 1])
           - torch.maximum(br[..., 0], sr[..., 0])).clamp(min=0)
    z_c = (torch.minimum(br[..., 3], sr[..., 3])
           - torch.maximum(br[..., 2], sr[..., 2])).clamp(min=0)
    return z_r * z_c


def fitting_loss_batched_ref(rects, labels4, weights4, seg_rects, seg_labels):
    """(T,) losses: rects/labels4/weights4 (B, 4); seg_rects (T, K, 4);
    seg_labels (T, K)."""
    z = overlaps(rects, seg_rects)                    # (T, B, K)
    Z = torch.cumsum(z, dim=2)
    Zp = Z - z
    U = torch.cumsum(weights4, dim=1)                 # (B, 4)
    Up = U - weights4
    lo = torch.maximum(Zp[..., None], Up[None, :, None, :])
    hi = torch.minimum(Z[..., None], U[None, :, None, :])
    consumed = (hi - lo).clamp(min=0)                 # (T, B, K, 4)
    diff = seg_labels[:, None, :, None] - labels4[None, :, None, :]
    return (consumed * diff * diff).sum(dim=(1, 2, 3))


def fitting_loss_ref(rects, labels4, weights4, seg_rects, seg_labels):
    """Scalar loss of one tree: seg_rects (K, 4), seg_labels (K,)."""
    return fitting_loss_batched_ref(rects, labels4, weights4,
                                    seg_rects[None], seg_labels[None])[0]
