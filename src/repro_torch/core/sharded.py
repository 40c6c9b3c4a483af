"""Band-parallel coreset construction, and the coreset's array-heavy stages
over a device mesh.

The construction is embarrassingly parallel over row bands (coresets of
disjoint sub-signals compose exactly — see streaming.py).  On a real
cluster each host builds the coreset of the row band whose data it owns
(data never leaves the host: only the tiny coresets are gathered), which is
how the paper's challenge (iv) (parallel training of a single tree) is met.
Here the per-band builds run on a thread pool (NumPy releases the GIL in the
hot loops), and each band's integral images dispatch ``sat_moments`` to the
card, several threads at once.

Over a ``torch.distributed`` ``DeviceMesh`` (``repro_torch.launch.mesh``),
the two stages the reference runs under pjit:

  * ``sat_pjit``             — the (1, y, y^2) integral images, row-band
    sharded: each rank scans its band seeded with the integral row above
    it, which passes from rank to rank;
  * ``fitting_loss_batched`` — Algorithm 5 for MANY candidate trees at once
    (the hyperparameter-tuning inner loop), blocks sharded over the mesh
    and one all_reduce at the end.

A mesh program is SPMD: every rank of the mesh calls the same function with
the same inputs, and every rank returns the whole result.
"""
from __future__ import annotations

import concurrent.futures as _fut
import time

import numpy as np

from .coreset import SignalCoreset, signal_coreset
from .fitting_loss import true_loss
from .segmentation import greedy_tree
from .stats import PrefixStats
from .streaming import compose, recompress

__all__ = ["sharded_coreset", "shared_tolerance", "band_bounds", "sat_pjit",
           "fitting_loss_batched", "MESH_BACKEND", "CPU_MESH_BACKEND",
           "mesh_axis", "mesh_backend"]


def shared_tolerance(values: np.ndarray, k: int, eps: float,
                     _stats=None) -> float:
    """The global per-block opt1 cap (``tolerance_override``) shared across
    band builds: one cheap greedy k-tree pass estimates sigma, and the
    Lemma-14 budget ``eps^2 * sigma / k`` is split over intersected blocks
    globally.  Every band-parallel caller computes the *identical* float
    (same op order), which is what keeps their composed coresets bitwise
    fingerprint-equal.
    """
    y = np.asarray(values, np.float64)
    ps = _stats if _stats is not None else PrefixStats.build(y)
    g = greedy_tree(ps, k)
    sigma = max(true_loss(y, g.rects, g.labels, ps=ps) / 4.0, 1e-12)
    return eps * eps * sigma / max(k, 1)


def band_bounds(n: int, num_bands: int) -> list[tuple[int, int]]:
    """The canonical row-band split: linspace bounds, empty bands dropped."""
    bounds = np.linspace(0, n, num_bands + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(num_bands)
            if bounds[i + 1] > bounds[i]]


def sharded_coreset(values: np.ndarray, k: int, eps: float, num_bands: int,
                    *, recompress_result: bool = False, max_workers: int | None = None,
                    share_tolerance: bool = True, _stats=None, **kw) -> SignalCoreset:
    """Build per-row-band coresets in parallel and compose them.

    ``share_tolerance``: derive the per-block opt1 cap from a *global* sigma
    estimate (one cheap greedy k-tree pass — on a real cluster, a
    tree-reduction over band statistics) and share it across bands.  The
    Lemma-14 error budget sums over intersected blocks globally, so a global
    cap keeps |C| at the single-build size; per-band caps (share_tolerance=
    False, the pure merge-reduce setting) are also valid but ~bands-times
    larger.

    ``_stats`` (internal): prebuilt full-signal integral images for the
    sigma estimate (maintained incrementally through ``delta_sat`` by a
    caller whose signal mutates), sparing the O(N) re-SAT here.
    """
    y = np.asarray(values, np.float64)
    n = y.shape[0]
    if share_tolerance and "tolerance_override" not in kw:
        kw = dict(kw, tolerance_override=shared_tolerance(y, k, eps, _stats))
    bands = band_bounds(n, num_bands)
    with _fut.ThreadPoolExecutor(max_workers=max_workers or len(bands)) as ex:
        parts = list(ex.map(lambda b: signal_coreset(y[b[0]:b[1]], k, eps, **kw), bands))
    cs = compose(parts, [b[0] for b in bands], n_total=n)
    return recompress(cs) if recompress_result else cs




# ------------------------------------------------------------------ the mesh
# the mesh scorer's backend names: kernel 4 on every rank of a mesh on the
# card, its plain version on a mesh of CPU ranks; each then one all_reduce
MESH_BACKEND = "cuda+all_reduce"
CPU_MESH_BACKEND = "torch+all_reduce"


def mesh_backend(mesh) -> str:
    """The backend name of the mesh scorer on ``mesh``."""
    return MESH_BACKEND if mesh.device_type == "cuda" else CPU_MESH_BACKEND


def mesh_axis(mesh, axis: str) -> int:
    """The index of ``mesh``'s dimension named ``axis``; raises unless
    ``mesh`` is a ``DeviceMesh`` with such a dimension."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(repro_torch.launch.mesh), got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} dimension "
                         f"(its dimensions: {names})")
    return names.index(axis)


def _mesh_place(mesh, axis: str):
    """(shards, this rank's coordinate, the axis's group, this rank's
    device, whether the group moves host tensors only) along ``axis``."""
    import torch
    import torch.distributed as dist
    dim = mesh_axis(mesh, axis)
    group = mesh.get_group(axis)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    # gloo moves host memory: a tensor on the card crosses through the host
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    return mesh.size(dim), mesh.get_local_rank(axis), group, device, staged


def _slab(a: np.ndarray, lo: int, rows: int) -> np.ndarray:
    """Rows [lo, lo + rows) of ``a`` as float32, zero rows past its end:
    the reference's zero-weight padding blocks, which add no loss."""
    out = np.zeros((rows,) + a.shape[1:], np.float32)
    part = a[lo:lo + rows]
    out[:len(part)] = part
    return out


def fitting_loss_batched(cs: SignalCoreset, seg_rects: np.ndarray,
                         seg_labels: np.ndarray, mesh=None,
                         data_axis: str = "data",
                         backend: str | None = None) -> np.ndarray:
    """Evaluate T candidate segmentations at once: seg_rects (T, K, 4),
    seg_labels (T, K).  Returns (T,).

    Without a mesh this is the dispatched ``repro_torch.ops
    .fitting_loss_batched`` (numpy oracle, plain torch on the CPU, or the
    batched CUDA kernel, by the selection rules or the explicit
    ``backend=``).  With a mesh the coreset's blocks, padded with
    zero-weight blocks to a multiple of the ``data_axis`` size, are split
    into contiguous slabs; the rank at coordinate c runs the batched loss
    kernel (``csrc/fitting_loss.cu``; its plain version on a CPU mesh) on
    slab c against all T trees, then ONE all_reduce over the axis sums the
    partial losses.  Ranks along other axes hold replicas.  Every rank
    returns the (T,) float32 losses.  ``backend=`` is ignored under a mesh;
    the dispatch span and the profile record the hop as
    :data:`MESH_BACKEND` (``CPU_MESH_BACKEND`` on a CPU mesh).
    """
    if mesh is None:
        from repro_torch import ops
        return ops.fitting_loss_batched(cs, np.asarray(seg_rects),
                                        np.asarray(seg_labels),
                                        backend=backend)
    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.kernels.fitting_loss.ops import fitting_loss_batched as kernel

    shards, coord, group, device, staged = _mesh_place(mesh, data_axis)
    sr = np.asarray(seg_rects, np.float32)
    sl = np.asarray(seg_labels, np.float32)
    B, T = int(cs.rects.shape[0]), int(sr.shape[0])
    rows = -(-B // shards)
    slab = [_slab(np.asarray(a), coord * rows, rows)
            for a in (cs.rects, cs.labels, cs.weights)]
    name = mesh_backend(mesh)
    size = B * T
    t0 = time.perf_counter()
    with obs.span("ops.dispatch", op="fitting_loss_batched", backend=name,
                  size=size):
        part = kernel(*[torch.as_tensor(a, device=device)
                        for a in (*slab, sr, sl)])
        if staged:
            part = part.cpu()
        dist.all_reduce(part, group=group)
        out = part.cpu().numpy()
    if obs.profile._HOOKS:
        obs.profile.record("fitting_loss_batched", name, size,
                           time.perf_counter() - t0)
    return out


def sat_pjit(values, mesh=None, data_axis: str = "data"):
    """(3, n, m) float32 integral images of (1, y, y^2).

    Without a mesh, one device's scans (``sat_moments``): the card's kernel
    for a numpy array or a CUDA tensor, the plain version only for a tensor
    the caller put on the CPU.  With a mesh the rows are sharded over
    ``data_axis`` as a ``Shard(1)`` DTensor splits them (``torch.chunk``'s
    bands, empty trailing bands allowed): rank c receives from rank c - 1
    the integral row just above its band (-0.0 at rank 0, which leaves
    every sum as it is), scans its band seeded with it (the seeded scan
    ``delta_sat_moments``), and sends its band's last row on to rank c + 1
    (an empty band passes its carry on).  The carry chain is the
    reference's scan + collective-permute chain; each rank's adds are the
    one-device scan's.  Returns a ``DTensor`` sharded on the rows,
    replicated along the mesh's other axes."""
    import torch
    from repro_torch.kernels.common import require_cuda
    from repro_torch.kernels.sat2d import ops as sat_ops

    if mesh is None:
        if isinstance(values, torch.Tensor):
            y = values.to(torch.float32)
        else:
            require_cuda()
            y = torch.as_tensor(np.asarray(values, np.float32), device="cuda")
        return sat_ops.sat_moments(y)

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shards, coord, group, device, staged = _mesh_place(mesh, data_axis)
    y = values if isinstance(values, torch.Tensor) else np.asarray(values)
    n, m = (int(d) for d in y.shape)
    rows = -(-n // shards)
    lo, hi = min(coord * rows, n), min((coord + 1) * rows, n)
    band = y[lo:hi]
    band = (band.to(device=device, dtype=torch.float32)
            if isinstance(band, torch.Tensor)
            else torch.as_tensor(np.asarray(band, np.float32), device=device))
    link = "cpu" if staged else device
    carry = torch.full((3, m), -0.0, dtype=torch.float32, device=link)
    if coord > 0:
        dist.recv(carry, src=dist.get_global_rank(group, coord - 1), group=group)
    carry = carry.to(device)
    if hi > lo:
        local = sat_ops.delta_sat_moments(carry, band)
        last = local[:, -1, :]
    else:
        local = torch.empty((3, 0, m), dtype=torch.float32, device=device)
        last = carry
    if coord < shards - 1:
        dist.send(last.to(link).contiguous(),
                  dst=dist.get_global_rank(group, coord + 1), group=group)
    placements = [Shard(1) if name == data_axis else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements,
                              shape=torch.Size((3, n, m)), stride=(n * m, m, 1))
