"""Band-parallel coreset construction on one device.

The construction is embarrassingly parallel over row bands (coresets of
disjoint sub-signals compose exactly — see streaming.py).  On a real
cluster each host builds the coreset of the row band whose data it owns
(data never leaves the host: only the tiny coresets are gathered), which is
how the paper's challenge (iv) (parallel training of a single tree) is met.
Here the per-band builds run on a thread pool (NumPy releases the GIL in the
hot loops), and each band's integral images dispatch ``sat_moments`` to the
card, several threads at once.

``fitting_loss_batched`` is the serving engine's batched scorer: the
dispatched ``repro_torch.ops.fitting_loss_batched``.  The multi-device half
of the reference module (the row-sharded integral images and the
mesh-sharded batched loss) is the mesh half of core/sharded.py
(ROADMAP.md, modules to port): ``mesh=`` takes only ``None`` until then.
"""
from __future__ import annotations

import concurrent.futures as _fut

import numpy as np

from .coreset import SignalCoreset, signal_coreset
from .fitting_loss import true_loss
from .segmentation import greedy_tree
from .stats import PrefixStats
from .streaming import compose, recompress

__all__ = ["sharded_coreset", "shared_tolerance", "band_bounds",
           "fitting_loss_batched"]


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


def fitting_loss_batched(cs: SignalCoreset, seg_rects: np.ndarray,
                         seg_labels: np.ndarray, *, backend: str | None = None,
                         mesh=None) -> np.ndarray:
    """Evaluate T candidate segmentations at once: seg_rects (T, K, 4),
    seg_labels (T, K).  Returns (T,).

    The dispatched ``repro_torch.ops.fitting_loss_batched`` (numpy oracle,
    plain torch on the CPU, or the batched CUDA kernel, by the selection
    rules or the explicit ``backend=``).  A ``mesh`` raises: the
    mesh-sharded scorer is not ported yet, and running it on one device
    instead would hide that."""
    if mesh is not None:
        raise NotImplementedError(
            "fitting_loss_batched(mesh=...) is not ported: the mesh-sharded "
            "scorer is the mesh half of core/sharded.py (ROADMAP.md, "
            "modules to port)")
    from repro_torch import ops
    return ops.fitting_loss_batched(cs, np.asarray(seg_rects),
                                    np.asarray(seg_labels), backend=backend)
