"""The port's merge-reduce on the CPU backends: compose, recompress
(``ops.streaming_compress``), the StreamingBuilder and the band-parallel
``sharded_coreset``, each fingerprint-equal to the reference on the same
inputs (counterparts of tests/test_streaming.py and of the
streaming_compress cases of tests/test_ops.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.sharded as ref_sharded  # noqa: E402
from repro import ops as ref_ops  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import (SignalCoreset, StreamingBuilder,  # noqa: E402
                              band_bounds, compose, fitting_loss,
                              random_tree_segmentation, recompress,
                              shared_tolerance, sharded_coreset,
                              signal_coreset, true_loss)
from repro_torch.data import piecewise_signal  # noqa: E402


@pytest.fixture(params=["numpy", "torch"])
def backend(request):
    ops.reset_dispatch_counts()
    with ops.backend_override(request.param):
        yield request.param


def _carried(cs):
    """The reference coreset as the port's, through from_arrays."""
    d = {f: getattr(cs, f) for f in SignalCoreset._SCALARS + SignalCoreset._ARRAYS}
    d["bicriteria"] = vars(cs.bicriteria)
    return SignalCoreset.from_arrays(d)


def _err(cs, y, seg):
    tl = true_loss(y, seg.rects, seg.labels)
    return abs(fitting_loss(cs, seg.rects, seg.labels) - tl) / max(tl, 1e-12)


def test_compose_equals_union_semantics(backend):
    rng = np.random.default_rng(0)
    y = piecewise_signal(80, 60, 6, noise=0.15, seed=0)
    cs = sharded_coreset(y, 6, 0.3, num_bands=4)
    assert cs.fingerprint() == ref_core.sharded_coreset(
        y, 6, 0.3, num_bands=4).fingerprint()
    assert np.isclose(cs.total_mass(), y.size)
    for _ in range(6):
        q = random_tree_segmentation(80, 60, 6, rng)
        assert _err(cs, y, q) <= 0.3


def test_recompress_shrinks_and_keeps_guarantee(backend):
    rng = np.random.default_rng(1)
    y = piecewise_signal(90, 70, 8, noise=0.2, seed=1)
    cs = sharded_coreset(y, 8, 0.3, num_bands=6, share_tolerance=False)
    rc = recompress(cs)
    ref = ref_core.sharded_coreset(y, 8, 0.3, num_bands=6,
                                   share_tolerance=False)
    assert rc.fingerprint() == ref_core.recompress(ref).fingerprint()
    assert rc.size <= cs.size
    assert np.isclose(rc.total_mass(), y.size)
    q = random_tree_segmentation(90, 70, 8, rng)
    assert _err(rc, y, q) <= 0.6   # two eps layers of merge-reduce
    assert ops.dispatch_counts()[("streaming_compress", backend)] == 1


def test_streaming_builder_bounded_and_accurate(backend):
    rng = np.random.default_rng(2)
    y = piecewise_signal(120, 50, 6, noise=0.15, seed=2)
    sb = StreamingBuilder(m=50, k=6, eps=0.3)
    ref = ref_core.StreamingBuilder(m=50, k=6, eps=0.3)
    for i in range(0, 120, 20):
        sb.insert_band(y[i:i + 20])
        ref.insert_band(y[i:i + 20])
    cs = sb.result()
    assert cs.fingerprint() == ref.result().fingerprint()
    assert (sb.max_level, sb.rows_seen, sb.num_bands) == (
        ref.max_level, ref.rows_seen, ref.num_bands)
    assert np.isclose(cs.total_mass(), y.size)
    q = random_tree_segmentation(120, 50, 6, rng)
    assert _err(cs, y, q) <= 0.6


def test_compose_is_order_invariant_under_row_offsets(backend):
    """compose() is exact concatenation: feeding the per-band coresets in a
    shuffled order (with matching offsets) gives identical losses and
    identical (sorted) block geometry."""
    y = piecewise_signal(64, 40, 5, noise=0.15, seed=4)
    bounds = [(0, 16), (16, 40), (40, 64)]
    parts = [signal_coreset(y[a:b], 5, 0.3) for a, b in bounds]
    offs = [a for a, _ in bounds]
    cs_sorted = compose(parts, offs, n_total=64)
    order = [2, 0, 1]
    cs_shuf = compose([parts[i] for i in order], [offs[i] for i in order],
                      n_total=64)
    ref_parts = [ref_core.signal_coreset(y[a:b], 5, 0.3) for a, b in bounds]
    assert cs_shuf.fingerprint() == ref_core.compose(
        [ref_parts[i] for i in order], [offs[i] for i in order],
        n_total=64).fingerprint()
    key = lambda cs: np.lexsort(cs.rects.T[::-1])  # noqa: E731
    np.testing.assert_array_equal(cs_sorted.rects[key(cs_sorted)],
                                  cs_shuf.rects[key(cs_shuf)])
    q = random_tree_segmentation(64, 40, 5, np.random.default_rng(4))
    assert np.isclose(fitting_loss(cs_sorted, q.rects, q.labels),
                      fitting_loss(cs_shuf, q.rects, q.labels))
    for cs in (cs_sorted, cs_shuf):
        assert cs.rects[:, 0].min() == 0 and cs.rects[:, 1].max() == 64


def test_streaming_cascade_offsets_tile_the_domain(backend):
    """Uneven bands force multi-level bucket cascades; without recompression
    the merged rects tile [0,n) x [0,m) exactly and the moments match the
    signal."""
    n, m = 110, 30
    y = piecewise_signal(n, m, 5, noise=0.1, seed=5)
    sb = StreamingBuilder(m=m, k=5, eps=0.3, recompress_levels=False)
    ref = ref_core.StreamingBuilder(m=m, k=5, eps=0.3, recompress_levels=False)
    r = 0
    for s in [10, 30, 15, 25, 20, 10]:   # 6 bands -> buckets at levels 1 and 2
        sb.insert_band(y[r:r + s])
        ref.insert_band(y[r:r + s])
        r += s
    assert sb.rows_seen == n and sb.max_level >= 1
    cs = sb.result()
    assert cs.fingerprint() == ref.result().fingerprint()
    areas = ((cs.rects[:, 1] - cs.rects[:, 0])
             * (cs.rects[:, 3] - cs.rects[:, 2]))
    assert int(areas.sum()) == n * m               # tiling: no gap/overlap
    assert np.isclose(cs.moments[:, 0].sum(), n * m)
    assert np.isclose(cs.moments[:, 1].sum(), y.sum())
    assert np.isclose(cs.moments[:, 2].sum(), (y * y).sum())
    for (a, b) in [(0, 10), (40, 55), (90, 110)]:
        covered = ((np.minimum(cs.rects[:, 1], b) - np.maximum(cs.rects[:, 0], a)).clip(0)
                   * (cs.rects[:, 3] - cs.rects[:, 2]))
        assert int(covered.sum()) == (b - a) * m
    assert ("streaming_compress", backend) not in ops.dispatch_counts()


def test_recompress_after_out_of_order_compose_keeps_moments(backend):
    rng = np.random.default_rng(6)
    y = piecewise_signal(96, 32, 6, noise=0.15, seed=6)
    bounds = [(48, 96), (0, 48)]                    # deliberately unsorted
    parts = [signal_coreset(y[a:b], 6, 0.3) for a, b in bounds]
    cs = compose(parts, [a for a, _ in bounds], n_total=96)
    rc = recompress(cs)
    ref = ref_core.compose([ref_core.signal_coreset(y[a:b], 6, 0.3)
                            for a, b in bounds], [a for a, _ in bounds],
                           n_total=96)
    assert rc.fingerprint() == ref_core.recompress(ref).fingerprint()
    assert np.isclose(rc.total_mass(), y.size)
    assert np.isclose(rc.moments[:, 1].sum(), cs.moments[:, 1].sum())
    q = random_tree_segmentation(96, 32, 6, rng)
    assert _err(rc, y, q) <= 0.6


def test_shared_tolerance_matches_single_build_size(backend):
    y = piecewise_signal(100, 80, 10, noise=0.2, seed=3)
    full = signal_coreset(y, 10, 0.3)
    sh = sharded_coreset(y, 10, 0.3, num_bands=4)   # share_tolerance=True
    assert sh.size <= 3 * full.size
    assert shared_tolerance(y, 10, 0.3) == ref_sharded.shared_tolerance(
        y, 10, 0.3)


# ------------------------------------------------------ sharded_coreset parity
@pytest.mark.parametrize("recompress_result", [False, True])
@pytest.mark.parametrize("num_bands", [1, 3, 4])
def test_sharded_coreset_equals_reference(backend, num_bands, recompress_result):
    y = piecewise_signal(72, 56, 6, noise=0.2, seed=7)
    got = sharded_coreset(y, 6, 0.3, num_bands,
                          recompress_result=recompress_result)
    want = ref_core.sharded_coreset(y, 6, 0.3, num_bands,
                                    recompress_result=recompress_result)
    assert got.fingerprint() == want.fingerprint()
    assert (got.sigma, got.tolerance, got.certified) == (
        want.sigma, want.tolerance, want.certified)


def test_band_bounds_equal_reference():
    for n, bands in ((10, 3), (7, 7), (5, 8), (2048, 8)):
        assert band_bounds(n, bands) == ref_sharded.band_bounds(n, bands)


# ------------------------------------------- ops.streaming_compress parity
def _buckets():
    y = piecewise_signal(64, 44, 5, noise=0.15, seed=23)
    parts = [ref_core.signal_coreset(y[a:b], 5, 0.3)
             for a, b in ((0, 32), (32, 64))]
    # ragged buckets: two of the whole signal (in either order) and one band
    return [ref_core.compose(parts, [0, 32], n_total=64),
            ref_core.compose(list(reversed(parts)), [32, 0], n_total=64),
            ref_core.compose(parts[:1], [0], n_total=32)]


def test_streaming_compress_batched_equals_reference_oracle(backend):
    """One dispatch recompresses ragged buckets; the float64 backends give
    the reference numpy oracle's coresets, fingerprint for fingerprint."""
    buckets = _buckets()
    want = ref_ops.streaming_compress(buckets, backend="numpy")
    got = ops.streaming_compress([_carried(b) for b in buckets])
    assert len(got) == len(buckets)
    assert [g.fingerprint() for g in got] == [w.fingerprint() for w in want]
    assert ops.dispatch_counts() == {("streaming_compress", backend): 1}


@pytest.mark.parametrize("k,eps", [(None, None), (3, 0.5)])
def test_streaming_compress_overrides_k_and_eps(backend, k, eps):
    buckets = _buckets()[:1]
    want = ref_ops.streaming_compress(buckets, k, eps, backend="numpy")
    got = ops.streaming_compress([_carried(b) for b in buckets], k, eps)
    assert got[0].fingerprint() == want[0].fingerprint()
    assert (got[0].k, got[0].eps) == (k or 5, eps or 0.3)


def test_streaming_compress_f32_keeps_moments_and_losses():
    """dtype "float32" (the TPU kernel's type): the block moments stay exact
    float64 (the rasters' sums never route through float32) and the losses
    agree with the oracle's within the reference's own 10 % bar."""
    buckets = [_carried(b) for b in _buckets()]
    ref = ops.streaming_compress(buckets, backend="numpy")
    got = ops.streaming_compress(buckets, backend="torch",
                                 config={"dtype": "float32"})
    q = random_tree_segmentation(64, 44, 5, np.random.default_rng(24))
    for g, r, b in zip(got, ref, buckets):
        assert np.isclose(g.total_mass(), b.total_mass())
        assert np.isclose(g.moments[:, 1].sum(), b.moments[:, 1].sum())
        assert np.isclose(g.moments[:, 2].sum(), b.moments[:, 2].sum())
        np.testing.assert_allclose(fitting_loss(g, q.rects, q.labels),
                                   fitting_loss(r, q.rects, q.labels), rtol=0.1)


def test_streaming_compress_empty_and_single(backend):
    assert ops.streaming_compress([]) == []
    cs = _carried(_buckets()[0])
    via_op = ops.streaming_compress([cs])[0]
    assert via_op.fingerprint() == recompress(cs).fingerprint()
