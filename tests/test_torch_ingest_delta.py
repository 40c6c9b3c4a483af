"""The port's write path on the CPU backends: delta-patched prefix stats and
the merge-reduce StreamingBuilder with band replacement.  Each is held
bitwise to a from-scratch build on the same backend and to the reference's
PrefixStats and StreamingBuilder on the same inputs (counterparts of the
library tests of tests/test_ingest_delta.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import (PrefixStats, StreamingBuilder,  # noqa: E402
                              fitting_loss, random_tree_segmentation)


@pytest.fixture(params=["numpy", "torch"])
def backend(request):
    ops.reset_dispatch_counts()
    with ops.backend_override(request.param):
        yield request.param


def _bitwise_equal(a, b) -> bool:
    return (np.array_equal(a.p0, b.p0) and np.array_equal(a.p1, b.p1)
            and np.array_equal(a.p2, b.p2))


# ---------------------------------------------------- prefix-stats patching
def test_random_append_replace_sequence_bitwise_equals_rebuild(backend):
    """Any interleaving of band appends and in-range row replacements through
    the delta path gives integral images bitwise equal to a build of the
    final signal, and to the reference's images after the same sequence."""
    rng = np.random.default_rng(0)
    m = 37                                       # off every tile quantum
    for trial in range(8):
        first = rng.integers(1, 9)
        y = rng.normal(size=(first, m))
        ps = PrefixStats.build(y)
        ref = ref_core.PrefixStats.build(y)
        for _ in range(rng.integers(3, 9)):
            if y.shape[0] >= 2 and rng.random() < 0.5:
                r0 = int(rng.integers(0, y.shape[0]))
                rows = int(rng.integers(1, y.shape[0] - r0 + 1))
                y[r0:r0 + rows] = rng.normal(size=(rows, m))
                ps = ps.patch_rows(r0, y[r0:])
                ref = ref.patch_rows(r0, y[r0:])
            else:
                band = rng.normal(size=(int(rng.integers(1, 7)), m))
                y = np.vstack([y, band])
                ps = ps.append_rows(band)
                ref = ref.append_rows(band)
        assert _bitwise_equal(ps, PrefixStats.build(y)), f"trial {trial}"
        assert _bitwise_equal(ps, ref), f"trial {trial}"
    assert ops.dispatch_counts()[("delta_sat", backend)] > 0


@pytest.mark.parametrize("r0,rows", [(0, 3), (9, 1), (11, 1), (0, 12), (4, 8)])
def test_patch_rows_awkward_placements_bitwise(backend, r0, rows):
    """1-row bands, a band at row 0, a band ending at the last row, and the
    whole signal at once: every placement is a bitwise-exact patch."""
    rng = np.random.default_rng(1)
    y = rng.normal(size=(12, 129))               # m % 128 != 0
    ps = PrefixStats.build(y)
    ref = ref_core.PrefixStats.build(y)
    y[r0:r0 + rows] = rng.normal(size=(rows, 129))
    got = ps.patch_rows(r0, y[r0:])
    assert got is ps                              # same row count: in place
    assert _bitwise_equal(got, PrefixStats.build(y))
    assert _bitwise_equal(got, ref.patch_rows(r0, y[r0:]))


def test_patch_rows_copy_leaves_previous_arrays_untouched(backend):
    rng = np.random.default_rng(2)
    y = rng.normal(size=(10, 8))
    ps = PrefixStats.build(y)
    before = ps.p1.copy()
    y2 = y.copy()
    y2[3:6] = 0.0
    ps2 = ps.patch_rows(3, y2[3:], copy=True)
    assert ps2 is not ps
    np.testing.assert_array_equal(ps.p1, before)     # reader-held arrays safe
    assert _bitwise_equal(ps2, PrefixStats.build(y2))
    assert _bitwise_equal(ps2, ref_core.PrefixStats.build(y).patch_rows(
        3, y2[3:], copy=True))


def test_patch_rows_validates_inputs(backend):
    ps = PrefixStats.build(np.zeros((4, 5)))
    with pytest.raises(ValueError):
        ps.patch_rows(0, np.zeros((2, 7)))           # column mismatch
    with pytest.raises(ValueError):
        ps.patch_rows(5, np.zeros((1, 5)))           # offset beyond n
    with pytest.raises(ValueError):
        ps.patch_rows(1, np.zeros((0, 5)))           # empty band


def test_append_then_replace_chain_keeps_carry_rows(backend):
    # the carry of a patch is the stored integral row above it: after an
    # append it must be the appended images' own row, not a rebuilt one
    rng = np.random.default_rng(3)
    y = rng.normal(size=(6, 11))
    ps = PrefixStats.build(y)
    band = rng.normal(size=(4, 11))
    ps = ps.append_rows(band)
    y = np.vstack([y, band])
    assert np.array_equal(ps.carry_row(7), PrefixStats.build(y).carry_row(7))
    assert np.array_equal(ps.carry_row(0), np.zeros((3, 11)))
    y[8:] = rng.normal(size=(2, 11))
    assert _bitwise_equal(ps.patch_rows(8, y[8:]), PrefixStats.build(y))


# ----------------------------------------------- streaming builder equivalence
def _feed(builder_cls, bands, **kw):
    sb = builder_cls(**kw)
    for b in bands:
        sb.insert_band(b)
    return sb


def test_streaming_replace_sequence_equivalent_to_rebuild(backend):
    """Inserts and band replacements give the coreset a from-scratch builder
    fed the final bands gives (the flush replays the exact cascade), and the
    reference's builder after the same calls: equal fingerprints, equal
    recompression counts, equal losses."""
    rng = np.random.default_rng(3)
    m = 33
    sizes = [7, 1, 16, 9, 1, 14]                     # awkward: 1-row bands
    bands = [rng.normal(size=(s, m)) for s in sizes]
    kw = dict(m=m, k=4, eps=0.3)
    sb = _feed(StreamingBuilder, bands, **kw)
    ref = _feed(ref_core.StreamingBuilder, bands, **kw)
    for idx in (0, 3, 5, 3):                          # first/last/repeat
        bands[idx] = rng.normal(size=bands[idx].shape)
        sb.replace_band(idx, bands[idx])
        ref.replace_band(idx, bands[idx])
    cs = sb.result()
    want_ref = ref.result()
    assert cs.fingerprint() == want_ref.fingerprint()
    assert sb.buckets_recompressed_total == ref.buckets_recompressed_total > 0

    want = _feed(StreamingBuilder, bands, **kw).result()
    assert cs.fingerprint() == want.fingerprint()
    n = sum(sizes)
    for _ in range(4):
        q = random_tree_segmentation(n, m, 4, rng)
        a = fitting_loss(cs, q.rects, q.labels)
        b = fitting_loss(want, q.rects, q.labels)
        assert abs(a - b) <= 1e-12 * max(abs(b), 1.0)
    assert ops.dispatch_counts()[("streaming_compress", backend)] > 0


def test_streaming_insert_after_replace_flushes_first(backend):
    """An insert whose cascade would merge a dirty bucket settles the pending
    replacement first; otherwise the stale leaf would be baked into a clean
    higher-level bucket that no flush could repair."""
    rng = np.random.default_rng(12)
    m = 20
    bands = [rng.normal(size=(8, m)) for _ in range(2)]
    kw = dict(m=m, k=3, eps=0.3)
    sb = _feed(StreamingBuilder, bands, **kw)
    ref = _feed(ref_core.StreamingBuilder, bands, **kw)
    bands[0] = rng.normal(size=(8, m))
    sb.replace_band(0, bands[0])          # level-1 bucket goes dirty
    ref.replace_band(0, bands[0])
    bands += [rng.normal(size=(8, m)) for _ in range(2)]
    for b in bands[2:]:
        sb.insert_band(b)                 # the cascade absorbs the dirty bucket
        ref.insert_band(b)
    cs = sb.result()
    assert cs.fingerprint() == _feed(StreamingBuilder, bands, **kw).result().fingerprint()
    assert cs.fingerprint() == ref.result().fingerprint()
    assert sb.buckets_recompressed_total == ref.buckets_recompressed_total


def test_streaming_replace_validates_and_counts_dirty(backend):
    rng = np.random.default_rng(4)
    bands = [rng.normal(size=(8, 10)) for _ in range(4)]
    kw = dict(m=10, k=3, eps=0.3)
    sb = _feed(StreamingBuilder, bands, **kw)
    ref = _feed(ref_core.StreamingBuilder, bands, **kw)
    with pytest.raises(ValueError):
        sb.replace_band(1, rng.normal(size=(9, 10)))  # wrong row count
    assert sb.dirty_buckets == 0
    new = rng.normal(size=(8, 10))
    sb.replace_band(1, new)
    ref.replace_band(1, new)
    assert sb.dirty_buckets == ref.dirty_buckets == 1  # one bucket, not all
    flushed = sb.flush_dirty()
    assert flushed == ref.flush_dirty() >= 1 and sb.dirty_buckets == 0
    assert sb.flush_dirty() == 0                      # idempotent
    assert sb.buckets_recompressed_total == flushed
    assert sb.result().fingerprint() == ref.result().fingerprint()
