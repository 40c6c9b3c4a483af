"""The port's coreset build end to end on the numpy and torch backends:
bitwise the reference's (same fingerprint), data generators included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.data as ref_data  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.data as data  # noqa: E402
from repro_torch import ops  # noqa: E402

BACKENDS = ["numpy", "torch"]


def _points(mod, name, seed):
    kw = dict(n=3000, seed=seed)
    X, y = getattr(mod, name)(**kw)
    return mod.rasterize(X, y, n=64, m=72)


GENERATORS = {
    "piecewise": lambda mod, s: mod.piecewise_signal(96, 80, 6, seed=s),
    "smooth": lambda mod, s: mod.smooth_field(64, 128, seed=s),
    "sensor": lambda mod, s: mod.sensor_matrix(n=128, m=15, seed=s),
    "blobs": lambda mod, s: _points(mod, "blobs", s),
    "moons": lambda mod, s: _points(mod, "moons", s),
    "circles": lambda mod, s: _points(mod, "circles", s),
}


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generators_give_the_reference_signals(gen):
    make = GENERATORS[gen]
    assert np.array_equal(make(data, 4), make(ref_data, 4))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_fingerprint_equals_reference_per_generator(backend, gen):
    y = GENERATORS[gen](data, 1)
    want = ref_core.signal_coreset(y, 6, 0.3).fingerprint()
    with ops.backend_override(backend):
        assert core.signal_coreset(y, 6, 0.3).fingerprint() == want


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,eps,fidelity", [
    (3, 0.2, "practical"), (8, 0.5, "practical"), (16, 0.1, "practical"),
    (2, 0.5, "paper"), (4, 0.4, "paper")])
def test_fingerprint_equals_reference_per_parameters(backend, k, eps, fidelity):
    y = data.piecewise_signal(48, 64, 5, noise=0.2, seed=2)
    ref = ref_core.signal_coreset(y, k, eps, fidelity=fidelity)
    with ops.backend_override(backend):
        got = core.signal_coreset(y, k, eps, fidelity=fidelity)
    assert got.fingerprint() == ref.fingerprint()
    assert (got.sigma, got.certified, got.max_slices) == (
        ref.sigma, ref.certified, ref.max_slices)


@pytest.mark.parametrize("backend", BACKENDS)
def test_signal_coreset_to_size_equals_reference(backend):
    y = data.smooth_field(64, 64, seed=5)
    want = ref_core.signal_coreset_to_size(y, 6, 0.05)
    with ops.backend_override(backend):
        got = core.signal_coreset_to_size(y, 6, 0.05)
    assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("backend", BACKENDS)
def test_true_loss_and_prefix_stats_equal_reference(backend):
    y = data.piecewise_signal(70, 50, 6, seed=7)
    seg = core.random_tree_segmentation(70, 50, 9, np.random.default_rng(3))
    with ops.backend_override(backend):
        ps = core.PrefixStats.build(y)
        got = core.true_loss(y, seg.rects, seg.labels)
    ref = ref_core.PrefixStats.build(y)
    for a, b in zip((ps.p0, ps.p1, ps.p2), (ref.p0, ref.p1, ref.p2)):
        assert np.array_equal(a, b)
    assert got == ref_core.true_loss(y, seg.rects, seg.labels)


def test_prefix_stats_host_builders_equal_reference():
    rng = np.random.default_rng(8)
    y = rng.normal(size=(20, 30))
    mask = rng.uniform(size=y.shape) > 0.3
    rows, cols = rng.integers(0, 20, 50), rng.integers(0, 30, 50)
    lab, w = rng.normal(size=50), rng.uniform(size=50)
    pairs = [
        (core.PrefixStats.build(y, mask=mask), ref_core.PrefixStats.build(y, mask=mask)),
        (core.PrefixStats.build_moments(y, y, y * y, mask=mask),
         ref_core.PrefixStats.build_moments(y, y, y * y, mask=mask)),
        (core.PrefixStats.from_points(20, 30, rows, cols, lab, w),
         ref_core.PrefixStats.from_points(20, 30, rows, cols, lab, w)),
        (core.PrefixStats.build(y, mask=mask).transpose(),
         ref_core.PrefixStats.build(y, mask=mask).transpose()),
    ]
    for got, want in pairs:
        for a, b in zip((got.p0, got.p1, got.p2), (want.p0, want.p1, want.p2)):
            assert np.array_equal(a, b)


def test_arrays_round_trip():
    y = data.piecewise_signal(40, 40, 4, seed=9)
    with ops.backend_override("numpy"):
        cs = core.signal_coreset(y, 4, 0.3)
    d = cs.to_arrays()
    assert all(isinstance(d[f], np.ndarray) for f in ("rects", "labels",
                                                      "weights", "moments"))
    assert isinstance(d["bicriteria"], dict)
    back = core.SignalCoreset.from_arrays(d)
    assert back.fingerprint() == cs.fingerprint()
    assert back.to_arrays()["bicriteria"] == d["bicriteria"]
    assert (back.sigma, back.tolerance, back.max_slices, back.certified) == (
        cs.sigma, cs.tolerance, cs.max_slices, cs.certified)


def test_mask_branch_has_reference_fingerprint():
    y = data.piecewise_signal(48, 40, 4, seed=0)
    mask = np.ones_like(y, bool)
    mask[10:20, 5:15] = False
    got = core.signal_coreset(y, 4, 0.3, mask=mask)
    assert got.fingerprint() == ref_core.signal_coreset(
        y, 4, 0.3, mask=mask).fingerprint()
    assert got.total_mass() == pytest.approx(mask.sum())
