"""The port's weighted CART, random forest and GBDT against the reference's:
on the numpy and torch histogram backends, every node, prediction and leaf
rectangle is bitwise the reference's on its numpy backend."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.trees as ref_trees  # noqa: E402
import repro_torch.trees as trees  # noqa: E402
from repro_torch import ops  # noqa: E402

BACKENDS = ["numpy", "torch"]


def _data(seed, P=400, F=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 10, size=(P, F))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.normal(size=P)
    w = rng.uniform(0.2, 3.0, size=P)          # coreset points are weighted
    Xq = rng.uniform(0, 10, size=(150, F))
    return X, y, w, Xq


def _nodes(tree):
    return [(nd.feature, nd.bin_thr, nd.threshold, nd.value, nd.left, nd.right)
            for nd in tree.nodes]


def _assert_same_tree(got, want, Xq):
    assert _nodes(got) == _nodes(want)
    assert np.array_equal(got.predict(Xq), want.predict(Xq))
    lo, hi = np.zeros(2), np.full(2, 10.0)
    for a, b in zip(got.leaf_rectangles(lo, hi), want.leaf_rectangles(lo, hi)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("leaves,bins,seed", [(2, 255, 0), (9, 32, 1),
                                              (31, 255, 2), (64, 64, 3)])
def test_cart_equals_reference(backend, leaves, bins, seed):
    X, y, w, Xq = _data(seed)
    want = ref_trees.DecisionTreeRegressor(
        max_leaves=leaves, max_bins=bins, hist_backend="numpy").fit(
            X, y, sample_weight=w)
    got = trees.DecisionTreeRegressor(
        max_leaves=leaves, max_bins=bins, hist_backend=backend).fit(
            X, y, sample_weight=w)
    _assert_same_tree(got, want, Xq)
    assert got.n_leaves == want.n_leaves


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("feature_fraction,bootstrap", [(1.0, True),
                                                        (0.5, True),
                                                        (1.0, False)])
def test_forest_equals_reference(backend, feature_fraction, bootstrap):
    X, y, w, Xq = _data(4, F=3)
    kw = dict(n_estimators=4, max_leaves=16, feature_fraction=feature_fraction,
              bootstrap=bootstrap, random_state=7)
    want = ref_trees.RandomForestRegressor(hist_backend="numpy", **kw).fit(
        X, y, sample_weight=w)
    got = trees.RandomForestRegressor(hist_backend=backend, **kw).fit(
        X, y, sample_weight=w)
    assert len(got.trees) == len(want.trees) == 4
    for a, b in zip(got.trees, want.trees):
        assert _nodes(a) == _nodes(b)
    assert np.array_equal(got.predict(Xq), want.predict(Xq))


@pytest.mark.parametrize("backend", BACKENDS)
def test_gbdt_equals_reference(backend):
    X, y, w, Xq = _data(5)
    kw = dict(n_estimators=6, learning_rate=0.2, max_leaves=8, max_bins=64)
    want = ref_trees.GradientBoostingRegressor(hist_backend="numpy", **kw).fit(
        X, y, sample_weight=w)
    got = trees.GradientBoostingRegressor(hist_backend=backend, **kw).fit(
        X, y, sample_weight=w)
    assert got.base_ == want.base_
    for a, b in zip(got.trees, want.trees):
        assert _nodes(a) == _nodes(b)
    assert np.array_equal(got.predict(Xq), want.predict(Xq))


def test_binning_equals_reference():
    X, *_ = _data(6, P=1000, F=3)
    edges = trees.quantile_bins(X, 255)
    want = ref_trees.quantile_bins(X, 255)
    assert all(np.array_equal(a, b) for a, b in zip(edges, want))
    codes = trees.apply_bins(X, edges)
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, ref_trees.apply_bins(X, want))


def test_tree_dispatches_one_hist_split_per_split_search():
    X, y, w, _ = _data(7)
    ops.reset_dispatch_counts()
    t = trees.DecisionTreeRegressor(max_leaves=5, hist_backend="torch").fit(
        X, y, sample_weight=w)
    assert ops.dispatch_counts() == {("hist_split", "torch"): len(t.nodes)}
    assert ops.dispatch_seconds()[("hist_split", "torch")] > 0


@pytest.mark.parametrize("name", ["jax", "xla", "pallas", "gpu"])
def test_hist_backend_names_are_checked(name):
    X, y, _, _ = _data(8, P=50)
    with pytest.raises(ValueError, match=r"valid: \['auto', 'cuda', 'numpy', 'torch'\]"):
        trees.DecisionTreeRegressor(max_leaves=3, hist_backend=name).fit(X, y)


def test_auto_without_a_card_raises(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, _, _ = _data(9, P=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trees.DecisionTreeRegressor(max_leaves=3).fit(X, y)
    monkeypatch.setenv(ops.ENV_VAR, "numpy")
    assert trees.DecisionTreeRegressor(max_leaves=3).fit(X, y).n_leaves == 3


def _weighted_and_duplicated(mod, seed):
    """tests/test_trees.py::test_weighted_equals_duplicated's two fits at
    one of its seeds: integer weights, then the rows duplicated."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(60, 2))
    y = rng.normal(size=60)
    w = rng.integers(1, 4, size=60)
    edges = mod.quantile_bins(X, 64)
    codes = mod.apply_bins(X, edges)
    t_w = mod.DecisionTreeRegressor(max_leaves=6, max_bins=64).fit(
        X, y, sample_weight=w.astype(float), bins=(edges, codes))
    t_d = mod.DecisionTreeRegressor(max_leaves=6, max_bins=64).fit(
        np.repeat(X, w, axis=0), np.repeat(y, w),
        bins=(edges, np.repeat(codes, w, axis=0)))
    q = rng.uniform(size=(40, 2))
    return t_w.predict(q), t_d.predict(q)


@pytest.mark.parametrize("seed", [3725, 7846])
def test_weighted_and_duplicated_fits_at_the_reference_s_failing_seeds(
        seed, monkeypatch):
    """At these seeds the reference's weighted and duplicated trees pick
    different splits (an exact gain tie broken differently), so its
    property test fails there.  The port holds the reference's behaviour:
    both of its fits equal the reference's bitwise."""
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    with ops.backend_override("numpy"):
        got_w, got_d = _weighted_and_duplicated(trees, seed)
    want_w, want_d = _weighted_and_duplicated(ref_trees, seed)
    assert np.array_equal(got_w, want_w)
    assert np.array_equal(got_d, want_d)
    assert not np.allclose(want_w, want_d, atol=1e-9)
