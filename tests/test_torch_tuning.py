"""The port's §5 tuning path against the reference's: the held-out patch
mask, the masked coreset build, the k sweep over full / coreset / uniform
training sets, coreset model selection and the signal-tree config."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.data as ref_data  # noqa: E402
import repro.trees as ref_trees  # noqa: E402
from repro.configs.signal_tree import CONFIG as REF_CONFIG  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.data as data  # noqa: E402
import repro_torch.trees as trees  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.configs import CONFIG, SignalTreeConfig  # noqa: E402


@pytest.mark.parametrize("n,m,frac,patch,seed", [(600, 15, 0.3, 5, 1),
                                                 (40, 50, 0.1, 3, 2),
                                                 (4, 4, 0.5, 5, 3)])
def test_patch_mask_equals_reference(n, m, frac, patch, seed):
    got = data.patch_mask(n, m, frac, patch, seed=seed)
    want = ref_data.patch_mask(n, m, frac, patch, seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not (got[0] & got[1]).any()


def _masked(seed=0, n=300, m=15):
    y = data.sensor_matrix(n, m, seed=seed)
    train, test = data.patch_mask(n, m, 0.3, 5, seed=seed + 1)
    return y, train, test


@pytest.mark.parametrize("k,eps,seed", [(8, 0.3, 0), (64, 0.4, 1),
                                        (16, 0.2, 2)])
def test_masked_coreset_has_reference_fingerprint(k, eps, seed):
    y, train, _ = _masked(seed)
    got = core.signal_coreset(y, k, eps, mask=train)
    want = ref_core.signal_coreset(y, k, eps, mask=train)
    assert got.fingerprint() == want.fingerprint()
    # held-out cells carry no mass
    assert got.total_mass() == pytest.approx(train.sum())


@pytest.mark.parametrize("k,frac", [(64, 0.02), (16, 0.1)])
def test_masked_coreset_to_size_has_reference_fingerprint(k, frac):
    y, train, _ = _masked(3, n=600)
    got = core.signal_coreset_to_size(y, k, frac, mask=train)
    want = ref_core.signal_coreset_to_size(y, k, frac, mask=train)
    assert got.fingerprint() == want.fingerprint()


def test_compose_equals_reference():
    y = data.piecewise_signal(64, 40, 4, seed=5)
    bands = [(0, 24), (24, 64)]
    with ops.backend_override("numpy"):
        parts = [core.signal_coreset(y[a:b], 4, 0.3) for a, b in bands]
    got = core.compose(parts, [a for a, _ in bands], 64)
    want = ref_core.compose([ref_core.signal_coreset(y[a:b], 4, 0.3)
                             for a, b in bands], [a for a, _ in bands], 64)
    assert got.fingerprint() == want.fingerprint()
    with pytest.raises(ValueError):
        core.compose([], [], 0)


def test_points_and_uniform_sample_equal_reference():
    y, train, _ = _masked(4)
    X, v = trees.signal_to_points(y, train)
    rX, rv = ref_trees.signal_to_points(y, train)
    assert np.array_equal(X, rX) and np.array_equal(v, rv)
    got = trees.uniform_sample(X, v, 100, np.random.default_rng(6))
    want = ref_trees.uniform_sample(rX, rv, 100, np.random.default_rng(6))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_tune_k_equals_reference(backend):
    # the reference's own integration size (tests/test_tuning_integration.py)
    y = data.sensor_matrix(600, 15, seed=0)
    train, test = data.patch_mask(*y.shape, 0.3, 5, seed=1)
    kw = dict(ks=[8, 32], eps=0.4, coreset_k=64, n_estimators=3)
    want = ref_trees.tune_k(y, train, test, hist_backend="numpy", **kw)
    got = trees.tune_k(y, train, test, hist_backend=backend, **kw)
    assert got.losses == want.losses
    assert got.best_k == want.best_k and got.sizes == want.sizes
    assert got.ks == [8, 32]
    assert min(got.losses["coreset"]) <= 2.0 * min(got.losses["full"])


def test_tune_k_to_size_equals_reference():
    y = data.sensor_matrix(400, 15, seed=2)
    train, test = data.patch_mask(*y.shape, 0.3, 5, seed=3)
    kw = dict(ks=[4, 16], coreset_k=16, target_frac=0.05, n_estimators=2,
              methods=("coreset", "uniform"))
    want = ref_trees.tune_k(y, train, test, hist_backend="numpy", **kw)
    got = trees.tune_k(y, train, test, hist_backend="numpy", **kw)
    assert got.losses == want.losses and got.sizes == want.sizes
    assert set(got.times) == {"coreset", "uniform"}


def test_tune_k_auto_without_a_card_raises(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, train, test = _masked(5, n=60)
    ops.reset_dispatch_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trees.tune_k(y, train, test, ks=[4], n_estimators=1)
    assert ops.dispatch_counts() == {}          # no forest ran on the CPU


def _candidates(n, m, cs_k, t=6, leaves=8):
    y, train, _ = _masked(6, n=n, m=m)
    cs = core.signal_coreset(y, cs_k, 0.3, mask=train)
    ref_cs = ref_core.signal_coreset(y, cs_k, 0.3, mask=train)
    assert cs.fingerprint() == ref_cs.fingerprint()
    rng = np.random.default_rng(7)
    segs = [core.random_tree_segmentation(n, m, leaves, rng) for _ in range(t)]
    return (cs, ref_cs, np.stack([s.rects for s in segs]).astype(np.float64),
            np.stack([s.labels for s in segs]))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_best_segmentation_agrees_with_reference(backend):
    cs, ref_cs, sr, sl = _candidates(120, 15, 8)
    want_losses = ref_trees.score_segmentations(ref_cs, sr, sl, backend="numpy")
    want_i, want_loss = ref_trees.best_segmentation(ref_cs, sr, sl,
                                                    backend="numpy")
    losses = trees.score_segmentations(cs, sr, sl, backend=backend)
    i, loss = trees.best_segmentation(cs, sr, sl, backend=backend)
    if backend == "numpy":
        assert np.array_equal(losses, want_losses)
        assert (i, loss) == (want_i, want_loss)
    else:   # float32 losses: the reference's 1e-3 bar against the oracle
        np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
        assert loss == pytest.approx(want_losses[i], rel=1e-3)
        assert want_losses[i] <= want_loss * (1 + 1e-3)


def test_signal_tree_config_matches_reference():
    assert isinstance(CONFIG, SignalTreeConfig)
    assert vars(CONFIG) == vars(REF_CONFIG)
    y, train, _ = _masked(8, n=200)
    got = CONFIG.build(y, mask=train)
    assert got.fingerprint() == REF_CONFIG.build(y, mask=train).fingerprint()
    eps_cfg = SignalTreeConfig(target_frac=None, k=8)
    with ops.backend_override("numpy"):
        got = eps_cfg.build(y)
    assert got.fingerprint() == ref_core.signal_coreset(
        y, 8, eps_cfg.eps).fingerprint()


@pytest.mark.parametrize("solver,cls,leaves", [
    ("forest", "RandomForestRegressor", 256),
    ("tree", "DecisionTreeRegressor", 256),
    ("gbdt", "GradientBoostingRegressor", 64)])
def test_signal_tree_config_makes_its_solver(solver, cls, leaves):
    cfg = SignalTreeConfig(solver=solver)
    model = cfg.make_solver()
    assert type(model).__name__ == cls and model.max_leaves == leaves
    assert type(model).__module__.startswith("repro_torch.trees")
    X, v = trees.signal_to_points(data.sensor_matrix(40, 15, seed=9))
    model.hist_backend = "numpy"
    assert np.isfinite(model.fit(X, v).predict(X[:10])).all()
