"""repro_torch Algorithm-5 loss: the plain versions against the reference's
interpret-mode Pallas kernels and numpy oracle (the CUDA kernels are held
to them in test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.core import fitting_loss as ref_fitting_loss  # noqa: E402
from repro.core import random_tree_segmentation as ref_random_tree  # noqa: E402
from repro.core import signal_coreset as ref_signal_coreset  # noqa: E402
from repro.data import piecewise_signal as ref_piecewise  # noqa: E402
from repro.kernels.fitting_loss import ops as ref_fl  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import SignalCoreset  # noqa: E402
from repro_torch.kernels.fitting_loss import kernel as fl_kernel  # noqa: E402
from repro_torch.kernels.fitting_loss import ops as fl_ops  # noqa: E402


def _coreset(n, m, k, eps=0.3, seed=0):
    return ref_signal_coreset(ref_piecewise(n, m, k, noise=0.2, seed=seed),
                              k, eps)


def _trees(n, m, k, t, seed=1):
    rng = np.random.default_rng(seed)
    segs = [ref_random_tree(n, m, k, rng) for _ in range(t)]
    return (np.stack([s.rects for s in segs]).astype(np.float64),
            np.stack([s.labels for s in segs]))


def _carried(cs):
    """The reference coreset as the port's, through from_arrays."""
    d = {f: getattr(cs, f) for f in (
        "n", "m", "k", "eps", "rects", "labels", "weights", "moments",
        "sigma", "tolerance", "max_slices", "build_seconds", "certified")}
    d["bicriteria"] = vars(cs.bicriteria)
    return SignalCoreset.from_arrays(d)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


# (n, m, coreset k, tree leaves, trees): B and T off every tile size, K = 1
CASES = [(57, 41, 5, 7, 3), (60, 70, 6, 1, 5), (33, 90, 4, 12, 9),
         (96, 64, 8, 16, 17)]


@pytest.mark.parametrize("n,m,k,leaves,t", CASES)
def test_plain_batched_matches_reference_pallas_and_oracle(n, m, k, leaves, t):
    cs = _coreset(n, m, k)
    sr, sl = _trees(n, m, leaves, t)
    got = fl_ops.coreset_loss_batched(_carried(cs), sr, sl, device="cpu")
    pallas = np.asarray(ref_fl.coreset_loss_batched(cs, sr, sl, interpret=True))
    oracle = np.array([ref_fitting_loss(cs, r, lab) for r, lab in zip(sr, sl)])
    assert got.shape == (t,)
    assert _rel(got, pallas).max() < 1e-5
    assert _rel(got, oracle).max() < 1e-3


@pytest.mark.parametrize("n,m,k,leaves,t", CASES)
def test_plain_single_matches_reference_pallas_and_oracle(n, m, k, leaves, t):
    cs = _coreset(n, m, k)
    sr, sl = _trees(n, m, leaves, 1, seed=t)
    got = fl_ops.coreset_loss(_carried(cs), sr[0], sl[0], device="cpu")
    pallas = float(ref_fl.coreset_loss(cs, sr[0], sl[0], interpret=True))
    assert _rel(got, pallas) < 1e-5
    assert _rel(got, ref_fitting_loss(cs, sr[0], sl[0])) < 1e-3


def test_carried_coreset_scores_alike_in_both_packages():
    cs = _coreset(64, 48, 6)
    port = _carried(cs)
    assert port.fingerprint() == cs.fingerprint()
    sr, sl = _trees(64, 48, 9, 6)
    assert np.array_equal(ops.fitting_loss_batched(port, sr, sl, backend="numpy"),
                          ref_ops.fitting_loss_batched(cs, sr, sl, backend="numpy"))
    for r, lab in zip(sr, sl):
        assert (ops.fitting_loss(port, r, lab, backend="numpy")
                == ref_ops.fitting_loss(cs, r, lab, backend="numpy"))
    torch_losses = ops.fitting_loss_batched(port, sr, sl, backend="torch")
    assert _rel(torch_losses, ref_ops.fitting_loss_batched(
        cs, sr, sl, backend="xla")).max() < 1e-5


def test_zero_area_padding_leaves_add_nothing():
    cs = _carried(_coreset(57, 41, 5))
    sr, sl = _trees(57, 41, 7, 4)
    padded_r = np.concatenate([sr, np.zeros((4, 5, 4))], axis=1)
    padded_l = np.concatenate([sl, np.zeros((4, 5))], axis=1)
    a = fl_ops.coreset_loss_batched(cs, sr, sl, device="cpu")
    b = fl_ops.coreset_loss_batched(cs, padded_r, padded_l, device="cpu")
    assert _rel(a, b).max() < 1e-6


def test_pack_layout():
    rects = torch.arange(8.).reshape(2, 4)
    blk = fl_kernel.pack_blocks(rects, rects + 10, rects + 20)
    assert blk.shape == (2, 16) and blk.dtype == torch.float32
    assert torch.equal(blk[:, 8:12], rects + 20)
    assert torch.equal(blk[:, 12:], torch.zeros(2, 4))
    seg = fl_kernel.pack_trees(torch.ones(3, 5, 4), torch.full((3, 5), 7.))
    assert seg.shape == (3, 5, 8)
    assert torch.equal(seg[..., 4], torch.full((3, 5), 7.))


def test_cuda_launcher_refuses_cpu_tensors():
    with pytest.raises((RuntimeError, ValueError)):
        fl_kernel.fitting_loss_batched_cuda(torch.zeros(3, 16),
                                            torch.zeros(1, 2, 8))


def test_launch_shape_refuses_empty_inputs():
    for B, T in ((0, 1), (1, 0), (2**31, 1)):
        with pytest.raises(ValueError):
            fl_kernel.launch_shape(B, T)


def _work_by_loops(rects, seg_rects, chunk):
    """kernel.work's counts by plain loops over every (tree, block, leaf)."""
    T, K = seg_rects.shape[:2]
    B = len(rects)
    chunks = -(-B // chunk)
    box, hits, live = [], [], []
    for t in range(T):
        z = np.zeros((chunks * chunk, K), bool)
        for b in range(B):
            for k in range(K):
                r0, r1, c0, c1 = rects[b]
                l0, l1, m0, m1 = seg_rects[t, k]
                z[b, k] = (max(min(r1, l1) - max(r0, l0), 0)
                           * max(min(c1, m1) - max(c0, m0), 0)) > 0
        box.append(chunks * K)
        hits.append(int(z.reshape(chunks, chunk, K).any(axis=1).sum()))
        live.append(int(z.sum()))
    return {"box_tests": box, "chunk_hits": hits, "live_pairs": live}


# (n, m, coreset k, tree leaves, trees, chunk): the loss kernel's 32-block
# chunks, one-block chunks, chunks that do not divide B and one wider than B
WORK_CASES = [(57, 41, 5, 7, 3, 32), (60, 70, 6, 1, 2, 32), (33, 90, 4, 12, 4, 32),
              (96, 64, 8, 16, 5, 32), (96, 64, 8, 16, 5, 1), (64, 48, 6, 9, 3, 4),
              (64, 48, 6, 9, 3, 7), (40, 40, 3, 5, 2, 1000)]


@pytest.mark.parametrize("n,m,k,leaves,t,chunk", WORK_CASES)
def test_work_counts_what_the_kernel_scores(n, m, k, leaves, t, chunk):
    cs = _coreset(n, m, k)
    sr, sl = _trees(n, m, leaves, t)
    got = fl_kernel.work(torch.as_tensor(cs.rects, dtype=torch.float32),
                         torch.as_tensor(sr, dtype=torch.float32), chunk)
    want = _work_by_loops(cs.rects, sr, chunk)
    assert {key: v.tolist() for key, v in got.items()} == want
    # a tree's leaves tile the plane, so every block meets one at least
    assert (got["live_pairs"] >= len(cs.rects)).all()
    assert (got["chunk_hits"] <= got["box_tests"]).all()
    assert (got["chunk_hits"] * chunk >= got["live_pairs"]).all()


def test_work_skips_zero_area_leaves():
    cs = _coreset(57, 41, 5)
    sr, _ = _trees(57, 41, 7, 3)
    rects = torch.as_tensor(cs.rects, dtype=torch.float32)
    padded = np.concatenate([sr[:, :3], np.zeros((3, 4, 4)), sr[:, 3:]], axis=1)
    a = fl_kernel.work(rects, torch.as_tensor(sr, dtype=torch.float32), 32)
    b = fl_kernel.work(rects, torch.as_tensor(padded, dtype=torch.float32), 32)
    assert torch.equal(a["live_pairs"], b["live_pairs"])
    assert torch.equal(a["chunk_hits"], b["chunk_hits"])
    assert torch.equal(b["box_tests"], a["box_tests"] // 7 * 11)


def _one_block_and_label(label):
    """The reference coreset of one block (0, 4, 0, 4) with labels
    (1, 2, 3, 4) and weights 4 each, and a tree of a leaf (0, 4, 0, 4)
    labelled 2 beside a zero-area leaf (4, 4, 0, 4) labelled ``label``."""
    from repro.core.bicriteria import BicriteriaResult
    from repro.core.coreset import SignalCoreset as RefCoreset
    labels = np.array([[1.0, 2.0, 3.0, 4.0]])
    weights = np.full((1, 4), 4.0)
    moments = np.array([[16.0, (weights * labels).sum(),
                         (weights * labels ** 2).sum()]])
    cs = RefCoreset(n=4, m=4, k=2, eps=0.3, rects=np.array([[0, 4, 0, 4]]),
                    labels=labels, weights=weights, moments=moments,
                    sigma=1.0, tolerance=1.0, max_slices=1,
                    bicriteria=BicriteriaResult(1.0, 1.0, 1.0, 1, 1, []),
                    build_seconds=0.0)
    rects = np.array([[0.0, 4.0, 0.0, 4.0], [4.0, 4.0, 0.0, 4.0]])
    return cs, rects, np.array([2.0, label])


@pytest.mark.parametrize("label", [np.nan, np.inf])
def test_non_finite_label_on_a_zero_area_leaf_follows_the_xla_backend(label):
    # the plain version's dense terms take 0 * label for the zero-area leaf,
    # as the reference's xla backend does, so both give NaN; the numpy
    # oracle skips the leaf and gives 24 (the CUDA kernel's answer,
    # tests/test_torch_cuda.py)
    cs, rects, labels = _one_block_and_label(label)
    port = _carried(cs)
    got = ops.fitting_loss(port, rects, labels, backend="torch")
    want = ref_ops.fitting_loss(cs, rects, labels, backend="xla")
    assert np.isnan(got) and np.isnan(want)
    got_b = ops.fitting_loss_batched(port, rects[None], labels[None],
                                     backend="torch")
    want_b = ref_ops.fitting_loss_batched(cs, rects[None], labels[None],
                                          backend="xla")
    assert np.isnan(got_b).all() and np.isnan(want_b).all()
    assert ops.fitting_loss(port, rects, labels, backend="numpy") == 24.0
    assert ref_ops.fitting_loss(cs, rects, labels, backend="numpy") == 24.0


# --------------------------------------------------------- deprecated shim
# the contract of the reference's shim (tests/test_ops.py): it warns once,
# scores a uniform candidate set through the fused batched op and a ragged
# one (differing leaf counts) a tree at a time
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_coreset_loss_many_shim_delegates_and_warns_once(backend):
    import warnings
    cs = _coreset(57, 41, 5, seed=10)
    port = _carried(cs)
    sr, sl = _trees(57, 41, 4, 3, seed=11)
    fl_ops._MANY_DEPRECATION_WARNED = False
    ref_fl._MANY_DEPRECATION_WARNED = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = fl_ops.coreset_loss_many(port, list(sr), list(sl), backend=backend)
        again = fl_ops.coreset_loss_many(port, list(sr), list(sl), backend=backend)
        pallas = np.asarray(ref_fl.coreset_loss_many(cs, list(sr), list(sl),
                                                     interpret=True))
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)
            and "repro_torch" in str(w.message)]
    assert len(deps) == 1                                     # warn once
    assert np.array_equal(got, again)
    assert np.array_equal(got, ops.fitting_loss_batched(port, sr, sl,
                                                        backend=backend))
    if backend == "numpy":                   # the reference's oracle, bitwise
        assert np.array_equal(got, ref_ops.fitting_loss_batched(
            cs, sr, sl, backend="numpy"))
    want = np.array([ref_fitting_loss(cs, r, lab) for r, lab in zip(sr, sl)])
    np.testing.assert_allclose(got, want, rtol=2e-3)         # the shim's bar
    np.testing.assert_allclose(got, pallas, rtol=2e-3)


def test_coreset_loss_many_shim_accepts_ragged_leaf_counts():
    cs = _coreset(57, 41, 5, seed=14)
    port = _carried(cs)
    rng = np.random.default_rng(15)
    segs = [ref_random_tree(57, 41, k, rng) for k in (3, 6)]
    rects, labels = [s.rects for s in segs], [s.labels for s in segs]
    fl_ops._MANY_DEPRECATION_WARNED = False
    with pytest.warns(DeprecationWarning, match="fitting_loss_batched"):
        got = fl_ops.coreset_loss_many(port, rects, labels, backend="numpy")
    want = np.array([ref_fitting_loss(cs, s.rects, s.labels) for s in segs])
    assert np.array_equal(got, [ref_ops.fitting_loss(cs, r, lab, backend="numpy")
                                for r, lab in zip(rects, labels)])
    np.testing.assert_allclose(got, want, rtol=2e-3)
    ref_fl._MANY_DEPRECATION_WARNED = True
    pallas = np.asarray(ref_fl.coreset_loss_many(cs, rects, labels,
                                                 interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-3)
    assert "coreset_loss_many" in fl_ops.__all__
