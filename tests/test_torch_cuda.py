"""The repro_torch CUDA kernels on the card, against their plain PyTorch
versions and the numpy oracle.  Imports only the port (no jax), so it runs
on a CUDA host without the reference's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card every test here skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ops  # noqa: E402
from repro_torch.core import random_tree_segmentation, signal_coreset  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.kernels.fitting_loss import kernel as fl_kernel  # noqa: E402
from repro_torch.kernels.fitting_loss import ops as fl_ops  # noqa: E402
from repro_torch.kernels.sat2d import kernel as sat_kernel  # noqa: E402
from repro_torch.kernels.histsplit import kernel as hist_kernel  # noqa: E402
from repro_torch.kernels.histsplit import ops as hist_ops  # noqa: E402
from repro_torch.kernels.histsplit.ref import partials_ref  # noqa: E402
from repro_torch.kernels.sat2d import ops as sat_ops  # noqa: E402
from repro_torch.trees import RandomForestRegressor  # noqa: E402

pytestmark = pytest.mark.gpu

SHAPES = [(8, 8), (130, 70), (256, 256), (1, 300), (257, 5), (1000, 1000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _numpy_sat(y):
    return ops.sat_moments(y, backend="numpy")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


@pytest.mark.parametrize("shape", SHAPES)
def test_sat_f64_bitwise_equals_numpy(cuda, shape):
    y = np.random.default_rng(0).normal(size=shape)
    before = sat_kernel.SAT_MOMENTS_F64.launches
    got = sat_ops.sat_moments(torch.as_tensor(y, device=cuda)).cpu().numpy()
    assert sat_kernel.SAT_MOMENTS_F64.launches == before + 1
    assert np.array_equal(got, _numpy_sat(y))


def test_sat_keeps_numpy_signed_zero(cuda):
    # numpy's scan starts from the first element, not from 0 + it
    y = np.array([[-0.0, 1.0], [2.0, -0.0]])
    got = sat_ops.sat_moments(torch.as_tensor(y, device=cuda)).cpu().numpy()
    assert np.array_equal(np.signbit(got), np.signbit(_numpy_sat(y)))


@pytest.mark.parametrize("shape", SHAPES)
def test_sat_f32_matches_plain(cuda, shape):
    y = torch.as_tensor(np.random.default_rng(1).normal(size=shape),
                        dtype=torch.float32, device=cuda)
    got = sat_ops.sat_moments(y).cpu().numpy()
    want = sat_ops.sat_moments(y.cpu()).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-3)


def _coreset_and_trees(n, m, k, leaves, t):
    with ops.backend_override("numpy"):
        cs = signal_coreset(piecewise_signal(n, m, k, noise=0.2, seed=0), k, 0.3)
    rng = np.random.default_rng(1)
    segs = [random_tree_segmentation(n, m, leaves, rng) for _ in range(t)]
    return (cs, np.stack([s.rects for s in segs]).astype(np.float64),
            np.stack([s.labels for s in segs]))


# (n, m, coreset k, tree leaves, trees): B and T off every tile size, K = 1
@pytest.mark.parametrize("n,m,k,leaves,t", [
    (57, 41, 5, 7, 3), (60, 70, 6, 1, 5), (96, 64, 8, 16, 17),
    (512, 512, 32, 64, 300)])
def test_loss_matches_plain_and_oracle(cuda, n, m, k, leaves, t):
    cs, sr, sl = _coreset_and_trees(n, m, k, leaves, t)
    got = fl_ops.coreset_loss_batched(cs, sr, sl, device=cuda)
    plain = fl_ops.coreset_loss_batched(cs, sr, sl, device="cpu")
    assert _rel(got, plain).max() < 1e-4
    oracle = ops.fitting_loss_batched(cs, sr, sl, backend="numpy")
    assert _rel(got, oracle).max() < 1e-3
    assert _rel(ops.fitting_loss_batched(cs, sr, sl, backend="cuda"),
                oracle).max() < 1e-3


def test_tree_alone_equals_in_batch_bitwise(cuda):
    cs, sr, sl = _coreset_and_trees(96, 64, 8, 16, 40)
    batch = fl_ops.coreset_loss_batched(cs, sr, sl, device=cuda)
    padded = fl_ops.coreset_loss_batched(
        cs, np.concatenate([sr, np.zeros((40, 3, 4))], axis=1),
        np.concatenate([sl, np.zeros((40, 3))], axis=1), device=cuda)
    assert np.array_equal(batch, padded)
    before = fl_kernel.FITTING_LOSS.launches
    for t in (0, 17, 39):
        alone = fl_ops.coreset_loss_batched(cs, sr[t:t + 1], sl[t:t + 1],
                                            device=cuda)
        single = fl_ops.coreset_loss(cs, sr[t], sl[t], device=cuda)
        assert alone[0] == batch[t] == single
    assert fl_kernel.FITTING_LOSS.launches == before + 3


def test_cuda_backend_builds_the_numpy_fingerprint(cuda):
    y = piecewise_signal(300, 200, 8, seed=3)
    with ops.backend_override("numpy"):
        want = signal_coreset(y, 8, 0.3).fingerprint()
    with ops.backend_override("cuda"):
        assert signal_coreset(y, 8, 0.3).fingerprint() == want


# (P, F, n_bins) of tests/test_torch_histsplit.py, plus one P past a stage
# of every CTA and a tile count past the reduction's unroll
HIST_SHAPES = [(64, 1, 16), (700, 5, 32), (1030, 3, 256), (1030, 3, 17),
               (40_000, 2, 256)]


def _hist_inputs(P, F, B, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, size=(P, F)).astype(np.uint8)
    w = rng.uniform(0.1, 2, P)
    y = rng.normal(size=P)
    return codes, w, w * y, w * y * y


def _on(device, codes, *vals):
    return (torch.as_tensor(codes, device=device),
            *(torch.as_tensor(v, device=device) for v in vals))


@pytest.mark.parametrize("P,F,B", HIST_SHAPES)
def test_hist_f64_bitwise_equals_numpy(cuda, P, F, B):
    args = _hist_inputs(P, F, B)
    before = hist_kernel.HIST_F64.launches
    got = hist_ops.histograms(*_on(cuda, *args), B)
    assert hist_kernel.HIST_F64.launches == before + 1
    want = ops.hist_split(*args, B, backend="numpy")
    assert np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(ops.hist_split(*args, B, backend="cuda"), want)


@pytest.mark.parametrize("variant", ["fused", "legacy"])
@pytest.mark.parametrize("P,F,B", HIST_SHAPES)
def test_hist_f32_matches_plain(cuda, variant, P, F, B):
    args = _hist_inputs(P, F, B, seed=1)
    kern = hist_kernel.HIST_FUSED if variant == "fused" else hist_kernel.HIST_LEGACY
    before = kern.launches
    got = hist_ops.histograms(*_on(cuda, *args), B, variant=variant, tile_p=256)
    assert kern.launches == before + 1
    want = hist_ops.histograms(*_on("cpu", *args), B, variant=variant)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("P,F,B", HIST_SHAPES)
def test_hist_partials_match_plain_and_certificate(cuda, P, F, B):
    args = _hist_inputs(P, F, B, seed=2)
    codes, w, wy, wy2 = _on(cuda, *args)
    vals = hist_ops.pack_values(w, wy, wy2, "partials")
    parts = hist_kernel.histograms_cuda(codes, vals, B, variant="partials",
                                        tile_p=256)
    want_parts = partials_ref(codes.cpu(), vals.cpu(), B, 256)
    np.testing.assert_allclose(parts.cpu().numpy(), want_parts.numpy(),
                               rtol=2e-4, atol=2e-4)
    oracle = ops.hist_split(*args, B, backend="numpy")
    got = ops.hist_split(*args, B, backend="cuda", variant="partials",
                         tile_p=256)
    scale = np.abs(oracle).max(axis=(0, 1))
    assert (np.abs(got - oracle).max(axis=(0, 1)) <= 1e-6 * scale).all()


@pytest.mark.parametrize("P,F,B", HIST_SHAPES)
def test_hist_f32_kernels_equal_their_order_on_the_cpu(cuda, P, F, B):
    # each tile's sums are chains in point order (a CPU bincount's order),
    # and fused/legacy add the tiles in tile order: so all three equal the
    # CPU's float32 sums in that order bitwise
    args = _hist_inputs(P, F, B, seed=4)
    for variant in ("partials", "fused", "legacy"):
        vals = hist_ops.pack_values(*_on("cpu", *args)[1:], variant)
        parts = partials_ref(torch.from_numpy(args[0]), vals, B, 256)
        if variant == "partials":
            want = parts
        else:
            want = parts[0].clone()
            for c in range(1, parts.shape[0]):
                want += parts[c]
        got = hist_kernel.histograms_cuda(
            torch.as_tensor(args[0], device=cuda), vals.to(cuda), B,
            variant=variant, tile_p=256)
        assert torch.equal(got.cpu(), want)


def test_hist_fused_is_the_same_from_run_to_run(cuda):
    args = _on(cuda, *_hist_inputs(200_000, 2, 256, seed=3))
    first = hist_ops.histograms(*args, 256, variant="fused")
    for _ in range(3):
        assert torch.equal(hist_ops.histograms(*args, 256, variant="fused"),
                           first)


def test_hist_launcher_rejects_bins_past_one_cta(cuda):
    codes, w, wy, wy2 = _on(cuda, *_hist_inputs(64, 1, 16))
    vals = hist_ops.pack_values(w, wy, wy2, "f64")
    with pytest.raises(ValueError, match="n_bins"):
        hist_kernel.histograms_cuda(codes, vals, hist_kernel.MAX_BINS + 1)


def test_forest_on_the_card_equals_numpy(cuda):
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 10, size=(3000, 2))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.normal(size=3000)
    w = rng.uniform(0.2, 3.0, size=3000)
    kw = dict(n_estimators=3, max_leaves=64, random_state=5)
    want = RandomForestRegressor(hist_backend="numpy", **kw).fit(X, y, w)
    before = hist_kernel.HIST_F64.launches
    got = RandomForestRegressor(hist_backend="cuda", **kw).fit(X, y, w)
    assert hist_kernel.HIST_F64.launches > before
    for a, b in zip(got.trees, want.trees):
        assert [vars(n) for n in a.nodes] == [vars(n) for n in b.nodes]
    assert np.array_equal(got.predict(X), want.predict(X))
