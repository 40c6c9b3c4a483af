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
from repro_torch.kernels.sat2d import ops as sat_ops  # noqa: E402

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
