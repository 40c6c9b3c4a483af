"""repro_torch sat_moments: the plain versions against the reference's
numpy oracle and its interpret-mode Pallas kernel (the CUDA kernel is held
to them in test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.kernels.sat2d import ops as ref_sat  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.kernels.sat2d import kernel as sat_kernel  # noqa: E402
from repro_torch.kernels.sat2d import ops as sat_ops  # noqa: E402

# the shapes of the reference's sat2d sweep (tests/test_kernels.py)
SHAPES = [(8, 8), (130, 70), (256, 256), (1, 300), (257, 5)]


def _signal(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("shape", SHAPES + [(1000, 1000)])
def test_plain_f64_bitwise_equals_reference_numpy(shape):
    y = _signal(shape)
    want = ref_ops.sat_moments(y, backend="numpy")
    got = sat_ops.sat_moments(torch.as_tensor(y)).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("shape", [(130, 70), (257, 5)])
def test_dispatched_backends_bitwise_equal_reference(backend, shape):
    y = _signal(shape, seed=3)
    assert np.array_equal(ops.sat_moments(y, backend=backend),
                          ref_ops.sat_moments(y, backend="numpy"))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_f32_matches_reference_pallas_interpret(shape):
    import jax.numpy as jnp
    y = _signal(shape).astype(np.float32)
    want = np.asarray(ref_sat.sat_moments(jnp.asarray(y), interpret=True))
    got = sat_ops.sat_moments(torch.as_tensor(y)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-3)


def test_cuda_launcher_refuses_cpu_tensor():
    with pytest.raises((RuntimeError, ValueError)):
        sat_kernel.sat_moments_cuda(torch.zeros(4, 4, dtype=torch.float64))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_dispatched_f32_matches_reference_pallas_interpret(backend):
    import jax.numpy as jnp
    y = _signal((90, 40), seed=5)
    got = ops.sat_moments(y, backend=backend, dtype=np.float32)
    want = np.asarray(ref_sat.sat_moments(jnp.asarray(y, jnp.float32),
                                          interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-3)
