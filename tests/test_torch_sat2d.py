"""repro_torch sat2d: sat, sat_moments, delta_sat and sat_stack, the plain
versions against the reference's numpy oracle, PrefixStats.build_moments
and its interpret-mode Pallas kernels (the CUDA kernels are held to them in
test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro import ops as ref_ops  # noqa: E402
from repro.kernels.sat2d import ops as ref_sat  # noqa: E402
from repro.kernels.sat2d.ref import sat2d_ref as ref_sat2d_ref  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.kernels.sat2d import kernel as sat_kernel  # noqa: E402
from repro_torch.kernels.sat2d import ops as sat_ops  # noqa: E402
from repro_torch.kernels.sat2d import ref as sat_ref  # noqa: E402

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
    got = ops.sat_moments(y, backend=backend, config={"dtype": "float32"})
    want = np.asarray(ref_sat.sat_moments(jnp.asarray(y, jnp.float32),
                                          interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-3)


# ------------------------------------------------------------------- sat
@pytest.mark.parametrize("shape", SHAPES)
def test_sat_plain_f64_bitwise_equals_the_reference_order(shape):
    # the reference's sat2d_ref sums down the columns, then along the rows;
    # in float64 that is numpy's cumsum of a cumsum, which the plain
    # version keeps bitwise
    x = _signal(shape, seed=7)
    got = sat_ops.sat(torch.as_tensor(x))
    assert got.dtype == torch.float64
    assert torch.equal(got, sat_ref.sat2d_ref(torch.as_tensor(x)))
    assert np.array_equal(got.numpy(), np.cumsum(np.cumsum(x, axis=0), axis=1))


@pytest.mark.parametrize("shape", SHAPES)
def test_sat_f32_matches_reference_sat_interpret_and_sat2d_ref(shape):
    import jax.numpy as jnp
    x = _signal(shape, seed=8).astype(np.float32)
    got = sat_ops.sat(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    for want in (ref_sat.sat(jnp.asarray(x), interpret=True),
                 ref_sat2d_ref(jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-3)


def test_sat_takes_a_2d_tensor_and_is_public():
    assert "sat" in sat_ops.__all__ and "sat2d_ref" in sat_ref.__all__
    with pytest.raises(ValueError):
        sat_ops.sat(torch.zeros(2, 3, 4))


# ------------------------------------------------------------- delta_sat
# the reference's own delta shapes (tests/test_ops.py): a 15-row tail from
# row 30 of a 45 x 37 signal, and a 1-row band from row 0 at m = 129
def _delta_case(which):
    rng = np.random.default_rng(21 if which == "tail" else 22)
    if which == "tail":
        y = rng.normal(size=(45, 37))
        carry = ref_ops.sat_moments(y, backend="numpy")[:, 29, :]
        return carry, y[30:]
    return np.zeros((3, 129)), rng.normal(size=(1, 129))


@pytest.mark.parametrize("which", ["tail", "row0"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_delta_sat_bitwise_equals_reference_numpy(backend, which):
    carry, tail = _delta_case(which)
    want = ref_ops.delta_sat(carry, tail, backend="numpy")
    got = ops.delta_sat(carry, tail, backend=backend)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("which", ["tail", "row0"])
def test_delta_plain_f32_matches_reference_pallas_interpret(which):
    import jax.numpy as jnp
    carry, tail = _delta_case(which)
    want = np.asarray(ref_sat.delta_sat_moments(
        jnp.asarray(carry, jnp.float32), jnp.asarray(tail, jnp.float32),
        interpret=True))
    got = sat_ops.delta_sat_moments(torch.as_tensor(carry, dtype=torch.float32),
                                    torch.as_tensor(tail, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(
        ops.delta_sat(carry, tail, backend="torch", config={"dtype": "float32"}),
        want,
        rtol=5e-4, atol=5e-3)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_chained_delta_sat_bitwise_equals_full_build(backend):
    # chaining patches is indistinguishable from a from-scratch build
    y = np.random.default_rng(20).normal(size=(41, 37))
    full = ops.sat_moments(y, backend=backend)
    first = ops.delta_sat(np.zeros((3, 37)), y[:17], backend=backend)
    rest = ops.delta_sat(first[:, -1, :], y[17:], backend=backend)
    assert np.array_equal(np.concatenate([first, rest], axis=1), full)


def test_delta_sat_validates_shapes():
    with pytest.raises(ValueError):
        ops.delta_sat(np.zeros((3, 4)), np.zeros((2, 5)), backend="numpy")
    with pytest.raises(ValueError):
        ops.delta_sat(np.zeros((3, 4)), np.zeros((0, 4)), backend="torch")


# -------------------------------------------------------------- sat_stack
def _ragged_stack(dtype=np.float64, seed=30):
    """The streaming_compress padding: ragged (3, n, m) moment rasters in
    one zero-padded (L, 3, nmax, mmax) stack, as _stack_rasters builds it."""
    rng = np.random.default_rng(seed)
    shapes = [(33, 20), (7, 41), (50, 9), (1, 1)]
    rasters = [rng.normal(size=(3, n, m)) * (rng.random((n, m)) < 0.3)
               for n, m in shapes]
    stk = np.zeros((len(shapes), 3, 50, 41), dtype)
    for i, r in enumerate(rasters):
        stk[i, :, :r.shape[1], :r.shape[2]] = r
    return rasters, stk


def test_stack_cols_first_bitwise_equals_build_moments_per_bucket():
    rasters, stk = _ragged_stack()
    got = sat_ref.sat_stack_ref(torch.as_tensor(stk), "cols_first").numpy()
    got_ops = sat_ops.sat_stack(torch.as_tensor(stk)).numpy()
    assert np.array_equal(got, got_ops)          # float64 keeps cols_first
    for i, r in enumerate(rasters):
        _, n, m = r.shape
        want = ref_core.PrefixStats.build_moments(*r)
        for c, p in enumerate((want.p0, want.p1, want.p2)):
            assert np.array_equal(got[i, c, :n, :m], p[1:, 1:])


def test_stack_rows_first_f32_matches_reference_pallas_interpret():
    import jax.numpy as jnp
    _, stk = _ragged_stack(np.float32, seed=31)
    want = np.asarray(ref_sat.sat_stack(jnp.asarray(stk), interpret=True))
    got = sat_ops.sat_stack(torch.as_tensor(stk))
    assert got.dtype == torch.float32
    assert torch.equal(got, sat_ref.sat_stack_ref(torch.as_tensor(stk),
                                                  "rows_first"))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-3)


def test_stack_orders_differ_and_are_checked():
    # the two orders round differently: a test that held the float64 stack
    # to the rows-first order alone would miss the build_moments order
    _, stk = _ragged_stack(seed=32)
    t = torch.as_tensor(stk)
    a = sat_ref.sat_stack_ref(t, "cols_first")
    b = sat_ref.sat_stack_ref(t, "rows_first")
    assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError):
        sat_ref.sat_stack_ref(t, "diagonal")


def test_new_launchers_refuse_cpu_tensors():
    x = torch.zeros(2, 4, 4, dtype=torch.float64)
    with pytest.raises((RuntimeError, ValueError)):
        sat_kernel.sat_stack_cuda(x)
    with pytest.raises((RuntimeError, ValueError)):
        sat_kernel.delta_sat_cuda(x[0, :3], x[0])


# -------------------------------------------- sat_moments as a -0.0 delta
# The CUDA kernels build sat_moments as the delta patch seeded with a carry
# row of -0.0: under round-to-nearest -0.0 + x == x for every x, -0.0
# included, so every column's first add yields numpy's first element
# itself.  -0.0 entries at the top-left corner, along row 0, down column 0,
# in the interior, and all four; widths and heights of 1 among the shapes.
NEG0_SHAPES = [(1, 9), (7, 1), (9, 13), (40, 70)]
NEG0_PLACES = ["corner", "row0", "col0", "interior", "all"]


def _with_neg0(shape, place, seed=40):
    y = np.random.default_rng(seed).normal(size=shape)
    n, m = shape
    places = ["corner", "row0", "col0", "interior"] if place == "all" else [place]
    for p in places:
        if p == "corner":
            y[0, 0] = -0.0
        elif p == "row0":
            y[0, :max(m // 2, 1)] = -0.0
        elif p == "col0":
            y[:max(n // 2, 1), 0] = -0.0
        else:
            y[n // 3:, m // 3:m // 3 + 3] = -0.0
    return y


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint64)


@pytest.mark.parametrize("place", NEG0_PLACES)
@pytest.mark.parametrize("shape", NEG0_SHAPES)
def test_sat_moments_is_the_delta_from_a_negative_zero_carry(shape, place):
    y = _with_neg0(shape, place)
    want = ref_ops.sat_moments(y, backend="numpy")
    got = sat_ref.delta_sat_ref(torch.full((3, shape[1]), -0.0, dtype=torch.float64),
                                torch.as_tensor(y)).numpy()
    if place != "interior":
        assert np.signbit(want[1]).any()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("place", NEG0_PLACES)
def test_port_numpy_and_plain_sat_moments_keep_numpy_signed_zeros(place):
    # the port's numpy op and the plain version start each scan from its
    # first element as well; a +0.0 carry would not
    y = _with_neg0((40, 70), place, seed=41)
    want = ref_ops.sat_moments(y, backend="numpy")
    assert np.array_equal(_bits(ops.sat_moments(y, backend="numpy")), _bits(want))
    assert np.array_equal(_bits(sat_ref.sat_moments_ref(torch.as_tensor(y)).numpy()),
                          _bits(want))
    assert np.array_equal(
        _bits(ops.delta_sat(np.full((3, 70), -0.0), y, backend="numpy")), _bits(want))
    if place != "interior":
        plus = ops.delta_sat(np.zeros((3, 70)), y, backend="numpy")
        assert not np.array_equal(_bits(plus), _bits(want))
