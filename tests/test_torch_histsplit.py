"""repro_torch histsplit: the plain versions and the hist_split backends
against the reference's numpy oracle and its interpret-mode Pallas kernel
(the CUDA kernels are held to the plain versions in test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.kernels.histsplit import ops as ref_hist  # noqa: E402
from repro.kernels.sat2d.ref import split_hi_lo as ref_split  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.kernels.histsplit import kernel as hist_kernel  # noqa: E402
from repro_torch.kernels.histsplit import ops as hist_ops  # noqa: E402
from repro_torch.kernels.histsplit import ref as hist_ref  # noqa: E402

# (P, F, n_bins): the reference's sweep (tests/test_kernels.py) and its
# awkward-size parity case (tests/test_ops.py), P off every tile size
SHAPES = [(64, 1, 16), (700, 5, 32), (1030, 3, 256), (1030, 3, 17)]
# the reference's tolerance for its float32 kernels (tests/test_ops.py)
F32_TOL = 2e-4


def _inputs(P, F, B, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, size=(P, F)).astype(np.uint8)
    w = rng.uniform(0.1, 2, P)
    y = rng.normal(size=P)
    return codes, w, w * y, w * y * y


def _tensors(codes, *vals):
    return (torch.from_numpy(codes),) + tuple(torch.from_numpy(v) for v in vals)


@pytest.mark.parametrize("P,F,B", SHAPES)
def test_f64_plain_bitwise_equals_reference_numpy(P, F, B):
    args = _inputs(P, F, B)
    want = ref_ops.hist_split(*args, B, backend="numpy")
    got = hist_ops.histograms(*_tensors(*args), B).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("P,F,B", SHAPES)
def test_backends_bitwise_equal_reference_numpy(backend, P, F, B):
    args = _inputs(P, F, B, seed=1)
    want = ref_ops.hist_split(*args, B, backend="numpy")
    got = ops.hist_split(*args, B, backend=backend)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("variant", ["fused", "legacy"])
@pytest.mark.parametrize("P,F,B", SHAPES)
def test_f32_within_reference_interpret_kernel(variant, P, F, B):
    args = _inputs(P, F, B, seed=2)
    want = np.asarray(ref_hist.histograms(*args, B, tile_p=256,
                                          variant=variant, interpret=True))
    got = hist_ops.histograms(*_tensors(*args), B, variant=variant, tile_p=256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    via_op = ops.hist_split(*args, B, backend="torch",
                            config={"variant": variant, "tile_p": 256})
    np.testing.assert_array_equal(via_op, got.numpy().astype(np.float64))


@pytest.mark.parametrize("tile_p", [256, 2048])
@pytest.mark.parametrize("P,F,B", SHAPES)
def test_partials_combined_within_certificate(tile_p, P, F, B):
    # the compensated path's bar: 1e-6 of the channel's scale
    args = _inputs(P, F, B, seed=3)
    oracle = ref_ops.hist_split(*args, B, backend="numpy")
    got = ops.hist_split(*args, B, backend="torch",
                         config={"variant": "partials", "tile_p": tile_p})
    scale = np.abs(oracle).max(axis=(0, 1))
    assert (np.abs(got - oracle).max(axis=(0, 1)) <= 1e-6 * scale).all()
    ref = np.asarray(ref_hist.histograms(*args, B, tile_p=tile_p,
                                         variant="partials", interpret=True))
    assert (np.abs(got - ref).max(axis=(0, 1)) <= 1e-6 * scale).all()


def test_partials_are_per_tile_sums():
    codes, w, wy, wy2 = _inputs(1030, 3, 17, seed=4)
    vals = hist_ops.pack_values(*_tensors(codes, w, wy, wy2)[1:], "partials")
    parts = hist_ref.partials_ref(torch.from_numpy(codes), vals, 17, 256)
    assert parts.shape == (5, 3, 17, 6)
    for c in range(5):
        sl = slice(256 * c, 256 * (c + 1))
        whole = hist_ref.histograms_ref(torch.from_numpy(codes[sl]), vals[sl], 17)
        assert torch.equal(parts[c], whole)


def test_split_hi_lo_equals_reference():
    x = np.random.default_rng(5).normal(size=257) * 1e3
    hi, lo = hist_ref.split_hi_lo(torch.from_numpy(x))
    want_hi, want_lo = (np.asarray(a) for a in ref_split(x))
    assert np.array_equal(hi.numpy(), want_hi) and np.array_equal(lo.numpy(), want_lo)


def test_one_upload_packs_codes_and_values(monkeypatch):
    uploads = []
    real_to = torch.Tensor.to

    def spy(self, *a, **kw):
        uploads.append(tuple(self.shape))
        return real_to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    codes, w, wy, wy2 = _inputs(100, 2, 16)
    hist_ops.hist_split(codes, w, wy, wy2, 16, device="cpu")
    buf = [s for s in uploads if s == (100 * 3 * 8 + 100 * 2,)]
    assert len(buf) == 1


@pytest.mark.parametrize("codes,n_bins,match", [
    (np.full((4, 2), 20), 16, "below n_bins"),
    (np.full((4, 2), 300), 512, r"\[0, 256\)"),
    (np.full((4, 2), -1), 16, r"\[0, 256\)"),
    (np.zeros(4, np.uint8), 16, r"\(P, F\)"),
])
def test_host_adapter_rejects_codes_the_kernel_cannot_bin(codes, n_bins, match):
    w = np.ones(codes.shape[0])
    with pytest.raises(ValueError, match=match):
        hist_ops.hist_split(codes, w, w, w, n_bins, device="cpu")


def test_unknown_variant_raises():
    args = _tensors(*_inputs(10, 1, 4))
    with pytest.raises(ValueError, match="unknown histsplit variant"):
        hist_ops.histograms(*args, 4, variant="onehot")


def test_cuda_launcher_refuses_cpu_tensors():
    codes, w, wy, wy2 = _tensors(*_inputs(64, 2, 16))
    vals = hist_ops.pack_values(w, wy, wy2, "f64")
    before = hist_kernel.HIST_F64.launches
    with pytest.raises((RuntimeError, ValueError)):
        hist_kernel.histograms_cuda(codes, vals, 16)
    assert hist_kernel.HIST_F64.launches == before


# launch_shape asks the compiled source (so its values are checked in
# tests/test_torch_cuda.py); what it refuses, it refuses before the build
# (legacy: no bins, and more features than its grid's 65,535 CTAs a tile)
@pytest.mark.parametrize("variant,P,F,n_bins,tile_p", [
    ("legacy", 10, 1, 0, 8), ("legacy", 10, 65536, 4, 8),
    ("f64", 10, 1, 4, 8), ("fused", 0, 1, 4, 8),
    ("fused", 10, 0, 4, 8), ("partials", 10, 1, 0, 8),
    ("partials", 10, 1, hist_kernel.MAX_BINS + 1, 8), ("fused", 10, 1, 4, 0),
    ("fused", 10, 1, 4, 2**31), ("partials", 10, 65536, 4, 8)])
def test_launch_shape_refuses_what_the_kernels_do_not_take(variant, P, F, n_bins,
                                                           tile_p):
    with pytest.raises(ValueError):
        hist_kernel.launch_shape(variant, P, F, n_bins, tile_p, sms=132)
