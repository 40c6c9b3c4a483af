"""The repro_torch CUDA kernels on the card, against their plain PyTorch
versions and the numpy oracle.  Imports only the port (no jax), so it runs
on a CUDA host without the reference's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card every test here skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ops  # noqa: E402
from repro_torch.core import (PrefixStats, StreamingBuilder,  # noqa: E402
                              random_tree_segmentation, sharded_coreset,
                              signal_coreset)
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.kernels.fitting_loss import kernel as fl_kernel  # noqa: E402
from repro_torch.kernels.fitting_loss import ops as fl_ops  # noqa: E402
from repro_torch.kernels.sat2d import kernel as sat_kernel  # noqa: E402
from repro_torch.kernels.histsplit import kernel as hist_kernel  # noqa: E402
from repro_torch.kernels.histsplit import ops as hist_ops  # noqa: E402
from repro_torch.kernels.histsplit.ref import (hist_rows_ref,  # noqa: E402
                                               partials_ref)
from repro_torch.kernels.sat2d import ops as sat_ops  # noqa: E402
from repro_torch.kernels.sat2d import ref as sat_ref  # noqa: E402
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


def _blocks_and_trees(B, T, K, device, seed=0, band_blocks=64, cell=8):
    """(blk, seg) on ``device``: B blocks tiling bands of ``band_blocks``
    cells of ``cell`` x ``cell``, in the coreset's order (band by band, left
    to right), random labels and weights that sum to each block's area; T
    random K-leaf trees over the plane the bands fill."""
    rng = np.random.default_rng(seed)
    i = np.arange(B)
    r0, c0 = (i // band_blocks) * cell, (i % band_blocks) * cell
    rects = np.stack([r0, r0 + cell, c0, c0 + cell], axis=1).astype(np.float64)
    weights = rng.dirichlet(np.ones(4), size=B) * cell * cell
    labels = rng.normal(size=(B, 4))
    n, m = max(int(rects[:, 1].max()), 1), band_blocks * cell
    segs = [random_tree_segmentation(n, m, K, rng) for _ in range(T)]
    sr = np.stack([sg.rects for sg in segs]).astype(np.float64)
    sl = np.stack([sg.labels for sg in segs])
    blk = fl_kernel.pack_blocks(*(torch.as_tensor(a, dtype=torch.float32, device=device)
                                  for a in (rects, labels, weights)))
    return blk, fl_kernel.pack_trees(torch.as_tensor(sr, device=device),
                                     torch.as_tensor(sl, device=device))


def _plain(blk, seg):
    from repro_torch.kernels.fitting_loss.ref import fitting_loss_batched_ref
    return fitting_loss_batched_ref(blk[:, :4], blk[:, 4:8], blk[:, 8:12],
                                    seg[..., :4], seg[..., 4])


# (B, T, K): B at 1, 31, 32, 33 and past one CTA's chunks (rounds of warps,
# chunks split over CTAs); T on both sides of the split rule (66 trees);
# K past one staging tile of 256 leaves
LOSS_EDGES = [(1, 1, 7), (31, 3, 64), (32, 1, 64), (33, 2, 64), (33, 9, 1),
              (10_000, 1, 64), (2_600, 256, 64), (5_000, 40, 16), (300, 257, 16),
              (300, 530, 9), (100, 3, 300), (700, 70, 257), (2_600, 2, 520)]


@pytest.mark.parametrize("B,T,K", LOSS_EDGES)
def test_loss_kernel_at_its_edges_matches_plain(cuda, B, T, K):
    blk, seg = _blocks_and_trees(B, T, K, cuda)
    before = fl_kernel.FITTING_LOSS_BATCHED.launches
    got = fl_kernel.fitting_loss_batched_cuda(blk, seg)
    assert fl_kernel.FITTING_LOSS_BATCHED.launches == before + 1
    want = _plain(blk, seg)
    torch.cuda.synchronize()
    assert got.shape == (T,) and bool(torch.isfinite(got).all())
    assert _rel(got.cpu().numpy(), want.cpu().numpy()).max() < 1e-4


@pytest.mark.parametrize("T", [1, 2, 3, 8, 40, 66, 257, 530])
def test_loss_tree_alone_equals_tree_in_batch_at_every_T(cuda, T):
    blk, seg = _blocks_and_trees(2_600, T, 24, cuda, seed=T)
    batch = fl_kernel.fitting_loss_batched_cuda(blk, seg).cpu().numpy()
    alone = np.array([fl_kernel.fitting_loss_cuda(blk, seg[t]).item()
                      for t in range(T)], np.float32)
    assert np.array_equal(alone, batch)
    for lo in (0, T // 3):
        part = fl_kernel.fitting_loss_batched_cuda(blk, seg[lo:lo + 5])
        assert np.array_equal(part.cpu().numpy(), batch[lo:lo + 5])


def test_loss_launches_leave_their_counts_at_zero(cuda):
    # split launches (T = 1 and 3 over 2,600 blocks) count a tree's
    # finished CTAs on the stream's counts and must leave them zero
    blk, seg = _blocks_and_trees(2_600, 3, 24, cuda)
    for T in (1, 3, 1):
        assert fl_kernel.launch_shape(2_600, T)["splits"] > 1
        fl_kernel.fitting_loss_batched_cuda(blk, seg[:T])
    stream = torch.cuda.current_stream().cuda_stream
    done = fl_kernel.done_counts(blk.device, stream, 1)
    torch.cuda.synchronize()
    assert int(done.abs().sum()) == 0


# (B, T): the serving coreset (B ~ 2,121) at T = 1 and 256, B at a chunk's
# edges, T on both sides of the split rule, and sizes past one CTA's chunks
FL_LAUNCH_SHAPES = [(2121, 1), (2121, 256), (1, 1), (31, 3), (32, 65), (33, 66),
                    (10_000, 1), (10_000, 40), (300, 257), (300, 530), (5_000, 5_000),
                    (3_000_000, 2)]


@pytest.mark.parametrize("B,T", FL_LAUNCH_SHAPES)
def test_launch_shape_covers_every_chunk(cuda, B, T):
    got = fl_kernel.launch_shape(B, T)
    splits, per_cta = got["splits"], got["chunks_per_cta"]
    warps, rounds = got["warps"], got["rounds"]
    assert got["chunk"] == 32 and got["chunks"] == -(-B // got["chunk"])
    assert (splits - 1) * per_cta < got["chunks"] <= splits * per_cta
    assert splits <= 65535
    assert 1 <= warps <= got["max_warps"] and (rounds - 1) * warps < per_cta <= rounds * warps
    assert got["ctas"] == T * splits


@pytest.mark.parametrize("T", [1, 256])
def test_launch_shape_fills_the_card_at_the_serving_shapes(cuda, T):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = fl_kernel.launch_shape(2121, T)
    assert got == fl_kernel.launch_shape(2121, T, sms=sms)
    assert got["ctas"] >= sms // 2
    if T > 1:       # every tree's chunks in one CTA
        assert got["splits"] == 1


def _with_leaves(seg, where, rects):
    """seg with leaves of the given rectangles (label 3) inserted before
    leaf ``where`` of every tree."""
    T = seg.shape[0]
    extra = torch.zeros((T, len(rects), 8), device=seg.device)
    extra[..., :4] = torch.as_tensor(rects, dtype=torch.float32, device=seg.device)
    extra[..., 4] = 3.0
    return torch.cat([seg[:, :where], extra, seg[:, where:]], dim=1)


@pytest.mark.parametrize("B,T", [(2_600, 1), (2_600, 256), (33, 3)])
def test_loss_leaves_that_meet_no_block_change_nothing(cuda, B, T):
    blk, seg = _blocks_and_trees(B, T, 16, cuda, seed=5)
    bottom = float(blk[:, 1].max())
    got = fl_kernel.fitting_loss_batched_cuda(blk, seg).cpu().numpy()
    # zero-area leaves (a point, a segment inside the blocks, an inverted
    # one); leaves that miss every block, so every warp's box; leaves that
    # only touch a block's edge (below the last band, right of the bands)
    cases = {
        "zero_area": [(0, 0, 0, 0), (8, 8, 0, 64), (4, 4, 4, 4), (16, 8, 0, 512)],
        "missing": [(bottom + 8, bottom + 40, 0, 512), (0, 64, 600, 700)],
        "touching": [(bottom, bottom + 8, 0, 512), (0, 16, 512, 520), (0, 8, -8, 0)],
    }
    for what, rects in cases.items():
        for where in (0, 7, 16):
            extended = _with_leaves(seg, where, rects)
            again = fl_kernel.fitting_loss_batched_cuda(blk, extended).cpu().numpy()
            assert np.array_equal(again, got), (what, where)


def _one_block_and_label(label):
    """A coreset of one block (0, 4, 0, 4) with labels (1, 2, 3, 4) and
    weights 4 each, and a tree of a leaf (0, 4, 0, 4) labelled 2 beside a
    zero-area leaf (4, 4, 0, 4) labelled ``label``."""
    from repro_torch.core import SignalCoreset
    labels = np.array([[1.0, 2.0, 3.0, 4.0]])
    weights = np.full((1, 4), 4.0)
    cs = SignalCoreset.from_arrays({
        "n": 4, "m": 4, "k": 2, "eps": 0.3, "rects": [[0, 4, 0, 4]],
        "labels": labels, "weights": weights,
        "moments": [[16.0, (weights * labels).sum(), (weights * labels ** 2).sum()]],
        "sigma": 1.0, "tolerance": 1.0, "max_slices": 1, "build_seconds": 0.0,
        "certified": True,
        "bicriteria": {"sigma": 1.0, "ell": 1.0, "alpha_hat": 1.0,
                       "n_iterations": 1, "n_blocks": 1, "iter_losses": []}})
    rects = np.array([[0.0, 4.0, 0.0, 4.0], [4.0, 4.0, 0.0, 4.0]])
    return cs, rects, np.array([2.0, label])


@pytest.mark.parametrize("label", [np.nan, np.inf])
def test_non_finite_label_on_a_zero_area_leaf_follows_the_numpy_oracle(cuda, label):
    # the kernel skips every (block, leaf) pair with z = 0, so the zero-area
    # leaf's label never enters the sum: the numpy oracle's 24, where the
    # plain version gives NaN (tests/test_torch_fitting_loss.py)
    cs, rects, labels = _one_block_and_label(label)
    want = ops.fitting_loss(cs, rects, labels, backend="numpy")
    assert want == 24.0
    before = (fl_kernel.FITTING_LOSS.launches, fl_kernel.FITTING_LOSS_BATCHED.launches)
    got = ops.fitting_loss(cs, rects, labels, backend="cuda")
    got_b = ops.fitting_loss_batched(cs, rects[None], labels[None], backend="cuda")
    assert (fl_kernel.FITTING_LOSS.launches, fl_kernel.FITTING_LOSS_BATCHED.launches) == (
        before[0] + 1, before[1] + 1)
    np.testing.assert_array_equal([got], [want])
    np.testing.assert_array_equal(got_b, [want])


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
    got = ops.hist_split(*args, B, backend="cuda",
                         config={"variant": "partials", "tile_p": 256})
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


def test_hist_partials_is_the_same_from_run_to_run(cuda):
    codes, w, wy, wy2 = _on(cuda, *_hist_inputs(200_000, 2, 256, seed=3))
    vals = hist_ops.pack_values(w, wy, wy2, "partials")
    first = hist_kernel.histograms_cuda(codes, vals, 256, variant="partials")
    for _ in range(3):
        assert torch.equal(hist_kernel.histograms_cuda(
            codes, vals, 256, variant="partials"), first)


# (P, F, n_bins, tile_p, codes) at the edges of the in-tile sort that
# fused, partials and legacy launch: every point of a tile in one bin (within one
# sub-chunk of 2048 points and across three); n_bins 1, 255 and 1024;
# tile_p 32, 33 (tiles whose values start off a 16-byte boundary), 2048, one
# past the sub-chunk and larger than P (one tile of several sub-chunks);
# F = 1 and the Air-Quality shape's 15 features; P = 1; a CTA of several
# features over tiles of several sub-chunks (14 tiles of 3000 points: on 132
# SMs, 8 CTAs a tile of up to 2 features each)
HIST_F32_EDGES = [(5000, 2, 256, 2048, "one_bin"), (5000, 2, 256, 5000, "one_bin"),
                  (3000, 2, 1, 2048, "random"), (3000, 2, 255, 2048, "random"),
                  (3000, 2, 1024, 2048, "random"), (3000, 3, 64, 32, "random"),
                  (3000, 2, 256, 33, "random"), (4096, 2, 256, 2048, "random"),
                  (5000, 2, 256, 2049, "random"), (3000, 2, 256, 10_000, "random"),
                  (7000, 1, 300, 1 << 20, "random"), (100, 1, 16, 2048, "random"),
                  (9358, 15, 256, 2048, "random"), (1, 1, 16, 2048, "random"),
                  (1, 3, 256, 1, "random"), (40_000, 15, 256, 3000, "random")]


@pytest.mark.parametrize("P,F,B,tile_p,codes", HIST_F32_EDGES)
def test_hist_f32_sort_at_its_edges_equals_the_cpu_order(cuda, P, F, B, tile_p, codes):
    # the rule of test_hist_f32_kernels_equal_their_order_on_the_cpu, one
    # counted launch a call
    args = _hist_inputs(P, F, B, seed=5)
    if codes == "one_bin":
        args[0][:] = B - 1
    for variant, kern in (("partials", hist_kernel.HIST_PARTIALS),
                          ("fused", hist_kernel.HIST_FUSED),
                          ("legacy", hist_kernel.HIST_LEGACY)):
        vals = hist_ops.pack_values(*_on("cpu", *args)[1:], variant)
        parts = partials_ref(torch.from_numpy(args[0]), vals, B, tile_p)
        want = parts
        if variant != "partials":
            want = parts[0].clone()
            for c in range(1, parts.shape[0]):
                want += parts[c]
        before = kern.launches
        got = hist_kernel.histograms_cuda(
            torch.as_tensor(args[0], device=cuda), vals.to(cuda), B,
            variant=variant, tile_p=tile_p)
        assert kern.launches == before + 1
        assert torch.equal(got.cpu(), want), (variant, P, F, B, tile_p, codes)


# (P, F, n_bins, tile_p): chip_smoke's three shapes, tiles on both sides of
# the SM count, past one sub-chunk, many features, 1024 bins
HIST_LAUNCH_SHAPES = [(98_237, 2, 256, 2048), (2_112, 2, 256, 2048),
                      (1 << 24, 2, 256, 2048), (1, 1, 1, 1), (3000, 2, 256, 33),
                      (9358, 15, 256, 2048), (5000, 2, 1024, 2049),
                      (7000, 1, 300, 1 << 20), (1 << 20, 40_000, 16, 1 << 20)]


@pytest.mark.parametrize("variant", ["fused", "partials", "legacy"])
@pytest.mark.parametrize("P,F,B,tile_p", HIST_LAUNCH_SHAPES)
def test_hist_f32_launch_shape_covers_every_tile_and_feature(cuda, variant, P, F, B,
                                                              tile_p):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = hist_kernel.launch_shape(variant, P, F, B, tile_p)
    assert got == hist_kernel.launch_shape(variant, P, F, B, tile_p, sms=sms)
    groups, per_cta = got["feature_groups"], got["features_per_cta"]
    assert got["tiles"] == -(-P // tile_p)
    assert (groups - 1) * per_cta < F <= groups * per_cta and groups <= 65535
    assert got["ctas"] == got["tiles"] * groups
    if variant == "legacy":   # the reference's grid: a CTA a (tile, feature)
        assert per_cta == 1 and groups == F
    else:
        assert groups == 1 or got["tiles"] < sms
    assert got["sub_chunks_per_tile"] == -(-tile_p // got["sub_chunk"])
    assert got["smem_bytes"] <= 227 * 1024 and got["threads"] >= 32


# legacy is fused's sort on another grid: the same chains, the same bits,
# at every shape above and at 2^20 points (512 tiles, more than the SMs:
# fused folds the two features into a CTA, legacy does not)
@pytest.mark.parametrize("P,F,B,tile_p,codes",
                         [(P, F, B, 256, "random") for P, F, B in HIST_SHAPES]
                         + HIST_F32_EDGES + [(1 << 20, 2, 256, 2048, "random")])
def test_hist_legacy_equals_fused_bitwise(cuda, P, F, B, tile_p, codes):
    args = _hist_inputs(P, F, B, seed=6)
    if codes == "one_bin":
        args[0][:] = B - 1
    c, w, wy, wy2 = _on(cuda, *args)
    vals = hist_ops.pack_values(w, wy, wy2, "legacy")
    before = hist_kernel.HIST_LEGACY.launches
    got = hist_kernel.histograms_cuda(c, vals, B, variant="legacy", tile_p=tile_p)
    assert hist_kernel.HIST_LEGACY.launches == before + 1
    want = hist_kernel.histograms_cuda(c, vals, B, variant="fused", tile_p=tile_p)
    assert torch.equal(got, want), (P, F, B, tile_p, codes)


def test_hist_launcher_rejects_bins_past_one_cta(cuda):
    codes, w, wy, wy2 = _on(cuda, *_hist_inputs(64, 1, 16))
    vals = hist_ops.pack_values(w, wy, wy2, "f64")
    with pytest.raises(ValueError, match="n_bins"):
        hist_kernel.histograms_cuda(codes, vals, hist_kernel.MAX_BINS + 1)


# hist_f64 over a node's rows: every HIST_SHAPES shape with all rows and a
# strict ascending random half, both sides of the one-CTA path's limit
# (4096 rows), a skewed node (every point in one bin), one row and none
HIST_ROWS_CASES = ([(P, F, B, r, "random") for P, F, B in HIST_SHAPES
                    for r in ("all", "half")]
                   + [(4096, 2, 256, "all", "random"),
                      (4097, 2, 256, "all", "random"),
                      (9000, 3, 1024, "half", "random"),
                      (1 << 20, 2, 256, "all", "one_bin"),
                      (5000, 1, 2, "half", "one_bin"),
                      (64, 2, 256, "one", "random"),
                      (64, 3, 16, "none", "random")])


def _rows_case(P, F, B, rows, codes, seed=0):
    c, w, wy, wy2 = _hist_inputs(P, F, B, seed)
    if codes == "one_bin":
        c[:] = B - 1
    rng = np.random.default_rng(seed + 100)
    idx = {"all": np.arange(P), "one": np.array([P // 2]),
           "none": np.zeros(0, np.int64),
           "half": np.sort(rng.choice(P, size=P // 2, replace=False))}[rows]
    want = ops.hist_split(c[idx], w[idx], wy[idx], wy2[idx], B,
                          backend="numpy")
    return (c, w, wy, wy2), idx, want


@pytest.mark.parametrize("P,F,B,rows,codes", HIST_ROWS_CASES)
def test_hist_f64_rows_bitwise_numpy_and_run_to_run(cuda, P, F, B, rows,
                                                    codes):
    args, idx, want = _rows_case(P, F, B, rows, codes)
    c, w, wy, wy2 = _on(cuda, *args)
    vals = hist_ops.pack_values(w, wy, wy2)
    r = torch.as_tensor(idx, dtype=torch.int32, device=cuda)
    before = hist_kernel.HIST_F64.launches
    got = hist_kernel.hist_rows_cuda(c, vals, r, B)
    assert hist_kernel.HIST_F64.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), want)
    for _ in range(2):
        assert torch.equal(hist_kernel.hist_rows_cuda(c, vals, r, B), got)
    # the plain version on the card: the same four passes, CUDA's cumsum
    plain = hist_rows_ref(c, vals, r.long(), B).cpu().numpy()
    assert np.abs(plain - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("P,F,B,rows,codes", HIST_ROWS_CASES[-7:])
def test_resident_hist_on_the_card_one_launch_a_node(cuda, P, F, B, rows,
                                                     codes):
    args, idx, want = _rows_case(P, F, B, rows, codes, seed=1)
    res = hist_ops.ResidentHist(*args, B, device=cuda)
    before = hist_kernel.HIST_F64_NODE.launches
    assert np.array_equal(res(idx), want)
    assert np.array_equal(res(np.arange(P)), ops.hist_split(*args, B,
                                                            backend="numpy"))
    assert np.array_equal(res(idx), want)
    assert hist_kernel.HIST_F64_NODE.launches == before + 3


def test_forest_on_the_card_equals_numpy(cuda):
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 10, size=(3000, 2))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.normal(size=3000)
    w = rng.uniform(0.2, 3.0, size=3000)
    kw = dict(n_estimators=3, max_leaves=64, random_state=5)
    want = RandomForestRegressor(hist_backend="numpy", **kw).fit(X, y, w)
    before = hist_kernel.HIST_F64_NODE.launches
    ops.reset_dispatch_counts()
    got = RandomForestRegressor(hist_backend="cuda", **kw).fit(X, y, w)
    calls = ops.dispatch_counts()[("hist_split", "cuda")]
    assert hist_kernel.HIST_F64_NODE.launches == before + calls > before
    for a, b in zip(got.trees, want.trees):
        assert [vars(n) for n in a.nodes] == [vars(n) for n in b.nodes]
    assert np.array_equal(got.predict(X), want.predict(X))


# ------------------------------------------------------------- write path
# (rows of the signal, first patched row, columns): r0 = 0, a 1-row tail,
# m % 32 != 0, a tail past the column pass's unroll, a long tail; then the
# delta kernels' edges (csrc/sat2d.cu): odd and even tails (a row-pass CTA
# takes 2 rows) around a column-pass ring stage of 16 rows, around its
# ring of 8 stages and long past it; widths around a warp's 32 columns (a
# column pass's strip), a row pass's 64-column tile, two tiles, its ring of
# 8 tiles, and a ragged 4097; the largest tail of the write path at that
# width
DELTA_TAILS = (1, 15, 16, 17, 31, 32, 33, 255, 256, 257, 2048)
DELTA_WIDTHS = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 511, 512, 513, 4097)
DELTA_SHAPES = ([(12, 0, 129), (12, 11, 129), (45, 30, 37), (300, 100, 1000),
                 (1000, 0, 70)]
                + [(b + 1, 1, 129) for b in DELTA_TAILS]
                + [(17, 0, m) for m in DELTA_WIDTHS]
                + [(2053, 5, 4097)])
# (tail rows, columns) under a carry drawn from a seeded generator
DELTA_SEEDED = [(1, 1), (16, 32), (17, 33), (33, 129), (257, 4097), (2048, 257)]


def _delta_inputs(n, r0, m, seed=0):
    y = np.random.default_rng(seed).normal(size=(n, m))
    carry = np.zeros((3, m)) if r0 == 0 else _numpy_sat(y)[:, r0 - 1, :]
    return carry, y[r0:]


def _seeded_inputs(b, m, seed):
    rng = np.random.default_rng(seed)
    carry = rng.normal(size=(3, m)) * np.array([[1e3], [1e2], [1e3]])
    return carry, rng.normal(size=(b, m))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _numpy_delta(carry, tail, dtype):
    return ops.delta_sat(carry, tail, backend="numpy",
                         config={"dtype": np.dtype(dtype).name})


@pytest.mark.parametrize("n,r0,m", DELTA_SHAPES)
def test_delta_f64_bitwise_equals_numpy_and_plain(cuda, n, r0, m):
    carry, tail = _delta_inputs(n, r0, m)
    before = sat_kernel.SAT_DELTA_F64.launches
    got = sat_ops.delta_sat_moments(torch.as_tensor(carry, device=cuda),
                                    torch.as_tensor(tail, device=cuda)).cpu()
    assert sat_kernel.SAT_DELTA_F64.launches == before + 1
    want = ops.delta_sat(carry, tail, backend="numpy")
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, sat_ops.delta_sat_moments(torch.as_tensor(carry),
                                                      torch.as_tensor(tail)))
    assert np.array_equal(ops.delta_sat(carry, tail, backend="cuda"), want)


def test_delta_leading_negative_zero_follows_the_oracle(cuda):
    # output row 0 is carry + inner[0], an add: at r0 = 0 a -0.0 cell comes
    # out +0.0, as in the numpy delta oracle (and unlike a full build)
    carry, tail = np.zeros((3, 3)), np.array([[-0.0, 1.0, -0.0]])
    got = ops.delta_sat(carry, tail, backend="cuda")
    want = ops.delta_sat(carry, tail, backend="numpy")
    assert np.array_equal(np.signbit(got), np.signbit(want))
    assert not np.signbit(got).any()


@pytest.mark.parametrize("n,r0,m", DELTA_SHAPES)
def test_delta_f32_matches_plain(cuda, n, r0, m):
    carry, tail = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                   for a in _delta_inputs(n, r0, m, seed=1))
    before = sat_kernel.SAT_DELTA_F32.launches
    got = sat_ops.delta_sat_moments(carry, tail).double()
    assert sat_kernel.SAT_DELTA_F32.launches == before + 1
    want = sat_ref.delta_sat_ref(carry, tail).double()
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got - want).abs() <= 5e-4 * scale).all()


def test_delta_keeps_sat_moments_bitwise(cuda):
    # a patch from row 0 of a signal without -0.0 equals the full build
    y = np.random.default_rng(2).normal(size=(257, 300))
    got = sat_ops.delta_sat_moments(torch.zeros((3, 300), dtype=torch.float64,
                                                device=cuda),
                                    torch.as_tensor(y, device=cuda))
    assert np.array_equal(got.cpu().numpy(), _numpy_sat(y))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("b,m", DELTA_SEEDED)
def test_delta_seeded_carry_bitwise_equals_numpy(cuda, b, m, dtype):
    # both types keep the numpy oracle's order, so each equals it bitwise
    # in its own type, whatever the carry
    carry, tail = _seeded_inputs(b, m, seed=b + m)
    got = sat_ops.delta_sat_moments(
        torch.as_tensor(carry.astype(dtype), device=cuda),
        torch.as_tensor(tail.astype(dtype), device=cuda)).cpu().numpy()
    assert np.array_equal(_bits(got), _bits(_numpy_delta(carry, tail, dtype)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_delta_interior_negative_zero_bitwise_equals_numpy(cuda, dtype):
    # column 0 is -0.0 in the carry and in tail rows 0-20, so the column
    # chain stays -0.0 down to interior row 20 (y: -0 + -0) and turns +0.0
    # in y^2; the within-row scan must start from the -0.0 itself
    carry, tail = _seeded_inputs(40, 70, seed=3)
    carry[1:, 0] = -0.0
    tail[:21, 0] = -0.0
    got = sat_ops.delta_sat_moments(
        torch.as_tensor(carry.astype(dtype), device=cuda),
        torch.as_tensor(tail.astype(dtype), device=cuda)).cpu().numpy()
    want = _numpy_delta(carry, tail, dtype)
    assert np.signbit(want[1, 20, 0]) and not np.signbit(want[2, 20, 0])
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_delta_same_from_run_to_run(cuda, dtype):
    carry, tail = (torch.as_tensor(a, dtype=dtype, device=cuda)
                   for a in _seeded_inputs(257, 4097, seed=4))
    first = sat_kernel.delta_sat_cuda(carry, tail)
    for _ in range(3):
        assert torch.equal(sat_kernel.delta_sat_cuda(carry, tail).view(torch.uint8),
                           first.view(torch.uint8))


def test_delta_f32_ones_saturate_as_the_sequential_sum(cuda):
    # channel 0's within-row sums are written, not scanned: in float32 the
    # sequential sum of ones stops at 2^24 (2^24 + 1 rounds to even), so a
    # row wider than 2^24 keeps it there, bitwise numpy's float32 oracle
    m = (1 << 24) + 33
    carry, tail = _seeded_inputs(2, m, seed=5)
    got = sat_ops.delta_sat_moments(
        torch.as_tensor(carry.astype(np.float32), device=cuda),
        torch.as_tensor(tail.astype(np.float32), device=cuda)).cpu().numpy()
    want = _numpy_delta(carry, tail, np.float32)
    ones = np.cumsum(np.ones(m, np.float32))
    assert ones[-1] == np.float32(1 << 24)
    assert np.array_equal(_bits(got), _bits(want))


def _stack(planes, n, m, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(planes, n, m)) * (rng.random((planes, n, m)) < 0.4)
    return torch.as_tensor(x, dtype=dtype)


# (planes, n, m): one plane, m % 32 != 0, n past the column unroll, a
# level of four buckets' (3, n, m) rasters
STACK_SHAPES = [(1, 1, 1), (3, 33, 20), (5, 70, 129), (12, 512, 1024)]


@pytest.mark.parametrize("planes,n,m", STACK_SHAPES)
def test_stack_f64_bitwise_equals_build_moments_and_plain(cuda, planes, n, m):
    x = _stack(planes, n, m, torch.float64)
    before = sat_kernel.SAT_STACK_F64.launches
    got = sat_ops.sat_stack(x.to(cuda)).cpu()
    assert sat_kernel.SAT_STACK_F64.launches == before + 1
    assert torch.equal(got, sat_ops.sat_stack(x))       # cols_first on the CPU
    for c in range(planes):
        plane = x[c].numpy()
        want = PrefixStats.build_moments(plane, plane, plane).p0[1:, 1:]
        assert np.array_equal(got[c].numpy(), want)


@pytest.mark.parametrize("planes,n,m", STACK_SHAPES)
def test_stack_f32_matches_plain(cuda, planes, n, m):
    x = _stack(planes, n, m, torch.float32, seed=1)
    before = sat_kernel.SAT_STACK_F32.launches
    got = sat_ops.sat_stack(x.to(cuda)).cpu()
    assert sat_kernel.SAT_STACK_F32.launches == before + 1
    want = sat_ref.sat_stack_ref(x.to(cuda), "rows_first").cpu()
    scale = want.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1.0)
    assert ((got - want).abs() <= 5e-4 * scale).all()


# sat_moments and sat_stack on the row and column passes they share with the
# delta kernels (csrc/sat2d.cu): n or m = 1; widths around a row pass's
# 64-column tile and its ring of 8 tiles, and not a multiple of either; row
# counts around a column pass's 16-row stage and below or past its ring of 8
# stages; the stream's frame; widths around the column pass's switch from
# one warp a CTA to three (3 x 44 strips fill the 132 SMs, 3 x 45 do not);
# row counts around the moments row pass's switch from 1 row a CTA to 4
# (1056), odd or not a multiple of 4; the build's width + 1
MOMENTS_EDGES = [(1, 1), (1, 4097), (300, 1), (15, 63), (17, 65), (33, 129),
                 (100, 513), (129, 1000), (256, 1024), (257, 1408), (40, 1409),
                 (527, 70), (1055, 129), (1056, 64), (1058, 513), (130, 4097)]
# (planes, n, m) of the stack: one plane past both rings, in place; rows
# (planes x n) not a multiple of a plain row-pass CTA's 8; two planes of the
# build's width + 1
STACK_EDGES = [(1, 300, 1000), (7, 17, 65), (3, 1, 1), (2, 129, 4097)]
NEG0_PLACES = ("corner", "row0", "col0", "interior")


def _with_neg0(shape, places, seed=0):
    """A signal with -0.0 at the top-left corner, along row 0, down column
    0 or in the interior (each run long enough to keep a -0.0 prefix)."""
    y = np.random.default_rng(seed).normal(size=shape)
    n, m = shape
    for place in places:
        if place == "corner":
            y[0, 0] = -0.0
        elif place == "row0":
            y[0, :m // 2] = -0.0
        elif place == "col0":
            y[:n // 2, 0] = -0.0
        else:
            y[n // 3:, m // 3:m // 3 + 5] = -0.0
    return y


def _numpy_moments(y, dtype):
    return ops.sat_moments(y, backend="numpy",
                           config={"dtype": np.dtype(dtype).name})


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,m", MOMENTS_EDGES)
def test_sat_moments_bitwise_equals_numpy_at_the_passes_edges(cuda, n, m, dtype):
    # both types keep numpy's order, so each equals it bitwise in its type
    y = _with_neg0((n, m), ("corner",), seed=n + m)
    kern = sat_kernel.SAT_MOMENTS_F64 if dtype == np.float64 else sat_kernel.SAT_MOMENTS_F32
    before = kern.launches
    got = sat_ops.sat_moments(torch.as_tensor(y.astype(dtype), device=cuda)).cpu().numpy()
    assert kern.launches == before + 1
    assert np.array_equal(_bits(got), _bits(_numpy_moments(y, dtype)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("place", NEG0_PLACES + ("all",))
def test_sat_moments_keeps_numpy_signed_zeros(cuda, place, dtype):
    # every chain starts from -0.0, so a -0.0 prefix stays -0.0 in y and
    # turns +0.0 in y^2, as in numpy; +0.0 seeds would lose the sign
    y = _with_neg0((70, 130), NEG0_PLACES if place == "all" else (place,), seed=7)
    got = sat_ops.sat_moments(torch.as_tensor(y.astype(dtype), device=cuda)).cpu().numpy()
    want = _numpy_moments(y, dtype)
    if place != "interior":
        assert np.signbit(want[1]).any() and not np.signbit(want[2]).any()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("planes,n,m", STACK_EDGES)
def test_stack_bitwise_equals_numpy_in_its_order(cuda, planes, n, m, dtype):
    # the second pass runs in place: float64's row pass (columns first) and
    # float32's column pass (rows first) read ahead of their own stores
    x = _stack(planes, n, m, dtype, seed=planes + n + m)
    x[:, :max(n // 2, 1), 0] = -0.0
    kern = sat_kernel.SAT_STACK_F64 if dtype == torch.float64 else sat_kernel.SAT_STACK_F32
    before = kern.launches
    got = sat_ops.sat_stack(x.to(cuda)).cpu().numpy()
    assert kern.launches == before + 1
    first, second = (1, 2) if dtype == torch.float64 else (2, 1)
    want = np.cumsum(np.cumsum(x.numpy(), axis=first), axis=second)
    assert np.signbit(want).any()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n,m", [(4100, 4097), (3, (1 << 24) + 33)])
def test_sat_moments_f32_ones_keep_the_sequential_sum(cuda, n, m):
    # channel 0 in float32: the within-row sums saturate at 2^24, and down
    # the columns the sequential sum of them rounds where the product
    # (i + 1)(j + 1) would not; both bitwise numpy's float32 oracle
    y = np.random.default_rng(9).normal(size=(n, m)).astype(np.float32)
    got = sat_ops.sat_moments(torch.as_tensor(y, device=cuda)).cpu().numpy()
    want = _numpy_moments(y, np.float32)
    if m > 1 << 24:
        assert want[0, 0, -1] == np.float32(1 << 24)
    else:
        assert want[0, -1, -1] != np.float32(n * m)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sat_moments_and_stack_same_from_run_to_run(cuda, dtype):
    y = torch.as_tensor(np.random.default_rng(10).normal(size=(257, 4097)),
                        dtype=dtype, device=cuda)
    x = _stack(12, 100, 1000, dtype, seed=11).to(cuda)
    first = (sat_kernel.sat_moments_cuda(y), sat_kernel.sat_stack_cuda(x))
    for _ in range(3):
        again = (sat_kernel.sat_moments_cuda(y), sat_kernel.sat_stack_cuda(x))
        for a, b in zip(again, first):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_launch_shape_covers_every_row_and_column(cuda):
    for op, planes, n, m in [("moments", 3, 4096, 4096), ("moments", 3, 256, 1024),
                             ("delta", 3, 257, 4097), ("stack", 12, 512, 1024),
                             ("stack", 7, 17, 65), ("moments", 3, 1, 1),
                             ("delta", 3, 1055, 129), ("moments", 3, 1058, 64)]:
        got = sat_kernel.launch_shape(op, n, m, planes=planes)
        rows = n if op != "stack" else planes * n
        assert (got["rows_ctas"] - 1) * got["rows_per_cta"] < rows
        assert got["rows_ctas"] * got["rows_per_cta"] >= rows
        warps = planes * -(-m // got["strip_cols"])
        assert got["cols_ctas"] * got["cols_warps_per_cta"] == warps


def test_patch_chain_on_the_card_equals_numpy_build(cuda):
    rng = np.random.default_rng(3)
    y = rng.normal(size=(200, 77))
    with ops.backend_override("cuda"):
        ps = PrefixStats.build(y)
        y[50:60] = rng.normal(size=(10, 77))
        ps = ps.patch_rows(50, y[50:], copy=True)
        band = rng.normal(size=(33, 77))
        y = np.vstack([y, band])
        ps = ps.append_rows(band)
        y[-33:] = rng.normal(size=(33, 77))
        ps = ps.patch_rows(200, y[200:])
    with ops.backend_override("numpy"):
        want = PrefixStats.build(y)
    for a, b in zip((ps.p0, ps.p1, ps.p2), (want.p0, want.p1, want.p2)):
        assert np.array_equal(a, b)


def _stream(bands, replace):
    sb = StreamingBuilder(m=bands[0].shape[1], k=4, eps=0.3)
    for b in bands:
        sb.insert_band(b)
    for i, b in replace.items():
        sb.replace_band(i, b)
    return sb.result(), sb.buckets_recompressed_total


def test_stream_on_the_card_equals_numpy(cuda):
    bands = [piecewise_signal(32, 96, 4, noise=0.15, seed=s) for s in range(4)]
    replace = {1: piecewise_signal(32, 96, 4, noise=0.15, seed=9)}
    with ops.backend_override("numpy"):
        want = _stream(bands, replace)
    before = sat_kernel.SAT_STACK_F64.launches
    with ops.backend_override("cuda"):
        got = _stream(bands, replace)
    assert got[0].fingerprint() == want[0].fingerprint() and got[1] == want[1]
    assert sat_kernel.SAT_STACK_F64.launches > before


def test_sharded_coreset_on_the_card_counts_every_thread(cuda):
    y = piecewise_signal(256, 96, 6, noise=0.2, seed=4)
    with ops.backend_override("numpy"):
        want = sharded_coreset(y, 6, 0.3, 8, recompress_result=True)
    before = sat_kernel.SAT_MOMENTS_F64.launches
    with ops.backend_override("cuda"):
        got = sharded_coreset(y, 6, 0.3, 8, recompress_result=True)
    assert got.fingerprint() == want.fingerprint()
    # the shared tolerance's build and one build per band, on eight threads
    assert sat_kernel.SAT_MOMENTS_F64.launches == before + 9


# ------------------------------------------------------- flash attention
# (B, Hq, Hkv, Lq, Lk): the reference's sweep (MHA, GQA, MQA, Lq = 1 decode,
# ragged 300), then Lq < Lk with a causal offset and Lq > Lk (rows with no
# visible key); then the bf16 kernel's tile edges (128 query rows, 128 keys)
# at qwen2's group of 7 and MQA (granite-20b), and Lq > Lk by more than a
# tile, so that the rows with no visible key fill whole CTAs
FA_SHAPES = [(2, 4, 4, 64, 64), (2, 4, 2, 100, 100), (1, 8, 1, 96, 96),
             (2, 4, 2, 1, 64), (1, 2, 2, 300, 300), (2, 3, 1, 130, 260),
             (1, 2, 2, 300, 100),
             (1, 14, 2, 127, 127), (2, 4, 1, 128, 128), (1, 14, 2, 129, 129),
             (1, 6, 1, 257, 257), (1, 2, 2, 400, 100)]
# causal and not; decode (Lq = 1) causal only
FA_CASES = [(s, c) for s in FA_SHAPES for c in (True, False) if c or s[3] > 1]
# kernel against plain on the card: float32 differs only in the order of
# the sums and expf's last bits; bfloat16 also in a P entry that rounds the
# other way and the output's last bit (2^-8 relative)
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _qkv(shape, D, dtype, device, seed=0):
    B, Hq, Hkv, Lq, Lk = shape
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
            .to(device=device, dtype=dtype)
            for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("shape,causal", FA_CASES)
def test_flash_attention_matches_plain(cuda, shape, causal, D, dtype):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    q, k, v = _qkv(shape, D, dtype, cuda)
    kern = fa_kernel.FLASH_ATTENTION_F32 if dtype == torch.float32 \
        else fa_kernel.FLASH_ATTENTION_BF16
    before = kern.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert kern.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# float32 kernel edges: Lq at a CTA's 16 query rows, Lk at a warp's key
# slice (16 keys, 8 at D = 128) and at the 64-key tile (32 at D = 128), Lq >
# Lk by less and by more than a query tile
F32_EDGES = [(1, 2, 1, 15, 15), (1, 2, 2, 16, 64), (2, 2, 1, 17, 33),
             (1, 4, 2, 31, 65), (1, 2, 2, 32, 32), (1, 2, 2, 33, 63),
             (1, 14, 2, 33, 129), (1, 2, 2, 65, 31), (1, 2, 2, 48, 17),
             (2, 14, 2, 300, 300), (1, 2, 1, 16, 49)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", F32_EDGES)
def test_flash_attention_f32_at_its_tile_edges(cuda, shape, causal, D):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    q, k, v = _qkv(shape, D, torch.float32, cuda, seed=sum(shape))
    before = fa_kernel.FLASH_ATTENTION_F32.launches
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal)
    assert fa_kernel.FLASH_ATTENTION_F32.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert float((got - want).norm() / want.norm()) <= tol


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_f32_is_the_same_from_run_to_run(cuda, D):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    for shape in ((4, 14, 2, 64, 64), (2, 14, 2, 700, 700)):
        q, k, v = _qkv(shape, D, torch.float32, cuda, seed=D)
        first = fa_ops.flash_attention(q, k, v)
        for _ in range(3):
            assert torch.equal(fa_ops.flash_attention(q, k, v), first)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_is_the_same_from_run_to_run(cuda, D):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _qkv((2, 14, 2, 700, 700), D, torch.bfloat16, cuda, seed=3)
    first = fa_ops.flash_attention(q, k, v)
    assert torch.equal(fa_ops.flash_attention(q, k, v), first)


def test_flash_attention_kernel_rejects_other_head_sizes(cuda):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _qkv((1, 2, 2, 8, 8), 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head sizes"):
        fa_ops.flash_attention(q, k, v)


def _reduced_lm(dtype):
    from repro_torch.configs import get_arch, reduced_config
    return reduced_config(get_arch("qwen2-0.5b"), n_kv_heads=2, dtype=dtype)


def test_prefill_on_the_card_launches_the_kernel_once_a_layer(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import init_params, prefill
    cfg = _reduced_lm("bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 300)),
                           device=cuda)
    before = fa_kernel.FLASH_ATTENTION_BF16.launches
    got, _ = prefill(cfg, params, {"tokens": toks})
    assert fa_kernel.FLASH_ATTENTION_BF16.launches == before + cfg.n_layers
    want, _ = prefill(cfg, params, {"tokens": toks}, attn_impl="torch")
    assert fa_kernel.FLASH_ATTENTION_BF16.launches == before + cfg.n_layers
    rel = (got.float() - want.float()).norm() / want.float().norm()
    assert float(rel) < 2e-2


def test_float32_prefill_on_the_card_matches_decode_and_the_cpu(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    cfg = _reduced_lm("float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    toks = torch.as_tensor(prompts, device=cuda)
    before = fa_kernel.FLASH_ATTENTION_F32.launches
    full, _ = prefill(cfg, params, {"tokens": toks})
    assert fa_kernel.FLASH_ATTENTION_F32.launches == before + cfg.n_layers
    cache = init_cache(cfg, 2, 10, device=cuda)
    steps = torch.stack([decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]})[0][:, 0]
                         for t in range(10)], dim=1)
    torch.testing.assert_close(steps, full, rtol=2e-3, atol=2e-3)
    assert np.array_equal(generate(cfg, params, prompts, 6, greedy=True),
                          generate(cfg, _to_cpu(params), prompts, 6, greedy=True))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ------------------------------------------------------------- LM training
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_refuses_grad_on_the_card(cuda, dtype):
    """The kernel has no backward: under autograd it raises rather than
    hand back an output with no grad_fn; under no_grad it launches."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import forward, init_params
    q, k, v = _qkv((1, 2, 2, 64, 64), 64, dtype, cuda)
    kern = fa_kernel.FLASH_ATTENTION_BF16 if dtype == torch.bfloat16 \
        else fa_kernel.FLASH_ATTENTION_F32
    before = kern.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa_kernel.flash_attention_cuda(q.requires_grad_(True), k, v)
    assert kern.launches == before
    with torch.no_grad():
        fa_kernel.flash_attention_cuda(q, k, v)
    assert kern.launches == before + 1
    cfg = _reduced_lm("float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    params["head"]["w"].requires_grad_(True)
    params["embed"]["table"].requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="attn_impl='torch'"):
        forward(cfg, params, {"tokens": toks})


def test_train_step_on_the_card_launches_no_kernel_and_matches_the_cpu(cuda):
    import dataclasses
    from repro_torch.data import TokenStream
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(_reduced_lm("float32"), remat=False)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    stream = TokenStream(cfg.vocab, 2, 64, seed=0)
    out = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, p in (("cuda", params), ("cpu", _to_cpu(params))):
            o = adamw_init(p)
            before = (fa_kernel.FLASH_ATTENTION_BF16.launches,
                      fa_kernel.FLASH_ATTENTION_F32.launches)
            losses = []
            for s in range(3):
                b = {k: torch.as_tensor(v, device=dev)
                     for k, v in stream.batch_at(s).items()}
                p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
            assert (fa_kernel.FLASH_ATTENTION_BF16.launches,
                    fa_kernel.FLASH_ATTENTION_F32.launches) == before
            out[dev] = (losses, p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ------------------------------------------ the tuner's cuda search space
def _tuning_calls():
    """A small problem of every op, called through ``ops`` as the tuner
    calls it: a float64 config must equal numpy bitwise, a compensated one
    lie within the certificate (1e-6 scaled), a float32 one within its
    kernel's bar."""
    rng = np.random.default_rng(6)
    y = rng.normal(size=(70, 130)) + 10.0
    carry = ops.sat_moments(y[:1], backend="numpy")[:, 0, :]
    codes, w, wy, wy2 = _hist_inputs(5000, 3, 64, seed=6)
    with ops.backend_override("numpy"):
        cs = signal_coreset(piecewise_signal(48, 40, 4, seed=6), 4, 0.3)
    segs = [random_tree_segmentation(48, 40, 6, rng) for _ in range(5)]
    sr = np.stack([s.rects for s in segs]).astype(np.float64)
    sl = np.stack([s.labels for s in segs])
    return {
        "sat_moments": lambda **kw: ops.sat_moments(y, **kw),
        "delta_sat": lambda **kw: ops.delta_sat(carry, y[1:], **kw),
        "hist_split": lambda **kw: ops.hist_split(codes, w, wy, wy2, 64, **kw),
        "fitting_loss": lambda **kw: ops.fitting_loss(cs, sr[0], sl[0], **kw),
        "fitting_loss_batched": lambda **kw: ops.fitting_loss_batched(cs, sr, sl, **kw),
        "streaming_compress": lambda **kw: np.array(
            [c.total_mass() for c in ops.streaming_compress([cs, cs], 3, 0.5, **kw)]),
    }


def _cuda_search_space():
    from repro_torch.ops import autotune
    return [(op, cfg) for op, per in autotune.SEARCH_SPACE.items()
            for cfg in per["cuda"]]


@pytest.mark.parametrize("op,config", _cuda_search_space(),
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_every_cuda_search_config_runs_at_a_small_shape(cuda, op, config):
    from repro_torch.ops import autotune
    call = _tuning_calls()[op]
    got, want = call(backend="cuda", config=config), call(backend="numpy")
    err = autotune._scaled_rel_err(got, want)
    if config.get("dtype") == "float64" or config.get("variant") == "f64":
        assert np.array_equal(got, want)
    elif config.get("compensated"):
        assert err <= autotune.PARITY_RTOL
    elif op in ("sat_moments", "delta_sat"):
        assert err <= 5e-4                 # chip_smoke's float32 scan bar
    elif op.startswith("fitting_loss"):    # chip_smoke's served-loss bar
        np.testing.assert_allclose(got, want, rtol=1e-3)
    else:                                  # float32 sums: the reference's bar
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_tuned_cuda_plan_reaches_the_kernel(cuda, tmp_path, monkeypatch):
    # a planted float32 plan at a bucket: dispatch with config=None runs it
    # in fast mode, and holds the pinned op to float64 in the default mode
    from repro_torch.ops import autotune
    monkeypatch.setenv(autotune.CACHE_ENV_VAR, str(tmp_path / "autotune.json"))
    monkeypatch.delenv(autotune.PRECISION_ENV_VAR, raising=False)
    autotune.reset_cache()
    try:
        y = np.random.default_rng(7).normal(size=(64, 96))
        autotune.get_cache().put("sat_moments", "cuda",
                                 autotune.shape_bucket(3 * y.size),
                                 {"config": {"dtype": "float32"}, "us": 1.0,
                                  "numpy_us": 2.0, "rel_err": 1e-8})
        f32, f64 = sat_kernel.SAT_MOMENTS_F32, sat_kernel.SAT_MOMENTS_F64
        before = (f32.launches, f64.launches)
        assert np.array_equal(ops.sat_moments(y, backend="cuda"), _numpy_sat(y))
        assert (f32.launches, f64.launches) == (before[0], before[1] + 1)
        monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "fast")
        assert ops.sat_moments(y, backend="cuda").dtype == np.float32
        assert f32.launches == before[0] + 1
    finally:
        autotune.reset_cache()


# ------------------------------------------------------------------ the mesh
_MESH_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
backend, world, rank, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group(backend, init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import destroy_world
try:
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch import ops
    from repro_torch.core import random_tree_segmentation, sat_pjit
    from repro_torch.core.sharded import fitting_loss_batched
    from repro_torch.data import piecewise_signal
    from repro_torch.kernels.fitting_loss import kernel as fk
    from repro_torch.kernels.sat2d import kernel as sk
    from repro_torch.launch.mesh import compat_make_mesh, make_local_mesh
    from repro_torch.service import CoresetEngine
    n, m, k = 300, 200, 8
    y = piecewise_signal(n, m, k, noise=0.2, seed=0)
    rng = np.random.default_rng(1)
    segs = [random_tree_segmentation(n, m, 16, rng) for _ in range(64)]
    rects = np.stack([s.rects for s in segs])
    labels = np.stack([s.labels for s in segs])
    out = {}
    if world == 1:
        mesh = make_local_mesh(1)
        engine = CoresetEngine(workers=1, mesh=mesh)
        plain = CoresetEngine(workers=1, coalesce=False)
        try:
            engine.register_signal("s", y)
            before = fk.FITTING_LOSS_BATCHED.launches
            r = engine.tree_loss_batch("s", rects, labels, k=k, eps=0.3)
            out["launches"] = fk.FITTING_LOSS_BATCHED.launches - before
            plain.register_signal("s", y)
            st = engine.signal("s")
            plain.cache.put(engine.cache.lookup("s", st.version, k, 0.3)[0])
            q = plain.tree_loss_batch("s", rects, labels, k=k, eps=0.3)
            out["bitwise"] = bool(np.array_equal(r["losses"], q["losses"]))
            out["backends"] = [r["backend"], q["backend"]]
            out["counter"] = engine.metrics.get("ops_backend_cuda+all_reduce")
        finally:
            engine.close()
            plain.close()
    else:
        mesh = compat_make_mesh((world,), ("data",))
        with ops.backend_override("numpy"):
            from repro_torch.core import signal_coreset
            cs = signal_coreset(y, k, 0.3)
        got = fitting_loss_batched(cs, rects, labels, mesh=mesh)
        one = ops.fitting_loss_batched(cs, rects, labels, backend="cuda")
        out["rel"] = float((np.abs(got - one) / np.abs(one)).max())
    y32 = y.astype(np.float32)
    images = sat_pjit(y32, mesh=mesh)
    host = images.to_local().cpu()
    if world > 1:   # gloo gathers host tensors: over a CPU mesh of the ranks
        host = DTensor.from_local(host, compat_make_mesh((world,), ("data",), "cpu"),
                                  [Shard(1)], shape=images.shape,
                                  stride=(n * m, m, 1)).full_tensor()
    one_device = sk.sat_moments_cuda(torch.as_tensor(y32, device="cuda")).cpu()
    out["sat_bitwise"] = bool(torch.equal(host, one_device))
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
'''


def _mesh_ranks(backend, world, tmp_path):
    import json
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", ops.ENV_VAR)}
    env["PYTHONPATH"] = str(root / "src")
    env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "tune.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, backend, str(world), str(r),
         str(tmp_path / "store")], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_one_nccl_rank_mesh_engine_is_the_unmeshed_engine_bitwise(cuda, tmp_path):
    (out,) = _mesh_ranks("nccl", 1, tmp_path)
    assert out["bitwise"] and out["launches"] == 1 and out["counter"] == 1
    assert out["backends"] == ["cuda+all_reduce", "cuda"]
    assert out["sat_bitwise"]


def test_two_gloo_ranks_on_the_card_match_one_device(cuda, tmp_path):
    outs = _mesh_ranks("gloo", 2, tmp_path)
    assert all(o["rel"] <= 1e-4 and o["sat_bitwise"] for o in outs)
