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
from repro_torch.kernels.histsplit.ref import partials_ref  # noqa: E402
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


# ------------------------------------------------------------- write path
# (rows of the signal, first patched row, columns): r0 = 0, a 1-row tail,
# m % 32 != 0, a tail past the column pass's unroll, a long tail
DELTA_SHAPES = [(12, 0, 129), (12, 11, 129), (45, 30, 37), (300, 100, 1000),
                (1000, 0, 70)]


def _delta_inputs(n, r0, m, seed=0):
    y = np.random.default_rng(seed).normal(size=(n, m))
    carry = np.zeros((3, m)) if r0 == 0 else _numpy_sat(y)[:, r0 - 1, :]
    return carry, y[r0:]


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
    # sat_moments and sat_delta share the column pass; a patch from row 0
    # of a signal without -0.0 equals the full build
    y = np.random.default_rng(2).normal(size=(257, 300))
    got = sat_ops.delta_sat_moments(torch.zeros((3, 300), dtype=torch.float64,
                                                device=cuda),
                                    torch.as_tensor(y, device=cuda))
    assert np.array_equal(got.cpu().numpy(), _numpy_sat(y))


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
# visible key)
FA_SHAPES = [(2, 4, 4, 64, 64), (2, 4, 2, 100, 100), (1, 8, 1, 96, 96),
             (2, 4, 2, 1, 64), (1, 2, 2, 300, 300), (2, 3, 1, 130, 260),
             (1, 2, 2, 300, 100)]
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


def test_flash_attention_is_the_same_from_run_to_run(cuda):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v = _qkv((2, 14, 2, 700, 700), 64, torch.bfloat16, cuda, seed=3)
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
