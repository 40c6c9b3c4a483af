"""The float64 split histogram over a node's rows: the four-pass plain
version (count, scan, stable order, ordered segment sums) and the resident
path the trees take (``ResidentHist`` through ``ops.bind``), on the CPU,
against the reference's numpy ``hist_split`` on ``codes[rows]``, bitwise.
The CUDA kernel is held to the same cases in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.kernels.histsplit import ops as hist_ops  # noqa: E402
from repro_torch.kernels.histsplit.ref import hist_rows_ref  # noqa: E402
from repro_torch.trees import DecisionTreeRegressor  # noqa: E402

# (P, F, n_bins, rows, codes): rows "all", "half" (a strict ascending random
# subset), "one", "none"; codes "random" or "one_bin" (every point in the
# last bin: one chain as long as the node)
CASES = [
    (300, 1, 2, "all", "random"), (300, 3, 2, "half", "random"),
    (500, 1, 256, "half", "random"), (500, 3, 256, "all", "random"),
    (257, 3, 17, "half", "random"), (64, 2, 256, "one", "random"),
    (64, 3, 16, "none", "random"), (400, 2, 256, "half", "one_bin"),
    (400, 1, 2, "all", "one_bin"), (1, 1, 2, "all", "random"),
]
IDS = [f"P{p}-F{f}-B{b}-{r}-{c}" for p, f, b, r, c in CASES]


def _case(P, F, B, rows, codes, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, B, size=(P, F)).astype(np.uint8)
    if codes == "one_bin":
        c[:] = B - 1
    # signs and magnitudes that make the order of the adds show
    w = rng.uniform(0.1, 2, P) * np.where(rng.random(P) < 0.2, -1, 1)
    y = rng.normal(size=P) * 10.0 ** rng.integers(-6, 6, P)
    idx = {"all": np.arange(P), "one": np.array([P // 2]),
           "none": np.zeros(0, np.int64),
           "half": np.sort(rng.choice(P, size=P // 2, replace=False))}[rows]
    return c, w, w * y, w * y * y, idx


def _want(c, w, wy, wy2, idx, B):
    return ref_ops.hist_split(c[idx], w[idx], wy[idx], wy2[idx], B,
                              backend="numpy")


def _same(got, want):
    return (got.dtype == np.float64 and np.array_equal(got, want)
            and np.array_equal(np.signbit(got), np.signbit(want)))


@pytest.mark.parametrize("P,F,B,rows,codes", CASES, ids=IDS)
def test_four_pass_plain_version_bitwise_equals_reference(P, F, B, rows, codes):
    c, w, wy, wy2, idx = _case(P, F, B, rows, codes)
    vals = hist_ops.pack_values(*(torch.from_numpy(a) for a in (w, wy, wy2)))
    got = hist_rows_ref(torch.from_numpy(c), vals, torch.from_numpy(idx), B)
    assert got.shape == (F, B, 3)
    assert _same(got.numpy(), _want(c, w, wy, wy2, idx, B))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("P,F,B,rows,codes", CASES, ids=IDS)
def test_bound_node_hist_bitwise_equals_reference(backend, P, F, B, rows,
                                                  codes):
    c, w, wy, wy2, idx = _case(P, F, B, rows, codes, seed=1)
    node = ops.bind("hist_split", c, w, wy, wy2, B, backend=backend)
    assert _same(np.asarray(node(idx)), _want(c, w, wy, wy2, idx, B))


def test_resident_set_serves_many_nodes():
    c, w, wy, wy2, _ = _case(600, 3, 64, "all", "random", seed=2)
    res = hist_ops.ResidentHist(c, w, wy, wy2, 64, device="cpu")
    rng = np.random.default_rng(3)
    for n in (600, 300, 2, 1, 0, 599):
        idx = np.sort(rng.choice(600, size=n, replace=False))
        assert _same(res(idx), _want(c, w, wy, wy2, idx, 64))


def test_bound_calls_count_one_dispatch_each():
    c, w, wy, wy2, idx = _case(200, 2, 32, "half", "random", seed=4)
    ops.reset_dispatch_counts()
    node = ops.bind("hist_split", c, w, wy, wy2, 32, backend="torch")
    assert ops.dispatch_counts() == {("hist_split", "torch"): 0}
    bound_s = ops.dispatch_seconds()[("hist_split", "torch")]
    for k in range(1, 4):
        node(idx)
        assert ops.dispatch_counts() == {("hist_split", "torch"): k}
    assert ops.dispatch_seconds()[("hist_split", "torch")] > bound_s > 0


@pytest.mark.parametrize("rows,err,match", [
    (np.array([3, 2]), ValueError, "strictly ascending"),
    (np.array([1, 1]), ValueError, "strictly ascending"),
    (np.array([-1, 2]), ValueError, r"\[0, 50\)"),
    (np.array([10, 50]), ValueError, r"\[0, 50\)"),
    (np.array([[1, 2]]), TypeError, r"\(n,\) integers"),
    (np.array([0.0, 1.0]), TypeError, r"\(n,\) integers"),
])
def test_resident_rejects_rows_the_kernel_cannot_take(rows, err, match):
    c, w, wy, wy2, _ = _case(50, 2, 8, "all", "random")
    res = hist_ops.ResidentHist(c, w, wy, wy2, 8, device="cpu")
    with pytest.raises(err, match=match):
        res(rows)


def test_tree_uploads_its_data_once(monkeypatch):
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 10, size=(300, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=300)
    packed = (300 * 3 * 8 + 300 * 2,)
    uploads = []
    real_to = torch.Tensor.to

    def spy(self, *a, **kw):
        uploads.append(tuple(self.shape))
        return real_to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    ops.reset_dispatch_counts()
    t = DecisionTreeRegressor(max_leaves=8, hist_backend="torch").fit(X, y)
    assert ops.dispatch_counts()[("hist_split", "torch")] == len(t.nodes) > 1
    assert uploads.count(packed) == 1


def test_plain_version_of_all_rows_is_the_f64_op_surface():
    c, w, wy, wy2, _ = _case(700, 3, 32, "all", "random", seed=6)
    t = (torch.from_numpy(a) for a in (w, wy, wy2))
    got = hist_ops.histograms(torch.from_numpy(c), *t, 32).numpy()
    assert _same(got, ref_ops.hist_split(c, w, wy, wy2, 32, backend="numpy"))


def test_f64_source_adds_floats_with_no_atomics():
    # the float64 path's only atomics count codes in shared int32 arrays;
    # every float64 add is an ordered __dadd_rn (add_rn)
    import re

    from repro_torch.kernels.common import CSRC
    src = (CSRC / "histsplit.cu").read_text()
    f64 = src[src.index("constexpr int ROWS_THREADS"):src.index("}  // namespace")]
    calls = re.findall(r"atomic\w*\(\s*([^,]+),", f64)
    assert calls and all(c.startswith("&cnt[") for c in calls)
    assert re.findall(r"\bint\*? ?cnt\b", f64)
    assert not re.search(r"(double|float)\s*\*?\s*cnt\b", f64)
    assert "add_rn(a0" in f64 and not re.search(r"a0\s*\+=", f64)
