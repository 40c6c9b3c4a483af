"""repro_torch.ops: the backend selection order, the registered backends,
the rule that the CPU must be asked for, and the kernel builder (with a
stand-in compiler, since this host has no nvcc)."""
import os
import stat
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ops  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.sat2d import ops as sat_ops  # noqa: E402
from repro_torch.ops import registry  # noqa: E402


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_registered_backends():
    assert ops.OPS == ("sat_moments", "delta_sat", "fitting_loss",
                       "fitting_loss_batched", "hist_split",
                       "streaming_compress")
    for op in ops.OPS:
        assert ops.available_backends(op) == ("numpy", "torch", "cuda")


def test_selection_order(monkeypatch, no_card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ops.select_backend("fitting_loss") == "cuda"
    monkeypatch.setenv(ops.ENV_VAR, "torch,fitting_loss=numpy")
    assert ops.select_backend("fitting_loss") == "numpy"
    assert ops.select_backend("sat_moments") == "torch"
    with ops.backend_override("cuda"):
        assert ops.select_backend("fitting_loss") == "cuda"
        # the argument beats the override
        assert ops.selected_backend("fitting_loss", backend="numpy") == "numpy"


@pytest.mark.parametrize("spec", ["nonsense", "histsplit=numpy", "xla"])
def test_env_rejects_unknown_names(monkeypatch, spec):
    monkeypatch.setenv(ops.ENV_VAR, spec)
    with pytest.raises(ops.BackendError):
        ops.select_backend("sat_moments")


def test_no_card_and_no_cpu_request_raises(no_card):
    y = np.ones((4, 4))
    with pytest.raises(RuntimeError, match="pin backend"):
        ops.sat_moments(y)
    before = ops.dispatch_counts()
    with pytest.raises(RuntimeError):
        ops.fitting_loss_batched(None, np.zeros((1, 1, 4)), np.zeros((1, 1)))
    assert ops.dispatch_counts() == before      # nothing ran on the CPU


def test_pinned_cuda_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sat_moments(np.ones((3, 3)), backend="cuda")


@pytest.mark.parametrize("call", [
    lambda: ops.delta_sat(np.zeros((3, 2)), np.ones((1, 2)), backend="xla"),
    lambda: ops.streaming_compress([object()], backend="pallas"),
    lambda: ops.hist_split(np.zeros((1, 1), np.uint8), [1.0], [1.0], [1.0], 2,
                           backend="jax"),
])
def test_unregistered_backend_names_the_available_ones(call):
    with pytest.raises(ops.BackendError, match=r"available: \('numpy', "
                                               r"'torch', 'cuda'\)"):
        call()


@pytest.mark.parametrize("call", [
    lambda: ops.delta_sat(np.zeros((3, 2)), np.ones((1, 2))),
    lambda: ops.streaming_compress([object()]),
])
def test_write_path_ops_raise_without_card_or_pin(no_card, call):
    before = ops.dispatch_counts()
    with pytest.raises(RuntimeError, match="pin backend"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with ops.backend_override("cuda"):
            call()
    assert ops.dispatch_counts() == before      # nothing ran on the CPU


def test_dispatch_counter_per_op_and_backend():
    ops.reset_dispatch_counts()
    y = np.arange(6.0).reshape(2, 3)
    ops.sat_moments(y, backend="numpy")
    with ops.backend_override("torch"):
        ops.sat_moments(y)
        ops.sat_moments(y)
    assert ops.dispatch_counts() == {("sat_moments", "numpy"): 1,
                                     ("sat_moments", "torch"): 2}
    ops.reset_dispatch_counts()
    assert ops.dispatch_counts() == {}


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    y = torch.ones(3, 4, dtype=torch.float64)
    assert sat_ops.sat_moments(y).shape == (3, 3, 4)
    with pytest.raises((RuntimeError, ValueError)):
        sat_ops.sat_moments(y.to("meta"))


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_writes_hash_named_libraries_atomically(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "kernels")
    nvcc = _fake_nvcc(tmp_path, "open(args[args.index('-o') + 1], 'w').write('lib')")
    monkeypatch.setattr(common, "_nvcc", lambda: nvcc)
    built = common.build()
    assert sorted(built) == ["fitting_loss", "flash_attention", "histsplit", "sat2d"]
    for name in built:
        path = common.library_path(name)
        assert path.parent == tmp_path / "kernels" and path.read_text() == "lib"
        assert path.name.startswith(name + "-")
    assert not [p for p in os.listdir(tmp_path / "kernels") if p.endswith(".tmp")]
    assert common.build() == {}                 # nothing left to build


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "kernels")
    nvcc = _fake_nvcc(tmp_path, "print('error: no such intrinsic'); sys.exit(2)")
    monkeypatch.setattr(common, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        common.build(["sat2d"])
    assert not os.listdir(tmp_path / "kernels")


def test_library_hash_follows_the_source(tmp_path, monkeypatch):
    for name in ("a.cu", "common.cuh"):
        (tmp_path / name).write_text("x")
    monkeypatch.setattr(common, "CSRC", tmp_path)
    before = common.library_path("a")
    (tmp_path / "common.cuh").write_text("y")
    assert common.library_path("a") != before


def test_require_cuda_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.require_cuda()


def test_registry_rejects_unknown_names():
    with pytest.raises(ops.BackendError):
        registry.register("not_an_op", "numpy")
    with pytest.raises(ops.BackendError):
        registry.register("sat_moments", "xla")
    with pytest.raises(ops.BackendError):
        with ops.backend_override("pallas"):
            pass


def test_cuda_kernel_is_safe_under_threads(monkeypatch):
    # many threads call one kernel at once (sharded_coreset's band pool): the
    # symbol is looked up once and no launch goes uncounted
    import threading
    import time
    lookups = []

    class FakeLib:
        def __getattr__(self, symbol):
            lookups.append(symbol)
            time.sleep(0.01)                    # widen the lookup's window
            return lambda *args: 0

    monkeypatch.setattr(common, "library", lambda name: FakeLib())
    kern = common.CudaKernel("fake", "fake_launch", [])
    threads, calls = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda: [kern() for _ in range(calls)])
                for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    assert lookups == ["fake_launch"]
    assert kern.launches == threads * calls


# ------------------------------------------- the dispatch seam and config=
@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A private, cold autotune cache."""
    from repro_torch.ops import autotune
    monkeypatch.setenv(autotune.CACHE_ENV_VAR, str(tmp_path / "autotune.json"))
    monkeypatch.delenv(autotune.DISABLE_ENV_VAR, raising=False)
    autotune.reset_cache()
    yield autotune
    autotune.reset_cache()


def _coreset():
    from repro_torch.core import random_tree_segmentation, signal_coreset
    from repro_torch.data import piecewise_signal
    with ops.backend_override("numpy"):
        cs = signal_coreset(piecewise_signal(40, 36, 4, seed=0), 4, 0.3)
    segs = [random_tree_segmentation(40, 36, 5, np.random.default_rng(i))
            for i in range(3)]
    return (cs, np.stack([s.rects for s in segs]).astype(np.float64),
            np.stack([s.labels for s in segs]))


def test_size_reaches_profile_hooks_and_the_dispatch_span(tune_cache):
    from repro_torch import obs
    seen = []

    def hook(op, backend, size, seconds):
        seen.append((op, backend, size))
    y = np.ones((5, 7))
    cs, sr, sl = _coreset()
    obs.profile.add_hook(hook)
    root = obs.TRACER.start_trace("req")
    try:
        with obs.TRACER.attach(root):
            ops.sat_moments(y, backend="numpy")
            ops.fitting_loss_batched(cs, sr, sl, backend="torch")
    finally:
        root.end()
        obs.profile.remove_hook(hook)
    fl_size = ops.fitting_loss_batched_size(cs, sr)
    assert seen == [("sat_moments", "numpy", 105),
                    ("fitting_loss_batched", "torch", fl_size)]
    spans = [s for s in obs.TRACER.get(root.trace_id)["spans"]
             if s["name"] == "ops.dispatch"]
    assert [s["attrs"] for s in spans] == [
        {"op": "sat_moments", "backend": "numpy", "size": 105,
         "shape_bucket": "le_2^7"},
        {"op": "fitting_loss_batched", "backend": "torch", "size": fl_size,
         "shape_bucket": obs.profile.shape_bucket(fl_size)}]
    assert all(s["parent_id"] == root.span_id for s in spans)


def test_snapshot(no_card, monkeypatch):
    monkeypatch.setenv(ops.ENV_VAR, "torch,hist_split=numpy")
    snap = ops.snapshot()
    assert list(snap) == list(ops.OPS)
    assert snap["hist_split"] == {"available": ["numpy", "torch", "cuda"],
                                  "selected": "numpy", "env_override": "numpy",
                                  "pinned": True}
    assert snap["fitting_loss"]["selected"] == "torch"
    assert not snap["fitting_loss"]["pinned"]
    assert {op for op, s in snap.items() if s["pinned"]} == ops.PINNED_OPS == {
        "sat_moments", "delta_sat", "hist_split", "streaming_compress"}
    monkeypatch.delenv(ops.ENV_VAR)
    assert ops.snapshot()["sat_moments"]["selected"] is None   # would raise


def _all_ops_calls():
    rng = np.random.default_rng(4)
    y = rng.normal(size=(33, 21))
    carry = ops.sat_moments(y[:1], backend="numpy")[:, 0, :]
    codes = rng.integers(0, 16, size=(300, 3)).astype(np.uint8)
    w = rng.uniform(0.5, 1.5, 300)
    cs, sr, sl = _coreset()
    return {
        "sat_moments": lambda **kw: ops.sat_moments(y, **kw),
        "delta_sat": lambda **kw: ops.delta_sat(carry, y[1:], **kw),
        "fitting_loss": lambda **kw: ops.fitting_loss(cs, sr[0], sl[0], **kw),
        "fitting_loss_batched": lambda **kw: ops.fitting_loss_batched(cs, sr, sl, **kw),
        "hist_split": lambda **kw: ops.hist_split(codes, w, w * 2, w * 4, 16, **kw),
        "streaming_compress": lambda **kw: np.concatenate([
            c.moments for c in ops.streaming_compress([cs, cs], 3, 0.5, **kw)]),
    }


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_cold_cache_config_none_is_bitwise_config_empty(tune_cache, backend):
    # and on the float64 ops it is numpy's output, bitwise
    hits = tune_cache.counters_snapshot()["cache_hit"]
    for op, call in _all_ops_calls().items():
        got = call(backend=backend)
        assert np.array_equal(got, call(backend=backend, config={})), op
        if op not in ("fitting_loss", "fitting_loss_batched"):
            assert np.array_equal(got, call(backend="numpy")), op
    assert tune_cache.counters_snapshot()["cache_hit"] == hits


def test_bind_follows_a_planted_plan_and_stays_resident_when_cold(tune_cache):
    from repro_torch.kernels.histsplit.ops import ResidentHist
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 16, size=(500, 3)).astype(np.uint8)
    w = rng.uniform(0.5, 1.5, 500)
    args = (codes, w, w * 3, w * 9, 16)
    rows = np.flatnonzero(rng.random(500) < 0.5)
    _, fn = registry.resolve("hist_split", "torch")
    assert isinstance(fn.bind(*args), ResidentHist)          # cold: resident
    want = ops.hist_split(codes[rows], w[rows], w[rows] * 3, w[rows] * 9, 16,
                          backend="numpy")
    ops.reset_dispatch_counts()
    assert np.array_equal(ops.bind("hist_split", *args, backend="torch")(rows),
                          want)
    bucket = tune_cache.shape_bucket(codes.size)

    def plant(cfg):
        tune_cache.get_cache().put("hist_split", "torch", bucket,
                                   {"config": cfg, "us": 1.0, "numpy_us": 2.0,
                                    "rel_err": 1e-8})
    # a plain float32 plan of the pinned op is held in the default mode
    plant({"variant": "vmap", "compensated": False})
    assert isinstance(fn.bind(*args), ResidentHist)
    # a certified compensated plan is followed, each node on its rows
    cfg = {"variant": "chunked", "compensated": True}
    plant(cfg)
    assert not isinstance(fn.bind(*args), ResidentHist)
    node = ops.bind("hist_split", *args, backend="torch")
    got = node(rows)
    assert np.array_equal(got, ops.hist_split(codes[rows], w[rows], w[rows] * 3,
                                              w[rows] * 9, 16, backend="torch",
                                              config=cfg))
    assert tune_cache._scaled_rel_err(got, want) <= tune_cache.PARITY_RTOL
    assert ops.dispatch_counts() == {("hist_split", "torch"): 3}
