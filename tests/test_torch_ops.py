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
