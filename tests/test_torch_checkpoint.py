"""repro_torch.checkpoint.CheckpointManager against repro's: the same
layout (``step_<k>/host_<i>.npz.<codec>``, the DONE JSON, ``latest``), the
same array names and values, garbage collection, bfloat16 widened to
float32 for storage and restored bitwise, restore onto the template's dtype
and device, and ``save`` taking its host copy before it returns."""
import io
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "layers": [{"b": torch.randn(5, generator=g).bfloat16()},
                                  {"b": torch.randn(5, generator=g).bfloat16()}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": torch.randn(2, 2, generator=g, dtype=torch.float64)},
            "np": np.arange(6, dtype=np.float32).reshape(2, 3),
            "step": 3}


def _npz(path):
    raw = zlib.decompress(path.read_bytes())
    npz = np.load(io.BytesIO(raw))
    return {k: npz[k] for k in npz.files}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2, async_save=False)
    state = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "nested": {"b": torch.tensor(7.0)}, "step": 3}
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    out = mgr.restore(3, state)
    assert torch.equal(out["a"], state["a"])
    assert float(out["nested"]["b"]) == 7.0 and int(out["step"]) == 3
    # a dangling pointer falls back to the newest committed step
    (tmp_path / "latest").write_text("9")
    assert mgr.latest_step() == 3


def test_layout_names_and_done_json_are_the_reference_s(tmp_path):
    """The same tree, as numpy for the reference and as tensors here, saved
    at the same step: the same files, DONE, latest and arrays."""
    tree = _tree()
    ref_tree = {"params": {"w": tree["params"]["w"].numpy(),
                           "layers": [{"b": lp["b"].float().numpy()}
                                      for lp in tree["params"]["layers"]]},
                "opt": {"step": tree["opt"]["step"].numpy(),
                        "m": tree["opt"]["m"].numpy()},
                "np": tree["np"], "step": 3}
    ref = RefManager(tmp_path / "ref", async_save=False, codec="zlib")
    port = CheckpointManager(tmp_path / "port", async_save=False, codec="zlib")
    ref.save(np.int64(5), ref_tree)
    port.save(torch.tensor(5), tree)

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    assert files(tmp_path / "port") == files(tmp_path / "ref") == [
        "latest", "step_00000005", "step_00000005/DONE",
        "step_00000005/host_0.npz.zlib"]
    for name in ("latest", "step_00000005/DONE"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "ref" / name).read_text()
    assert json.loads((tmp_path / "port/step_00000005/DONE").read_text()) == \
        {"step": 5, "num_hosts": 1, "codec": "zlib"}
    got = _npz(tmp_path / "port/step_00000005/host_0.npz.zlib")
    want = _npz(tmp_path / "ref/step_00000005/host_0.npz.zlib")
    assert sorted(got) == sorted(want) == [
        "np", "opt/m", "opt/step", "params/layers/0/b", "params/layers/1/b",
        "params/w", "step"]
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["params/layers/0/b"].dtype == np.float32   # bf16 widened


def test_bf16_roundtrip_is_bitwise_and_lands_on_the_template(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, tree)
    out = mgr.restore(1, tree)
    for a, b in ((out["params"]["layers"][1]["b"], tree["params"]["layers"][1]["b"]),
                 (out["params"]["w"], tree["params"]["w"]),
                 (out["opt"]["step"], tree["opt"]["step"]),
                 (out["opt"]["m"], tree["opt"]["m"])):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert isinstance(out["np"], np.ndarray) and np.array_equal(out["np"], tree["np"])
    assert int(out["step"]) == 3


def test_restore_casts_to_the_template_s_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    src = {"w": torch.linspace(-2, 2, 9, dtype=torch.float64), "n": np.arange(4.0)}
    mgr.save(2, src)
    template = {"w": torch.zeros(9, dtype=torch.bfloat16),
                "n": np.zeros(4, dtype=np.float32)}
    out = mgr.restore(2, template)
    assert out["w"].dtype == torch.bfloat16 and out["n"].dtype == np.float32
    assert torch.equal(out["w"], src["w"].bfloat16())
    assert np.array_equal(out["n"], np.arange(4.0, dtype=np.float32))


def test_async_save_keeps_the_values_at_save_time(tmp_path, monkeypatch):
    """The writer runs after the tree changed in place: it still writes
    what the tree held when save returned."""
    import threading
    gate = threading.Event()
    real = checkpointer.np.savez

    def slow_savez(*a, **kw):
        gate.wait(30)
        return real(*a, **kw)
    monkeypatch.setattr(checkpointer.np, "savez", slow_savez)
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "b": torch.ones(3, dtype=torch.bfloat16), "n": np.arange(3.0)}
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
             for k, v in tree.items()}
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(4, tree)
    tree["w"].mul_(-3)
    tree["b"].add_(5)
    tree["n"] += 9
    gate.set()
    mgr.wait()
    out = mgr.restore(4, tree)
    assert torch.equal(out["w"], saved["w"]) and torch.equal(out["b"], saved["b"])
    assert np.array_equal(out["n"], saved["n"])


def test_codecs_as_the_reference_checks_them(tmp_path):
    with pytest.raises(ValueError, match="unknown codec"):
        CheckpointManager(tmp_path, codec="lz4")
    if checkpointer.zstandard is None:
        with pytest.raises(ValueError, match="zstandard"):
            CheckpointManager(tmp_path, codec="zstd")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(8, {"a": torch.zeros(1)})
