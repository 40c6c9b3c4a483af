"""repro_torch.launch.train on the CPU: crash-and-resume equal to an
uninterrupted run (the reference's bar, rtol 1e-5 / atol 1e-6, and here
bitwise), the losses of ``train_loop`` against the reference's
``train_loop`` from the same weights (rtol 1e-4), the CLI with
``--device cpu`` and its resume, the refusal without a card, and
``NotImplementedError`` for a mesh of more than one rank."""
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.launch.train import train_loop as ref_train_loop  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dtype="float32", remat=False, n_layers=1, d_model=64, vocab=128,
            n_heads=2, n_kv_heads=1, d_ff=128)
COMMON = dict(steps=10, batch=2, seq_len=16, save_every=5, log_every=100)
TIMEOUT_S = 240


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def _tiny(pkg):
    return dataclasses.replace(pkg.reduced_config(pkg.ARCHS["qwen2-0.5b"]), **TINY)


def test_train_resume_is_deterministic(tmp_path):
    """Crash at step 7, resume from the checkpoint of step 5: the final
    params are the uninterrupted run's."""
    cfg = _tiny(configs)
    ref = launch_train.train_loop(cfg, ckpt_dir=str(tmp_path / "ref"),
                                  device="cpu", **COMMON)
    crashy = launch_train.train_loop(cfg, ckpt_dir=str(tmp_path / "crash"),
                                     fail_at=7, device="cpu", **COMMON)
    assert crashy["step"] == ref["step"] == 10
    # the replay runs steps 5 and 6 again: their losses repeat
    assert len(crashy["losses"]) == 12 and crashy["losses"][7:9] == ref["losses"][5:7]
    assert crashy["losses"][-3:] == ref["losses"][-3:]
    for a, b in zip(flatten(ref["params"])[1], flatten(crashy["params"])[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "crash").iterdir()) == [
        "latest", "step_00000005", "step_00000010"]


def test_train_loop_losses_match_the_reference_s(monkeypatch, capsys):
    """Both loops from the reference's weights for seed 0 (the port's init
    draws from a torch.Generator, so its weights are carried across)."""
    rcfg, tcfg = _tiny(ref_configs), _tiny(configs)
    want = ref_train_loop(rcfg, steps=6, batch=2, seq_len=16, log_every=100)
    init = jax.tree.map(np.asarray, ref_models.init_params(rcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(launch_train, "init_params",
                        lambda cfg, gen: models.params_from_jax(cfg, init, gen.device))
    got = launch_train.train_loop(tcfg, steps=6, batch=2, seq_len=16, log_every=2,
                                  device="cpu")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert len(got["grad_norms"]) == len(got["step_s"]) == 6
    assert all(np.isfinite(got["grad_norms"])) and all(s > 0 for s in got["step_s"])
    out = capsys.readouterr().out
    assert "[train] arch=qwen2-0.5b" in out and "device=cpu" in out
    assert "[train] step     4 loss" in out


def _cli(*args, timeout=TIMEOUT_S):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=timeout)


def test_cli_on_the_cpu_trains_and_resumes(tmp_path):
    base = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = _cli(*base, "--steps", "3")
    assert first.returncode == 0, first.stderr
    assert "device=cpu" in first.stdout and "resumed" not in first.stdout
    assert (tmp_path / "latest").read_text() == "3"
    ext = ".npz.zst" if checkpointer.zstandard is not None else ".npz.zlib"
    assert sorted(p.name for p in (tmp_path / "step_00000003").iterdir()) == [
        "DONE", f"host_0{ext}"]
    again = _cli(*base, "--steps", "5")
    assert again.returncode == 0, again.stderr
    assert "[train] resumed from step 3" in again.stdout
    assert "[train] loss first-1-mean" in again.stdout
    assert (tmp_path / "latest").read_text() == "5"


def test_cli_without_a_card_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would train on it")
    out = _cli("--arch", "qwen2-0.5b", "--reduced", "--steps", "1", timeout=120)
    assert out.returncode != 0 and "[train] step" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_production_mesh_waits_for_the_sharding_slice():
    with pytest.raises(NotImplementedError, match="sharding slice"):
        launch_train.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                           "--production-mesh"])


_MESH_RANK = r'''
import sys
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
try:
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    cfg = reduced_config(get_arch("qwen2-0.5b"))
    try:
        train_loop(cfg, steps=1, batch=2, seq_len=8, device="cpu",
                   mesh=make_local_mesh(world, 1, device_type="cpu"))
    except NotImplementedError as exc:
        print("refused:", exc, flush=True)
    one = train_loop(cfg, steps=1, batch=2, seq_len=8, device="cpu",
                     mesh=make_local_mesh(1, 1, device_type="cpu"))
    print("one rank:", one["step"], flush=True)
finally:
    dist.destroy_process_group()
'''


@pytest.mark.parametrize("world", [2])
def test_a_mesh_of_two_ranks_raises_not_implemented(tmp_path, world):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_RANK, str(world), str(r), str(tmp_path / "store")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate(timeout=TIMEOUT_S)
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err}"
        assert f"refused: training over a mesh of {world} ranks" in out
        assert "sharding slice" in out
        assert "one rank: 1" in out
