"""repro_torch.launch.train on the CPU: crash-and-resume equal to an
uninterrupted run (the reference's bar, rtol 1e-5 / atol 1e-6, and here
bitwise), the losses of ``train_loop`` against the reference's
``train_loop`` from the same weights (rtol 1e-4), the CLI with
``--device cpu`` and its resume, the refusal without a card, and
``--production-mesh``'s 256 ranks.  Data parallel with ZeRO-1 over 2 and 4
gloo ranks (child processes, ``torch_ranks``): losses within 1e-5 and
weights within 1e-4 of the reference's train step jitted on one device and
over a (2, 1) mesh of forced host devices, with an optimizer that moves the
weights far past that bar, the optimizer parts covering
each leaf once; ``NotImplementedError`` for a "model" axis of more than one
rank and for an MoE model over data ranks."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.data import tokens as ref_data  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.launch.train import train_loop as ref_train_loop  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from torch_ranks import TRAIN_RANK, run_ranks  # noqa: E402

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


def test_production_mesh_needs_its_256_ranks():
    """``--production-mesh`` joins a world (here one of this one process)
    and builds the (16, 16) mesh, which needs 256 ranks."""
    out = _cli("--arch", "qwen2-0.5b", "--reduced", "--steps", "1", "--device", "cpu",
               "--production-mesh", timeout=120)
    assert out.returncode != 0 and "[train] step" not in out.stdout
    assert "need 256 ranks for a (16, 16) mesh, have 1" in out.stderr
    assert "NotImplementedError" not in out.stderr


# ------------------------------------------------ data parallel over ranks
ARCH = "qwen2-0.5b"
# n_layers 2: ZeRO-1 cuts the stacked layers at data 2; at data 4 it cuts
# the matrices' d and the biases' head_dim under 4 and 1 heads, a strided
# cut of the port's flat (H * hd,) bias
REDUCED = dict(n_layers=2)
LOOP = dict(steps=3, batch=8, seq_len=16)
# an optimizer that moves the weights well past the weights' bar in three
# steps (test_torch_train.py's): AdamWConfig(total_steps=3), train_loop's
# default, moves them by ~2e-5 in three steps of its warmup
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-4
DP_MESHES = {"2x1": ((2, 1), ("data", "model")),
             "4x1": ((4, 1), ("data", "model")),
             "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def _ref_cfg(**reduced):
    return dataclasses.replace(ref_configs.reduced_config(ref_configs.ARCHS[ARCH], **reduced),
                               dtype="float32")


def _port_cfg(**reduced):
    return dataclasses.replace(configs.reduced_config(configs.ARCHS[ARCH], **reduced),
                               dtype="float32")


def _flat_np(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in flat}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train step jitted on one device for LOOP's steps,
    from its init for seed 0 (also written as an npz) on its train_loop's
    token stream, with OCFG."""
    tmp = tmp_path_factory.mktemp("ref")
    rcfg, tcfg = _ref_cfg(**REDUCED), _port_cfg(**REDUCED)
    params = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
    np.savez(tmp / "init.npz", **_flat_np(params))
    init = models.params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    opt = ref_train.adamw_init(params)
    step = jax.jit(ref_train.make_train_step(rcfg, ref_train.AdamWConfig(**OCFG)))
    stream = ref_data.TokenStream(rcfg.vocab, LOOP["batch"], LOOP["seq_len"], seed=0)
    losses = []
    for s in range(LOOP["steps"]):
        params, opt, m = step(params, opt,
                              {k: jax.numpy.asarray(v) for k, v in stream.batch_at(s).items()})
        losses.append(float(m["loss"]))
    params = models.params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    opt = models.opt_state_from_jax(tcfg, jax.tree.map(np.asarray, opt))
    moved = max(float((a - b).abs().max())
                for a, b in zip(flatten(params)[1], flatten(init)[1]))
    assert moved > 10 * WEIGHT_ATOL
    return {"init": tmp / "init.npz", "losses": losses,
            "params": flatten(params), "master": flatten(opt["master"])}


@pytest.fixture(scope="module")
def dp_runs(reference, tmp_path_factory):
    runs = {}

    def get(mesh):
        if mesh not in runs:
            tmp = tmp_path_factory.mktemp(f"dp{mesh}")
            shape, axes = DP_MESHES[mesh]
            spec = {"arch": ARCH, "reduced": REDUCED, "init": str(reference["init"]),
                    "shape": shape, "axes": axes, "loops": {"dp": dict(LOOP, opt=OCFG)},
                    "out": str(tmp)}
            res = run_ranks(TRAIN_RANK, int(np.prod(shape)), tmp, json.dumps(spec))
            runs[mesh] = (res, [np.load(tmp / f"dp_rank{r}.npz") for r in range(len(res))])
        return runs[mesh]
    return get


@pytest.mark.parametrize("mesh", sorted(DP_MESHES))
def test_train_loop_over_gloo_ranks_matches_the_reference_s(reference, dp_runs, mesh):
    """Every rank's losses within 1e-5 of the reference's one-device run and
    its weights within 1e-4; losses, grad norms and gathered params the
    same bits on every rank."""
    res, parts = dp_runs(mesh)
    first = res[0]["runs"]["dp"]
    for r in res:
        run = r["runs"]["dp"]
        assert r["bad"] == []
        assert run["step"] == run["opt_step"] == LOOP["steps"]
        assert run["losses"] == first["losses"] and run["grad_norms"] == first["grad_norms"]
        assert run["digest"] == first["digest"]
        assert len(run["sync"]) == LOOP["steps"]
        assert all(s["sync_bytes"] > 0 and s["sync_s"] > 0 for s in run["sync"])
    np.testing.assert_allclose(first["losses"], reference["losses"], rtol=LOSS_RTOL)
    keys, want = reference["params"]
    for key, w in zip(keys, want):
        np.testing.assert_allclose(parts[0]["params/" + key], w.numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=key)


@pytest.mark.parametrize("mesh", sorted(DP_MESHES))
def test_zero1_parts_cover_each_optimizer_leaf_once(reference, dp_runs, mesh):
    """The ranks' master parts, placed where ``state_shardings`` puts each
    rank's coordinate (on the leaf's reference view), hold every element of
    every leaf once a pod (the pods' copies bitwise equal) and are the
    reference's masters."""
    from repro_torch.sharding import state_shardings
    from repro_torch.sharding import compat_abstract_mesh
    from torch.distributed.tensor import Shard
    res, parts = dp_runs(mesh)
    shape, axes = DP_MESHES[mesh]
    at = flatten(state_shardings(_port_cfg(**REDUCED),
                                 compat_abstract_mesh(shape, axes))["opt"]["master"])[1]
    pods = dict(zip(axes, shape)).get("pod", 1)
    keys, want = reference["master"]
    if mesh == "4x1":
        bias = at[keys.index("layers/0/attn/wq/b")]
        assert bias.view == (4, 32) and bias.placements[0] == Shard(1)
    for key, w, named in zip(keys, want, at):
        view = named.view_of(w.shape)
        whole = np.full(view, np.nan, dtype=np.float32)
        count = np.zeros(view, dtype=np.int64)
        for r, p in zip(res, parts):
            sl = named.local_slices(view, r["coord"])
            part = p["master/" + key]
            assert part.size == whole[sl].size, key
            part = part.reshape(whole[sl].shape)
            assert np.isnan(whole[sl]).all() or np.array_equal(whole[sl], part), key
            whole[sl] = part
            count[sl] += 1
        assert (count == pods).all(), key
        np.testing.assert_allclose(whole.reshape(w.shape), w.numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=key)
    owned = [sum(p["master/" + k].size for k in keys) for p in parts]
    assert sum(owned) == pods * sum(w.numel() for w in want)


_REF_ON_TWO_DEVICES = r"""
import dataclasses, json, sys
import jax
import numpy as np
from repro.configs import ARCHS, reduced_config
from repro.data.tokens import TokenStream
from repro.launch.mesh import make_local_mesh
from repro.models import init_params
from repro.sharding import compat_set_mesh, named, opt_specs, param_specs
from repro.train import AdamWConfig, adamw_init, make_train_step
spec = json.loads(sys.argv[1])
assert jax.device_count() == 2, jax.devices()
cfg = dataclasses.replace(reduced_config(ARCHS[spec["arch"]], **spec["reduced"]),
                          dtype="float32")
loop = spec["loop"]
mesh = make_local_mesh(2, 1)
params = init_params(cfg, jax.random.PRNGKey(0))
opt = adamw_init(params)
pspec = named(mesh, param_specs(params, mesh))
ospec = named(mesh, opt_specs(params, mesh))
params = jax.tree.map(jax.device_put, params, pspec)
opt = jax.tree.map(jax.device_put, opt, ospec)
step_fn = make_train_step(cfg, AdamWConfig(**spec["opt"]))
with compat_set_mesh(mesh):
    jitted = jax.jit(step_fn, in_shardings=(pspec, ospec, None),
                     out_shardings=(pspec, ospec, None), donate_argnums=(0, 1))
stream = TokenStream(cfg.vocab, loop["batch"], loop["seq_len"], seed=0)
losses = []
for s in range(loop["steps"]):
    batch = {k: jax.numpy.asarray(v) for k, v in stream.batch_at(s).items()}
    with compat_set_mesh(mesh):
        params, opt, m = jitted(params, opt, batch)
    losses.append(float(m["loss"]))
flat, _ = jax.tree_util.tree_flatten_with_path(params)
np.savez(spec["out"], **{"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in flat})
print(json.dumps({"losses": losses}))
"""


def test_two_ranks_match_the_reference_s_two_device_mesh(tmp_path, dp_runs):
    """The reference's train step jitted over a (2, 1) mesh of two forced
    host devices (a child process, so that the flag precedes jax's start),
    as its train_loop places it: params by param_specs, the optimizer by
    opt_specs (ZeRO-1).  Its train_loop itself fails there at the second
    step (jit's in_shardings against the layout XLA gave the first step's
    outputs), so the step's out_shardings are those same specs."""
    spec = {"arch": ARCH, "reduced": REDUCED, "loop": LOOP, "opt": OCFG,
            "out": str(tmp_path / "ref2.npz")}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_ON_TWO_DEVICES, json.dumps(spec)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])["losses"]
    ref = np.load(tmp_path / "ref2.npz")
    tree = {}
    for key in ref.files:
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = ref[key]
    keys, params = flatten(models.params_from_jax(_port_cfg(**REDUCED), tree))
    res, parts = dp_runs("2x1")
    np.testing.assert_allclose(res[0]["runs"]["dp"]["losses"], want, rtol=LOSS_RTOL)
    for key, w in zip(keys, params):
        np.testing.assert_allclose(parts[0]["params/" + key], w.numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=key)


_REFUSE_RANK = r"""
import json, sys
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import destroy_world
try:
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.train import train_loop
    out = {}
    for name, arch, shape, layers in json.loads(sys.argv[4]):
        cfg = reduced_config(get_arch(arch), n_layers=layers)
        mesh = compat_make_mesh(shape, ("data", "model"), device_type="cpu")
        try:
            train_loop(cfg, steps=1, batch=4, seq_len=8, device="cpu", mesh=mesh)
            out[name] = "trained"
        except NotImplementedError as exc:
            out[name] = [type(exc).__name__, str(exc)]
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
"""


@pytest.mark.parametrize("world", [2])
def test_a_mesh_of_two_ranks_raises_not_implemented(tmp_path, world):
    """A "model" axis of two ranks, and an MoE model over two data ranks:
    the tensor- and expert-parallel slice."""
    cases = [("model_axis", ARCH, (1, world), 2),
             ("moe", "qwen3-moe-235b-a22b", (world, 1), 2)]
    for r in run_ranks(_REFUSE_RANK, world, tmp_path, json.dumps(cases)):
        assert r["model_axis"][0] == "NotImplementedError"
        assert f"'model' axis of {world} ranks" in r["model_axis"][1]
        assert r["moe"][0] == "NotImplementedError"
        assert f"MoE model over {world} data ranks" in r["moe"][1]
        assert "expert-parallel slice" in r["moe"][1]
