"""repro_torch.launch.train's partitioned step over gloo ranks on the CPU
(child processes, ``torch_ranks``, their world on ``launch.transport``),
against the reference.

* MoE over data ranks: the reduced float32 qwen3-moe over (2, 1) and
  (2, 2) (experts cut over "model" there) against the reference's step
  jitted over forced 2- and 4-device meshes, its dispatch groups from its
  abstract mesh: losses within 1e-5, weights within 1e-4, once no token's
  k-th and (k+1)-th router probabilities are within 1e-5 of each other (a
  pick could flip between the packages).
* A one-row batch (``batch_specs`` cuts it over a data axis of size 1) at
  (1, 1) and (1, 2), qwen2 and qwen3-moe: the one-device step's loss
  (within 1e-5), gradients and new parameters (within 1e-4).
* Over (1, 2), two microbatches keep the step (losses 1e-5, weights
  1e-4), and checkpoints of the placed state: a crash and resume is
  bitwise the run without it; a (1, 2) checkpoint restores placed
  (``restore(shardings=StateLayout)`` is ``reshard_state``) and resumes on
  one device and on (2, 1) (ZeRO-1) within the bars above.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import AdamWConfig  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from torch_ranks import ROOT, TRAIN_RANK, run_ranks  # noqa: E402

LOSS_RTOL, WEIGHT_ATOL, ROUTER_MARGIN = 1e-5, 1e-4, 1e-5
LOOP = dict(steps=3, batch=8, seq_len=16)
# moves the weights well past the weights' bar in three steps
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TIMEOUT_S = 240
MOE = "qwen3-moe-235b-a22b"
MOE_MESHES = {"2x1": (2, 1), "2x2": (2, 2)}


def _port_cfg(arch, **reduced):
    return dataclasses.replace(configs.reduced_config(configs.ARCHS[arch], **reduced),
                               dtype="float32")


def _init_npz(arch, path):
    """The reference's init for seed 0 of the reduced float32 ``arch``,
    written by leaf path."""
    rcfg = dataclasses.replace(ref_configs.reduced_config(ref_configs.ARCHS[arch]),
                               dtype="float32")
    params = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez(path, **{"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in flat})
    return path


def _tree(npz) -> dict:
    tree = {}
    for key in npz.files:
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = npz[key]
    return tree


# ------------------------------------------------------- MoE over data ranks
_REF_ON_MESH = r"""
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
data, model = spec["mesh"]
assert jax.device_count() == data * model, jax.devices()
cfg = dataclasses.replace(reduced_config(ARCHS[spec["arch"]]), dtype="float32")
loop = spec["loop"]
mesh = make_local_mesh(data, model)
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


@pytest.fixture(scope="module")
def moe_init(tmp_path_factory):
    return _init_npz(MOE, tmp_path_factory.mktemp("moe") / "init.npz")


@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
def test_moe_over_data_ranks_matches_the_reference_s_mesh(tmp_path, moe_init, mesh):
    """The reduced float32 qwen3-moe trained over ``mesh`` (dispatch groups
    = the data ranks; at (2, 2) the experts cut over "model") against the
    reference's step jitted over the same mesh of forced host devices."""
    shape = MOE_MESHES[mesh]
    n = shape[0] * shape[1]
    spec = {"arch": MOE, "loop": LOOP, "opt": OCFG, "mesh": list(shape),
            "out": str(tmp_path / "ref.npz")}
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REF_ON_MESH, json.dumps(spec)],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    rank_spec = {"arch": MOE, "reduced": {}, "init": str(moe_init), "shape": shape,
                 "axes": ["data", "model"], "loops": {"tp": dict(LOOP, opt=OCFG)},
                 "out": str(tmp_path), "margin": True}
    try:
        res = run_ranks(TRAIN_RANK, n, tmp_path, json.dumps(rank_spec))
        out, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    want = json.loads(out.strip().splitlines()[-1])["losses"]
    assert min(r["margin"] for r in res) > ROUTER_MARGIN, \
        "a near-tie in the routing: a pick may flip between the packages"
    first = res[0]["runs"]["tp"]
    for r in res:
        assert r["bad"] == [] and r["runs"]["tp"]["losses"] == first["losses"]
        assert r["runs"]["tp"]["digest"] == first["digest"]
        assert all(s["by_kind"] for s in r["runs"]["tp"]["sync"])
    np.testing.assert_allclose(first["losses"], want, rtol=LOSS_RTOL)
    keys, params = flatten(models.params_from_jax(_port_cfg(MOE),
                                                  _tree(np.load(tmp_path / "ref.npz"))))
    got = np.load(tmp_path / "tp_rank0.npz")
    moved = 0.0
    init = flatten(models.params_from_jax(_port_cfg(MOE), _tree(np.load(moe_init))))[1]
    for key, w, w0 in zip(keys, params, init):
        np.testing.assert_allclose(got["params/" + key], w.numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=key)
        moved = max(moved, float((w - w0).abs().max()))
    assert moved > 10 * WEIGHT_ATOL


# ------------------------------------------------------- a one-row batch
_ONE_ROW = r'''
import dataclasses, json, sys
import numpy as np
import torch
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
arch, model = sys.argv[4], int(sys.argv[5])
from repro_torch.launch import transport
transport.start_world("file://" + store, world, rank)
from repro_torch.launch.mesh import destroy_world
try:
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params
    from repro_torch.sharding.dtensor import (distribute_batch, partitioned_train_step,
                                              state_layout)
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import make_grad_fn
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(reduced_config(get_arch(arch)), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, 32)).astype(np.int32))
             for k in ("tokens", "targets")}
    ocfg = AdamWConfig(warmup_steps=1)
    loss, grads, _ = make_grad_fn(cfg)(params, batch)
    new, _, _ = make_train_step(cfg, ocfg)(params, adamw_init(params), batch)
    mesh = make_local_mesh(1, model, device_type="cpu")
    lay = state_layout(cfg, mesh, "train")
    with implicit_replication():
        p = lay.params(params)
        b = distribute_batch(batch, mesh)
        ploss, pgrads, _ = make_grad_fn(cfg, mesh=mesh)(p, b)
        pnew, _, met = partitioned_train_step(cfg, ocfg, lay)(
            p, lay.opt_state(adamw_init(params)), b)
        whole = lambda t, like: t.full_tensor().reshape(like.shape)  # noqa: E731
        out = {
            "loss": float(loss), "ploss": float(ploss.full_tensor()),
            "step_loss": float(met["loss"].to_local()),
            "grad_err": max(float((whole(g, w) - w).abs().max())
                            for g, w in zip(leaves(pgrads), leaves(grads))),
            "param_err": max(float((whole(g, w) - w).abs().max())
                             for g, w in zip(leaves(pnew), leaves(new))),
            "moved": max(float((n - o).abs().max())
                         for n, o in zip(leaves(new), leaves(params))),
            "batch_placements": sorted({repr(pl) for t in b.values()
                                        for pl in t.placements})}
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
'''


@pytest.mark.parametrize("arch", ["qwen2-0.5b", MOE])
@pytest.mark.parametrize("model", [1, 2], ids=["1x1", "1x2"])
def test_a_one_row_batch_is_the_one_device_step(tmp_path, arch, model):
    """A global batch of one row on a mesh whose data axis is 1 (the
    reference's ``batch_specs`` cuts it there: 1 divides 1): placed
    replicated, since a cut over a mesh dim of size 1 cuts nothing, and the
    step is the one-device step."""
    for out in run_ranks(_ONE_ROW, model, tmp_path, arch, str(model)):
        assert out["batch_placements"] == ["Replicate()"]
        assert abs(out["ploss"] - out["loss"]) <= 1e-5 * abs(out["loss"])
        assert abs(out["step_loss"] - out["loss"]) <= 1e-5 * abs(out["loss"])
        assert out["grad_err"] <= 1e-4
        assert out["param_err"] <= 1e-4 < out["moved"]


# ------------------------------------------------ checkpoints of the placed state
QWEN = "qwen2-0.5b"
RESUME = dict(steps=4, batch=8, seq_len=16)
SAVE_AT = 2


@pytest.fixture(scope="module")
def tp_checkpoints(tmp_path_factory):
    """Over (1, 2): a straight run of RESUME; the same in two microbatches;
    the same crashing at step 3 with a checkpoint every SAVE_AT steps; and
    a run to SAVE_AT whose checkpoint the resumes read, restored placed."""
    tmp = tmp_path_factory.mktemp("tpckpt")
    init = _init_npz(QWEN, tmp / "init.npz")
    loops = {"straight": dict(RESUME, opt=OCFG),
             "micro": dict(RESUME, opt=OCFG, microbatches=2),
             "crash": dict(RESUME, opt=OCFG, ckpt_dir=str(tmp / "crash"),
                           save_every=SAVE_AT, fail_at=3),
             "saved": dict(RESUME, steps=SAVE_AT, opt=OCFG, ckpt_dir=str(tmp / "saved"),
                           save_every=SAVE_AT)}
    spec = {"arch": QWEN, "reduced": {}, "init": str(init), "shape": [1, 2],
            "axes": ["data", "model"], "loops": loops, "out": str(tmp),
            "restore": {"dir": str(tmp / "saved"), "step": SAVE_AT}}
    res = run_ranks(TRAIN_RANK, 2, tmp, json.dumps(spec))
    return tmp, init, res


def test_a_crash_and_resume_over_a_model_axis_is_bitwise(tp_checkpoints):
    tmp, _, res = tp_checkpoints
    for r in res:
        straight, crash = r["runs"]["straight"], r["runs"]["crash"]
        assert crash["step"] == straight["step"] == RESUME["steps"]
        # the replay runs step 2 again
        assert len(crash["losses"]) == RESUME["steps"] + 1
        assert crash["losses"][-2:] == straight["losses"][-2:]
        assert crash["digest"] == straight["digest"]
    got = np.load(tmp / "crash_rank0.npz")
    want = np.load(tmp / "straight_rank0.npz")
    for k in want.files:
        assert np.array_equal(got[k], want[k]), k


def test_microbatches_over_a_model_axis_keep_the_step(tp_checkpoints):
    """Two microbatches of each rank's rows: the straight run's losses
    within 1e-5 and its weights within 1e-4."""
    tmp, _, res = tp_checkpoints
    for r in res:
        np.testing.assert_allclose(r["runs"]["micro"]["losses"],
                                   r["runs"]["straight"]["losses"], rtol=LOSS_RTOL)
    got = np.load(tmp / "micro_rank0.npz")
    want = np.load(tmp / "straight_rank0.npz")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=WEIGHT_ATOL, err_msg=k)


def test_a_model_axis_checkpoint_restores_placed(tp_checkpoints):
    """``restore(shardings=StateLayout)`` gives every leaf as a DTensor,
    each rank's blocks those of ``reshard_state`` on the whole, and the
    params gather back to the whole; ``shardings=state_shardings`` the
    reference's parts of every leaf."""
    _, _, res = tp_checkpoints
    for r in res:
        rest = r["restored"]
        assert rest["bitwise"]
        placed = rest["placed"]
        assert placed["dtensors"] > 0 and placed["is_reshard_state"]
        assert placed["gathers_whole"]


def _straight(tmp):
    """The (1, 2) straight run's whole params, losses from step SAVE_AT."""
    want = np.load(tmp / "straight_rank0.npz")
    keys = [k[len("params/"):] for k in want.files if k.startswith("params/")]
    return {k: want["params/" + k] for k in keys}


def test_a_model_axis_checkpoint_resumes_on_one_device(tp_checkpoints, tmp_path,
                                                       monkeypatch):
    tmp, init, res = tp_checkpoints
    ckpt = tmp_path / "ckpt"
    shutil.copytree(tmp / "saved", ckpt)
    tree = _tree(np.load(init))
    cfg = _port_cfg(QWEN)
    monkeypatch.setattr(launch_train, "init_params",
                        lambda cfg, gen: models.params_from_jax(cfg, tree, gen.device))
    monkeypatch.setattr(launch_train, "AdamWConfig", lambda **_: AdamWConfig(**OCFG))
    st = launch_train.train_loop(cfg, device="cpu", ckpt_dir=str(ckpt),
                                 save_every=RESUME["steps"], log_every=100, **RESUME)
    assert st["step"] == RESUME["steps"] and len(st["losses"]) == RESUME["steps"] - SAVE_AT
    np.testing.assert_allclose(st["losses"], res[0]["runs"]["straight"]["losses"][SAVE_AT:],
                               rtol=LOSS_RTOL)
    want = _straight(tmp)
    for k, t in zip(*flatten(st["params"])):
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=WEIGHT_ATOL, err_msg=k)


def test_a_model_axis_checkpoint_resumes_on_two_data_ranks(tp_checkpoints, tmp_path):
    """The (1, 2) checkpoint resumed by ZeRO-1 over (2, 1)."""
    tmp, init, res = tp_checkpoints
    ckpt = tmp_path / "ckpt"
    shutil.copytree(tmp / "saved", ckpt)
    spec = {"arch": QWEN, "reduced": {}, "init": str(init), "shape": [2, 1],
            "axes": ["data", "model"], "out": str(tmp_path),
            "loops": {"resumed": dict(RESUME, opt=OCFG, ckpt_dir=str(ckpt),
                                      save_every=RESUME["steps"])}}
    out = run_ranks(TRAIN_RANK, 2, tmp_path, json.dumps(spec))
    for r in out:
        run = r["runs"]["resumed"]
        assert run["step"] == RESUME["steps"]
        np.testing.assert_allclose(run["losses"],
                                   res[0]["runs"]["straight"]["losses"][SAVE_AT:],
                                   rtol=LOSS_RTOL)
    got = np.load(tmp_path / "resumed_rank0.npz")
    for k, w in _straight(tmp).items():
        np.testing.assert_allclose(got["params/" + k], w, rtol=0, atol=WEIGHT_ATOL,
                                   err_msg=k)
