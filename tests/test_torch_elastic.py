"""repro_torch.runtime.elastic and CheckpointManager.restore(shardings=) on
the CPU, over gloo ranks that are child processes of the test
(``torch_ranks``): ``plan_mesh`` and ``reshard_state`` on 1–3 ranks, and a
checkpoint written by two ZeRO-1 ranks restored onto one and onto three,
whose next step is within 1e-5 (loss) and 1e-4 (weights) of the two ranks'
uninterrupted run."""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from torch_ranks import TRAIN_RANK, run_ranks  # noqa: E402

ARCH = "qwen2-0.5b"
REDUCED = dict(n_layers=4)
# a batch of 6 rows splits over 1, 2 and 3 data ranks; the optimizer moves
# the weights past the bar (test_torch_train.py's)
LOOP = dict(batch=6, seq_len=16, opt=dict(lr=1e-3, warmup_steps=2, total_steps=10))
LOSS_RTOL, WEIGHT_ATOL = 1e-5, 1e-4


def _init_npz(path):
    import dataclasses
    cfg = dataclasses.replace(
        ref_configs.reduced_config(ref_configs.ARCHS[ARCH], **REDUCED), dtype="float32")
    flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_models.init_params(cfg, jax.random.PRNGKey(0)))
    np.savez(path, **{"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in flat})
    return str(path)


_PLAN_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import destroy_world
try:
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models import init_params
    from repro_torch.runtime import plan_mesh, reshard_state
    from repro_torch.sharding import state_shardings
    from repro_torch.train import adamw_init
    from repro_torch.tree import flatten
    out = {}
    for n, model in ((0, 1), (world, 2)):
        try:
            plan_mesh(n, model, device_type="cpu")
            out[f"plan_{n}_{model}"] = "planned"
        except RuntimeError as exc:
            out[f"plan_{n}_{model}"] = str(exc)
    mesh = plan_mesh(world, 1, device_type="cpu")
    out["shape"], out["names"] = list(mesh.shape), list(mesh.mesh_dim_names)
    out["coord"] = mesh.get_coordinate()
    cfg = reduced_config(get_arch("qwen2-0.5b"), n_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    state = {"params": params, "opt": adamw_init(params), "step": 0}
    placed = reshard_state(state, cfg, mesh)
    at = state_shardings(cfg, mesh)
    keys, whole = flatten(state["opt"]["master"])
    _, part = flatten(placed["opt"]["master"])
    _, named = flatten(at["opt"]["master"])
    out["views"] = all(p.data_ptr() == n.local(w).data_ptr() or p.numel() == 0
                       for p, w, n in zip(part, whole, named))
    out["params_whole"] = all(a.data_ptr() == b.data_ptr() and a.shape == b.shape
                              for a, b in zip(flatten(placed["params"])[1],
                                              flatten(params)[1]))
    out["slices"] = {k: [[s.start, s.stop] for s in n.local_slices(w.shape)]
                     for k, w, n in zip(keys, whole, named)}
    out["shapes"] = {k: list(n.view_of(w.shape)) for k, w, n in zip(keys, whole, named)}
    out["step_kept"] = placed["step"] == 0 and placed["opt"]["step"] is state["opt"]["step"]
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
"""


@pytest.mark.parametrize("world", [1, 2, 3])
def test_plan_mesh_and_reshard_state_on_ranks(tmp_path, world):
    """A (world, 1) mesh; fewer ranks than the model axis raise the
    reference's error; each rank's ZeRO-1 parts are views of the whole
    state, and over the ranks every leaf is either cut once (four layers
    over 2 ranks) or, where nothing divides (3 ranks), whole on each."""
    res = run_ranks(_PLAN_RANK, world, tmp_path)
    for r, out in enumerate(res):
        assert out["shape"] == [world, 1] and out["names"] == ["data", "model"]
        assert out["coord"] == [r, 0]
        assert out["plan_0_1"] == "cannot keep TP=1 with only 0 devices"
        assert out["plan_%d_2" % world] == (
            "planned" if world >= 2 else "cannot keep TP=2 with only 1 devices")
        assert out["views"] and out["params_whole"] and out["step_kept"]
    cut = 0
    for key, shape in res[0]["shapes"].items():
        count = np.zeros(shape, dtype=np.int64)
        for out in res:
            count[tuple(slice(a, b) for a, b in out["slices"][key])] += 1
        assert (count == 1).all() or (count == world).all(), key
        cut += bool((count == 1).all()) and world > 1
    assert cut == (len(res[0]["shapes"]) if world == 2 else 0)


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """Two ZeRO-1 ranks: 2 steps saving at step 2, and 3 steps straight."""
    tmp = tmp_path_factory.mktemp("two")
    spec = {"arch": ARCH, "reduced": REDUCED, "init": _init_npz(tmp / "init.npz"),
            "shape": [2, 1], "axes": ["data", "model"], "out": str(tmp),
            "loops": {"ckpt": dict(LOOP, steps=2, ckpt_dir=str(tmp / "ckpt"), save_every=2),
                      "straight": dict(LOOP, steps=3)}}
    res = run_ranks(TRAIN_RANK, 2, tmp, json.dumps(spec))
    return tmp, spec, res, np.load(tmp / "straight_rank0.npz")


@pytest.mark.parametrize("world", [1, 3])
def test_a_two_rank_checkpoint_restores_onto_one_and_three_ranks(tmp_path, two_rank_run,
                                                                 world):
    """The checkpoint of step 2, written whole by the first of two ranks,
    restored through plan_mesh(world, 1) and restore(shardings=): each
    rank's part bitwise its placement's slice of the whole, and step 3
    trained from it within the bars of the two ranks' straight run."""
    src, spec, two, straight = two_rank_run
    assert sorted(p.name for p in (src / "ckpt").iterdir()) == ["latest", "step_00000002"]
    assert [r["runs"]["ckpt"]["losses"] for r in two] == [
        two[0]["runs"]["straight"]["losses"][:2]] * 2
    ckpt = tmp_path / "ckpt"
    shutil.copytree(src / "ckpt", ckpt)
    spec = dict(spec, plan=[world, 1], out=str(tmp_path),
                loops={"resumed": dict(LOOP, steps=3, ckpt_dir=str(ckpt), save_every=3)},
                restore={"dir": str(ckpt), "step": 2})
    res = run_ranks(TRAIN_RANK, world, tmp_path, json.dumps(spec))
    want = two[0]["runs"]["straight"]
    for out in res:
        assert out["bad"] == [] and out["shape"] == [world, 1]
        assert out["restored"]["bitwise"]
        run = out["runs"]["resumed"]
        assert run["step"] == run["opt_step"] == 3 and len(run["losses"]) == 1
        assert run["losses"] == res[0]["runs"]["resumed"]["losses"]
        assert run["digest"] == res[0]["runs"]["resumed"]["digest"]
        np.testing.assert_allclose(run["losses"], want["losses"][2:], rtol=LOSS_RTOL)
    parts = sum(out["restored"]["elements"] for out in res)
    assert parts == res[0]["restored"]["whole_elements"] * (world if world == 3 else 1)
    got = np.load(tmp_path / "resumed_rank0.npz")
    for key in straight.files:
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], straight[key], rtol=0, atol=WEIGHT_ATOL,
                                       err_msg=key)
    assert (ckpt / "latest").read_text() == "3"
