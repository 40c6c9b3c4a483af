"""The dry run (repro_torch.launch.dryrun, repro_torch.sharding.dtensor)
against the reference's on the CPU.

The cells' inputs (``input_specs``) and microbatch policy are the
reference's for every pair; a cell's per-rank argument bytes are the
reference's compiled ``memory_analysis().argument_size_in_bytes`` (a child
process that forces four host devices for the reference and runs the port's
fake world of four ranks); the pure-DP layout's per-rank FLOPs are the
one-rank program's split evenly; the ZeRO-1 step's collectives move the
bytes the specs imply; and the partitioned step on two real gloo ranks,
tensor- or data-parallel, gives the one-device step's loss (within 1e-5),
gradients and updated parameters (within 1e-4), float32.  Every fake
world here is torn down by ``fake_world`` (or lives in a child process).
"""
import ast
import json
import math
import subprocess
import sys

import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import compat_make_mesh, fake_world  # noqa: E402

from torch_ranks import ROOT, rank_env, run_ranks  # noqa: E402

PAIRS = [(a, s) for a in configs.ARCHS for s in configs.SHAPES]
CHILD_TIMEOUT_S = 240


def _reference_auto_microbatches():
    """The reference's ``auto_microbatches``, taken from its source: its
    module forces 512 host devices on import, which a test process must not
    take on."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "auto_microbatches")
    scope: dict = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), scope)
    return scope["auto_microbatches"]


# ---------------------------------------------------------------- the cells
def test_every_arch_and_shape_is_a_cell():
    assert len(PAIRS) == 40
    assert [(a, s) for a, s, _ in configs.runnable_cells()] == PAIRS


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_are_the_reference_s(arch, shape):
    want = ref_configs.input_specs(ref_configs.get_arch(arch), shape)
    got = configs.input_specs(configs.get_arch(arch), shape)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].is_meta
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[-1] == jnp.dtype(w.dtype).name, k


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_auto_microbatches_are_the_reference_s(arch):
    ref = _reference_auto_microbatches()
    cfg = configs.get_arch(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        B = configs.get_shape(shape)["global_batch"]
        for dp in (1, 16, 32, 256, 512):
            assert dryrun.auto_microbatches(cfg, B, dp) == ref(cfg, B, dp), (shape, dp)


# ------------------------------------------------- against the reference's
_ARG_BYTES = r'''
import json, sys
arch, shape = sys.argv[1], sys.argv[2]
from repro.launch import dryrun as ref          # forces the host devices
from repro.launch.mesh import make_local_mesh
mesh = make_local_mesh(2, 2)
_, compiled = ref.lower_cell(mesh, arch, shape, n_layers_override=1, microbatches=1)
want = compiled.memory_analysis().argument_size_in_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import compat_make_mesh, fake_world
with fake_world(4):
    m = compat_make_mesh((2, 2), ("data", "model"), device_type="cpu")
    _, low = dryrun.lower_cell(m, arch, shape, n_layers_override=1, microbatches=1)
print(json.dumps({"want": int(want), "got": low.argument_bytes}))
'''


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_argument_bytes_per_rank_are_the_reference_s_compile(shape):
    """qwen2-0.5b cut to one layer on a (2, 2) mesh: the bytes a rank holds
    of the placed state and batch (params, AdamW's masters, m and v and
    step, or the KV cache; the batch) are those of the reference's
    compiled program's arguments (less, for decode, the reference's int32
    cache position, which the port's cache keeps as a Python int)."""
    out = subprocess.run([sys.executable, "-c", _ARG_BYTES, "qwen2-0.5b", shape],
                         cwd=ROOT, env=rank_env(), capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    pos = 4 if shape.startswith("decode") else 0
    assert rec["got"] == rec["want"] - pos > 0


def _lower(shape, mesh_shape, **kw):
    with fake_world(math.prod(mesh_shape)):
        mesh = compat_make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
        cfg, low = dryrun.lower_cell(mesh, "qwen2-0.5b", shape, n_layers_override=1,
                                     microbatches=1, **kw)
        from repro_torch.sharding.dtensor import state_layout
        lay = state_layout(cfg, mesh, "train", layout=kw.get("layout", "tp"))
        return cfg, dryrun.analyze(low), lay


def test_the_dp_layout_splits_the_flops_evenly():
    """layout="dp" on a (2, 2) mesh (the batch over all four ranks, the
    weights whole): a rank's FLOPs times the ranks are the one-rank
    program's."""
    _, one, _ = _lower("train_4k", (1, 1), layout="dp")
    _, four, _ = _lower("train_4k", (2, 2), layout="dp")
    assert one["flops"] > 0 and not one["collectives"]["total"]
    assert four["flops"] * 4 == one["flops"]
    assert four["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]


def test_zero1_collectives_move_the_bytes_the_specs_imply():
    """A (2, 1) mesh, ZeRO-1: each gradient a rank's block of which the
    optimizer holds is reduce-scattered onto it (the result, that block, in
    the parameter's dtype), the others all-reduced whole, and each such
    parameter all-gathered back whole; beyond those, only scalars (the
    loss, its metrics and the clip's norm) are all-reduced."""
    from torch.distributed.tensor import Shard
    _, rec, lay = _lower("train_4k", (2, 1))
    want = {"reduce-scatter": 0, "all-gather": 0, "all-reduce": 0}
    for key in lay.opt_keys:
        (i,) = lay.opt_members[key]
        n = math.prod(lay.port_shapes[i]) * torch.empty((), dtype=lay.dtypes[i]).element_size()
        cut = [p for p in lay.opt_at[key] if isinstance(p, Shard)]
        if cut:
            want["reduce-scatter"] += n // 2
            want["all-gather"] += n
        else:
            want["all-reduce"] += n
    coll = rec["collectives"]
    assert want["reduce-scatter"] > 0, want
    assert coll["reduce-scatter"] == want["reduce-scatter"], (coll, want)
    assert coll["all-gather"] == want["all-gather"]
    assert 0 <= coll["all-reduce"] - want["all-reduce"] <= 64
    assert set(coll) == {"reduce-scatter", "all-gather", "all-reduce", "total"}


@pytest.mark.parametrize("arch,layers", [("qwen2-0.5b", 2), ("qwen3-moe-235b-a22b", 1)])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_the_dry_run_takes_a_one_row_batch(arch, layers, mesh_shape):
    """A global batch of one row (64 tokens) on a mesh whose data axis is 1:
    ``batch_specs`` cuts it over "data" (1 divides 1), which places as
    ``Replicate()``, so that DTensor's view rules propagate; the step runs
    and a rank holds less at (1, 2) than at (1, 1)."""
    recs = {}
    for shape in {(1, 1), mesh_shape}:
        with fake_world(math.prod(shape)):
            mesh = compat_make_mesh(shape, ("data", "model"), device_type="cpu")
            _, low = dryrun.lower_cell(mesh, arch, "train_4k", n_layers_override=layers,
                                       batch_override=(1, 64), microbatches=1)
            recs[shape] = dryrun.analyze(low)
    rec = recs[mesh_shape]
    assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    if mesh_shape == (1, 2):
        assert rec["collectives"]["total"] > 0
        assert rec["memory"]["argument_bytes"] < recs[(1, 1)]["memory"]["argument_bytes"]
    else:
        assert rec["collectives"]["total"] == 0


# ------------------------------------------------------------ real ranks
_PARTITIONED = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
data, model = int(sys.argv[4]), int(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
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
    cfg = dataclasses.replace(reduced_config(get_arch("qwen2-0.5b")), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 32)).astype(np.int32))
             for k in ("tokens", "targets")}
    ocfg = AdamWConfig(warmup_steps=1)
    loss, grads, _ = make_grad_fn(cfg)(params, batch)
    new, _, _ = make_train_step(cfg, ocfg)(params, adamw_init(params), batch)
    mesh = make_local_mesh(data, model, device_type="cpu")
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
            "views": sum(v is not None for v in lay.views),
            "cut": sorted({repr(pl) for t in leaves(p) for pl in t.placements})}
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
'''


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)], ids=["tp", "dp"])
def test_the_partitioned_step_on_gloo_ranks_is_the_one_device_step(tmp_path, data, model):
    """Reduced qwen2 in float32 on two gloo ranks: at (1, 2) the heads, the
    FFN and the vocab are cut over "model" (the single KV head's hd too,
    held in its head view), at (2, 1) the batch and the ZeRO-1 state over
    "data" (some of it cut in hd, so held in the head view too).  Every rank's loss is the one-device step's within 1e-5, and the
    gradients and the updated parameters, gathered, within 1e-4."""
    outs = run_ranks(_PARTITIONED, 2, tmp_path, str(data), str(model))
    for out in outs:
        assert abs(out["ploss"] - out["loss"]) <= 1e-5 * abs(out["loss"])
        assert abs(out["step_loss"] - out["loss"]) <= 1e-5 * abs(out["loss"])
        assert out["grad_err"] <= 1e-4
        assert out["param_err"] <= 1e-4 < out["moved"]
        assert any("Shard" in c for c in out["cut"]) == (model > 1)
        assert out["views"] > 0
