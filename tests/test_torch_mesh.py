"""The port's mesh half (repro_torch.launch.mesh, core.sharded's
``sat_pjit`` and ``fitting_loss_batched(mesh=...)``, ``CoresetEngine(mesh=
...)``) against the reference's.

Every mesh runs in ranks that are child processes of the test, each in a
session of its own with its own timeout, killed with its process group when
it fails: ``gloo`` over a ``file://`` store in the test's temporary
directory (no port to collide between workers), a CPU mesh.  No process
group is ever started in the pytest process.  The ranks import only
``repro_torch`` and assert that neither ``jax`` nor ``repro`` was loaded;
the test computes the reference's values with JAX on the CPU.

Bars: the scorer within 1e-4 relative of the reference's one-device
``fitting_loss_batched`` (the batched-against-dense gate) and within rtol
2e-3 / atol 1e-3 of the numpy oracle (the reference's own mesh test); the
integral images within rtol 5e-4 / atol 5e-3 of the reference's float32
``sat_pjit`` (tests/test_kernels.py), and against the port's one-device
plain float32 scan bitwise on one rank.  On more ranks a band's scan starts
from the float32 row above it where the one-device scan (torch's CPU
cumsum, which sums float32 in float64) carries it unrounded, so each band
may differ by the rounding of that row: at most 2^-22 of a channel's
largest value (one rounding of the carry and one of the result, with room)."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.core import fitting_loss as ref_fitting_loss  # noqa: E402
from repro.core import sharded as ref_sharded  # noqa: E402
from repro.core import signal_coreset as ref_signal_coreset  # noqa: E402
from repro.service import CoresetEngine as RefEngine  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import random_tree_segmentation, sat_pjit  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.kernels.sat2d.ref import sat_moments_ref  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120.0
# the scorer's signal, coreset and trees (the reference mesh test's shapes)
N, M, K, EPS, LEAVES, T = 48, 40, 5, 0.3, 4, 3
# B < ranks: this signal's coreset has 2 blocks
SMALL = (8, 8, 2)
# the integral images: 50 x 40, and n = 2 rows on 3 ranks (an empty band)
SAT_SHAPES = {"50x40": (50, 40), "2x40": (2, 40)}
SAT_RTOL, SAT_ATOL = 5e-4, 5e-3
SAT_BAND_SCALED = 2.0 ** -22

_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

world, rank, store, inputs = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                              sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import destroy_world
try:
    from repro_torch import obs, ops
    from repro_torch.core import sat_pjit, signal_coreset
    from repro_torch.core.sharded import fitting_loss_batched
    from repro_torch.kernels.fitting_loss.ops import fitting_loss_batched as kernel
    from repro_torch.launch.mesh import (compat_make_mesh, make_local_mesh,
                                         make_production_mesh)
    from repro_torch.service import CoresetEngine

    d = np.load(inputs)
    samples = []
    obs.profile.add_hook(lambda op, b, size, dt: samples.append([op, b]))
    out = {}

    def score(mesh, y, k):
        with ops.backend_override("numpy"):
            cs = signal_coreset(y, k, float(d["eps"]))
        return {"fingerprint": cs.fingerprint(), "blocks": int(cs.num_blocks),
                "losses": fitting_loss_batched(cs, d["rects"], d["labels"],
                                               mesh=mesh).tolist()}

    def sat(mesh, y):
        images = sat_pjit(y, mesh=mesh)
        return {"placements": [[type(p).__name__, getattr(p, "dim", None)]
                               for p in images.placements],
                "shape": list(images.shape),
                "local_rows": int(images.to_local().shape[1]),
                "full": images.full_tensor().numpy().tolist()}

    mesh = compat_make_mesh((world,), ("data",), device_type="cpu")
    out["scorer"] = score(mesh, d["y"], int(d["k"]))
    out["small"] = score(mesh, d["y_small"], int(d["k_small"]))
    out["sat"] = {key[4:]: sat(mesh, d[key]) for key in d.files
                  if key.startswith("sat_")}
    zero = torch.zeros((1, 4))
    out["padding_only"] = kernel(zero, zero, zero,
                                 torch.as_tensor(d["rects"], dtype=torch.float32),
                                 torch.as_tensor(d["labels"], dtype=torch.float32)
                                 ).tolist()
    if world == 2:
        grid = make_local_mesh(2, 1, device_type="cpu")
        out["grid"] = {"shape": list(grid.shape),
                       "names": list(grid.mesh_dim_names),
                       "scorer": score(grid, d["y"], int(d["k"])),
                       "sat": sat(grid, d["sat_50x40"])}
        try:
            fitting_loss_batched(None, d["rects"], d["labels"],
                                 mesh=compat_make_mesh((2,), ("model",),
                                                       device_type="cpu"))
        except ValueError as exc:
            out["no_data_axis"] = str(exc)
        engine = CoresetEngine(workers=1, mesh=grid)
        try:
            with ops.backend_override("numpy"):
                engine.register_signal("s", d["y"])
                r = engine.tree_loss_batch("s", d["rects"].astype(np.int64),
                                           d["labels"], eps=float(d["eps"]),
                                           k=int(d["k"]))
            root = obs.start_trace("probe")
            with obs.attach(root):
                engine.tree_loss_batch("s", d["rects"].astype(np.int64),
                                       d["labels"], eps=float(d["eps"]),
                                       k=int(d["k"]))
            root.end()
            doc = obs.TRACER.get(root.trace_id, wait_s=5.0)
            spans = {sp["name"]: sp for sp in doc["spans"]}
            counters = engine.metrics.snapshot()["counters"]
            out["engine"] = {
                "fingerprint": r["fingerprint"], "losses": r["losses"].tolist(),
                "backend": r["backend"], "fused": r["fused_batch_size"],
                "coalesce": spans["engine.tree_loss_batch"]["attrs"]["coalesce"],
                "counters": {key: v for key, v in counters.items()
                             if key.startswith(("loss_scoring", "ops_backend_",
                                                "query_fused"))}}
        finally:
            engine.close()
    if world == 1:
        out["local"] = {"shape": list(make_local_mesh(device_type="cpu").shape)}
        try:
            make_production_mesh()
        except RuntimeError as exc:
            out["production"] = str(exc)
    out["samples"] = samples
    out["bad"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
'''


def _trees(n, m, seed=0):
    rng = np.random.default_rng(seed)
    segs = [random_tree_segmentation(n, m, LEAVES, rng) for _ in range(T)]
    return (np.stack([s.rects for s in segs]).astype(np.float64),
            np.stack([s.labels for s in segs]))


def _inputs():
    rects, labels = _trees(N, M)
    sat = {f"sat_{key}": np.random.default_rng(3).normal(size=shape)
           for key, shape in SAT_SHAPES.items()}
    return dict(y=piecewise_signal(N, M, K, noise=0.2, seed=0), k=K, eps=EPS,
                y_small=piecewise_signal(*SMALL, noise=0.0, seed=0),
                k_small=SMALL[2], rects=rects, labels=labels, **sat)


def _kill(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=RANK_TIMEOUT_S)


def _run_ranks(world: int, tmp: Path) -> list[dict]:
    """``world`` ranks of ``_RANK`` on the inputs; each rank's JSON."""
    np.savez(tmp / "inputs.npz", **_inputs())
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", ops.ENV_VAR)}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp / "tune.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(world), str(r), str(tmp / "store"),
         str(tmp / "inputs.npz")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            _kill(p)
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{err}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's ranks, run once for the module's tests."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = _run_ranks(world, tmp_path_factory.mktemp(f"w{world}"))
        return runs[world]
    return get


@pytest.fixture(scope="module")
def reference():
    """The reference's coresets, one-device losses and oracle, float32
    integral images and engine, on the CPU."""
    d = _inputs()
    out = {}
    with ref_ops.backend_override("numpy"):
        for key, y, k in (("scorer", d["y"], K), ("small", d["y_small"], SMALL[2])):
            cs = ref_signal_coreset(y, k, EPS)
            out[key] = {
                "fingerprint": cs.fingerprint(),
                "losses": np.asarray(ref_sharded.fitting_loss_batched(
                    cs, d["rects"], d["labels"])),
                "oracle": np.array([ref_fitting_loss(cs, r, lab)
                                    for r, lab in zip(d["rects"], d["labels"])])}
        eng = RefEngine(workers=1)
        try:
            eng.register_signal("s", d["y"])
            r = eng.tree_loss_batch("s", d["rects"].astype(np.int64),
                                    d["labels"], eps=EPS, k=K, coalesce=False)
            out["engine"] = {"fingerprint": r["fingerprint"],
                             "losses": np.asarray(r["losses"])}
        finally:
            eng.close()
    out["sat"] = {key: (np.asarray(ref_sharded.sat_pjit(d[f"sat_{key}"])),
                        sat_moments_ref(torch.as_tensor(
                            d[f"sat_{key}"], dtype=torch.float32)).numpy())
                  for key in SAT_SHAPES}
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)


def _check_scorer(got, want):
    assert got["fingerprint"] == want["fingerprint"]
    losses = np.asarray(got["losses"])
    assert losses.shape == (T,) and np.isfinite(losses).all()
    assert _rel(losses, want["losses"]).max() <= 1e-4
    np.testing.assert_allclose(losses, want["oracle"], rtol=2e-3, atol=1e-3)


# --------------------------------------------------------------- the scorer
@pytest.mark.parametrize("world", [1, 2, 3])
def test_mesh_scorer_matches_the_reference_on_ranks(ranks, reference, world):
    outs = ranks(world)
    for out in outs:
        assert out["bad"] == []
        _check_scorer(out["scorer"], reference["scorer"])
        assert ["fitting_loss_batched", "torch+all_reduce"] in out["samples"]
    # every rank returns the whole result, the same one
    assert all(o["scorer"]["losses"] == outs[0]["scorer"]["losses"] for o in outs)


def test_mesh_scorer_with_fewer_blocks_than_ranks(ranks, reference):
    outs = ranks(3)
    assert outs[0]["small"]["blocks"] == 2
    for out in outs:
        _check_scorer(out["small"], reference["small"])
        # a slab of padding blocks only adds exactly nothing
        assert out["padding_only"] == [0.0] * T


def test_mesh_scorer_on_a_data_by_model_mesh(ranks, reference):
    outs = ranks(2)
    for out in outs:
        grid = out["grid"]
        assert grid["shape"] == [2, 1] and grid["names"] == ["data", "model"]
        _check_scorer(grid["scorer"], reference["scorer"])
        assert "no 'data' dimension" in out["no_data_axis"]


# ------------------------------------------------------- the integral images
def _check_sat(out, ref, world, key):
    want_ref, want_plain = ref
    n = SAT_SHAPES[key][0]
    rows = -(-n // world)
    got = np.asarray(out["full"], np.float32)
    assert out["shape"] == [3, *SAT_SHAPES[key]]
    np.testing.assert_allclose(got, want_ref, rtol=SAT_RTOL, atol=SAT_ATOL)
    if world == 1:
        assert np.array_equal(got, want_plain)
    else:
        scale = np.abs(want_plain).max(axis=(1, 2), keepdims=True)
        assert (np.abs(got - want_plain) / scale).max() <= SAT_BAND_SCALED
        # the first band has no carry: the one-device scan's own adds
        assert np.array_equal(got[:, :rows], want_plain[:, :rows])


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sat_pjit_matches_the_reference_on_ranks(ranks, reference, world):
    outs = ranks(world)
    n = SAT_SHAPES["50x40"][0]
    rows = -(-n // world)
    for r, out in enumerate(outs):
        sat = out["sat"]["50x40"]
        assert sat["placements"] == [["Shard", 1]]
        assert sat["local_rows"] == min(rows, n - r * rows)
        _check_sat(sat, reference["sat"]["50x40"], world, "50x40")


def test_sat_pjit_with_fewer_rows_than_ranks(ranks, reference):
    outs = ranks(3)
    assert [o["sat"]["2x40"]["local_rows"] for o in outs] == [1, 1, 0]
    for out in outs:
        _check_sat(out["sat"]["2x40"], reference["sat"]["2x40"], 3, "2x40")
    grid = ranks(2)[0]["grid"]["sat"]
    assert grid["placements"] == [["Shard", 1], ["Replicate", None]]
    _check_sat(grid, reference["sat"]["50x40"], 2, "50x40")


# ----------------------------------------------------------------- the engine
def test_mesh_engine_matches_the_reference_engine(ranks, reference):
    outs = ranks(2)
    want = reference["engine"]
    for out in outs:
        eng = out["engine"]
        assert eng["fingerprint"] == want["fingerprint"]
        assert _rel(eng["losses"], want["losses"]).max() <= 1e-4
        assert eng["backend"] == "torch+all_reduce" and eng["fused"] == T
        assert eng["coalesce"] is False
        assert eng["counters"] == {"loss_scoring_calls": 2,
                                   "ops_backend_torch+all_reduce": 2}


# ------------------------------------------------------------------ the meshes
def test_local_mesh_has_the_reference_shape_and_axes(ranks):
    from repro.launch.mesh import make_local_mesh as ref_make_local_mesh
    ref = ref_make_local_mesh()
    out = ranks(1)[0]
    assert out["local"]["shape"] == list(ref.devices.shape) == [1, 1]
    grid = ranks(2)[0]["grid"]
    assert tuple(grid["names"]) == ref.axis_names == ("data", "model")


def test_production_mesh_needs_its_ranks(ranks):
    msg = ranks(1)[0]["production"]
    assert "need 256 ranks" in msg and "have 1" in msg
    assert "XLA_FLAGS" not in msg


@pytest.mark.parametrize("make", [
    lambda: mesh_mod.make_local_mesh(device_type="cpu"),
    lambda: mesh_mod.make_production_mesh(),
    lambda: mesh_mod.compat_make_mesh((1,), ("data",), device_type="cpu")])
def test_mesh_constructors_start_no_process_group(make):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no default process group"):
        make()
    assert not dist.is_initialized()


def test_sat_pjit_without_a_mesh_is_one_device_s_scan(reference):
    # a tensor the caller put on the CPU takes the plain version; anything
    # else goes to the card, which this host has not
    for key in SAT_SHAPES:
        values = _inputs()[f"sat_{key}"]
        want_ref, want_plain = reference["sat"][key]
        got = sat_pjit(torch.as_tensor(values))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want_plain)
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=SAT_RTOL,
                                   atol=SAT_ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sat_pjit(values)


_TEARDOWN_RANK = r'''
import glob, json, sys
import torch
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]


def gloo_threads():
    names = []
    for path in glob.glob("/proc/self/task/*/comm"):
        try:
            names.append(open(path).read())
        except OSError:   # a thread that ended meanwhile
            pass
    return sum(n.startswith(("gloo", "pt_gloo")) for n in names)


dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import compat_make_mesh, destroy_world, make_local_mesh
try:
    grid = make_local_mesh(world, 1, device_type="cpu")
    line = compat_make_mesh((world,), ("pod",), device_type="cpu")
    x = torch.ones(3) * (rank + 1)
    dist.all_reduce(x, group=grid["data"].get_group())
    dist.all_reduce(x, group=line.get_group("pod"))
    before = gloo_threads()
finally:
    destroy_world()
print(json.dumps({"sum": x.tolist(), "before": before, "after": gloo_threads(),
                  "held": [grid.mesh_dim_names, line.mesh_dim_names],
                  "initialized": dist.is_initialized()}), flush=True)
'''


@pytest.mark.parametrize("world", [1, 2])
def test_destroy_world_joins_the_gloo_threads_while_meshes_are_held(tmp_path, world):
    """The rank holds a (data, model) mesh, a submesh of it and a 1-D mesh
    when it ends its world: no gloo thread may outlive ``destroy_world``
    (one left to the interpreter's exit aborts the rank now and then)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TEARDOWN_RANK, str(world), str(r), str(tmp_path / "store")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            _kill(p)
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{err}"
        res = json.loads(out.strip().splitlines()[-1])
        total = world * (world + 1) / 2
        assert res["sum"] == [total * world] * 3
        assert res["before"] > 0        # the probe sees gloo's threads
        assert res["after"] == 0
        assert res["held"] == [["data", "model"], ["pod"]]
        assert res["initialized"] is False
