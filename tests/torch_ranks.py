"""Ranks of a torch.distributed program as child processes of a test.

Each rank is ``python -c PROGRAM WORLD RANK STORE *ARGS``, in a session of
its own, over a ``file://`` store in the test's temporary directory (no
port to collide between xdist workers); every rank is killed with its
process group when the run fails or times out.  No process group is ever
started in the pytest process.  A rank prints one JSON object as the last
line of its standard output."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 180.0


def rank_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_TORCH_OPS_BACKEND")}
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def run_ranks(program: str, world: int, tmp: Path, *args: str,
              timeout: float = RANK_TIMEOUT_S) -> list[dict]:
    """``world`` ranks of ``program``; each rank's JSON, asserting that
    every rank exited 0."""
    store = tmp / f"store_{world}_{os.urandom(4).hex()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", program, str(world), str(r), str(store), *args],
        cwd=ROOT, env=rank_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.communicate(timeout=timeout)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{err}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


# A rank of the trainer: the reduced float32 ``spec["arch"]`` (``reduced``
# overrides), its weights the reference's (``spec["init"]``, an npz of the
# reference's init_params leaves by path) carried across, trained by
# ``train_loop`` over a CPU mesh (``shape``/``axes``, or ``plan``:
# ``plan_mesh(n_healthy, model_size)``) once a ``loops`` entry (train_loop's
# arguments, and under "opt" the AdamWConfig that train_loop builds in that
# run, put in its place as the weights are).  A rank in
# the mesh writes each run's params and its ZeRO-1 master parts to
# ``{out}/{run}_rank{rank}.npz``; with ``restore`` ({"dir", "step"}) it
# also restores that checkpoint whole and with ``shardings=``, and reports
# whether each part is its placement's slice of the whole, bitwise.
TRAIN_RANK = r'''
import dataclasses, hashlib, json, sys
import numpy as np
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import destroy_world
try:
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import params_from_jax
    from repro_torch.runtime import plan_mesh
    from repro_torch.train import AdamWConfig
    from repro_torch.tree import flatten
    cfg = dataclasses.replace(reduced_config(get_arch(spec["arch"]), **spec["reduced"]),
                              dtype="float32")
    init = np.load(spec["init"])
    tree = {}
    for key in init.files:
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = init[key]
    launch_train.init_params = lambda cfg, gen: params_from_jax(cfg, tree, gen.device)
    if spec.get("plan"):
        mesh = plan_mesh(*spec["plan"], device_type="cpu")
    else:
        mesh = compat_make_mesh(spec["shape"], spec["axes"], device_type="cpu")
    out = {"coord": mesh.get_coordinate(), "shape": list(mesh.shape), "runs": {}}
    for name, loop in (spec["loops"].items() if out["coord"] is not None else ()):
        loop = dict(loop)
        opt = loop.pop("opt")
        launch_train.AdamWConfig = lambda **_: AdamWConfig(**opt)
        st = launch_train.train_loop(cfg, mesh=mesh, device="cpu", log_every=100, **loop)
        keys, ps = flatten(st["params"])
        mkeys, ms = flatten(st["opt"]["master"])
        np.savez(f"{spec['out']}/{name}_rank{rank}.npz",
                 **{"params/" + k: v.numpy() for k, v in zip(keys, ps)},
                 **{"master/" + k: v.numpy() for k, v in zip(mkeys, ms)})
        out["runs"][name] = {
            "losses": st["losses"], "grad_norms": st["grad_norms"], "step": st["step"],
            "sync": st["sync"], "opt_step": int(st["opt"]["step"]),
            "digest": hashlib.sha256(b"".join(p.numpy().tobytes() for p in ps)).hexdigest()}
    if spec.get("restore") and out["coord"] is not None:
        # restore(shardings=) against the whole checkpoint, leaf by leaf
        import torch
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.sharding import state_shardings
        params = launch_train.init_params(cfg, torch.Generator())
        from repro_torch.train import adamw_init
        template = {"params": params, "opt": adamw_init(params), "step": 0}
        mgr = CheckpointManager(spec["restore"]["dir"])
        whole = mgr.restore(spec["restore"]["step"], template)
        at = state_shardings(cfg, mesh)
        part = mgr.restore(spec["restore"]["step"], template, shardings=at)
        _, w = flatten(whole)
        _, p = flatten(part)
        _, a = flatten(at)
        same = lambda x, y: (torch.equal(x, y) if isinstance(x, torch.Tensor)  # noqa: E731
                             else np.array_equal(x, y))
        out["restored"] = {
            "bitwise": all(same(pi, wi if ai is None else ai.local(wi))
                           for pi, wi, ai in zip(p, w, a)),
            "elements": sum(t.numel() for t in flatten(part["opt"])[1]),
            "whole_elements": sum(t.numel() for t in flatten(whole["opt"])[1])}
    out["bad"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
'''
