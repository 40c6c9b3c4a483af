"""End-to-end training driver.

Wires the substrates together: config -> mesh -> params and ZeRO-1
optimizer shards -> step-indexed data -> train step -> async checkpoints
-> crash-only supervision.  Runs on the card unless ``--device cpu`` is
given (without a card and without it, it raises), e.g.:

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50
  python -m repro_torch.launch.train --arch qwen2-0.5b --reduced --steps 50 --device cpu

``train_loop(mesh=None)`` trains on one device.  Over a ``DeviceMesh`` it
is a rank program (SPMD: every rank of the mesh calls it alike) that trains
data parallel with ZeRO-1 (``train.zero1``): each rank takes its rows of
every batch, the gradients are averaged over the data ranks before the
clip, each rank updates its part of AdamW's state and the parameters are
gathered back; losses and grad norms are the global ones.  A "model" axis
of more than one rank and an MoE model over more than one data rank raise
``NotImplementedError`` (a later slice).  ``--production-mesh`` trains over
``make_production_mesh()``: it joins torchrun's world (or starts a world of
this one process) and raises unless the world has its 256 ranks.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.configs import get_arch, reduced_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.serve import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime.fault_tolerance import supervise
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train.zero1 import Zero1, Zero1Checkpoints
from repro_torch.tree import leaves

__all__ = ["train_loop", "main"]


def train_loop(cfg, *, steps: int, batch: int, seq_len: int, mesh=None,
               ckpt_dir: str | None = None, save_every: int = 50,
               microbatches: int = 1, log_every: int = 10, seed: int = 0,
               resume: bool = True, fail_at: int | None = None,
               device: str | None = None) -> dict:
    """Returns final {"params", "opt", "step", "losses", "grad_norms",
    "step_s", "sync"}: a loss, a grad norm, the host seconds and (over a
    mesh) the sync's seconds and bytes of every step run (a replayed step
    again).  ``device`` None is the card, raising without one; the params
    are drawn from ``torch.Generator(device)`` seeded with ``seed``, alike
    on every rank.  ``mesh``: None (one device) or a ``DeviceMesh`` this
    rank is in; over a mesh ``opt`` holds this rank's ZeRO-1 part, a
    checkpoint the whole state (written by the mesh's first rank) and
    resuming restores each rank's part of it, from a run over any number
    of ranks."""
    device = resolve_device(device)
    zero = Zero1(cfg, mesh, device) if mesh is not None else None
    ocfg = AdamWConfig(total_steps=steps)
    stream = TokenStream(cfg.vocab, batch, seq_len, seed=seed,
                         n_codebooks=cfg.n_codebooks)

    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    opt = adamw_init(params) if zero is None else zero.init_opt(params)
    n_params = sum(t.numel() for t in leaves(params))
    where = "" if zero is None else (
        f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} zero1 "
        f"transport={zero.transport}")
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"batch={batch} seq={seq_len} steps={steps} device={device}{where}")
    if zero is None:
        step_fn = make_train_step(cfg, ocfg, num_microbatches=microbatches)
    else:
        step_fn = zero.make_step(ocfg, num_microbatches=microbatches)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and zero is not None:
        mgr = Zero1Checkpoints(mgr, zero)
    state = {"params": params, "opt": opt, "step": 0}
    if mgr and resume:
        last = mgr.latest_step()
        if last is not None:
            state = mgr.restore(last, state)
            state["step"] = int(state["step"])
            print(f"[train] resumed from step {last}")

    losses: list[float] = []
    grad_norms: list[float] = []
    step_s: list[float] = []
    sync: list[dict] = []
    injected = {"done": False}

    def run_step(step: int, state: dict) -> dict:
        if fail_at is not None and step == fail_at and not injected["done"]:
            injected["done"] = True   # fail once; replay must succeed
            raise RuntimeError("injected failure (test)")
        t0 = time.perf_counter()
        b = stream.batch_at(step)
        if zero is not None:
            b = zero.local_batch(b)
        b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        p, o, m = step_fn(state["params"], state["opt"], b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])   # waits for the step
        step_s.append(time.perf_counter() - t0)
        if zero is not None:
            sync.append(zero.last_sync)
        losses.append(loss)
        grad_norms.append(gnorm)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorm:.3f} ({step_s[-1]:.1f}s)")
        return {"params": p, "opt": o, "step": step}

    if mgr:
        state = supervise(run_step, state, steps=steps, ckpt_mgr=mgr,
                          save_every=save_every)
    else:
        for s in range(state["step"], steps):
            state = run_step(s, state)
            state["step"] = s + 1
    state.update(losses=losses, grad_norms=grad_norms, step_s=step_s, sync=sync)
    return state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, raising without one")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        n_heads=max(args.d_model // 64, 4),
                        n_kv_heads=max(args.d_model // 128, 2),
                        d_ff=args.d_model * 3 if cfg.d_ff else 0)
        if args.layers:
            over["n_layers"] = args.layers
        if args.vocab:
            over["vocab"] = args.vocab
        cfg = reduced_config(cfg, **over)
    mesh, started = None, False
    if args.production_mesh:
        started = _join_world(args.device)
    try:
        if args.production_mesh:
            from repro_torch.launch.mesh import make_production_mesh
            mesh = make_production_mesh(
                device_type="cpu" if args.device == "cpu" else "cuda")
        state = train_loop(cfg, steps=args.steps, batch=args.batch,
                           seq_len=args.seq, mesh=mesh, ckpt_dir=args.ckpt_dir,
                           save_every=args.save_every,
                           microbatches=args.microbatches, seed=args.seed,
                           device=args.device)
    finally:
        if started:
            from repro_torch.launch.mesh import destroy_world
            destroy_world()
    ls = state["losses"]
    if ls:
        k = max(len(ls) // 10, 1)
        print(f"[train] loss first-{k}-mean {np.mean(ls[:k]):.4f} -> "
              f"last-{k}-mean {np.mean(ls[-k:]):.4f}")


def _join_world(device: str | None) -> bool:
    """Start this process's torch.distributed world unless one is running:
    torchrun's (its environment variables) if it set them, else a world of
    this one process.  gloo on the CPU, NCCL on the cards.  Returns whether
    it started one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "gloo" if device == "cpu" else "nccl"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_world_"), "store")
        dist.init_process_group(backend, init_method="file://" + store,
                                world_size=1, rank=0)
    return True


if __name__ == "__main__":
    main()
