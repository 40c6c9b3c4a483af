"""End-to-end training driver.

Wires the substrates together: config -> params and optimizer on one
device -> step-indexed data -> train step -> async checkpoints ->
crash-only supervision.  Runs on the card unless ``--device cpu`` is given
(without a card and without it, it raises), e.g.:

  python -m repro_torch.launch.train --arch qwen2-0.5b --steps 50
  python -m repro_torch.launch.train --arch qwen2-0.5b --reduced --steps 50 --device cpu

One device only: a mesh of more than one rank and ``--production-mesh``
(data parallel, ZeRO-1 optimizer shards) wait for the port's sharding
slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
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
from repro_torch.tree import leaves

__all__ = ["train_loop", "main"]

_SHARDING_SLICE = ("comes with the port's sharding slice (sharding/rules.py, "
                   "ROADMAP.md queue 1 item 5); the trainer runs on one device")


def train_loop(cfg, *, steps: int, batch: int, seq_len: int, mesh=None,
               ckpt_dir: str | None = None, save_every: int = 50,
               microbatches: int = 1, log_every: int = 10, seed: int = 0,
               resume: bool = True, fail_at: int | None = None,
               device: str | None = None) -> dict:
    """Returns final {"params", "opt", "step", "losses", "grad_norms",
    "step_s"}: a loss, a grad norm and the host seconds of every step run
    (a replayed step again).  ``device`` None is the card, raising without
    one; the params are drawn from ``torch.Generator(device)`` seeded with
    ``seed``.  ``mesh``: None or a one-rank ``DeviceMesh``."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(f"training over a mesh of {mesh.size()} "
                                  f"ranks {_SHARDING_SLICE}")
    device = resolve_device(device)
    ocfg = AdamWConfig(total_steps=steps)
    stream = TokenStream(cfg.vocab, batch, seq_len, seed=seed,
                         n_codebooks=cfg.n_codebooks)

    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    opt = adamw_init(params)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"batch={batch} seq={seq_len} steps={steps} device={device}")
    step_fn = make_train_step(cfg, ocfg, num_microbatches=microbatches)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
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
    injected = {"done": False}

    def run_step(step: int, state: dict) -> dict:
        if fail_at is not None and step == fail_at and not injected["done"]:
            injected["done"] = True   # fail once; replay must succeed
            raise RuntimeError("injected failure (test)")
        t0 = time.perf_counter()
        b = {k: torch.as_tensor(v, device=device)
             for k, v in stream.batch_at(step).items()}
        p, o, m = step_fn(state["params"], state["opt"], b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])   # waits for the step
        step_s.append(time.perf_counter() - t0)
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
    state.update(losses=losses, grad_norms=grad_norms, step_s=step_s)
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

    if args.production_mesh:
        raise NotImplementedError(f"--production-mesh {_SHARDING_SLICE}")
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
    state = train_loop(cfg, steps=args.steps, batch=args.batch,
                       seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                       save_every=args.save_every,
                       microbatches=args.microbatches, seed=args.seed,
                       device=args.device)
    ls = state["losses"]
    if ls:
        k = max(len(ls) // 10, 1)
        print(f"[train] loss first-{k}-mean {np.mean(ls[:k]):.4f} -> "
              f"last-{k}-mean {np.mean(ls[-k:]):.4f}")


if __name__ == "__main__":
    main()
