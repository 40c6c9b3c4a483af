"""The partitioned train step over a ``DeviceMesh`` for ``train_loop``:
the reference's step jitted over any mesh, its params placed by
``param_specs`` and its optimizer by ``opt_specs`` (layout "tp", ZeRO-1),
here ``sharding.dtensor.partitioned_train_step`` on a ``StateLayout``.

It trains where ``train.zero1`` does not: a "model" axis of more than one
rank (heads, FFN, vocab and experts cut over "model") and an MoE model over
more than one data rank (its dispatch groups from the mesh).  Every rank
places the same whole state and the same global batch and keeps its blocks;
DTensor issues the step's collectives.  Over ``launch.transport``'s group
(gloo ranks sharing a card) each collective is counted, and a step's
``last_sync`` holds their calls, bytes and seconds by kind.

Checkpoints are the one-device format: the mesh's first rank writes the
whole state, gathered from every rank, and a resume places it on any mesh.
"""
from __future__ import annotations

import math

import torch

from ..sharding import axis_sizes, data_axes
from ..sharding.dtensor import StateLayout, distribute_batch, partitioned_train_step
from ..tree import unflatten
from .optimizer import adamw_init

__all__ = ["partitioned", "Partitioned", "PartitionedCheckpoints"]


def partitioned(cfg, mesh) -> bool:
    """Whether ``train_loop`` trains ``cfg`` on ``mesh`` by the partitioned
    step: a "model" axis above 1, or an MoE model over more than one data
    rank (a dense model at model 1 trains by ``train.zero1``)."""
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in data_axes(mesh))
    return sizes.get("model", 1) > 1 or (cfg.is_moe and n_data > 1)


class Partitioned:
    """``cfg``'s partitioned step and state on ``mesh`` (this rank's
    device ``device``).  ``lay`` is the state's ``StateLayout``; the rank
    at every coordinate 0 is the ``writer``; ``transport`` the backend of
    the mesh's groups."""

    layout = "tp"

    def __init__(self, cfg, mesh, device):
        import torch.distributed as dist
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh: it has no part in "
                             "the mesh's training")
        self.cfg, self.mesh, self.device = cfg, mesh, torch.device(device)
        self.writer = not any(coord)
        self.lay = StateLayout(cfg, mesh, layout=self.layout)
        self.transport = str(dist.get_backend(mesh.get_group(0)))
        self.last_sync: dict = {}

    def describe(self) -> str:
        return (f"mesh={dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))} "
                f"layout={self.layout} zero1 step=partitioned "
                f"transport={self.transport}")

    # ------------------------------------------------------------ state
    def init(self, params) -> tuple:
        """Whole ``params`` (alike on every rank) placed, and AdamW's state
        of them placed."""
        return self.lay.params(params), self.lay.opt_state(adamw_init(params))

    def batch(self, b: dict) -> dict:
        """The global batch (numpy, alike on every rank) on the device,
        placed by ``batch_specs``: each rank keeps its rows."""
        return distribute_batch({k: torch.as_tensor(v, device=self.device)
                                 for k, v in b.items()}, self.mesh)

    def whole(self, state: dict) -> dict:
        """The train state gathered whole in the one-device format (a
        collective: every rank of the mesh calls it)."""
        return {"params": self.lay.whole_params(state["params"]),
                "opt": self.lay.whole_opt(state["opt"]), "step": state["step"]}

    def template(self) -> dict:
        """A one-device train state of host tensors to restore into."""
        ls = [torch.empty(s, dtype=d) for s, d in zip(self.lay.port_shapes, self.lay.dtypes)]
        params = unflatten(self.lay.template, ls)
        f32 = lambda: unflatten(self.lay.template, [  # noqa: E731
            torch.empty(s, dtype=torch.float32) for s in self.lay.port_shapes])
        return {"params": params, "opt": {"master": f32(), "m": f32(), "v": f32(),
                                          "step": torch.zeros((), dtype=torch.int32)},
                "step": 0}

    def barrier(self) -> None:
        import torch.distributed as dist
        for i, n in enumerate(self.mesh.shape):
            if n > 1:
                dist.barrier(group=self.mesh.get_group(i))

    # ------------------------------------------------------------- step
    def make_step(self, ocfg, attn_impl: str = "torch", num_microbatches: int = 1):
        """train_step(params, opt_state, placed_batch) -> (params, opt,
        metrics): the metrics this rank's (replicated) local tensors, the
        global ones; ``last_sync`` the step's collectives."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        from ..launch import transport
        inner = partitioned_train_step(self.cfg, ocfg, self.lay, attn_impl,
                                       num_microbatches)

        def train_step(params, opt, batch):
            transport.reset_stats()
            with implicit_replication():
                params, opt, met = inner(params, opt, batch)
            met = {k: v.to_local() if isinstance(v, DTensor) else v
                   for k, v in met.items()}
            by_kind = transport.stats()
            stages = {k: sum(v[k] for v in by_kind.values())
                      for k in ("to_host_s", "collective_s", "back_s")}
            self.last_sync = {
                "transport": self.transport, "by_kind": by_kind, **stages,
                "sync_s": sum(stages.values()),
                "sync_bytes": sum(v["bytes"] for v in by_kind.values())}
            return params, opt, met

        return train_step


class PartitionedCheckpoints:
    """A ``CheckpointManager`` for a placed state: ``save`` gathers the
    whole state (every rank calls it) and the ``writer`` writes it in the
    one-device format; ``restore`` reads the whole and places it (each rank
    keeps its blocks), from a run over any mesh; ``wait`` joins the
    writer's save and then every rank of the mesh."""

    def __init__(self, mgr, part: Partitioned):
        self.mgr, self.part = mgr, part

    def save(self, step: int, state: dict) -> None:
        whole = self.part.whole(state)
        if self.part.writer:
            self.mgr.save(step, whole)

    def wait(self) -> None:
        if self.part.writer:
            self.mgr.wait()
        self.part.barrier()

    def latest_step(self):
        return self.mgr.latest_step()

    def restore(self, step: int, template=None) -> dict:
        return self.mgr.restore(step, self.part.template(), shardings=self.part.lay)
