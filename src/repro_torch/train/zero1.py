"""ZeRO-1 data parallelism over a ``DeviceMesh``: the port's counterpart of
the reference's train step jitted over a mesh, its params placed by
``param_specs`` and its optimizer state by ``opt_specs``.

A torch program is SPMD: every rank of the mesh runs the same step on its
block of the global batch (``batch_specs``: contiguous rows over the data
axes), holds the whole parameters (at model = 1 ``param_specs`` cuts
nothing), and holds the master, m and v of its part only (``opt_specs``'
ZeRO-1 "data" axis, put on the port's tree by ``state_shardings``: whole
layers where the reference cuts the stacked L axis, a block of a dim of the
leaf's reference view elsewhere).  A step:

  1. the forward and backward on the rank's rows (``make_grad_fn``);
  2. the sync: the gradients in float32, one row a "data" rank holding
     that rank's parts, all-reduced (sum) over the data axes; each rank
     keeps its own row, divided by the data ranks; the loss, ce and aux
     all-reduced alike.  gloo's reduce-scatter of the same rows, which
     moves half the bytes, took longer than its all-reduce on two ranks
     sharing an H100's host (``PERF.md``, ``chip_smoke.py``'s lm_train_dp);
  3. the clip's norm: the sums of squares of the ranks' parts, all-reduced
     over "data" (a leaf every rank holds counted once);
  4. AdamW on the rank's part (``adamw_apply`` with that norm);
  5. the gather: each rank's new parameter parts, one buffer a dtype,
     all-gathered over "data" as bytes and written into whole parameters.

A mesh whose device type is not the tensors' (gloo ranks of a "cpu" mesh
training on the card, since NCCL refuses two ranks on one card) stages
every collective through host copies: ``transport`` "host"; on a mesh of
the tensors' own device type it is "direct".

It trains a dense model at model = 1.  A "model" axis of more than one
rank (tensor and expert parallel) and an MoE model over more than one data
rank train by the partitioned step (``train.partitioned``), which
``train_loop`` takes there.
"""
from __future__ import annotations

import math
import time

import torch

from ..models.model import param_shapes
from ..sharding import Own, axis_sizes, batch_specs, data_axes, named, state_shardings
from ..tree import leaves, unflatten
from .optimizer import AdamWConfig, adamw_apply
from .train_step import make_grad_fn

__all__ = ["Zero1", "Zero1Checkpoints"]

class Zero1:
    """A mesh's data-parallel step and state for ``cfg`` on ``device``
    (this rank's).  ``coord`` is this rank's coordinate in the mesh, one
    index a mesh dim; the rank at every coordinate 0 is the ``writer``;
    ``at`` the train state's placements (``state_shardings``);
    ``members`` the coordinates of the "data" ranks, in their group's
    order, and ``part_shapes`` the shape of each one's part of each leaf."""

    def __init__(self, cfg, mesh, device):
        import torch.distributed as dist
        from .partitioned import partitioned
        if partitioned(cfg, mesh):
            raise ValueError(f"ZeRO-1 trains a dense model at model 1, not {cfg.name} "
                             f"on {dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
                             "that is train.partitioned's")
        sizes = axis_sizes(mesh)
        self.n_data = math.prod(sizes[a] for a in data_axes(mesh))
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh: it has no part in "
                             "the mesh's training")
        self.cfg, self.mesh, self.device = cfg, mesh, torch.device(device)
        self.coord = tuple(coord)
        self.writer = not any(self.coord)
        self.transport = "direct" if mesh.device_type == self.device.type else "host"
        self.at = state_shardings(cfg, mesh)
        self._opt_at = leaves(self.at["opt"]["master"])
        self.shapes = [tuple(t.shape) for t in leaves(param_shapes(cfg))]
        self.sync_axes = [a for a in data_axes(mesh) if sizes[a] > 1]
        self.group, self.members = None, [self.coord]
        if sizes.get("data", 1) > 1:
            self.group = mesh.get_group("data")
            d = list(mesh.mesh_dim_names).index("data")
            self.members = [self.coord[:d] + (i,) + self.coord[d + 1:]
                            for i in range(sizes["data"])]
            if dist.get_process_group_ranks(self.group) != [
                    int(mesh.mesh[m]) for m in self.members]:
                raise RuntimeError("the mesh's 'data' group is not in the order "
                                   "of its coordinates")
        self.index = self.members.index(self.coord)
        metas = [torch.empty(sh, device="meta") for sh in self.shapes]
        self.part_shapes = [[tuple(s.local(t, m).shape) for s, t in zip(self._opt_at, metas)]
                            for m in self.members]
        self._numels = [sum(math.prod(sh) for sh in shapes) for shapes in self.part_shapes]
        # a leaf every "data" rank holds whole counts in the norm on the first only
        from torch.distributed.tensor import Shard
        d = list(sizes).index("data") if "data" in sizes else None
        self._shared = [d is None or not isinstance(s.placements[d], (Shard, Own))
                        for s in self._opt_at]
        self.last_sync, self.stages = {}, {}

    def describe(self) -> str:
        return (f"mesh={dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))} "
                f"layout=tp zero1 step=zero1 transport={self.transport}")

    def init(self, params) -> tuple:
        return params, self.init_opt(params)

    def batch(self, b: dict) -> dict:
        """This rank's rows of the global batch, on its device."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.local_batch(b).items()}

    # ------------------------------------------------------------ layout
    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (numpy or tensors), by
        ``batch_specs``."""
        at = named(self.mesh, batch_specs(batch, self.mesh))
        return {k: v[at[k].local_slices(v.shape, self.coord)] for k, v in batch.items()}

    def parts(self, tensors: list, coord=None) -> list:
        """The parts of whole leaves (the parameters' order) that the rank
        at ``coord`` (default this one) holds: views."""
        return [s.local(t, coord or self.coord) for s, t in zip(self._opt_at, tensors)]

    def init_opt(self, params) -> dict:
        """AdamW's state of this rank's part: masters (float32 copies of the
        params' parts), m and v (float32 zeros), and step 0."""
        parts = self.parts(leaves(params))
        zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
        return {"master": unflatten(params, [zeros(t).copy_(t) for t in parts]),
                "m": unflatten(params, [zeros(t) for t in parts]),
                "v": unflatten(params, [zeros(t) for t in parts]),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    # ------------------------------------------------------- collectives
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_mesh(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.transport == "host" else t

    def _rows(self, tensors: list, dtype) -> torch.Tensor:
        """(members, width): row i the parts of ``tensors`` (whole leaves)
        that member i holds, flattened in ``dtype``, zero padded."""
        rows = torch.zeros((len(self.members), max(self._numels)), dtype=dtype,
                           device=self.device)
        for row, m in zip(rows, self.members):
            off = 0
            for part in self.parts(tensors, m):
                n = part.numel()
                row[off:off + n].view(part.shape).copy_(part)
                off += n
        return rows

    def reduce_mean(self, grads: list, trio: torch.Tensor):
        """This rank's parts of the gradients (``grads``: whole leaves)
        summed over the data axes and divided by the data ranks, as a
        float32 buffer; ``trio`` (loss, ce, aux) the same; and the squared
        norm of the whole mean gradient.  ``stages`` holds the seconds of
        the copy to the mesh's device, the collectives and the copy back of
        this rank's row."""
        import torch.distributed as dist
        rows = self._rows(grads, torch.float32)
        k = self._numels[self.index]
        self._sync()
        t0 = time.perf_counter()
        trio = trio.to(torch.float32)
        if self.sync_axes:
            rows, trio = self._to_mesh(rows), self._to_mesh(trio)
        t1 = time.perf_counter()
        for a in self.sync_axes:
            g = self.mesh.get_group(a)
            dist.all_reduce(rows, group=g)
            dist.all_reduce(trio, group=g)
        t2 = time.perf_counter()
        own = rows[self.index, :k].to(self.device).div_(self.n_data)
        self._sync()
        t3 = time.perf_counter()
        sq, off = torch.zeros((), dtype=torch.float32, device=self.device), 0
        for shape, shared in zip(self.part_shapes[self.index], self._shared):
            n = math.prod(shape)
            if not shared or self.index == 0:
                sq = sq + own[off:off + n].square().sum()
            off += n
        if self.group is not None:
            sq = self._to_mesh(sq)
            dist.all_reduce(sq, group=self.group)
        self.stages = {"to_mesh_s": t1 - t0, "collective_s": t2 - t1,
                       "back_s": t3 - t2}
        return own, trio.to(self.device) / self.n_data, sq.to(self.device)

    def assemble(self, parts: list) -> list:
        """Whole tensors (the parameters' shapes) from every data rank's
        ``parts`` (this rank's part of each leaf, in any dtype), one
        all-gather of bytes a dtype."""
        import torch.distributed as dist
        if self.group is None:
            return [p.reshape(sh) for p, sh in zip(parts, self.shapes)]
        out = [torch.empty(sh, dtype=p.dtype, device=self.device)
               for sh, p in zip(self.shapes, parts)]
        for dt in dict.fromkeys(p.dtype for p in parts):
            idx = [j for j, p in enumerate(parts) if p.dtype == dt]
            width = max(sum(math.prod(shapes[j]) for j in idx) for shapes in self.part_shapes)
            send = torch.zeros(width, dtype=dt, device=self.device)
            off = 0
            for j in idx:
                n = parts[j].numel()
                send[off:off + n].view(parts[j].shape).copy_(parts[j])
                off += n
            send = self._to_mesh(send.view(torch.uint8))
            recv = torch.empty(len(self.members) * send.numel(), dtype=torch.uint8,
                               device=send.device)
            dist.all_gather_into_tensor(recv, send, group=self.group)
            recv = recv.to(self.device).view(dt).view(len(self.members), width)
            for row, m, shapes in zip(recv, self.members, self.part_shapes):
                off = 0
                for j in idx:
                    n = math.prod(shapes[j])
                    if n:
                        self._opt_at[j].local(out[j], m).copy_(
                            row[off:off + n].view(shapes[j]))
                    off += n
        return out

    def full_opt(self, opt: dict) -> dict:
        """The whole optimizer state, gathered from every data rank's part
        (a collective: every rank of the mesh calls it)."""
        out = {k: unflatten(opt[k], self.assemble(leaves(opt[k])))
               for k in ("master", "m", "v")}
        out["step"] = opt["step"]
        return out

    def barrier(self) -> None:
        import torch.distributed as dist
        for a in self.sync_axes:
            dist.barrier(group=self.mesh.get_group(a))

    # -------------------------------------------------------------- step
    def make_step(self, ocfg: AdamWConfig, attn_impl: str = "torch",
                  num_microbatches: int = 1):
        """train_step(params, opt_state, local_batch) -> (params, opt,
        metrics), ``make_train_step``'s over the mesh: the metrics are the
        global ones, equal on every rank; ``last_sync`` holds the step's
        sync and gather seconds and bytes."""
        grad_fn = make_grad_fn(self.cfg, attn_impl, num_microbatches)

        def train_step(params, opt_state, batch):
            loss, grads, met = grad_fn(params, batch)
            self._sync()
            t0 = time.perf_counter()
            own, (loss, ce, aux), sq = self.reduce_mean(
                leaves(grads), torch.stack([loss, met["ce"], met["aux"]]))
            sync_s = time.perf_counter() - t0
            del grads
            synced, off = [], 0
            for shape in self.part_shapes[self.index]:
                n = math.prod(shape)
                synced.append(own[off:off + n].view(shape))
                off += n
            part = lambda ts: unflatten(params, ts)  # noqa: E731
            new_part, opt_state, opt_met = adamw_apply(
                ocfg, part(synced), opt_state, part(self.parts(leaves(params))),
                gnorm=torch.sqrt(sq))
            del own, synced
            t0 = time.perf_counter()
            new = self.assemble(leaves(new_part))
            self._sync()
            moved = self.group is not None
            self.last_sync = {
                "transport": self.transport, "sync_s": sync_s, **self.stages,
                "gather_s": time.perf_counter() - t0,
                "sync_bytes": (4 * len(self.members) * max(self._numels)
                               if self.n_data > 1 else 0),
                "gather_bytes": sum(t.numel() * t.element_size() for t in new) if moved else 0}
            return unflatten(params, new), opt_state, {
                "loss": loss, "ce": ce, "aux": aux, **opt_met}

        return train_step


class Zero1Checkpoints:
    """A ``CheckpointManager`` for a ZeRO-1 state: ``save`` gathers the
    whole optimizer state (a collective, every rank calls it) and the
    ``writer`` rank writes the whole tree as host 0 does, the reference's
    single-controller picture; ``restore`` gives each rank its part of it
    (``shardings=``), on a mesh of any number of ranks; ``wait`` joins the
    writer's save and then every rank, so that none reads the directory
    before the save it waits for is committed."""

    def __init__(self, mgr, zero: Zero1):
        self.mgr, self.zero = mgr, zero

    def save(self, step: int, state: dict) -> None:
        whole = {"params": state["params"], "opt": self.zero.full_opt(state["opt"]),
                 "step": state["step"]}
        if self.zero.writer:
            self.mgr.save(step, whole)

    def wait(self) -> None:
        if self.zero.writer:
            self.mgr.wait()
        self.zero.barrier()

    def latest_step(self):
        return self.mgr.latest_step()

    def restore(self, step: int, template: dict) -> dict:
        return self.mgr.restore(step, template, shardings=self.zero.at)

