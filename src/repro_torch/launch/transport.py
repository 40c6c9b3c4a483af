"""The collectives of gloo ranks whose tensors lie on the card.

NCCL refuses two ranks on one card, so ranks that share a card are gloo
processes.  ``BACKEND`` is a process-group backend for both the "cpu" and
the "cuda" device: a Python ``ProcessGroup`` (torch's
``multi_threaded_pg`` is one that DTensor runs on) over a gloo group of the
same ranks.  A collective on CPU tensors goes straight to gloo.  One on CUDA
tensors is staged: its inputs are copied to the host, gloo runs the
collective there, and the results are copied back into the CUDA outputs.
Nothing is computed on the host but gloo's own reductions, and a collective
that fails raises (its ``Work`` is waited on before the copy back).

Start a world on it with ``start_world``, then build the mesh with
``device_type="cuda"`` (``launch.mesh.compat_make_mesh``): DTensor's
collectives, the explicit ones of the partitioned ops and ``dist.*`` calls
on the mesh's groups all reach this group.  Every collective is counted in
this process, by kind (the dry run's names: "all-reduce", "all-gather",
"reduce-scatter", "all-to-all", and "broadcast" and "barrier"): calls, the
bytes of its result (as the dry run counts them), and the seconds of the
copy to the host, the collective and the copy back (``stats``,
``reset_stats``).  Every call is synchronous: the ``Work`` it returns is
complete.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as c10d

__all__ = ["BACKEND", "register", "start_world", "stats", "reset_stats",
           "HostStagedGroup"]

BACKEND = "gloo_host"
_STAGES = ("to_host_s", "collective_s", "back_s")
_STATS: dict[str, dict] = {}


def reset_stats() -> None:
    _STATS.clear()


def stats() -> dict:
    """Kind -> {"calls", "bytes", "to_host_s", "collective_s", "back_s"}
    since the last ``reset_stats``, over every group of this process."""
    return {k: dict(v) for k, v in _STATS.items()}


def _record(kind: str, nbytes: int, stages) -> None:
    s = _STATS.setdefault(kind, {"calls": 0, "bytes": 0, **dict.fromkeys(_STAGES, 0.0)})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    for k, v in zip(_STAGES, stages):
        s[k] += v


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _done(result):
    fut = torch.futures.Future()
    fut.set_result(result)
    return c10d._create_work_from_future(fut)


def _sync(ts) -> None:
    if any(t.is_cuda for t in ts):
        torch.cuda.synchronize()


class HostStagedGroup(dist.ProcessGroup):
    """A process group of ``size`` ranks whose collectives run on a gloo
    group of the same ranks (made on ``store`` under its own prefix), CUDA
    tensors staged through host copies.  Implements the collectives that
    torch's functional collectives, DTensor and ``torch.distributed``'s
    calls reach, under their names in torch 2.11 to 2.13."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(dist.PrefixStore("staged/", store), rank,
                                           size, timeout)
        self._name, self._desc = "", ""

    def getBackendName(self) -> str:
        return BACKEND

    # a ProcessGroup keeps its name and description in its backends, which
    # a Python one has none of
    def setGroupName(self, name: str) -> None:
        self._name = name

    def getGroupName(self) -> str:
        return self._name

    def setGroupDesc(self, desc: str) -> None:
        self._desc = desc

    def getGroupDesc(self) -> str:
        return self._desc

    _set_group_name = setGroupName
    _set_group_desc = setGroupDesc
    group_name = property(getGroupName)
    group_desc = property(getGroupDesc)

    # ---------------------------------------------------------- staging
    def _staged(self, kind: str, reads: list, writes: list, run, counted: list):
        """Runs ``run(host_reads, host_writes)`` (a gloo call returning a
        ``Work``) on host copies of ``reads`` and host buffers for
        ``writes`` (a CUDA tensor's copy, a CPU tensor itself; ``reads``
        and ``writes`` may share tensors), then copies the results back
        into ``writes``.  ``counted``: the tensors whose bytes the call
        counts."""
        _sync(reads + writes)
        t0 = time.perf_counter()
        host: dict[int, torch.Tensor] = {}

        def on_host(t, copy):
            if not t.is_cuda:
                return t
            if id(t) not in host:
                host[id(t)] = (t.detach().contiguous().cpu() if copy else
                               torch.empty(t.shape, dtype=t.dtype))
            return host[id(t)]
        h_reads = [on_host(t, True) for t in reads]
        h_writes = [on_host(t, False) for t in writes]
        t1 = time.perf_counter()
        run(h_reads, h_writes).wait()
        t2 = time.perf_counter()
        for t, h in zip(writes, h_writes):
            if h is not t:
                t.copy_(h)
        _sync(writes)
        _record(kind, _nbytes(counted), (t1 - t0, t2 - t1, time.perf_counter() - t2))

    # ------------------------------------------------------- all-reduce
    def allreduce(self, tensors, opts=None):
        opts = opts or c10d.AllreduceOptions()
        self._staged("all-reduce", list(tensors), list(tensors),
                     lambda r, w: self._gloo.allreduce(w, opts), list(tensors))
        return _done(list(tensors))

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            o = c10d.AllreduceOptions()
            if opts is not None:
                o.reduceOp = opts.reduceOp
            self.allreduce([t], o)
        return _done(list(tensors))

    # ------------------------------------------------------- all-gather
    def _allgather_base(self, output, input, opts=None):
        opts = opts or c10d.AllgatherOptions()
        self._staged("all-gather", [input], [output],
                     lambda r, w: self._gloo._allgather_base(w[0], r[0], opts), [output])
        return _done([output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i)
        return _done(list(outputs))

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def allgather(self, output_lists, inputs, opts=None):
        opts = opts or c10d.AllgatherOptions()
        for outs, i in zip(output_lists, inputs):
            self._staged("all-gather", [i], list(outs),
                         lambda r, w: self._gloo.allgather([w], r, opts), list(outs))
        return _done(output_lists)

    # --------------------------------------------------- reduce-scatter
    def _reduce_scatter_base(self, output, input, opts=None):
        opts = opts or c10d.ReduceScatterOptions()
        self._staged("reduce-scatter", [input], [output],
                     lambda r, w: self._gloo._reduce_scatter_base(w[0], r[0], opts),
                     [output])
        return _done([output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            ro = c10d.ReduceScatterOptions()
            if opts is not None:
                ro.reduceOp = opts.reduceOp
            self._reduce_scatter_base(o, i, ro)
        return _done(list(outputs))

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    # ------------------------------------------------------- all-to-all
    def alltoall_base(self, output, input, output_split_sizes, input_split_sizes,
                      opts=None):
        opts = opts or c10d.AllToAllOptions()
        self._staged("all-to-all", [input], [output],
                     lambda r, w: self._gloo.alltoall_base(
                         w[0], r[0], list(output_split_sizes), list(input_split_sizes),
                         opts), [output])
        return _done([output])

    all_to_all_single = alltoall_base

    # ------------------------------------------------------------ others
    def broadcast(self, tensors, opts=None):
        opts = opts or c10d.BroadcastOptions()
        self._staged("broadcast", list(tensors), list(tensors),
                     lambda r, w: self._gloo.broadcast(w, opts), list(tensors))
        return _done(list(tensors))

    def barrier(self, opts=None):
        t0 = time.perf_counter()
        self._gloo.barrier(c10d.BarrierOptions()).wait()
        _record("barrier", 0, (0.0, time.perf_counter() - t0, 0.0))
        return _done([])


def _create(store, rank, size, timeout):
    return HostStagedGroup(store, rank, size, timeout)


def register() -> None:
    """Registers ``BACKEND`` (once a process) for the "cpu" and "cuda"
    devices."""
    if BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(BACKEND, _create, devices=["cpu", "cuda"])


def start_world(init_method: str, world_size: int, rank: int) -> None:
    """Starts this rank's world on ``BACKEND``; end it with
    ``launch.mesh.destroy_world()``."""
    register()
    dist.init_process_group(BACKEND, init_method=init_method,
                            world_size=world_size, rank=rank)
