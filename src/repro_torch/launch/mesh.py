"""Device meshes over a torch.distributed world.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (torch's
counterpart of ``jax.sharding.Mesh``), built by ``init_device_mesh`` with
the reference's axis names: ``("data", "model")``, or ``("pod", "data",
"model")`` across pods.

A torch.distributed program is SPMD: every rank runs the same program and
builds the same mesh.  The constructors never start a process group, on
import or on a call: the rank program starts it (torchrun's environment,
or its own ``init_process_group``), and without one they raise.  A mesh
lies on the card (``device_type="cuda"``) unless the caller asks for
``"cpu"``; on the card a rank takes ``cuda:{local_rank % device_count()}``
(``LOCAL_RANK`` as torchrun sets it, else the global rank).

A rank program ends its world with ``destroy_world()`` (in a ``finally:``
after its last collective), not with ``destroy_process_group`` alone: a
``DeviceMesh`` holds the ``ProcessGroup`` objects of its dims, so a mesh
still referenced when the groups are destroyed keeps them, and gloo's
threads, alive until the interpreter finalizes.  A gloo thread that then
runs into the finalizing interpreter aborts the rank ("terminate called
without an active exception", exit -6), after its work is done and only
now and then, under the load of a whole test run.

``fake_world(n)`` is the dry run's world: one process that is rank 0 of
``n`` over torch's fake process group, whose collectives move nothing and
return at once, so that a mesh of the production size can be built and a
partitioned step run over it (on fake tensors) without the ranks.  It is a
context manager that ends with ``destroy_world()``: no group outlives it.
"""
from __future__ import annotations

import contextlib
import gc
import math
import os
import weakref

__all__ = ["make_production_mesh", "make_local_mesh", "compat_make_mesh",
           "destroy_world", "fake_world"]

# every mesh the constructors built, by id (a DeviceMesh compares equal to
# another of the same layout, so a WeakSet would keep only one of them)
_MESHES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _world_size() -> int:
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no default process group: start one in the rank program "
            "(torchrun, or torch.distributed.init_process_group) before "
            "building a mesh")
    return dist.get_world_size()


def _take_device(device_type: str) -> None:
    import torch
    import torch.distributed as dist
    if device_type == "cpu":
        return
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a 'cuda' mesh needs the card; "
                           "pass device_type='cpu' to build a mesh of CPU ranks")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    torch.cuda.set_device(local % torch.cuda.device_count())


def compat_make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the world (the reference's ``jax.make_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world = _world_size()
    n = math.prod(shape)
    if world < n:
        raise RuntimeError(f"need {n} ranks for a {shape} mesh, have {world}")
    _take_device(device_type)
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    _MESHES[id(mesh)] = mesh
    return mesh


def destroy_world() -> None:
    """End this rank's torch.distributed world: every mesh built here lets
    go of its groups (torch keeps them in the mesh's ``_pg_registry``, and
    a submesh in its root's), the groups are destroyed, and what held them
    is collected, so that their threads are joined before this returns,
    whoever still holds a mesh (a group taken from a mesh and still held
    stays alive: drop it first).  A mesh is unusable after it.  Without a
    world it does nothing."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return
    for mesh in list(_MESHES.values()):
        for m in (mesh, getattr(mesh, "_root_mesh", None)):
            registry = getattr(m, "_pg_registry", None)
            if registry is not None:
                registry.clear()
    _MESHES.clear()
    dist.destroy_process_group()
    gc.collect()


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake world of ``world_size`` ranks, for
    the body of the ``with``; the world is destroyed on the way out, also
    when the body raises.  Raises if a world is already up."""
    import torch.distributed as dist
    # torch registers the "fake" backend in this module of its own
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("a process group is already up: a fake world "
                           "needs the process to itself")
    dist.init_process_group("fake", rank=0, world_size=int(world_size),
                            store=dist.HashStore())
    try:
        yield
    finally:
        destroy_world()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks single-pod; 2x16x16 = 512 ranks across two pods,
    on the cards unless ``device_type="cpu"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over the world's first data x model ranks
    (tests, one host)."""
    return compat_make_mesh((data, model), ("data", "model"), device_type)
