"""Elastic re-meshing: shrink/grow the mesh around failed hosts.

``plan_mesh``: given the healthy rank count and a model-parallel size that
must be preserved (TP degree is baked into layouts/divisibility), pick the
largest (data, model) grid that fits — data parallelism absorbs the loss.
``reshard_state``: each rank's part of a whole state tree on the new mesh
(restore and reshard are the same placement; see
``CheckpointManager.restore(shardings=)``), in the form its trainer holds
it: ZeRO-1's parts (a dense model at model 1), or the state placed as
DTensors for the partitioned step (``train.partitioned``).

The mesh is a torch ``DeviceMesh`` over the world's first data × model
ranks; a rank past them has no coordinate in it (SPMD: every rank of the
world calls ``plan_mesh``).  The placements are ``repro_torch.sharding``'s
``state_shardings``: the reference's ``param_specs`` and ``opt_specs`` put
on the port's tree.
"""
from __future__ import annotations

from ..sharding import state_shardings
from ..tree import tree_map

__all__ = ["plan_mesh", "reshard_state"]


def plan_mesh(n_healthy: int, model_size: int, axis_names=("data", "model"),
              device_type: str = "cuda"):
    """Largest (data, model_size) mesh with data * model_size <= n_healthy."""
    if n_healthy < model_size:
        raise RuntimeError(
            f"cannot keep TP={model_size} with only {n_healthy} devices")
    from ..launch.mesh import compat_make_mesh
    data = n_healthy // model_size
    return compat_make_mesh((data, model_size), axis_names, device_type)


def reshard_state(state: dict, cfg, new_mesh) -> dict:
    """Re-place {params, opt} onto a new mesh after an elastic resize: this
    rank's part of each whole leaf (views), as ``state_shardings`` places
    it, or, where ``train_loop`` trains ``cfg`` on ``new_mesh`` by the
    partitioned step, the state placed as its DTensors (``opt`` whole, as
    ``adamw_init`` makes it).  ``cfg`` stands where the reference takes the
    params' shapes."""
    from ..train.partitioned import partitioned
    if partitioned(cfg, new_mesh):
        from ..sharding.dtensor import StateLayout
        return StateLayout(cfg, new_mesh).place_state(state)
    at = state_shardings(cfg, new_mesh)
    out = dict(state)
    out["params"] = tree_map(lambda t, s: s.local(t), state["params"], at["params"])
    if "opt" in state:
        out["opt"] = dict(state["opt"])
        for k in ("master", "m", "v"):
            out["opt"][k] = tree_map(lambda t, s: s.local(t), state["opt"][k],
                                     at["opt"][k])
    return out
