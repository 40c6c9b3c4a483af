"""Sharding rules (``rules``) and the mesh the spec logic runs on without
ranks.  The reference's other shims (``compat_get_abstract_mesh``,
``compat_set_mesh``, ``compat_shard_map``) paper over jax versions and have
no counterpart: a torch program passes its ``DeviceMesh`` to whatever uses
it (ROADMAP.md)."""
from .rules import (AbstractMesh, NamedSharding, Own, P, axis_sizes,
                    batch_specs, cache_specs, data_axes, named, opt_specs,
                    param_specs, port_shardings, reference_shapes,
                    state_shardings)

__all__ = ["batch_specs", "cache_specs", "data_axes", "named", "opt_specs",
           "param_specs", "compat_abstract_mesh", "AbstractMesh",
           "NamedSharding", "Own", "P", "axis_sizes", "port_shardings",
           "reference_shapes", "state_shardings"]


def compat_abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    """Axis names and sizes without ranks (the reference's
    ``AbstractMesh``), for the spec logic at any mesh size."""
    return AbstractMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))
