"""Launch layer: ``serve`` (``python -m repro_torch.launch.serve``), the LM
serving entry point; ``train`` (``python -m repro_torch.launch.train``), the
LM trainer; ``serve_coresets``, the coreset server; ``mesh``, the device
meshes.  The mesh constructors load on first use, so that importing
the package leaves ``torch.distributed`` alone."""

__all__ = ["make_local_mesh", "make_production_mesh"]


def __getattr__(name):
    if name in __all__:
        from . import mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
