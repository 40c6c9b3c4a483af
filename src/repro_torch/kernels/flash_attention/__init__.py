from . import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
