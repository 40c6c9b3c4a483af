from .convert import params_from_jax
from .model import (Model, cast_params, decode_step, forward, init_cache,
                    init_params, prefill)

__all__ = ["Model", "cast_params", "decode_step", "forward", "init_cache",
           "init_params", "params_from_jax", "prefill"]
