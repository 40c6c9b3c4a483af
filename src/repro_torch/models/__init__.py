from .convert import opt_state_from_jax, params_from_jax
from .model import (Model, cast_params, decode_step, forward, init_cache,
                    init_params, prefill)

__all__ = ["Model", "cast_params", "decode_step", "forward", "init_cache",
           "init_params", "opt_state_from_jax", "params_from_jax", "prefill"]
