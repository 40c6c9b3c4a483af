"""Carry the reference's parameters and optimizer state across:
``params_from_jax``, ``opt_state_from_jax``.

The reference's ``init_params`` tree, its leaves turned into numpy arrays
(``jax.tree.map(np.asarray, params)``), becomes the port's tree: the
stacked ``layers`` leaves are split along their leading L axis into one
dict per layer, and the ``(d, H, hd)`` projection weights and ``(H, hd)``
biases are flattened to the ``(d, H * hd)`` and ``(H * hd,)`` the port
stores.  Any tree of the parameters' structure maps the same way (a
gradient tree, AdamW's master, m and v), in a dtype given by the caller.
Takes numpy only, so the port never imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import torch_dtype

__all__ = ["params_from_jax", "opt_state_from_jax"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # a bfloat16 array comes as ml_dtypes' bfloat16, which torch.from_numpy
    # refuses; bfloat16 -> float32 -> bfloat16 is exact
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


def _linear(p: dict, dtype, device) -> dict:
    w = np.asarray(p["w"])
    out = {"w": _tensor(w.reshape(w.shape[0], -1), dtype, device)}
    if "b" in p:
        out["b"] = _tensor(np.asarray(p["b"]).reshape(-1), dtype, device)
    return out


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked (leading-L) subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(cfg, tree: dict, device="cpu", dtype: torch.dtype | None = None) -> dict:
    """The port's parameters, in ``dtype`` (default ``cfg``'s) on ``device``,
    from the reference's ``init_params(cfg, key)`` tree of numpy arrays, or
    from any tree of that structure (its gradients, say)."""
    dt = torch_dtype(cfg) if dtype is None else dtype

    def norm(p):
        return {"scale": _tensor(p["scale"], dt, device)}

    layers = []
    for i in range(cfg.n_layers):
        lp = _layer(tree["layers"], i)
        layers.append({
            "ln1": norm(lp["ln1"]),
            "attn": {name: _linear(lp["attn"][name], dt, device)
                     for name in ("wq", "wk", "wv", "wo")},
            "ln2": norm(lp["ln2"]),
            "mlp": {name: _linear(lp["mlp"][name], dt, device)
                    for name in ("wi", "wg", "wo")}})
    return {"embed": {"table": _tensor(tree["embed"]["table"], dt, device)},
            "head": _linear(tree["head"], dt, device),
            "layers": layers,
            "final_ln": norm(tree["final_ln"])}


def opt_state_from_jax(cfg, opt_tree: dict, device="cpu") -> dict:
    """The port's AdamW state from the reference's ``adamw_init`` /
    ``adamw_apply`` state of numpy arrays: master, m and v mapped as the
    parameters are, in float32, and the int32 step."""
    out = {k: params_from_jax(cfg, opt_tree[k], device, torch.float32)
           for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(opt_tree["step"]), dtype=torch.int32, device=device)
    return out
