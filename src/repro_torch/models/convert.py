"""Carry the reference's parameters and optimizer state across:
``params_from_jax``, ``opt_state_from_jax``.

The reference's ``init_params`` tree, its leaves turned into numpy arrays
(``jax.tree.map(np.asarray, params)``), becomes the port's tree: the
stacked ``layers`` leaves are split along their leading L axis into one
dict per layer, and the ``(d, H, hd)`` projection weights and ``(H, hd)``
biases are flattened to the ``(d, H * hd)`` and ``(H * hd,)`` the port
stores.  An SSM layer's ``mixer`` maps leaf by leaf (its linears as
above), and the hybrid's ``shared_attn`` and ``shared_ln`` as a layer's
attention and norm.  An MLA attention's projections are linears and its
``q_norm``/``kv_norm`` norms; an MoE ``mlp`` keeps its router as a linear,
its ``(E, ...)`` expert weights ``wi``, ``wg``, ``wo`` as they are, and its
``shared`` experts as a SwiGLU.  Each leaf keeps its own dtype unless the
caller asks for one: the reference keeps ``A_log``, ``D`` and ``dt_bias``,
and the MoE router, float32 in a bfloat16 model.  Any tree of the
parameters' structure maps the same way (a gradient tree, AdamW's master,
m and v).  Takes numpy only, so the port never imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "opt_state_from_jax"]


def _tensor(a, dtype: torch.dtype | None, device) -> torch.Tensor:
    """``a`` as a tensor in ``dtype``, or in its own dtype for None."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses; bfloat16 ->
        # float32 -> bfloat16 is exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=dtype or torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


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
    """The port's parameters on ``device``, each leaf in ``dtype`` (default:
    its own), from the reference's ``init_params(cfg, key)`` tree of numpy
    arrays, or from any tree of that structure (its gradients, say)."""
    def norm(p):
        return {"scale": _tensor(p["scale"], dtype, device)}

    def gqa(p):
        return {name: _linear(p[name], dtype, device) for name in ("wq", "wk", "wv", "wo")}

    def attn(p):
        if not cfg.is_mla:
            return gqa(p)
        return {name: norm(v) if name.endswith("_norm") else _linear(v, dtype, device)
                for name, v in p.items()}

    def swiglu(p):
        return {name: _linear(p[name], dtype, device) for name in ("wi", "wg", "wo")}

    def mlp(p):
        if not cfg.is_moe:
            return swiglu(p)
        out = {"router": _linear(p["router"], dtype, device)}
        out.update({name: _tensor(p[name], dtype, device) for name in ("wi", "wg", "wo")})
        if "shared" in p:
            out["shared"] = swiglu(p["shared"])
        return out

    layers = []
    for i in range(cfg.n_layers):
        lp = _layer(tree["layers"], i)
        if cfg.is_ssm:
            layers.append({"ln1": norm(lp["ln1"]), "mixer": {
                name: _linear(v, dtype, device) if isinstance(v, dict) else _tensor(v, dtype, device)
                for name, v in lp["mixer"].items()}})
            continue
        layers.append({"ln1": norm(lp["ln1"]), "attn": attn(lp["attn"]),
                       "ln2": norm(lp["ln2"]), "mlp": mlp(lp["mlp"])})
    out = {"embed": {"table": _tensor(tree["embed"]["table"], dtype, device)},
           "head": _linear(tree["head"], dtype, device),
           "layers": layers}
    if "shared_attn" in tree:
        out["shared_attn"] = gqa(tree["shared_attn"])
        out["shared_ln"] = norm(tree["shared_ln"])
    out["final_ln"] = norm(tree["final_ln"])
    return out


def opt_state_from_jax(cfg, opt_tree: dict, device="cpu") -> dict:
    """The port's AdamW state from the reference's ``adamw_init`` /
    ``adamw_apply`` state of numpy arrays: master, m and v mapped as the
    parameters are, in float32, and the int32 step."""
    out = {k: params_from_jax(cfg, opt_tree[k], device, torch.float32)
           for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(opt_tree["step"]), dtype=torch.int32, device=device)
    return out
