"""Spec trees onto DTensors: a train or serving state placed on a mesh, one
``DTensor`` a leaf whose placements are the reference's specs, and the
partitioned train step over it.

``port_shardings`` gives each of the port's leaves its placements in the
leaf's reference view (``NamedSharding``).  Here those become DTensors:

* a leaf whose placements cut only dims the port keeps (its flat ``H·hd``
  dim cut over heads is a contiguous block of the flat dim) is a DTensor of
  the port's own shape;
* a leaf whose spec cuts ``hd`` under several heads (the rules' head_dim
  fallback for head counts the "model" axis does not divide, e.g. qwen2's
  14 heads at model 16), or the audio head's vocab under its codebooks, is
  strided on the flat leaf, which no ``Shard`` expresses: it is held in its
  ``(..., H, hd)`` view (``models.layers.linear`` takes such a weight and
  gives the heads' ``(..., H, hd)``);
* an optimizer leaf whose ZeRO-1 spec cuts the stacked L axis (``Own``
  on the port's list of layers) is held stacked, one tensor a parameter
  path ``layers/*/...`` of ``(L, *view)``, with the spec's placements.

A parameter's placements are never changed silently: a leaf whose
placements are ``Own`` raises.

The state is built from real tensors (``torch.distributed.tensor.
distribute_tensor`` with no source rank: each rank keeps its own blocks of
the whole, nothing moves) or from meta tensors (each rank's block a new
meta tensor of its local shape, as in the dry run).
"""
from __future__ import annotations

import torch

from ..tree import flatten, leaves, unflatten
from .rules import (NamedSharding, Own, _placements, _port_leaves, batch_specs,
                    cache_specs, named, opt_specs, param_specs, port_shardings,
                    reference_shapes)

__all__ = ["place", "StateLayout", "state_layout", "distribute_batch",
           "distribute_cache", "partitioned_train_step"]


def _dt():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def place(t: torch.Tensor, mesh, placements) -> "torch.Tensor":
    """``t`` (the whole leaf) as a DTensor of ``placements`` on ``mesh``:
    a meta ``t`` becomes a new meta tensor of this rank's local shape (the
    dry run's: shapes and dtypes, no storage), a real one this rank's blocks
    of it."""
    DTensor, _, _ = _dt()
    from torch.distributed.tensor import distribute_tensor
    placements = tuple(placements)
    if t.is_meta:
        local = torch.empty(_local_shape(t.shape, mesh, placements), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    out = distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a block that is a view of the whole would keep the whole alive
        out = DTensor.from_local(local.clone(), mesh, placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def _local_shape(shape, mesh, placements) -> tuple:
    """A rank's block of a whole of ``shape``: each ``Shard`` divides its
    dim by its mesh dim's size (the specs cut only dims it divides)."""
    _, _, Shard = _dt()
    out = list(shape)
    for p, n in zip(placements, mesh.shape):
        if isinstance(p, Shard):
            if out[p.dim] % n:
                raise ValueError(f"{tuple(shape)} dim {p.dim} does not split "
                                 f"into {n}")
            out[p.dim] //= n
    return tuple(out)


def _needs_view(sh: NamedSharding, port_shape: tuple) -> bool:
    """Whether a placement cuts a dim the port's flat leaf does not keep."""
    _, _, Shard = _dt()
    if sh.view is None:
        return False
    return any(isinstance(p, Shard) and p.dim >= len(port_shape) for p in sh.placements)


def _no_own(sh: NamedSharding, key: str) -> tuple:
    if any(isinstance(p, Own) for p in sh.placements):
        raise NotImplementedError(
            f"{key}: a parameter whose spec cuts the stacked layer axis "
            f"({sh.spec}) has no placement on the port's list of layers")
    return sh.placements


class StateLayout:
    """Where a train or serving state of ``cfg`` lies on ``mesh``: the
    parameters by ``param_specs(serve=, expert_2d=, layout=)`` and, for
    training, the optimizer state by ``opt_specs``.

    ``views[i]``: the reference view a parameter leaf is held in, or None;
    ``param_at[i]``: its placements (on that view); ``opt_keys``: the
    optimizer state's keys, a port path or ``layers/*/rest`` for a stacked
    group; ``opt_at[key]``: its placements; ``opt_members[key]``: the
    parameter leaves it holds, in order."""

    def __init__(self, cfg, mesh, *, serve=False, expert_2d=False, layout="tp",
                 train=True):
        self.cfg, self.mesh = cfg, mesh
        shapes = reference_shapes(cfg)
        pspecs = param_specs(shapes, mesh, serve=serve, expert_2d=expert_2d,
                             layout=layout)
        self.template, info = _port_leaves(cfg)
        self.keys = [k for k, *_ in info]
        self.port_shapes = [s for _, _, _, s, *_ in info]
        self.dtypes = [d for *_, d in info]
        ps = leaves(port_shardings(cfg, pspecs, mesh))
        os_ = leaves(port_shardings(cfg, opt_specs(
            shapes, mesh, expert_2d=expert_2d, layout=layout)["master"], mesh)) \
            if train else [None] * len(ps)
        self.views = []
        for (key, ref_path, layer, shape, ref, split, _), p, o in zip(info, ps, os_):
            stacked = o is not None and any(isinstance(x, Own) for x in o.placements)
            need = _needs_view(p, shape) or (o is not None and not stacked
                                             and _needs_view(o, shape))
            self.views.append(tuple(ref) if (need or (stacked and split)) else None)
        # a linear's weight and bias are held alike (its output the heads'
        # (..., H, hd) where either is in its view)
        by_key = {k: i for i, k in enumerate(self.keys)}
        for i, (key, *_, ref, split, _) in enumerate(info):
            sib = by_key.get(key[:-1] + ("b" if key.endswith("/w") else "w"))
            if self.views[i] is None and split and sib is not None \
                    and self.views[sib] is not None:
                self.views[i] = tuple(ref)
        self.param_at = [_no_own(p, k) for p, k in zip(ps, self.keys)]
        self.opt_keys, self.opt_at, self.opt_members = [], {}, {}
        if not train:
            return
        ospecs = opt_specs(shapes, mesh, expert_2d=expert_2d, layout=layout)["master"]
        for i, ((key, ref_path, layer, shape, ref, split, _), o) in enumerate(zip(info, os_)):
            if any(isinstance(x, Own) for x in o.placements):
                gkey = "/".join(("layers", "*") + tuple(key.split("/")[2:]))
                if gkey not in self.opt_at:
                    spec = ospecs
                    for k in ref_path:
                        spec = spec[k]
                    self.opt_keys.append(gkey)
                    self.opt_at[gkey] = _placements(spec, mesh)
                    self.opt_members[gkey] = []
                self.opt_members[gkey].append(i)
            else:
                self.opt_keys.append(key)
                self.opt_at[key] = o.placements
                self.opt_members[key] = [i]
                if self.views[i] is None and _needs_view(o, shape):
                    raise AssertionError(key)

    # ------------------------------------------------------------ params
    def _held(self, i, t):
        """A parameter leaf in the shape it is held in."""
        return t.reshape(self.views[i]) if self.views[i] is not None else t

    def params(self, params) -> dict:
        """The port's parameter tree (meta or real whole tensors) placed."""
        ls = leaves(params)
        return unflatten(params, [place(self._held(i, t), self.mesh, self.param_at[i])
                                  for i, t in enumerate(ls)])

    def _opt_whole(self, key, ls):
        idx = self.opt_members[key]
        if key.startswith("layers/*/"):
            return torch.stack([self._held(i, ls[i]) for i in idx])
        return self._held(idx[0], ls[idx[0]])

    def opt_state(self, opt) -> dict:
        """AdamW's state of whole port trees ``{"master", "m", "v", "step"}``
        (meta or real) placed: ``{"master", "m", "v"}`` dicts by opt key,
        ``"step"`` replicated.  Stacking a meta group makes no tensor."""
        _, Replicate, _ = _dt()
        out = {}
        for name in ("master", "m", "v"):
            ls = leaves(opt[name])
            out[name] = {k: place(self._opt_whole(k, ls), self.mesh, self.opt_at[k])
                         for k in self.opt_keys}
        out["step"] = place(opt["step"], self.mesh, [Replicate()] * self.mesh.ndim)
        return out

    # ------------------------------------------------ the one-device state
    def whole_params(self, params) -> dict:
        """The placed parameters gathered whole (a collective: every rank of
        the mesh calls it), in the port's shapes."""
        return unflatten(self.template, [t.full_tensor().reshape(shape) for t, shape in
                                         zip(leaves(params), self.port_shapes)])

    def whole_opt(self, opt) -> dict:
        """The placed optimizer state gathered whole (a collective) as
        ``adamw_init``'s tree: ``{"master", "m", "v"}`` port trees and
        ``"step"``."""
        out = {}
        for name in ("master", "m", "v"):
            ls = [None] * len(self.keys)
            for k in self.opt_keys:
                full = opt[name][k].full_tensor()
                idx = self.opt_members[k]
                if k.startswith("layers/*/"):
                    for j, i in enumerate(idx):
                        ls[i] = full[j].reshape(self.port_shapes[i])
                else:
                    ls[idx[0]] = full.reshape(self.port_shapes[idx[0]])
                del full
            out[name] = unflatten(self.template, ls)
        out["step"] = opt["step"].full_tensor()
        return out

    def place_state(self, state: dict) -> dict:
        """A whole train state ``{"params", "opt", "step"}`` (``opt``
        optional) in the one-device format (a checkpoint's) placed: this
        rank keeps its blocks."""
        out = {**state, "params": self.params(state["params"])}
        if "opt" in state:
            out["opt"] = self.opt_state(state["opt"])
        return out

    # ------------------------------------------------- the optimizer step
    def grads_to_opt(self, grads) -> dict:
        """Gradients in the parameters' placements (the port's tree) onto
        the optimizer state's: a reduce of the data axes' partial sums
        straight into each rank's ZeRO-1 block."""
        ls = leaves(grads)
        return {k: self._opt_whole(k, ls).redistribute(self.mesh, self.opt_at[k])
                for k in self.opt_keys}

    def dtype_tree(self) -> dict:
        """Each opt key's parameter dtype (the tree ``adamw_apply`` casts
        the new parameters by)."""
        return {k: torch.empty((), dtype=self.dtypes[self.opt_members[k][0]],
                               device="meta") for k in self.opt_keys}

    def params_from_opt(self, new) -> dict:
        """New parameters in the optimizer's placements back onto the
        parameters' (the ZeRO-1 gather) and into the port's tree."""
        out = [None] * len(self.keys)
        for k in self.opt_keys:
            idx = self.opt_members[k]
            if k.startswith("layers/*/"):
                for j, i in enumerate(idx):
                    # the stacked L axis gathered first, then each layer
                    out[i] = new[k].redistribute(
                        self.mesh, self._stack_at(i))[j].redistribute(
                            self.mesh, self.param_at[i])
            else:
                out[idx[0]] = new[k].redistribute(self.mesh, self.param_at[idx[0]])
        return unflatten(self.template, out)

    def _stack_at(self, i):
        """A stacked group's placements with its L axis whole and its other
        dims as parameter ``i`` holds them."""
        _, _, Shard = _dt()
        return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                     for p in self.param_at[i])


def state_layout(cfg, mesh, kind: str, *, expert_2d=False, layout="tp") -> StateLayout:
    """The layout of a cell of ``kind`` ("train", "prefill", "decode"), as
    the reference's dry run shards it: serving cells by
    ``param_specs(serve=True)``."""
    if kind == "train":
        return StateLayout(cfg, mesh, expert_2d=expert_2d, layout=layout)
    return StateLayout(cfg, mesh, serve=True, train=False)


def distribute_batch(batch: dict, mesh, include_model=False) -> dict:
    """A batch placed by ``batch_specs``."""
    at = named(mesh, batch_specs(batch, mesh, include_model=include_model))
    return {k: place(v, mesh, at[k].placements) for k, v in batch.items()}


def distribute_cache(cache: dict, mesh) -> dict:
    """A cache's tensors placed by ``cache_specs`` (its position stays an
    int)."""
    tensors = {k: v for k, v in cache.items() if k != "pos"}
    at = named(mesh, cache_specs(tensors, mesh))
    keys, ls = flatten(tensors)
    ats = flatten(at)[1]
    placed = unflatten(tensors, [place(t, mesh, s.placements) for t, s in zip(ls, ats)])
    return {**placed, "pos": cache["pos"]}


def partitioned_train_step(cfg, ocfg, lay: StateLayout, attn_impl="torch",
                           num_microbatches: int = 1):
    """The train step over DTensors: the forward and backward of
    ``make_grad_fn`` on the placed state and batch (the mesh's
    collectives where the placements call for them), the gradients reduced
    onto the optimizer state's placements, ``adamw_apply`` there, and the new
    parameters gathered back onto theirs.  Returns step(params, opt, batch)
    -> (params, opt, metrics), the state in ``lay``'s placements and the
    metrics replicated."""
    from ..train.optimizer import adamw_apply
    from ..train.train_step import make_grad_fn
    DTensor, Replicate, _ = _dt()
    grad_fn = make_grad_fn(cfg, attn_impl, num_microbatches, mesh=lay.mesh)
    rep = [Replicate()] * lay.mesh.ndim

    def step(params, opt, batch):
        loss, grads, met = grad_fn(params, batch)
        g = lay.grads_to_opt(grads)
        del grads
        new, opt, om = adamw_apply(ocfg, g, opt, lay.dtype_tree())
        del g
        params = lay.params_from_opt(new)
        met = {k: v.redistribute(lay.mesh, rep) if isinstance(v, DTensor) else v
               for k, v in {"loss": loss, **met, **om}.items()}
        return params, opt, met

    return step
