"""Logical sharding rules: param/optimizer/cache/batch specs, and where
they put the port's leaves.

Axis semantics of the production mesh (launch/mesh.py):
  "pod"   — data parallel across pods (slow DCN links; grad sync crosses it)
  "data"  — data parallel within a pod
  "model" — tensor/expert parallel (attention heads, ffn hidden, experts,
            mamba inner channels, vocab)

Rules are path-based with divisibility guards: a dim is sharded only when
divisible by the mesh axis size (e.g. granite's kv=1 head stays replicated —
the realistic MQA serving layout).  ZeRO-1: optimizer-state leaves get their
first still-replicated divisible dim sharded over "data" on top of the param
layout.

The rules are the reference's line for line, over a tree of shapes in the
reference's layout (``reference_shapes(cfg)``: the stacked ``layers`` with
their leading L axis, the projections' ``(d, H, hd)``) and a mesh: a torch
``DeviceMesh`` or an ``AbstractMesh`` of axis sizes and no ranks.  A spec is
a ``P``, one entry a tensor dim.

The port keeps one dict a layer and flat ``(d, H * hd)`` projections, so
``port_shardings`` maps a spec tree onto the port's tree: the stacked L axis
becomes ``Own(index)``, the ranks at that coordinate of the axis holding the
layer's leaf whole, and every other dim is cut by ``Shard(dim)`` of the
leaf's reference view (``NamedSharding.view``: the flat last dim unflattened
back to ``(H, hd)``, a reshape of the leaf's own storage).  So a cut of hd
under several heads, strided on the flat leaf, holds the reference's
elements as the spec does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import flatten, unflatten

__all__ = ["P", "AbstractMesh", "Own", "NamedSharding", "param_specs",
           "opt_specs", "batch_specs", "cache_specs", "named", "data_axes",
           "reference_shapes", "port_shardings", "state_shardings", "axis_sizes"]


def _norm_axis(a):
    # a one-name tuple is the name, an empty one None (as jax's
    # PartitionSpec keeps them)
    if isinstance(a, (tuple, list)):
        a = tuple(a)
        return None if not a else a[0] if len(a) == 1 else a
    return a


class P:
    """A partition spec: one entry a tensor dim, each an axis name, a tuple
    of names (the dim cut over all of them, the first the major) or None.
    Not a tuple, so that the port's trees take it as a leaf; it iterates and
    compares as the tuple of its entries (``P("data", None) == ("data",
    None)``), as ``tuple(jax.sharding.PartitionSpec(...))`` does."""
    __slots__ = ("_axes",)

    def __init__(self, *axes):
        self._axes = tuple(_norm_axis(a) for a in axes)

    def __iter__(self):
        return iter(self._axes)

    def __len__(self):
        return len(self._axes)

    def __getitem__(self, i):
        return self._axes[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._axes == other._axes
        if isinstance(other, tuple):
            return self._axes == other
        return NotImplemented

    def __hash__(self):
        return hash(self._axes)

    def __repr__(self):
        return f"P{self._axes!r}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks (the reference's
    ``jax.sharding.AbstractMesh``), so that the spec logic runs at any mesh
    size: ``shape`` maps a name to its size."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)     # a DeviceMesh
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def _axis_size(mesh, name) -> int:
    return axis_sizes(mesh).get(name, 1)


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _leaf_spec(path: tuple[str, ...], shape: tuple[int, ...], msize: int) -> P:
    """Param sharding for one leaf, identified by its dict path."""
    p = list(path)
    stacked = p and p[0] == "layers"
    off = 1 if stacked else 0           # leading L axis of scanned stacks

    def spec(*axes):
        return P(*([None] * off + list(axes)))

    name = p[-1]
    parent = p[-2] if len(p) >= 2 else ""
    gparent = p[-3] if len(p) >= 3 else ""
    dims = shape[off:]

    def model_if(idx: int):
        axes = [None] * len(dims)
        if _div(dims[idx], msize):
            axes[idx] = "model"
        return spec(*axes)

    # ---- embeddings / head ------------------------------------------------
    if parent == "embed" and name == "table":
        return model_if(len(dims) - 2)            # vocab dim (C, V, d) or (V, d)
    if parent == "head" and name == "w":
        return model_if(len(dims) - 1)            # (d, V) or (d, C, V)
    if parent == "head" and name == "b":
        return model_if(len(dims) - 1)

    # ---- norms / scalars ---------------------------------------------------
    if name in ("scale",) or parent in ("ln1", "ln2", "final_ln", "kv_norm",
                                        "q_norm", "shared_ln"):
        return spec(*([None] * len(dims)))

    # ---- attention ----------------------------------------------------------
    if gparent in ("attn", "shared_attn") or parent in ("attn", "shared_attn") \
            or (stacked and len(p) >= 2 and p[1] == "attn") \
            or path[0] == "shared_attn":
        if parent in ("wq", "wk", "wv", "wq_b", "wk_b", "wv_b"):
            if name == "w":                       # (d|r, H, hd)
                sp = model_if(1)
                if sp == spec(None, None, None) and len(dims) == 3:
                    return model_if(2)            # odd head counts: shard hd
                return sp
            sp = model_if(0)                      # bias (H, hd)
            if sp == spec(None, None) and len(dims) == 2:
                return model_if(1)
            return sp
        if parent == "wo" and name == "w":        # (H*hd, d)
            return model_if(0)
        if parent in ("wq_a", "wkv_a"):
            return spec(*([None] * len(dims)))    # low-rank stems replicated
        return spec(*([None] * len(dims)))

    # ---- MoE ------------------------------------------------------------------
    if parent == "router":
        return spec(*([None] * len(dims)))
    if name in ("wi", "wg", "wo") and len(dims) == 3 and parent == "mlp":
        return model_if(0)                        # (E, d, ff) expert dim -> EP
    if gparent == "shared" or parent == "shared":
        # shared experts: dense SwiGLU layout
        if parent in ("wi", "wg") and name == "w":
            return model_if(1)
        if parent == "wo" and name == "w":
            return model_if(0)
        return spec(*([None] * len(dims)))

    # ---- dense MLP ---------------------------------------------------------------
    if gparent == "mlp" or parent == "mlp":
        if parent in ("wi", "wg") and name == "w":    # (d, ff)
            return model_if(1)
        if parent == "wo" and name == "w":            # (ff, d)
            return model_if(0)
        return spec(*([None] * len(dims)))

    # ---- mamba ------------------------------------------------------------------
    if parent == "mixer" or gparent == "mixer":
        if parent == "in_proj" and name == "w":       # (d, 2*di)
            return model_if(1)
        if parent == "out_proj" and name == "w":      # (di, d)
            return model_if(0)
        if parent == "x_proj" and name == "w":        # (di, k)
            return model_if(0)
        if parent == "dt_proj":
            if name == "w":                            # (dt_rank, di)
                return model_if(1)
            return model_if(0)                         # bias (di,)
        if name == "conv":                             # (di, W)
            return model_if(0)
        if name in ("conv_b", "D") and len(dims) == 1:
            return model_if(0)
        if name == "A_log":                            # (di, s) or (H,)
            return model_if(0)
        if name == "dt_bias":
            return model_if(0)
        if parent == "bc_proj":
            return spec(*([None] * len(dims)))         # small (d, 2s+H)
        return spec(*([None] * len(dims)))

    return spec(*([None] * len(dims)))


def _paths_and_shapes(tree):
    keys, leaves = flatten(tree)
    return [(tuple(k.split("/")), tuple(getattr(leaf, "shape", ())))
            for k, leaf in zip(keys, leaves)]


def _like(tree, new_leaves):
    """A nested dict of ``tree``'s structure with ``new_leaves`` (the
    shape trees here are dicts only)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def param_specs(params_shapes, mesh, serve: bool = False,
                expert_2d: bool = False, layout: str = "tp"):
    """Spec tree matching a params (shapes) tree.

    ``serve=True`` / ``expert_2d=True``: expert tensors additionally shard
    their d_model axis over the data axis (2D weight sharding; the MoE
    einsum re-gathers per use) — what fits a 236B MoE on 256 x 16 GiB chips
    (serving always; training as the FSDP-style §Perf lever).

    ``layout="dp"``: replicate all weights; the model axis is given to the
    batch instead (see batch_specs(include_model=True)) — the right layout
    for small models where TP activation psums dominate (§Perf, qwen2).
    """
    msize = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")
    flat = _paths_and_shapes(params_shapes)

    def leaf(path, shape):
        if layout == "dp":
            return P(*([None] * len(shape)))
        spec = _leaf_spec(path, shape, msize)
        if (serve or expert_2d) and path[-1] in ("wi", "wg", "wo") \
                and len(shape) == 4 and path[-2] == "mlp" \
                and spec == P(None, "model", None, None):
            # stacked expert weights (L, E, d, ff)/(L, E, ff, d): shard the
            # wider inner axis over data
            inner = 2 if shape[2] >= shape[3] else 3
            if _div(shape[inner], dsize):
                axes = [None, "model", None, None]
                axes[inner] = "data"
                return P(*axes)
        if layout == "fsdp":
            # ZeRO-3: every big param also shards a replicated dim over
            # "data" (XLA re-gathers per use; grads reduce-scatter back)
            n = 1
            for s in shape:
                n *= s
            axes = list(spec) + [None] * (len(shape) - len(spec))
            if n >= 1 << 20 and "data" not in axes:
                for i in range(len(shape) - 1, -1, -1):
                    if axes[i] is None and _div(shape[i], dsize) \
                            and shape[i] >= dsize:
                        axes[i] = "data"
                        return P(*axes)
        return spec

    return _like(params_shapes, [leaf(p, s) for p, s in flat])


def opt_specs(params_shapes, mesh, zero1: bool = True,
              expert_2d: bool = False, layout: str = "tp"):
    """Optimizer-state specs: master/m/v mirror the param layout; under
    ZeRO-1 the first still-replicated divisible dim also shards over "data"
    (and over "model" too in the pure-DP layout, where weights are
    replicated and the optimizer is the only sharded copy)."""
    dsize = _axis_size(mesh, "data")
    msize = _axis_size(mesh, "model")
    pspecs = param_specs(params_shapes, mesh, expert_2d=expert_2d,
                         layout=layout)

    def zero1_spec(spec: P, shape: tuple[int, ...]) -> P:
        if not zero1:
            return spec
        axes = list(spec) + [None] * (len(shape) - len(spec))
        pending = [a for a in (["data"] + (["model"] if layout == "dp" else []))
                   if a not in axes]    # an axis may appear only once
        sizes = {"data": dsize, "model": msize}
        for i in range(len(shape)):
            if not pending:
                break
            ax = pending[0]
            if axes[i] is None and _div(shape[i], sizes[ax]) and shape[i] >= sizes[ax]:
                axes[i] = ax       # ZeRO-1: slice replicated dims over DP
                pending.pop(0)
        return P(*axes)

    flat = _paths_and_shapes(params_shapes)
    flat_p = flatten(pspecs)[1]
    state_leaf_specs = _like(
        params_shapes, [zero1_spec(sp, sh) for (path, sh), sp in zip(flat, flat_p)])
    return {
        "master": state_leaf_specs,
        "m": state_leaf_specs,
        "v": state_leaf_specs,
        "step": P(),
    }


def batch_specs(batch_shapes, mesh, include_model: bool = False):
    """Batch dims shard over the DP axes when divisible (long_500k's B=1
    stays replicated).  ``include_model=True``: pure-DP layout — the model
    axis joins the batch sharding (weights replicated)."""
    dp = data_axes(mesh)
    if include_model and "model" in _axis_names(mesh):
        dp = dp + ("model",)
    dp_size = math.prod(_axis_size(mesh, a) for a in dp) if dp else 1

    def one(shape):
        if not shape:
            return P()
        if _div(shape[0], dp_size):
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _like(batch_shapes, [one(s) for _, s in _paths_and_shapes(batch_shapes)])


def cache_specs(cache_shapes, mesh):
    """KV/SSM cache: batch dim -> DP axes; head/channel dims -> model when
    divisible.  Cache layouts (leading L stack axis):
      k/v    (L, B, Hkv, S, hd)   model on Hkv
      c_kv   (L, B, S, r)          replicated feature dim (MLA latent)
      conv   (L, B, W-1, di)       model on di
      h      (L, B, di, s)         model on di
      S      (L, B, H, s, P)       model on H
      shared k/v (Ns, B, Hkv, S, hd)
    """
    dp = data_axes(mesh)
    dp_size = math.prod(_axis_size(mesh, a) for a in dp) if dp else 1
    msize = _axis_size(mesh, "model")
    flat = _paths_and_shapes(cache_shapes)

    def one(path, shape):
        name = path[-1]
        if name == "pos" or not shape:
            return P()
        axes: list = [None] * len(shape)
        # batch axis is dim 1 for stacked entries
        bdim = 1 if len(shape) >= 2 else 0
        if _div(shape[bdim], dp_size):
            axes[bdim] = dp
        if name in ("k", "v") and len(shape) == 5:
            if _div(shape[2], msize):
                axes[2] = "model"          # KV heads
            elif _div(shape[4], msize):
                axes[4] = "model"          # MQA/odd-head serving: shard hd
        elif name == "c_kv" and _div(shape[-1], msize):
            axes[-1] = "model"             # MLA latent dim (512/16 = 32)
        elif name == "conv" and _div(shape[-1], msize):
            axes[-1] = "model"
        elif name == "h" and _div(shape[2], msize):
            axes[2] = "model"
        elif name == "S" and _div(shape[2], msize):
            axes[2] = "model"
        return P(*axes)

    return _like(cache_shapes, [one(p, s) for p, s in flat])


# ------------------------------------------------------------- placements
@dataclasses.dataclass(frozen=True)
class Own:
    """A mesh dim's placement of one layer's leaf where the reference's
    spec cuts the stacked L axis over it: the ranks at ``index`` along the
    dim hold the leaf whole, the others nothing."""
    index: int


def _shard_types():
    from torch.distributed.tensor import Replicate, Shard
    return Shard, Replicate


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement on a mesh (the reference's ``NamedSharding``):
    one entry a mesh dim, ``Shard(dim)``, ``Replicate()`` or ``Own(i)``;
    ``spec`` is the spec it came from.  ``view``: the dims a ``Shard``
    counts, where they are not the leaf's own (a port leaf's reference
    dims), else None."""
    mesh: object
    placements: tuple
    spec: P | None = None
    view: tuple | None = None

    def local_slices(self, shape, coordinate=None) -> tuple:
        """The slices of a leaf of ``shape`` (of its ``view``) that the
        rank at ``coordinate`` (one index a mesh dim; default this rank's
        in the mesh) holds: a ``Shard`` cuts its dim into equal contiguous
        blocks, mesh dims in order; an ``Own`` that is not this rank's
        leaves dim 0 empty."""
        Shard, _ = _shard_types()
        if coordinate is None:
            coordinate = self.mesh.get_coordinate()
        shape = self.view_of(shape)
        sizes = list(axis_sizes(self.mesh).values())
        lo, hi = [0] * len(shape), list(shape)
        for pl, c, n in zip(self.placements, coordinate, sizes):
            if isinstance(pl, Own) and c != pl.index:
                lo[0] = hi[0] = 0
            elif isinstance(pl, Shard):
                block = (hi[pl.dim] - lo[pl.dim]) // n
                lo[pl.dim] += c * block
                hi[pl.dim] = lo[pl.dim] + block
        return tuple(slice(a, b) for a, b in zip(lo, hi))

    def view_of(self, shape) -> tuple:
        """The dims the placements count on a leaf of ``shape``."""
        shape = tuple(shape)
        if self.view is None:
            return shape
        if math.prod(self.view) != math.prod(shape):
            raise ValueError(f"a leaf of {shape} has no view {self.view}")
        return self.view

    def local(self, array, coordinate=None):
        """This rank's part of the whole ``array`` (a tensor or a numpy
        array): a view, shaped as its slice of ``view``, or ``array`` itself
        where the rank holds all of it."""
        view = self.view_of(array.shape)
        sl = self.local_slices(view, coordinate)
        if all(s.start == 0 and s.stop == n for s, n in zip(sl, view)):
            return array
        return array.reshape(view)[sl]


def _placements(spec: P, mesh) -> tuple:
    """A spec's placements: a ``Shard`` on each mesh axis the spec names,
    except an axis of size 1, which cuts nothing and places as
    ``Replicate()`` (as in ``port_shardings``): DTensor's view rules cannot
    propagate a ``Shard`` over a mesh dim of size 1 (a one-row batch at
    data 1)."""
    Shard, Replicate = _shard_types()
    sizes = axis_sizes(mesh)
    out = {a: Replicate() for a in _axis_names(mesh)}
    for dim, entry in enumerate(spec):
        for a in _axis_entries(entry):
            if sizes[a] > 1:
                out[a] = Shard(dim)
    return tuple(out.values())


def _axis_entries(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def named(mesh, tree_of_specs):
    """A ``NamedSharding`` a spec, its placements on the reference's
    layout (``_placements``)."""
    return _like(tree_of_specs, [NamedSharding(mesh, _placements(s, mesh), s)
                                 for s in flatten(tree_of_specs)[1]])


# -------------------------------------------------- the port's parameters
def _split(cfg, path: tuple) -> tuple | None:
    """The reference dims that a port leaf's last dim flattens (its
    ``(H, hd)`` heads, the audio head's ``(C, V)``), or None.  ``path`` is
    the leaf's, without a layer index."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    gparent = path[-3] if len(path) >= 3 else ""
    if path[:2] == ("head", "w") and cfg.frontend == "audio_codebooks":
        return (cfg.n_codebooks, cfg.vocab)
    if gparent == "shared_attn" or (gparent == "attn" and not cfg.is_mla):
        heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads,
                 "wv": cfg.n_kv_heads}.get(parent)
        return (heads, cfg.hd) if heads else None
    if gparent == "attn" and name == "w":
        H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {"wq": (H, dn + dr), "wq_b": (H, dn + dr), "wk_b": (H, dn),
                "wv_b": (H, dv)}.get(parent)
    return None


def _port_leaves(cfg):
    """The port's parameter shapes, and for each leaf (port path, reference
    path, layer index or None, port shape, reference dims without L, split,
    dtype)."""
    from ..models.model import param_shapes
    shapes = param_shapes(cfg)
    keys, leaves = flatten(shapes)
    out = []
    for key, leaf in zip(keys, leaves):
        path = tuple(key.split("/"))
        layer = None
        ref_path = path
        if path[0] == "layers":
            layer, ref_path = int(path[1]), ("layers",) + path[2:]
        shape = tuple(leaf.shape)
        split = _split(cfg, ref_path[1:] if layer is not None else ref_path)
        ref = shape if split is None else shape[:-1] + split
        if split is not None and math.prod(split) != shape[-1]:
            raise ValueError(f"{key}: {shape} does not flatten {split}")
        out.append((key, ref_path, layer, shape, ref, split, leaf.dtype))
    return shapes, out


def reference_shapes(cfg) -> dict:
    """The reference's ``init_params`` shape tree, from the port's own
    init on the meta device: meta tensors in the reference's layout (each
    ``layers`` leaf stacked to ``(L, ...)``, the flat projections unflattened
    to ``(d, H, hd)``)."""
    tree: dict = {}
    for key, ref_path, layer, shape, ref, split, dtype in _port_leaves(cfg)[1]:
        if layer not in (None, 0):
            continue
        dims = ((cfg.n_layers,) if layer is not None else ()) + ref
        node = tree
        for k in ref_path[:-1]:
            node = node.setdefault(k, {})
        node[ref_path[-1]] = torch.empty(dims, dtype=dtype, device="meta")
    return tree


def _spec_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def port_shardings(cfg, specs, mesh):
    """The port's parameter tree (a list of layers, flat projections) of
    ``NamedSharding``s for a spec tree over ``reference_shapes(cfg)`` (a
    ``param_specs``, or one of ``opt_specs``' master/m/v).  An axis of size
    1 cuts nothing and places as ``Replicate()``; the stacked L axis places
    as ``Own``; every other dim as a ``Shard`` of the leaf's reference view,
    where the port flattens dims."""
    Shard, Replicate = _shard_types()
    sizes = axis_sizes(mesh)
    shapes, leaves = _port_leaves(cfg)
    out = []
    for _, ref_path, layer, _, ref, split, _ in leaves:
        spec = _spec_at(specs, ref_path)
        axes = list(spec) + [None] * (len(ref) + (layer is not None) - len(spec))
        pl = {a: Replicate() for a in sizes}
        if layer is not None:
            cut = [a for a in _axis_entries(axes.pop(0)) if sizes[a] > 1]
            block = cfg.n_layers // math.prod(sizes[a] for a in cut) if cut else 0
            index = layer // block if cut else 0
            for a in reversed(cut):            # the first name is the major
                pl[a] = Own(index % sizes[a])
                index //= sizes[a]
        for j, entry in enumerate(axes):
            for a in _axis_entries(entry):
                if sizes[a] > 1:
                    pl[a] = Shard(j)
        out.append(NamedSharding(mesh, tuple(pl.values()), spec,
                                 ref if split is not None else None))
    return unflatten(shapes, out)


def state_shardings(cfg, mesh) -> dict:
    """The placements of a train state {"params", "opt", "step"} of ``cfg``
    on ``mesh``: a tree of the state's structure, ``None`` where a leaf is
    whole."""
    shapes = reference_shapes(cfg)
    ps = port_shardings(cfg, param_specs(shapes, mesh), mesh)
    os_ = port_shardings(cfg, opt_specs(shapes, mesh)["master"], mesh)
    return {"params": ps, "opt": {"master": os_, "m": os_, "v": os_, "step": None},
            "step": None}
