"""Multi-pod dry run: every (arch x shape x mesh) cell partitioned by the
specs and stepped once over a fake world, per rank.

The reference lowers and compiles each cell with its spec trees as
``in_shardings`` over 512 forced host devices, and reads the compiled
program.  Here the cell's state and batch are DTensors whose placements are
the same specs (``sharding.dtensor``) on a ``DeviceMesh`` of the production
size over a fake process group (``launch.mesh.fake_world``: one process,
rank 0 of 256 or 512, collectives that move nothing), every local tensor a
meta one (a shape and a dtype, no storage on any device).  One eager step runs over them: DTensor's
sharding propagation puts the collectives where GSPMD would put its own, and
the step is read as it runs, on rank 0's local shards:

  * ``flops``: the local ops' FLOPs (``torch.utils.flop_counter``'s
    formulas: the products);
  * ``bytes``: the unfused sum of every local op's inputs and outputs (not
    XLA's count, which is of its fused program);
  * ``collectives``: the result bytes of each collective, by kind (as the
    reference sums the result shapes of its HLO's collectives), with
    ``total``, and ``collective_calls`` the calls by kind (what
    ``launch.transport`` counts on real ranks); ``CommDebugMode`` counts
    the same ops (``comm_counts``);
  * ``memory``: ``argument_bytes`` (the placed state and batch),
    ``output_bytes`` (what the step returns), ``alias_bytes`` (returned
    tensors that are arguments written in place: decode's cache), the peak
    of the live bytes while the step runs (every local tensor from its
    making to its last reference, the arguments throughout), and
    ``temp_bytes`` = peak - arguments - outputs + aliases, so that
    ``peak_hbm_estimate`` adds up as the reference's does.

Every number is per rank.  The reference's ``collective_bytes(hlo_text)``
has no counterpart: the port has no HLO to parse; the collectives are
counted as they are issued.  The step's attention is the plain chunked one
(``attn_impl="torch"``): the flash-attention kernel runs only on the card.
The reference's "donation" is the port's in-place writes (decode's cache);
the train step's AdamW is functional, so old and new state are both live at
its end, as in the port's trainer.

Costing lowers at ``period`` and ``2·period`` layers extrapolate
``a + L·b`` as the reference's do; an eager step counts every layer, so
where ``L`` is a multiple of the period the extrapolation equals the full
count, and ``run_cell`` asserts it.

Usage:
  python -m repro_torch.launch.dryrun [--arch yi-9b] [--shape train_4k]
      [--mesh single|multi|both] [--out DIR] [--skip-costing]
  python -m repro_torch.launch.dryrun --table [--out DIR]   # the records
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["auto_microbatches", "build_cell", "shardings_for", "lower_cell",
           "analyze", "run_cell", "table", "main", "RankCounter", "Lowered",
           "counting"]

_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all",
                "permute_tensor": "collective-permute"}


# --------------------------------------------------------------------------
def auto_microbatches(cfg, global_batch: int, dp_size: int) -> int:
    """Baseline microbatch policy: a local microbatch of ~4 sequences for
    models narrower than 4096, ~2 for d_model >= 4096, 1 for the widest
    (d_model >= 5120) and for SSMs from 4096."""
    b_local = max(global_batch // dp_size, 1)
    target = 4 if cfg.d_model < 4096 else 2
    if cfg.d_model >= 5120 or (cfg.is_ssm and cfg.d_model >= 4096):
        target = 1
    mb = max(b_local // target, 1)
    while b_local % mb:
        mb -= 1
    return max(mb, 1)


# ------------------------------------------------------------ the counter
class _InPropagation:
    """Marks the shape inference that DTensor's sharding propagation runs
    on whole-size fake tensors, which is no rank's work."""
    depth = 0

    @classmethod
    @contextlib.contextmanager
    def patched(cls):
        """For the body: the shape inference marked, and a Shard -> Shard
        redistribution an all-to-all as on a device mesh (DTensor gives a
        CPU mesh, the fake world's, an all-gather and a chunk instead,
        since gloo has no all-to-all; the fake group has one)."""
        from torch.distributed.tensor import _collective_utils as cu
        from torch.distributed.tensor import placement_types as pt
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        orig_a2a = getattr(pt, "shard_dim_alltoall", None)

        def wrapped(self, *a, **k):
            cls.depth += 1
            try:
                return orig(self, *a, **k)
            finally:
                cls.depth -= 1

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            import torch.distributed._functional_collectives as funcol
            if hasattr(funcol, "_resolve_group"):
                name = funcol._group_or_group_name(funcol._resolve_group((mesh, mesh_dim)))
            else:                              # torch before 2.12
                name = funcol._resolve_group_name((mesh, mesh_dim))
            return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                         name)
        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        if orig_a2a is not None and hasattr(cu, "_shard_dim_alltoall_meta"):
            pt.shard_dim_alltoall = alltoall
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig
            if orig_a2a is not None:
                pt.shard_dim_alltoall = orig_a2a


def _tensors(tree) -> list:
    """The tensors in nested lists, tuples and dicts.  (A loop, not a
    recursive closure: a closure that calls itself is a reference cycle,
    which would hold every op's tensors until the cyclic collector runs,
    and so inflate the live bytes.)"""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankCounter(TorchDispatchMode):
    """Rank 0's local ops as they run: FLOPs, unfused bytes, collective
    bytes by kind, and the live bytes of every storage it has seen made
    (``watch`` adds the arguments'), with their peak.  An op on DTensors is
    left to DTensor, which runs it on the local shards, where this mode
    sees it again."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen: dict[int, weakref.ref] = {}

    def watch(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key]() is st:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(_, n=n, key=key):
            self.live -= n
            self._seen.pop(key, None)
        self._seen[key] = weakref.ref(st, gone)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _InPropagation.depth:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        pk = func._overloadpacket
        if pk in flop_registry:
            self.flops += int(flop_registry[pk](*args, **kwargs, out_val=out))
        kind = _COLLECTIVES.get(pk.__name__) \
            if func.namespace in ("_c10d_functional", "c10d", "_dtensor") else None
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                _nbytes(t) for t in outs)
            self.calls[kind] = self.calls.get(kind, 0) + 1
        for t in outs:
            self.watch(t)
        return out


@contextlib.contextmanager
def counting():
    """A ``RankCounter`` over the body, as the dry run counts a step: on a
    real rank it counts the same local ops (``watch`` the arguments for the
    live bytes)."""
    counter = RankCounter()
    with _InPropagation.patched(), counter:
        yield counter


# ------------------------------------------------------------------ cells
def build_cell(arch: str, shape: str, *, n_layers_override=None, remat=None,
               dp_size: int = 16, microbatches: int | None = None,
               batch_override=None):
    """Returns (cfg, make_step, args, kind): the cell's config, a function
    of the state layout that gives its step, and its arguments as meta
    tensors (the whole, unplaced state and batch).  ``batch_override``:
    ``(global_batch, seq_len)`` in place of the shape's."""
    from ..configs import get_arch, get_shape, input_specs
    from ..models.model import decode_step, init_cache, param_shapes, prefill
    from ..sharding.dtensor import partitioned_train_step
    from ..train.optimizer import AdamWConfig, adamw_init

    cfg = get_arch(arch)
    if n_layers_override:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    sh = get_shape(shape)
    if batch_override is not None:
        sh = dict(sh, global_batch=batch_override[0], seq_len=batch_override[1])
    batch = input_specs(cfg, sh)
    params = param_shapes(cfg)

    if sh["kind"] == "train":
        ocfg = AdamWConfig()
        opt = adamw_init(params)
        mb = microbatches or auto_microbatches(cfg, sh["global_batch"], dp_size)

        def make_step(lay):
            return partitioned_train_step(cfg, ocfg, lay, num_microbatches=mb)
        return cfg, make_step, (params, opt, batch), "train"
    if sh["kind"] == "prefill":
        def make_step(lay):
            def step(params, batch):
                return prefill(cfg, params, batch, attn_impl="torch", mesh=lay.mesh)
            return step
        return cfg, make_step, (params, batch), "prefill"
    cache = init_cache(cfg, sh["global_batch"], sh["seq_len"], device="meta")

    def make_step(lay):
        def step(params, cache, batch):
            return decode_step(cfg, params, cache, batch, mesh=lay.mesh)
        return step
    return cfg, make_step, (params, cache, batch), "decode"


def shardings_for(cfg, mesh, args, kind, expert_2d=False, layout="tp"):
    """(layout, placed args): the state's ``StateLayout`` and the args as
    DTensors on ``mesh``, as the reference's ``shardings_for`` shards them:
    train by ``param_specs``/``opt_specs`` of ``layout`` (``"dp"`` also puts
    the batch over "model"), serving by ``param_specs(serve=True)`` and the
    cache by ``cache_specs``."""
    from ..sharding.dtensor import distribute_batch, distribute_cache, state_layout
    lay = state_layout(cfg, mesh, kind, expert_2d=expert_2d, layout=layout)
    if kind == "train":
        params, opt, batch = args
        return lay, (lay.params(params), lay.opt_state(opt),
                     distribute_batch(batch, mesh, include_model=(layout == "dp")))
    if kind == "prefill":
        params, batch = args
        return lay, (lay.params(params), distribute_batch(batch, mesh))
    params, cache, batch = args
    return lay, (lay.params(params), distribute_cache(cache, mesh),
                 distribute_batch(batch, mesh))


@dataclasses.dataclass
class Lowered:
    """One cell's step as rank 0 ran it: the counter, the argument and
    output bytes, the output bytes written into arguments, the collective
    counts by op, and the seconds it took."""
    counter: object
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    comm_counts: dict
    seconds: float


def _dp_size(mesh, layout: str) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    if layout == "dp":
        dp *= sizes.get("model", 1)
    return dp


def lower_cell(mesh, arch, shape, *, n_layers_override=None, remat=None,
               microbatches=None, expert_2d=False, layout="tp", batch_override=None):
    """Places the cell on ``mesh`` (a mesh of the current, fake, world) and
    runs its step once on fake tensors, counted.  Returns (cfg, Lowered)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg, make_step, args, kind = build_cell(
        arch, shape, n_layers_override=n_layers_override, remat=remat,
        dp_size=_dp_size(mesh, layout), microbatches=microbatches,
        batch_override=batch_override)
    t0 = time.time()
    counter = RankCounter()
    comm = CommDebugMode()
    with _InPropagation.patched(), implicit_replication():
        lay, placed = shardings_for(cfg, mesh, args, kind, expert_2d=expert_2d,
                                    layout=layout)
        del args
        arg_local = [t.to_local() if isinstance(t, DTensor) else t
                     for t in _tensors(placed)]
        for t in arg_local:
            counter.watch(t)
        arg_bytes = sum(_nbytes(t) for t in arg_local)
        arg_storages = {id(t.untyped_storage()) for t in arg_local}
        step = make_step(lay)
        with comm, counter:
            out = step(*placed)
        out_local = [t.to_local() if isinstance(t, DTensor) else t
                     for t in _tensors(out)]
        seen, out_bytes, alias = set(), 0, 0
        for t in out_local:
            st = id(t.untyped_storage())
            if st in seen:
                continue
            seen.add(st)
            out_bytes += _nbytes(t)
            if st in arg_storages:
                alias += _nbytes(t)
        del out, out_local, placed, arg_local
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    return cfg, Lowered(counter, arg_bytes, out_bytes, alias, counts,
                        time.time() - t0)


def analyze(lowered: Lowered) -> dict:
    """The reference's record fields, per rank."""
    c = lowered.counter
    coll = dict(c.collectives)
    coll["total"] = sum(coll.values())
    peak = c.peak
    arg, out, alias = lowered.argument_bytes, lowered.output_bytes, lowered.alias_bytes
    return {
        "flops": float(c.flops),
        "bytes": float(c.bytes),
        "collectives": coll,
        "collective_calls": dict(c.calls),
        "comm_counts": lowered.comm_counts,
        "memory": {
            "argument_bytes": arg,
            "output_bytes": out,
            "temp_bytes": peak - arg - out + alias,
            "alias_bytes": alias,
            "peak_hbm_estimate": peak,
        },
        "seconds": lowered.seconds,
    }


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: pathlib.Path,
             costing: bool = True, variant: str | None = None,
             **lower_kw) -> dict:
    """One cell on the single-pod (16x16) or multi-pod (2x16x16) mesh of a
    fake world: the full-depth step, and (``costing``) the costing lowers
    at ``period`` and ``2·period`` layers, extrapolated; the record is
    written to ``out_dir``."""
    from .mesh import fake_world, make_production_mesh

    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                     "mesh_shape": list(mesh.shape),
                     "variant": variant or "baseline", "overrides": repr(lower_kw)}
        t0 = time.time()
        cfg, low = lower_cell(mesh, arch, shape, **lower_kw)
        full = analyze(low)
        rec["full"] = full
        rec["compile_seconds"] = time.time() - t0
        if costing:
            period = cfg.attn_every or 1
            t1 = time.time()
            kw = dict(lower_kw)
            kw.pop("n_layers_override", None)
            a1 = analyze(lower_cell(mesh, arch, shape, n_layers_override=period, **kw)[1])
            a2 = analyze(lower_cell(mesh, arch, shape, n_layers_override=2 * period,
                                    **kw)[1])
            L = cfg.n_layers

            def extrapolate(v1, v2):
                b = (v2 - v1) / period
                a = v1 - period * b
                return a + L * b

            flops = extrapolate(a1["flops"], a2["flops"])
            rec["costing"] = {
                "flops": flops,
                "bytes": extrapolate(a1["bytes"], a2["bytes"]),
                "collective_bytes": extrapolate(a1["collectives"]["total"],
                                                a2["collectives"]["total"]),
                "collectives_by_kind": {
                    k: extrapolate(a1["collectives"].get(k, 0.0),
                                   a2["collectives"].get(k, 0.0))
                    for k in set(a1["collectives"]) | set(a2["collectives"])
                    if k != "total"},
                "period": period,
                "costing_seconds": time.time() - t1,
            }
            if L % period == 0:
                # every layer counted: the line through two depths is exact
                assert flops == full["flops"], (
                    f"{arch} x {shape}: extrapolated FLOPs {flops} != the "
                    f"full-depth count {full['flops']}")
            rec["costing"]["flops_vs_full"] = flops - full["flops"]
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"__{variant}" if variant else ""
    path = out_dir / f"{arch}__{shape}__{mesh_kind}{tag}.json"
    path.write_text(json.dumps(rec, indent=1))
    return rec


def table(out_dir: pathlib.Path) -> str:
    """The records under ``out_dir`` as a markdown table, in the registry's
    order: per rank, the peak GB (1e9 bytes), TFLOP, the collectives' GB by
    kind (all-reduce / all-gather / reduce-scatter / all-to-all) and the
    cell's seconds (its full step, costing apart)."""
    from ..configs import ARCHS, SHAPES
    rows = ["| arch | shape | mesh | | peak GB | TFLOP | AR / AG / RS / A2A GB "
            "| s |", "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for a in ARCHS:
        for s in SHAPES:
            for mk in ("single", "multi"):
                path = out_dir / f"{a}__{s}__{mk}.json"
                if not path.exists():
                    continue
                rec = json.loads(path.read_text())
                full = rec["full"]
                if full is None:
                    rows.append(f"| {a} | {s} | {mk} | FAIL: {rec['error'][:120]} "
                                "| | | | |")
                    continue
                c = full["collectives"]
                kinds = " / ".join(f"{c.get(k, 0) / 1e9:.3g}" for k in (
                    "all-reduce", "all-gather", "reduce-scatter", "all-to-all"))
                rows.append(f"| {a} | {s} | {mk} | OK | "
                            f"{full['memory']['peak_hbm_estimate'] / 1e9:.4g} | "
                            f"{full['flops'] / 1e12:.4g} | {kinds} | "
                            f"{full['seconds']:.0f} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--skip-costing", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="a tag for an experiment (suffixes the JSON name)")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp", "fsdp"])
    ap.add_argument("--expert-2d", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a markdown table "
                         "(one row a cell x mesh) and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(pathlib.Path(args.out)))
        return

    from ..configs import runnable_cells
    out_dir = pathlib.Path(args.out)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    def chosen(a, s):
        return (args.arch is None or a == args.arch) and \
            (args.shape is None or s == args.shape)
    cells = [(a, s) for a, s, ok in runnable_cells() if ok and chosen(a, s)]
    skipped = [(a, s) for a, s, ok in runnable_cells() if not ok and chosen(a, s)]
    for a, s in skipped:
        print(f"SKIP {a} x {s} (full attention at 500k — see DESIGN.md §5)")

    failures = []
    for a, s in cells:
        for mk in meshes:
            tag = f"{a} x {s} x {mk}"
            have = out_dir / f"{a}__{s}__{mk}.json"
            if args.skip_existing and have.exists() \
                    and json.loads(have.read_text())["full"] is not None:
                print(f"HAVE {tag}")
                continue
            try:
                t0 = time.time()
                # costing only once (the per-rank terms are the pods' alike)
                rec = run_cell(a, s, mk, out_dir,
                               costing=(not args.skip_costing and mk == "single"),
                               variant=args.variant, layout=args.layout,
                               expert_2d=args.expert_2d,
                               microbatches=args.microbatches)
                mem = rec["full"]["memory"]["peak_hbm_estimate"] / 2**30
                print(f"OK   {tag}: peak/dev ~{mem:.2f} GiB, "
                      f"colls {rec['full']['collectives']['total']/2**20:.1f} MiB, "
                      f"{time.time()-t0:.0f}s", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e!r}", flush=True)
                traceback.print_exc()
                out_dir.mkdir(parents=True, exist_ok=True)
                (out_dir / f"{a}__{s}__{mk}.json").write_text(json.dumps(
                    {"arch": a, "shape": s, "mesh": mk, "full": None,
                     "error": repr(e)}, indent=1))
    print(f"\n{len(cells)*len(meshes)-len(failures)} ok, {len(failures)} failed,"
          f" {len(skipped)} skipped")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
