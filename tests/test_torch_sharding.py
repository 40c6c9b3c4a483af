"""The port's sharding rules (repro_torch.sharding) against the reference's
(repro.sharding), spec for spec, at full size.

The reference's shape trees come from ``jax.eval_shape`` of its
``init_params`` / ``init_cache``; the port's from its own init on the meta
device (``reference_shapes``, ``init_cache(device="meta")``), which must
give the reference's paths and shapes.  Both run the rules over a mesh of
axis sizes and no devices.  Then the mapping onto the port's tree
(``port_shardings``): every port leaf gets exactly one placement, whose
shards over the mesh cover the leaf once, counted on the leaf's reference
view where the port flattens dims (a cut of hd under several heads
included)."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.model import init_cache as ref_init_cache  # noqa: E402
from repro import sharding as ref_sharding  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "16x1": ((16, 1), ("data", "model"))}
PARAM_VARIANTS = [dict(layout="tp"), dict(layout="dp"), dict(layout="fsdp"),
                  dict(serve=True), dict(expert_2d=True)]
OPT_VARIANTS = [dict(zero1=z, layout=lay) for z in (True, False)
                for lay in ("tp", "dp", "fsdp")] + [dict(expert_2d=True)]
# (batch, seq) of the reference's shapes (train_4k, prefill_32k, decode_32k,
# long_500k) and a batch no mesh divides
BATCHES = [(256, 4096), (32, 32768), (128, 1), (1, 1), (3, 8)]
CACHE = (128, 4096)

_REF = {}


def _ref_params(arch):
    if arch not in _REF:
        _REF[arch] = jax.eval_shape(
            lambda: ref_init_params(REF_ARCHS[arch], jax.random.PRNGKey(0)))
    return _REF[arch]


def _port_shapes(arch):
    key = ("port", arch)
    if key not in _REF:
        _REF[key] = sharding.reference_shapes(get_arch(arch))
    return _REF[key]


def _meshes(name):
    sizes, names = MESHES[name]
    return (ref_sharding.compat_abstract_mesh(sizes, names),
            sharding.compat_abstract_mesh(sizes, names))


def _ref_flat(tree):
    from jax.sharding import PartitionSpec
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): v
            for kp, v in flat}


def _port_flat(tree):
    keys, leaves = flatten(tree)
    return dict(zip(keys, leaves))


def _same_specs(port_tree, ref_tree):
    want, got = _ref_flat(ref_tree), _port_flat(port_tree)
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert isinstance(got[key], sharding.P), key
        assert got[key] == tuple(spec), (key, got[key], spec)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reference_shapes_are_the_reference_s_init_params(arch):
    want = {k: tuple(v.shape) for k, v in _ref_flat(_ref_params(arch)).items()}
    got = {k: tuple(v.shape) for k, v in _port_flat(_port_shapes(arch)).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in _port_flat(_port_shapes(arch)).values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_are_the_reference_s(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    for kw in PARAM_VARIANTS:
        _same_specs(sharding.param_specs(_port_shapes(arch), pmesh, **kw),
                    ref_sharding.param_specs(_ref_params(arch), rmesh, **kw))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_specs_are_the_reference_s(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    for kw in OPT_VARIANTS:
        _same_specs(sharding.opt_specs(_port_shapes(arch), pmesh, **kw),
                    ref_sharding.opt_specs(_ref_params(arch), rmesh, **kw))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_are_the_reference_s(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    cfg = get_arch(arch)
    for B, S in BATCHES:
        tail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        shapes = {"tokens": (B, S) + tail, "targets": (B, S) + tail}
        if cfg.n_patches:
            shapes["patch_embeds"] = (B, cfg.n_patches, cfg.d_model)
        ref = {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in shapes.items()}
        port = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        for include_model in (False, True):
            _same_specs(sharding.batch_specs(port, pmesh, include_model=include_model),
                        ref_sharding.batch_specs(ref, rmesh, include_model=include_model))
    ref_cache = jax.eval_shape(lambda: ref_init_cache(REF_ARCHS[arch], *CACHE))
    port_cache = init_cache(cfg, *CACHE, device="meta")
    assert ({k: tuple(getattr(v, "shape", ())) for k, v in _port_flat(port_cache).items()}
            == {k: tuple(v.shape) for k, v in _ref_flat(ref_cache).items()})
    _same_specs(sharding.cache_specs(port_cache, pmesh),
                ref_sharding.cache_specs(ref_cache, rmesh))


# ------------------------------------------------- the port's parameter tree
def _covers_once(named, shape, sizes):
    """The shards of a leaf over every coordinate of the mesh: each element
    held by the ranks of exactly one distinct shard, and every shard the
    same on ranks that differ only along a ``Replicate`` dim."""
    Replicate = type(torch.distributed.tensor.Replicate())
    dims = list(sizes.values())
    moving = [i for i, p in enumerate(named.placements) if not isinstance(p, Replicate)]
    boxes = set()
    for coord in itertools.product(*(range(dims[i]) for i in moving)):
        full = [0] * len(dims)
        for i, c in zip(moving, coord):
            full[i] = c
        sl = named.local_slices(shape, full)
        for i in range(len(dims)):          # a replicated dim moves nothing
            if i not in moving and dims[i] > 1:
                alt = list(full)
                alt[i] = dims[i] - 1
                assert named.local_slices(shape, alt) == sl
        box = tuple((s.start, s.stop) for s in sl)
        if all(b > a for a, b in box):
            boxes.add(box)
    boxes = sorted(boxes)
    lo = np.array([[a for a, _ in b] for b in boxes]).reshape(len(boxes), -1)
    hi = np.array([[b for _, b in b] for b in boxes]).reshape(len(boxes), -1)
    assert (np.prod(hi - lo, axis=1).sum() == int(np.prod(shape)) if shape else len(boxes) == 1)
    meet = np.all((lo[:, None] < hi[None]) & (lo[None] < hi[:, None]), axis=-1)
    assert meet.sum() == len(boxes)        # only each with itself


def _check_mapping(cfg, spec_tree, pmesh):
    """port_shardings of ``spec_tree``: one placement a port leaf, each
    covering its leaf's reference view once."""
    sizes = sharding.axis_sizes(pmesh)
    port = _port_flat(param_shapes(cfg))
    placed = _port_flat(sharding.port_shardings(cfg, spec_tree, pmesh))
    assert sorted(placed) == sorted(port)
    seen = {}
    for key, named in placed.items():
        assert isinstance(named, sharding.NamedSharding)
        assert len(named.placements) == len(sizes)
        shape = named.view_of(tuple(port[key].shape))
        sig = (shape, named.placements)
        if sig not in seen:
            _covers_once(named, shape, sizes)
            seen[sig] = True


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_shardings_place_every_port_leaf_once(arch, mesh):
    cfg = get_arch(arch)
    _, pmesh = _meshes(mesh)
    shapes = _port_shapes(arch)
    for kw in PARAM_VARIANTS:
        _check_mapping(cfg, sharding.param_specs(shapes, pmesh, **kw), pmesh)
    for kw in OPT_VARIANTS:
        _check_mapping(cfg, sharding.opt_specs(shapes, pmesh, **kw)["master"], pmesh)


def test_qwen2_s_head_dim_fallback_at_16x16_cuts_the_reference_view():
    """14 query heads do not divide 16: the reference cuts head_dim, which
    the port's flat (d, 14 * 64) projection holds as a Shard of its
    (d, 14, 64) view: the reference's elements, a strided cut of the flat
    leaf."""
    cfg = get_arch("qwen2-0.5b")
    _, pmesh = _meshes("16x16")
    specs = sharding.param_specs(_port_shapes("qwen2-0.5b"), pmesh)
    assert specs["layers"]["attn"]["wq"]["w"] == (None, None, None, "model")
    assert specs["layers"]["attn"]["wk"]["b"] == (None, None, "model")
    placed = sharding.port_shardings(cfg, specs, pmesh)
    Shard = torch.distributed.tensor.Shard
    Replicate = torch.distributed.tensor.Replicate
    wq, bk = placed["layers"][5]["attn"]["wq"]["w"], placed["layers"][5]["attn"]["wk"]["b"]
    assert (wq.view, wq.placements) == ((896, 14, 64), (Replicate(), Shard(2)))
    assert (bk.view, bk.placements) == ((2, 64), (Replicate(), Shard(1)))
    w = torch.arange(896 * 896, dtype=torch.float32).reshape(896, 896)
    assert torch.equal(wq.local(w, (7, 3)), w.reshape(896, 14, 64)[:, :, 12:16])
    assert wq.local(w, (7, 3)).data_ptr() == w.data_ptr() + 12 * 4
    b = np.arange(128)
    np.testing.assert_array_equal(bk.local(b, (0, 15)), b.reshape(2, 64)[:, 60:])


def test_zero1_at_data_2_owns_layers_and_halves_the_rest():
    """qwen2-0.5b at (2, 1): the reference's ZeRO-1 cuts the stacked L = 24
    over data, so data rank 0 owns layers 0-11 and rank 1 layers 12-23; the
    embedding, head and final norm are halved along their d dim."""
    cfg = get_arch("qwen2-0.5b")
    _, pmesh = _meshes("2x1")
    master = sharding.opt_specs(_port_shapes("qwen2-0.5b"), pmesh)["master"]
    assert master["embed"]["table"] == ("model", "data")
    assert master["head"]["w"] == ("data", "model")
    assert master["final_ln"]["scale"] == ("data",)
    placed = sharding.port_shardings(cfg, master, pmesh)
    Shard = torch.distributed.tensor.Shard
    Replicate = torch.distributed.tensor.Replicate
    for i, layer in enumerate(placed["layers"]):
        for named in flatten(layer)[1]:
            assert named.placements == (sharding.Own(i // 12), Replicate())
    assert placed["embed"]["table"].placements == (Shard(1), Replicate())
    assert placed["head"]["w"].placements == (Shard(0), Replicate())
    w = torch.arange(896 * 6).reshape(896, 6)
    assert torch.equal(placed["head"]["w"].local(w, (1, 0)), w[448:])
    wq = torch.zeros(896, 896)
    assert placed["layers"][3]["attn"]["wq"]["w"].local(wq, (1, 0)).shape == (0, 14, 64)
    assert placed["layers"][3]["attn"]["wq"]["w"].local(wq, (0, 0)).shape == (896, 896)


def test_p_and_named_mirror_the_reference_s():
    from jax.sharding import PartitionSpec
    for axes in [(), (None,), ("data", None), (("pod", "data"), None),
                 (("data",), "model"), ((), None)]:
        assert sharding.P(*axes) == tuple(PartitionSpec(*axes))
    assert sharding.P("data") != sharding.P("data", None)
    _, pmesh = _meshes("2x16x16")
    Shard = torch.distributed.tensor.Shard
    Replicate = torch.distributed.tensor.Replicate
    got = sharding.named(pmesh, {"a": sharding.P(("pod", "data"), "model"),
                                 "b": sharding.P()})
    assert got["a"].placements == (Shard(0), Shard(0), Shard(1))
    assert got["b"].placements == (Replicate(),) * 3
    assert sharding.data_axes(pmesh) == ("pod", "data")
    # a (pod, data)-cut dim: pod the major
    x = torch.arange(64)
    assert torch.equal(got["a"].local(x[:, None].expand(64, 16), (1, 3, 0))[:, 0],
                       x[32 + 3 * 2:32 + 4 * 2])
