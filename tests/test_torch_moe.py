"""repro_torch.models.moe and the MLA attention against the reference's
on the CPU, on the reference's weights of reduced qwen3-moe-235b-a22b
(GQA, no shared expert) and deepseek-v2-236b (MLA, one shared expert, a
48-wide value head against a 32-wide query/key head) carried across by
``params_from_jax``: the MoE layer's output and aux loss; dispatch and
combine on given picks, bitwise, with assignments dropped at capacity (the
reference's own ``dispatch_one`` and ``combine_one``, taken from its
``moe_forward``); which picks drop (the stable sort); the bfloat16
combine's order of adds; MLA's forward with its compressed cache, its
absorbed decode, and the kernel path both packages refuse.

Tolerances: float32 within 1e-4 and bfloat16 within 5e-2 (the bars of
tests/test_torch_models.py); dispatch and combine bitwise.  Where routing
decides a comparison, each token's k-th router probability must stand
more than ROUTER_MARGIN above its (k+1)-th, so that a flipped pick fails
as its own named check."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]
CASES = [(a, d) for a in ARCHS for d in TOL]
ROUTER_MARGIN = 1e-5


def _cfgs(arch, dtype, **kw):
    kw = dict(dtype=dtype, remat=False, **kw)
    return (ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw),
            configs.reduced_config(configs.ARCHS[arch], **kw))


@pytest.fixture(scope="module")
def layer0():
    """{(arch, dtype): (ref cfg, port cfg, ref layer 0, port layer 0)} of
    the reference's reduced model (key 1), carried across."""
    out = {}
    for arch, dtype in CASES:
        rcfg, tcfg = _cfgs(arch, dtype)
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
        tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
        out[arch, dtype] = (rcfg, tcfg, jax.tree.map(lambda a: a[0], rp["layers"]),
                            tp["layers"][0])
    return out


def _dtypes(dtype):
    return (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                      torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def _bitwise(got, want):
    assert np.array_equal(got.numpy() if got.dtype != torch.bfloat16 else _np(got),
                          np.asarray(want) if want.dtype != jnp.bfloat16 else _np(want))


def router_margin(cfg, router, x) -> float:
    """The smallest gap, over the tokens of x (..., d), between a token's
    k-th and (k+1)-th router probability (the port's float32 router)."""
    probs, _, _ = moe.route({"router": router}, cfg, x.reshape(-1, x.shape[-1]))
    top = torch.topk(probs, cfg.moe_top_k + 1, dim=-1).values
    return float((top[:, -2] - top[:, -1]).min())


def _x(cfg, B, L, seed):
    return np.random.default_rng(seed).normal(size=(B, L, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------ the MoE layer
@pytest.mark.parametrize("arch,dtype", CASES)
def test_moe_forward_and_aux_match_the_reference(layer0, arch, dtype):
    rcfg, tcfg, rlp, tlp = layer0[arch, dtype]
    jdt, tdt = _dtypes(dtype)
    x = _x(rcfg, 2, 16, seed=3)
    tx = torch.as_tensor(x).to(tdt)
    assert router_margin(tcfg, tlp["mlp"]["router"], tx) > ROUTER_MARGIN, \
        "a near-tie in the routing: a pick may flip between the packages"
    want, waux = ref_moe.moe_forward(rlp["mlp"], rcfg, jnp.asarray(x, jdt))
    got, aux = moe.moe_forward(tlp["mlp"], tcfg, tx)
    assert got.dtype == tdt and aux.dtype == torch.float32 and aux.shape == ()
    assert ("shared" in tlp["mlp"]) == (arch == "deepseek-v2-236b")
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def _reference_steps(monkeypatch, rcfg, mlp, x):
    """The reference's ``dispatch_one`` and ``combine_one`` closures of one
    ``moe_forward`` call on x (they close over its T, E and C), taken from
    the ``jax.vmap`` calls that apply them."""
    taken = {}

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def vmap(fn, *a, **kw):
            taken[fn.__name__] = fn
            return jax.vmap(fn, *a, **kw)
    monkeypatch.setattr(ref_moe, "jax", _Jax())
    ref_moe.moe_forward(mlp, rcfg, x)
    monkeypatch.undo()
    return taken["dispatch_one"], taken["combine_one"]


def _picks(T, E, k, rng, hot=None):
    """k distinct experts a token (expert ``hot`` first in every token's
    picks where given) and gates that sum to one."""
    rows = []
    for _ in range(T):
        perm = rng.permutation(E)
        if hot is not None:
            perm = np.concatenate([[hot], perm[perm != hot]])
        rows.append(perm[:k])
    experts = np.stack(rows).astype(np.int32)
    gates = rng.random((T, k)).astype(np.float32)
    return experts, gates / gates.sum(-1, keepdims=True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hot", [None, 0])
def test_dispatch_and_combine_on_given_picks_are_bitwise_the_reference_s(
        layer0, monkeypatch, arch, hot):
    """At a capacity that drops: the reference's dispatch_one and
    combine_one and the port's on the same picks (uniform, or every token
    picking expert 0), float32, bitwise."""
    rcfg, tcfg, rlp, tlp = layer0[arch, "float32"]
    rcfg, tcfg = (dataclasses.replace(c, capacity_factor=0.5) for c in (rcfg, tcfg))
    B, L, E, k = 2, 16, tcfg.n_experts, tcfg.moe_top_k
    T, C = B * L, moe.capacity(tcfg, B * L)
    assert C == max(int(T * k * 0.5 / E), 4) == 8
    x = _x(rcfg, B, L, seed=4)
    dispatch_one, combine_one = _reference_steps(monkeypatch, rcfg, rlp["mlp"],
                                                 jnp.asarray(x))
    rng = np.random.default_rng(5)
    experts, gates = _picks(T, E, k, rng, hot)
    xt = x.reshape(T, -1)
    want_buf, want_meta = dispatch_one(jnp.asarray(xt), jnp.asarray(experts),
                                       jnp.asarray(gates))
    got_buf, got_meta = moe.dispatch(torch.as_tensor(xt), torch.as_tensor(experts).long(),
                                     torch.as_tensor(gates), E, C)
    keep = got_meta[3].numpy()
    assert 0 < (~keep).sum(), "no pick dropped: the capacity does not bind"
    assert tuple(got_buf.shape) == want_buf.shape == (E, C, rcfg.d_model)
    _bitwise(got_buf, want_buf)
    for g, w in zip(got_meta, want_meta):
        _bitwise(g, w)
    y = rng.normal(size=(E, C, rcfg.d_model)).astype(np.float32)
    _bitwise(moe.combine(torch.as_tensor(y), got_meta, T),
             combine_one(jnp.asarray(y), want_meta))


def test_over_capacity_the_later_tokens_of_an_expert_drop(layer0, monkeypatch):
    """The stable-sort trap: 512 tokens all pick experts 0 and 1 (one
    key repeated 512 times), so any order of equal keys but the original
    one keeps other tokens.  The kept picks are the reference's: each
    expert's first C tokens."""
    rcfg, tcfg, rlp, _ = layer0["qwen3-moe-235b-a22b", "float32"]
    B, L, E = 4, 128, tcfg.n_experts
    T, C = B * L, moe.capacity(tcfg, B * L)
    x = _x(rcfg, B, L, seed=6)
    dispatch_one, _ = _reference_steps(monkeypatch, rcfg, rlp["mlp"], jnp.asarray(x))
    experts = np.tile(np.array([[1, 0]], np.int32), (T, 1))
    experts[::3] = experts[::3, ::-1]
    gates = np.full((T, 2), 0.5, np.float32)
    xt = x.reshape(T, -1)
    _, (_, want_t, _, want_keep) = dispatch_one(jnp.asarray(xt), jnp.asarray(experts),
                                                jnp.asarray(gates))
    _, (_, got_t, _, got_keep) = moe.dispatch(torch.as_tensor(xt),
                                              torch.as_tensor(experts).long(),
                                              torch.as_tensor(gates), E, C)
    assert got_keep.sum() == 2 * C < 2 * T
    assert np.array_equal(got_keep.numpy(), np.asarray(want_keep))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    kept = got_t[got_keep].reshape(2, C)
    assert torch.equal(kept, torch.arange(C).expand(2, C))


def test_the_bf16_combine_adds_in_the_reference_s_order(layer0, monkeypatch):
    """In bfloat16 the order of a token's adds shows in the bits (with
    three picks a token: two commute): the port's combine equals the
    reference's scatter-add bitwise, and adding in descending expert id
    instead differs."""
    rcfg, tcfg, rlp, _ = layer0["deepseek-v2-236b", "bfloat16"]
    rcfg, tcfg = (dataclasses.replace(c, moe_top_k=3) for c in (rcfg, tcfg))
    B, L, E, k = 2, 16, tcfg.n_experts, tcfg.moe_top_k
    T, C = B * L, moe.capacity(tcfg, B * L)
    x = _x(rcfg, B, L, seed=7)
    _, combine_one = _reference_steps(monkeypatch, rcfg, rlp["mlp"],
                                      jnp.asarray(x, jnp.bfloat16))
    rng = np.random.default_rng(8)
    experts, gates = _picks(T, E, k, rng)
    _, meta = moe.dispatch(torch.as_tensor(x.reshape(T, -1)).bfloat16(),
                           torch.as_tensor(experts).long(), torch.as_tensor(gates), E, C)
    # magnitudes far apart, so that the first add's rounding shows
    y = (rng.normal(size=(E, C, rcfg.d_model))
         * 10.0 ** rng.integers(-3, 3, size=(E, 1, 1))).astype(np.float32)
    ty = torch.as_tensor(y).bfloat16()
    got = moe.combine(ty, meta, T)
    want = combine_one(jnp.asarray(y, jnp.bfloat16),
                       tuple(jnp.asarray(m.numpy()) for m in meta))
    assert got.dtype == torch.bfloat16
    _bitwise(got, want)
    rev = moe.combine(ty, tuple(m.flip(0) for m in meta), T)
    assert not torch.equal(rev, got)


# ---------------------------------------------------------------------- MLA
@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_forward_and_compressed_cache_match_the_reference(layer0, dtype):
    rcfg, tcfg, rlp, tlp = layer0["deepseek-v2-236b", dtype]
    jdt, tdt = _dtypes(dtype)
    assert (tcfg.qk_nope_dim + tcfg.qk_rope_dim, tcfg.v_head_dim) == (32, 48)
    B, L = 2, 20
    x = _x(rcfg, B, L, seed=9)
    pos = np.tile(np.arange(L), (B, 1))
    want, (wc, wr) = ref_attn.mla_forward(rlp["attn"], rcfg, jnp.asarray(x, jdt),
                                          jnp.asarray(pos), "xla", return_kv=True)
    got, (gc, gr) = attention.mla_forward(tlp["attn"], tcfg, torch.as_tensor(x).to(tdt),
                                          torch.as_tensor(pos), "torch", return_kv=True)
    assert tuple(gc.shape) == wc.shape == (B, L, tcfg.kv_lora_rank)
    assert tuple(gr.shape) == wr.shape == (B, L, tcfg.qk_rope_dim)
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        assert g.dtype == tdt
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", list(TOL))
def test_mla_decode_writes_the_cache_and_matches_the_reference(layer0, dtype):
    rcfg, tcfg, rlp, tlp = layer0["deepseek-v2-236b", dtype]
    jdt, tdt = _dtypes(dtype)
    rng = np.random.default_rng(10)
    B, S, pos = 2, 12, 5
    x = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
    before = {"c_kv": rng.normal(size=(B, S, rcfg.kv_lora_rank)).astype(np.float32),
              "k_rope": rng.normal(size=(B, S, rcfg.qk_rope_dim)).astype(np.float32)}
    want, wcache = ref_attn.mla_decode(rlp["attn"], rcfg, jnp.asarray(x, jdt),
                                       {n: jnp.asarray(a, jdt) for n, a in before.items()},
                                       jnp.asarray(pos, jnp.int32))
    cache = {n: torch.as_tensor(a).to(tdt) for n, a in before.items()}
    got, gcache = attention.mla_decode(tlp["attn"], tcfg, torch.as_tensor(x).to(tdt),
                                       cache, pos)
    assert gcache is cache and got.dtype == tdt
    _close(got, want, dtype)
    for name in ("c_kv", "k_rope"):
        _close(gcache[name], wcache[name], dtype)
        # only position pos was written
        keep = np.delete(np.arange(S), pos)
        _bitwise(gcache[name][:, keep], jnp.asarray(before[name], jdt)[:, keep])


def test_mla_refuses_the_kernel_path_as_the_reference_does(layer0):
    """MLA's 32-wide query/key and 48-wide value heads: the port raises a
    ValueError naming attn_impl="torch" before any kernel runs; the
    reference's Pallas path fails on the same shapes."""
    rcfg, tcfg, rlp, tlp = layer0["deepseek-v2-236b", "float32"]
    x = _x(rcfg, 2, 16, seed=11)
    pos = np.tile(np.arange(16), (2, 1))
    with pytest.raises(ValueError, match='attn_impl="torch"'):
        attention.mla_forward(tlp["attn"], tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                              "cuda")
    with pytest.raises(TypeError, match="reshape"):
        ref_attn.mla_forward(rlp["attn"], rcfg, jnp.asarray(x), jnp.asarray(pos), "pallas")
    tp = models.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='attn_impl="torch"'):
        models.prefill(tcfg, tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                       attn_impl="cuda")


# ------------------------------------------------------------ dispatch groups
def _reference_grouped(monkeypatch, rcfg, mlp, x, G):
    """The reference's ``moe_forward`` on x (B, L, d) under an abstract
    mesh of G data shards (its dispatch groups), jitted (its sharding
    constraints need a traced program), with its ``dispatch_one`` closure
    (over that call's Tg and C)."""
    from repro.sharding import compat_abstract_mesh
    taken = {}

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def vmap(fn, *a, **kw):
            taken[fn.__name__] = fn
            return jax.vmap(fn, *a, **kw)
    monkeypatch.setattr(ref_moe, "jax", _Jax())
    with jax.sharding.use_abstract_mesh(compat_abstract_mesh((G,), ("data",))):
        assert ref_moe._dispatch_groups(rcfg) == G
        out, aux = jax.jit(lambda p, x: ref_moe.moe_forward(p, rcfg, x))(mlp, x)
    monkeypatch.undo()
    return out, aux, taken["dispatch_one"]


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_matches_the_reference_s_groups(layer0, monkeypatch, arch, G):
    """G dispatch groups (a mesh of G data shards) at a capacity that drops,
    float32: each group's picks and which of them drop are the reference's
    (its ``dispatch_one`` on the group), the layer's output is within 1e-5
    of the reference's grouped layer, and the aux loss, over all the
    groups' picks and probabilities, within 1e-6 (float32 sums in another
    order)."""
    from repro_torch.sharding import compat_abstract_mesh
    rcfg, tcfg, rlp, tlp = layer0[arch, "float32"]
    rcfg, tcfg = (dataclasses.replace(c, capacity_factor=0.5) for c in (rcfg, tcfg))
    B, L, E, k = 4, 16, tcfg.n_experts, tcfg.moe_top_k
    T, Tg = B * L, B * L // G
    x = _x(rcfg, B, L, seed=11)
    tx = torch.as_tensor(x)
    assert router_margin(tcfg, tlp["mlp"]["router"], tx) > ROUTER_MARGIN
    want, waux, dispatch_one = _reference_grouped(monkeypatch, rcfg, rlp["mlp"],
                                                  jnp.asarray(x), G)
    mesh = compat_abstract_mesh((G,), ("data",))
    assert moe.dispatch_groups(mesh, T) == G
    got, aux = moe.moe_forward(tlp["mlp"], tcfg, tx, mesh=mesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    # the picks and drops, group by group
    probs, gates, experts = moe.route(tlp["mlp"], tcfg, tx.reshape(T, -1))
    r_probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ rlp["mlp"]["router"]["w"], -1)
    r_gates, r_experts = jax.lax.top_k(r_probs, k)
    assert np.array_equal(experts.numpy(), np.asarray(r_experts))
    C = moe.capacity(tcfg, Tg)
    dropped = 0
    for g in range(G):
        rows = slice(g * Tg, (g + 1) * Tg)
        _, meta = moe.dispatch(tx.reshape(T, -1)[rows], experts[rows], gates[rows], E, C)
        _, (w_slot, w_t, _, w_keep) = dispatch_one(
            jnp.asarray(x.reshape(T, -1)[rows]), r_experts[rows],
            r_gates[rows] / r_gates[rows].sum(-1, keepdims=True))
        assert np.array_equal(meta[3].numpy(), np.asarray(w_keep))
        assert np.array_equal(meta[1].numpy(), np.asarray(w_t))
        assert np.array_equal(meta[0].numpy(), np.asarray(w_slot))
        dropped += int((~meta[3]).sum())
    assert dropped, "no pick dropped: the capacity does not bind"


def test_one_group_keeps_the_ungrouped_layer_s_bits(layer0):
    """G = 1 (no mesh, or a mesh of one data shard) is the layer as it was:
    bitwise in bfloat16, the combine's order of adds included."""
    from repro_torch.sharding import compat_abstract_mesh
    _, tcfg, _, tlp = layer0["deepseek-v2-236b", "bfloat16"]
    tx = torch.as_tensor(_x(tcfg, 2, 16, seed=12)).to(torch.bfloat16)
    base, base_aux = moe.moe_forward(tlp["mlp"], tcfg, tx)
    one, one_aux = moe.moe_forward(tlp["mlp"], tcfg, tx,
                                   mesh=compat_abstract_mesh((1, 4), ("data", "model")))
    assert torch.equal(base, one) and torch.equal(base_aux, one_aux)
    assert moe.dispatch_groups(None, 32) == 1
    assert moe.dispatch_groups(compat_abstract_mesh((2, 4, 2), ("pod", "data", "model")), 32) == 8
    assert moe.dispatch_groups(compat_abstract_mesh((16, 16), ("data", "model")), 24) == 8
