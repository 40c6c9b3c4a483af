"""repro_torch's LM serving path against repro.models on the CPU: configs,
layers, GQA attention, forward/prefill, decode and greedy generation on the
reduced qwen2-0.5b (MQA at reduced width) and a GQA variant (two KV heads),
on the state-space families, reduced falcon-mamba-7b (Mamba1) and
zamba2-1.2b (Mamba2 with its shared GQA block), and on the MoE families,
reduced qwen3-moe-235b-a22b (GQA) and deepseek-v2-236b (MLA, a shared
expert), with the reference's weights carried across by
``params_from_jax``.

Tolerances: float32 within 1e-4 on logits and equal tokens; bfloat16
within 5e-2 (the port follows the reference's dtype promotions; what is
left is the order of the sums and bfloat16's last bit)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.launch.serve import generate as ref_generate  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
VARIANTS = {"mqa": {}, "gqa": {"n_kv_heads": 2}}
CASES = [(v, d) for v in VARIANTS for d in TOL]


def _cfgs(variant, dtype):
    kw = dict(VARIANTS[variant], dtype=dtype, remat=False)
    return (ref_configs.reduced_config(ref_configs.ARCHS["qwen2-0.5b"], **kw),
            configs.reduced_config(configs.ARCHS["qwen2-0.5b"], **kw))


@pytest.fixture(scope="module")
def models_by_case():
    """{(variant, dtype): (ref cfg, port cfg, ref params, port params)}, the
    reference's weights from one key, carried across."""
    out = {}
    for variant, dtype in CASES:
        rcfg, tcfg = _cfgs(variant, dtype)
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
        tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
        out[variant, dtype] = (rcfg, tcfg, rp, tp)
    return out


def _tokens(vocab, B, L, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


# ------------------------------------------------------------------ configs
def test_archs_and_shapes_equal_the_reference_field_for_field():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        ref = ref_configs.ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert dataclasses.asdict(configs.reduced_config(cfg)) == \
            dataclasses.asdict(ref_configs.reduced_config(ref))
        assert dataclasses.asdict(configs.reduced_config(cfg, n_kv_heads=2)) == \
            dataclasses.asdict(ref_configs.reduced_config(ref, n_kv_heads=2))
    assert configs.SHAPES == ref_configs.SHAPES
    assert configs.runnable_cells() == ref_configs.runnable_cells()
    assert configs.get_shape("prefill_32k") == ref_configs.get_shape("prefill_32k")
    with pytest.raises(KeyError):
        configs.get_arch("gpt-5")


def test_qwen2_full_width_is_the_served_model():
    cfg = configs.get_arch("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.qkv_bias) == (24, 896, 14, 2, 64, 4864,
                                                    151936, True)
    assert cfg.hd in fa_kernel.HEAD_DIMS


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", list(TOL))
def test_layers_match_the_reference(dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 5, 32)).astype(np.float32)
    scale = rng.normal(size=32).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 1, 5))
    w = rng.normal(size=(32, 4, 8)).astype(np.float32) * 0.2
    b = rng.normal(size=(4, 8)).astype(np.float32)
    mlp = {n: rng.normal(size=s).astype(np.float32) * 0.1
           for n, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    table = rng.normal(size=(50, 32)).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 7))

    def J(a):
        return jnp.asarray(a, jdt)

    def T(a):
        return torch.as_tensor(a).to(tdt)

    _close(layers.rms_norm({"scale": T(scale)}, T(x), 1e-5),
           ref_layers.rms_norm({"scale": J(scale)}, J(x), 1e-5), dtype)
    _close(layers.rope(T(x), torch.as_tensor(pos), 1e4),
           ref_layers.rope(J(x), jnp.asarray(pos), 1e4), dtype)
    got = layers.linear({"w": T(w.reshape(32, -1)), "b": T(b.reshape(-1))}, T(x))
    want = ref_layers.linear({"w": J(w), "b": J(b)}, J(x))
    _close(got.reshape(want.shape), want, dtype)
    _close(layers.swiglu({n: {"w": T(a)} for n, a in mlp.items()}, T(x)),
           ref_layers.swiglu({n: {"w": J(a)} for n, a in mlp.items()}, J(x)), dtype)
    assert torch.equal(layers.embed({"table": T(table)}, torch.as_tensor(toks)),
                       T(np.array(ref_layers.embed({"table": J(table)},
                                                   jnp.asarray(toks)), np.float32)))


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("variant,dtype", CASES)
@pytest.mark.parametrize("impl,ref_impl", [("torch", "xla"), ("cuda", "pallas")])
def test_gqa_forward_matches_the_reference(models_by_case, variant, dtype, impl,
                                           ref_impl):
    rcfg, tcfg, rp, tp = models_by_case[variant, dtype]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = np.random.default_rng(8).normal(size=(2, 20, rcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20), (2, 1))
    rlp = jax.tree.map(lambda a: a[0], rp["layers"])
    want, (wk, wv) = ref_attn.gqa_forward(rlp["attn"], rcfg, jnp.asarray(x, jdt),
                                          jnp.asarray(pos), ref_impl, return_kv=True)
    got, (gk, gv) = attention.gqa_forward(
        tp["layers"][0]["attn"], tcfg, torch.as_tensor(x).to(tp["embed"]["table"].dtype),
        torch.as_tensor(pos), impl, return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert g.dtype == tp["embed"]["table"].dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("variant,dtype", CASES)
def test_gqa_decode_matches_the_reference(models_by_case, variant, dtype):
    rcfg, tcfg, rp, tp = models_by_case[variant, dtype]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = tp["embed"]["table"].dtype
    rng = np.random.default_rng(9)
    S, pos = 12, 5
    x = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, rcfg.n_kv_heads, S, rcfg.hd)).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[0], rp["layers"])
    want, wc = ref_attn.gqa_decode(rlp["attn"], rcfg, jnp.asarray(x, jdt),
                                   {"k": jnp.asarray(ck, jdt), "v": jnp.asarray(cv, jdt)},
                                   jnp.asarray(pos, jnp.int32))
    cache = {"k": torch.as_tensor(ck).to(tdt), "v": torch.as_tensor(cv).to(tdt)}
    got, gc = attention.gqa_decode(tp["layers"][0]["attn"], tcfg,
                                   torch.as_tensor(x).to(tdt), cache, pos)
    assert gc is cache
    _close(got, want, dtype)
    for name in ("k", "v"):
        _close(gc[name], wc[name], dtype)


def test_attention_selection_pins_the_cpu_or_raises():
    assert attention.resolve_attn_impl("torch") == "torch"
    assert attention.resolve_attn_impl("cuda") == "cuda"
    with pytest.raises(ValueError, match="attn_impl"):
        attention.resolve_attn_impl("xla")
    if torch.cuda.is_available():
        assert attention.resolve_attn_impl(None) == "cuda"
    else:
        with pytest.raises(RuntimeError, match="attn_impl='torch'"):
            attention.resolve_attn_impl(None)


# ------------------------------------------------------- forward / prefill
@pytest.mark.parametrize("variant,dtype", CASES)
@pytest.mark.parametrize("impl,ref_impl", [("torch", "xla"), ("cuda", "pallas")])
def test_forward_and_prefill_match_the_reference(models_by_case, variant, dtype,
                                                 impl, ref_impl):
    rcfg, tcfg, rp, tp = models_by_case[variant, dtype]
    toks = _tokens(rcfg.vocab, 2, 24)
    want, waux = ref_models.forward(rcfg, rp, {"tokens": jnp.asarray(toks)},
                                    attn_impl=ref_impl)
    got, aux = models.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                              attn_impl=impl)
    assert got.shape == (2, 24, rcfg.vocab) and got.dtype == tp["head"]["w"].dtype
    assert float(aux) == float(waux) == 0.0
    _close(got, want, dtype)
    pre, _ = models.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)}, attn_impl=impl)
    assert torch.equal(pre, got)


def test_forward_without_a_card_raises_unless_the_cpu_is_pinned(models_by_case):
    _, tcfg, _, tp = models_by_case["mqa", "float32"]
    batch = {"tokens": torch.as_tensor(_tokens(tcfg.vocab, 1, 4))}
    if torch.cuda.is_available():
        pytest.skip("a card is present: attn_impl=None runs the kernel")
    with pytest.raises(RuntimeError, match="attn_impl='torch'"):
        models.prefill(tcfg, tp, batch)
    with pytest.raises(RuntimeError, match="attn_impl='torch'"):
        models.Model(tcfg).apply(tp, batch)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("variant,dtype", CASES)
def test_decode_steps_and_cache_match_the_reference(models_by_case, variant, dtype):
    rcfg, tcfg, rp, tp = models_by_case[variant, dtype]
    B, L = 2, 10
    toks = _tokens(rcfg.vocab, B, L, seed=1)
    rc = ref_models.init_cache(rcfg, B, L)
    tc = models.init_cache(tcfg, B, L)
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == rc["layers"][name].shape
        assert tc["layers"][name].dtype == tp["embed"]["table"].dtype
    assert tc["pos"] == int(rc["pos"]) == 0
    dec = jax.jit(lambda p, c, b: ref_models.decode_step(rcfg, p, c, b))
    for t in range(L):
        want, rc = dec(rp, rc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, tc2 = models.decode_step(tcfg, tp, tc, {"tokens": torch.as_tensor(toks[:, t:t + 1])})
        assert tc2 is tc and tc["pos"] == int(rc["pos"]) == t + 1
        _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc["layers"][name], rc["layers"][name], dtype)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_prefill_in_float32(models_by_case, variant):
    """The reference's own bar (tests/test_models_smoke.py): teacher-forced
    decode equals the full forward within 2e-3, here through the kernel's
    plain version."""
    _, tcfg, _, tp = models_by_case[variant, "float32"]
    B, L = 2, 10
    toks = torch.as_tensor(_tokens(tcfg.vocab, B, L, seed=2))
    full, _ = models.prefill(tcfg, tp, {"tokens": toks}, attn_impl="cuda")
    cache = models.init_cache(tcfg, B, L)
    steps = [models.decode_step(tcfg, tp, cache, {"tokens": toks[:, t:t + 1]})[0][:, 0]
             for t in range(L)]
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full),
                               rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------- generate
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_equals_the_reference_token_for_token(models_by_case, variant):
    rcfg, tcfg, rp, tp = models_by_case[variant, "float32"]
    prompts = _tokens(rcfg.vocab, 3, 8, seed=3)
    want = ref_generate(rcfg, rp, prompts, 12, greedy=True)
    got = serve.generate(tcfg, tp, prompts, 12, greedy=True)
    assert got.dtype == np.int32 and got.shape == (3, 20)
    assert np.array_equal(got, want)


def test_sampled_generate_is_seeded(models_by_case):
    _, tcfg, _, tp = models_by_case["gqa", "bfloat16"]
    prompts = _tokens(tcfg.vocab, 2, 4, seed=4)
    a = serve.generate(tcfg, tp, prompts, 6, temperature=0.8, seed=5)
    assert np.array_equal(a, serve.generate(tcfg, tp, prompts, 6, temperature=0.8, seed=5))
    assert np.array_equal(a[:, :4], prompts)
    assert ((a >= 0) & (a < tcfg.vocab)).all()


def test_serve_cli_runs_on_a_pinned_cpu_and_raises_without_a_card(capsys):
    serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "2"])
    assert "generated (2, 5)" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI serves on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "qwen2-0.5b", "--reduced"])


# --------------------------------------------------------- port's own init
def test_port_init_params_has_the_converted_layout_and_is_seeded(models_by_case):
    _, tcfg, _, tp = models_by_case["gqa", "bfloat16"]
    gen = torch.Generator().manual_seed(0)
    mine = models.init_params(tcfg, gen)
    flat = jax.tree_util.tree_flatten_with_path
    shapes = [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype) for p, x in flat(mine)[0]]
    assert shapes == [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype)
                      for p, x in flat(tp)[0]]
    again = models.init_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(mine),
                                                 jax.tree.leaves(again)))
    # truncated at two standard deviations of each weight's scale
    w = mine["layers"][0]["attn"]["wq"]["w"].float()
    assert w.abs().max() <= 2 * tcfg.d_model ** -0.5 * (1 + 2 ** -7)
    assert torch.equal(mine["layers"][0]["attn"]["wq"]["b"],
                       torch.zeros_like(mine["layers"][0]["attn"]["wq"]["b"]))
    f32 = models.cast_params(mine, torch.float32)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(f32))


@pytest.mark.parametrize("arch", ["musicgen-medium", "pixtral-12b"])
def test_other_families_wait_for_their_slice(arch):
    cfg = configs.reduced_config(configs.ARCHS[arch])
    with pytest.raises(NotImplementedError, match="slice"):
        models.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="slice"):
        models.init_cache(cfg, 1, 4)


# ------------------------------------------------- the state-space families
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
SSM_CASES = [(a, d) for a in SSM_ARCHS for d in TOL]
# falcon has no attention, so only zamba2's shared block takes both pairs
SSM_IMPLS = [("falcon-mamba-7b", "torch", "xla"), ("zamba2-1.2b", "torch", "xla"),
             ("zamba2-1.2b", "cuda", "pallas")]


@pytest.fixture(scope="module")
def ssm_models():
    """{(arch, dtype): (ref cfg, port cfg, ref params, port params)} of the
    reduced SSM archs, the reference's weights (key 1) carried across."""
    out = {}
    for arch, dtype in SSM_CASES:
        kw = dict(dtype=dtype, remat=False)
        rcfg = ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw)
        tcfg = configs.reduced_config(configs.ARCHS[arch], **kw)
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
        out[arch, dtype] = (rcfg, tcfg, rp,
                            models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp)))
    return out


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch,impl,ref_impl", SSM_IMPLS)
def test_ssm_forward_and_prefill_match_the_reference(ssm_models, arch, dtype, impl,
                                                     ref_impl):
    rcfg, tcfg, rp, tp = ssm_models[arch, dtype]
    toks = _tokens(rcfg.vocab, 2, 24)
    want, waux = ref_models.forward(rcfg, rp, {"tokens": jnp.asarray(toks)},
                                    attn_impl=ref_impl)
    got, aux = models.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                              attn_impl=impl)
    assert got.shape == (2, 24, rcfg.vocab) and got.dtype == tp["head"]["w"].dtype
    assert float(aux) == float(waux) == 0.0
    _close(got, want, dtype)
    pre, _ = models.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)}, attn_impl=impl)
    assert torch.equal(pre, got)


def test_zamba2_shared_block_runs_every_attn_every_layers(ssm_models, monkeypatch):
    """One shared block, applied after layers attn_every - 1, 2·attn_every - 1,
    ... with one set of weights; without a card and a pin it raises."""
    _, tcfg, _, tp = ssm_models["zamba2-1.2b", "float32"]
    cfg = dataclasses.replace(tcfg, n_layers=5)
    params = dict(tp, layers=[tp["layers"][i % 2] for i in range(5)])
    calls = []
    real = attention.gqa_forward
    monkeypatch.setattr(attention, "gqa_forward",
                        lambda p, *a, **k: calls.append(p) or real(p, *a, **k))
    batch = {"tokens": torch.as_tensor(_tokens(cfg.vocab, 1, 6))}
    models.forward(cfg, params, batch, attn_impl="torch")
    assert len(calls) == 5 // cfg.attn_every == 2
    assert all(c is tp["shared_attn"] for c in calls)
    cache = models.init_cache(cfg, 1, 6)
    assert tuple(cache["shared"]["k"].shape) == (2, 1, cfg.n_kv_heads, 6, cfg.hd)
    if torch.cuda.is_available():
        pytest.skip("a card is present: attn_impl=None runs the kernel")
    with pytest.raises(RuntimeError, match="attn_impl='torch'"):
        models.prefill(tcfg, tp, batch)


@pytest.mark.parametrize("arch,dtype", SSM_CASES)
def test_ssm_decode_steps_and_cache_match_the_reference(ssm_models, arch, dtype):
    rcfg, tcfg, rp, tp = ssm_models[arch, dtype]
    B, L = 2, 10
    toks = _tokens(rcfg.vocab, B, L, seed=1)
    rc = ref_models.init_cache(rcfg, B, L)
    tc = models.init_cache(tcfg, B, L)
    state = "h" if rcfg.mamba_version == 1 else "S"
    assert sorted(tc["layers"]) == sorted(rc["layers"]) == sorted(["conv", state])
    assert ("shared" in tc) == ("shared" in rc) == (arch == "zamba2-1.2b")
    def pairs(rc, tc):
        """(port leaf, reference leaf) of the two caches, by path."""
        flat = jax.tree_util.tree_flatten_with_path
        want = {jax.tree_util.keystr(k): a for k, a in flat(rc)[0]}
        got = flat({n: v for n, v in tc.items() if n != "pos"})[0]
        assert len(got) == len(want) - 1
        return [(t, want[jax.tree_util.keystr(k)]) for k, t in got]

    for t, w in pairs(rc, tc):
        assert tuple(t.shape) == w.shape and str(t.dtype).split(".")[1] == str(w.dtype)
    dec = jax.jit(lambda p, c, b: ref_models.decode_step(rcfg, p, c, b))
    for t in range(L):
        want, rc = dec(rp, rc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, tc2 = models.decode_step(tcfg, tp, tc, {"tokens": torch.as_tensor(toks[:, t:t + 1])})
        assert tc2 is tc and tc["pos"] == int(rc["pos"]) == t + 1
        _close(got, want, dtype)
    for t, w in pairs(rc, tc):
        _close(t, w, dtype)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_matches_prefill_in_float32(ssm_models, arch):
    """The reference's own bar (tests/test_models_smoke.py): teacher-forced
    decode equals the full forward within 2e-3 (zamba2's shared block
    through the kernel's plain version)."""
    _, tcfg, _, tp = ssm_models[arch, "float32"]
    B, L = 2, 10
    toks = torch.as_tensor(_tokens(tcfg.vocab, B, L, seed=2))
    full, _ = models.prefill(tcfg, tp, {"tokens": toks}, attn_impl="cuda")
    cache = models.init_cache(tcfg, B, L)
    steps = [models.decode_step(tcfg, tp, cache, {"tokens": toks[:, t:t + 1]})[0][:, 0]
             for t in range(L)]
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_greedy_generate_equals_the_reference_token_for_token(ssm_models, arch):
    rcfg, tcfg, rp, tp = ssm_models[arch, "float32"]
    prompts = _tokens(rcfg.vocab, 3, 8, seed=3)
    want = ref_generate(rcfg, rp, prompts, 12, greedy=True)
    got = serve.generate(tcfg, tp, prompts, 12, greedy=True)
    assert got.dtype == np.int32 and got.shape == (3, 20)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_port_init_params_has_the_converted_layout_and_dtypes(ssm_models, arch):
    """The port's own init: the converted tree's paths, shapes and dtypes
    (A_log, D and dt_bias float32 in a bfloat16 model), seeded."""
    _, tcfg, _, tp = ssm_models[arch, "bfloat16"]
    mine = models.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path
    shapes = [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype) for p, x in flat(mine)[0]]
    assert shapes == [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype)
                      for p, x in flat(tp)[0]]
    f32 = {"A_log", "D", "dt_bias"}
    for k, _, dt in shapes:
        name = k.split("[")[-1].strip("]'")
        assert dt == (torch.float32 if name in f32 else torch.bfloat16), k
    assert sum(name.endswith("['A_log']") for name, _, _ in shapes) == tcfg.n_layers
    again = models.init_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(mine),
                                                 jax.tree.leaves(again)))
    assert ("shared_attn" in mine) == (arch == "zamba2-1.2b")


def test_ssm_serve_cli_runs_on_a_pinned_cpu(capsys):
    serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "arch=falcon-mamba-7b" in out and "generated (2, 5)" in out


# ---------------------------------------------------------- the MoE families
MOE_ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v2-236b"]
MOE_CASES = [(a, d) for a in MOE_ARCHS for d in TOL]
# MLA's mixed head sizes run on the plain attention only, in both packages
MOE_IMPLS = [("qwen3-moe-235b-a22b", "torch", "xla"),
             ("qwen3-moe-235b-a22b", "cuda", "pallas"),
             ("deepseek-v2-236b", "torch", "xla")]
# each token's k-th router probability above its (k+1)-th, in every layer,
# so that a pick flipped between the packages fails as its own check
ROUTER_MARGIN = 1e-5


@pytest.fixture(scope="module")
def moe_models():
    """{(arch, dtype): (ref cfg, port cfg, ref params, port params)} of the
    reduced MoE archs, the reference's weights (key 1) carried across."""
    out = {}
    for arch, dtype in MOE_CASES:
        kw = dict(dtype=dtype, remat=False)
        rcfg = ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw)
        tcfg = configs.reduced_config(configs.ARCHS[arch], **kw)
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
        out[arch, dtype] = (rcfg, tcfg, rp,
                            models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp)))
    return out


@contextlib.contextmanager
def _router_gaps(monkeypatch):
    """Yields a list that receives, for each MoE layer run inside, the
    smallest gap between a token's k-th and (k+1)-th router probability."""
    from repro_torch.models import moe
    real, gaps = moe.route, []

    def route(p, c, xt):
        out = real(p, c, xt)
        top = torch.topk(out[0], c.moe_top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return out
    monkeypatch.setattr(moe, "route", route)
    yield gaps
    monkeypatch.undo()


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch,impl,ref_impl", MOE_IMPLS)
def test_moe_forward_and_prefill_match_the_reference(moe_models, monkeypatch, arch,
                                                     dtype, impl, ref_impl):
    """Against the reference's forward run op by op (``unroll=True``): its
    scan compiles the layer body, where XLA fuses bfloat16 chains in
    float32 without the roundings between ops that its unrolled forward and
    the port make; on the Pallas path reduced qwen3-moe's scanned forward
    flips a pick against its own unrolled one (its logits then stand
    beyond the 5e-2 bar)."""
    rcfg, tcfg, rp, tp = moe_models[arch, dtype]
    toks = _tokens(rcfg.vocab, 2, 24)
    want, waux = ref_models.forward(rcfg, rp, {"tokens": jnp.asarray(toks)},
                                    attn_impl=ref_impl, unroll=True)
    with _router_gaps(monkeypatch) as gaps:
        got, aux = models.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                                  attn_impl=impl)
    assert len(gaps) == tcfg.n_layers and min(gaps) > ROUTER_MARGIN, \
        f"a near-tie in the routing, a pick may flip between the packages: {gaps}"
    assert got.shape == (2, 24, rcfg.vocab) and got.dtype == tp["head"]["w"].dtype
    assert aux.dtype == torch.float32 and float(aux) > 0
    # the aux loss: the loss's bar in float32, the logits' in bfloat16 (the
    # router reads the bfloat16 hidden states)
    np.testing.assert_allclose(float(aux), float(waux),
                               rtol=1e-5 if dtype == "float32" else TOL[dtype])
    _close(got, want, dtype)
    pre, pre_aux = models.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                                  attn_impl=impl)
    assert torch.equal(pre, got) and torch.equal(pre_aux, aux)


@pytest.mark.parametrize("arch,dtype", MOE_CASES)
def test_moe_decode_steps_and_cache_match_the_reference(moe_models, monkeypatch, arch,
                                                        dtype):
    """Against the reference's decode step run op by op (``unroll=True``,
    not jitted): under ``jax.jit`` XLA fuses bfloat16 chains in float32
    without the roundings between ops that the eager reference and the port
    make, and reduced deepseek-v2's jitted step 6 flips a pick against the
    eager reference's own (beyond the 5e-2 bar)."""
    rcfg, tcfg, rp, tp = moe_models[arch, dtype]
    B, L = 2, 10
    toks = _tokens(rcfg.vocab, B, L, seed=1)
    rc = ref_models.init_cache(rcfg, B, L)
    tc = models.init_cache(tcfg, B, L)
    names = ["c_kv", "k_rope"] if arch == "deepseek-v2-236b" else ["k", "v"]
    assert sorted(tc["layers"]) == sorted(rc["layers"]) == sorted(names)
    for name in names:
        assert tuple(tc["layers"][name].shape) == rc["layers"][name].shape
        assert tc["layers"][name].dtype == tp["embed"]["table"].dtype
    for t in range(L):
        want, rc = ref_models.decode_step(rcfg, rp, rc,
                                          {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                          unroll=True)
        with _router_gaps(monkeypatch) as gaps:
            got, tc2 = models.decode_step(tcfg, tp, tc,
                                          {"tokens": torch.as_tensor(toks[:, t:t + 1])})
        assert min(gaps) > ROUTER_MARGIN, f"a near-tie in the routing at step {t}: {gaps}"
        assert tc2 is tc and tc["pos"] == int(rc["pos"]) == t + 1
        _close(got, want, dtype)
    for name in names:
        _close(tc["layers"][name], rc["layers"][name], dtype)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_prefill_in_float32(moe_models, arch):
    """The reference's own check (tests/test_models_smoke.py): at
    capacity_factor 8, where no assignment drops, teacher-forced decode
    equals the full forward, here within 2e-3."""
    _, tcfg, _, tp = moe_models[arch, "float32"]
    cfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    B, L = 2, 10
    toks = torch.as_tensor(_tokens(cfg.vocab, B, L, seed=2))
    impl = "cuda" if arch == "qwen3-moe-235b-a22b" else "torch"
    full, _ = models.prefill(cfg, tp, {"tokens": toks}, attn_impl=impl)
    cache = models.init_cache(cfg, B, L)
    steps = [models.decode_step(cfg, tp, cache, {"tokens": toks[:, t:t + 1]})[0][:, 0]
             for t in range(L)]
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_greedy_generate_equals_the_reference_token_for_token(moe_models, arch):
    rcfg, tcfg, rp, tp = moe_models[arch, "float32"]
    prompts = _tokens(rcfg.vocab, 3, 8, seed=3)
    want = ref_generate(rcfg, rp, prompts, 12, greedy=True)
    got = serve.generate(tcfg, tp, prompts, 12, greedy=True)
    assert got.dtype == np.int32 and got.shape == (3, 20)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_port_init_params_has_the_converted_layout_and_dtypes(moe_models, arch):
    """The port's own init: the converted tree's paths, shapes and dtypes
    (the router float32 in a bfloat16 model, the experts (E, ...) raw),
    seeded."""
    _, tcfg, _, tp = moe_models[arch, "bfloat16"]
    mine = models.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path
    shapes = [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype) for p, x in flat(mine)[0]]
    assert shapes == [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype)
                      for p, x in flat(tp)[0]]
    for k, shape, dt in shapes:
        assert dt == (torch.float32 if "['router']" in k else torch.bfloat16), k
    mlp = mine["layers"][0]["mlp"]
    E, d, dff = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert
    assert [tuple(mlp[n].shape) for n in ("wi", "wg", "wo")] == [(E, d, dff), (E, d, dff),
                                                                 (E, dff, d)]
    assert ("shared" in mlp) == (arch == "deepseek-v2-236b")
    att = mine["layers"][0]["attn"]
    if arch == "deepseek-v2-236b":
        H, r = tcfg.n_heads, tcfg.kv_lora_rank
        assert sorted(att) == ["kv_norm", "q_norm", "wk_b", "wkv_a", "wo", "wq_a", "wq_b",
                               "wv_b"]
        assert tuple(att["wk_b"]["w"].shape) == (r, H * tcfg.qk_nope_dim)
        assert tuple(att["wv_b"]["w"].shape) == (r, H * tcfg.v_head_dim)
    else:
        assert sorted(att) == ["wk", "wo", "wq", "wv"]
    again = models.init_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(mine),
                                                 jax.tree.leaves(again)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serve_cli_runs_on_a_pinned_cpu(capsys, arch):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "generated (2, 5)" in out
