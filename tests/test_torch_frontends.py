"""repro_torch's modality frontends against repro's on the CPU: musicgen-medium
(``audio_codebooks``: (B, L, C) codebook tokens, their C embeddings summed,
one logits head a codebook) and pixtral-12b (``vision_stub``: precomputed
patch embeddings before the text tokens), reduced, with the reference's
weights carried across by ``params_from_jax`` and the same numpy-seeded
inputs; and every arch of the registry through the port's entry points.

Bars: logits float32 1e-4 and bfloat16 5e-2 (tests/test_torch_models.py's);
the bfloat16 codebook embedding bitwise the reference's op-by-op sum;
teacher-forced decode within 2e-3 of the prefill (the reference's own bar,
tests/test_models_smoke.py); greedy tokens equal; the loss rtol 1e-5 and
every gradient leaf rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad``'s
(tests/test_torch_train.py's); two microbatched train steps 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.launch.serve import generate as ref_generate  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train.train_step import chunked_xent as ref_chunked_xent  # noqa: E402
from repro_torch import configs, models, train  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.train.train_step import chunked_xent  # noqa: E402
from repro_torch.tree import flatten, tree_map, unflatten  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["musicgen-medium", "pixtral-12b"]
CASES = [(a, d) for a in ARCHS for d in TOL]
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(arch, dtype="float32"):
    kw = dict(dtype=dtype, remat=False)
    return (ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw),
            configs.reduced_config(configs.ARCHS[arch], **kw))


@pytest.fixture(scope="module")
def frontends():
    """{(arch, dtype): (ref cfg, port cfg, ref params, port params)}, the
    reference's weights (key 1) carried across."""
    out = {}
    for arch, dtype in CASES:
        rcfg, tcfg = _cfgs(arch, dtype)
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
        out[arch, dtype] = (rcfg, tcfg, rp,
                            models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp)))
    return out


def _batch(cfg, B, L, seed=0, targets=False) -> dict:
    """numpy inputs of L positions: musicgen's (B, L, C) tokens; pixtral's
    n_patches float32 patch embeddings (each package rounds them to
    bfloat16, as the reference's tests pass them) and L - n_patches text
    tokens; targets over every position."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_codebooks":
        b = {"tokens": rng.integers(0, cfg.vocab, size=(B, L, cfg.n_codebooks))}
    else:
        b = {"patch_embeds": rng.normal(size=(B, cfg.n_patches, cfg.d_model)),
             "tokens": rng.integers(0, cfg.vocab, size=(B, L - cfg.n_patches))}
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab, size=b["tokens"].shape[:1] + (L,)
                                    + b["tokens"].shape[2:])
    return {k: v.astype(np.float32 if k == "patch_embeds" else np.int32)
            for k, v in b.items()}


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "patch_embeds" else None)
            for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.as_tensor(v).to(torch.bfloat16) if k == "patch_embeds"
            else torch.as_tensor(v) for k, v in b.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def _logits_shape(cfg, B, L):
    return (B, L) + layers.head_shape(cfg)


# ------------------------------------------------------- forward / prefill
@pytest.mark.parametrize("arch,dtype", CASES)
@pytest.mark.parametrize("impl,ref_impl", [("torch", "xla"), ("cuda", "pallas")])
def test_forward_and_prefill_match_the_reference(frontends, arch, dtype, impl, ref_impl):
    """musicgen's logits (B, L, C, V), pixtral's (B, P + Lt, V)."""
    rcfg, tcfg, rp, tp = frontends[arch, dtype]
    b = _batch(rcfg, 2, 24)
    want, waux = ref_models.forward(rcfg, rp, _jax(b), attn_impl=ref_impl)
    got, aux = models.forward(tcfg, tp, _torch(b), attn_impl=impl)
    assert tuple(got.shape) == want.shape == _logits_shape(rcfg, 2, 24)
    assert got.dtype == tp["head"]["w"].dtype
    assert float(aux) == float(waux) == 0.0
    _close(got, want, dtype)
    pre, _ = models.prefill(tcfg, tp, _torch(b), attn_impl=impl)
    assert torch.equal(pre, got)


@pytest.mark.parametrize("dtype", list(TOL))
def test_codebook_embedding_is_the_reference_s_op_by_op_sum(frontends, dtype):
    """The C codebook rows added c = 0, 1, ... in the table's dtype: bitwise
    the reference's ``_codebook_embed`` run op by op (in bfloat16 each add
    rounds)."""
    rcfg, tcfg, rp, tp = frontends["musicgen-medium", dtype]
    toks = _batch(rcfg, 3, 17, seed=5)["tokens"]
    with jax.disable_jit():
        want = ref_model._codebook_embed(rp["embed"]["table"], jnp.asarray(toks))
    got = port_model.embed_inputs(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == tp["embed"]["table"].dtype and tuple(got.shape) == want.shape
    want = np.asarray(want)
    got = got.view(torch.int16).numpy() if dtype == "bfloat16" else got.numpy()
    assert np.array_equal(got, want.view(np.int16) if dtype == "bfloat16" else want)


@pytest.mark.parametrize("model_dtype,patch_dtype", [("float32", "bfloat16"),
                                                     ("bfloat16", "float32")])
def test_patch_embeddings_take_the_text_s_dtype_before_the_text(frontends, model_dtype,
                                                                 patch_dtype):
    """The reference's tests pass bfloat16 patches into float32 models: the
    patches are cast to the text's dtype and put first, as the reference's
    ``embed_inputs`` does, not refused."""
    rcfg, tcfg, rp, tp = frontends["pixtral-12b", model_dtype]
    b = _batch(rcfg, 2, 12, seed=6)
    pt = torch.as_tensor(b["patch_embeds"]).to(getattr(torch, patch_dtype))
    got = port_model.embed_inputs(tcfg, tp, {"patch_embeds": pt,
                                             "tokens": torch.as_tensor(b["tokens"])})
    want = ref_model.embed_inputs(rcfg, rp, {
        "patch_embeds": jnp.asarray(b["patch_embeds"], getattr(jnp, patch_dtype)),
        "tokens": jnp.asarray(b["tokens"])})
    assert got.dtype == tp["embed"]["table"].dtype and tuple(got.shape) == want.shape
    assert torch.equal(got[:, :rcfg.n_patches], pt.to(got.dtype))
    assert np.array_equal(_np(got), _np(want))


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_steps_and_cache_match_the_reference(frontends, arch, dtype):
    """musicgen's steps take (B, 1, C) tokens and give (B, 1, C, V) logits;
    pixtral's decode carries text only, as the reference's does."""
    rcfg, tcfg, rp, tp = frontends[arch, dtype]
    B, L = 2, 10
    toks = _batch(rcfg, B, L + rcfg.n_patches, seed=1)["tokens"]
    rc = ref_models.init_cache(rcfg, B, L)
    tc = models.init_cache(tcfg, B, L)
    dec = jax.jit(lambda p, c, b: ref_models.decode_step(rcfg, p, c, b))
    for t in range(L):
        want, rc = dec(rp, rc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, tc2 = models.decode_step(tcfg, tp, tc, {"tokens": torch.as_tensor(toks[:, t:t + 1])})
        assert tc2 is tc and tc["pos"] == int(rc["pos"]) == t + 1
        assert tuple(got.shape) == want.shape == _logits_shape(rcfg, B, 1)
        _close(got, want, dtype)
    for name in ("k", "v"):
        _close(tc["layers"][name], rc["layers"][name], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_in_float32(frontends, arch):
    """The reference's own bar (tests/test_models_smoke.py): teacher-forced
    decode equals the full forward within 2e-3, through the kernel's plain
    version; pixtral on text, which is all its decode takes."""
    _, tcfg, _, tp = frontends[arch, "float32"]
    B, L = 2, 10
    toks = torch.as_tensor(_batch(tcfg, B, L + tcfg.n_patches, seed=2)["tokens"])
    full, _ = models.prefill(tcfg, tp, {"tokens": toks}, attn_impl="cuda")
    cache = models.init_cache(tcfg, B, L)
    steps = [models.decode_step(tcfg, tp, cache, {"tokens": toks[:, t:t + 1]})[0][:, 0]
             for t in range(L)]
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full),
                               rtol=2e-3, atol=2e-3)


def _greedy_codebooks(decode, prompts, new: int) -> np.ndarray:
    """musicgen's greedy loop (no ``generate`` takes codebooks): the prompt's
    (B, Lp, C) tokens one step each, then ``new`` steps feeding back each
    codebook's argmax.  ``decode(tokens (B, 1, C)) -> (B, 1, C, V)``."""
    out = [prompts[:, t:t + 1] for t in range(prompts.shape[1])]
    for t in range(prompts.shape[1] + new - 1):
        logits = decode(out[t])
        if t + 1 >= prompts.shape[1]:
            out.append(np.argmax(logits[:, -1], axis=-1)[:, None].astype(np.int32))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decoding_equals_the_reference_token_for_token(frontends, arch):
    """pixtral through ``generate``; musicgen through a loop of decode steps
    with an argmax over each codebook's vocab, in both packages."""
    rcfg, tcfg, rp, tp = frontends[arch, "float32"]
    if rcfg.frontend == "vision_stub":
        prompts = _batch(rcfg, 3, 8 + rcfg.n_patches, seed=3)["tokens"]
        want = ref_generate(rcfg, rp, prompts, 12, greedy=True)
        got = serve.generate(tcfg, tp, prompts, 12, greedy=True)
        assert got.dtype == np.int32 and got.shape == (3, 20)
        assert np.array_equal(got, want)
        return
    prompts = _batch(rcfg, 3, 8, seed=3)["tokens"]
    rc, tc = ref_models.init_cache(rcfg, 3, 20), models.init_cache(tcfg, 3, 20)
    dec = jax.jit(lambda p, c, b: ref_models.decode_step(rcfg, p, c, b))

    def ref_step(tok):
        nonlocal rc
        logits, rc = dec(rp, rc, {"tokens": jnp.asarray(tok)})
        return np.asarray(logits)

    def port_step(tok):
        return models.decode_step(tcfg, tp, tc, {"tokens": torch.as_tensor(tok)})[0].numpy()
    want = _greedy_codebooks(ref_step, prompts, 12)
    got = _greedy_codebooks(port_step, prompts, 12)
    assert got.shape == (3, 20, rcfg.n_codebooks)
    assert np.array_equal(got[:, :8], prompts) and np.array_equal(got, want)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("arch", ARCHS)
def test_converted_layout_and_port_init_are_the_reference_s(frontends, arch):
    """musicgen's (C, V, d) embedding carried as it is and its (d, C, V)
    head flattened to (d, C·V); the port's own init has the converted
    tree's paths, shapes and dtypes, and is seeded."""
    rcfg, tcfg, rp, tp = frontends[arch, "bfloat16"]
    C = rcfg.n_codebooks or 1
    emb = (C, rcfg.vocab, rcfg.d_model) if rcfg.n_codebooks else (rcfg.vocab, rcfg.d_model)
    assert tuple(tp["embed"]["table"].shape) == rp["embed"]["table"].shape == emb
    assert rp["head"]["w"].shape == (rcfg.d_model,) + layers.head_shape(rcfg)
    assert tuple(tp["head"]["w"].shape) == (rcfg.d_model, C * rcfg.vocab)
    assert np.array_equal(_np(tp["head"]["w"]),
                          _np(rp["head"]["w"]).reshape(rcfg.d_model, -1))
    mine = models.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path
    shapes = [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype) for p, x in flat(mine)[0]]
    assert shapes == [(jax.tree_util.keystr(p), tuple(x.shape), x.dtype)
                      for p, x in flat(tp)[0]]
    again = models.init_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(mine),
                                                 jax.tree.leaves(again)))
    # each codebook's table at the embedding's scale, truncated at two
    assert float(mine["embed"]["table"].float().abs().max()) <= 2.0
    assert float(mine["head"]["w"].float().abs().max()) <= \
        2 * tcfg.d_model ** -0.5 * (1 + 2 ** -7)


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCHS))
def test_every_arch_runs_init_forward_and_decode(arch):
    """Every arch of the reference's registry, reduced: the port's own
    init, a prefill on the plain attention and two decode steps, with the
    reference's logits shapes, finite."""
    cfg = configs.reduced_config(configs.ARCHS[arch])
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    b = _torch(_batch(cfg, 2, 12 + cfg.n_patches, seed=4))
    logits, _ = models.prefill(cfg, params, b, attn_impl="torch")
    assert tuple(logits.shape) == _logits_shape(cfg, 2, 12 + cfg.n_patches)
    assert bool(torch.isfinite(logits.float()).all())
    cache = models.init_cache(cfg, 2, 4)
    for t in range(2):
        step, cache = models.decode_step(cfg, params, cache,
                                         {"tokens": b["tokens"][:, t:t + 1]})
        assert tuple(step.shape) == _logits_shape(cfg, 2, 1)
        assert bool(torch.isfinite(step.float()).all())
    assert cache["pos"] == 2


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("L", [24, 20, 7])
def test_chunked_xent_matches_the_reference_on_codebook_targets(frontends, L):
    """(B, L, C) targets: the codebook axis folds into the cross-entropy's
    leading axes; L = 24 takes 8 chunks, 20 halves to 4, 7 to 1."""
    rcfg, tcfg, rp, tp = frontends["musicgen-medium", "float32"]
    rng = np.random.default_rng(L)
    hidden = rng.normal(size=(2, L, rcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, rcfg.vocab, size=(2, L, rcfg.n_codebooks)).astype(np.int32)
    want = ref_chunked_xent(rcfg, rp["head"], jnp.asarray(hidden), jnp.asarray(targets))
    got = chunked_xent(tcfg, tp["head"], torch.as_tensor(hidden), torch.as_tensor(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_the_reference(frontends, arch):
    """musicgen on (B, L, C) targets, pixtral's over its patch positions and
    its text's: the loss within 1e-5 and every gradient leaf within 1e-4 of
    ``jax.value_and_grad``'s."""
    rcfg, tcfg, rp, tp = frontends[arch, "float32"]
    b = _batch(rcfg, 2, 32, seed=7, targets=True)
    want_loss, want = jax.value_and_grad(
        lambda p: ref_train.loss_fn(rcfg, p, _jax(b))[0])(rp)
    keys, leaves_ = flatten(tree_map(lambda t: t.detach().requires_grad_(True), tp))
    loss, _ = train.loss_fn(tcfg, unflatten(tp, leaves_), _torch(b))
    grads = torch.autograd.grad(loss, leaves_)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    wk, wl = flatten(models.params_from_jax(tcfg, jax.tree.map(np.asarray, want)))
    assert keys == wk and "embed/table" in keys and "head/w" in keys
    for k, g, w in zip(keys, grads, wl):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-6, err_msg=k)


def test_microbatched_steps_slice_the_patches_as_the_reference(frontends):
    """Two train steps of pixtral in two microbatches, its patch embeddings
    split along the batch with the tokens: loss and weights within 1e-4 of
    the reference's jitted steps."""
    rcfg, tcfg, rp, tp = frontends["pixtral-12b", "float32"]
    ref_step = jax.jit(ref_train.make_train_step(
        rcfg, ref_train.AdamWConfig(**OCFG), num_microbatches=2))
    step = train.make_train_step(tcfg, train.AdamWConfig(**OCFG), num_microbatches=2)
    ro, to = ref_train.adamw_init(rp), train.adamw_init(tp)
    for s in range(2):
        b = _batch(rcfg, 4, 16, seed=10 + s, targets=True)
        rp, ro, rm = ref_step(rp, ro, _jax(b))
        tp, to, tm = step(tp, to, _torch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-4)
    wk, wl = flatten(models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp)))
    gk, gl = flatten(tp)
    assert gk == wk
    for k, g, w in zip(gk, gl, wl):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_takes_steps_on_a_pinned_cpu(capsys, arch):
    """``python -m repro_torch.launch.train --arch ... --reduced --device
    cpu``: musicgen's token stream gives (B, L, C) grids."""
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "[train] step     0 loss" in out
    assert "[train] loss first-1-mean" in out


# ----------------------------------------------------------------- serving
def test_serve_cli_refuses_musicgen_as_the_reference_does():
    """Before building anything, with or without a card."""
    with pytest.raises(SystemExit, match="use the musicgen example for codebook decoding"):
        serve.main(["--arch", "musicgen-medium", "--reduced"])
    with pytest.raises(SystemExit, match="musicgen example"):
        serve.main(["--arch", "musicgen-medium", "--reduced", "--device", "cpu"])


def test_serve_cli_runs_pixtral_on_a_pinned_cpu(capsys):
    serve.main(["--arch", "pixtral-12b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "arch=pixtral-12b" in out and "generated (2, 5)" in out
