"""repro_torch's training path (train/, data/tokens.py, the model's
``return_hidden`` and remat, the flash-attention kernel's grad guard)
against repro's on the CPU, on the same seeded inputs, with the
reference's weights and optimizer state carried across by
``params_from_jax`` / ``opt_state_from_jax``.

Bars: cross_entropy rtol 1e-6; chunked_xent and loss_fn rtol 1e-5; the
gradient against ``jax.value_and_grad`` rtol 1e-4 / atol 1e-6; cosine_lr
and one adamw_apply 1e-6; three train steps (loss and params) 1e-4;
microbatches 1, 2 and 4 rtol 1e-5 (the reference's own bar);
quantize/dequantize and TokenStream bitwise; 50 steps of error feedback
1e-6; the compressed all_reduce on 2 and 4 gloo ranks 1e-6 of the
reference's quantise/dequantise composed per rank."""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.data.tokens import TokenStream as RefTokenStream  # noqa: E402
from repro.train.train_step import chunked_xent as ref_chunked_xent  # noqa: E402
from repro_torch import configs, models, train  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.train.train_step import chunked_xent  # noqa: E402
from repro_torch.tree import flatten, tree_map, unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120.0
# an optimizer that moves the weights well past the bars in three steps,
# with warmup and the clip both active.  Adam turns a float32 rounding of a
# near-zero gradient into an update of up to ~lr/10 (g / (|g| + eps)), so
# the difference after a few steps grows with lr: at lr 1e-2 one weight in
# 32,768 stood 1.3e-4 off the reference's after three steps, at 1e-3
# 1.3e-5, while the weights moved 2.9e-3
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(**kw):
    kw = {"dtype": "float32", "remat": False, **kw}
    return (ref_configs.reduced_config(ref_configs.ARCHS["qwen2-0.5b"], **kw),
            configs.reduced_config(configs.ARCHS["qwen2-0.5b"], **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_trees_close(got, want, rtol, atol=0.0):
    gk, gl = flatten(got)
    wk, wl = flatten(want)
    assert gk == wk
    for k, a, b in zip(gk, gl, wl):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def lm():
    """The reference's reduced float32 qwen2 weights (key 1), carried
    across, and a batch of the token stream."""
    rcfg, tcfg = _cfgs()
    rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
    tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
    b = RefTokenStream(rcfg.vocab, 2, 32, seed=0).batch_at(0)
    return rcfg, tcfg, rp, tp, b


def _batches(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("z_coef", [0.0, 1e-4])
def test_cross_entropy_matches_the_reference(z_coef):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 8, 64)) * 3).astype(np.float32)
    targets = rng.integers(0, 64, size=(2, 8)).astype(np.int32)
    want = ref_train.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), z_coef)
    got = train.cross_entropy(torch.as_tensor(logits), torch.as_tensor(targets), z_coef)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("L", [24, 20, 7])
def test_chunked_xent_matches_the_reference(lm, L):
    """L = 24 takes 8 chunks, 20 halves to 4, 7 to 1."""
    rcfg, tcfg, rp, tp, _ = lm
    rng = np.random.default_rng(L)
    hidden = rng.normal(size=(2, L, rcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, rcfg.vocab, size=(2, L)).astype(np.int32)
    want = ref_chunked_xent(rcfg, rp["head"], jnp.asarray(hidden), jnp.asarray(targets))
    got = chunked_xent(tcfg, tp["head"], torch.as_tensor(hidden), torch.as_tensor(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_fn_matches_the_reference(lm):
    rcfg, tcfg, rp, tp, b = lm
    jb, tb = _batches(b)
    want, wmet = ref_train.loss_fn(rcfg, rp, jb)
    got, gmet = train.loss_fn(tcfg, tp, tb)
    assert set(gmet) == set(wmet) == {"ce", "aux"}
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gmet["ce"]), float(wmet["ce"]), rtol=1e-5)
    assert float(gmet["aux"]) == float(wmet["aux"]) == 0.0


def test_forward_return_hidden_is_the_reference_s_final_normed_hidden(lm):
    rcfg, tcfg, rp, tp, b = lm
    jb, tb = _batches(b)
    want, _ = ref_models.forward(rcfg, rp, jb, return_hidden=True)
    got, _ = models.forward(tcfg, tp, tb, attn_impl="torch", return_hidden=True)
    assert tuple(got.shape) == (2, 32, rcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    logits, _ = models.forward(tcfg, tp, tb, attn_impl="torch")
    assert torch.equal(logits, torch.matmul(got, tp["head"]["w"]))


def test_gradient_matches_jax_value_and_grad(lm):
    rcfg, tcfg, rp, tp, b = lm
    jb, tb = _batches(b)
    want_loss, want = jax.value_and_grad(
        lambda p: ref_train.loss_fn(rcfg, p, jb)[0])(rp)
    ps = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, _ = train.loss_fn(tcfg, ps, tb)
    _, leaves_ = flatten(ps)
    grads = torch.autograd.grad(loss, leaves_)
    got = dict(zip(flatten(ps)[0], grads))
    want = models.params_from_jax(tcfg, jax.tree.map(np.asarray, want),
                                  dtype=torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    wk, wl = flatten(want)
    assert list(got) == wk
    for k, w in zip(wk, wl):
        np.testing.assert_allclose(_np(got[k]), _np(w), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_loss_and_gradient_match_the_reference(arch):
    """The state-space families through the same loss: reduced float32
    falcon-mamba-7b and zamba2-1.2b (with its shared block), the loss
    within 1e-5 and every gradient leaf within 1e-4 of
    ``jax.value_and_grad``'s (the dense model's bars above)."""
    kw = dict(dtype="float32", remat=False)
    rcfg = ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw)
    tcfg = configs.reduced_config(configs.ARCHS[arch], **kw)
    rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
    tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
    jb, tb = _batches(RefTokenStream(rcfg.vocab, 2, 32, seed=0).batch_at(0))
    want_loss, want = jax.value_and_grad(lambda p: ref_train.loss_fn(rcfg, p, jb)[0])(rp)
    keys, leaves_ = flatten(tree_map(lambda t: t.detach().requires_grad_(True), tp))
    loss, _ = train.loss_fn(tcfg, unflatten(tp, leaves_), tb)
    grads = torch.autograd.grad(loss, leaves_)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    wk, wl = flatten(models.params_from_jax(tcfg, jax.tree.map(np.asarray, want)))
    assert keys == wk and any("mixer/A_log" in k for k in keys)
    for k, g, w in zip(keys, grads, wl):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_moe_loss_and_gradient_match_the_reference(arch):
    """The MoE families through the same loss, with the layers' aux term in
    it: reduced float32 qwen3-moe-235b-a22b and deepseek-v2-236b (MLA, a
    shared expert), the loss and the aux within 1e-5 and every gradient
    leaf (the float32 router's and the (E, ...) experts' among them) within
    1e-4 of ``jax.value_and_grad``'s."""
    kw = dict(dtype="float32", remat=False)
    rcfg = ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw)
    tcfg = configs.reduced_config(configs.ARCHS[arch], **kw)
    rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
    tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
    jb, tb = _batches(RefTokenStream(rcfg.vocab, 2, 32, seed=0).batch_at(0))
    (want_loss, wmet), want = jax.value_and_grad(
        lambda p: ref_train.loss_fn(rcfg, p, jb), has_aux=True)(rp)
    keys, leaves_ = flatten(tree_map(lambda t: t.detach().requires_grad_(True), tp))
    loss, met = train.loss_fn(tcfg, unflatten(tp, leaves_), tb)
    grads = torch.autograd.grad(loss, leaves_)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    aux = float(met["aux"].detach())
    assert aux > 0
    np.testing.assert_allclose(aux, float(wmet["aux"]), rtol=1e-5)
    wk, wl = flatten(models.params_from_jax(tcfg, jax.tree.map(np.asarray, want)))
    assert keys == wk and any(k.endswith("mlp/router/w") for k in keys)
    for k, g, w in zip(keys, grads, wl):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v2-236b"])
def test_moe_remat_gives_the_same_loss_aux_and_gradient(arch):
    """torch.utils.checkpoint returns each MoE layer's aux beside its
    output, and the recompute routes the same picks: the loss, the aux and
    every gradient bitwise with remat on and off."""
    tcfg = configs.reduced_config(configs.ARCHS[arch], dtype="float32")
    params = models.init_params(tcfg, torch.Generator().manual_seed(0))
    tb = {k: torch.as_tensor(v)
          for k, v in TokenStream(tcfg.vocab, 2, 32, seed=1).batch_at(0).items()}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, met = train.loss_fn(cfg, ps, tb)
        out.append((loss.detach(), met["aux"].detach(),
                    torch.autograd.grad(loss, flatten(ps)[1])))
    assert float(out[0][1]) > 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


def test_remat_changes_neither_the_loss_nor_the_gradient(monkeypatch):
    """torch.utils.checkpoint reruns each layer's forward in the backward:
    the same operations on the same inputs, so the same bits.  It wraps
    every layer of a recorded forward and none of a prefill whose weights
    ask for no gradient."""
    _, tcfg = _cfgs()
    params = models.init_params(tcfg, torch.Generator().manual_seed(0))
    tb = {k: torch.as_tensor(v)
          for k, v in TokenStream(tcfg.vocab, 2, 32, seed=1).batch_at(0).items()}
    checkpointed = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: checkpointed.append(1) or real(*a, **kw))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = train.loss_fn(cfg, ps, tb)
        out.append((loss.detach(), torch.autograd.grad(loss, flatten(ps)[1])))
        assert len(checkpointed) == (tcfg.n_layers if remat else 0)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    logits, _ = models.prefill(cfg, params, tb, attn_impl="torch")
    assert len(checkpointed) == tcfg.n_layers and logits.grad_fn is None


def test_zamba2_remat_with_two_shared_block_uses_changes_nothing(monkeypatch):
    """Reduced float32 zamba2 at 12 layers, its shared block after layers 6
    and 12: under torch.utils.checkpoint (each layer, the block inside the
    layer it follows) its two uses' gradients sum into one leaf as without
    remat.  The loss, every gradient and two train steps' losses bitwise
    with remat on and off."""
    tcfg = configs.reduced_config(configs.ARCHS["zamba2-1.2b"], dtype="float32",
                                  remat=False, n_layers=12, attn_every=6)
    params = models.init_params(tcfg, torch.Generator().manual_seed(0))
    stream = TokenStream(tcfg.vocab, 2, 32, seed=1)
    tb = {k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()}
    checkpointed = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: checkpointed.append(a[6] is not None) or real(*a, **kw))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        keys, leaves_ = flatten(tree_map(lambda t: t.detach().requires_grad_(True), params))
        loss, _ = train.loss_fn(cfg, unflatten(params, leaves_), tb)
        grads = torch.autograd.grad(loss, leaves_)
        step = train.make_train_step(cfg, train.AdamWConfig(**OCFG))
        p, o, losses = params, train.adamw_init(params), []
        for s in range(2):
            p, o, m = step(p, o, {k: torch.as_tensor(v)
                                  for k, v in stream.batch_at(s).items()})
            losses.append(float(m["loss"]))
        out.append((loss.detach(), dict(zip(keys, grads)), losses))
    assert checkpointed.count(True) == 2 * 3 and len(checkpointed) == 12 * 3
    assert torch.equal(out[0][0], out[1][0]) and out[0][2] == out[1][2]
    assert out[0][1].keys() == out[1][1].keys()
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])
    shared = [k for k in out[0][1] if k.startswith("shared_attn/")]
    assert shared and all(out[0][1][k].abs().max() > 0 for k in shared)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("ocfg", [{}, OCFG, dict(warmup_steps=0, total_steps=7,
                                                 min_lr_frac=0.0)])
def test_cosine_lr_matches_the_reference(ocfg):
    rc, tc = ref_train.AdamWConfig(**ocfg), train.AdamWConfig(**ocfg)
    steps = np.array([0, 1, 2, 3, 50, 99, 100, 101, 5000, 9999, 10000, 20000],
                     np.int32)
    want = np.asarray(ref_train.cosine_lr(rc, jnp.asarray(steps)))
    got = train.cosine_lr(tc, torch.as_tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_adamw_apply_matches_the_reference(lm):
    """One step from a random state at step 5 (random m, v > 0, masters
    off the params) with random grads, through opt_state_from_jax."""
    rcfg, tcfg, rp, _, _ = lm
    rng = np.random.default_rng(2)
    like = jax.tree.map(np.asarray, rp)
    rand = lambda s=1.0: jax.tree.map(  # noqa: E731
        lambda a: (rng.normal(size=a.shape) * s).astype(np.float32), like)
    grads = rand(0.3)
    opt = {"master": jax.tree.map(lambda a, d: a + d, like, rand(1e-3)),
           "m": rand(0.05), "v": jax.tree.map(np.abs, rand(0.01)),
           "step": np.int32(5)}
    rc, tc = ref_train.AdamWConfig(**OCFG), train.AdamWConfig(**OCFG)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    wp, wo, wm = ref_train.adamw_apply(rc, to_j(grads), to_j(opt), to_j(like))
    gp, go, gm = train.adamw_apply(
        tc, models.params_from_jax(tcfg, grads, dtype=torch.float32),
        models.opt_state_from_jax(tcfg, opt), models.params_from_jax(tcfg, like))
    _assert_trees_close(gp, models.params_from_jax(tcfg, jax.tree.map(np.asarray, wp)),
                        rtol=1e-6, atol=1e-6)
    want_opt = models.opt_state_from_jax(tcfg, jax.tree.map(np.asarray, wo))
    assert int(go["step"]) == int(want_opt["step"]) == 6
    assert go["step"].dtype == torch.int32
    for key in ("master", "m", "v"):
        _assert_trees_close(go[key], want_opt[key], rtol=1e-6, atol=1e-6)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_train_steps_equal_the_functional_ones_in_place(dtype):
    """Three train steps of reduced qwen2 with ``donate=True`` against
    ``donate=False`` from copies of one state: the losses, the grad norms,
    the params and every optimizer leaf bitwise; the donated steps write
    into the tensors they were given (each leaf's storage unchanged)."""
    _, tcfg = _cfgs(dtype=dtype)
    init = models.init_params(tcfg, torch.Generator().manual_seed(3))
    stream = TokenStream(tcfg.vocab, 2, 32, seed=4)
    runs = {}
    for donate in (False, True):
        p = tree_map(lambda t: t.clone(), init)
        o = train.adamw_init(p)
        ptrs = [t.data_ptr() for t in flatten({"p": p, "o": o})[1]
                if t.dim()]
        step = train.make_train_step(tcfg, train.AdamWConfig(**OCFG), donate=donate)
        mets = []
        for s in range(3):
            p, o, m = step(p, o, {k: torch.as_tensor(v)
                                  for k, v in stream.batch_at(s).items()})
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        after = [t.data_ptr() for t in flatten({"p": p, "o": o})[1]
                 if t.dim()]
        runs[donate] = (p, o, mets, ptrs == after)
    (fp, fo, fm, f_same), (dp, do, dm, d_same) = runs[False], runs[True]
    assert dm == fm and d_same and not f_same
    assert int(do["step"]) == int(fo["step"]) == 3
    (kf, lf), (kd, ld) = flatten({"p": fp, "o": fo}), flatten({"p": dp, "o": do})
    assert kf == kd
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(lf, ld))


def test_adamw_decreases_quadratic():
    ocfg = train.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = train.adamw_init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, opt, m = train.adamw_apply(ocfg, grads, opt, params)
    assert float(params["w"].abs().max()) < 0.5
    assert int(opt["step"]) == 60


def test_adamw_keeps_bf16_params_over_float32_state():
    p = {"a": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
         "b": [torch.ones(5)]}
    opt = train.adamw_init(p)
    assert all(t.dtype == torch.float32 for t in flatten(opt["master"])[1])
    assert opt["master"]["a"].data_ptr() != p["a"].data_ptr()
    assert opt["master"]["b"][0].data_ptr() != p["b"][0].data_ptr()
    grads = tree_map(torch.ones_like, p)
    new, opt2, _ = train.adamw_apply(train.AdamWConfig(), grads, opt, p)
    assert new["a"].dtype == torch.bfloat16 and new["b"][0].dtype == torch.float32
    assert torch.equal(new["a"], opt2["master"]["a"].bfloat16())
    assert int(opt["step"]) == 0 and int(opt2["step"]) == 1


# --------------------------------------------------------------- the step
def _steps_match_the_reference(lm, batch, num_microbatches):
    """Three steps of the port's train step and of the reference's jitted
    one, from the same weights on the same token-stream batches: every
    step's metrics rtol 1e-4, then the params and the optimizer state 1e-4."""
    rcfg, tcfg, rp, tp, _ = lm
    rc, tc = ref_train.AdamWConfig(**OCFG), train.AdamWConfig(**OCFG)
    ref_step = jax.jit(ref_train.make_train_step(rcfg, rc,
                                                 num_microbatches=num_microbatches))
    step = train.make_train_step(tcfg, tc, num_microbatches=num_microbatches)
    stream = RefTokenStream(rcfg.vocab, batch, 32, seed=3)
    ropt, topt = ref_train.adamw_init(rp), train.adamw_init(tp)
    tp0 = tp
    for s in range(3):
        jb, tb = _batches(stream.batch_at(s))
        rp, ropt, rm = ref_step(rp, ropt, jb)
        tp, topt, tm = step(tp, topt, tb)
        assert set(tm) == set(rm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(rm[key]), rtol=1e-4,
                                       err_msg=f"step {s} {key}")
    want = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
    _assert_trees_close(tp, want, rtol=1e-4, atol=1e-4)
    moved = max(float((a - b).abs().max()) for a, b in zip(flatten(tp)[1], flatten(tp0)[1]))
    assert moved > 1e-3      # the steps moved the weights far past the bar
    _assert_trees_close(topt, models.opt_state_from_jax(
        tcfg, jax.tree.map(np.asarray, ropt)), rtol=1e-4, atol=1e-4)


def test_three_train_steps_match_the_reference_s_jitted_steps(lm):
    _steps_match_the_reference(lm, batch=2, num_microbatches=1)


@pytest.mark.parametrize("num_microbatches", [2, 4])
def test_microbatched_train_steps_match_the_reference_s_jitted_steps(lm, num_microbatches):
    """The gradient accumulation against the reference's ``lax.scan``: a
    sum or average wrong by a factor, or ``ce`` taken from another
    microbatch than the last, shows in the metrics of the first step."""
    _steps_match_the_reference(lm, batch=4, num_microbatches=num_microbatches)


def test_microbatches_give_equal_losses():
    _, tcfg = _cfgs()
    params = models.init_params(tcfg, torch.Generator().manual_seed(0))
    opt = train.adamw_init(params)
    tb = {k: torch.as_tensor(v)
          for k, v in TokenStream(tcfg.vocab, 4, 32, seed=0).batch_at(0).items()}
    outs = []
    for mb in (1, 2, 4):
        step = train.make_train_step(tcfg, train.AdamWConfig(total_steps=10),
                                     num_microbatches=mb)
        p, o, m = step(params, opt, tb)
        outs.append(float(m["loss"]))
    assert np.allclose(outs[0], outs[1], rtol=1e-5)
    assert np.allclose(outs[0], outs[2], rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        train.make_train_step(tcfg, train.AdamWConfig(), num_microbatches=3)(
            params, opt, tb)


def _bf16_lm(key=1):
    rcfg, tcfg = _cfgs(dtype="bfloat16")
    rp = ref_models.init_params(rcfg, jax.random.PRNGKey(key))
    tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
    jb, tb = _batches(RefTokenStream(rcfg.vocab, 2, 32, seed=0).batch_at(0))
    return rcfg, tcfg, rp, tp, jb, tb


def _rel(got, want) -> float:
    """Relative Frobenius distance, in float64."""
    got, want = torch.as_tensor(_np(got)).double(), torch.as_tensor(_np(want)).double()
    return float((got - want).norm() / want.norm())


def test_a_bf16_step_keeps_the_dtypes_and_follows_the_reference():
    """bfloat16 params, bfloat16 gradients, float32 state.  Bars from the
    readings at keys 1-3: the loss rtol 1e-3 (read at most 1.6e-4); each
    gradient leaf against ``jax.value_and_grad`` of the reference's bf16
    ``loss_fn`` within 4e-2 relative Frobenius (at most 2.7e-2, the k
    bias, whose gradient is rounding noise: softmax is blind to it), all
    leaves together 1.5e-2 (7.4e-3 to 7.8e-3); the step's ``grad_norm``
    rtol 1e-3 (2.2e-4).  The float32 masters' change against the
    reference's: Adam's first step is about lr * sign(g), so an element
    whose bf16 gradient is near zero may move the other way; 98.7% of
    them moved within 1e-7 of the reference's (bar 97%), the whole change
    within 0.10 relative (bar 0.15).  A missing or wrongly scaled update
    reads ~0% and ~1."""
    rcfg, tcfg, rp, tp, jb, tb = _bf16_lm()
    (rloss, _), rg = jax.jit(jax.value_and_grad(
        lambda p: ref_train.loss_fn(rcfg, p, jb), has_aux=True))(rp)
    ps = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, _ = train.loss_fn(tcfg, ps, tb)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-3)
    grads = torch.autograd.grad(loss, flatten(ps)[1])
    assert all(g.dtype == torch.bfloat16 for g in grads)
    keys, want = flatten(models.params_from_jax(tcfg, jax.tree.map(np.asarray, rg)))
    for k, g, w in zip(keys, grads, want):
        assert _rel(g, w) <= 4e-2, k
    assert _rel(torch.cat([g.float().flatten() for g in grads]),
                torch.cat([w.float().flatten() for w in want])) <= 1.5e-2

    rc, tc = ref_train.AdamWConfig(**OCFG), train.AdamWConfig(**OCFG)
    ropt0, topt0 = ref_train.adamw_init(rp), train.adamw_init(tp)
    _, ropt, rm = jax.jit(ref_train.make_train_step(rcfg, rc))(rp, ropt0, jb)
    tp2, topt, tm = train.make_train_step(tcfg, tc)(tp, topt0, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-3)
    assert all(t.dtype == torch.bfloat16 for t in flatten(tp2)[1])
    assert all(t.dtype == torch.float32 for t in flatten(topt["master"])[1])
    rmaster0, rmaster = (models.opt_state_from_jax(tcfg, jax.tree.map(np.asarray, o))["master"]
                         for o in (ropt0, ropt))
    got = torch.cat([(a - b).flatten() for a, b in
                     zip(flatten(topt["master"])[1], flatten(topt0["master"])[1])])
    ref = torch.cat([(a - b).flatten() for a, b in
                     zip(flatten(rmaster)[1], flatten(rmaster0)[1])])
    assert float(ref.abs().max()) > 1e-4          # the step moved the masters
    assert float(((got - ref).abs() <= 1e-7).double().mean()) >= 0.97
    assert _rel(got, ref) <= 0.15


def test_bf16_microbatches_accumulate_in_float32():
    """With bf16 params the microbatches' bf16 gradients are summed and
    averaged in float32, as the reference's float32 ``lax.scan`` carry
    does: the step's state is bitwise one ``adamw_apply`` of that average
    (a bf16 sum rounds every addition to 8 bits and misses it)."""
    _, tcfg = _cfgs(dtype="bfloat16")
    params = models.init_params(tcfg, torch.Generator().manual_seed(0))
    tb = {k: torch.as_tensor(v)
          for k, v in TokenStream(tcfg.vocab, 4, 32, seed=0).batch_at(0).items()}
    tc = train.AdamWConfig(**OCFG)
    total = None
    for i in range(2):
        ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = train.loss_fn(tcfg, ps, {k: v[2 * i:2 * i + 2] for k, v in tb.items()})
        grads = [g.float() for g in torch.autograd.grad(loss, flatten(ps)[1])]
        total = grads if total is None else [a + b for a, b in zip(total, grads)]
    avg = tree_map(lambda g: g * 0.5, unflatten(params, total))
    want_p, want_opt, _ = train.adamw_apply(tc, avg, train.adamw_init(params), params)
    got_p, got_opt, _ = train.make_train_step(tcfg, tc, num_microbatches=2)(
        params, train.adamw_init(params), tb)
    for k, a, b in zip(*flatten(got_opt), flatten(want_opt)[1]):
        assert torch.equal(a, b), k
    assert all(torch.equal(a, b) for a, b in zip(flatten(got_p)[1], flatten(want_p)[1]))


def test_adamw_on_the_reference_s_bf16_gradients_is_the_reference_s():
    """The optimizer's bf16 path alone: one ``adamw_apply`` of the
    reference's bf16 gradient tree on bf16 params.  The float32 state
    within 1e-7 (read at most 6e-8), the new bf16 params bitwise."""
    rcfg, tcfg, rp, tp, jb, _ = _bf16_lm()
    _, rg = jax.value_and_grad(lambda p: ref_train.loss_fn(rcfg, p, jb), has_aux=True)(rp)
    tg = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rg))
    assert all(g.dtype == torch.bfloat16 for g in flatten(tg)[1])
    rc, tc = ref_train.AdamWConfig(**OCFG), train.AdamWConfig(**OCFG)
    rp2, ropt, rmet = ref_train.adamw_apply(rc, rg, ref_train.adamw_init(rp), rp)
    tp2, topt, tmet = train.adamw_apply(tc, tg, train.adamw_init(tp), tp)
    _assert_trees_close(topt, models.opt_state_from_jax(
        tcfg, jax.tree.map(np.asarray, ropt)), rtol=1e-6, atol=1e-7)
    for k, a, b in zip(*flatten(tp2), flatten(models.params_from_jax(
            tcfg, jax.tree.map(np.asarray, rp2)))[1]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), k
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(rmet["grad_norm"]), rtol=1e-6)


# -------------------------------------------------------------- compression
def test_int8_quantization_is_the_reference_s_bitwise():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(256,)) * 5, rng.normal(size=(33, 7)) * 1e-3,
              np.zeros(8), np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0]) / 127):
        x = x.astype(np.float32)
        wq, ws = ref_train.quantize_int8(jnp.asarray(x))
        gq, gs = train.quantize_int8(torch.as_tensor(x))
        assert gq.dtype == torch.int8 and gs.dtype == torch.float32
        assert np.array_equal(gq.numpy(), np.asarray(wq))
        assert np.array_equal(gs.numpy(), np.asarray(ws))
        assert np.array_equal(train.dequantize_int8(gq, gs).numpy(),
                              np.asarray(ref_train.dequantize_int8(wq, ws)))
        err = np.abs(train.dequantize_int8(gq, gs).numpy() - x)
        assert err.max() <= float(gs) * 0.5 + 1e-6


def test_fifty_steps_of_error_feedback_match_the_reference():
    rng = np.random.default_rng(1)
    g = {"w": (rng.normal(size=64) * 0.1).astype(np.float32),
         "b": [(rng.normal(size=(3, 5)) * 2).astype(np.float32)]}
    rerr = ref_train.ef_init(jax.tree.map(jnp.asarray, g))
    terr = train.ef_init(tree_map(torch.as_tensor, g))
    assert all(t.dtype == torch.float32 and not t.any() for t in flatten(terr)[1])
    rsent = np.zeros(64)
    tsent = np.zeros(64)
    for _ in range(50):
        rq, rerr = ref_train.compress_with_feedback(jax.tree.map(jnp.asarray, g), rerr)
        tq, terr = train.compress_with_feedback(tree_map(torch.as_tensor, g), terr)
        rsent += np.asarray(ref_train.dequantize_int8(*rq["w"]))
        tsent += train.dequantize_int8(*tq["w"]).numpy()
        assert tq["w"][0].dtype == torch.int8 and len(tq["b"]) == 1
    np.testing.assert_allclose(tsent, rsent, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(terr["w"].numpy(), np.asarray(rerr["w"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(terr["b"][0].numpy(), np.asarray(rerr["b"][0]),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(tsent - g["w"] * 50).max() <= float(np.abs(g["w"]).max()) * 1.5


_PSUM_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

world, rank, store, inputs = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                              sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank)
from repro_torch.launch.mesh import destroy_world
try:
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.train import compressed_pod_psum
    d = np.load(inputs)
    grads = {"w": torch.as_tensor(d[f"w{rank}"]), "b": [torch.as_tensor(d[f"b{rank}"])]}
    err = {"w": torch.as_tensor(d[f"ew{rank}"]), "b": [torch.as_tensor(d[f"eb{rank}"])]}
    mesh = compat_make_mesh((world,), ("pod",), device_type="cpu")
    out = {}
    for how, group in (("mesh", mesh), ("default", None)):
        synced, new_err = compressed_pod_psum(grads, err, group)
        out[how] = {"w": synced["w"].tolist(), "b": synced["b"][0].tolist(),
                    "ew": new_err["w"].tolist(), "eb": new_err["b"][0].tolist()}
    out["bad"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps(out), flush=True)
    # no rank tears its gloo pairs down while a peer may still be in a
    # collective with it
    dist.barrier()
finally:
    destroy_world()
'''


def _kill(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=RANK_TIMEOUT_S)


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_pod_psum_on_gloo_ranks_matches_the_reference_per_rank(tmp_path, world):
    rng = np.random.default_rng(world)
    d = {}
    for r in range(world):
        d[f"w{r}"] = (rng.normal(size=40) * (r + 1)).astype(np.float32)
        d[f"b{r}"] = rng.normal(size=(3, 4)).astype(np.float32)
        d[f"ew{r}"] = (rng.normal(size=40) * 1e-3).astype(np.float32)
        d[f"eb{r}"] = (rng.normal(size=(3, 4)) * 1e-3).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **d)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PSUM_RANK, str(world), str(r), str(tmp_path / "store"),
         str(tmp_path / "inputs.npz")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            _kill(p)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{err}"
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for key in ("w", "b"):
        deq, new_err = [], []
        for r in range(world):
            target = jnp.asarray(d[f"{key}{r}"]) + jnp.asarray(d[f"e{key}{r}"])
            q, s = ref_train.quantize_int8(target)
            deq.append(np.asarray(ref_train.dequantize_int8(q, s)))
            new_err.append(np.asarray(target) - deq[-1])
        want = np.sum(deq, axis=0) / world
        for r, out in enumerate(res):
            assert out["bad"] == []
            for how in ("mesh", "default"):
                np.testing.assert_allclose(out[how][key], want, rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(out[how][f"e{key}"], new_err[r],
                                           rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,host_id,num_hosts,n_codebooks",
                         [(0, 0, 1, 0), (7, 1, 4, 0), (3, 2, 3, 4), (11, 0, 2, 0)])
def test_token_stream_is_the_reference_s_bitwise(seed, host_id, num_hosts, n_codebooks):
    kw = dict(vocab=1000, batch=3, seq_len=17, seed=seed, host_id=host_id,
              num_hosts=num_hosts, n_codebooks=n_codebooks)
    ref, port = RefTokenStream(**kw), TokenStream(**kw)
    for step in (0, 1, 5, 123456):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])
    it = iter(port)
    assert np.array_equal(next(it)["tokens"], ref.batch_at(0)["tokens"])
    assert np.array_equal(next(it)["targets"], ref.batch_at(1)["targets"])


# --------------------------------------------------------------- grad guard
def test_the_attention_kernel_refuses_tensors_that_ask_for_a_gradient():
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    k, v = torch.randn(1, 1, 8, 32), torch.randn(1, 1, 8, 32)
    with pytest.raises(RuntimeError, match="no backward.*attn_impl='torch'"):
        fa_kernel.check_no_grad(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_kernel.flash_attention_cuda(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_kernel.flash_attention_cuda(q.detach(), k, v.requires_grad_(True))
    # not recording, or nothing asks for a gradient: the guard lets it
    # through to the card check
    with torch.no_grad():
        fa_kernel.check_no_grad(q, k, v)
    fa_kernel.check_no_grad(q.detach(), k, v.detach())
    if not torch.cuda.is_available():
        with torch.no_grad(), pytest.raises(RuntimeError, match="no CUDA device"):
            fa_kernel.flash_attention_cuda(q, k, v)
