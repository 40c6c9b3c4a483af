"""repro_torch.models.ssm against repro.models.ssm on the CPU: the causal
conv, Mamba1's and Mamba2's forward (at a length the chunk divides and at
a padded one) and decode with its cache, on the reference's weights of
reduced falcon-mamba-7b (Mamba1) and zamba2-1.2b (Mamba2) carried across by
``params_from_jax``; and the reference's chunk-size invariance.

Tolerances: float32 within 1e-4 and bfloat16 within 5e-2 (the bars of
tests/test_torch_models.py: the port follows the reference's dtype
promotions, and Mamba1's doubling scan sums in another order than
``jax.lax.associative_scan``); chunks 4, 8 and 24 within 2e-4 of each
other, the reference's own bar (tests/test_models_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
VERSIONS = {1: "falcon-mamba-7b", 2: "zamba2-1.2b"}
CASES = [(v, d) for v in VERSIONS for d in TOL]
STATE = {1: "h", 2: "S"}


def _cfgs(version, dtype, **kw):
    kw = dict(dtype=dtype, remat=False, **kw)
    arch = VERSIONS[version]
    return (ref_configs.reduced_config(ref_configs.ARCHS[arch], **kw),
            configs.reduced_config(configs.ARCHS[arch], **kw))


@pytest.fixture(scope="module")
def mixers():
    """{(version, dtype): (ref cfg, port cfg, ref mixer, port mixer)}: layer
    0's mixer of the reference's reduced model (key 1), carried across."""
    out = {}
    for version, dtype in CASES:
        rcfg, tcfg = _cfgs(version, dtype)
        rp = ref_models.init_params(rcfg, jax.random.PRNGKey(1))
        tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
        out[version, dtype] = (rcfg, tcfg, jax.tree.map(lambda a: a[0], rp["layers"])["mixer"],
                               tp["layers"][0]["mixer"])
    return out


def _dtypes(dtype):
    return (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                      torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("window", [1, 4])
def test_causal_conv_matches_the_reference(dtype, window):
    jdt, tdt = _dtypes(dtype)
    rng = np.random.default_rng(window)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(12, window)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(b, jdt), window)
    got = ssm._causal_conv(*(torch.as_tensor(a).to(tdt) for a in (x, w, b)), window)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("version,dtype", CASES)
@pytest.mark.parametrize("L", [32, 21])
def test_mixer_forward_matches_the_reference(mixers, version, dtype, L):
    """L = 32 is two chunks of the reduced configs' 16; 21 pads the last."""
    rcfg, tcfg, rmix, tmix = mixers[version, dtype]
    jdt, tdt = _dtypes(dtype)
    x = np.random.default_rng(L).normal(size=(2, L, rcfg.d_model)).astype(np.float32)
    fwd = (ref_ssm.mamba1_forward, ssm.mamba1_forward) if version == 1 else \
        (ref_ssm.mamba2_forward, ssm.mamba2_forward)
    want = fwd[0](rmix, rcfg, jnp.asarray(x, jdt))
    got = fwd[1](tmix, tcfg, torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("version,dtype", CASES)
def test_mixer_decode_and_its_cache_match_the_reference(mixers, version, dtype):
    rcfg, tcfg, rmix, tmix = mixers[version, dtype]
    jdt, tdt = _dtypes(dtype)
    rng = np.random.default_rng(5)
    B, di, s = 2, rcfg.d_inner, rcfg.ssm_state
    state = (B, di, s) if version == 1 else (B, rcfg.ssm_heads, s, rcfg.mamba_headdim)
    conv = rng.normal(size=(B, rcfg.ssm_conv - 1, di)).astype(np.float32)
    st = rng.normal(size=state).astype(np.float32)
    key = STATE[version]
    rcache = {"conv": jnp.asarray(conv, jdt), key: jnp.asarray(st)}
    tcache = {"conv": torch.as_tensor(conv).to(tdt), key: torch.as_tensor(st)}
    dec = (ref_ssm.mamba1_decode, ssm.mamba1_decode) if version == 1 else \
        (ref_ssm.mamba2_decode, ssm.mamba2_decode)
    for t in range(3):
        x = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
        want, rcache = dec[0](rmix, rcfg, jnp.asarray(x, jdt), rcache)
        conv_t, st_t = tcache["conv"], tcache[key]
        got, out = dec[1](tmix, tcfg, torch.as_tensor(x).to(tdt), tcache)
        # written in place
        assert out is tcache and out["conv"] is conv_t and out[key] is st_t
        assert got.dtype == tdt and st_t.dtype == torch.float32 and conv_t.dtype == tdt
        _close(got, want, TOL[dtype])
        _close(conv_t, rcache["conv"], TOL[dtype])
        _close(st_t, rcache[key], TOL[dtype])


@pytest.mark.parametrize("version", list(VERSIONS))
def test_chunk_size_invariance(version):
    """The reference's test_ssm_chunk_size_invariance on the port: one
    float32 model without the shared block at chunks 4, 8 and 24 (L = 24)
    within 2e-4; a padded chunk (5: four full chunks and one of 4) within
    1e-4 of the reference's at that chunk."""
    rcfg, tcfg = _cfgs(version, "float32", attn_every=0)
    rp = ref_models.init_params(rcfg, jax.random.PRNGKey(2))
    tp = models.params_from_jax(tcfg, jax.tree.map(np.asarray, rp))
    assert "shared_attn" not in tp
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, size=(2, 24))
    batch = {"tokens": torch.as_tensor(toks)}
    outs = [models.forward(dataclasses.replace(tcfg, ssm_chunk=c), tp, batch,
                           attn_impl="torch")[0].numpy() for c in (4, 8, 24)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-4)
    want, _ = ref_models.forward(dataclasses.replace(rcfg, ssm_chunk=5), rp,
                                 {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = models.forward(dataclasses.replace(tcfg, ssm_chunk=5), tp, batch,
                            attn_impl="torch")
    _close(got, want, 1e-4)


def test_doubling_scan_is_the_sequential_recurrence():
    """The intra-chunk scan against the plain loop h_t = a_t h_{t-1} + b_t,
    in float64, at a length that is not a power of two."""
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 13, 3, 4), generator=g, dtype=torch.float64)
    b = torch.randn((2, 13, 3, 4), generator=g, dtype=torch.float64)
    aa, hh = ssm._doubling_scan(a, b)
    h, p = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(13):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        torch.testing.assert_close(hh[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(aa[:, t], p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("version", list(VERSIONS))
def test_port_init_matches_the_reference_s_init(version):
    """The port's own mixer init: the reference's layout, dtypes (A_log, D
    and dt_bias float32 in a bfloat16 model) and deterministic values."""
    rcfg, tcfg = _cfgs(version, "bfloat16")
    rmix = jax.tree.map(lambda a: a[0], ref_models.init_params(
        rcfg, jax.random.PRNGKey(0))["layers"])["mixer"]
    mine = (ssm.init_mamba1 if version == 1 else ssm.init_mamba2)(
        torch.Generator().manual_seed(0), tcfg)
    assert sorted(mine) == sorted(rmix)
    for name, want in rmix.items():
        got = mine[name]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == torch.bfloat16
                assert tuple(got[k].shape) == want[k].shape, (name, k)
            continue
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
        if name in ("A_log", "D", "dt_bias", "conv_b"):
            # log(1..s) to float32 rounding: torch's and XLA's log may differ in the last bit
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-7, atol=0, err_msg=name)
    assert {name: mine[name].dtype for name in ("A_log", "D")} == {
        "A_log": torch.float32, "D": torch.float32}
    if version == 2:
        assert mine["dt_bias"].dtype == torch.float32
    W = tcfg.ssm_conv
    assert mine["conv"].float().abs().max() <= 2 * W ** -0.5 * (1 + 2 ** -7)


def test_ssd_gradient_stays_finite_where_a_chunk_s_decays_overflow(mixers):
    """Strong decays (Δ ≈ 2.1) over a 128-step chunk, zamba2-1.2b's: above
    the diagonal the decays' log sums pass float32's exp limit.  The
    reference masks after the exp, so its gradient turns NaN there; the
    port masks before it.  Its forward at chunk 128 is the reference's
    (1e-4), and its gradient is the reference's at chunk 8, where nothing
    overflows, within 2e-4 (the chunk-invariance bar)."""
    rcfg, tcfg, rmix, tmix = mixers[2, "float32"]
    rcfg = {c: dataclasses.replace(rcfg, ssm_chunk=c) for c in (8, 128)}
    tcfg = dataclasses.replace(tcfg, ssm_chunk=128)
    rmix = dict(rmix, dt_bias=rmix["dt_bias"] + 2.0)
    x = np.random.default_rng(3).normal(size=(2, 128, tcfg.d_model)).astype(np.float32)

    def ref(c):
        return jax.value_and_grad(
            lambda p: ref_ssm.mamba2_forward(p, rcfg[c], jnp.asarray(x)).sum())(rmix)

    (_, grad8), (_, grad128) = ref(8), ref(128)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(grad128))
    p = {k: v.detach().clone() for k, v in tmix.items() if isinstance(v, torch.Tensor)}
    p["dt_bias"] = p["dt_bias"] + 2.0
    for v in p.values():
        v.requires_grad_(True)
    out = ssm.mamba2_forward({**tmix, **p}, tcfg, torch.as_tensor(x))
    _close(out, ref_ssm.mamba2_forward(rmix, rcfg[128], jnp.asarray(x)), 1e-4)
    out.sum().backward()
    for name, v in p.items():
        assert torch.isfinite(v.grad).all(), name
        g = np.asarray(grad8[name])
        np.testing.assert_allclose(v.grad.numpy(), g, rtol=2e-4,
                                   atol=2e-4 * np.abs(g).max(), err_msg=name)
