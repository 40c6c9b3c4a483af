"""repro_torch's attention against the reference's on the CPU: the flash
kernel's plain version against the Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the dense oracle, the chunked plain path
against the reference's XLA path, and the kernel launcher's input checks.
Inputs come from a numpy seed and go to both as the same numbers."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as ref_fa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as ref_fa_ref  # noqa: E402
from repro.models.attention import chunked_attention as ref_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, flash_attention_plain)
from repro_torch.models.attention import chunked_attention  # noqa: E402

# (B, Hq, Hkv, Lq, Lk, D, causal): tests/test_kernels.py's sweep (MHA, GQA,
# MQA, Lq = 1 decode, padded 300), causal and not (decode causal only)
SWEEP = [(s + (c,)) for s in [(2, 4, 4, 64, 64, 32), (2, 4, 2, 100, 100, 32),
                              (1, 8, 1, 96, 96, 64), (2, 4, 2, 1, 64, 32),
                              (1, 2, 2, 300, 300, 16)]
         for c in (True, False) if c or s[3] > 1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, Hq, Hkv, Lq, Lk, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.as_tensor(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal", SWEEP)
def test_plain_f32_matches_pallas_kernel_and_oracle(B, Hq, Hkv, Lq, Lk, D, causal):
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, Lq, Lk, D, "float32")
    got = flash_attention_plain(q, k, v, causal=causal)
    kern = ref_fa_ops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(attention_ref(q, k, v, causal=causal)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal", SWEEP)
def test_plain_bf16_matches_pallas_kernel(B, Hq, Hkv, Lq, Lk, D, causal):
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, Lq, Lk, D, "bfloat16", seed=1)
    got = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    kern = ref_fa_ops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(kern), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_oracle_matches_reference_oracle(dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(2, 4, 2, 40, 70, 32, dtype, seed=2)
    got = attention_ref(q, k, v, causal=causal)
    want = ref_fa_ref.attention_ref(jq, jk, jv, causal=causal)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# Lq > Lk: the first Lq - Lk rows see no key.  The Pallas kernel returns the
# sum of V over its padded key count there (the mean of V when Lk <= 256);
# the dense oracle gives NaN.  Lk = 300 pads to two 256-key tiles.
@pytest.mark.parametrize("Lq,Lk", [(300, 100), (40, 7), (600, 300)])
def test_rows_without_keys_follow_the_pallas_kernel(Lq, Lk):
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, Lq, Lk, 32, "float32", seed=3)
    got = flash_attention_plain(q, k, v)
    kern = _np(ref_fa_ops.flash_attention(jq, jk, jv))
    np.testing.assert_allclose(_np(got), kern, rtol=1e-5, atol=1e-5)
    empty = Lq - Lk
    den = fa_kernel.empty_row_divisor(Lk)
    assert den == (Lk if Lk <= 256 else 512)
    # query head h reads KV head h // 2
    want = v.double().sum(dim=2).repeat_interleave(2, dim=1) / den
    np.testing.assert_allclose(_np(got)[:, :, :empty],
                               np.broadcast_to(want.numpy()[:, :, None],
                                               (1, 4, empty, 32)),
                               rtol=1e-5, atol=1e-6)
    assert np.isnan(_np(attention_ref(q, k, v))[:, :, :empty]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,Lk,causal", [(128, 128, True), (100, 130, True),
                                          (70, 70, False)])
def test_chunked_torch_path_matches_reference_xla_path(dtype, Lq, Lk, causal):
    (jq, jk, jv), (q, k, v) = _inputs(2, 4, 2, Lq, Lk, 32, dtype, seed=4)
    got = chunked_attention(q, k, v, causal=causal, q_chunk=64, k_chunk=32,
                            impl="torch")
    want = ref_chunked(jq, jk, jv, causal=causal, q_chunk=64, k_chunk=32)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_cuda_impl_on_cpu_tensors_runs_the_plain_version():
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, 50, 50, 32, "float32", seed=5)
    for kern in (fa_kernel.FLASH_ATTENTION_BF16, fa_kernel.FLASH_ATTENTION_F32):
        kern.launches = 0
    got = chunked_attention(q, k, v, impl="cuda")
    assert torch.equal(got, flash_attention_plain(q, k, v))
    assert torch.equal(fa_ops.flash_attention(q, k, v), got)
    assert fa_kernel.FLASH_ATTENTION_F32.launches == 0
    assert fa_kernel.FLASH_ATTENTION_BF16.launches == 0
    np.testing.assert_allclose(_np(got), _np(ref_chunked(jq, jk, jv, impl="pallas")),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes,dtype,match", [
    (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), torch.float32, "head sizes"),
    (((1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 8, 48)), torch.float32, "V's head size"),
    (((1, 3, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)), torch.float32, "multiple"),
    (((1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)), torch.float16, "bfloat16 or float32"),
])
def test_kernel_launcher_rejects_what_it_does_not_take(shapes, dtype, match):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises((ValueError, TypeError), match=match):
        fa_kernel.flash_attention_cuda(q, k, v)


def test_kernel_launcher_never_falls_back_to_the_cpu():
    q = torch.zeros((1, 2, 8, 32))
    before = fa_kernel.FLASH_ATTENTION_F32.launches
    # no card: RuntimeError; a card but CPU tensors: ValueError
    with pytest.raises((RuntimeError, ValueError)):
        fa_kernel.flash_attention_cuda(q, q, q)
    assert fa_kernel.FLASH_ATTENTION_F32.launches == before
