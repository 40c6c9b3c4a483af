"""repro_torch.ops.autotune, the counterpart of tests/test_autotune.py: the
tuning cache's lifecycle (round trip; a corrupt cache, a wrong schema
version, a stale kernel fingerprint, and a CUDA source edit all fall back to
the untuned rules), the promotion rules (a tuned backend must have beaten
the numpy oracle, cuda is never promoted without a card, a pinned op also
needs a certificate: a compensated config's or the card's exact float64
path's), the selection order (override and env beat a tuned entry,
``REPRO_TORCH_OPS_PRECISION=f64`` holds the pin), the counters, the tuner
(winners, certificates, failed candidates recorded, cuda skipped without a
card, the CLI), and the compensated float32 twins at the reference's awkward
shapes against the numpy oracle and against the reference's own xla
backend with the same config, both within ``PARITY_RTOL`` (1e-6 of the
output's largest magnitude, ``_scaled_rel_err``)."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as ref_core  # noqa: E402
from repro import ops as ref_ops  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import SignalCoreset  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.ops import autotune  # noqa: E402

RNG = np.random.default_rng(7)
SRC = autotune.pathlib.Path(autotune.__file__).resolve().parents[2]


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    """A private cache file per test; the module cache reloads on repoint."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV_VAR, str(path))
    for var in (autotune.DISABLE_ENV_VAR, autotune.PRECISION_ENV_VAR, ops.ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    autotune.reset_cache()
    yield path
    autotune.reset_cache()


@pytest.fixture()
def card(monkeypatch):
    """Set whether ``torch.cuda.is_available()`` says a card is present;
    the cache keys stay this host's (``device_kind`` is read first)."""
    autotune.device_kind()

    def set_card(present: bool):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: present)
    set_card(False)
    return set_card


def _seed_entry(op, backend, size, *, us=10.0, numpy_us=100.0, config=None,
                rel_err=None):
    """Plant a measured-looking entry at size's bucket; returns the bucket."""
    bucket = autotune.shape_bucket(size)
    entry = {"config": config or {}, "us": us, "numpy_us": numpy_us,
             "size": int(size), "bucket": bucket}
    if rel_err is not None:
        entry["rel_err"] = rel_err
    autotune.get_cache().put(op, backend, bucket, entry)
    return bucket


# fitting_loss_batched is not precision-pinned; with no card and no pin
# selection raises, so any backend selected below came from the cache
_OP, _SIZE = "fitting_loss_batched", 1024
_HIST_SIZE = 40_000 * 4


def _untuned(op, size):
    with pytest.raises(RuntimeError, match="pin backend"):
        ops.select_backend(op, size)


# --------------------------------------------------------------- lifecycle
def test_cache_round_trip(tune_cache):
    _seed_entry(_OP, "torch", _SIZE, config={"tile_b": 256})
    saved = autotune.get_cache().save()
    assert saved == tune_cache
    autotune.reset_cache()
    cache = autotune.get_cache()
    assert cache.loaded_from_disk
    entry = cache.get(_OP, "torch", autotune.shape_bucket(_SIZE))
    assert entry is not None and entry["config"] == {"tile_b": 256}
    doc = json.loads(tune_cache.read_text())
    assert doc["fingerprint"] == autotune.kernel_fingerprint()
    assert list(doc["entries"]) == [
        f"{_OP}|torch|{autotune.device_kind()}|{autotune.shape_bucket(_SIZE)}"]


def test_corrupt_cache_falls_back_cleanly(tune_cache, card):
    tune_cache.write_text("{corrupt json")
    before = autotune.counters_snapshot()["cache_load_errors"]
    autotune.reset_cache()
    cache = autotune.get_cache()
    assert not cache.entries and not cache.loaded_from_disk
    assert autotune.counters_snapshot()["cache_load_errors"] == before + 1
    # dispatch survives on the untuned rules
    _untuned(_OP, _SIZE)
    np.testing.assert_allclose(
        ops.sat_moments([[1.0, 2.0], [3.0, 4.0]], backend="torch")[0, -1, -1],
        4.0)


@pytest.mark.parametrize("doc", [
    {"version": 999, "fingerprint": None, "entries": {}},       # wrong schema
    {"version": autotune.SCHEMA_VERSION, "fingerprint": "0" * 12,
     "entries": {}},                                            # stale kernels
], ids=["schema-version", "kernel-fingerprint"])
def test_stale_cache_discarded(tune_cache, card, doc):
    if doc["fingerprint"] is None:
        doc["fingerprint"] = autotune.kernel_fingerprint()
    doc["entries"] = {autotune.TuneCache.key(
        _OP, "torch", autotune.device_kind(), autotune.shape_bucket(_SIZE)):
        {"config": {}, "us": 1.0, "numpy_us": 100.0}}
    tune_cache.write_text(json.dumps(doc))
    before = autotune.counters_snapshot()["cache_load_errors"]
    autotune.reset_cache()
    assert not autotune.get_cache().entries
    assert autotune.counters_snapshot()["cache_load_errors"] == before + 1
    _untuned(_OP, _SIZE)


@pytest.mark.parametrize("source", ["csrc/sat2d.cu", "csrc/common.cuh",
                                    "kernels/histsplit/ref.py",
                                    "ops/backends.py"])
def test_fingerprint_follows_kernel_sources(tmp_path, source):
    # a copied tree fingerprints as this one until one of its kernel
    # sources changes: an entry tuned against an older .cu is stale
    pkg = tmp_path / "repro_torch"
    shutil.copytree(SRC / "repro_torch", pkg, ignore=shutil.ignore_patterns("__pycache__"))
    assert autotune._fingerprint(pkg) == autotune.kernel_fingerprint()
    with open(pkg / source, "a") as f:
        f.write("\n// edited\n" if source.endswith(("cu", "cuh")) else "\n# edited\n")
    assert autotune._fingerprint(pkg) != autotune.kernel_fingerprint()


# ---------------------------------------------------------------- promotion
def test_promotion_requires_beating_numpy(tune_cache, card):
    _seed_entry(_OP, "torch", _SIZE, us=500.0, numpy_us=100.0)   # oracle won
    _untuned(_OP, _SIZE)
    _seed_entry(_OP, "torch", _SIZE, us=10.0, numpy_us=100.0)    # tuned win
    before = autotune.counters_snapshot()["tuned_dispatch"]
    assert ops.select_backend(_OP, _SIZE) == "torch"
    assert autotune.counters_snapshot()["tuned_dispatch"] == before + 1
    # a different bucket is a cold miss: the untuned rules again
    _untuned(_OP, 1 << 20)
    card(True)
    assert ops.select_backend(_OP, 1 << 20) == "cuda"


def test_cuda_never_promoted_without_card(tune_cache, card):
    _seed_entry(_OP, "cuda", _SIZE, us=1.0, numpy_us=100.0)
    assert autotune.tuned_backend(_OP, _SIZE) is None
    _untuned(_OP, _SIZE)
    card(True)
    _seed_entry(_OP, "cuda", _SIZE, us=1.0, numpy_us=100.0)   # fresh decision
    assert ops.select_backend(_OP, _SIZE) == "cuda"


def test_tuned_bucket_where_numpy_won_falls_through_to_the_card(tune_cache, card):
    # as on a TPU in the reference: nothing beat numpy, so the card decides
    card(True)
    _seed_entry(_OP, "torch", _SIZE, us=500.0, numpy_us=100.0)
    _seed_entry(_OP, "cuda", _SIZE, us=400.0, numpy_us=100.0)
    assert ops.select_backend(_OP, _SIZE) == "cuda"


@pytest.mark.parametrize("mode", ["f64", "compensated", "fast"])
@pytest.mark.parametrize("op,config,rel_err", [
    (_OP, {}, 1e-7),
    ("sat_moments", {"compensated": True}, 2e-10),
    ("sat_moments", {"compensated": False}, 0.0),
    ("hist_split", {"variant": "chunked", "compensated": True}, 2e-8),
])
def test_torch_never_promoted_with_card(tune_cache, card, monkeypatch, mode,
                                        op, config, rel_err):
    # torch is the CPU: where a card is present, a torch entry that beat
    # numpy and the card at tune time never takes dispatch off the card
    card(True)
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, mode)
    size = 1 << 17
    cuda_cfg = {"variant": "f64"} if op == "hist_split" else (
        {"dtype": "float64"} if op in ops.PINNED_OPS else {})
    _seed_entry(op, "torch", size, us=5.0, numpy_us=100.0, config=config,
                rel_err=rel_err)
    assert autotune.tuned_backend(op, size) is None
    _seed_entry(op, "cuda", size, us=50.0, numpy_us=100.0, config=cuda_cfg,
                rel_err=0.0)
    assert autotune.tuned_backend(op, size) in (
        (None,) if op in ops.PINNED_OPS and mode == "f64" else ("cuda",))
    assert ops.select_backend(op, size) == "cuda"


def test_promoted_f32_counts_only_float32_picks(tune_cache, card, monkeypatch):
    # the card's float64 path of a pinned op is a tuned pick, not a float32
    # promotion; its float32 path (fast mode) is one
    card(True)
    size = 1 << 17
    counts = autotune.counters_snapshot
    _seed_entry("sat_moments", "cuda", size, config={"dtype": "float64"},
                rel_err=0.0)
    before = counts()
    assert autotune.tuned_backend("sat_moments", size) == "cuda"
    assert counts()["tuned_dispatch"] == before["tuned_dispatch"] + 1
    assert counts()["promoted_f32"] == before["promoted_f32"]
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "fast")
    _seed_entry("sat_moments", "cuda", size, config={"dtype": "float32"},
                rel_err=1e-7)
    assert autotune.tuned_backend("sat_moments", size) == "cuda"
    assert counts()["promoted_f32"] == before["promoted_f32"] + 1


def test_override_and_env_beat_tuned(tune_cache, card, monkeypatch):
    _seed_entry(_OP, "torch", _SIZE, us=10.0, numpy_us=100.0)
    assert ops.select_backend(_OP, _SIZE) == "torch"
    monkeypatch.setenv(ops.ENV_VAR, "numpy")
    assert ops.select_backend(_OP, _SIZE) == "numpy"
    monkeypatch.delenv(ops.ENV_VAR)
    with ops.backend_override("numpy"):
        assert ops.select_backend(_OP, _SIZE) == "numpy"
    assert ops.select_backend(_OP, _SIZE) == "torch"
    assert ops.selected_backend(_OP, _SIZE, backend="numpy") == "numpy"


def test_disable_env_kills_tuned_selection(tune_cache, card, monkeypatch):
    _seed_entry(_OP, "torch", _SIZE, us=10.0, numpy_us=100.0,
                config={"tile_b": 1})
    monkeypatch.setenv(autotune.DISABLE_ENV_VAR, "0")
    assert autotune.tuned_backend(_OP, _SIZE) is None
    _untuned(_OP, _SIZE)
    assert autotune.plan(_OP, "torch", _SIZE) == {}


def test_pinned_promotion_needs_parity_certificate(tune_cache, card):
    # hist_split is precision-pinned: a win alone must not lift the pin
    _seed_entry("hist_split", "torch", _HIST_SIZE, us=10.0, numpy_us=100.0,
                config={"variant": "flat", "compensated": False}, rel_err=1e-9)
    _untuned("hist_split", _HIST_SIZE)
    # compensated but failing the certificate: the pin still holds
    _seed_entry("hist_split", "torch", _HIST_SIZE, us=10.0, numpy_us=100.0,
                config={"variant": "chunked", "compensated": True},
                rel_err=5e-6)
    _untuned("hist_split", _HIST_SIZE)
    # compensated with a passing certificate: promoted, and counted
    before = autotune.counters_snapshot()["promoted_f32"]
    _seed_entry("hist_split", "torch", _HIST_SIZE, us=10.0, numpy_us=100.0,
                config={"variant": "chunked", "compensated": True},
                rel_err=2e-8)
    assert ops.select_backend("hist_split", _HIST_SIZE) == "torch"
    assert autotune.counters_snapshot()["promoted_f32"] == before + 1


@pytest.mark.parametrize("op,exact,plain", [
    ("hist_split", {"variant": "f64"}, {"variant": "fused", "tile_p": 2048}),
    ("sat_moments", {"dtype": "float64"}, {"dtype": "float32"}),
    ("delta_sat", {"dtype": "float64"}, {"dtype": "float32"}),
    ("streaming_compress", {"dtype": "float64"}, {"dtype": "float32"}),
])
def test_card_float64_path_carries_its_certificate(tune_cache, card,
                                                   monkeypatch, op, exact, plain):
    # the card's native float64 path is exact (rel_err 0), so it lifts a pin
    # in compensated mode; a plain float32 config only in fast mode; f64
    # mode never lifts it
    card(True)
    size = 1 << 17
    _seed_entry(op, "cuda", size, us=10.0, numpy_us=100.0, config=plain,
                rel_err=1e-8)
    assert ops.select_backend(op, size) == "cuda"     # the untuned card rule
    assert autotune.tuned_backend(op, size) is None   # ... not a promotion
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "fast")
    assert autotune.tuned_backend(op, size) == "cuda"
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "compensated")
    _seed_entry(op, "cuda", size, us=10.0, numpy_us=100.0, config=exact,
                rel_err=0.0)
    assert autotune.tuned_backend(op, size) == "cuda"
    # an exact config whose certificate is missing or fails is no promotion
    _seed_entry(op, "cuda", size, us=10.0, numpy_us=100.0, config=exact)
    assert autotune.tuned_backend(op, size) is None
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "f64")
    _seed_entry(op, "cuda", size, us=10.0, numpy_us=100.0, config=exact,
                rel_err=0.0)
    assert autotune.tuned_backend(op, size) is None


def test_a_float32_winner_does_not_hide_the_allowed_pick(tune_cache, card,
                                                        monkeypatch):
    # the card's float32 scan won, its float64 path (exact) came second:
    # in compensated and f64 modes dispatch and plan take the float64 path,
    # not the slower torch backend, and fast mode takes the winner
    card(True)
    size = 1 << 17
    bucket = autotune.shape_bucket(size)
    f64 = {"config": {"dtype": "float64"}, "us": 20.0, "rel_err": 0.0}
    autotune.get_cache().put("sat_moments", "cuda", bucket, {
        "config": {"dtype": "float32"}, "us": 10.0, "numpy_us": 100.0,
        "rel_err": 1e-7, "modes": {"compensated": f64, "f64": f64}})
    autotune.get_cache().put("sat_moments", "torch", bucket, {
        "config": {"compensated": False}, "us": 50.0, "numpy_us": 100.0,
        "rel_err": 0.0})
    for mode, backend, cfg in (("compensated", "cuda", {"dtype": "float64"}),
                               ("f64", "cuda", {"dtype": "float64"}),
                               ("fast", "cuda", {"dtype": "float32"})):
        monkeypatch.setenv(autotune.PRECISION_ENV_VAR, mode)
        assert ops.select_backend("sat_moments", size) == backend, mode
        assert autotune.plan("sat_moments", "cuda", size) == cfg, mode


def test_precision_mode_f64_and_fast(tune_cache, card, monkeypatch):
    _seed_entry("hist_split", "torch", _HIST_SIZE, us=10.0, numpy_us=100.0,
                config={"variant": "chunked", "compensated": True},
                rel_err=2e-8)
    assert ops.select_backend("hist_split", _HIST_SIZE) == "torch"
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "f64")   # escape hatch
    _untuned("hist_split", _HIST_SIZE)
    # fast mode waives the certificate entirely
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "fast")
    _seed_entry("hist_split", "torch", _HIST_SIZE, us=10.0, numpy_us=100.0,
                config={"variant": "flat", "compensated": False})
    assert ops.select_backend("hist_split", _HIST_SIZE) == "torch"


def test_plan_serves_config_and_counts(tune_cache):
    before = autotune.counters_snapshot()
    assert autotune.plan(_OP, "torch", _SIZE) == {}          # cold miss
    _seed_entry(_OP, "torch", _SIZE, config={"tile_b": 512})
    assert autotune.plan(_OP, "torch", _SIZE) == {"tile_b": 512}
    assert autotune.plan(_OP, "numpy", _SIZE) == {}          # oracle untouched
    after = autotune.counters_snapshot()
    assert after["cache_miss"] == before["cache_miss"] + 1
    assert after["cache_hit"] == before["cache_hit"] + 1


@pytest.mark.parametrize("op,config,rel_err,served_in", [
    ("sat_moments", {"dtype": "float32"}, 1e-8, {"fast"}),
    ("hist_split", {"variant": "fused", "tile_p": 512}, 1e-8, {"fast"}),
    ("hist_split", {"variant": "partials", "compensated": True, "tile_p": 1024},
     2e-8, {"fast", "compensated"}),
    ("hist_split", {"variant": "partials", "compensated": True, "tile_p": 1024},
     5e-6, {"fast"}),
    ("delta_sat", {"dtype": "float64"}, 0.0, {"fast", "compensated", "f64"}),
    ("streaming_compress", {"compensated": False}, 0.0,
     {"fast", "compensated", "f64"}),
    (_OP, {"tile_b": 512}, None, {"fast", "compensated", "f64"}),
])
def test_plan_serves_a_pinned_op_only_what_the_mode_allows(
        tune_cache, monkeypatch, op, config, rel_err, served_in):
    # the card computes in float64 by default, so a float32 winner of a
    # pinned op must not reach it through plan() where the mode forbids it
    backend = "torch" if "compensated" in config and "variant" not in config \
        else "cuda"
    _seed_entry(op, backend, 1 << 17, config=config, rel_err=rel_err)
    for mode in ("f64", "compensated", "fast"):
        monkeypatch.setenv(autotune.PRECISION_ENV_VAR, mode)
        held = autotune.counters_snapshot()["pin_held"]
        want = config if mode in served_in else {}
        assert autotune.plan(op, backend, 1 << 17) == want, mode
        assert autotune.counters_snapshot()["pin_held"] == held + (not want)


def test_dispatch_runs_the_planned_config(tune_cache, monkeypatch):
    monkeypatch.setenv(autotune.PRECISION_ENV_VAR, "fast")
    y = RNG.normal(size=(40, 30)) + 1e4
    _seed_entry("sat_moments", "torch", 3 * y.size, config={"dtype": "float32"})
    got = ops.sat_moments(y, backend="torch")
    assert got.dtype == np.float32
    assert np.array_equal(got, ops.sat_moments(y, backend="torch",
                                               config={"dtype": "float32"}))
    with pytest.raises(ValueError, match="config keys"):
        ops.sat_moments(y, backend="torch", config={"tile": 256})


# ------------------------------------------------------------------- tuning
def test_tune_op_records_winner_and_certificate(tune_cache, card):
    winners = autotune.tune_op("sat_moments", budget="quick")
    assert winners["cuda"] == {"skipped": "no CUDA device"}
    entry = winners["torch"]
    assert entry["us"] > 0 and entry["numpy_us"] > 0
    assert {c["config"]["compensated"] for c in entry["candidates"]} == {False, True}
    assert entry["failed"] == []
    # every candidate's certificate: the float64 default is exact, the
    # compensated twin within the bound
    for c in entry["candidates"]:
        assert c["rel_err"] == 0.0 if not c["config"]["compensated"] \
            else c["rel_err"] <= autotune.PARITY_RTOL
    # sat_moments is pinned: the fastest candidate each mode allows
    fastest = {c["config"]["compensated"]: c for c in entry["candidates"]}
    assert entry["modes"]["f64"] == fastest[False]
    assert entry["modes"]["compensated"] == min(fastest.values(),
                                                key=lambda c: c["us"])
    bucket = entry["bucket"]
    stored = autotune.get_cache().get("sat_moments", "torch", bucket)
    assert stored == {k: v for k, v in entry.items()
                      if k not in ("candidates", "failed")}
    assert autotune.get_cache().get("sat_moments", "cuda", bucket) is None


def test_tune_op_records_a_failed_candidate(tune_cache, card, monkeypatch,
                                            capsys):
    monkeypatch.setitem(autotune.SEARCH_SPACE["hist_split"], "torch",
                        [{"variant": "vmap", "compensated": False},
                         {"variant": "no_such_variant"}])
    winners = autotune.tune_op("hist_split", budget="quick")
    [failed] = winners["torch"]["failed"]
    assert failed["config"] == {"variant": "no_such_variant"}
    assert "no_such_variant" in failed["error"]
    assert winners["torch"]["config"] == {"variant": "vmap", "compensated": False}
    assert "no_such_variant" in capsys.readouterr().err


def test_cli_tunes_torch_and_skips_cuda_without_a_card(tmp_path):
    cache = tmp_path / "t.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.ops.autotune", "--budget", "quick",
         "--cache", str(cache), "--json", "--ops", "sat_moments,hist_split"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**autotune.os.environ, "PYTHONPATH": str(SRC),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["device"] == "cpu" and summary["entries"] == 2
    for op in ("sat_moments", "hist_split"):
        assert summary["tuned"][op]["cuda"] == {"skipped": "no CUDA device"}
        assert summary["tuned"][op]["torch"]["failed"] == []
    doc = json.loads(cache.read_text())
    assert doc["fingerprint"] == autotune.kernel_fingerprint()


# -------------------------------------------- compensated float32 parity
def _rel(got, want):
    return autotune._scaled_rel_err(got, want)


def _both_within(op_call, ref_call, want):
    got = op_call()
    assert _rel(got, want) <= autotune.PARITY_RTOL
    assert _rel(got, ref_call()) <= autotune.PARITY_RTOL


def test_compensated_sat_parity_off_tile_quantum():
    # 131 x 67: off the 128-row tile quantum, a large offset so the plain
    # float32 scan's error shows beside the two-float path's
    y = RNG.normal(size=(131, 67)) + 1e6
    cfg = {"compensated": True}
    want = ops.sat_moments(y, backend="numpy")
    assert 10 * _rel(ops.sat_moments(y, backend="torch", config=cfg), want) \
        < _rel(ops.sat_moments(y, backend="torch", config={"dtype": "float32"}), want)
    _both_within(lambda: ops.sat_moments(y, backend="torch", config=cfg),
                 lambda: ref_ops.sat_moments(y, backend="xla", config=cfg), want)


def test_compensated_delta_sat_parity():
    y = RNG.normal(size=(34, 257)) + 1e5      # odd band, off-quantum width
    carry = ops.sat_moments(y[:1], backend="numpy")[:, 0, :]
    cfg = {"compensated": True}
    want = ops.delta_sat(carry, y[1:], backend="numpy")
    _both_within(lambda: ops.delta_sat(carry, y[1:], backend="torch", config=cfg),
                 lambda: ref_ops.delta_sat(carry, y[1:], backend="xla",
                                           config=cfg), want)


def test_compensated_chained_delta_sat_stays_certified():
    # the carry enters as its own pair: three chained patches stay within
    # the bound of the float64 build
    y = RNG.normal(size=(96, 129)) + 1e5
    sat = ops.sat_moments(y[:32], backend="torch", config={"compensated": True})
    for r0 in (32, 64):
        rows = ops.delta_sat(sat[:, -1, :], y[r0:r0 + 32], backend="torch",
                             config={"compensated": True})
        sat = np.concatenate([sat, rows], axis=1)
    assert _rel(sat, ops.sat_moments(y, backend="numpy")) <= autotune.PARITY_RTOL


def _hist_problem(P, F, B, zero_frac=0.0):
    codes = RNG.integers(0, B, size=(P, F)).astype(np.uint8)
    w = RNG.uniform(0.5, 1.5, P)
    if zero_frac:
        w[RNG.random(P) < zero_frac] = 0.0    # zero-weight rows must vanish
    yv = RNG.normal(size=P) + 100.0
    return codes, w, w * yv, w * yv * yv


@pytest.mark.parametrize("config,ref_backend", [
    ({"variant": "chunked", "compensated": True}, "xla"),
    ({"variant": "partials", "compensated": True, "tile_p": 512}, "pallas"),
], ids=["chunked", "partials"])
@pytest.mark.parametrize("P,F,B,zero_frac", [(4097, 3, 16, 0.1), (1023, 2, 1, 0.0)],
                         ids=["awkward", "single-bin"])
def test_compensated_hist_parity(config, ref_backend, P, F, B, zero_frac):
    # P = 4097: off both the 512 tile and the 8192 chunk quantum; one bin:
    # the degenerate histogram
    args = _hist_problem(P, F, B, zero_frac)
    want = ops.hist_split(*args, B, backend="numpy")
    ref_kw = {"interpret": True} if ref_backend == "pallas" else {}
    _both_within(lambda: ops.hist_split(*args, B, backend="torch", config=config),
                 lambda: ref_ops.hist_split(*args, B, backend=ref_backend,
                                            config=config, **ref_kw), want)


@pytest.mark.parametrize("variant", ["vmap", "flat"])
def test_plain_xla_hist_lowerings_match_reference(variant):
    # the reference's float32 lowerings: the same sums in float32, within
    # the reference's tolerance for its float32 histograms (2e-4)
    args = _hist_problem(4097, 3, 16, 0.1)
    cfg = {"variant": variant, "compensated": False}
    got = ops.hist_split(*args, 16, backend="torch", config=cfg)
    np.testing.assert_allclose(
        got, ref_ops.hist_split(*args, 16, backend="xla", config=cfg),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, ops.hist_split(*args, 16, backend="numpy"),
                               rtol=2e-4, atol=2e-4)


def _carried(cs):
    d = {f: getattr(cs, f) for f in SignalCoreset._SCALARS + SignalCoreset._ARRAYS}
    d["bicriteria"] = vars(cs.bicriteria)
    return SignalCoreset.from_arrays(d)


def test_compensated_streaming_compress_parity():
    y = piecewise_signal(64, 44, 5, noise=0.15, seed=23) + 1e3
    parts = [ref_core.signal_coreset(y[a:b], 5, 0.3) for a, b in ((0, 32), (32, 64))]
    buckets = [ref_core.compose(parts, [0, 32], n_total=64),
               ref_core.compose(parts[:1], [0], n_total=32)]
    cfg = {"compensated": True}

    def moments(out):
        return autotune._comparable("streaming_compress", out)
    want = moments(ops.streaming_compress([_carried(b) for b in buckets],
                                          backend="numpy"))
    _both_within(
        lambda: moments(ops.streaming_compress([_carried(b) for b in buckets],
                                               backend="torch", config=cfg)),
        lambda: moments(ref_ops.streaming_compress(buckets, backend="xla",
                                                   config=cfg)), want)


def test_comp_cumsum_is_an_inclusive_two_float_scan():
    # against float64 cumsum, at lengths around powers of two (the
    # log-step scan's edges)
    from repro_torch.kernels.sat2d.ref import comp_cumsum, split_hi_lo
    for n in (1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257):
        x = RNG.normal(size=(3, n)) + 1e6
        hi, lo = comp_cumsum(*split_hi_lo(torch.as_tensor(x)), dim=1)
        got = hi.double().numpy() + lo.double().numpy()
        assert _rel(got, np.cumsum(x, axis=1)) <= 1e-12


# ------------------------------------------------------------ service plane
def test_engine_stats_surface_autotune(tune_cache):
    from repro_torch.service.engine import CoresetEngine
    _seed_entry(_OP, "torch", _SIZE, us=10.0, numpy_us=100.0)
    assert ops.select_backend(_OP, _SIZE) == "torch"   # bump tuned_dispatch
    eng = CoresetEngine(cache_bytes=1 << 20, workers=1)
    try:
        st = eng.stats()
        assert st["ops_autotune"]["entries"] == 1
        assert st["ops_autotune"]["enabled"] is True
        counters = st["metrics"]["counters"]
        assert counters.get("ops_autotune_tuned_dispatch", 0) >= 1
        # render must expose the family for Prometheus scrapes
        eng.sync_autotune_metrics()
        assert "ops_autotune_tuned_dispatch" in eng.metrics.render()
    finally:
        eng.close()
