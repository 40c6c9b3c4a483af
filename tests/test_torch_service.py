"""The port's CoresetEngine and HTTP server against the reference's.

Both engines run on the numpy backend (each package pinned with its own
``ops.backend_override``) on the same seeded signal, the one
``serve_coresets --smoke`` uses, and must agree bitwise: coreset
fingerprints, the ``served_from`` sequence, ``eps_eff``, float64 losses
(single, batched, coalesced and inline), forest predictions, compressed
points, and a streamed then delta-patched coreset.  The ``torch`` backend's
losses are held to the reference's 1e-4 batched-against-dense bar.  With no
card and no pin the port's engine and server refuse to score."""
import contextlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.core import sharded as ref_sharded  # noqa: E402
from repro.service import CoresetEngine as RefEngine  # noqa: E402
from repro_torch import obs, ops  # noqa: E402
from repro_torch.client import CoresetClient, TransportError  # noqa: E402
from repro_torch.core import random_tree_segmentation, signal_coreset  # noqa: E402
from repro_torch.core import sharded  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.service import (CoresetEngine, ServiceMetrics,  # noqa: E402
                                 make_server, serve_forever_in_thread)

N, M, KMAX = 96, 64, 8
WAIT_S = 60.0          # every blocking wait is bounded


def _signal():
    return piecewise_signal(N, M, KMAX, noise=0.15, seed=7)


@pytest.fixture()
def env(monkeypatch, tmp_path):
    """No environment pin and a private (cold) autotune cache: selection
    sees only what each test pins."""
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    ops.autotune.reset_cache()
    yield
    ops.autotune.reset_cache()


@contextlib.contextmanager
def _pinned(backend="numpy"):
    with ops.backend_override(backend), ref_ops.backend_override("numpy"):
        yield


@contextlib.contextmanager
def _engines(**kw):
    kw.setdefault("workers", 2)
    port = CoresetEngine(metrics=ServiceMetrics(), **kw)
    ref = RefEngine(**kw)
    try:
        yield port, ref
    finally:
        port.close()
        ref.close()


def _gated_build(eng):
    """Hold ``eng``'s coreset builds until the returned event is set."""
    gate = threading.Event()
    build = eng._build_and_cache

    def held(*a, **k):
        gate.wait(WAIT_S)
        return build(*a, **k)
    eng._build_and_cache = held
    return gate


def _wait_for(cond):
    t_end = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < t_end, "condition not reached"
        time.sleep(0.001)


def _served_from_sequence(eng, y):
    """built, exact, dominated on one signal; then built and coalesced: two
    concurrent requests for a new coreset while its build is held."""
    eng.register_signal("dense", y)
    out = []
    for k, eps in ((KMAX, 0.2), (KMAX, 0.2), (4, 0.3)):
        cs, eps_eff, how = eng.get_coreset("dense", k, eps)
        out.append((how, cs.fingerprint(), eps_eff))
    eng.register_signal("held", y[: N // 2])
    gate = _gated_build(eng)
    results = [None, None]

    def get(i):
        results[i] = eng.get_coreset("held", 6, 0.25, timeout=WAIT_S)
    first = threading.Thread(target=get, args=(0,))
    first.start()
    _wait_for(lambda: eng.scheduler.in_flight() == 1)
    second = threading.Thread(target=get, args=(1,))
    second.start()
    _wait_for(lambda: eng.metrics.get("builds_coalesced") >= 1)
    gate.set()
    first.join(WAIT_S)
    second.join(WAIT_S)
    for cs, eps_eff, how in results:
        out.append((how, cs.fingerprint(), eps_eff))
    return out


def test_served_from_sequence_fingerprints_and_eps_eff_bitwise(env):
    y = _signal()
    with _pinned(), _engines() as (port, ref):
        got = _served_from_sequence(port, y)
        want = _served_from_sequence(ref, y)
    assert [g[0] for g in got] == ["built", "exact", "dominated", "built",
                                   "coalesced"]
    assert got == want
    # the engine's build is the band-parallel one; its fingerprint is the
    # port's own sharded build too
    assert port.metrics.get("coreset_builds") == 2


def _trees(rng, T, k):
    segs = [random_tree_segmentation(N, M, k, rng) for _ in range(T)]
    return (np.stack([s.rects for s in segs]), np.stack([s.labels for s in segs]))


def _loss_answers(eng, y):
    eng.register_signal("dense", y)
    rng = np.random.default_rng(11)
    out = []
    for coalesce in (True, False):
        for k in (3, 5, KMAX):
            q = random_tree_segmentation(N, M, k, rng)
            r = eng.tree_loss("dense", q.rects, q.labels, eps=0.3, k=KMAX,
                              coalesce=coalesce, timeout=WAIT_S)
            out.append(r)
    for coalesce in (True, False):
        rects, labels = _trees(rng, 6, 5)
        out.append(eng.tree_loss_batch("dense", rects, labels, eps=0.3,
                                       k=KMAX, coalesce=coalesce,
                                       timeout=WAIT_S))
    return out


def test_losses_bitwise_on_numpy(env):
    y = _signal()
    with _pinned(), _engines() as (port, ref):
        got, want = _loss_answers(port, y), _loss_answers(ref, y)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key == "losses":
                assert g[key].dtype == np.float64
                assert np.array_equal(g[key], w[key])
            else:
                assert g[key] == w[key], key
    assert {g["backend"] for g in got} == {"numpy"}
    # one scoring call a request here (no co-travellers), each counted
    assert port.metrics.get("loss_scoring_calls") == 8
    assert port.metrics.get("ops_backend_numpy") == 8


def test_losses_on_torch_within_the_batched_bar(env):
    y = _signal()
    with _pinned("torch"), _engines() as (port, ref):
        got, want = _loss_answers(port, y), _loss_answers(ref, y)
    assert {g["backend"] for g in got} == {"torch"}
    assert port.metrics.get("ops_backend_torch") == 8
    assert port.metrics.get("ops_backend_numpy") == 0
    for g, w in zip(got, want):
        assert g["fingerprint"] == w["fingerprint"]
        if "losses" in g:
            np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-4)
        else:
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)


def _fit_and_compress(eng, y):
    eng.register_signal("dense", y)
    fit = eng.fit_forest("dense", k=KMAX, eps=0.2, n_estimators=3,
                         predict=[[1, 1], [N - 2, M - 2], [N // 2, 7]],
                         timeout=WAIT_S)
    again = eng.fit_forest("dense", k=KMAX, eps=0.2, n_estimators=3,
                           timeout=WAIT_S)
    comp = eng.compress("dense", k=KMAX, eps=0.2, max_points=50,
                        timeout=WAIT_S)
    sized = eng.compress("dense", k=4, target_frac=0.1, timeout=WAIT_S)
    return fit, again, comp, sized


def test_forest_fit_and_compress_bitwise_on_numpy(env):
    y = _signal()
    with _pinned(), _engines() as (port, ref):
        got, want = _fit_and_compress(port, y), _fit_and_compress(ref, y)
    assert got == want
    assert got[0]["model_cache"] == "fit" and got[1]["model_cache"] == "hit"
    assert got[2]["truncated"] and len(got[2]["points"]["y"]) == 50


def _stream_and_delta(eng, y):
    for i in range(0, N, 16):
        eng.ingest_band("stream", y[i:i + 16])
    out = []
    cs, eps_eff, how = eng.get_coreset("stream", KMAX, 0.25)
    out.append((how, cs.fingerprint(), eps_eff))
    band = y[32:48][::-1].copy()
    r = eng.ingest_delta("stream", band, row0=32)
    out.append(r)
    cs, eps_eff, how = eng.get_coreset("stream", KMAX, 0.25)
    out.append((how, cs.fingerprint(), eps_eff))
    out.append(eng.ingest_delta("stream", y[:16]))        # an append
    cs, eps_eff, how = eng.get_coreset("stream", KMAX, 0.25)
    out.append((how, cs.fingerprint(), eps_eff))
    # a dense signal: the first replace materialises its integral images,
    # the second patches them through delta_sat
    eng.register_signal("dense", y)
    eng.get_coreset("dense", KMAX, 0.2)
    for row0 in (40, 8):
        out.append(eng.ingest_delta("dense", y[row0:row0 + 8] * 0.5,
                                    row0=row0))
    cs, eps_eff, how = eng.get_coreset("dense", KMAX, 0.2, timeout=WAIT_S)
    out.append((how, cs.fingerprint(), eps_eff))
    return out


def test_streamed_and_delta_patched_coresets_bitwise_on_numpy(env):
    y = _signal()
    with _pinned(), _engines() as (port, ref):
        got, want = _stream_and_delta(port, y), _stream_and_delta(ref, y)
        dispatched = {o for o, _ in ops.dispatch_counts()}
    assert got == want
    assert got[0][0] == "built" and got[1]["mode"] == "replace"
    assert got[3]["mode"] == "append" and got[3]["entries_reanchored"] == 1
    assert {"delta_sat", "streaming_compress"} <= dispatched


def test_streamed_build_is_the_one_shot_builder(env):
    """The server's streamed coreset is StreamingBuilder's over the same
    bands, built in one go outside the engine."""
    from repro_torch.core import StreamingBuilder
    y = _signal()
    with _pinned(), _engines() as (port, _):
        for i in range(0, N, 16):
            port.ingest_band("s", y[i:i + 16])
        cs, _, _ = port.get_coreset("s", KMAX, 0.25)
        sb = StreamingBuilder(m=M, k=KMAX, eps=0.25)
        for i in range(0, N, 16):
            sb.insert_band(y[i:i + 16])
        assert cs.fingerprint() == sb.result().fingerprint()


# ------------------------------------------------------------ no CPU path
def test_engine_refuses_to_score_without_a_card_or_a_pin(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: selection would take it")
    y = _signal()
    with _engines() as (port, _):
        port.register_signal("dense", y)
        q = random_tree_segmentation(N, M, 5, np.random.default_rng(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.tree_loss("dense", q.rects, q.labels, eps=0.3, k=KMAX,
                           timeout=WAIT_S)
        # a coreset built under a pin does not open a CPU path either
        with ops.backend_override("numpy"):
            port.get_coreset("dense", KMAX, 0.3)
        for coalesce in (True, False):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port.tree_loss("dense", q.rects, q.labels, eps=0.3, k=KMAX,
                               coalesce=coalesce, timeout=WAIT_S)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port.tree_loss_batch("dense", q.rects[None], q.labels[None],
                                     eps=0.3, k=KMAX, coalesce=coalesce,
                                     timeout=WAIT_S)
        assert port.metrics.get("ops_backend_numpy") == 0
        assert port.metrics.get("ops_backend_torch") == 0


def test_server_answers_5xx_without_a_card_or_a_pin(env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: selection would take it")
    eng = CoresetEngine(workers=2)
    srv = make_server(eng)
    try:
        serve_forever_in_thread(srv)
        cl = CoresetClient(f"http://127.0.0.1:{srv.server_address[1]}",
                           retries=0, timeout=WAIT_S)
        cl.register_signal("dense", values=_signal())
        q = random_tree_segmentation(N, M, 5, np.random.default_rng(0))
        # a 5xx is the client's retryable kind: it surfaces as transport
        with pytest.raises(TransportError, match="HTTP 500.*no CUDA device"):
            cl.query_loss("dense", q.rects, q.labels, eps=0.3, k=KMAX)
        with ops.backend_override("numpy"):
            cl.build("dense", KMAX, 0.3)
        with pytest.raises(TransportError, match="HTTP 500.*no CUDA device"):
            cl.query_loss_batch("dense", q.rects[None], q.labels[None],
                                eps=0.3, k=KMAX)
        assert eng.metrics.get("http_500") == 2
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


# ------------------------------------------------------------------ mesh
def test_mesh_is_refused_and_the_plain_scorer_is_the_reference_s(env):
    """A ``mesh=`` that is not a DeviceMesh, or has no ``data`` dimension,
    is refused (the meshes themselves run in tests/test_torch_mesh.py's
    ranks); with no mesh the scorer is bitwise the reference's.  The
    DeviceMesh here is built without a process group (``_init_backend=
    False``), so none is started in this process."""
    from torch.distributed.device_mesh import DeviceMesh
    no_data = DeviceMesh("cpu", [[0]], mesh_dim_names=("pod", "model"),
                         _init_backend=False, _rank=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        CoresetEngine(mesh=object())
    with pytest.raises(ValueError, match="no 'data' dimension"):
        CoresetEngine(mesh=no_data)
    y = _signal()
    with _pinned():
        cs = signal_coreset(y, KMAX, 0.2)
        rects, labels = _trees(np.random.default_rng(3), 5, KMAX)
        got = sharded.fitting_loss_batched(cs, rects, labels)
        from repro.core import signal_coreset as ref_signal_coreset
        want = ref_sharded.fitting_loss_batched(
            ref_signal_coreset(y, KMAX, 0.2), rects, labels)
    assert np.array_equal(got, want)
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharded.fitting_loss_batched(cs, rects, labels, mesh=object(),
                                     backend="numpy")
    with pytest.raises(ValueError, match="no 'data' dimension"):
        sharded.fitting_loss_batched(cs, rects, labels, mesh=no_data)


# ------------------------------------------------------ stats and hooks
def test_stats_surface_and_close_removes_the_profile_hook(env):
    before = obs.profile.hooks()
    with _pinned(), _engines() as (port, _):
        assert len(obs.profile.hooks()) == len(before) + 1
        port.register_signal("dense", _signal())
        q = random_tree_segmentation(N, M, 5, np.random.default_rng(0))
        port.tree_loss("dense", q.rects, q.labels, eps=0.3, k=KMAX,
                       timeout=WAIT_S)
        st = port.stats()
        assert set(st["ops_backends"]) == set(ops.OPS)
        assert st["ops_backends"]["fitting_loss_batched"]["selected"] == "numpy"
        assert "entries" in st["ops_autotune"] and "enabled" in st["tracing"]
        assert st["admission"] == {"enabled": False}
        text = port.metrics.render()
        for op in ("fitting_loss_batched", "sat_moments"):
            assert any(line.startswith("coreset_ops_dispatch_total{")
                       and 'backend="numpy"' in line and f'op="{op}"' in line
                       for line in text.splitlines()), op
    assert obs.profile.hooks() == before


def test_smoke_passes_on_the_cpu_with_numpy_pinned(env, monkeypatch):
    from repro_torch.launch.serve_coresets import run_smoke
    monkeypatch.setenv(ops.ENV_VAR, "numpy")
    assert run_smoke(verbose=False) == 0
