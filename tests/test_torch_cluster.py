"""The port's distributed serving plane (repro_torch.cluster) against the
reference's (repro.cluster).

The nine tests of the reference's ``tests/test_cluster.py``, ported: a
ClusterEngine scattering row-band builds to in-process ShardWorkers composes
coresets fingerprint-equal to the single-host thread-pool path, forwards
deltas in O(changed rows), degrades to local band builds when a worker dies,
heals and rejoins through the content-addressed no_band / stale_band path,
and carries one trace id across every RPC hop.  Then the port against the
reference itself: the same signal through both clusters gives the same
fingerprint and bitwise the same losses, the five RPC messages encode to
the same bytes in both codecs, and the same kill and rejoin leave the same
counters.  Last, ``serve_coresets --role worker|coordinator`` in fresh
interpreters: a pinned worker boots and answers ``/v1/healthz``, a
coordinator without ``--peers`` is a usage error, and with neither a card
nor a pin neither role boots.

Every engine runs on the numpy backend, each package pinned with its own
``ops.backend_override`` (process-global, so the in-process workers'
request threads see it too).  Workers bind port 0 with private tracers and
are shut down and closed in ``finally``; no test asserts on a duration."""
import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs  # noqa: E402
from repro import ops as ref_ops  # noqa: E402
from repro.cluster import ClusterEngine as RefClusterEngine  # noqa: E402
from repro.cluster import ShardWorker as RefShardWorker  # noqa: E402
from repro.cluster import make_worker_server as ref_make_worker_server  # noqa: E402
from repro.cluster import rpc as ref_rpc  # noqa: E402
from repro.core.bicriteria import BicriteriaResult as RefBicriteria  # noqa: E402
from repro.core.coreset import SignalCoreset as RefSignalCoreset  # noqa: E402
from repro.service import ServiceMetrics as RefServiceMetrics  # noqa: E402
from repro.service import protocol as RP  # noqa: E402
from repro_torch import obs, ops  # noqa: E402
from repro_torch.cluster import (ClusterEngine, ShardWorker,  # noqa: E402
                                 WorkerClient, WorkerRPCError,
                                 make_worker_server)
from repro_torch.cluster import rpc  # noqa: E402
from repro_torch.core import random_tree_segmentation, signal_coreset  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.service import CoresetEngine, ServiceMetrics  # noqa: E402
from repro_torch.service import protocol as P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, M, K, EPS = 96, 64, 5, 0.3
WAIT_S = 60.0          # every blocking wait is bounded


@pytest.fixture()
def pinned(monkeypatch, tmp_path):
    """No environment pin, a private (cold) autotune cache, and both
    packages pinned to numpy for the test's whole run."""
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    ops.autotune.reset_cache()
    with ops.backend_override("numpy"), ref_ops.backend_override("numpy"):
        yield
    ops.autotune.reset_cache()


def _start_worker(i: int, port: int = 0, *, ref: bool = False):
    worker_cls, make, tracer_cls = (
        (RefShardWorker, ref_make_worker_server, ref_obs.Tracer) if ref
        else (ShardWorker, make_worker_server, obs.Tracer))
    w = worker_cls(worker_id=f"w{i}")
    tracer = tracer_cls()
    srv = make(w, port=port, tracer=tracer)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return SimpleNamespace(worker=w, tracer=tracer, server=srv,
                           port=srv.server_address[1],
                           url=f"http://127.0.0.1:{srv.server_address[1]}")


def _stop(node) -> None:
    node.server.shutdown()
    node.server.server_close()   # release the port (kill/rejoin reuses it)


@contextlib.contextmanager
def _cluster(*, ref: bool = False, single: bool = True):
    """Three workers, their coordinator and (``single``) the single-host
    engine with the same band count, all of one package."""
    nodes = []
    engines = []
    try:
        for i in range(3):
            nodes.append(_start_worker(i, ref=ref))
        coord_cls, metrics_cls = ((RefClusterEngine, RefServiceMetrics) if ref
                                  else (ClusterEngine, ServiceMetrics))
        coord = coord_cls([n.url for n in nodes], workers=2, reprobe_s=0.2,
                          rpc_timeout=10.0, metrics=metrics_cls())
        engines.append(coord)
        one = None
        if single:
            one = CoresetEngine(num_bands=3, workers=2, metrics=ServiceMetrics())
            engines.append(one)
        yield SimpleNamespace(nodes=nodes, coord=coord, single=one)
    finally:
        for eng in engines:
            eng.close()
        for n in nodes:
            _stop(n)


@pytest.fixture()
def cluster(pinned):
    with _cluster() as c:
        yield c


def _y(seed=7):
    return piecewise_signal(N, M, K, noise=0.15, seed=seed)


def _settled(coord) -> None:
    """Wait until no build is pending: a dense ingest_delta re-caches
    through the BuildScheduler, and its gather must be done before the
    cluster's counters are read."""
    t_end = time.monotonic() + WAIT_S
    while coord.scheduler.in_flight():
        assert time.monotonic() < t_end, "a build never finished"
        time.sleep(0.001)


# ------------------------------------------------------------------- parity
def test_cluster_fingerprint_and_loss_parity(cluster):
    y = _y()
    cluster.coord.register_signal("sig", y)
    cluster.single.register_signal("sig", y)
    cs_c, _, _ = cluster.coord.get_coreset("sig", K, EPS)
    cs_s, _, _ = cluster.single.get_coreset("sig", K, EPS)
    assert cs_c.fingerprint() == cs_s.fingerprint()   # bitwise composition
    # every worker served (no degraded fallback hid a dead worker)
    assert cluster.coord.metrics.get("cluster_degraded_builds") == 0
    assert cluster.coord.metrics.get("cluster_gathers") == 1
    for n in cluster.nodes:
        assert n.worker.metrics.get("worker_band_builds") == 1
    # loss answers ride the identical coreset -> bitwise equal
    rng = np.random.default_rng(11)
    for _ in range(4):
        q = random_tree_segmentation(N, M, K, rng)
        lc = cluster.coord.tree_loss("sig", q.rects, q.labels, eps=EPS)
        ls = cluster.single.tree_loss("sig", q.rects, q.labels, eps=EPS)
        assert lc["loss"] == ls["loss"]
        assert lc["fingerprint"] == ls["fingerprint"]


def test_cluster_batch_query_parity(cluster):
    y = _y(8)
    cluster.coord.register_signal("sig", y)
    cluster.single.register_signal("sig", y)
    rng = np.random.default_rng(12)
    segs = [random_tree_segmentation(N, M, K, rng) for _ in range(6)]
    br = np.stack([s.rects for s in segs])
    bl = np.stack([s.labels for s in segs])
    rc = cluster.coord.tree_loss_batch("sig", br, bl, eps=EPS)
    rs = cluster.single.tree_loss_batch("sig", br, bl, eps=EPS)
    assert np.array_equal(rc["losses"], rs["losses"])
    assert rc["fingerprint"] == rs["fingerprint"]


def test_worker_build_cache_serves_repeat_gathers(cluster):
    cluster.coord.register_signal("sig", _y(9))
    cluster.coord.get_coreset("sig", K, EPS)
    # drop only the coordinator's cache; worker band caches must answer
    cluster.coord.cache.invalidate_signal("sig", keep_version=None)
    cluster.coord.get_coreset("sig", K, EPS)
    assert cluster.coord.metrics.get("cluster_band_cache_hits") == 3
    for n in cluster.nodes:
        assert n.worker.metrics.get("worker_build_cache_hits") == 1


# ------------------------------------------------------------- delta writes
def test_delta_forward_patches_workers_and_keeps_parity(cluster):
    y = _y(10)
    cluster.coord.register_signal("sig", y)
    cluster.single.register_signal("sig", y)
    cluster.coord.get_coreset("sig", K, EPS)
    patch = np.full((8, M), 2.5)
    cluster.coord.ingest_delta("sig", patch, row0=40)   # band 1 rows
    cluster.single.ingest_delta("sig", patch, row0=40)
    assert cluster.coord.metrics.get("cluster_deltas_forwarded") == 1
    # only the owning worker saw rows; its slab hash now matches the
    # coordinator's post-patch band (content-addressed consistency)
    deltas = [n.worker.metrics.get("worker_deltas_applied")
              for n in cluster.nodes]
    assert deltas == [0, 1, 0]
    _settled(cluster.coord)
    _settled(cluster.single)
    cs_c, _, how = cluster.coord.get_coreset("sig", K, EPS)
    cs_s, _, _ = cluster.single.get_coreset("sig", K, EPS)
    assert how == "exact"           # the re-cache build's coreset
    assert cs_c.fingerprint() == cs_s.fingerprint()
    assert cluster.coord.metrics.get("cluster_degraded_builds") == 0
    # the re-cache gather found every worker current (no heal); the patch
    # moved the shared tolerance, so every band built once more
    assert cluster.coord.metrics.get("cluster_gathers") == 2
    assert cluster.coord.metrics.get(
        'cluster_band_heals{code="stale_band"}') == 0
    assert [n.worker.metrics.get("worker_band_builds")
            for n in cluster.nodes] == [2, 2, 2]


def test_recache_gather_waits_for_a_slow_delta_forward(cluster, monkeypatch):
    """A dense delta schedules its re-cache build before the coordinator
    forwards the rows; the build's gather must still find every worker
    patched, however slow the forward."""
    coord = cluster.coord
    coord.register_signal("sig", _y(16))
    coord.get_coreset("sig", K, EPS)
    forward = coord._forward_deltas
    scheduled = []

    def slow_forward(*args, **kwargs):
        # the re-cache build is queued by now; hold the forward until the
        # scheduler has handed it to a build thread, and a while after
        scheduled.append(coord.scheduler.in_flight())
        t_end = time.monotonic() + 0.5
        while coord.metrics.get("build_batches") < 2 and \
                time.monotonic() < t_end:
            time.sleep(0.001)
        time.sleep(0.2)
        return forward(*args, **kwargs)
    monkeypatch.setattr(coord, "_forward_deltas", slow_forward)
    coord.ingest_delta("sig", np.full((8, M), -1.0), row0=40)
    _settled(coord)
    assert scheduled == [1]
    assert coord.metrics.get("cluster_gathers") == 2
    assert [coord.metrics.get(f'cluster_band_heals{{code="{c}"}}')
            for c in ("no_band", "stale_band")] == [0, 0]
    assert [n.worker.metrics.get("worker_deltas_applied")
            for n in cluster.nodes] == [0, 1, 0]


def test_stale_worker_heals_by_reassign(cluster):
    y = _y(11)
    cluster.coord.register_signal("sig", y)
    # corrupt one worker's slab behind the coordinator's back
    cluster.nodes[0].worker.assign(rpc.BandAssignRequest(
        signal=P.SignalRef(name="sig"), row0=0,
        band=np.ones((32, M)), band_hash=""))
    cs_c, _, _ = cluster.coord.get_coreset("sig", K, EPS)
    single = cluster.single
    single.register_signal("sig", y)
    cs_s, _, _ = single.get_coreset("sig", K, EPS)
    assert cs_c.fingerprint() == cs_s.fingerprint()
    assert cluster.coord.metrics.get(
        'cluster_band_heals{code="stale_band"}') == 1
    assert cluster.coord.metrics.get("cluster_degraded_builds") == 0


# ------------------------------------------------- kill / degrade / rejoin
def _victim_rpcs(coord, url: str) -> dict:
    return {k: v for k, v in coord.metrics.snapshot()["counters"].items()
            if k.startswith("cluster_rpc_total{") and f'worker="{url}"' in k}


def _kill_and_rejoin(c, y, start_worker):
    """Build, kill worker 1, build twice inside its cooldown (the second
    must not touch it), restart it empty on the same port, lapse the
    cooldown and build again.  Returns the four fingerprints and the
    restarted worker.  The cooldown is a long ``reprobe_s`` that is set to
    0 to lapse it, so nothing depends on how long a build takes."""
    coord = c.coord
    coord.reprobe_s = WAIT_S
    coord.register_signal("sig", y)
    cs0, _, _ = coord.get_coreset("sig", K, EPS)
    victim = c.nodes[1]
    _stop(victim)
    coord.cache.invalidate_signal("sig", keep_version=None)
    cs1, _, _ = coord.get_coreset("sig", K, EPS)      # 200-path, no raise
    # inside the cooldown the dead worker is skipped without a socket
    before = _victim_rpcs(coord, victim.url)
    coord.cache.invalidate_signal("sig", keep_version=None)
    cs_cool, _, _ = coord.get_coreset("sig", K, EPS)
    cooldown_rpcs = (before, _victim_rpcs(coord, victim.url))
    # restart EMPTY on the same port: rejoin = no_band 404 -> assign -> serve
    fresh = start_worker(99, port=victim.port)
    c.nodes.append(fresh)        # closed with the others
    coord.reprobe_s = 0.0
    coord.cache.invalidate_signal("sig", keep_version=None)
    cs2, _, _ = coord.get_coreset("sig", K, EPS)
    return ([cs.fingerprint() for cs in (cs0, cs1, cs_cool, cs2)],
            cooldown_rpcs, victim, fresh)


def test_worker_kill_degrades_then_rejoins(cluster):
    y = _y(12)
    coord = cluster.coord
    cluster.single.register_signal("sig", y)
    fps, (before, after), victim, fresh = _kill_and_rejoin(
        cluster, y, _start_worker)
    assert len(set(fps)) == 1                         # degraded == identical
    assert cluster.single.get_coreset("sig", K, EPS)[0].fingerprint() == fps[0]
    assert after == before          # the cooldown build sent it nothing
    assert before == {
        f'cluster_rpc_total{{outcome="ok",worker="{victim.url}"}}': 1,
        f'cluster_rpc_total{{outcome="transport_error",worker="{victim.url}"}}': 1}
    assert coord.metrics.get("cluster_degraded_builds") == 2  # no new
    assert coord.metrics.get("cluster_worker_rejoins") == 1
    assert coord.metrics.get('cluster_band_heals{code="no_band"}') == 1
    assert coord.metrics.get_gauge("cluster_worker_up",
                                   worker=victim.url) == 1.0
    assert fresh.worker.metrics.get("worker_band_builds") == 1


def _cluster_counters(c) -> dict:
    """The coordinator's cluster_* counters and worker-up gauges, each
    worker named by its index rather than its URL."""
    urls = {n.url: f"w{i}" for i, n in enumerate(c.nodes[:3])}

    def named(key):
        for url, w in urls.items():
            key = key.replace(url, w)
        return key
    snap = c.coord.metrics.snapshot()
    out = {named(k): v for k, v in snap["counters"].items()
           if k.startswith("cluster_")}
    out.update({named(k): v for k, v in snap["gauges"].items()
                if k.startswith("cluster_")})
    return out


def test_kill_and_rejoin_counters_equal_the_reference_s(pinned):
    y = _y(12)
    runs = {}
    for ref in (False, True):
        with _cluster(ref=ref, single=False) as c:
            fps, _, _, fresh = _kill_and_rejoin(
                c, y, lambda i, port: _start_worker(i, port, ref=ref))
            runs[ref] = (fps, _cluster_counters(c),
                         fresh.worker.metrics.get("worker_band_builds"))
    assert runs[False] == runs[True]
    fps, counters, _ = runs[False]
    assert counters["cluster_degraded_builds"] == 2
    assert counters['cluster_worker_up{worker="w1"}'] == 1.0


def test_port_cluster_equals_the_reference_cluster(pinned):
    y = _y(13)
    rng = np.random.default_rng(14)
    single = [random_tree_segmentation(N, M, K, rng) for _ in range(4)]
    br = np.stack([s.rects for s in single])
    bl = np.stack([s.labels for s in single])
    got = {}
    for ref in (False, True):
        with _cluster(ref=ref, single=False) as c:
            c.coord.register_signal("sig", y)
            cs, _, _ = c.coord.get_coreset("sig", K, EPS)
            losses = [c.coord.tree_loss("sig", q.rects, q.labels,
                                        eps=EPS)["loss"] for q in single]
            batch = c.coord.tree_loss_batch("sig", br, bl, eps=EPS)["losses"]
            got[ref] = (cs.fingerprint(), losses, batch.tolist(),
                        _cluster_counters(c))
    one = CoresetEngine(num_bands=3, workers=2)
    try:
        one.register_signal("sig", y)
        want = one.get_coreset("sig", K, EPS)[0].fingerprint()
    finally:
        one.close()
    assert got[False][0] == got[True][0] == want
    assert got[False][1:] == got[True][1:]


# -------------------------------------------------------- trace hops
def test_trace_id_spans_coordinator_and_worker_hops(cluster):
    coord = cluster.coord
    coord.register_signal("sig", _y(13))
    root = obs.start_trace("test.build")
    with obs.TRACER.attach(root):
        coord.get_coreset("sig", K, EPS)
    root.end()
    t = obs.TRACER.get(root.trace_id)
    assert t is not None
    gathers = [s for s in t["spans"] if s["name"] == "cluster.gather"]
    assert len(gathers) == 1
    rpcs = [s for s in t["spans"] if s["name"] == "cluster.rpc"]
    assert len(rpcs) == 3
    # every worker continued the SAME trace id: its private tracer finished
    # a trace under root.trace_id whose root is the band:build route
    linked_ids = {li["span_id"] for li in gathers[0].get("links", ())}
    assert len(linked_ids) == 3                      # gather fan-in links
    for n in cluster.nodes:
        # the worker finalizes its root span AFTER flushing the RPC reply,
        # so bound-wait for the trace to finish rather than racing it
        wt = n.tracer.get(root.trace_id, wait_s=WAIT_S)
        assert wt is not None
        names = {s["name"] for s in wt["spans"]}
        assert "POST /v1/worker/band:build" in names
        assert "worker.band_build" in names
        # the response traceparent the coordinator linked IS a worker span
        worker_span_ids = {s["span_id"] for s in wt["spans"]}
        assert linked_ids & worker_span_ids


def test_worker_error_envelope_carries_trace_headers(cluster):
    client = WorkerClient(cluster.nodes[0].url)
    root = obs.start_trace("test.err")
    with obs.TRACER.attach(root):
        with pytest.raises(WorkerRPCError) as ei:
            client.build("ghost", 0, 32, "deadbeef", K, EPS, 1e-3)
    root.end()
    assert ei.value.code == "no_band"
    assert ei.value.http == 404
    # X-Coreset-Trace-Id on the ERROR envelope names the propagated trace
    assert ei.value.trace_id == root.trace_id


# ----------------------------------------------------------- telemetry
def test_cluster_metrics_gauges_histograms_and_stats(cluster):
    coord = cluster.coord
    coord.register_signal("sig", _y(14))
    root = obs.start_trace("test.metrics")
    with obs.TRACER.attach(root):
        coord.get_coreset("sig", K, EPS)
    root.end()
    text = coord.metrics.render()
    assert "# TYPE coreset_cluster_worker_up gauge" in text
    for n in cluster.nodes:
        assert f'coreset_cluster_worker_up{{worker="{n.url}"}} 1' in text
    # per-worker RPC latency histograms + the gather histogram, with the
    # traced build attached as an exemplar
    assert "coreset_cluster_rpc_seconds_bucket" in text
    assert "coreset_cluster_gather_seconds_bucket" in text
    assert f'trace_id="{root.trace_id}"' in text
    snap = coord.stats()
    assert snap["cluster"]["role"] == "coordinator"
    assert [p["up"] for p in snap["cluster"]["peers"]] == [True] * 3
    assert snap["cluster"]["gathers"] == 1
    assert snap["metrics"]["gauges"]   # gauges surfaced in /v1/stats
    # worker-side: its own /metrics exposition works too
    wtext = cluster.nodes[0].worker.metrics.render()
    assert "coreset_worker_band_builds" in wtext
    assert "# TYPE coreset_worker_bands_held gauge" in wtext


# ------------------------------------------------------------ wire frames
@pytest.fixture()
def frozen_zip_time(monkeypatch):
    """npz members carry the time of writing; freeze it for byte equality."""
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.time = lambda: 1_700_000_000.0
    monkeypatch.setattr(zipfile, "time", fake)


def _coreset():
    with ops.backend_override("numpy"):
        cs = signal_coreset(_y(15), K, EPS)
    return dataclasses.replace(cs, build_seconds=0.125)


def _ref_coreset(cs):
    d = cs.to_arrays()
    d["bicriteria"] = RefBicriteria(**d["bicriteria"])
    return RefSignalCoreset(**d)


_BAND = np.random.default_rng(5).normal(size=(4, M))
_SIG = {"name": "sig"}
RPC_SAMPLES = {
    "band_assign": {"signal": _SIG, "row0": 32, "band": _BAND,
                    "band_hash": rpc.band_hash(_BAND)},
    "band_delta": {"signal": _SIG, "row0": 40, "band": _BAND[:2],
                   "band_hash": "ab" * 12},
    "band_build": {"signal": _SIG, "row0": 32, "rows": 32,
                   "band_hash": "cd" * 12, "k": K, "eps": EPS,
                   "tolerance_override": 1.25e-3, "deadline_ms": 250.0},
    "band_ack": {"signal": "sig", "row0": 32, "rows": 32, "m": M,
                 "band_hash": "ef" * 12, "worker_id": "w1"},
}


def _rpc_msgs(kind):
    if kind == "band_coreset":
        cs = _coreset()
        return (ref_rpc.coreset_to_msg(_ref_coreset(cs), worker_id="w2"),
                rpc.coreset_to_msg(cs, worker_id="w2"))
    return (RP._REGISTRY[kind].from_payload(dict(RPC_SAMPLES[kind])),
            P._REGISTRY[kind].from_payload(dict(RPC_SAMPLES[kind])))


@pytest.mark.parametrize("encoding", ["json", "binary"])
@pytest.mark.parametrize("kind", [*RPC_SAMPLES, "band_coreset"])
def test_rpc_frames_are_byte_equal_and_cross_decode(kind, encoding,
                                                    frozen_zip_time):
    ref, port = _rpc_msgs(kind)
    assert type(port).__module__ == "repro_torch.cluster.rpc"
    ref_wire = ref.to_wire(encoding, binary_codec="zlib")
    port_wire = port.to_wire(encoding, binary_codec="zlib")
    assert port_wire == ref_wire
    got = P.decode(*ref_wire)
    assert type(got) is type(port) and got == port
    got = RP.decode(*port_wire)
    assert type(got) is type(ref) and got == ref


@pytest.mark.parametrize("encoding", ["json", "binary"])
def test_coreset_round_trips_the_wire_exactly(encoding):
    cs = _coreset()
    msg = rpc.coreset_to_msg(cs, cache="hit", worker_id="w0")
    back = rpc.coreset_from_msg(P.decode(*msg.to_wire(encoding)))
    assert back.fingerprint() == cs.fingerprint()
    assert back.to_arrays().keys() == cs.to_arrays().keys()
    for key, val in cs.to_arrays().items():
        if isinstance(val, np.ndarray):
            assert back.to_arrays()[key].dtype == val.dtype
            assert np.array_equal(back.to_arrays()[key], val), key
        else:
            assert back.to_arrays()[key] == val, key
    # and through the reference's decoder into the reference's coreset
    ref = ref_rpc.coreset_from_msg(RP.decode(*msg.to_wire(encoding)))
    assert ref.fingerprint() == cs.fingerprint()
    assert rpc.band_hash(_BAND) == ref_rpc.band_hash(_BAND)


# ------------------------------------------------- serve_coresets --role
def _child_env(pin: str | None, tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", ops.ENV_VAR)}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "tune.json")
    if pin is not None:
        env[ops.ENV_VAR] = pin
    return env


def _launch(args, pin, tmp_path):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_coresets", *args],
        cwd=ROOT, env=_child_env(pin, tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def _kill(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=WAIT_S)


def test_role_worker_boots_pinned_and_answers_healthz(tmp_path):
    import json
    proc = _launch(["--role", "worker", "--port", "0", "--worker-id", "wx"],
                   "numpy", tmp_path)
    try:
        boot = []

        def read_boot_line():
            for line in proc.stdout:
                if "listening on" in line:
                    boot.append(line)
                    return
        reader = threading.Thread(target=read_boot_line, daemon=True)
        reader.start()
        reader.join(WAIT_S)
        assert boot, f"no boot line (exit {proc.poll()})"
        assert "listening on http://127.0.0.1:" in boot[0]
        assert "ops on ['numpy']" in boot[0]
        url = boot[0].split("listening on ")[1].split()[0]
        with urllib.request.urlopen(url + "/v1/healthz", timeout=WAIT_S) as r:
            health = json.loads(r.read())
        assert health["role"] == "worker" and health["worker_id"] == "wx"
        assert health["status"] == "ok" and health["bands"] == {}
    finally:
        _kill(proc)


def test_role_coordinator_without_peers_is_a_usage_error(tmp_path):
    proc = _launch(["--role", "coordinator", "--port", "0"], "numpy",
                   tmp_path)
    try:
        _, err = proc.communicate(timeout=WAIT_S)
        assert proc.returncode == 2
        assert "--role coordinator requires --peers" in err
    finally:
        _kill(proc)


@pytest.mark.parametrize("role", [
    ["--role", "worker"],
    ["--role", "coordinator", "--peers", "http://127.0.0.1:9"]],
    ids=["worker", "coordinator"])
def test_roles_refuse_to_boot_without_a_card_or_a_pin(role, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the role would boot on it")
    proc = _launch([*role, "--port", "0"], None, tmp_path)
    try:
        out, err = proc.communicate(timeout=WAIT_S)
        assert proc.returncode not in (0, None)
        assert "listening" not in out
        assert "no CUDA device" in err
    finally:
        _kill(proc)


# ------------------------------------------------ scripts/cluster_gate_torch
def _gate(pin, tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "scripts/cluster_gate_torch.py", "--reprobe", "0.2"],
        cwd=ROOT, env=_child_env(pin, tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        _kill(proc)      # the gate and every role process it started
    return proc.returncode, out, err


def test_cluster_gate_passes_pinned_on_the_cpu(tmp_path):
    rc, out, err = _gate("numpy", tmp_path)
    assert rc == 0, out + err
    assert "ops on ['numpy']" in out
    assert out.strip().splitlines()[-1] == "[cluster_gate_torch] PASS"


def test_cluster_gate_refuses_without_a_card_or_a_pin(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the gate would run on it")
    rc, out, err = _gate(None, tmp_path)
    assert rc == 2 and out == ""
    assert "no CUDA device" in err
