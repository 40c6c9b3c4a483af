"""The wire in both directions: the reference's ``repro.client`` drives the
port's server and the port's ``repro_torch.client`` drives the reference's,
in the JSON and binary encodings and with the v1 buffered and v2 streamed
compress responses.  Each client gets the same answers from both servers
(both servers on the numpy backend), and the port's server keeps the
reference's legacy routes, error envelopes and trace retrieval."""
import contextlib
import json
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.client as ref_client  # noqa: E402
import repro.service as ref_service  # noqa: E402
from repro import ops as ref_ops  # noqa: E402
import repro_torch.client as port_client  # noqa: E402
import repro_torch.service as port_service  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import random_tree_segmentation  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402

N, M, KMAX = 96, 64, 8
TIMEOUT = 60.0
CLIENTS = {"reference": ref_client, "port": port_client}
SERVICES = {"reference": ref_service, "port": port_service}


@pytest.fixture()
def pinned(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    with ops.backend_override("numpy"), ref_ops.backend_override("numpy"):
        yield


@contextlib.contextmanager
def _server(service):
    eng = service.CoresetEngine(workers=2)
    srv = service.make_server(eng)
    try:
        service.serve_forever_in_thread(srv)
        yield eng, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def _payload(msg):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in msg.to_payload().items()}


def _scenario(client_mod, base, encoding, stream):
    cl = client_mod.CoresetClient(base, encoding=encoding, stream=stream,
                                  timeout=TIMEOUT, retries=0)
    y = piecewise_signal(N, M, KMAX, noise=0.15, seed=7)
    rng = np.random.default_rng(17)
    out = [cl.register_signal("dense", values=y),
           cl.build("dense", KMAX, 0.2),
           cl.build("dense", 4, 0.3)]
    for k in (3, KMAX):
        q = random_tree_segmentation(N, M, k, rng)
        out.append(cl.query_loss("dense", q.rects, q.labels, eps=0.3, k=KMAX))
    segs = [random_tree_segmentation(N, M, 5, rng) for _ in range(5)]
    out.append(cl.query_loss_batch("dense", np.stack([s.rects for s in segs]),
                                   np.stack([s.labels for s in segs]),
                                   eps=0.3, k=KMAX))
    out.append(cl.fit("dense", KMAX, 0.2, n_estimators=2,
                      predict=[[1, 1], [N - 2, M - 2]]))
    out.append(cl.compress("dense", KMAX, 0.2, max_points=40))
    out.append(cl.last_stream_chunks)
    for i in range(0, N, 32):
        out.append(cl.ingest("stream", band=y[i:i + 32]))
    out.append(cl.ingest_delta("stream", band=y[32:64] * 0.5, row0=32))
    out.append(cl.build("stream", KMAX, 0.25))
    out.append(cl.ingest("synth", synthetic={"kind": "piecewise", "n": 32,
                                             "m": M, "seed": 1}))
    return [_payload(o) if hasattr(o, "to_payload") else o for o in out]


def _scrub(answers):
    """Drop what differs between two runs of one server: build times."""
    for a in answers:
        if isinstance(a, dict):
            a.pop("build_seconds", None)
    return answers


@pytest.mark.parametrize("stream", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("encoding", ["json", "binary"])
@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_each_client_gets_the_same_answers_from_both_servers(
        pinned, client, encoding, stream):
    answers = {}
    for name, service in SERVICES.items():
        with _server(service) as (_, base):
            answers[name] = _scrub(_scenario(CLIENTS[client], base, encoding,
                                             stream))
    assert answers["port"] == answers["reference"]
    # the v2 stream is offered with the binary encoding only
    assert (answers["port"][8] > 0) == (stream and encoding == "binary")
    served = [a["served_from"] for a in answers["port"]
              if isinstance(a, dict) and "served_from" in a]
    assert served[:5] == ["built", "dominated", "dominated", "dominated",
                          "dominated"]
    assert served[5:7] == ["exact", "exact"]          # fit and compress


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_errors_reach_either_client_as_the_envelope(pinned, client):
    mod = CLIENTS[client]
    with _server(port_service) as (_, base):
        cl = mod.CoresetClient(base, timeout=TIMEOUT, retries=0)
        with pytest.raises(mod.CoresetAPIError) as ei:
            cl.build("nope", 4, 0.3)
        assert ei.value.http == 404 and ei.value.code == "not_found"
        assert ei.value.trace_id
        cl.register_signal("s", values=np.ones((8, 8)))
        with pytest.raises(mod.CoresetAPIError) as ei:
            cl.register_signal("s", values=np.ones((8, 8)))
        assert ei.value.http == 409 and ei.value.code == "conflict"
        with pytest.raises(mod.CoresetAPIError) as ei:
            cl.register_signal("bad", values=np.array([[1.0, np.nan]]))
        assert ei.value.http == 400 and ei.value.code == "bad_request"
        doc = cl.trace(ei.value.trace_id)
        assert doc["trace_id"] == ei.value.trace_id


def test_legacy_routes_answer_with_deprecation_headers(pinned):
    with _server(port_service) as (eng, base):
        def post(path, body):
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                return resp, json.loads(resp.read())
        resp, info = post("/signals", {"name": "s", "synthetic": {
            "kind": "piecewise", "n": 64, "m": 32, "k": 4, "seed": 3}})
        assert resp.headers["Deprecation"] == "true"
        assert '</v1/signals>; rel="successor-version"' == resp.headers["Link"]
        assert info["n"] == 64
        resp, built = post("/build", {"name": "s", "k": 4, "eps": 0.3})
        assert built["cache"] == built["served_from"] == "built"
        q = random_tree_segmentation(64, 32, 4, np.random.default_rng(0))
        resp, loss = post("/query/loss", {"name": "s",
                                          "rects": q.rects.tolist(),
                                          "labels": q.labels.tolist(),
                                          "k": 4, "eps": 0.3})
        assert loss["backend"] == "numpy" and loss["cache"] == "exact"
        with urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT) as resp:
            assert resp.headers["Deprecation"] == "true"
            assert json.loads(resp.read())["status"] == "ok"
        # the handler counts a request after its reply is written
        t_end = time.monotonic() + TIMEOUT
        while eng.metrics.get("http_deprecated") < 4:
            assert time.monotonic() < t_end
            time.sleep(0.001)
        assert eng.metrics.get("http_deprecated") == 4


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_trace_chrome_export_and_metrics_from_the_port_server(pinned, client):
    with _server(port_service) as (_, base):
        cl = CLIENTS[client].CoresetClient(base, timeout=TIMEOUT, retries=0)
        cl.register_signal("s", values=piecewise_signal(48, 32, 4, seed=1))
        cl.build("s", 4, 0.3)
        tid = cl.last_trace_id
        doc = cl.trace(tid)
        names = {sp["name"] for sp in doc["spans"]}
        assert {"POST /v1/build", "coreset.get", "engine.compress"} <= names
        assert "ops.dispatch" in names
        chrome = cl.trace(tid, format="chrome")
        assert chrome["traceEvents"]
        assert any(t["trace_id"] == tid for t in cl.traces_recent(10))
        text = cl.metrics_text()
        assert "coreset_ops_dispatch_total{" in text
        assert cl.stats()["ops_backends"]["sat_moments"]["selected"] == "numpy"
