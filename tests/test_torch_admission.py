"""The port's AdmissionController against the reference's on a fake clock:
the same seeded mix of arrivals and completions gives the same admits,
the same rejections (reason, tenant, Retry-After) and the same snapshot.
Over HTTP the port's server refuses on arrival with the 503 envelope the
reference's client types, and admitted work is bitwise the work of a
server without admission."""
import contextlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.client import AdmissionRejectedError as RefRejected  # noqa: E402
from repro.client import CoresetClient as RefClient  # noqa: E402
from repro.service import admission as ref_adm  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.client import CoresetClient  # noqa: E402
from repro_torch.core import random_tree_segmentation  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.service import (CoresetEngine, make_server,  # noqa: E402
                                 serve_forever_in_thread)
from repro_torch.service import admission as adm  # noqa: E402

TIMEOUT = 60.0


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


CONFIGS = {
    "rate": dict(tenants={"hot": 3.0, "cold": 1.0}, rate_rps=40.0,
                 burst_s=0.05),
    "inflight": dict(tenants={"big": 3.0, "small": 1.0}, max_inflight=4),
    "deadline": dict(parallelism=2),
    "all": dict(tenants={"a": 2.0}, rate_rps=100.0, burst_s=0.1,
                max_inflight=6, parallelism=3),
    "off": dict(enabled=False, rate_rps=1.0),
}


def _trace(mod, config, seed):
    """Drive one controller through a seeded mix; record every outcome."""
    clk = FakeClock()
    ctl = mod.AdmissionController(mod.AdmissionConfig(**config), clock=clk)
    rng = np.random.default_rng(seed)
    tenants = ["hot", "cold", "big", "small", "a", None]
    open_tickets, out = [], []
    for _ in range(600):
        clk.t += float(rng.exponential(0.004))
        if open_tickets and rng.random() < 0.45:
            open_tickets.pop(int(rng.integers(len(open_tickets)))).done()
            out.append(("done",))
            continue
        kind = ("loss_query", "build")[int(rng.integers(2))]
        tenant = tenants[int(rng.integers(len(tenants)))]
        deadline = (None, 5.0, 50.0)[int(rng.integers(3))]
        try:
            open_tickets.append(ctl.admit(kind, tenant, deadline_ms=deadline,
                                          signal="s"))
            out.append(("admit", tenant))
        except mod.AdmissionRejected as exc:
            out.append(("reject", exc.reason, exc.tenant, exc.retry_after,
                        exc.message))
    return out, ctl.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_decisions_equal_the_reference(config, seed):
    got, got_snap = _trace(adm, CONFIGS[config], seed)
    want, want_snap = _trace(ref_adm, CONFIGS[config], seed)
    assert got == want
    assert got_snap == want_snap
    if config != "off":
        assert any(o[0] == "reject" for o in got)
    assert any(o[0] == "admit" for o in got)


def test_tenant_spec_parses_alike():
    spec = "gold=4, silver=2,bronze,,x=0.5"
    assert (adm.AdmissionConfig.parse_tenants(spec)
            == ref_adm.AdmissionConfig.parse_tenants(spec))
    with pytest.raises(ValueError, match="weight must be > 0"):
        adm.AdmissionConfig(tenants={"z": 0.0})


@pytest.fixture()
def pinned(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    with ops.backend_override("numpy"), ref_ops.backend_override("numpy"):
        yield


@contextlib.contextmanager
def _server(admission=None):
    eng = CoresetEngine(workers=2, admission=admission)
    srv = make_server(eng)
    try:
        serve_forever_in_thread(srv)
        yield eng, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def test_port_server_refuses_on_arrival_to_the_reference_client(pinned):
    ctl = adm.AdmissionController(adm.AdmissionConfig(deadline_guard=False))
    with _server(ctl) as (eng, base):
        cl = RefClient(base, retries=0, timeout=TIMEOUT)
        cl.register_signal("s", values=piecewise_signal(48, 32, 4, seed=3))
        ctl.config.rate_rps = 1e-6        # ~1 token, then an 11-day refill
        q = random_tree_segmentation(48, 32, 4, np.random.default_rng(0))
        cl.query_loss("s", q.rects, q.labels, eps=0.3)      # takes the token
        with pytest.raises(RefRejected) as ei:
            cl.query_loss("s", q.rects, q.labels, eps=0.3)
        err = ei.value
        assert err.http == 503 and err.code == "overloaded"
        assert err.reason == "tenant_rate" and err.tenant == "default"
        assert err.retry_after is not None and err.retry_after > 0
        assert eng.metrics.get("http_503") == 1
        snap = eng.stats()["admission"]
        assert snap["rejected_by_reason"] == {"tenant_rate": 1}
        assert "queries" in snap["scheduler_load"]


def test_admitted_work_is_bitwise_the_unadmitted(pinned):
    ctl = adm.AdmissionController(adm.AdmissionConfig(
        tenants={"gold": 2.0}, rate_rps=10_000.0, max_inflight=64))
    y = piecewise_signal(72, 48, 8, noise=0.15, seed=9)
    with _server(ctl) as (_, base_a), _server() as (_, base_p):
        ca = CoresetClient(base_a, tenant="gold", timeout=TIMEOUT)
        cp = CoresetClient(base_p, timeout=TIMEOUT)
        for cl in (ca, cp):
            cl.register_signal("s", values=y)
        assert ca.build("s", 8, 0.2).fingerprint == cp.build("s", 8, 0.2).fingerprint
        rng = np.random.default_rng(21)
        for _ in range(3):
            q = random_tree_segmentation(72, 48, 6, rng)
            ra = ca.query_loss("s", q.rects, q.labels, eps=0.3)
            rp = cp.query_loss("s", q.rects, q.labels, eps=0.3)
            assert ra.loss == rp.loss and ra.fingerprint == rp.fingerprint
        snap = ctl.snapshot()
        assert snap["rejected_total"] == 0
        assert snap["tenants"]["gold"]["admitted"] == 5
