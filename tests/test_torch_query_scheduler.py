"""The port's QueryScheduler against the reference's: the same padded
fused batch handed to the executor, the same scatter, the same counters;
expired deadlines, failed dispatches and the shutdown drain; and through
the engine, concurrent singles and a batch fused into one scoring call
whose losses are bitwise the reference engine's.  Flushes here are driven
by ``max_fuse`` (the full-bucket rule) or the drain, never by the clock:
the batching windows are long."""
import contextlib
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import ops as ref_ops  # noqa: E402
from repro.service import CoresetEngine as RefEngine  # noqa: E402
from repro.service import query_scheduler as ref_qs  # noqa: E402
from repro_torch import ops  # noqa: E402
from repro_torch.core import random_tree_segmentation  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.service import CoresetEngine, ServiceMetrics  # noqa: E402
from repro_torch.service import query_scheduler as qs  # noqa: E402

WAIT_S = 60.0
LONG_WINDOW = 600.0
MODULES = {"reference": ref_qs, "port": qs}


def _wait_for(cond):
    t_end = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < t_end, "condition not reached"
        time.sleep(0.001)


def _items(rng):
    singles = [(rng.integers(0, 50, size=(k, 4)), rng.normal(size=k))
               for k in (2, 3, 5)]
    batch = (rng.integers(0, 50, size=(2, 4, 4)), rng.normal(size=(2, 4)))
    return singles, batch


def _execute_recorder(calls):
    def execute(rects3, labels2):
        calls.append((rects3.copy(), labels2.copy()))
        return labels2.sum(axis=1) * 3.0 + rects3.sum(axis=(1, 2))
    return execute


def _fuse(mod):
    sched = mod.QueryScheduler(window=LONG_WINDOW, max_fuse=5, max_workers=2)
    calls = []
    try:
        singles, batch = _items(np.random.default_rng(4))
        execute = _execute_recorder(calls)
        futs = [sched.submit(("key",), r, lab, execute) for r, lab in singles]
        futs.append(sched.submit_batch(("key",), *batch, execute))
        results = [f.result(timeout=WAIT_S) for f in futs]
        counters = sched.metrics.snapshot()["counters"]
    finally:
        sched.shutdown()
    return calls, results, counters


def test_fused_batch_and_scatter_equal_the_reference():
    got_calls, got, got_counters = _fuse(qs)
    want_calls, want, want_counters = _fuse(ref_qs)
    assert len(got_calls) == len(want_calls) == 1
    for (gr, gl), (wr, wl) in zip(got_calls, want_calls):
        assert gr.dtype == wr.dtype and np.array_equal(gr, wr)
        assert gl.dtype == wl.dtype and np.array_equal(gl, wl)
    assert got_calls[0][0].shape == (5, 5, 4)        # padded to the widest
    for (gv, gn), (wv, wn) in zip(got, want):
        assert gn == wn == 5
        assert np.array_equal(gv, wv)
    assert isinstance(got[-1][0], np.ndarray) and got[-1][0].shape == (2,)
    assert got_counters == want_counters
    assert got_counters["query_fused_dispatches"] == 1
    assert got_counters["query_coalesced_total"] == 3
    assert got_counters['query_flushes{reason="full"}'] == 1


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_an_expired_deadline_fails_before_enqueue(mod):
    m = MODULES[mod]
    sched = m.QueryScheduler(window=LONG_WINDOW, max_fuse=2)
    try:
        fut = sched.submit(("k",), np.zeros((1, 4)), np.zeros(1),
                           lambda r, lab: np.zeros(r.shape[0]),
                           deadline=time.perf_counter() - 1.0)
        with pytest.raises(m.DeadlineExceeded):
            fut.result(timeout=WAIT_S)
        assert sched.metrics.get("query_deadline_expired") == 1
        assert sched.in_flight() == 0
    finally:
        sched.shutdown()


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_shutdown_drains_every_queued_query(mod):
    m = MODULES[mod]
    sched = m.QueryScheduler(window=LONG_WINDOW, max_fuse=100)
    calls = []
    futs = [sched.submit(("k", i % 2), np.full((1, 4), i), np.ones(1),
                         _execute_recorder(calls)) for i in range(5)]
    assert sched.load() == {"queued": 5, "buckets": 2}
    sched.shutdown()
    assert [f.result(timeout=WAIT_S)[1] for f in futs] == [3, 2, 3, 2, 3]
    assert sched.metrics.get('query_flushes{reason="drain"}') == 2
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(("k",), np.zeros((1, 4)), np.zeros(1), lambda r, lab: r)


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_a_failed_dispatch_fails_each_waiter(mod):
    m = MODULES[mod]
    sched = m.QueryScheduler(window=LONG_WINDOW, max_fuse=2)

    def boom(rects3, labels2):
        raise ValueError("scoring failed")
    try:
        futs = [sched.submit(("k",), np.zeros((1, 4)), np.zeros(1), boom)
                for _ in range(2)]
        for f in futs:
            with pytest.raises(ValueError, match="scoring failed"):
                f.result(timeout=WAIT_S)
        assert sched.metrics.get("query_fused_failed") == 1
    finally:
        sched.shutdown()


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_map_fanout_keeps_order(mod):
    sched = MODULES[mod].QueryScheduler(max_workers=3)
    try:
        out = sched.map_fanout([lambda i=i: i * i for i in range(7)])
        assert out == [i * i for i in range(7)]
        assert sched.metrics.get("query_fanout_items") == 7
    finally:
        sched.shutdown()


# ------------------------------------------------------ through the engine
N, M, KMAX = 96, 64, 8


@contextlib.contextmanager
def _pinned_engines(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    kw = dict(workers=2, query_window=LONG_WINDOW, query_max_fuse=4)
    with ops.backend_override("numpy"), ref_ops.backend_override("numpy"):
        port = CoresetEngine(metrics=ServiceMetrics(), **kw)
        ref = RefEngine(**kw)
        try:
            yield port, ref
        finally:
            port.close()
            ref.close()


def _concurrent(eng, y, singles, batch):
    """Four singles from four threads fill one bucket (max_fuse 4); then
    two singles wait while a batch of three pops their bucket."""
    eng.register_signal("s", y)
    eng.get_coreset("s", KMAX, 0.3)
    out = {}

    def single(i, q):
        out[i] = eng.tree_loss("s", *q, eps=0.3, k=KMAX, timeout=WAIT_S)
    threads = [threading.Thread(target=single, args=(i, q))
               for i, q in enumerate(singles[:4])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    threads = [threading.Thread(target=single, args=(i, q))
               for i, q in enumerate(singles[4:], start=4)]
    for t in threads:
        t.start()
    _wait_for(lambda: eng.queries.in_flight() == 2)
    out["batch"] = eng.tree_loss_batch("s", *batch, eps=0.3, k=KMAX,
                                       timeout=WAIT_S)
    for t in threads:
        t.join(WAIT_S)
    return out


def test_engine_fuses_concurrent_queries_bitwise_the_reference(monkeypatch):
    y = piecewise_signal(N, M, KMAX, noise=0.15, seed=7)
    rng = np.random.default_rng(9)
    singles = [(q.rects, q.labels) for q in
               (random_tree_segmentation(N, M, KMAX, rng) for _ in range(6))]
    segs = [random_tree_segmentation(N, M, KMAX, rng) for _ in range(3)]
    batch = (np.stack([s.rects for s in segs]), np.stack([s.labels for s in segs]))
    with _pinned_engines(monkeypatch) as (port, ref):
        got = _concurrent(port, y, singles, batch)
        want = _concurrent(ref, y, singles, batch)
        inline = [port.tree_loss("s", *q, eps=0.3, k=KMAX, coalesce=False)
                  for q in singles]
    for i in range(6):
        assert got[i]["loss"] == want[i]["loss"]
        assert got[i]["fused_batch_size"] == (4 if i < 4 else 5)
        assert abs(got[i]["loss"] - inline[i]["loss"]) <= 1e-9 * inline[i]["loss"]
    assert np.array_equal(got["batch"]["losses"], want["batch"]["losses"])
    assert got["batch"]["fused_batch_size"] == 5      # rode with two singles
    counters = port.metrics.snapshot()["counters"]
    # one scoring call a fusion: two fusions, then the six inline queries
    assert counters["query_fused_dispatches"] == 2
    assert counters["loss_scoring_calls"] == 2 + 6
    assert counters["query_coalesced_total"] == 3 + 2
