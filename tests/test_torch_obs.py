"""repro_torch.obs against repro.obs: traceparent propagation, span nesting,
the ring buffer, the Chrome export and the profile hooks (the reference's
own cases, tests/test_obs.py, on the port's copy), and the port's buckets
and headers against the reference's.

Tests build private ``Tracer`` instances rather than mutating the global
``obs.TRACER`` so they stay independent of other tests in the process.
"""
import json
import threading

import pytest

pytest.importorskip("torch")

from repro.obs import format_traceparent as ref_format_traceparent  # noqa: E402
from repro.obs import parse_traceparent as ref_parse_traceparent  # noqa: E402
from repro.obs import profile as ref_profile  # noqa: E402
from repro_torch.obs import (NOOP, Span, SpanContext, Tracer,  # noqa: E402
                             format_traceparent, mint_span_id, mint_trace_id,
                             parse_traceparent)
from repro_torch.obs import profile  # noqa: E402
from repro_torch.obs.trace import _CURRENT  # noqa: E402


# ------------------------------------------------------------- traceparent
def test_traceparent_roundtrip():
    tid, sid = mint_trace_id(), mint_span_id()
    assert len(tid) == 32 and len(sid) == 16
    hdr = format_traceparent(tid, sid)
    assert hdr == f"00-{tid}-{sid}-01"
    assert parse_traceparent(hdr) == (tid, sid)
    # whitespace and case are normalized per the spec
    assert parse_traceparent("  " + hdr.upper() + " ") == (tid, sid)


def test_traceparent_rejects_malformed_and_reserved():
    good_tid, good_sid = "ab" * 16, "cd" * 8
    for bad in (
            None, "", "garbage",
            f"00-{good_tid}-{good_sid}",            # missing flags
            f"00-{good_tid[:-1]}-{good_sid}-01",    # short trace id
            f"00-{good_tid}-{good_sid}-0",          # short flags
            f"00-{'z' * 32}-{good_sid}-01",         # non-hex
            f"ff-{good_tid}-{good_sid}-01",         # reserved version
            f"00-{'0' * 32}-{good_sid}-01",         # all-zero trace id
            f"00-{good_tid}-{'0' * 16}-01"):        # all-zero span id
        assert parse_traceparent(bad) is None, bad


def test_ids_unique():
    assert len({mint_trace_id() for _ in range(256)}) == 256
    assert len({mint_span_id() for _ in range(256)}) == 256


# ---------------------------------------------------------------- spanning
def test_span_nesting_records_parent_chain():
    tr = Tracer(capacity=8)
    root = tr.start_trace("req")
    with tr.attach(root):
        with tr.span("outer") as outer:
            with tr.span("inner", op="x") as inner:
                assert inner.parent_id == outer.span_id
            assert _CURRENT.get() is outer
    root.end()
    t = tr.get(root.trace_id)
    by_name = {s["name"]: s for s in t["spans"]}
    assert set(by_name) == {"req", "outer", "inner"}
    assert by_name["outer"]["parent_id"] == root.span_id
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["inner"]["attrs"] == {"op": "x"}
    assert by_name["req"]["parent_id"] is None
    assert t["root"] == "req" and t["duration_us"] >= 0


def test_child_span_is_noop_outside_a_trace_and_when_disabled():
    tr = Tracer(capacity=8)
    assert tr.child_span("orphan") is NOOP
    with tr.span("orphan-cm") as sp:
        assert sp is NOOP and not sp
    tr.set_enabled(False)
    assert tr.start_trace("req") is NOOP
    assert not tr.stats()["enabled"]
    tr.set_enabled(True)
    root = tr.start_trace("req")
    assert root  # truthy again
    root.end()


def test_noop_span_absorbs_all_calls():
    NOOP.set_attr("k", "v")
    NOOP.add_link(SpanContext("ab" * 16, "cd" * 8))
    NOOP.end()
    assert NOOP.context is None
    assert not NOOP


def test_traceparent_continues_callers_trace():
    tr = Tracer(capacity=8)
    tid, parent_sid = mint_trace_id(), mint_span_id()
    root = tr.start_trace("req",
                          traceparent=format_traceparent(tid, parent_sid))
    assert root.trace_id == tid and root.parent_id == parent_sid
    root.end()
    assert tr.get(tid)["trace_id"] == tid


def test_attach_carries_span_across_threads():
    tr = Tracer(capacity=8)
    root = tr.start_trace("req")
    seen = {}

    def worker(parent):
        # a fresh thread has no inherited context ...
        seen["before"] = _CURRENT.get()
        with tr.attach(parent):
            with tr.span("work") as sp:
                seen["span"] = sp

    th = threading.Thread(target=worker, args=(root,))
    th.start()
    th.join(timeout=10)
    assert seen["before"] is None
    assert seen["span"].trace_id == root.trace_id
    assert seen["span"].parent_id == root.span_id
    root.end()
    names = [s["name"] for s in tr.get(root.trace_id)["spans"]]
    assert names == ["work", "req"]


def test_span_end_is_idempotent():
    tr = Tracer(capacity=8)
    root = tr.start_trace("req")
    root.end()
    first = tr.get(root.trace_id)["duration_us"]
    root.end()
    assert tr.get(root.trace_id)["duration_us"] == first
    assert tr.stats()["completed_total"] == 1


# -------------------------------------------------------------- ring buffer
def test_ring_buffer_caps_completed_traces():
    tr = Tracer(capacity=4)
    ids = []
    for i in range(10):
        root = tr.start_trace(f"t{i}")
        root.end()
        ids.append(root.trace_id)
    st = tr.stats()
    assert st["buffered"] == 4 and st["completed_total"] == 10
    assert [t["root"] for t in tr.recent()] == ["t9", "t8", "t7", "t6"]
    assert tr.recent(limit=2) == tr.recent()[:2]
    assert tr.get(ids[0]) is None          # evicted
    assert tr.get(ids[-1]) is not None     # newest survives


def test_max_spans_per_trace_drops_and_counts():
    tr = Tracer(capacity=4, max_spans_per_trace=3)
    root = tr.start_trace("req")
    with tr.attach(root):
        for i in range(5):
            with tr.span(f"c{i}"):
                pass
    root.end()
    # 2 children over the cap were dropped, root still finalizes the trace
    assert tr.stats()["spans_dropped"] == 3  # c3, c4, and the root record
    assert len(tr.get(root.trace_id)["spans"]) == 3


def test_straggler_span_lands_in_finished_trace():
    tr = Tracer(capacity=4)
    root = tr.start_trace("req")
    late = tr.child_span("late", parent=root)
    root.end()          # finalizes with just the root
    late.end()          # straggler: appended to the finished trace
    names = [s["name"] for s in tr.get(root.trace_id)["spans"]]
    assert names == ["req", "late"]
    assert tr.stats()["spans_dropped"] == 0


# ------------------------------------------------------------------- links
def test_links_resolve_one_hop():
    tr = Tracer(capacity=8)
    fused = tr.start_trace("fused")
    req = tr.start_trace("req")
    req.add_link(fused.context, kind="fused_dispatch")
    fused.add_link(req.context)
    fused.end()
    req.end()
    t = tr.get(req.trace_id)
    [link] = t["spans"][0]["links"]
    assert link["trace_id"] == fused.trace_id
    assert link["attrs"] == {"kind": "fused_dispatch"}
    [lt] = t["linked_traces"]
    assert lt["trace_id"] == fused.trace_id and lt["root"] == "fused"
    assert tr.get(req.trace_id, resolve_links=False).get("linked_traces") is None


# ------------------------------------------------------------ chrome export
def test_chrome_export_structure():
    tr = Tracer(capacity=8)
    fused = tr.start_trace("fused")
    root = tr.start_trace("req")
    with tr.attach(root):
        with tr.span("child", op="q") as sp:
            sp.add_link(fused.context)
    fused.end()
    root.end()
    doc = json.loads(tr.chrome_json(root.trace_id))
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} >= {"req", "child", "fused"}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0 and "pid" in e and "tid" in e
    # per-trace process groups, named
    metas = [e for e in evs if e["ph"] == "M" and e["name"] == "process_name"]
    assert len({e["pid"] for e in metas}) == 2
    # flow event along the cross-trace link
    assert any(e["ph"] == "s" for e in evs)
    assert tr.chrome("0" * 32) is None


# -------------------------------------------------------------- profile hook
def test_profile_hooks_fire_and_survive_exceptions():
    calls = []

    def bad(*a):
        raise RuntimeError("hook must not break dispatch")

    def good(op, backend, size, seconds):
        calls.append((op, backend, size))

    profile.add_hook(bad)
    profile.add_hook(good)
    try:
        profile.record("fitting_loss", "numpy", 128, 0.001)
    finally:
        profile.remove_hook(bad)
        profile.remove_hook(good)
    assert calls == [("fitting_loss", "numpy", 128)]
    profile.record("fitting_loss", "numpy", 1, 0.0)  # no hooks: no-op
    assert calls == [("fitting_loss", "numpy", 128)]


def test_shape_bucket_boundaries():
    assert profile.shape_bucket(None) == "none"
    assert profile.shape_bucket(0) == "le_2^0"
    assert profile.shape_bucket(1) == "le_2^0"
    assert profile.shape_bucket(2) == "le_2^1"
    assert profile.shape_bucket(3) == "le_2^2"
    assert profile.shape_bucket(1024) == "le_2^10"
    assert profile.shape_bucket(1025) == "le_2^11"


# ------------------------------------------------------- attrs are immutable
def test_recorded_spans_are_snapshots():
    tr = Tracer(capacity=8)
    root = tr.start_trace("req")
    root.set_attr("k", 1)
    root.end()
    got = tr.get(root.trace_id)
    got["spans"][0]["attrs"]["k"] = 999
    assert tr.get(root.trace_id)["spans"][0]["attrs"]["k"] == 1


def test_span_reprs_do_not_crash():
    # Span is __slots__-only; just make sure the public surface holds
    tr = Tracer(capacity=2)
    sp = tr.start_trace("req")
    assert isinstance(sp, Span)
    ctx = sp.context
    assert ctx.to_dict() == {"trace_id": sp.trace_id, "span_id": sp.span_id}
    sp.end()


# ----------------------------------------------------- against the reference
def test_shape_bucket_equals_reference():
    sizes = [None, 0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 3 * 384 * 384,
             120_000 * 8, 2**40 + 1]
    assert [profile.shape_bucket(s) for s in sizes] == \
        [ref_profile.shape_bucket(s) for s in sizes]


def test_traceparent_interoperates_with_reference():
    tid, sid = mint_trace_id(), mint_span_id()
    assert ref_parse_traceparent(format_traceparent(tid, sid)) == (tid, sid)
    assert parse_traceparent(ref_format_traceparent(tid, sid)) == (tid, sid)
