"""The port's wire protocol against the reference's, byte for byte.

Every registered message, built from the same payload in both packages,
encodes to the same JSON bytes and the same binary frame (zlib codec; the
zip members' timestamps are frozen so the frames are reproducible), and
each package decodes the other's bytes to its own message.  The v2 chunked
compress stream, the codec negotiation helpers and the errors on corrupt
frames agree too."""
import io
import time
import types
import zipfile

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.service import protocol as RP  # noqa: E402
from repro_torch.service import protocol as P  # noqa: E402

RNG = np.random.default_rng(5)
_ref = {"name": "sig", "version": "abc"}
_spec = {"k": 8, "eps": 0.3, "fidelity": "practical"}
SAMPLES = {
    "coreset_spec": _spec,
    "signal_ref": _ref,
    "register": {"signal": _ref, "values": RNG.normal(size=(6, 5)),
                 "replace": True, "tenant": "gold"},
    "ingest": {"signal": _ref, "synthetic": {"kind": "piecewise", "n": 16,
                                             "m": 8, "seed": 1}},
    "ingest_delta": {"signal": _ref, "band": RNG.normal(size=(4, 5)),
                     "row0s": [0, None], "rows": [2, 2]},
    "build": {"signal": _ref, "spec": _spec, "deadline_ms": 250.0},
    "loss_query": {"signal": _ref,
                   "rects": RNG.integers(0, 9, size=(3, 4)),
                   "labels": np.array([1.5, np.nan, -np.inf]),
                   "spec": _spec, "coalesce": False},
    "batch_loss_query": {"signal": _ref,
                         "rects": RNG.integers(0, 9, size=(2, 3, 4)),
                         "labels": RNG.normal(size=(2, 3))},
    "fit_request": {"signal": _ref, "spec": _spec, "n_estimators": 3,
                    "max_leaves": 5, "predict": RNG.uniform(size=(4, 2)),
                    "seed": 2},
    "compress_request": {"signal": _ref, "spec": _spec, "target_frac": 0.1,
                         "style": "center", "max_points": 64},
    "signal_info": {"name": "sig", "n": 96, "m": 64, "bands": 2,
                    "streamed": True, "version": "v", "builders": [[8, 0.25]]},
    "ingest_delta_response": {"name": "sig", "n": 96, "m": 64, "bands": 6,
                              "streamed": True, "version": "v",
                              "mode": "replace", "row0": 32, "rows": 16,
                              "buckets_recompressed": 1,
                              "entries_recached": 1, "deltas": 1,
                              "entries_reanchored": 0},
    "build_response": {"fingerprint": "f" * 32, "eps_eff": 0.2,
                       "served_from": "built", "size": 400, "blocks": 100,
                       "nbytes": 6400, "compression_ratio": 15.36,
                       "certified": True, "build_seconds": 0.125},
    "loss_response": {"loss": 12.375, "k": 8, "eps": 0.3, "eps_eff": 0.2,
                      "served_from": "dominated", "fingerprint": "f" * 32,
                      "coreset_size": 400, "fused_batch_size": 3,
                      "backend": "cuda"},
    "batch_loss_response": {"losses": RNG.normal(size=7), "k": 8, "eps": 0.3,
                            "eps_eff": 0.2, "served_from": "exact",
                            "fingerprint": "f" * 32, "coreset_size": 400,
                            "scoring_calls": 1, "fused_batch_size": 9},
    "fit_response": {"k": 8, "eps": 0.2, "eps_eff": 0.2, "served_from": "exact",
                     "fingerprint": "f" * 32, "train_size": 400,
                     "n_estimators": 3, "model_cache": "fit",
                     "predictions": RNG.normal(size=4)},
    "compress_response": {"k": 8, "eps_eff": 0.2, "served_from": "exact",
                          "fingerprint": "f" * 32, "size": 11, "blocks": 3,
                          "nbytes": 176, "compression_ratio": 2.5,
                          "truncated": False, "X": RNG.uniform(size=(11, 2)),
                          "y": RNG.normal(size=11), "w": RNG.uniform(size=11)},
    "error_info": {"code": "overloaded", "message": "slow down",
                   "retry_after": 0.25, "tenant": "gold",
                   "reason": "tenant_rate"},
    "error": {"error": {"code": "not_found", "message": "unknown signal 'x'"}},
    "compress_header": {"k": 8, "eps_eff": 0.2, "served_from": "exact",
                        "fingerprint": "f" * 32, "size": 11, "blocks": 3,
                        "nbytes": 176, "compression_ratio": 2.5,
                        "truncated": False, "points": 11, "chunks": 3},
    "compress_chunk": {"seq": 1, "X": RNG.uniform(size=(4, 2)),
                       "y": RNG.normal(size=4), "w": RNG.uniform(size=4)},
    "compress_trailer": {"chunks": 3, "points": 11, "digest": "d" * 32},
}
KINDS = sorted(SAMPLES)


@pytest.fixture()
def frozen_zip_time(monkeypatch):
    """npz members carry the time of writing; freeze it for byte equality."""
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.time = lambda: 1_700_000_000.0
    monkeypatch.setattr(zipfile, "time", fake)


def _msgs(kind):
    return (RP._REGISTRY[kind].from_payload(dict(SAMPLES[kind])),
            P._REGISTRY[kind].from_payload(dict(SAMPLES[kind])))


def _same_payload(a, b):
    pa, pb = a.to_payload(), b.to_payload()
    assert pa.keys() == pb.keys()
    for k in pa:
        if isinstance(pa[k], np.ndarray):
            assert pa[k].dtype == pb[k].dtype
            assert np.array_equal(pa[k], pb[k], equal_nan=True)
        else:
            assert pa[k] == pb[k], k


def _own_messages(mod):
    """The messages the protocol module defines (other modules of a
    package, such as the reference's cluster RPC, register more once they
    are imported)."""
    return sorted(k for k, cls in mod._REGISTRY.items()
                  if cls.__module__ == mod.__name__)


def test_the_same_messages_and_fields():
    assert _own_messages(RP) == _own_messages(P) == KINDS
    for kind in KINDS:
        ref_fields = [(f.name, f.default) for f in
                      RP.dataclasses.fields(RP._REGISTRY[kind])]
        port_fields = [(f.name, f.default) for f in
                       P.dataclasses.fields(P._REGISTRY[kind])]
        assert [n for n, _ in ref_fields] == [n for n, _ in port_fields], kind
    for name in ("PROTOCOL_VERSION", "CONTENT_TYPE_JSON", "CONTENT_TYPE_BINARY",
                 "PROTOCOL_VERSION_STREAM", "CONTENT_TYPE_STREAM",
                 "STREAM_MAGIC", "STREAM_CHUNK_POINTS"):
        assert getattr(RP, name) == getattr(P, name), name


@pytest.mark.parametrize("kind", KINDS)
def test_json_bytes_equal(kind):
    ref, port = _msgs(kind)
    assert ref.to_wire("json") == port.to_wire("json")


@pytest.mark.parametrize("kind", KINDS)
def test_binary_frame_bytes_equal(kind, frozen_zip_time):
    ref, port = _msgs(kind)
    assert (ref.to_wire("binary", binary_codec="zlib")
            == port.to_wire("binary", binary_codec="zlib"))


@pytest.mark.parametrize("encoding", ["json", "binary"])
@pytest.mark.parametrize("kind", KINDS)
def test_each_decodes_the_other(kind, encoding):
    ref, port = _msgs(kind)
    ctype, body = ref.to_wire(encoding, binary_codec="zlib")
    got = P.decode(ctype, body)
    assert type(got) is P._REGISTRY[kind] and got == port
    ctype, body = port.to_wire(encoding, binary_codec="zlib")
    got = RP.decode(ctype, body)
    assert type(got) is RP._REGISTRY[kind] and got == ref
    _same_payload(ref, port)


@pytest.mark.parametrize("chunk_points", [1, 4, 64])
def test_v2_stream_segments_equal_and_cross_decode(chunk_points,
                                                   frozen_zip_time):
    ref, port = _msgs("compress_response")
    ref_segs = list(RP.compress_stream_segments(ref, chunk_points=chunk_points))
    port_segs = list(P.compress_stream_segments(port,
                                                chunk_points=chunk_points))
    assert ref_segs == port_segs
    got, chunks = P.read_compress_stream(io.BytesIO(b"".join(ref_segs)).read)
    assert got == port and chunks == -(-11 // chunk_points)
    got, _ = RP.read_compress_stream(io.BytesIO(b"".join(port_segs)).read)
    assert got == ref


@pytest.mark.parametrize("accept", [
    "", "application/json", P.CONTENT_TYPE_BINARY,
    P.CONTENT_TYPE_BINARY + ";codec=zstd", P.CONTENT_TYPE_BINARY + "; v=2",
    P.CONTENT_TYPE_BINARY + ";codec=zstd;v=2", P.CONTENT_TYPE_STREAM,
    P.CONTENT_TYPE_BINARY + ";v=20"])
def test_negotiation_helpers_agree(accept):
    assert P.accept_stream(accept) == RP.accept_stream(accept)
    assert P._Wire.accept_codec(accept) == RP._Wire.accept_codec(accept)


@pytest.mark.parametrize("ctype,body", [
    ("application/json", b"[1, 2]"),
    ("application/json", b"{not json"),
    (P.CONTENT_TYPE_BINARY, b"XXXX"),
    (P.CONTENT_TYPE_BINARY, b"RPV1q" + b"\0" * 8),
    (P.CONTENT_TYPE_BINARY, b"RPV1z" + b"garbage"),
    ("text/plain", b"{}"),
    ("application/json", b'{"type": "no_such_message"}'),
    ("application/json", b'{"type": "build", "signal": {"name": "s"}}'),
    ("application/json", b'{"type": "loss_query", "signal": {"name": "s"}, '
                         b'"rects": [[0, 1], [2]], "labels": [1.0]}'),
])
def test_corrupt_frames_fail_alike(ctype, body):
    with pytest.raises(RP.ProtocolError) as want:
        RP.decode(ctype, body)
    with pytest.raises(P.ProtocolError) as got:
        P.decode(ctype, body)
    assert str(got.value) == str(want.value)
    assert type(got.value).__name__ == type(want.value).__name__
