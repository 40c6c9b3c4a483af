"""v1 wire protocol — typed request/response messages for the coreset service.

One shared vocabulary for server (``service.api``), SDK
(``repro_torch.client``) and tools (``serve_coresets --smoke``,
``chip_smoke.py``): frozen dataclasses with symmetric ``to_wire()`` /
``from_wire()`` so nobody re-encodes dicts by hand, plus two negotiated
encodings

  * ``application/json``            — readable, slow for large arrays;
  * ``application/x-repro-npz-v1``  — a compressed npz frame: magic
    ``RPV1`` + 1 codec byte (``Z`` zstandard / ``z`` zlib, mirroring the
    checkpointer's fallback) + compressed npz whose ``__json__`` member
    holds the scalar fields and whose remaining members are the ndarray
    fields verbatim.  Registration of a 512x512 signal spends its time in
    ``tobytes``/zlib instead of ``tolist``/``json``, where JSON array
    parsing would dominate.

Versioning policy (see DESIGN.md "v1 protocol"): the payload carries a
``type`` tag (dispatch) and the frame a protocol magic; adding optional
fields is backward compatible (``from_wire`` ignores unknown keys and fills
defaults), renaming/removing fields requires a new ``/v2`` route family.

Arrays with numpy extension dtypes (bfloat16/fp8 — dtype kind ``V``) are
widened to float32 on encode, exactly like the checkpointer: npz cannot
represent them, and float32 is exact for every sub-32-bit float, so the
widening is lossless (but not round-tripping the dtype — by design).
NaN/inf survive both encodings (Python's json module emits and parses
them; npz stores raw IEEE bytes).

Every message encodes byte for byte as the reference package's
``repro.service.protocol`` does, so either package's client talks to
either package's server.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import struct
import zlib

import numpy as np

try:
    import zstandard
except ModuleNotFoundError:  # bare containers: stdlib zlib fallback
    zstandard = None

__all__ = [
    "PROTOCOL_VERSION", "CONTENT_TYPE_JSON", "CONTENT_TYPE_BINARY",
    "CoresetSpec", "SignalRef", "RegisterRequest", "IngestRequest",
    "IngestDeltaRequest", "BuildRequest", "LossQuery", "BatchLossQuery",
    "FitRequest", "CompressRequest", "SignalInfo", "IngestDeltaResponse",
    "BuildResponse", "LossResponse", "BatchLossResponse", "FitResponse",
    "CompressResponse", "ErrorInfo", "ErrorResponse", "ProtocolError",
    "UnsupportedCodec", "decode", "encode",
    # ---- v2 chunked streaming
    "PROTOCOL_VERSION_STREAM", "CONTENT_TYPE_STREAM", "STREAM_MAGIC",
    "StreamTruncated", "CompressHeader", "CompressChunk", "CompressTrailer",
    "accept_stream", "compress_stream_segments", "read_compress_stream",
]

PROTOCOL_VERSION = "v1"
CONTENT_TYPE_JSON = "application/json"
CONTENT_TYPE_BINARY = "application/x-repro-npz-v1"

_MAGIC = b"RPV1"
# codec byte -> (compress, decompress); level 1: signal payloads are noisy
# floats (near-incompressible), so throughput beats ratio on the wire path
_ENC_ZSTD = (lambda b: zstandard.ZstdCompressor(level=1).compress(b)) \
    if zstandard is not None else None


class ProtocolError(ValueError):
    """Malformed frame / unknown message type / bad field value."""


class UnsupportedCodec(ProtocolError):
    """Frame codec this host cannot decode (zstd frame, no zstandard) —
    the server maps this to HTTP 415 so clients renegotiate, unlike plain
    400s which mean the request itself is bad."""


# decompressed-size ceiling: the HTTP layer caps the *compressed* body, but
# a zlib/zstd bomb (200 MB of compressed zeros -> ~200 GB) must die here,
# before the allocation, not in the OOM killer
_MAX_DECODED = 1 << 30


# --------------------------------------------------------------------- fields
def _arr(dtype, ndim: int | None = None, allow_none: bool = False):
    """Field coercer: JSON lists -> ndarray of ``dtype``; ndarrays from the
    npz path pass through (widened dtypes stay widened).  ``ndim`` enforces
    rank AFTER coercion — a ragged nested list coerces to an object array,
    which both the dtype cast and the rank check reject."""
    def coerce(v):
        if v is None:
            if allow_none:
                return None
            raise ProtocolError("array field must not be null")
        if not isinstance(v, np.ndarray):
            try:
                v = np.asarray(v, dtype)
            except (TypeError, ValueError) as exc:
                raise ProtocolError(f"not a numeric array: {exc}") from None
        if v.dtype.kind not in "iuf":
            raise ProtocolError(f"array has non-numeric dtype {v.dtype}")
        if ndim is not None and v.ndim != ndim:
            raise ProtocolError(f"array must be {ndim}-D, got {v.ndim}-D "
                                f"(ragged input coerces to object arrays)")
        return v
    return coerce


def _widen(a: np.ndarray) -> np.ndarray:
    # npz degrades extension dtypes (kind 'V': bfloat16/fp8) to raw void;
    # float32 is exact for every sub-32-bit float (checkpointer idiom)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


class _Wire:
    """Mixin: generic payload <-> dataclass conversion + frame codecs.

    Subclasses are frozen dataclasses.  Nested messages (``CoresetSpec``,
    ``SignalRef``, ``ErrorInfo``) and ndarray fields are discovered from the
    ``_NESTED`` / ``_COERCE`` class tables, so adding a message is one
    dataclass + one registry line.
    """

    kind: str = ""
    _NESTED: dict = {}
    _COERCE: dict = {}

    # --------------------------------------------------------------- payload
    def to_payload(self) -> dict:
        out = {"type": self.kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v):
                v = dataclasses.asdict(v)
            out[f.name] = v
        return out

    @classmethod
    def from_payload(cls, d: dict) -> "_Wire":
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in d or d[f.name] is None:
                if f.default is dataclasses.MISSING and \
                        f.default_factory is dataclasses.MISSING:
                    raise ProtocolError(f"{cls.kind}: missing field {f.name!r}")
                if f.name not in d:
                    continue
            v = d[f.name]
            if f.name in cls._NESTED and v is not None:
                if not isinstance(v, dict):
                    raise ProtocolError(f"{cls.kind}.{f.name} must be an object")
                # recurse through from_payload: unknown keys are ignored
                # (forward compat) and failures surface as ProtocolError
                v = cls._NESTED[f.name].from_payload(v)
            elif f.name in cls._COERCE:
                v = cls._COERCE[f.name](v)
            kw[f.name] = v
        try:
            return cls(**kw)
        except TypeError as exc:
            raise ProtocolError(f"{cls.kind}: {exc}") from None

    # ---------------------------------------------------------------- frames
    def to_wire(self, encoding: str = "json", *,
                binary_codec: str | None = None) -> tuple[str, bytes]:
        """Serialize to (content_type, body).  ``encoding``: json | binary.

        ``binary_codec`` pins the frame codec: "zlib" (always decodable —
        stdlib), "zstd" (requires zstandard on BOTH ends), or None = the
        best this host can encode.  Servers pass the codec the client
        advertised in ``Accept`` so a zlib-only client never receives a
        zstd frame it cannot decode.
        """
        payload = self.to_payload()
        if encoding == "json":
            body = json.dumps(
                {k: v.tolist() if isinstance(v, np.ndarray) else v
                 for k, v in payload.items()}).encode()
            return CONTENT_TYPE_JSON, body
        if encoding != "binary":
            raise ProtocolError(f"unknown encoding {encoding!r}")
        arrays = {k: _widen(v) for k, v in payload.items()
                  if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in payload.items() if k not in arrays}
        buf = io.BytesIO()
        np.savez(buf, __json__=np.frombuffer(json.dumps(meta).encode(),
                                             np.uint8), **arrays)
        raw = buf.getvalue()
        if binary_codec == "zstd" and _ENC_ZSTD is None:
            raise UnsupportedCodec("zstd requested but zstandard is not "
                                   "installed on this host")
        use_zstd = (_ENC_ZSTD is not None if binary_codec is None
                    else binary_codec == "zstd")
        if use_zstd:
            return CONTENT_TYPE_BINARY, _MAGIC + b"Z" + _ENC_ZSTD(raw)
        return CONTENT_TYPE_BINARY, _MAGIC + b"z" + zlib.compress(raw, 1)

    @staticmethod
    def accept_codec(accept_header: str) -> str:
        """The binary codec a peer's ``Accept`` header permits: "zstd" only
        when explicitly advertised (``;codec=zstd``), else "zlib" — the
        conservative default keeps responses stdlib-decodable for clients
        that predate the codec parameter."""
        return "zstd" if "codec=zstd" in accept_header.replace(" ", "") \
            else "zlib"

    # equality: field-wise with NaN-tolerant array comparison (round-trip
    # tests and client assertions; frozen dataclasses use eq=False)
    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                        and a.shape == b.shape
                        and np.array_equal(a, b, equal_nan=True)):
                    return False
            elif a != b:
                return False
        return True

    __hash__ = None


def _payload_from_wire(content_type: str, body: bytes) -> dict:
    ctype = (content_type or "").split(";", 1)[0].strip().lower()
    if ctype in ("", CONTENT_TYPE_JSON):
        try:
            d = json.loads(body or b"{}")
        except json.JSONDecodeError as exc:
            raise ProtocolError(f"bad JSON body: {exc}") from None
        if not isinstance(d, dict):
            raise ProtocolError("JSON body must be an object")
        return d
    if ctype != CONTENT_TYPE_BINARY:
        raise ProtocolError(f"unsupported content type {content_type!r}")
    if len(body) < 5 or body[:4] != _MAGIC:
        raise ProtocolError("bad binary frame: missing RPV1 magic")
    codec, blob = body[4:5], body[5:]
    try:
        if codec == b"Z":
            if zstandard is None:
                raise UnsupportedCodec(
                    "frame is zstd-compressed but the zstandard module is "
                    "not installed on this host")
            params = zstandard.get_frame_parameters(blob)
            if params.content_size > _MAX_DECODED:
                raise ProtocolError(
                    f"decompressed frame exceeds {_MAX_DECODED} bytes")
            raw = zstandard.ZstdDecompressor().decompress(
                blob, max_output_size=_MAX_DECODED)
        elif codec == b"z":
            dec = zlib.decompressobj()
            raw = dec.decompress(blob, _MAX_DECODED)
            if dec.unconsumed_tail:
                raise ProtocolError(
                    f"decompressed frame exceeds {_MAX_DECODED} bytes")
        else:
            raise ProtocolError(f"unknown frame codec {codec!r}")
        npz = np.load(io.BytesIO(raw))
    except ProtocolError:
        raise
    except Exception as exc:  # zlib.error, zstd errors, bad zip
        raise ProtocolError(f"corrupt binary frame: {exc}") from None
    if "__json__" not in npz.files:
        raise ProtocolError("binary frame missing __json__ member")
    d = json.loads(bytes(npz["__json__"]))
    for name in npz.files:
        if name != "__json__":
            d[name] = npz[name]
    return d


_REGISTRY: dict[str, type] = {}


def _message(kind: str):
    """Class decorator: freeze, register under ``kind`` for decode dispatch."""
    def wrap(cls):
        cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls
    return wrap


def decode(content_type: str, body: bytes, expect: type | None = None):
    """Parse a wire frame into its typed message (dispatch on ``type``).

    ``expect`` pins the message class for endpoint handlers: a payload whose
    tag names a different registered message is rejected, and an untagged
    payload (hand-written JSON) is parsed as ``expect`` for compatibility.
    """
    d = _payload_from_wire(content_type, body)
    tag = d.pop("type", None)
    if tag is None:
        if expect is None:
            raise ProtocolError("payload has no 'type' tag")
        cls = expect
    else:
        cls = _REGISTRY.get(tag)
        if cls is None:
            raise ProtocolError(f"unknown message type {tag!r}")
        if expect is not None and cls is not expect:
            raise ProtocolError(f"expected {expect.kind!r}, got {tag!r}")
    return cls.from_payload(d)


def encode(msg: "_Wire", encoding: str = "json") -> tuple[str, bytes]:
    return msg.to_wire(encoding)


# ---------------------------------------------------------------- vocabulary
@_message("coreset_spec")
class CoresetSpec(_Wire):
    """The (k, eps) guarantee a client asks for.  ``fidelity`` selects the
    gamma regime of ``signal_coreset`` ("practical" | "paper")."""
    k: int
    eps: float = 0.2
    fidelity: str = "practical"

    def __post_init__(self):
        object.__setattr__(self, "k", int(self.k))
        object.__setattr__(self, "eps", float(self.eps))
        if self.k < 1:
            raise ProtocolError("spec.k must be >= 1")
        if not (0.0 < self.eps < 1.0):
            raise ProtocolError("spec.eps must be in (0, 1)")
        if self.fidelity not in ("practical", "paper"):
            raise ProtocolError(f"unknown fidelity {self.fidelity!r}")


@_message("signal_ref")
class SignalRef(_Wire):
    """A named signal, optionally pinned to a content version (None = the
    server's current version)."""
    name: str
    version: str | None = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ProtocolError("signal name must be a non-empty string")


# ----------------------------------------------------------------- requests
@_message("register")
class RegisterRequest(_Wire):
    signal: SignalRef
    values: np.ndarray | None = None     # (n, m) dense payload
    synthetic: dict | None = None        # server-side generation spec
    replace: bool = False
    tenant: str | None = None            # QoS accounting identity
    _NESTED = {"signal": SignalRef}
    _COERCE = {"values": _arr(np.float64, ndim=2, allow_none=True)}


@_message("ingest")
class IngestRequest(_Wire):
    signal: SignalRef
    band: np.ndarray | None = None       # (rows, m) appended row band
    synthetic: dict | None = None
    tenant: str | None = None
    _NESTED = {"signal": SignalRef}
    _COERCE = {"band": _arr(np.float64, ndim=2, allow_none=True)}


@_message("ingest_delta")
class IngestDeltaRequest(_Wire):
    """Delta write: only the changed rows cross the wire.  ``row0`` is the
    absolute row offset of the replaced band (must align with an ingested
    band on streamed signals); None appends at the current end.

    **Burst form**: ``row0s``/``rows`` ship MANY deltas in one request —
    ``band`` is then the row-wise concatenation of ``len(row0s)`` bands of
    ``rows[i]`` rows each, placed at ``row0s[i]`` (null entries append).
    The server fans the per-band leaf rebuilds out through one batched
    scheduler submission instead of N sequential builds."""
    signal: SignalRef
    band: np.ndarray                     # (rows, m) changed rows only
    row0: int | None = None
    row0s: list | None = None            # burst: per-band placement
    rows: list | None = None             # burst: per-band row counts
    tenant: str | None = None
    _NESTED = {"signal": SignalRef}
    _COERCE = {"band": _arr(np.float64, ndim=2)}


@_message("build")
class BuildRequest(_Wire):
    signal: SignalRef
    spec: CoresetSpec
    deadline_ms: float | None = None
    tenant: str | None = None
    _NESTED = {"signal": SignalRef, "spec": CoresetSpec}


@_message("loss_query")
class LossQuery(_Wire):
    """Algorithm-5 loss of one k-segmentation.  ``spec`` is optional: k
    defaults to the tree's leaf count, eps to 0.2.

    ``deadline_ms`` bounds the server-side wait (build queue + batching
    window); past it the request fails 504 ``deadline_exceeded``.
    ``coalesce=False`` is the escape hatch that skips the cross-request
    QueryScheduler and scores inline.

    Labels are coerced to float64, never checked for finiteness.  A leaf
    of zero area with a NaN or infinite label adds nothing on the
    ``numpy`` and ``cuda`` backends (the oracle's sum and the kernel skip
    every pair with no overlap) and makes the loss NaN on ``torch`` (its
    dense terms compute 0 * NaN), as the reference's oracle and its
    ``xla`` backend answer."""
    signal: SignalRef
    rects: np.ndarray                     # (K, 4) half-open block corners
    labels: np.ndarray                    # (K,)
    spec: CoresetSpec | None = None
    deadline_ms: float | None = None
    coalesce: bool = True
    tenant: str | None = None
    _NESTED = {"signal": SignalRef, "spec": CoresetSpec}
    _COERCE = {"rects": _arr(np.int64, ndim=2),
               "labels": _arr(np.float64, ndim=1)}


@_message("batch_loss_query")
class BatchLossQuery(_Wire):
    """T same-signal segmentations scored in ONE fused engine call
    (``core.sharded.fitting_loss_batched``), instead of T sequential
    /query/loss round trips.  ``coalesce=False`` skips the cross-request
    QueryScheduler (the batch then dispatches alone instead of fusing with
    concurrent same-coreset queries)."""
    signal: SignalRef
    rects: np.ndarray                     # (T, K, 4)
    labels: np.ndarray                    # (T, K)
    spec: CoresetSpec | None = None
    deadline_ms: float | None = None
    coalesce: bool = True
    tenant: str | None = None
    _NESTED = {"signal": SignalRef, "spec": CoresetSpec}
    _COERCE = {"rects": _arr(np.int64, ndim=3),
               "labels": _arr(np.float64, ndim=2)}


@_message("fit_request")
class FitRequest(_Wire):
    signal: SignalRef
    spec: CoresetSpec
    n_estimators: int = 10
    max_leaves: int | None = None
    predict: np.ndarray | None = None     # (P, 2) grid points to evaluate
    seed: int = 0
    deadline_ms: float | None = None
    tenant: str | None = None
    _NESTED = {"signal": SignalRef, "spec": CoresetSpec}
    _COERCE = {"predict": _arr(np.float64, ndim=2, allow_none=True)}


@_message("compress_request")
class CompressRequest(_Wire):
    signal: SignalRef
    spec: CoresetSpec
    target_frac: float | None = None
    style: str = "mean"
    max_points: int = 4096
    deadline_ms: float | None = None
    tenant: str | None = None
    _NESTED = {"signal": SignalRef, "spec": CoresetSpec}


# ---------------------------------------------------------------- responses
@_message("signal_info")
class SignalInfo(_Wire):
    name: str
    n: int
    m: int | None
    bands: int
    streamed: bool
    version: str
    builders: list = dataclasses.field(default_factory=list)


@_message("ingest_delta_response")
class IngestDeltaResponse(_Wire):
    """Acknowledgement of a delta write, with the incremental-path telemetry
    (how much merge-reduce state was reused instead of rebuilt)."""
    name: str
    n: int
    m: int
    bands: int
    streamed: bool
    version: str
    mode: str                 # append | replace | burst
    row0: int
    rows: int
    buckets_recompressed: int
    entries_recached: int
    deltas: int = 1           # bands in the burst (1 = single-delta form)
    entries_reanchored: int = 0   # cache entries re-keyed to the new
                                  # version in metadata time (no rebuild)


@_message("build_response")
class BuildResponse(_Wire):
    fingerprint: str
    eps_eff: float
    served_from: str          # exact | dominated | built | coalesced
    size: int
    blocks: int
    nbytes: int
    compression_ratio: float
    certified: bool
    build_seconds: float


@_message("loss_response")
class LossResponse(_Wire):
    loss: float
    k: int
    eps: float
    eps_eff: float
    served_from: str
    fingerprint: str
    coreset_size: int
    fused_batch_size: int = 1 # requests sharing the dispatch that served this
    backend: str = ""         # the repro_torch.ops backend the dispatch ran on


@_message("batch_loss_response")
class BatchLossResponse(_Wire):
    losses: np.ndarray        # (T,)
    k: int
    eps: float
    eps_eff: float
    served_from: str
    fingerprint: str
    coreset_size: int
    scoring_calls: int        # fused engine evaluations consumed (1 per batch)
    fused_batch_size: int = 1 # trees the single dispatch scored
    _COERCE = {"losses": _arr(np.float64, ndim=1)}


@_message("fit_response")
class FitResponse(_Wire):
    k: int
    eps: float
    eps_eff: float
    served_from: str
    fingerprint: str
    train_size: int
    n_estimators: int
    model_cache: str          # hit | fit
    predictions: np.ndarray | None = None
    _COERCE = {"predictions": _arr(np.float64, ndim=1, allow_none=True)}


@_message("compress_response")
class CompressResponse(_Wire):
    k: int
    eps_eff: float
    served_from: str
    fingerprint: str
    size: int
    blocks: int
    nbytes: int
    compression_ratio: float
    truncated: bool
    X: np.ndarray             # (P, 2) weighted point coordinates
    y: np.ndarray             # (P,) labels
    w: np.ndarray             # (P,) weights
    _COERCE = {"X": _arr(np.float64, ndim=2),
               "y": _arr(np.float64, ndim=1),
               "w": _arr(np.float64, ndim=1)}


@_message("error_info")
class ErrorInfo(_Wire):
    code: str                 # bad_request | not_found | overloaded | internal
    message: str
    # admission-rejection extras.  All optional with None defaults,
    # so v1 peers that predate them decode the envelope unchanged (unknown
    # keys are ignored on decode, missing keys fill from defaults).
    retry_after: float | None = None    # seconds; mirrors the Retry-After header
    tenant: str | None = None           # tenant the rejection was charged to
    reason: str | None = None           # deadline_unmeetable | tenant_rate | ...


@_message("error")
class ErrorResponse(_Wire):
    """The uniform v1 error envelope: HTTP status >= 400 bodies are always
    ``{"type": "error", "error": {"code", "message"}}``."""
    error: ErrorInfo
    _NESTED = {"error": ErrorInfo}


# ===================================================== v2 chunked streaming
#
# The v1 path buffers a whole ``CompressResponse`` — metadata + every
# (X, y, w) point — into ONE npz frame on both sides, so peak memory during
# a large ``compress`` scales with coreset size.  v2 streams the same
# response as a sequence of independently decodable SEGMENTS over HTTP
# chunked transfer-encoding:
#
#     RPS2 | seg(header) | seg(chunk 0) ... seg(chunk C-1) | seg(trailer)
#
#     seg(msg) := u32 big-endian frame length | v1 binary frame of msg
#
# Each segment's payload is an ordinary v1 binary frame (magic + codec byte
# + compressed npz) of a registered message, so codec negotiation, bomb
# ceilings, and typed decode errors are all inherited from the v1 machinery
# — v2 only adds framing, sequencing, and an end-to-end digest:
#
#   * ``CompressHeader``  — the scalar half of ``CompressResponse`` plus
#     the expected chunk count, sent before any points;
#   * ``CompressChunk``   — ``seq`` (0-based, strictly sequential) and a
#     bounded slice of the point arrays, so the producer's working set is
#     O(chunk) no matter how large the coreset;
#   * ``CompressTrailer`` — chunk/point totals and a blake2b digest over
#     the raw point bytes in order, so truncation at a segment boundary
#     (which plain chunked encoding cannot detect) and reordering both
#     fail closed as ``StreamTruncated`` / ``ProtocolError``.
#
# Version negotiation rides the Accept header — ``Accept:
# application/x-repro-npz-v1;codec=zstd;v=2`` — so a v2 client talking to a
# v1 server degrades silently to the buffered response (the v1 server
# matches on the content-type substring and ignores the parameter), and a
# v1 client never sees a stream it did not ask for.

PROTOCOL_VERSION_STREAM = "v2"
CONTENT_TYPE_STREAM = "application/x-repro-stream-v2"
STREAM_MAGIC = b"RPS2"
STREAM_CHUNK_POINTS = 32768     # default points per chunk (~1 MiB raw)
_MAX_SEGMENT = 1 << 28          # one segment must never be a whole-response
                                # buffer in disguise (nor an alloc bomb)


class StreamTruncated(ProtocolError):
    """v2 stream ended mid-segment or before its trailer — the transfer
    died, not the request.  Clients treat this as transient (retryable)
    where other ProtocolErrors are terminal."""


@_message("compress_header")
class CompressHeader(_Wire):
    """Everything of a ``CompressResponse`` except the point arrays, known
    before the first chunk is encoded."""
    k: int
    eps_eff: float
    served_from: str
    fingerprint: str
    size: int
    blocks: int
    nbytes: int
    compression_ratio: float
    truncated: bool
    points: int               # total points the chunks will carry
    chunks: int               # segments to expect before the trailer


@_message("compress_chunk")
class CompressChunk(_Wire):
    seq: int                  # 0-based, strictly sequential
    X: np.ndarray             # (p, 2) slice of the point coordinates
    y: np.ndarray             # (p,)
    w: np.ndarray             # (p,)
    _COERCE = {"X": _arr(np.float64, ndim=2),
               "y": _arr(np.float64, ndim=1),
               "w": _arr(np.float64, ndim=1)}


@_message("compress_trailer")
class CompressTrailer(_Wire):
    chunks: int
    points: int
    digest: str               # blake2b-16 over the raw chunk bytes in order


def accept_stream(accept_header: str | None) -> bool:
    """True when the client negotiated the v2 stream: the binary content
    type with a ``v=2`` parameter (or the stream type spelled out)."""
    accept = (accept_header or "").replace(" ", "").lower()
    if CONTENT_TYPE_STREAM in accept:
        return True
    return CONTENT_TYPE_BINARY in accept and ";v=2" in (accept + ";")


def _chunk_digest() -> "hashlib._Hash":
    return hashlib.blake2b(digest_size=16)


def _digest_update(h, X: np.ndarray, y: np.ndarray, w: np.ndarray) -> None:
    h.update(np.ascontiguousarray(X, np.float64).tobytes())
    h.update(np.ascontiguousarray(y, np.float64).tobytes())
    h.update(np.ascontiguousarray(w, np.float64).tobytes())


def _segment(msg: "_Wire", binary_codec: str) -> bytes:
    _, frame = msg.to_wire("binary", binary_codec=binary_codec)
    return struct.pack(">I", len(frame)) + frame


def compress_stream_segments(resp: CompressResponse, *,
                             chunk_points: int = STREAM_CHUNK_POINTS,
                             binary_codec: str = "zlib"):
    """Yield the v2 byte segments of ``resp`` (magic first, trailer last).

    Each yielded bytes object is one write: the caller (the HTTP layer)
    flushes it as a transfer-encoding chunk before the next is encoded, so
    encode-side peak memory is O(chunk_points), not O(points).  Chunk
    slices are views into ``resp``'s arrays — nothing is copied until the
    per-segment npz encode.
    """
    chunk_points = max(1, int(chunk_points))
    points = int(resp.y.shape[0])
    chunks = (points + chunk_points - 1) // chunk_points
    header = CompressHeader(
        k=resp.k, eps_eff=resp.eps_eff, served_from=resp.served_from,
        fingerprint=resp.fingerprint, size=resp.size, blocks=resp.blocks,
        nbytes=resp.nbytes, compression_ratio=resp.compression_ratio,
        truncated=resp.truncated, points=points, chunks=chunks)
    yield STREAM_MAGIC + _segment(header, binary_codec)
    h = _chunk_digest()
    for seq in range(chunks):
        lo, hi = seq * chunk_points, min((seq + 1) * chunk_points, points)
        X, y, w = resp.X[lo:hi], resp.y[lo:hi], resp.w[lo:hi]
        _digest_update(h, X, y, w)
        yield _segment(CompressChunk(seq=seq, X=X, y=y, w=w), binary_codec)
    yield _segment(CompressTrailer(chunks=chunks, points=points,
                                   digest=h.hexdigest()), binary_codec)


def _read_exact(read, n: int, what: str) -> bytes:
    """Drain exactly ``n`` bytes from a ``read(size)`` callable (short reads
    are normal at transport boundaries); EOF mid-object is truncation."""
    parts, got = [], 0
    while got < n:
        piece = read(n - got)
        if not piece:
            raise StreamTruncated(
                f"v2 stream truncated reading {what}: wanted {n} bytes, "
                f"got {got}")
        parts.append(piece)
        got += len(piece)
    return b"".join(parts)


def _read_segment(read, expect: type, what: str) -> "_Wire":
    (length,) = struct.unpack(">I", _read_exact(read, 4, f"{what} length"))
    if length == 0 or length > _MAX_SEGMENT:
        raise ProtocolError(f"v2 segment length {length} out of range")
    frame = _read_exact(read, length, what)
    return decode(CONTENT_TYPE_BINARY, frame, expect=expect)


def read_compress_stream(read) -> tuple[CompressResponse, int]:
    """Incrementally decode a v2 stream from a ``read(size)`` callable
    (e.g. ``http.client`` response ``read`` — urllib de-chunks the
    transfer encoding transparently, so this sees the raw segments).

    Returns ``(response, chunks)`` where ``response`` is field-identical
    to the v1 buffered ``CompressResponse`` for the same request.  Raises
    ``StreamTruncated`` on EOF mid-stream (retryable) and ``ProtocolError``
    on sequencing/count/digest violations (corrupt, not transient).
    """
    magic = _read_exact(read, len(STREAM_MAGIC), "stream magic")
    if magic != STREAM_MAGIC:
        raise ProtocolError(f"bad v2 stream magic {magic!r}")
    header = _read_segment(read, CompressHeader, "header segment")
    if header.chunks < 0 or header.points < 0:
        raise ProtocolError("negative chunk/point count in stream header")
    h = _chunk_digest()
    Xs, ys, ws = [], [], []
    got_points = 0
    for seq in range(header.chunks):
        chunk = _read_segment(read, CompressChunk, f"chunk {seq}")
        if chunk.seq != seq:
            raise ProtocolError(
                f"v2 chunk out of order: expected seq {seq}, "
                f"got {chunk.seq}")
        if not (chunk.X.shape[0] == chunk.y.shape[0] == chunk.w.shape[0]):
            raise ProtocolError("v2 chunk arrays disagree on point count")
        _digest_update(h, chunk.X, chunk.y, chunk.w)
        Xs.append(chunk.X)
        ys.append(chunk.y)
        ws.append(chunk.w)
        got_points += int(chunk.y.shape[0])
    trailer = _read_segment(read, CompressTrailer, "trailer segment")
    if trailer.chunks != header.chunks or trailer.points != header.points:
        raise ProtocolError(
            f"v2 trailer disagrees with header: "
            f"{trailer.chunks}/{trailer.points} chunks/points vs "
            f"{header.chunks}/{header.points}")
    if got_points != header.points:
        raise ProtocolError(
            f"v2 stream carried {got_points} points, header promised "
            f"{header.points}")
    if trailer.digest != h.hexdigest():
        raise ProtocolError("v2 stream digest mismatch (corrupt chunk)")
    resp = CompressResponse(
        k=header.k, eps_eff=header.eps_eff, served_from=header.served_from,
        fingerprint=header.fingerprint, size=header.size,
        blocks=header.blocks, nbytes=header.nbytes,
        compression_ratio=header.compression_ratio,
        truncated=header.truncated,
        X=(np.concatenate(Xs, axis=0) if Xs else np.empty((0, 2))),
        y=(np.concatenate(ys) if ys else np.empty(0)),
        w=(np.concatenate(ws) if ws else np.empty(0)))
    return resp, int(header.chunks)
