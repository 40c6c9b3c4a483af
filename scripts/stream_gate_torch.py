#!/usr/bin/env python
"""The ``stream`` gate of ``repro_torch``: cache re-anchoring + v2 chunked
streaming.

Boots one in-process server and asserts the two acceptance invariants of
the version-aware write path and the v2 wire protocol:

  * **zero-rebuild re-anchor**: after a disjoint append delta against a
    streamed signal, every subsequent build/compress/loss is served off
    the re-anchored cache entry — ``coreset_builds`` does not move,
    ``cache_reanchored`` does, and the served coreset is **bitwise
    fingerprint-equal** to a from-scratch build of the grown signal;
  * **v2 streaming**: a >= 4 MB compress response negotiated with
    ``Accept: <binary>;v=2`` leaves the server as >= 4 default-size
    chunked segments, the client's incremental decode is identical to the
    buffered v1 body, and a truncated or corrupted stream is rejected as
    ``StreamTruncated`` (retryable) / ``ProtocolError`` (terminal), never
    silently mis-decoded.

The checks and constants are those of ``scripts/stream_gate.py``.  The
ops of both engines (the served one and the fresh build it is held to) run
where selection puts them: unpinned on the card (the server's start-up work,
``serve_coresets.runtime_hygiene``, builds and loads every kernel first), or
on the CPU under ``REPRO_TORCH_OPS_BACKEND=numpy|torch``.  With neither a
card nor a pin it exits 2 and starts nothing.

Run:  python scripts/stream_gate_torch.py
      REPRO_TORCH_OPS_BACKEND=numpy python scripts/stream_gate_torch.py
"""
from __future__ import annotations

import argparse
import io
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.client import CoresetClient  # noqa: E402
from repro_torch.data.signals import piecewise_signal  # noqa: E402
from repro_torch.service import (CoresetEngine, ServiceMetrics,  # noqa: E402
                           make_server, serve_forever_in_thread)
from repro_torch.service import protocol as P  # noqa: E402

M, ROWS, K, EPS = 64, 12, 5, 0.3


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        sys.exit(f"[stream_gate_torch] FAIL: {msg}")


def check_reanchor(base: str, eng: CoresetEngine) -> None:
    cl = CoresetClient(base, encoding="binary")
    bands = [piecewise_signal(ROWS, M, K, noise=0.15, seed=s)
             for s in range(5)]
    for b in bands[:-1]:
        cl.ingest("gate-st", band=b)
    cl.build("gate-st", K, EPS)
    builds = eng.metrics.get("coreset_builds")
    r = cl.ingest_delta("gate-st", bands[-1])            # disjoint append
    _gate(r.entries_reanchored == 1,
          f"append did not re-anchor (entries_reanchored="
          f"{r.entries_reanchored})")
    b2 = cl.build("gate-st", K, EPS)
    comp = cl.compress("gate-st", K, EPS, max_points=1 << 20)
    _gate(b2.served_from == "exact" and comp.served_from == "exact",
          f"post-delta requests not served from cache "
          f"({b2.served_from}/{comp.served_from})")
    _gate(eng.metrics.get("coreset_builds") == builds,
          "re-anchored delta still triggered a rebuild")
    _gate(eng.metrics.get("cache_reanchored") == 1,
          "cache_reanchored counter did not move")
    # bitwise parity with a from-scratch build of the grown signal
    ref = CoresetEngine(workers=2, metrics=ServiceMetrics())
    try:
        for b in bands:
            ref.ingest_band("gate-st", b)
        cs_ref, _, _ = ref.get_coreset("gate-st", K, EPS)
        _gate(b2.fingerprint == cs_ref.fingerprint(),
              "re-anchored coreset is not bitwise equal to a fresh build")
    finally:
        ref.close()
    print(f"[stream_gate_torch] re-anchor: 1 entry re-keyed, builds stayed at "
          f"{builds}, fingerprint {b2.fingerprint} == fresh build")


def check_stream(base: str, eng: CoresetEngine) -> None:
    # block-rich signal: >= 4 MB of weighted points at eps=0.01
    y = np.random.default_rng(9).random((256, 256)) * 8.0
    v1 = CoresetClient(base, encoding="binary", stream=False)
    v2 = CoresetClient(base, encoding="binary")
    v1.register_signal("gate-big", values=y)
    kw = dict(eps=0.01, max_points=1 << 20)
    r2 = v2.compress("gate-big", 3, **kw)
    nbytes = r2.X.nbytes + r2.y.nbytes + r2.w.nbytes
    _gate(nbytes >= 4 << 20, f"coreset too small to gate ({nbytes}B)")
    _gate(v2.last_stream_chunks >= 4,
          f"{nbytes}B compress streamed in {v2.last_stream_chunks} < 4 "
          f"chunks")
    _gate(eng.metrics.get("http_stream_responses") >= 1,
          "server never took the streaming path")
    r1 = v1.compress("gate-big", 3, **kw)
    for f in ("X", "y", "w"):
        _gate(np.array_equal(getattr(r1, f), getattr(r2, f)),
              f"v2-decoded {f} differs from the buffered v1 body")
    _gate(r1.fingerprint == r2.fingerprint, "fingerprint mismatch across "
                                            "protocol versions")
    # wire-level rejection: truncation is retryable, corruption terminal
    segs = list(P.compress_stream_segments(r2, chunk_points=4096))
    blob = b"".join(segs)
    try:
        P.read_compress_stream(io.BytesIO(blob[:len(blob) // 2]).read)
        _gate(False, "truncated stream decoded without error")
    except P.StreamTruncated:
        pass
    bad = bytearray(blob)
    bad[len(segs[0]) + 40] ^= 0xFF
    try:
        P.read_compress_stream(io.BytesIO(bytes(bad)).read)
        _gate(False, "corrupted stream decoded without error")
    except P.StreamTruncated:
        _gate(False, "corruption misclassified as retryable truncation")
    except P.ProtocolError:
        pass
    print(f"[stream_gate_torch] stream: {nbytes >> 20} MB compress in "
          f"{v2.last_stream_chunks} chunks, v1/v2 bitwise equal, "
          f"truncation/corruption rejected")


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    from repro_torch.launch.serve_coresets import (require_backends,
                                                   runtime_hygiene)
    try:
        backends = require_backends()
    except RuntimeError as exc:
        print(f"stream_gate_torch: {exc}; nothing was run", file=sys.stderr)
        return 2
    runtime_hygiene(backends, verbose=False)
    eng = CoresetEngine(workers=4, metrics=ServiceMetrics())
    srv = make_server(eng)
    serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        check_reanchor(base, eng)
        check_stream(base, eng)
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()
    print("[stream_gate_torch] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
