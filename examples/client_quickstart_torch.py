"""Client SDK quickstart: drive a coreset server through the typed v1 API.

Boots an in-process server (swap ``base`` for a real deployment URL), then
walks the whole request path with ``repro_torch.client.CoresetClient``: register
a signal over the binary wire format, build a coreset, score single and
fused-batch tree queries, fit a cached forest, and read the audit fields
(``fingerprint``, ``eps_eff``, ``served_from``) every response carries.

Runs its ops on the card; without one, pin the CPU with
``REPRO_TORCH_OPS_BACKEND=numpy`` (or ``torch``), or the first op raises.

    PYTHONPATH=src python examples/client_quickstart_torch.py
    REPRO_TORCH_OPS_BACKEND=numpy PYTHONPATH=src python examples/client_quickstart_torch.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.client import CoresetAPIError, CoresetClient  # noqa: E402
from repro_torch.core import random_tree_segmentation, true_loss  # noqa: E402
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.launch.serve_coresets import require_backends  # noqa: E402
from repro_torch.service import CoresetEngine, make_server, serve_forever_in_thread  # noqa: E402


def main() -> None:
    # the server's start-up check: its ops run on the card, or where the
    # caller pinned them; with neither it raises before it boots
    require_backends()
    engine = CoresetEngine(workers=4)
    srv = make_server(engine)
    serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    # encoding="binary" (the default) ships arrays as compressed npz frames;
    # pass encoding="json" to watch readable bodies instead
    client = CoresetClient(base)

    # 1. register a 256x256 signal — no tolist(), no hand-rolled dicts
    y = piecewise_signal(256, 256, k=16, noise=0.15, seed=0)
    info = client.register_signal("demo", values=y)
    print(f"registered {info.name}: {info.n}x{info.m}, version {info.version}")

    # 2. build the anchor (k, eps)-coreset; the response is a typed dataclass
    b = client.build("demo", k=16, eps=0.25)
    print(f"coreset {b.fingerprint[:10]}… size={b.size} "
          f"({100 * b.compression_ratio:.2f}% of cells) "
          f"eps_eff={b.eps_eff} built in {b.build_seconds:.2f}s")

    # 3. single tree-loss query — served from the dominance cache
    rng = np.random.default_rng(1)
    seg = random_tree_segmentation(256, 256, 12, rng)
    r = client.query_loss("demo", seg.rects, seg.labels, eps=0.3)
    tl = true_loss(y, seg.rects, seg.labels)
    print(f"tree loss {r.loss:.1f} vs true {tl:.1f} "
          f"(rel err {abs(r.loss - tl) / tl:.2%}, served_from={r.served_from})")

    # 4. fused batch: 32 candidate trees in ONE request / ONE scoring call
    segs = [random_tree_segmentation(256, 256, 12, rng) for _ in range(32)]
    rb = client.query_loss_batch(
        "demo", np.stack([s.rects for s in segs]),
        np.stack([s.labels for s in segs]), eps=0.3)
    print(f"batch of {len(rb.losses)} trees: best loss {rb.losses.min():.1f} "
          f"({rb.scoring_calls} fused scoring call)")

    # 5. forest fit — repeat hits the model cache keyed by coreset fingerprint
    f1 = client.fit("demo", k=16, eps=0.25, n_estimators=5,
                    predict=[[1, 1], [254, 254]])
    f2 = client.fit("demo", k=16, eps=0.25, n_estimators=5,
                    predict=[[1, 1], [254, 254]])
    print(f"forest on {f1.train_size} weighted points: first={f1.model_cache}, "
          f"repeat={f2.model_cache}; predictions {np.round(f2.predictions, 2)}")

    # 6. delta ingest: stream a signal in bands, then replace ONE band —
    # only the changed rows cross the wire, the server patches its SAT and
    # recompresses just the dirty merge-reduce buckets, and the previously
    # cached coreset is re-cached under the new version
    for i in range(0, 128, 32):
        client.ingest("stream", y[i:i + 32])
    client.build("stream", k=8, eps=0.3)
    d = client.ingest_delta("stream", y[:32] * 0.5, row0=32)
    print(f"delta {d.mode} of rows [{d.row0}, {d.row0 + d.rows}): "
          f"{d.buckets_recompressed} bucket(s) recompressed, "
          f"{d.entries_recached} cache entr{'y' if d.entries_recached == 1 else 'ies'} "
          f"re-cached at version {d.version[:10]}…")
    b2 = client.build("stream", k=8, eps=0.3)
    print(f"post-delta build served_from={b2.served_from} (no rebuild)")

    # 7. structured errors: typed envelope, not a stack trace
    try:
        client.query_loss("no-such-signal", seg.rects, seg.labels, eps=0.3)
    except CoresetAPIError as exc:
        print(f"expected error: http={exc.http} code={exc.code}")

    srv.shutdown()
    srv.server_close()
    engine.close()


if __name__ == "__main__":
    main()
