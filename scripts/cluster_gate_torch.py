#!/usr/bin/env python
"""The distributed serving plane of ``repro_torch``, end to end.

    python3 scripts/cluster_gate_torch.py                  # on the card
    REPRO_TORCH_OPS_BACKEND=numpy python3 scripts/cluster_gate_torch.py

Boots the cluster the way an operator would: 1 coordinator and 3 workers
as separate processes of ``python -m repro_torch.launch.serve_coresets
--role ...``, drives the coordinator's v1 API through the typed SDK at the
96 x 64 signals of the reference's ``scripts/cluster_gate.py``, and checks
the same three invariants:

  * parity: a coreset gathered from 3 remote band builds is fingerprint-
    equal to the single-host thread-pool build of a ``CoresetEngine`` in
    this process, and every loss answer is within 1e-9 of its answer;
  * degrade: with a worker killed, requests keep answering 200, the
    composed coreset keeps the same fingerprint (the coordinator builds
    the orphaned band locally with the same tolerance), and only
    ``cluster.degraded_builds`` moves;
  * rejoin: an empty worker restarted on the same port rejoins through the
    no_band heal, with no new degraded build and ``cluster.worker_rejoins``
    ticking.

Every process runs its ops where selection puts them: unpinned on the card
(each role's boot line must say ``ops on ['cuda']``), or on the CPU under
``REPRO_TORCH_OPS_BACKEND=numpy|torch``, which every process inherits.
With neither a card nor a pin it exits 2 and starts nothing.  The role
processes share this script's process group and are stopped in ``finally``
(also on SIGTERM).  Exit code 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

N, M, K, EPS = 96, 64, 6, 0.3
_URL_RE = re.compile(r"listening on (http://[\d.]+:\d+)")
_OPS_RE = re.compile(r"ops on (\[[^\]]*\])")


class _Proc:
    """A serve_coresets role process plus a drain thread over its output."""

    def __init__(self, role_args: list[str]):
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_coresets",
             *role_args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        self.lines: list[str] = []
        self.url: str | None = None
        self.ops: str | None = None
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)
            m = _URL_RE.search(line)
            if m and self.url is None:
                ops = _OPS_RE.search(line)
                self.ops = ops.group(1) if ops else None
                self.url = m.group(1)

    def wait_url(self, timeout: float = 300.0) -> str:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            if self.url:
                return self.url
            if self.proc.poll() is not None:
                break
            time.sleep(0.02)
        raise RuntimeError("role process never reported its URL:\n"
                           + "".join(self.lines))

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def _port(url: str) -> int:
    return int(url.rsplit(":", 1)[1])


def _parity(client, single, name: str, y: np.ndarray, errors: list[str], *,
            queries: int = 4) -> None:
    """Register + build + query ``name`` on both planes; any fingerprint or
    loss divergence is appended to ``errors``."""
    from repro_torch.core.segmentation import random_tree_segmentation
    client.register_signal(name, values=y)
    single.register_signal(name, y)
    rb = client.build(name, K, EPS)
    cs, _, _ = single.get_coreset(name, K, EPS)
    if rb.fingerprint != cs.fingerprint():
        errors.append(f"{name}: cluster fingerprint {rb.fingerprint[:12]} != "
                      f"single-host {cs.fingerprint()[:12]}")
    rng = np.random.default_rng(sum(name.encode()))
    for _ in range(queries):
        q = random_tree_segmentation(N, M, K, rng)
        rc = client.query_loss(name, q.rects, q.labels, eps=EPS)
        ls = single.tree_loss(name, q.rects, q.labels, eps=EPS)["loss"]
        if abs(rc.loss - ls) > 1e-9:
            errors.append(f"{name}: loss off single-host by "
                          f"{abs(rc.loss - ls):.2e} > 1e-9")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reprobe", type=float, default=0.5,
                    help="coordinator down-worker cooldown seconds")
    ap.add_argument("--rpc-timeout", type=float, default=15.0)
    args = ap.parse_args()

    from repro_torch.launch.serve_coresets import require_backends
    try:
        backends = sorted(set(require_backends().values()))
    except RuntimeError as exc:
        print(f"cluster_gate_torch: {exc}; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.client import CoresetClient
    from repro_torch.data.signals import piecewise_signal
    from repro_torch.service import CoresetEngine

    # SIGTERM unwinds through finally, so the role processes stop too
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    procs: list[_Proc] = []
    single = CoresetEngine(num_bands=3, workers=4)
    errors: list[str] = []
    try:
        workers = [_Proc(["--role", "worker", "--host", "127.0.0.1",
                          "--port", "0", "--worker-id", f"gate-w{i}"])
                   for i in range(3)]
        procs += workers
        peer_urls = [w.wait_url() for w in workers]
        coord = _Proc(["--role", "coordinator", "--host", "127.0.0.1",
                       "--port", "0", "--peers", ",".join(peer_urls),
                       "--reprobe-s", str(args.reprobe),
                       "--rpc-timeout", str(args.rpc_timeout)])
        procs.append(coord)
        base = coord.wait_url()
        for p in procs:
            if p.ops != str(backends):
                errors.append(f"a role process dispatches to {p.ops}, this "
                              f"process to {backends}")
        client = CoresetClient(base, retries=0)
        print(f"[cluster_gate_torch] coordinator {base}, workers "
              f"{[_port(u) for u in peer_urls]}, ops on {backends}",
              flush=True)

        # ---- healthy plane: fingerprint + 1e-9 loss parity
        _parity(client, single, "sig", piecewise_signal(N, M, K, seed=7),
                errors)
        st = client.stats()["cluster"]
        if st["degraded_builds"] != 0:
            errors.append(f"healthy build degraded {st['degraded_builds']}x")
        if [p["up"] for p in st["peers"]] != [True] * 3:
            errors.append(f"healthy plane reports down peers: {st['peers']}")
        print(f"[cluster_gate_torch] healthy: fingerprint parity, "
              f"gathers={st['gathers']} degraded={st['degraded_builds']}",
              flush=True)

        # ---- kill a worker: degrade, never 5xx, identical bytes
        victim = workers[1]
        victim_port = _port(peer_urls[1])
        victim.kill()
        _parity(client, single, "sig-degraded",
                piecewise_signal(N, M, K, seed=8), errors, queries=6)
        st = client.stats()["cluster"]
        degraded = st["degraded_builds"]
        if degraded < 1:
            errors.append("worker killed but no degraded build recorded")
        if all(p["up"] for p in st["peers"]):
            errors.append("killed worker still reported up")
        print(f"[cluster_gate_torch] degraded: parity survives worker kill "
              f"(degraded_builds={degraded}, all requests 200)", flush=True)

        # ---- rejoin: empty worker on the SAME port heals via re-assign
        fresh = _Proc(["--role", "worker", "--host", "127.0.0.1",
                       "--port", str(victim_port), "--worker-id", "gate-w1b"])
        procs.append(fresh)
        fresh.wait_url()
        time.sleep(args.reprobe + 0.2)   # let the cooldown lapse
        _parity(client, single, "sig-rejoin",
                piecewise_signal(N, M, K, seed=9), errors)
        st = client.stats()["cluster"]
        if st["degraded_builds"] != degraded:
            errors.append(f"rejoin still degraded: {st['degraded_builds']} "
                          f"builds vs {degraded} before restart")
        if st["worker_rejoins"] < 1:
            errors.append("restarted worker never marked rejoined")
        if not all(p["up"] for p in st["peers"]):
            errors.append(f"rejoined plane reports down peers: {st['peers']}")
        print(f"[cluster_gate_torch] rejoin: worker back on :{victim_port}, "
              f"rejoins={st['worker_rejoins']}, degraded stayed {degraded}",
              flush=True)
    except Exception as exc:  # noqa: BLE001 - reported, then failed
        errors.append(f"{type(exc).__name__}: {exc}")
    finally:
        for p in procs:
            p.kill()
        single.close()

    for e in errors:
        print(f"[cluster_gate_torch] FAIL: {e}")
    print(f"[cluster_gate_torch] {'PASS' if not errors else 'FAIL'}")
    return 0 if not errors else 1


if __name__ == "__main__":
    sys.exit(main())
