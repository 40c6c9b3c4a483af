#!/usr/bin/env python
"""Where the overload gate's process spends its CPU.

    REPRO_TORCH_OPS_BACKEND=numpy python3 scripts/overload_cpu_split_torch.py [--runs 10]

Runs ``scripts/overload_gate_torch.py``'s ``main(argv)`` (at its defaults,
or with the arguments left over) ``--runs`` times in this process, each
request's handler timed by its thread's CPU clock and summed by the status
it answered (503 a refusal, 200 an admitted request).  One JSON line a run:
the gate's rc, each status's requests and handler CPU ms a request, the
process's CPU seconds (the handlers, the server, the engine, admission and
any client loops run as threads of it) and its reaped children's (the
tenants' processes), over the run's wall seconds.  Needs a pin or a card,
as the gate does.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import resource
import sys
import threading
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import overload_gate_torch as gate  # noqa: E402
from repro_torch.service import api  # noqa: E402


def instrument(tally: dict, lock: threading.Lock) -> None:
    """Sum each handled request's thread CPU under the status it sent."""
    handler = api._Handler
    send, one = handler.send_response, handler.handle_one_request

    def send_response(self, code, *args, **kwargs):
        self._status = code
        return send(self, code, *args, **kwargs)

    def handle_one_request(self):
        t0, self._status = time.thread_time(), 0
        one(self)
        if self._status:     # a request was read (not a keep-alive's end)
            with lock:
                tally[self._status].append(time.thread_time() - t0)

    handler.send_response, handler.handle_one_request = send_response, handle_one_request


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=10)
    args, gate_argv = ap.parse_known_args(argv)
    tally, lock = collections.defaultdict(list), threading.Lock()
    instrument(tally, lock)
    for run in range(args.runs):
        tally.clear()
        cpu0, kids0 = time.process_time(), resource.getrusage(resource.RUSAGE_CHILDREN)
        wall0 = time.perf_counter()
        rc = gate.main(gate_argv)
        wall = time.perf_counter() - wall0
        kids = resource.getrusage(resource.RUSAGE_CHILDREN)
        print(json.dumps({
            "run": run + 1, "rc": rc, "wall_s": wall,
            "process_cpu_s": time.process_time() - cpu0,
            "children_cpu_s": (kids.ru_utime + kids.ru_stime
                               - kids0.ru_utime - kids0.ru_stime),
            "handler": {str(code): {"requests": len(s), "cpu_ms": 1e3 * sum(s) / len(s)}
                        for code, s in sorted(tally.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
