"""Fault tolerance: heartbeats, straggler detection, crash-only supervision.

At 1000+ nodes the failure model is: nodes die (no heartbeat), nodes limp
(straggler: heartbeats arrive but step progress lags the fleet), and
transient step failures.  Policy implemented here:

  * ``HeartbeatMonitor``: workers report (step, t); a worker is FAILED after
    ``deadline_s`` of silence, and a STRAGGLER when its step lags the fleet
    median by ``lag_factor`` x the median step duration.
  * ``supervise``: crash-only training driver — on any step exception the
    loop restores the last committed checkpoint and replays (the data
    pipeline is step-indexed, so replays are bit-identical); after
    ``max_restarts`` it re-raises.
  * Failure injection hooks for tests.

A copy of the reference's ``runtime/fault_tolerance.py`` (pure Python, so
the port keeps its own).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = ["HeartbeatMonitor", "WorkerState", "supervise"]


@dataclasses.dataclass
class WorkerState:
    step: int = -1
    last_seen: float = 0.0


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 60.0, lag_factor: float = 3.0):
        self.deadline_s = deadline_s
        self.lag_factor = lag_factor
        self.workers: dict[str, WorkerState] = {}
        self._step_times: list[float] = []
        self._last_step_t: float | None = None

    def report(self, worker: str, step: int, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        st = self.workers.setdefault(worker, WorkerState())
        if st.step >= 0 and step > st.step and self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
            self._step_times = self._step_times[-64:]
        st.step, st.last_seen = step, now
        self._last_step_t = now

    def median_step_s(self) -> float:
        if not self._step_times:
            return 0.0
        s = sorted(self._step_times)
        return s[len(s) // 2]

    def check(self, now: float | None = None) -> dict[str, list[str]]:
        now = time.monotonic() if now is None else now
        failed, stragglers = [], []
        steps = sorted(st.step for st in self.workers.values())
        med_step = steps[len(steps) // 2] if steps else 0
        med_t = self.median_step_s()
        for name, st in self.workers.items():
            if now - st.last_seen > self.deadline_s:
                failed.append(name)
            elif med_t > 0 and (med_step - st.step) * med_t > self.lag_factor * med_t \
                    and med_step - st.step >= self.lag_factor:
                stragglers.append(name)
        return {"failed": sorted(failed), "stragglers": sorted(stragglers)}


def supervise(run_step: Callable[[int, dict], dict], state: dict, *,
              steps: int, ckpt_mgr, save_every: int = 50,
              max_restarts: int = 3, on_restore=None,
              log: Callable[[str], None] = print) -> dict:
    """Crash-only loop: run_step(step, state) -> state; restores the last
    committed checkpoint on failure (state must be checkpoint-round-trip
    clean; the data pipeline must be step-indexed)."""
    start = state.get("step", 0)
    restarts = 0
    step = start
    while step < steps:
        try:
            state = run_step(step, state)
            state["step"] = step + 1
            if (step + 1) % save_every == 0 or step + 1 == steps:
                ckpt_mgr.save(step + 1, state)
            step += 1
        except Exception as e:  # noqa: BLE001 — crash-only: restore & replay
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt_mgr.wait()            # commit any in-flight save first
            last = ckpt_mgr.latest_step()
            log(f"[ft] step {step} failed ({e!r}); restart {restarts}/"
                f"{max_restarts} from checkpoint {last}")
            if last is None:
                raise RuntimeError(
                    "failure before the first committed checkpoint — "
                    "lower save_every or re-submit the job") from e
            state = ckpt_mgr.restore(last, state)
            if on_restore is not None:
                state = on_restore(state)
            step = int(state.get("step", last))
            state["step"] = step
    ckpt_mgr.wait()
    return state
