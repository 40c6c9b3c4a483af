"""repro_torch.runtime (heartbeats, straggler detection, crash-only
supervision) against repro.runtime.fault_tolerance on the same report
sequences and the same failing steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import fault_tolerance as ref_ft  # noqa: E402
from repro_torch import runtime  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402


def test_runtime_exports_only_the_fault_tolerance_names():
    """The reference's names: its fault tolerance and its elastic
    re-meshing."""
    from repro import runtime as ref_runtime
    assert runtime.__all__ == ref_runtime.__all__


def _reports(seed):
    """A report sequence: 5 workers, one that goes silent and one that
    lags, at irregular times."""
    rng = np.random.default_rng(seed)
    out, t = [], 1000.0
    for step in range(12):
        for w in range(5):
            if w == 4 and step >= 4:
                continue                       # w4 dies
            s = step - 6 if (w == 3 and step >= 6) else step   # w3 limps
            t += float(rng.uniform(0.2, 1.5))
            out.append((f"w{w}", s, t))
    return out, t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("deadline_s,lag_factor", [(10.0, 3.0), (4.0, 2.0), (60.0, 1.0)])
def test_heartbeat_monitor_checks_as_the_reference(seed, deadline_s, lag_factor):
    reports, t = _reports(seed)
    ref = ref_ft.HeartbeatMonitor(deadline_s=deadline_s, lag_factor=lag_factor)
    port = runtime.HeartbeatMonitor(deadline_s=deadline_s, lag_factor=lag_factor)
    for i, (w, s, now) in enumerate(reports):
        ref.report(w, s, now=now)
        port.report(w, s, now=now)
        if i % 7 == 0:
            assert port.check(now=now + 1.0) == ref.check(now=now + 1.0)
    for dt in (0.0, 3.0, 8.0, 30.0, 100.0):
        assert port.check(now=t + dt) == ref.check(now=t + dt)
    assert port.median_step_s() == ref.median_step_s()
    assert {k: (v.step, v.last_seen) for k, v in port.workers.items()} == \
        {k: (v.step, v.last_seen) for k, v in ref.workers.items()}
    out = port.check(now=t + 5.0)
    assert "w4" in out["failed"] or "w4" in out["stragglers"]


def _run(fail_at, tmp_path, **kw):
    """Sum a step-indexed sequence under supervise, failing once at each
    step in ``fail_at``; the log and the final state."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    failed = set()
    log = []

    def run_step(step, state):
        if step in fail_at and step not in failed:
            failed.add(step)
            raise RuntimeError(f"boom {step}")
        return {"acc": state["acc"] + torch.tensor(float(step) ** 2), "step": step}
    state = runtime.supervise(run_step, {"acc": torch.tensor(0.0), "step": 0},
                              steps=10, ckpt_mgr=mgr, log=log.append, **kw)
    return state, log, mgr


def test_supervise_replays_from_the_last_checkpoint(tmp_path):
    clean, log, _ = _run(set(), tmp_path / "clean", save_every=3)
    assert log == [] and float(clean["acc"]) == sum(s * s for s in range(10))
    crashy, log, mgr = _run({4, 7}, tmp_path / "crash", save_every=3)
    assert torch.equal(crashy["acc"], clean["acc"]) and crashy["step"] == 10
    assert [line.split(" failed")[0] for line in log] == ["[ft] step 4", "[ft] step 7"]
    assert log[0].endswith("restart 1/3 from checkpoint 3")
    assert log[1].endswith("restart 2/3 from checkpoint 6")
    assert mgr.all_steps() == [6, 9, 10]


def test_supervise_raises_before_the_first_checkpoint(tmp_path):
    with pytest.raises(RuntimeError, match="before the first committed checkpoint"):
        _run({2}, tmp_path, save_every=5)


def test_supervise_stops_at_max_restarts(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    calls = []

    def run_step(step, state):
        calls.append(step)
        if step == 3:
            raise ValueError("always")
        return {"x": state["x"] + 1, "step": step}
    with pytest.raises(ValueError, match="always"):
        runtime.supervise(run_step, {"x": torch.tensor(0), "step": 0}, steps=6,
                          ckpt_mgr=mgr, save_every=2, max_restarts=2,
                          log=lambda s: None)
    assert calls == [0, 1, 2, 3, 2, 3, 2, 3]
