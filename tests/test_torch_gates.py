"""The server's gates in ``repro_torch`` (``scripts/*_gate_torch.py``) against
the reference's (``scripts/*_gate.py``): the coalesce, trace and stream gates
pass pinned on numpy as the reference's do (the stream gate printing the
reference's fingerprint and chunks), all four refuse to start without a card
or a pin, and each keeps its reference's constants, argparse defaults and
numeric bars.  The overload gate's timed run is held on the card only
(chip_smoke.py's coreset_gates and ten standalone runs); here, untimed: its
tenants' loops run in spawned processes that report every tenant's counts
and are all gone when the gate exits, a gate whose admission admits
everything fails on the hot tenant's share (the negative control), and the
port's server holds a rate refusal's 503 asleep, min(n x Retry-After, cap)
for the n-th held at once, with at most RATE_REFUSAL_MAX_HELD_PER_TENANT of
a tenant's and RATE_REFUSAL_MAX_HELD in all held, the rest answered at once."""
import ast
import collections
import concurrent.futures
import os
import pathlib
import re
import signal
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
GATES = ("coalesce", "trace", "stream", "overload")
TIMEOUT_S = 240


def _env(tmp_path, reference: bool, pin: str | None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_OPS_BACKEND",
                        "REPRO_TORCH_OPS_BACKEND")}
    env["PYTHONPATH"] = str(ROOT / "src")
    if reference:
        env.update(JAX_PLATFORMS="cpu", REPRO_AUTOTUNE_CACHE=str(tmp_path / "ref.json"))
        if pin:
            env["REPRO_OPS_BACKEND"] = pin
    else:
        env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "port.json")
        if pin:
            env["REPRO_TORCH_OPS_BACKEND"] = pin
    return env


def _start(script: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, f"scripts/{script}"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _finish(procs: list) -> list[tuple[int, str, str]]:
    """Each process's (returncode, stdout, stderr); every one still running
    at the end is killed with its session."""
    try:
        results = []
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            results.append((p.returncode, out, err))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()


@pytest.mark.parametrize("gate", ["coalesce", "trace", "stream"])
def test_gate_passes_pinned_on_numpy_as_the_reference_does(gate, tmp_path):
    (rc, out, err), (ref_rc, ref_out, ref_err) = _finish([
        _start(f"{gate}_gate_torch.py", _env(tmp_path, False, "numpy")),
        _start(f"{gate}_gate.py", _env(tmp_path, True, "numpy"))])
    assert rc == 0, out + err
    assert out.strip().splitlines()[-1] == f"[{gate}_gate_torch] PASS"
    assert ref_rc == 0, ref_out + ref_err
    assert ref_out.strip().splitlines()[-1] == f"[{gate}_gate] PASS"
    if gate == "stream":    # deterministic: the re-anchored fingerprint, chunks
        assert out.replace("_gate_torch]", "_gate]") == ref_out


@pytest.mark.parametrize("gate", GATES)
def test_gate_refuses_without_a_card_or_a_pin(gate, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the gate would run on it")
    ((rc, out, err),) = _finish([_start(f"{gate}_gate_torch.py",
                                        _env(tmp_path, False, None))])
    assert rc == 2 and out == ""
    assert "no CUDA device" in err and "nothing was run" in err


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _constants(tree: ast.Module) -> dict:
    """The module's upper-case names bound to literals."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                names = ([target] if isinstance(target, ast.Name)
                         else getattr(target, "elts", []))
                values = ([node.value] if isinstance(target, ast.Name)
                          else getattr(node.value, "elts", []))
                for n, v in zip(names, values):
                    if isinstance(n, ast.Name) and n.id.isupper():
                        try:
                            out[n.id] = ast.literal_eval(v)
                        except ValueError:
                            pass
    return out


def _defaults(tree: ast.Module) -> dict:
    """Each ``add_argument`` flag's keywords (default, type, action)."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = ast.literal_eval(node.args[0])
            out[flag] = {k.arg: ast.unparse(k.value) for k in node.keywords
                         if k.arg in ("default", "type", "action")}
    return out


def _numbers(tree: ast.Module) -> collections.Counter:
    """Every numeric literal in the code (docstrings aside): the bars,
    counts and sizes the checks use."""
    return collections.Counter(
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and type(node.value) in (int, float))


@pytest.mark.parametrize("gate", GATES)
def test_gate_keeps_its_reference_constants_defaults_and_bars(gate):
    port = _tree(ROOT / "scripts" / f"{gate}_gate_torch.py")
    ref = _tree(ROOT / "scripts" / f"{gate}_gate.py")
    assert _constants(port) == _constants(ref)
    assert _defaults(port) == _defaults(ref)
    # the port adds only its exit code 2 (no card, no pin) and, in the
    # stream gate, the docstring's first paragraph's index 0
    extra = _numbers(port) - _numbers(ref)
    assert not _numbers(ref) - _numbers(port)
    assert set(extra) <= {0, 2} and extra[2] == 1
    # the port's main takes its argv, so that a caller can run it in-process
    main = next(n for n in port.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    assert [a.arg for a in main.args.args] == ["argv"]


# the gate imported as a module (as chip_smoke.py's coreset_gates does),
# with AdmissionController swapped for one that admits every request
_ADMIT_ALL = textwrap.dedent("""
    import sys
    sys.path[:0] = [{scripts!r}, {src!r}]
    import overload_gate_torch as gate

    class AdmitAll(gate.AdmissionController):
        def __init__(self, config=None, **kwargs):
            config.enabled = False
            super().__init__(config, **kwargs)

    if __name__ == "__main__":
        gate.AdmissionController = AdmitAll
        sys.exit(gate.main(sys.argv[1:]))
""")
_TENANT_LINE = re.compile(r"\] +(\w+): ok=(\d+) rejected=(\d+) expired_504=(\d+) "
                          r"errors=(\d+) p95=")


def _run_gate(argv, env, runner=None) -> tuple[int, str, str]:
    """The overload gate (or ``runner``) in a session of its own; once it
    has exited, none of the processes it started may be left in that
    session's group."""
    cmd = [sys.executable, str(runner) if runner else "scripts/overload_gate_torch.py", *argv]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
        deadline = time.monotonic() + 10
        while True:     # multiprocessing's resource tracker ends on its own
            try:
                os.killpg(proc.pid, 0)
            except ProcessLookupError:
                break
            assert time.monotonic() < deadline, "the gate left processes running"
            time.sleep(0.1)
        return proc.returncode, out, err
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.communicate()


def _tenants(out: str) -> dict:
    return {m[0]: tuple(map(int, m[1:])) for m in _TENANT_LINE.findall(out)}


def test_overload_gate_tenants_report_from_their_own_processes(monkeypatch):
    """The gate's harness against a server pinned on numpy: one spawned
    process a tenant (none of them this one), each ready before its phase,
    each tenant's counts sent back through its pipe, and every process
    gone once the tenants are stopped."""
    import multiprocessing

    import numpy as np
    from repro_torch import ops
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import overload_gate_torch as gate
    eng = gate.CoresetEngine(workers=2)
    srv = gate.make_server(eng)
    gate.serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    tenants = {}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        with ops.backend_override("numpy"):
            setup = gate.CoresetClient(base)
            setup.register_signal("sig", values=gate.piecewise_signal(
                gate.N, gate.M, gate.KMAX, noise=0.15, seed=7))
            setup.build("sig", gate.KMAX, 0.2)
            segs = [gate.random_tree_segmentation(gate.N, gate.M, 6,
                                                  np.random.default_rng(1))]
            tenants = pool.submit(gate.start_tenants, base, ["hot", "cold1"],
                                  segs).result(timeout=TIMEOUT_S)
            pids = {name: proc.pid for name, (proc, _) in tenants.items()}
            assert all(proc.is_alive() for proc, _ in tenants.values())
            assert len(set(pids.values()) | {os.getpid()}) == 3
            stats = pool.submit(gate.run_tenants, tenants, {
                "hot": [None] * 2, "cold1": [0.05]}, 0.5).result(timeout=TIMEOUT_S)
    finally:
        gate.stop_tenants(tenants)     # a run still waiting on a pipe ends here
        pool.shutdown(wait=False)
        srv.shutdown()
        srv.server_close()
        eng.close()
    assert sorted(stats) == ["cold1", "hot"]
    for name, st in stats.items():
        assert isinstance(st, gate.TenantStats) and st.name == name
        assert st.ok > 0 and st.ok == len(st.latencies) and not (st.errors or st.expired)
    assert not any(proc.is_alive() for proc, _ in tenants.values())
    assert not multiprocessing.active_children()


def test_overload_gate_runs_short_and_leaves_no_process(tmp_path):
    """The gate end to end in a short run pinned on numpy: every tenant's
    line has its counts, the hot tenant was pushed back, and nothing the
    gate started outlives it."""
    rc, out, err = _run_gate(["--duration", "1.0", "--baseline", "0.5"],
                             _env(tmp_path, False, "numpy"))
    assert rc in (0, 1), out + err
    assert "Traceback" not in err, err
    base = re.search(r"baseline: capacity=(\d+) rps .*\(n=(\d+)\)", out)
    assert base and int(base[2]) > 0, out
    tenants = _tenants(out)
    assert set(tenants) == {"hot", "cold1", "cold2"}, out
    assert all(t[0] > 0 for t in tenants.values()) and tenants["hot"][1] > 0, out


def test_overload_gate_fails_on_the_hot_share_when_admission_admits_everything(tmp_path):
    """The negative control: with AdmissionController admitting every
    request, the hot tenant takes far more than its share's +-20 % band,
    is never refused, and the gate ends in FAIL naming its share."""
    runner = tmp_path / "admit_all.py"
    runner.write_text(_ADMIT_ALL.format(scripts=str(ROOT / "scripts"), src=str(ROOT / "src")))
    rc, out, err = _run_gate([], _env(tmp_path, False, "numpy"), runner)
    assert rc == 1, out + err
    lines = out.strip().splitlines()
    assert lines[-1] == "[overload_gate_torch] FAIL", out
    assert any(re.match(r"\[overload_gate_torch\] FAIL: hot tenant admitted \d+ rps, "
                        r"outside \[\d+, \d+\] \(share \d+ \+-20%\)", ln)
               for ln in lines), out
    assert any("hot tenant was never pushed back" in ln for ln in lines), out
    assert _tenants(out)["hot"][1] == 0, out


def test_a_rate_refusal_is_answered_after_its_retry_after_asleep():
    """The port's server holds a tenant_rate refusal's 503 for
    min(n x Retry-After, RATE_REFUSAL_HOLD_S), n = 1 here, its handler thread
    asleep: the request takes at least that long, and the process spends
    little CPU over it (a handler that waited holding the interpreter would
    spend about all of it)."""
    import numpy as np
    from repro_torch.client import AdmissionRejectedError, CoresetClient
    from repro_torch.service import (AdmissionConfig, AdmissionController, CoresetEngine,
                                     api, make_server, serve_forever_in_thread)
    ctl = AdmissionController(AdmissionConfig(tenants={"t": 1.0}, rate_rps=4.0,
                                              burst_s=0.0, deadline_guard=False))
    eng = CoresetEngine(workers=1, admission=ctl)
    srv = make_server(eng)
    serve_forever_in_thread(srv)
    try:
        cl = CoresetClient(f"http://127.0.0.1:{srv.server_address[1]}", tenant="t",
                           retries=0)
        y = np.arange(64.0).reshape(8, 8)
        cl.register_signal("a", values=y)                # the bucket's one token
        t0, cpu0 = time.perf_counter(), time.process_time()
        with pytest.raises(AdmissionRejectedError) as exc:
            cl.register_signal("b", values=y)
        wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()
    hold = min(exc.value.retry_after, api.RATE_REFUSAL_HOLD_S)
    assert exc.value.retry_after > 0.1
    assert wall >= hold - 1e-3, (wall, hold)
    assert cpu < 0.25 * hold, (cpu, hold)
    assert ctl.snapshot()["rejected_total"] == 1


@pytest.mark.parametrize("tenants,per_tenant,total,held", [
    (("t",), 8, 32, 8),            # one tenant at its own bound
    (("a", "b"), 8, 5, 5),         # two tenants at the server's bound
])
def test_held_rate_refusals_are_bounded_and_the_rest_answered_at_once(
        monkeypatch, tenants, per_tenant, total, held):
    """Many concurrent rate refusals, sent without waiting (open loop):
    at most RATE_REFUSAL_MAX_HELD_PER_TENANT of a tenant's and
    RATE_REFUSAL_MAX_HELD in all are held at once; every other one is
    answered at once, long before a hold ends, and then only the held
    ones' handler threads are left alive."""
    import threading

    import numpy as np
    from repro_torch.client import AdmissionRejectedError, CoresetClient
    from repro_torch.service import (AdmissionConfig, AdmissionController, CoresetEngine,
                                     api, make_server, serve_forever_in_thread)
    hold_s, n_each = 3.0, 12
    monkeypatch.setattr(api, "RATE_REFUSAL_HOLD_S", hold_s)
    monkeypatch.setattr(api, "RATE_REFUSAL_MAX_HELD_PER_TENANT", per_tenant)
    monkeypatch.setattr(api, "RATE_REFUSAL_MAX_HELD", total)
    # a token each 4 s: every held refusal sleeps the whole hold_s
    ctl = AdmissionController(AdmissionConfig(
        tenants={t: 1.0 for t in tenants}, rate_rps=0.25 * len(tenants), burst_s=0.0,
        deadline_guard=False))
    eng = CoresetEngine(workers=1, admission=ctl)
    srv = make_server(eng)
    serve_forever_in_thread(srv)
    holds, samples, stop = srv.refusal_holds, [], threading.Event()

    def handlers() -> int:
        return sum("process_request_thread" in t.name for t in threading.enumerate())

    def sample():
        while not stop.is_set():
            samples.append((holds._total, max(holds._held.values(), default=0)))
            time.sleep(0.002)
    sampler = threading.Thread(target=sample)
    pool = concurrent.futures.ThreadPoolExecutor(len(tenants) * n_each)
    y = np.arange(64.0).reshape(8, 8)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def refused(tenant: str, name: str):
        with pytest.raises(AdmissionRejectedError) as exc:
            CoresetClient(base, tenant=tenant, retries=0).register_signal(name, values=y)
        return exc.value.reason

    try:
        for t in tenants:                                # each bucket's one token
            CoresetClient(base, tenant=t, retries=0).register_signal(f"{t}-0", values=y)
        sampler.start()
        t0 = time.perf_counter()
        futs = [pool.submit(refused, t, f"{t}-{i + 1}") for t in tenants
                for i in range(n_each)]
        n_fast = len(futs) - held
        while sum(f.done() for f in futs) < n_fast and time.perf_counter() - t0 < hold_s:
            time.sleep(0.005)
        fast_s, alive = time.perf_counter() - t0, handlers()
        reasons = [f.result(timeout=TIMEOUT_S) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        if sampler.is_alive():
            sampler.join()
        pool.shutdown(wait=False)
        srv.shutdown()
        srv.server_close()
        eng.close()
    assert reasons == ["tenant_rate"] * len(futs)
    assert fast_s < hold_s - 1.0, fast_s             # the rest answered at once
    assert alive <= held + 2, alive                   # threads asleep: the held ones
    assert wall >= hold_s, wall                       # those were held the whole hold
    assert max(s[0] for s in samples) == held
    assert max(s[1] for s in samples) <= per_tenant
    assert ctl.snapshot()["rejected_total"] == len(futs)
