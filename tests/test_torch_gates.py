"""The server's gates in ``repro_torch`` (``scripts/*_gate_torch.py``) against
the reference's (``scripts/*_gate.py``): the coalesce, trace and stream gates
pass pinned on numpy as the reference's do (the stream gate printing the
reference's fingerprint and chunks), all four refuse to start without a card
or a pin, and each keeps its reference's constants, argparse defaults and
numeric bars.  The overload gate's timed run is held on the card only
(chip_smoke.py's coreset_gates): its cold-p95 bar fails about one run in
three, on the CPU as on the card, and the reference's gate's too."""
import ast
import collections
import os
import pathlib
import signal
import subprocess
import sys

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
