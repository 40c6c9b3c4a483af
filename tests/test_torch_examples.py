"""The paper's examples in ``repro_torch`` (``examples/*_torch.py``) against
the reference's (``examples/*.py``): pinned on numpy, each prints what the
reference's prints, line for line, its seconds and speed-ups masked (the
mask is chip_smoke.py's, which holds the same examples on the card to their
numpy runs); unpinned without a card each raises the port's "no CUDA
device" error before it prints anything."""
import os
import pathlib
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import mask_timings  # noqa: E402

EXAMPLES = ("quickstart", "image_compression", "automl_tuning",
            "client_quickstart")
TIMEOUT_S = 240


def _start(script: str, tmp_path, reference: bool, pin: str | None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_OPS_BACKEND",
                        "REPRO_TORCH_OPS_BACKEND")}
    env["PYTHONPATH"] = str(ROOT / "src")
    if reference:
        env.update(JAX_PLATFORMS="cpu", REPRO_OPS_BACKEND=pin,
                   REPRO_AUTOTUNE_CACHE=str(tmp_path / "ref.json"))
    else:
        env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "port.json")
        if pin:
            env["REPRO_TORCH_OPS_BACKEND"] = pin
    return subprocess.Popen([sys.executable, f"examples/{script}"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish(procs):
    """Each process's (returncode, stdout, stderr); every one is killed
    if it is still running at the end."""
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


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_the_reference_prints_pinned_on_numpy(name, tmp_path):
    (rc, out, err), (ref_rc, ref_out, ref_err) = _finish([
        _start(f"{name}_torch.py", tmp_path, False, "numpy"),
        _start(f"{name}.py", tmp_path, True, "numpy")])
    assert rc == 0, err[-3000:]
    assert ref_rc == 0, ref_err[-3000:]
    assert out.strip()
    assert mask_timings(out).splitlines() == mask_timings(ref_out).splitlines()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card_or_a_pin(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the example would run on it")
    ((rc, out, err),) = _finish([_start(f"{name}_torch.py", tmp_path, False, None)])
    assert rc == 1 and out == ""
    assert "RuntimeError: no CUDA device" in err and "pin backend=" in err


def test_timing_mask_hides_only_seconds_and_speedups():
    text = ("coreset: 1296 weighted points (1.08% of the 120000 cells), built in 0.45s\n"
            "full            41996     256     3033.4     2.16\n"
            "speedup of the tuning sweep (incl. one-off compression): x0.9\n"
            "k=   16: loss via coreset   118837.5 | true   118286.6 | PSNR  14.7 dB\n")
    assert mask_timings(text).splitlines() == [
        "coreset: 1296 weighted points (1.08% of the 120000 cells), built in <s>",
        "full            41996     256     3033.4 <s>",
        "speedup of the tuning sweep (incl. one-off compression): x<speedup>",
        "k=   16: loss via coreset   118837.5 | true   118286.6 | PSNR  14.7 dB"]
