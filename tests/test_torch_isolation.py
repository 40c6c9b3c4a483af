"""repro_torch stands alone: it imports neither jax nor the reference
package, at run time (a fresh interpreter running the CPU slices: a
build, a loss query and a tune_k sweep) or anywhere in its source and in
chip_smoke.py."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")

_SLICE = """
import json, sys
import numpy as np
import repro_torch
from repro_torch import ops
from repro_torch.core import random_tree_segmentation, signal_coreset
from repro_torch.data import patch_mask, piecewise_signal, sensor_matrix
from repro_torch.trees import tune_k
with ops.backend_override("numpy"):
    cs = signal_coreset(piecewise_signal(64, 64, 4, seed=0), 4, 0.3)
    seg = random_tree_segmentation(64, 64, 5, np.random.default_rng(1))
    loss = ops.fitting_loss(cs, seg.rects, seg.labels)
y = sensor_matrix(120, 15, seed=0)
train, test = patch_mask(*y.shape, 0.3, 5, seed=1)
res = tune_k(y, train, test, ks=[4, 8], coreset_k=8, n_estimators=2,
             hist_backend="numpy")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loss": loss, "blocks": cs.num_blocks, "bad": bad,
                  "best_k": res.best_k}))
"""


def test_cpu_slice_runs_without_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _SLICE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["blocks"] > 0 and res["loss"] > 0
    assert set(res["best_k"]) == {"full", "coreset", "uniform"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert bad == []
