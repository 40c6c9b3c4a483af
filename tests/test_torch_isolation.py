"""repro_torch stands alone: it imports neither jax nor the reference
package, at run time (a fresh interpreter running the CPU slices: a
build, a loss query, a tune_k sweep, a row patch, a stream with a band
replacement, a band-parallel build, and a reduced qwen2 prefill and greedy
generation pinned to the plain attention) or anywhere in its source and in
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
from repro_torch.core import (PrefixStats, StreamingBuilder,
                              random_tree_segmentation, sharded_coreset,
                              signal_coreset)
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
with ops.backend_override("numpy"):
    z = piecewise_signal(48, 16, 3, seed=2)
    ps = PrefixStats.build(z[:40]).append_rows(z[40:])
    z[8:16] = 0.0
    patched = np.array_equal(ps.patch_rows(8, z[8:]).p2, PrefixStats.build(z).p2)
    sb = StreamingBuilder(m=16, k=3, eps=0.3)
    for i in range(0, 48, 12):
        sb.insert_band(z[i:i + 12])
    sb.replace_band(1, z[12:24] + 1.0)
    streamed = sb.result().num_blocks
    sharded = sharded_coreset(z, 3, 0.3, 3, recompress_result=True).num_blocks
    write_ops = sorted({o for o, _ in ops.dispatch_counts()})
import torch
from repro_torch.configs import get_arch, reduced_config
from repro_torch.launch.serve import generate
from repro_torch.models import init_params, prefill
lm = reduced_config(get_arch("qwen2-0.5b"))
lm_params = init_params(lm, torch.Generator().manual_seed(0))
prompts = np.random.default_rng(3).integers(0, lm.vocab, size=(2, 5)).astype(np.int32)
logits, _ = prefill(lm, lm_params, {"tokens": torch.as_tensor(prompts)},
                    attn_impl="torch")
tokens = generate(lm, lm_params, prompts, 3, greedy=True)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loss": loss, "blocks": cs.num_blocks, "bad": bad,
                  "best_k": res.best_k, "patched": bool(patched),
                  "streamed": streamed, "sharded": sharded,
                  "write_ops": write_ops,
                  "logits": list(logits.shape),
                  "finite": bool(torch.isfinite(logits.float()).all()),
                  "tokens": list(tokens.shape)}))
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
    assert res["patched"] and res["streamed"] > 0 and res["sharded"] > 0
    assert {"delta_sat", "streaming_compress"} <= set(res["write_ops"])
    assert res["logits"] == [2, 5, 512] and res["finite"]
    assert res["tokens"] == [2, 8]


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
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "flash_attention_turns.py"]
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert bad == []


def test_flash_attention_turns_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would time kernels")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "scripts/flash_attention_turns.py"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr
