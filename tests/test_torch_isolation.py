"""repro_torch stands alone: it imports neither jax nor the reference
package, at run time (a fresh interpreter running the CPU slices: a
build, a loss query, a tune_k sweep, a row patch, a stream with a band
replacement, a band-parallel build, a reduced qwen2 prefill and greedy
generation pinned to the plain attention, the same for reduced
falcon-mamba-7b and zamba2-1.2b and for reduced qwen3-moe-235b-a22b and
deepseek-v2-236b (MoE, MLA), a reduced musicgen-medium prefill and decode
step on codebook tokens and a reduced pixtral-12b prefill on patch
embeddings and its greedy generation, the coreset server booted on
an ephemeral port answering a loss query and a batch through the SDK, a
cluster coordinator gathering a build from two in-process workers, a
train step, a compressed gradient, a checkpoint and a crash-and-resume
``train_loop`` on the token stream, and a CPU rank of a one-rank gloo mesh
scoring and scanning over it) or anywhere in its source (train/,
checkpoint/, runtime/, data/tokens.py, launch/train.py, models/ssm.py and
models/moe.py among it), in
chip_smoke.py, in the port's scripts and in its examples.  Importing the
package loads no mesh module and starts no process group."""
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
from repro_torch.models import decode_step, init_cache, init_params, prefill
lm = reduced_config(get_arch("qwen2-0.5b"))
lm_params = init_params(lm, torch.Generator().manual_seed(0))
prompts = np.random.default_rng(3).integers(0, lm.vocab, size=(2, 5)).astype(np.int32)
logits, _ = prefill(lm, lm_params, {"tokens": torch.as_tensor(prompts)},
                    attn_impl="torch")
tokens = generate(lm, lm_params, prompts, 3, greedy=True)
ssm_tokens = []
for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
    sm = reduced_config(get_arch(arch))
    sm_params = init_params(sm, torch.Generator().manual_seed(0))
    sm_logits, _ = prefill(sm, sm_params, {"tokens": torch.as_tensor(prompts)},
                           attn_impl="torch")
    ssm_tokens.append([list(sm_logits.shape),
                       list(generate(sm, sm_params, prompts, 2, greedy=True).shape)])
moe_tokens = []
for arch in ("qwen3-moe-235b-a22b", "deepseek-v2-236b"):
    mm = reduced_config(get_arch(arch))
    mm_params = init_params(mm, torch.Generator().manual_seed(0))
    mm_logits, mm_aux = prefill(mm, mm_params, {"tokens": torch.as_tensor(prompts)},
                                attn_impl="torch")
    moe_tokens.append([list(mm_logits.shape), float(mm_aux) > 0,
                       list(generate(mm, mm_params, prompts, 2, greedy=True).shape)])
frontends = []
for arch in ("musicgen-medium", "pixtral-12b"):
    fm = reduced_config(get_arch(arch))
    fm_params = init_params(fm, torch.Generator().manual_seed(0))
    frng = np.random.default_rng(4)
    if fm.n_codebooks:
        fb = {"tokens": torch.as_tensor(
            frng.integers(0, fm.vocab, size=(2, 5, fm.n_codebooks)))}
    else:
        fb = {"patch_embeds": torch.as_tensor(frng.normal(
                  size=(2, fm.n_patches, fm.d_model))).to(torch.bfloat16),
              "tokens": torch.as_tensor(prompts)}
    fm_logits, _ = prefill(fm, fm_params, fb, attn_impl="torch")
    fm_step, _ = decode_step(fm, fm_params, init_cache(fm, 2, 1),
                             {"tokens": fb["tokens"][:, :1]})
    frontends.append([list(fm_logits.shape), list(fm_step.shape)])
frontends[1].append(list(generate(fm, fm_params, prompts, 2, greedy=True).shape))
from repro_torch.client import CoresetClient
from repro_torch.service import CoresetEngine, make_server, serve_forever_in_thread
with ops.backend_override("numpy"):
    engine = CoresetEngine(workers=2)
    srv = make_server(engine, port=0)
    try:
        serve_forever_in_thread(srv)
        cl = CoresetClient(f"http://127.0.0.1:{srv.server_address[1]}",
                           timeout=60, retries=0)
        cl.register_signal("s", synthetic={"kind": "piecewise", "n": 48,
                                           "m": 32, "k": 4, "seed": 1})
        q = random_tree_segmentation(48, 32, 4, np.random.default_rng(2))
        served = cl.query_loss("s", q.rects, q.labels, eps=0.3)
        batch = cl.query_loss_batch("s", q.rects[None].repeat(3, 0),
                                    q.labels[None].repeat(3, 0), eps=0.3)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
import threading
from repro_torch.cluster import ClusterEngine, ShardWorker, make_worker_server
with ops.backend_override("numpy"):
    wsrv = [make_worker_server(ShardWorker(f"w{i}"), port=0) for i in range(2)]
    coord = ClusterEngine([f"http://127.0.0.1:{w.server_address[1]}"
                           for w in wsrv], workers=2)
    try:
        for w in wsrv:
            threading.Thread(target=w.serve_forever, daemon=True).start()
        z2 = piecewise_signal(64, 16, 3, seed=4)
        coord.register_signal("s", z2)
        gathered = coord.get_coreset("s", 3, 0.3)[0].fingerprint()
        gathers = coord.metrics.get("cluster_gathers")
        one = sharded_coreset(z2, 3, 0.3, 2).fingerprint()
    finally:
        coord.close()
        for w in wsrv:
            w.shutdown()
            w.server_close()
import tempfile
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.train import train_loop
from repro_torch.runtime import HeartbeatMonitor
from repro_torch.train import (AdamWConfig, adamw_init, compress_with_feedback,
                               ef_init, make_train_step)
tok = TokenStream(lm.vocab, 2, 8, seed=0).batch_at(3)
opt = adamw_init(lm_params)
p2, opt, met = make_train_step(lm, AdamWConfig())(
    lm_params, opt, {k: torch.as_tensor(v) for k, v in tok.items()})
quant, _ = compress_with_feedback(p2["head"], ef_init(p2["head"]))
with tempfile.TemporaryDirectory() as ckpt:
    CheckpointManager(ckpt + "/a", async_save=False).save(1, {"p": p2})
    trained = train_loop(lm, steps=3, batch=2, seq_len=8, ckpt_dir=ckpt + "/b",
                         save_every=2, fail_at=2, device="cpu")["step"]
HeartbeatMonitor().report("w0", 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"loss": loss, "blocks": cs.num_blocks, "bad": bad,
                  "train": [int(opt["step"]), float(met["loss"]) > 0,
                            str(quant["w"][0].dtype), trained],
                  "best_k": res.best_k, "patched": bool(patched),
                  "streamed": streamed, "sharded": sharded,
                  "write_ops": write_ops,
                  "logits": list(logits.shape),
                  "finite": bool(torch.isfinite(logits.float()).all()),
                  "tokens": list(tokens.shape), "ssm": ssm_tokens,
                  "moe": moe_tokens, "frontends": frontends,
                  "served": [served.loss, served.backend, served.served_from],
                  "batch": batch.losses.tolist(),
                  "cluster": [gathers, gathered == one]}))
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
    assert res["ssm"] == [[[2, 5, 512], [2, 7]]] * 2
    assert res["moe"] == [[[2, 5, 512], True, [2, 7]]] * 2
    assert res["frontends"] == [[[2, 5, 4, 512], [2, 1, 4, 512]],
                                [[2, 13, 512], [2, 1, 512], [2, 7]]]
    loss, backend, served_from = res["served"]
    assert loss > 0 and backend == "numpy" and served_from == "built"
    assert res["batch"] == [loss] * 3
    assert res["cluster"] == [1, True]
    assert res["train"] == [1, True, "torch.int8", 3]


_MESH_RANK = """
import json, sys
import numpy as np
import torch.distributed as dist
dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        world_size=1, rank=0)
from repro_torch.launch.mesh import destroy_world
try:
    from repro_torch import ops
    from repro_torch.core import (random_tree_segmentation, sat_pjit,
                                  signal_coreset)
    from repro_torch.core.sharded import fitting_loss_batched
    from repro_torch.data import piecewise_signal
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device_type="cpu")
    y = piecewise_signal(32, 24, 3, seed=0)
    with ops.backend_override("numpy"):
        cs = signal_coreset(y, 3, 0.3)
    q = random_tree_segmentation(32, 24, 3, np.random.default_rng(1))
    loss = fitting_loss_batched(cs, q.rects[None], q.labels[None], mesh=mesh)
    images = sat_pjit(y, mesh=mesh).full_tensor()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(json.dumps({"bad": bad, "loss": loss.tolist(),
                      "images": list(images.shape)}))
finally:
    destroy_world()
"""


def test_a_cpu_mesh_rank_runs_without_jax_or_reference(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _MESH_RANK,
                          str(tmp_path / "store")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         start_new_session=True)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert len(res["loss"]) == 1 and res["loss"][0] > 0
    assert res["images"] == [3, 32, 24]


def test_importing_the_package_loads_no_mesh_and_starts_no_group():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import json, sys, repro_torch, torch.distributed as dist; "
            "print(json.dumps([m for m in ('repro_torch.launch.mesh', "
            "'torch.distributed.tensor') if m in sys.modules] "
            "+ [dist.is_initialized()]))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [False]


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
    scripts = sorted({*(ROOT / "scripts").glob("*_turns.py"),
                      *(ROOT / "scripts").glob("*_torch.py")})
    assert {p.name for p in scripts} >= {
        "fitting_loss_turns.py", "flash_attention_turns.py",
        "hist_f32_turns.py", "sat_delta_turns.py", "serve_turns.py",
        "cluster_gate_torch.py"}
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {p.name for p in examples} >= {"lm_pretrain_torch.py"}
    port = ROOT / "src" / "repro_torch"
    assert {port / "data" / "tokens.py", port / "launch" / "train.py",
            port / "train" / "train_step.py", port / "train" / "optimizer.py",
            port / "train" / "compress.py", port / "checkpoint" / "checkpointer.py",
            port / "runtime" / "fault_tolerance.py", port / "models" / "ssm.py",
            port / "models" / "moe.py"} <= set(files)
    files += [ROOT / "chip_smoke.py", *scripts, *examples]
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert bad == []


def _refuses_without_a_card(script):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would time kernels")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, f"scripts/{script}.py"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_flash_attention_turns_refuses_without_a_card():
    _refuses_without_a_card("flash_attention_turns")


def test_sat_delta_turns_refuses_without_a_card():
    _refuses_without_a_card("sat_delta_turns")

