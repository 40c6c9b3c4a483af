"""repro_torch.launch.transport on the CPU: gloo ranks (child processes,
``torch_ranks``) whose world is the staged backend.  On host tensors each
collective goes straight to gloo; the results are gloo's own, each call is
counted once by kind with its result's bytes, and a collective that gloo
refuses raises on every rank.  (On the card: ``tests/test_torch_cuda.py``'s
probe.)"""
import json
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torch_ranks import ROOT, rank_env, run_ranks  # noqa: E402

_RANK = r'''
import json, sys
import torch
import torch.distributed as dist
world, rank, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from repro_torch.launch import transport
transport.start_world("file://" + store, world, rank)
from repro_torch.launch.mesh import destroy_world
try:
    out = {"backend": str(dist.get_backend())}
    x = torch.arange(4 * world, dtype=torch.float32) + rank
    transport.reset_stats()
    t = x.clone()
    dist.all_reduce(t)
    out["all_reduce"] = t.tolist()
    b = torch.full((3,), float(rank))
    dist.broadcast(b, src=world - 1)
    out["broadcast"] = b.tolist()
    dist.barrier()
    out["stats"] = transport.stats()
    transport.reset_stats()
    out["reset"] = transport.stats()
    try:
        dist.all_gather_into_tensor(torch.empty(3), torch.ones(2))
        out["refused"] = None
    except Exception as e:  # noqa: BLE001 - what the test reads
        out["refused"] = type(e).__name__
    print(json.dumps(out), flush=True)
finally:
    destroy_world()
'''


@pytest.mark.parametrize("world", [2, 3])
def test_a_staged_world_runs_gloo_s_collectives_and_counts_them(tmp_path, world):
    outs = run_ranks(_RANK, world, tmp_path)
    x = [sum(i + r for r in range(world)) for i in range(4 * world)]
    for out in outs:
        assert out["backend"] == "gloo_host"
        assert out["all_reduce"] == x
        assert out["broadcast"] == [float(world - 1)] * 3
        st = out["stats"]
        assert sorted(st) == ["all-reduce", "barrier", "broadcast"]
        assert st["all-reduce"]["calls"] == 1 and st["all-reduce"]["bytes"] == 16 * world
        assert st["broadcast"]["calls"] == 1 and st["broadcast"]["bytes"] == 12
        assert st["barrier"]["calls"] == 1 and st["barrier"]["bytes"] == 0
        # host tensors: nothing is copied, only the collective takes time
        assert st["all-reduce"]["collective_s"] > 0
        assert out["reset"] == {}
        assert out["refused"] is not None


def test_the_probe_on_host_tensors_agrees_with_gloo():
    """``scripts/gloo_cuda_probe.py --device cpu``: the four collectives of
    the partitioned step, on a plain gloo group and on the staged one,
    equal the host result, each counted once."""
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "gloo_cuda_probe.py"),
                          "--device", "cpu"], cwd=ROOT, env=rank_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for r in res["ranks"]:
        for kind in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                     "all_to_all_single"):
            assert r[kind] == {"gloo": "ok", "staged": "ok"}, kind
        assert {k: v["calls"] for k, v in r["stats"].items()} == {
            "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1, "all-to-all": 1}
