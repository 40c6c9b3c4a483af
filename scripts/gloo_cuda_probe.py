"""Which collectives gloo takes on CUDA tensors, and the staged transport's.

Two ranks (processes of this script) share one card.  Each runs
all_reduce, all_gather_into_tensor, reduce_scatter_tensor and
all_to_all_single on CUDA tensors twice: on a plain gloo group (it may
refuse) and on ``repro_torch.launch.transport``'s group; each result is
held to the same collective on host tensors.  Prints one JSON object:
kind -> {"gloo": "ok" | "wrong" | the error, "staged": "ok" | ...}.

  python3 scripts/gloo_cuda_probe.py               # on the card
  python3 scripts/gloo_cuda_probe.py --device cpu  # both groups on host tensors
"""
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single")


def run(kind, x, group, world):
    import torch
    import torch.distributed as dist
    if kind == "all_reduce":
        out = x.clone()
        dist.all_reduce(out, group=group)
    elif kind == "all_gather_into_tensor":
        out = x.new_empty((world * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=group)
    elif kind == "reduce_scatter_tensor":
        out = x.new_empty((x.shape[0] // world,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, group=group)
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
    return out


def rank(world, r, store, device):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import transport
    from repro_torch.launch.mesh import destroy_world
    if device == "cuda":
        torch.cuda.set_device(0)
    transport.start_world("file://" + store, world, r)
    try:
        groups = {"gloo": dist.new_group(backend="gloo"), "staged": dist.group.WORLD}
        x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) * (r + 1)
        out = {}
        for kind in KINDS:
            want = run(kind, x, groups["gloo"], world)      # host tensors
            out[kind] = {}
            for name, g in groups.items():
                try:
                    got = run(kind, x.to(device), g, world).cpu()
                    out[kind][name] = "ok" if torch.equal(got, want) else "wrong"
                except Exception as e:  # noqa: BLE001 - the probe's finding
                    out[kind][name] = f"{type(e).__name__}: {str(e)[:200]}"
        out["stats"] = transport.stats()
        out["torch"] = torch.__version__
        print(json.dumps(out), flush=True)
    finally:
        groups = None
        destroy_world()


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        return 0
    device = "cpu" if sys.argv[1:] == ["--device", "cpu"] else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", "2", str(r), tmp + "/store", device],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for p, (_, err) in zip(procs, outs):
        if p.returncode:
            print(err[-3000:], file=sys.stderr)
            return 1
    res = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    print(json.dumps({"device": device, "ranks": res}))
    return 0 if all(r[k]["staged"] == "ok" for r in res for k in KINDS) else 1


if __name__ == "__main__":
    sys.exit(main())
