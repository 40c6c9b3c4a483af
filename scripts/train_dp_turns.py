"""Run ``chip_smoke.py``'s lm_train_dp phase alone, for this checkout and
for other trees, in turns, on one CUDA card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/train_dp_turns.py --other parent=build/parent

Each ``--other NAME=DIR`` names an unpacked tree that holds a
``chip_smoke.py`` with ``phase_lm_train_dp`` and its ``src/``.  The turns
run others, this, this, others reversed, each a process of its own tree, so
that a drift of the host or the card shows as a difference between a tree's
two turns.  Every turn runs the phase's checks (its ranks' losses, norms
and params bitwise across ranks, the reduced model against one rank, the
checkpoint onto one rank) against the one-rank losses ``--one-rank-losses``
(lm_train's first three, which the phase prints beside its own).  One JSON
line a turn (the tree's name and the phase's line), then nvidia-smi's name
and power limit.  Exits non-zero without a card or when a turn fails.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# lm_train's first three losses of qwen2-0.5b at 4 x 2048, seed 0, on the card
ONE_RANK_LOSSES = [12.19589900970459, 12.16098403930664, 11.99100399017334]
TURN = r"""
import json, subprocess, sys
sys.path.insert(0, ".")
import chip_smoke
losses = json.loads(sys.argv[1])
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True,
                     check=True).stdout.strip()
chip_smoke.phase_lm_train_dp(chip_smoke._kernel_counters(), smi, losses)
"""


def turn(name: str, tree: pathlib.Path, losses: list, timeout_s: float) -> dict:
    """One run of the phase from ``tree``: the phase's JSON line."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_TORCH_OPS_BACKEND")}
    env["PYTHONPATH"] = str(tree / "src")
    out = subprocess.run([sys.executable, "-c", TURN, json.dumps(losses)], cwd=tree,
                         env=env, capture_output=True, text=True, timeout=timeout_s)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"phase": "lm_train_dp"')]
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"{name}: the phase failed (exit {out.returncode})")
    return {"tree": name, **json.loads(lines[-1])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--one-rank-losses", type=json.loads, default=ONE_RANK_LOSSES)
    ap.add_argument("--timeout", type=float, default=400.0, help="seconds a turn")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_dp_turns: no CUDA device", file=sys.stderr)
        return 2
    others = [(n, pathlib.Path(d).resolve()) for n, d in
              (o.split("=", 1) for o in args.other)]
    order = others + [("this", ROOT), ("this", ROOT)] + others[::-1]
    for name, tree in order:
        print(json.dumps(turn(name, tree, args.one_rank_losses, args.timeout)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
