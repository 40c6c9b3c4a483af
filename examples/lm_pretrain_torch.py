"""End-to-end LM training with the PyTorch port: the qwen2-family model of
``examples/lm_pretrain.py`` (8 layers, d_model 512, 63.2M parameters)
trained on the synthetic token stream, with
checkpointing and restart through the port's production code path
(``repro_torch.launch.train.train_loop``), the counterpart of
``examples/lm_pretrain.py``.  Runs on the card; ``--device cpu`` runs it on
the CPU (slowly: pass --steps 30 for a quick look).  Checkpoints go to
``build/lm_pretrain_torch_ckpt`` in the checkout unless ``--ckpt`` names
another directory; a rerun resumes from the newest one.

    PYTHONPATH=src python examples/lm_pretrain_torch.py --steps 300
    PYTHONPATH=src python examples/lm_pretrain_torch.py --steps 30 --device cpu
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "lm_pretrain_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, raising without one")
    args = ap.parse_args()

    # the reference example's member of the qwen2 family (GQA + QKV bias)
    cfg = dataclasses.replace(
        get_arch("qwen2-0.5b"), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=2, d_ff=2048, vocab=32000, dtype="float32", remat=False)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} GQA {cfg.n_heads}/{cfg.n_kv_heads}")

    state = train_loop(cfg, steps=args.steps, batch=args.batch,
                       seq_len=args.seq, ckpt_dir=args.ckpt, save_every=100,
                       log_every=10, device=args.device)
    ls = state["losses"]
    if ls:
        k = max(len(ls) // 10, 1)
        print(f"loss: {np.mean(ls[:k]):.3f} -> {np.mean(ls[-k:]):.3f} over "
              f"{len(ls)} steps (vocab {cfg.vocab}: random = "
              f"{np.log(cfg.vocab):.2f})")


if __name__ == "__main__":
    main()
