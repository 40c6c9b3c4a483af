"""Quickstart: build a (k, eps)-coreset, train a forest on it, compare.

Runs its ops on the card; without one, pin the CPU with
``REPRO_TORCH_OPS_BACKEND=numpy`` (or ``torch``), or the first op raises.

    PYTHONPATH=src python examples/quickstart_torch.py
    REPRO_TORCH_OPS_BACKEND=numpy PYTHONPATH=src python examples/quickstart_torch.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (fitting_loss, random_tree_segmentation,  # noqa: E402
                        signal_coreset, true_loss)
from repro_torch.data import piecewise_signal  # noqa: E402
from repro_torch.trees import RandomForestRegressor, signal_to_points  # noqa: E402


def main() -> None:
    # 1. a 300x400 signal with 25-piece ground truth + noise
    y = piecewise_signal(300, 400, k=25, noise=0.15, seed=0)

    # 2. the paper's contribution: a provable summary of the signal
    cs = signal_coreset(y, k=25, eps=0.3)
    print(f"coreset: {cs.size} weighted points "
          f"({100 * cs.compression_ratio():.2f}% of the {y.size} cells), "
          f"built in {cs.build_seconds:.2f}s")

    # 3. Definition 3 in action: any k-tree's loss is approximated
    rng = np.random.default_rng(1)
    seg = random_tree_segmentation(300, 400, 25, rng)
    tl = true_loss(y, seg.rects, seg.labels)
    cl = fitting_loss(cs, seg.rects, seg.labels)
    print(f"random 25-tree: true loss {tl:.1f}, coreset loss {cl:.1f} "
          f"(rel err {abs(cl - tl) / tl:.2%}, eps was 30%)")

    # 4. train forests on full data vs the coreset
    Xf, yf = signal_to_points(y)
    Xc, yc, wc = cs.as_points()
    f_full = RandomForestRegressor(n_estimators=5, max_leaves=64).fit(Xf, yf)
    f_core = RandomForestRegressor(n_estimators=5, max_leaves=64).fit(
        Xc, yc, sample_weight=wc)
    sse_full = float(((f_full.predict(Xf) - yf) ** 2).mean())
    sse_core = float(((f_core.predict(Xf) - yf) ** 2).mean())
    print(f"forest MSE on the signal: full-data {sse_full:.4f} vs "
          f"coreset-trained {sse_core:.4f} "
          f"(training set {len(yc)} vs {len(yf)} points)")


if __name__ == "__main__":
    main()
