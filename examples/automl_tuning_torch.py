"""AutoML on the coreset (paper §5 / Fig 4): tune max_leaves for a random
forest on the compressed data, compare with tuning on the full data.

Runs its ops on the card; without one, pin the CPU with
``REPRO_TORCH_OPS_BACKEND=numpy`` (or ``torch``), or the first op raises.

    PYTHONPATH=src python examples/automl_tuning_torch.py
    REPRO_TORCH_OPS_BACKEND=numpy PYTHONPATH=src python examples/automl_tuning_torch.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data import patch_mask, sensor_matrix  # noqa: E402
from repro_torch.trees import tune_k  # noqa: E402


def main() -> None:
    y = sensor_matrix(4000, 15, seed=0)           # Air-Quality-like matrix
    train, test = patch_mask(*y.shape, 0.3, 5, seed=1)
    res = tune_k(y, train, test, ks=[8, 16, 32, 64, 128, 256],
                 coreset_k=64, target_frac=0.03, n_estimators=8)
    print(f"{'method':10s} {'train size':>10s} {'best k':>7s} "
          f"{'best SSE':>10s} {'total s':>8s}")
    for name in res.losses:
        print(f"{name:10s} {res.sizes[name]:10d} {res.best_k[name]:7d} "
              f"{min(res.losses[name]):10.1f} {res.times[name]:8.2f}")
    sp = res.times["full"] / max(res.times["coreset"], 1e-9)
    print(f"\nspeedup of the tuning sweep (incl. one-off compression): "
          f"x{sp:.1f}")
    print("loss-vs-k curves (coreset tracks full):")
    for k, lf, lc in zip(res.ks, res.losses["full"], res.losses["coreset"]):
        print(f"  k={k:4d}: full {lf:9.1f} | coreset {lc:9.1f}")


if __name__ == "__main__":
    main()
