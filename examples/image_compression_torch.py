"""Image compression via k-segmentation on a coreset (paper §1: the MPEG4 /
quadtree use case).  A synthetic "image" is summarized once; the k-tree
solver is then tuned across many k values using only Algorithm-5 queries
against the coreset — never touching the full image again.

Runs its ops on the card; without one, pin the CPU with
``REPRO_TORCH_OPS_BACKEND=numpy`` (or ``torch``), or the first op raises.

    PYTHONPATH=src python examples/image_compression_torch.py
    REPRO_TORCH_OPS_BACKEND=numpy PYTHONPATH=src python examples/image_compression_torch.py
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import fitting_loss, signal_coreset, true_loss  # noqa: E402
from repro_torch.data import smooth_field  # noqa: E402
from repro_torch.trees import DecisionTreeRegressor  # noqa: E402


def main() -> None:
    img = smooth_field(256, 256, freq=5, noise=0.05, seed=3)
    cs = signal_coreset(img, k=256, eps=0.3)
    print(f"image 256x256 -> coreset {cs.size} points "
          f"({100 * cs.compression_ratio():.2f}%)")

    # tune the number of blocks k on the CORESET only
    Xc, yc, wc = cs.as_points()
    t0 = time.time()
    results = {}
    for k in (16, 64, 256, 1024):
        t = DecisionTreeRegressor(max_leaves=k).fit(Xc, yc, sample_weight=wc)
        rects, vals = t.leaf_rectangles(np.zeros(2), np.asarray(img.shape, float))
        # snap to integer cell grid for evaluation
        rects = np.round(rects[:, [0, 2, 1, 3]]).astype(np.int64)
        loss_via_coreset = fitting_loss(cs, rects, vals)
        loss_true = true_loss(img, rects, vals)
        psnr = 10 * np.log10(img.size * (img.max() - img.min()) ** 2
                             / max(loss_true, 1e-12))
        results[k] = (loss_via_coreset, loss_true, psnr)
        print(f"k={k:5d}: loss via coreset {loss_via_coreset:10.1f} | "
              f"true {loss_true:10.1f} | PSNR {psnr:5.1f} dB | "
              f"compression {k / img.size:.2%}")
    print(f"tuning on coreset took {time.time() - t0:.2f}s "
          f"(the image itself was only touched once, at build time)")


if __name__ == "__main__":
    main()
