"""The §5 missing-value protocol: hold out random 5x5 patches as the test set."""
from __future__ import annotations

import numpy as np

__all__ = ["patch_mask"]


def patch_mask(n: int, m: int, test_fraction: float = 0.3, patch: int = 5,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Returns (train_mask, test_mask): test cells are random patch x patch
    squares covering ~test_fraction of the signal (paper §5: 30%, 5x5)."""
    rng = np.random.default_rng(seed)
    test = np.zeros((n, m), bool)
    target = int(test_fraction * n * m)
    guard = 0
    while test.sum() < target and guard < 100000:
        i = int(rng.integers(0, max(n - patch, 1)))
        j = int(rng.integers(0, max(m - patch, 1)))
        test[i:i + patch, j:j + patch] = True
        guard += 1
    return ~test, test
