from .signals import (blobs, circles, moons, piecewise_signal, rasterize,
                      sensor_matrix, smooth_field, zscore)
from .patches import patch_mask

__all__ = ["blobs", "circles", "moons", "piecewise_signal", "rasterize",
           "sensor_matrix", "smooth_field", "zscore", "patch_mask"]
