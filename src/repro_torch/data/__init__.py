from .signals import (blobs, circles, moons, piecewise_signal, rasterize,
                      sensor_matrix, smooth_field, zscore)

__all__ = ["blobs", "circles", "moons", "piecewise_signal", "rasterize",
           "sensor_matrix", "smooth_field", "zscore"]
