# Downstream tree solvers: the paper applies existing libraries
# (sklearn RandomForestRegressor, LightGBM LGBMRegressor) as black boxes on
# the coreset; offline, those baselines are implemented here with
# first-class sample weights and LightGBM-style leaf-wise histogram growth.
from .cart import DecisionTreeRegressor, apply_bins, quantile_bins
from .forest import RandomForestRegressor
from .boosting import GradientBoostingRegressor
from .tuning import (TuneResult, best_segmentation, score_segmentations,
                     signal_to_points, tune_k, uniform_sample)

__all__ = [
    "DecisionTreeRegressor", "apply_bins", "quantile_bins",
    "RandomForestRegressor", "GradientBoostingRegressor",
    "TuneResult", "best_segmentation", "score_segmentations",
    "signal_to_points", "tune_k", "uniform_sample",
]
