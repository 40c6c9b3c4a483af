# Host side of the coreset pipeline, ported from ``repro.core``: prefix
# statistics, the bi-criteria lower bound, the balanced partition,
# Caratheodory block compression, the masked (weighted-point) build and the
# Algorithm-5 numpy oracle.  Only the integral images of PrefixStats.build
# leave the host (ops.sat_moments).
from .stats import PrefixStats, opt1_from_sums
from .slice_partition import slice_partition
from .balanced import BalancedPartition, balanced_partition
from .bicriteria import BicriteriaResult, bicriteria
from .caratheodory import block_representatives, caratheodory_reduce
from .coreset import SignalCoreset, signal_coreset, signal_coreset_to_size
from .streaming import compose, weighted_signal_coreset
from .fitting_loss import fitting_loss, true_loss, overlap_counts
from .segmentation import (Segmentation, greedy_tree, optimal_labels,
                           optimal_tree_dp, random_tree_segmentation,
                           segment_1d_dp)

__all__ = [
    "PrefixStats", "opt1_from_sums", "slice_partition", "BalancedPartition",
    "balanced_partition", "BicriteriaResult", "bicriteria",
    "block_representatives", "caratheodory_reduce", "SignalCoreset",
    "signal_coreset", "signal_coreset_to_size", "compose",
    "weighted_signal_coreset", "fitting_loss", "true_loss",
    "overlap_counts", "Segmentation", "greedy_tree", "optimal_labels",
    "optimal_tree_dp", "random_tree_segmentation", "segment_1d_dp",
]
