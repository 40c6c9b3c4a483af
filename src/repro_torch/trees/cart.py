"""Weighted CART regression trees (histogram algorithm).

The downstream solver the paper feeds its coresets to (sklearn's
DecisionTreeRegressor / LightGBM's LGBMRegressor — neither is installable in
this offline container, so the baselines are implemented here).  Design
follows LightGBM's histogram algorithm:

  * features are quantile-binned once (<= 255 bins, uint8 codes);
  * each node builds per-(feature, bin) histograms of (w, w*y, w*y^2) and
    scans prefix sums for the best variance-reduction split;
  * growth is *best-first* with a leaf budget (``max_leaves = k`` — the
    paper's k-tree notion), like LightGBM's leaf-wise growth.

Sample weights are first-class throughout (coreset points are weighted).
The histogram build is the training hot spot; it dispatches ``hist_split``
once per node, bound to the tree's data (``repro_torch.ops.bind``): the
numpy bincount oracle on the node's rows, or the tree's codes and channels
held on the device once and each node's rows sent to the float64 CUDA
kernel in ``repro_torch.kernels.histsplit`` (or its plain PyTorch version
on the CPU), all bitwise equal, so a tree does not depend on where its
histograms were summed.  ``hist_backend`` selects:
"auto" (the dispatcher's rules: a pin from ``ops.backend_override`` or
REPRO_TORCH_OPS_BACKEND, else the card, else raise), "numpy", "torch" or
"cuda".
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

__all__ = ["DecisionTreeRegressor", "quantile_bins", "apply_bins"]

# hist_backend -> registry backend; "auto" defers to selection
_HIST_BACKENDS = {"auto": None, "numpy": "numpy", "torch": "torch",
                  "cuda": "cuda"}


def quantile_bins(X: np.ndarray, max_bins: int = 255) -> list[np.ndarray]:
    """Per-feature bin upper edges from quantiles (deduplicated)."""
    edges = []
    for f in range(X.shape[1]):
        qs = np.quantile(X[:, f], np.linspace(0, 1, max_bins + 1)[1:-1])
        edges.append(np.unique(qs))
    return edges


def apply_bins(X: np.ndarray, edges: list[np.ndarray]) -> np.ndarray:
    """uint8 bin codes; bin b covers (edges[b-1], edges[b]]."""
    out = np.empty(X.shape, np.uint8)
    for f, e in enumerate(edges):
        out[:, f] = np.searchsorted(e, X[:, f], side="left").astype(np.uint8)
    return out


@dataclasses.dataclass
class _Node:
    feature: int = -1        # -1: leaf
    threshold: float = 0.0   # raw-value threshold (go left if x <= thr)
    bin_thr: int = 0
    left: int = -1
    right: int = -1
    value: float = 0.0


class DecisionTreeRegressor:
    """Best-first weighted CART with a leaf budget (the paper's k)."""

    def __init__(self, max_leaves: int = 31, max_depth: int = 64,
                 min_weight_leaf: float = 1e-9, min_gain: float = 0.0,
                 max_bins: int = 255, hist_backend: str = "auto",
                 feature_indices: np.ndarray | None = None):
        self.max_leaves = int(max_leaves)
        self.max_depth = int(max_depth)
        self.min_weight_leaf = float(min_weight_leaf)
        self.min_gain = float(min_gain)
        self.max_bins = int(max_bins)
        self.hist_backend = hist_backend
        self.feature_indices = feature_indices
        self.nodes: list[_Node] = []
        self.edges: list[np.ndarray] | None = None

    # -------------------------------------------------------------- fitting
    def fit(self, X: np.ndarray, y: np.ndarray, sample_weight: np.ndarray | None = None,
            bins: tuple[list[np.ndarray], np.ndarray] | None = None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        w = np.ones(len(y)) if sample_weight is None else np.asarray(sample_weight, np.float64)
        if bins is not None:
            self.edges, codes = bins
        else:
            self.edges = quantile_bins(X, self.max_bins)
            codes = apply_bins(X, self.edges)
        if self.feature_indices is not None:
            codes = codes[:, self.feature_indices]
        n_bins = max(self.max_bins + 1, 2)
        wy, wy2 = w * y, w * y * y
        from repro_torch import ops
        try:
            hist_backend = _HIST_BACKENDS[self.hist_backend]
        except KeyError:
            raise ValueError(
                f"unknown hist_backend {self.hist_backend!r}; "
                f"valid: {sorted(_HIST_BACKENDS)}") from None

        node_hist = None

        def hist_fn(idx):
            # one hist_split dispatch a node; the first binds the tree's
            # codes and channels to the backend (on the card: one upload)
            nonlocal node_hist
            if node_hist is None:
                node_hist = ops.bind("hist_split", codes, w, wy, wy2, n_bins,
                                     backend=hist_backend)
            return np.asarray(node_hist(idx))

        self.nodes = [_Node()]
        # heap entries: (-gain, counter, node_id, row_idx, depth, split_info)
        heap: list = []
        counter = 0

        def leaf_stats(idx):
            return w[idx].sum(), wy[idx].sum(), wy2[idx].sum()

        def consider(node_id, idx, depth):
            nonlocal counter
            s0, s1, s2 = leaf_stats(idx)
            self.nodes[node_id].value = s1 / max(s0, 1e-300)
            if depth >= self.max_depth or s0 <= 2 * self.min_weight_leaf or len(idx) < 2:
                return
            H = hist_fn(idx)
            c0 = np.cumsum(H[:, :, 0], axis=1)
            c1 = np.cumsum(H[:, :, 1], axis=1)
            l0, l1 = c0[:, :-1], c1[:, :-1]
            r0, r1 = s0 - l0, s1 - l1
            ok = (l0 >= self.min_weight_leaf) & (r0 >= self.min_weight_leaf)
            with np.errstate(divide="ignore", invalid="ignore"):
                gain = (l1 * l1 / np.maximum(l0, 1e-300)
                        + r1 * r1 / np.maximum(r0, 1e-300)
                        - s1 * s1 / max(s0, 1e-300))
            gain = np.where(ok, gain, -np.inf)
            f, b = np.unravel_index(np.argmax(gain), gain.shape)
            if not np.isfinite(gain[f, b]) or gain[f, b] <= self.min_gain:
                return
            heapq.heappush(heap, (-float(gain[f, b]), counter, node_id, idx,
                                  depth, (int(f), int(b))))
            counter += 1

        all_idx = np.arange(len(y))
        consider(0, all_idx, 0)
        n_leaves = 1
        while heap and n_leaves < self.max_leaves:
            _, _, node_id, idx, depth, (f, b) = heapq.heappop(heap)
            go_left = codes[idx, f] <= b
            li, ri = idx[go_left], idx[~go_left]
            if len(li) == 0 or len(ri) == 0:
                continue
            node = self.nodes[node_id]
            node.feature = int(self.feature_indices[f]) if self.feature_indices is not None else f
            fe = self.edges[node.feature]
            node.threshold = float(fe[b]) if b < len(fe) else float("inf")
            node.bin_thr = b
            node.left, node.right = len(self.nodes), len(self.nodes) + 1
            self.nodes += [_Node(), _Node()]
            consider(node.left, li, depth + 1)
            consider(node.right, ri, depth + 1)
            n_leaves += 1
        return self

    # ----------------------------------------------------------- prediction
    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.empty(len(X))
        feat = np.array([nd.feature for nd in self.nodes])
        thr = np.array([nd.threshold for nd in self.nodes])
        left = np.array([nd.left for nd in self.nodes])
        right = np.array([nd.right for nd in self.nodes])
        val = np.array([nd.value for nd in self.nodes])
        cur = np.zeros(len(X), np.int64)
        active = feat[cur] >= 0
        while active.any():
            f = feat[cur[active]]
            goleft = X[active, f] <= thr[cur[active]]
            nxt = np.where(goleft, left[cur[active]], right[cur[active]])
            cur[active] = nxt
            active = feat[cur] >= 0
        out = val[cur]
        return out

    @property
    def n_leaves(self) -> int:
        return sum(1 for nd in self.nodes if nd.feature < 0)

    def leaf_rectangles(self, lo: np.ndarray, hi: np.ndarray):
        """Axis-aligned leaf cells over box [lo, hi) — for 2D signal-domain
        trees this yields the k-segmentation consumed by Algorithm 5."""
        rects, vals = [], []

        def rec(node_id, lo, hi):
            nd = self.nodes[node_id]
            if nd.feature < 0:
                rects.append(np.concatenate([lo, hi]))
                vals.append(nd.value)
                return
            mid_lo, mid_hi = lo.copy(), hi.copy()
            mid_hi[nd.feature] = min(hi[nd.feature], nd.threshold)
            rec(nd.left, lo, mid_hi)
            mid_lo[nd.feature] = min(hi[nd.feature], nd.threshold)
            rec(nd.right, mid_lo, hi)

        rec(0, np.asarray(lo, np.float64), np.asarray(hi, np.float64))
        return np.asarray(rects), np.asarray(vals)
