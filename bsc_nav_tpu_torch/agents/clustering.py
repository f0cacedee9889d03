"""Host-side clustering of query candidates (numpy).

Copy of ``bsc_nav_tpu/agents/clustering.py``: similarity-weighted cluster
centres over the top-K voxels and adaptive auto-eps clustering.  The JAX
module runs sklearn's ``DBSCAN`` and ``NearestNeighbors``, which the card
machine does not have: DBSCAN is ``memory.floors.dbscan`` (sklearn's
labels, border points included), and the k-nearest-neighbour distances are
``knn_distances``, computed as sklearn's default search computes them.
``tests/test_torch_agents.py`` holds both functions to the JAX module's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from bsc_nav_tpu_torch.memory.floors import dbscan, squared_distances


def knn_distances(points: np.ndarray, k: int) -> np.ndarray:
    """[n, k] distances of each point to its k nearest points, itself
    included (at distance 0), ascending: ``NearestNeighbors(n_neighbors=k)
    .fit(points).kneighbors(points)[0]``.  sklearn searches by brute force
    when k >= n // 2 (the GEMM form of the squared distance, clipped at 0,
    then its root) and with a KD tree otherwise (the root of the sum of
    squared differences)."""
    points = np.asarray(points, np.float64)
    d2 = squared_distances(points, k >= len(points) // 2)
    return np.sqrt(np.sort(d2, axis=1)[:, :k])


def weighted_cluster_centers(
    top_k_positions: np.ndarray,
    top_k_similarity: np.ndarray,
    eps: float = 10.0,
    min_samples: int = 5,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """DBSCAN the top-K voxels; return similarity-weighted centers sorted
    by mean similarity (objnav_benchmark.py:477-495 semantics)."""
    pos = np.asarray(top_k_positions, float)
    sim = np.asarray(top_k_similarity, float)
    if len(pos) == 0:
        return np.zeros((0, pos.shape[-1] if pos.ndim == 2 else 3)), \
            np.zeros(0, int), []
    labels = dbscan(pos, eps, min_samples)
    info = []
    for lbl in sorted(set(labels) - {-1}):
        m = labels == lbl
        w = sim[m]
        center = np.average(pos[m], axis=0, weights=w)
        info.append((float(w.mean()), center, int(m.sum())))
    info.sort(key=lambda x: x[0], reverse=True)
    centers = (np.stack([c for _, c, _ in info])
               if info else np.zeros((0, pos.shape[1])))
    sizes = [s for _, _, s in info]
    return centers, labels, sizes


def _knee_index(sorted_vals: np.ndarray) -> int:
    """Elbow of an increasing curve: the point farthest below the chord
    from first to last value (max-distance-to-line heuristic, standing in
    for kneed.KneeLocator at utils.py:253-259)."""
    n = len(sorted_vals)
    if n < 3:
        return n - 1
    x = np.arange(n, dtype=float)
    y = np.asarray(sorted_vals, float)
    x0, y0, x1, y1 = x[0], y[0], x[-1], y[-1]
    denom = np.hypot(x1 - x0, y1 - y0) + 1e-12
    d = ((y1 - y0) * x - (x1 - x0) * y + x1 * y0 - y1 * x0) / denom
    return int(np.argmax(d))


def adaptive_clustering(points: np.ndarray, confidences: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Auto-eps DBSCAN with confidence-weighted centers
    (utils.py:219-322 behavior: knee-based eps, adaptive min_samples,
    one retry with loosened parameters)."""
    points = np.asarray(points, float)
    confidences = np.asarray(confidences, float)
    n = len(points)
    if n == 0:
        return np.zeros((0, 3)), np.zeros(0), np.zeros(0, int)
    if n == 1:
        return points.copy(), confidences.copy(), np.zeros(1, int)

    k = min(n - 1, max(5, int(np.sqrt(n))))
    distances = knn_distances(points, k)
    dist_sorted = np.sort(distances[:, -1])
    knee = _knee_index(dist_sorted)
    eps = dist_sorted[knee] * 0.5 if knee > 0 else float(np.median(dist_sorted))
    if eps <= 0:
        eps = float(np.mean(dist_sorted) + np.std(dist_sorted)) or 1.0
    min_samples = max(2, min(n // 20, int(np.log(n) / 1.5)))

    labels = dbscan(points, eps, min_samples)
    n_clusters = len(set(labels)) - (1 if -1 in labels else 0)

    expected_min = max(1, int(np.sqrt(n) / 3))
    if n_clusters == 0 or (n > 20 and n_clusters < expected_min):
        eps = eps * (1.5 if n_clusters == 0 else 0.7)
        min_samples = max(2, min_samples - 1)
        labels = dbscan(points, eps, min_samples)
        n_clusters = len(set(labels)) - (1 if -1 in labels else 0)

    centers, confs = [], []
    for i in range(n_clusters):
        m = labels == i
        centers.append(np.average(points[m], axis=0, weights=confidences[m]))
        confs.append(float(confidences[m].mean()))
    return np.asarray(centers), np.asarray(confs), labels
