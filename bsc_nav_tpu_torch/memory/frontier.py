"""Frontier-based exploration over the top-down map (numpy, host).

Copy of ``bsc_nav_tpu/memory/frontier.py``, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package
(``tests/test_torch_host_copies.py`` holds the two equal):

  - frontiers:        known + navigable cells 4-adjacent to unknown cells
  - clusters:         connected components (4-connectivity), min size
  - information gain: count of unknown cells in a (2r+1)^2 window around
                      a cluster's centre
  - target:           the cluster centre of largest gain

``scipy.ndimage`` is imported inside the functions, as
``env/pathfinding.py`` does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def find_frontiers(known: np.ndarray, navigable: np.ndarray) -> np.ndarray:
    """Boolean frontier mask: known and navigable cells adjacent
    (4-neighbourhood) to at least one unknown cell."""
    from scipy import ndimage
    near_unknown = ndimage.binary_dilation(~known, structure=_CROSS)
    return navigable & known & near_unknown


def cluster_frontiers(frontier_mask: np.ndarray, min_cluster_size: int = 10
                      ) -> List[np.ndarray]:
    """Connected frontier clusters (4-connectivity) of at least
    ``min_cluster_size`` cells, each as an array of its (x, y) cells."""
    from scipy import ndimage
    lab, n = ndimage.label(frontier_mask, structure=_CROSS)
    clusters = []
    for i in range(1, n + 1):
        cells = np.argwhere(lab == i)
        if len(cells) >= min_cluster_size:
            clusters.append(cells)
    return clusters


def information_gain_map(known: np.ndarray, radius: int) -> np.ndarray:
    """Count of unknown cells in a (2r+1)^2 window around every cell."""
    from scipy import ndimage
    unknown = (~known).astype(np.float32)
    size = 2 * radius + 1
    return ndimage.uniform_filter(
        unknown, size=size, mode="constant") * (size * size)


def select_frontier_target(
    known: np.ndarray,
    navigable: np.ndarray,
    min_cluster_size: int = 10,
    ig_radius: int = 5,
) -> Optional[Tuple[float, float]]:
    """Mask -> clusters -> the cluster centre of largest information gain;
    None when exploration is exhausted."""
    frontiers = find_frontiers(known, navigable)
    if not frontiers.any():
        return None
    clusters = cluster_frontiers(frontiers, min_cluster_size)
    if not clusters:
        return None
    ig = information_gain_map(known, ig_radius)
    best, best_ig = None, 0.0
    for cells in clusters:
        cx, cy = cells.mean(axis=0)
        g = float(ig[int(round(cx)), int(round(cy))])
        if g > best_ig:
            best_ig = g
            best = (float(cx), float(cy))
    return best
