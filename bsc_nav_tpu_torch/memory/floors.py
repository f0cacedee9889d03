"""Multi-floor detection and floor height ranges (host code).

A copy of ``bsc_nav_tpu/memory/floors.py`` (the reference's load-time
floor logic, memory_2.py:203-256): DBSCAN over the agent base heights
sampled during mapping (eps 0.4, min_samples = len//5), floor ranges
carved out of the occupied-height span, then the current floor chosen by
the agent's height.

The JAX module runs ``sklearn.cluster.DBSCAN``, which the port does not
need: ``dbscan_1d`` gives sklearn's labels for these 1-D heights in numpy.
Its neighbourhoods are those of ``NearestNeighbors(radius=eps)`` with
sklearn's default algorithm choice -- brute force for up to 11 points,
whose squared distance is x^2 + (-2xy) + y^2 (the GEMM form), a KD tree
beyond, whose squared distance is (x - y)^2 -- each compared with eps^2,
the point itself included.  A point with at least min_samples neighbours
is a core point; cores chained within eps form a cluster, clusters are
numbered in order of their lowest core index, and a border point (not
core, within eps of a core) takes the first cluster that reaches it, the
lowest-numbered one among its cores' clusters, as sklearn's expansion
does.  ``tests/test_torch_host_copies.py`` holds it to sklearn.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

EPS = 0.4
_BRUTE_MAX = 11     # NearestNeighbors' default n_neighbors 5 >= n // 2


def _neighbours(x: np.ndarray, eps: float) -> np.ndarray:
    """[n, n] bool: j within eps of i, as sklearn's radius query decides."""
    if len(x) <= _BRUTE_MAX:
        sq = x * x
        d2 = np.maximum((sq[:, None] + (-2.0 * x[:, None]) * x[None, :])
                        + sq[None, :], 0.0)
    else:
        d = x[:, None] - x[None, :]
        d2 = d * d
    return d2 <= eps * eps


def dbscan_1d(x: Sequence[float], eps: float, min_samples: int
              ) -> np.ndarray:
    """sklearn ``DBSCAN(eps, min_samples).fit(x[:, None]).labels_`` for
    1-D data: cluster ids from 0, -1 for noise."""
    x = np.asarray(x, np.float64).reshape(-1)
    n = len(x)
    nb = _neighbours(x, eps)
    core = nb.sum(axis=1) >= min_samples
    labels = np.full(n, -1, np.int64)
    label = 0
    for seed in range(n):
        if labels[seed] != -1 or not core[seed]:
            continue
        labels[seed] = label
        stack = [seed]
        while stack:               # cores chained within eps
            i = stack.pop()
            for j in np.flatnonzero(nb[i] & core & (labels == -1)):
                labels[j] = label
                stack.append(j)
        label += 1
    for i in np.flatnonzero(~core):
        reach = labels[nb[i] & core]
        if len(reach):
            labels[i] = reach.min()
    return labels


def detect_floors(base_heights: Sequence[float]) -> List[float]:
    """Cluster sampled base heights into floor heights (ascending)."""
    arr = np.asarray(list(base_heights), float).reshape(-1, 1)
    if len(arr) == 0:
        return []
    min_samples = max(1, len(arr) // 5)
    labels = dbscan_1d(arr[:, 0], EPS, min_samples)
    floors = [float(arr[labels == l].mean())
              for l in sorted(set(labels)) if l != -1]
    return sorted(floors)


def floor_ranges(floor_heights: Sequence[float],
                 pos_h_range: Tuple[int, int],
                 cell_size: float) -> List[Tuple[int, int]]:
    """Per-floor [min_h, max_h] voxel-height ranges (memory_2.py:224-241):
    the lowest floor starts at the occupied minimum, the highest ends at
    the occupied maximum, intermediate boundaries at the height gaps."""
    lo, hi = pos_h_range
    n = len(floor_heights)
    if n <= 1:
        return [(int(lo), int(hi))]
    out = []
    for i in range(n):
        if i == 0:
            fmin = lo
            fmax = lo + (floor_heights[1] - floor_heights[0]) / cell_size
        elif i == n - 1:
            fmin = lo + (floor_heights[i] - floor_heights[0]) / cell_size
            fmax = hi
        else:
            fmin = lo + (floor_heights[i] - floor_heights[0]) / cell_size
            fmax = lo + (floor_heights[i + 1] - floor_heights[0]) / cell_size
        out.append((int(fmin) + 1, int(fmax) - 1))
    return out


def current_floor_range(base_heights: Sequence[float],
                        agent_height: float,
                        occupied_heights: np.ndarray,
                        cell_size: float) -> Tuple[int, int, int]:
    """(floor_index, min_h, max_h) for the floor the agent stands on."""
    floors = detect_floors(base_heights)
    if not floors:
        lo = int(occupied_heights.min()) if len(occupied_heights) else 0
        hi = int(occupied_heights.max()) if len(occupied_heights) else 0
        return 0, lo, hi
    lo = int(occupied_heights.min())
    hi = int(occupied_heights.max())
    idx = int(np.argmin(np.abs(np.asarray(floors) - agent_height)))
    ranges = floor_ranges(floors, (lo, hi), cell_size)
    fmin, fmax = ranges[idx] if idx < len(ranges) else (lo, hi)
    return idx, fmin, fmax
