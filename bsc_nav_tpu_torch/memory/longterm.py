"""Long-term instance memory: detections -> 3D-located labeled instances.

Counterpart of the host half of ``bsc_nav_tpu/memory/longterm.py``
(``instances_from_detections``, ``integrate``, ``filter_by_floor``;
``longterm.py:21-59,129-164,238-242``).  The JAX module imports
``bsc_nav_tpu.geometry``, which imports JAX, so the functions are
re-implemented here on the port's numpy ``camera_intrinsics``.  The device
feed (``instances_device``, ``integrate_device_scan``) waits for
YOLO-World (ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from bsc_nav_tpu_torch.config import Config
from bsc_nav_tpu_torch.models.detector import Detection
from bsc_nav_tpu_torch import geometry as G


def instances_from_detections(
    detections: Sequence[Detection],
    depth: np.ndarray,
    cam_to_world: np.ndarray,
    cfg: Config,
) -> List[Dict]:
    """Locate each detection's box center in the voxel grid.

    cam_to_world: the full camera -> allocentric transform of the frame.
    """
    H, W = depth.shape
    mem = cfg.memory
    inv_calib = np.linalg.inv(G.camera_intrinsics(H, W, cfg.sensor.hfov_deg))
    out: List[Dict] = []
    for det in detections:
        x1, y1, x2, y2 = det.xyxy
        col = int((x1 + x2) / 2)
        row = int((y1 + y2) / 2)
        if not (0 <= row < H and 0 <= col < W):
            continue
        z = float(depth[row, col])
        if not (cfg.sensor.min_depth < z < cfg.sensor.max_depth):
            continue
        p_cam = inv_calib @ np.array([col + 0.5, row + 0.5, 1.0]) * z
        p_w = cam_to_world[:3, :3] @ p_cam + cam_to_world[:3, 3]
        r = int(mem.grid_size / 2 - int(p_w[0] / mem.cell_size))
        c = int(mem.grid_size / 2 - int(p_w[1] / mem.cell_size))
        h = int(p_w[2] / mem.cell_size)
        if (r < 0 or r >= mem.grid_size or c < 0 or c >= mem.grid_size
                or h < mem.zmin or h >= mem.zmax):
            continue
        out.append({
            "label": det.label,
            "loc": [r, c, h - mem.zmin],
            "confidence": float(det.confidence),
        })
    return out


def integrate(instances: List[Dict], threshold: int = 3) -> List[Dict]:
    """Deduplicate same-label instances within L1 grid distance: the first
    kept entry keeps the slot, its loc and confidence replaced when a
    duplicate is more confident."""
    by_label: Dict[str, List[Dict]] = {}
    for item in instances:
        by_label.setdefault(item["label"], []).append(item)

    final: List[Dict] = []
    for label, items in by_label.items():
        locs = np.asarray([i["loc"] for i in items], np.int64)
        confs = np.asarray([i["confidence"] for i in items], np.float64)
        kept_loc = np.zeros((len(items), 3), np.int64)
        kept_conf = np.zeros(len(items), np.float64)
        m = 0
        for i in range(len(items)):
            if m:
                l1 = np.abs(kept_loc[:m] - locs[i]).sum(axis=1)
                hits = np.nonzero(l1 <= threshold)[0]
                if hits.size:
                    j = hits[0]
                    if confs[i] > kept_conf[j]:
                        kept_loc[j] = locs[i]
                        kept_conf[j] = confs[i]
                    continue
            kept_loc[m] = locs[i]
            kept_conf[m] = confs[i]
            m += 1
        final.extend({"label": label, "loc": kept_loc[j].tolist(),
                      "confidence": float(kept_conf[j])}
                     for j in range(m))
    return final


def filter_by_floor(instances: List[Dict], floor_min: int,
                    floor_max: int) -> List[Dict]:
    """Single-floor filter on the instance's height cell."""
    return [o for o in instances
            if floor_min <= o["loc"][2] <= floor_max]
