"""Long-term instance memory: detections -> 3D-located labeled instances.

Counterpart of ``bsc_nav_tpu/memory/longterm.py``: the host half
(``instances_from_detections``, ``integrate``, ``filter_by_floor``) on the
port's numpy ``camera_intrinsics``, and the device feed
(``instances_device``, ``instances_from_device``, and the cumulative
integration on the device, ``integrate_state_init``,
``integrate_device_scan`` and ``instances_from_integrate_state``) on
torch tensors.  The JAX package runs its scan in one ``lax.scan`` and no
agent calls it; the port keeps it as a plain loop of tensor ops (no host
sync), for parity.

``instances_device``'s world points are 3-term products whose last bits
XLA forms as fused multiply-adds on some hosts only: ``box_points``
exposes the float stage and ``instances_device(..., points=)`` takes
points from elsewhere, as ``memory/ingest.ingest_frames`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bsc_nav_tpu_torch import resolve_device
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


def box_points(boxes, depth, cam_tfs, cfg: Config, det_size: int):
    """The float stage of ``instances_device``: each box's center pixel in
    the depth frame (corners scaled to the frame and clipped per corner,
    then the center, truncated), its depth, and its camera and world
    points.  boxes [B, K, 4] xyxy in det_size pixels; depth [B, H, W];
    cam_tfs [B, 4, 4].  Returns (in_frame [B, K] bool, z [B, K],
    p_cam [B, K, 3], p_world [B, K, 3])."""
    H, W = depth.shape[1], depth.shape[2]
    inv_calib = torch.as_tensor(np.linalg.inv(G.camera_intrinsics(
        H, W, cfg.sensor.hfov_deg)), dtype=torch.float32,
        device=depth.device)
    sx, sy = W / det_size, H / det_size
    x1 = torch.clamp(boxes[..., 0] * sx, 0, W)
    y1 = torch.clamp(boxes[..., 1] * sy, 0, H)
    x2 = torch.clamp(boxes[..., 2] * sx, 0, W)
    y2 = torch.clamp(boxes[..., 3] * sy, 0, H)
    col = torch.trunc((x1 + x2) / 2)
    row = torch.trunc((y1 + y2) / 2)
    in_frame = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    rowc = torch.clamp(row, 0, H - 1).to(torch.int64)
    colc = torch.clamp(col, 0, W - 1).to(torch.int64)
    z = torch.gather(depth.reshape(depth.shape[0], H * W), 1,
                     rowc * W + colc)                         # [B, K]
    pix = torch.stack([colc.to(torch.float32) + 0.5,
                       rowc.to(torch.float32) + 0.5, torch.ones_like(z)],
                      dim=-1)                                 # [B, K, 3]
    p_cam = torch.einsum("ij,bkj->bki", inv_calib, pix) * z[..., None]
    p_w = (torch.einsum("bij,bkj->bki", cam_tfs[:, :3, :3], p_cam)
           + cam_tfs[:, None, :3, 3])
    return in_frame, z, p_cam, p_w


def instances_device(boxes, conf, cls_idx, valid, depth, cam_tfs,
                     cfg: Config, det_size: int,
                     points: Optional[torch.Tensor] = None):
    """Device counterpart of ``instances_from_detections`` for a batch:
    detector boxes (det_size pixels) -> box-center depth backprojection ->
    world voxel, with no host sync; one small copy (``instances_from_
    device``) reaches the host.  boxes [B, K, 4]; conf, cls_idx, valid
    [B, K]; depth [B, H, W]; cam_tfs [B, 4, 4] camera -> world; points
    [B, K, 3] f32, if given, replaces ``box_points``' world points.
    Returns (locs [B, K, 3] int32 grid (r, c, h - zmin), conf, cls_idx,
    ok [B, K] bool)."""
    mem = cfg.memory
    in_frame, z, _, p_w = box_points(boxes, depth, cam_tfs, cfg, det_size)
    if points is not None:
        p_w = points
    z_ok = (z > cfg.sensor.min_depth) & (z < cfg.sensor.max_depth)
    rc = G.world_to_grid(p_w, mem.grid_size, mem.cell_size)
    in_grid = G.grid_in_range(rc, mem.grid_size, mem.zmin, mem.zmax)
    locs = rc - torch.tensor([0, 0, mem.zmin], dtype=rc.dtype,
                             device=rc.device)
    ok = valid & in_frame & z_ok & in_grid
    return locs, conf, cls_idx, ok


def instances_from_device(dev_out, classes: Sequence[str]) -> List[Dict]:
    """One small copy to the host -> instance dicts, frame-major."""
    locs, conf, cls_idx, ok = (t.cpu().numpy() for t in dev_out)
    out: List[Dict] = []
    for b in range(locs.shape[0]):
        for k in np.nonzero(ok[b])[0]:
            out.append({"label": classes[int(cls_idx[b, k])],
                        "loc": locs[b, k].tolist(),
                        "confidence": float(conf[b, k])})
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


def integrate_state_init(capacity: int, device="cuda"):
    """The long-term instance state on the device: buffers of
    ``capacity`` keepers plus one garbage row (index ``capacity``), cls
    -1 so that an empty slot never matches a label."""
    device = resolve_device(device)
    return (torch.zeros(capacity + 1, 3, dtype=torch.int32, device=device),
            torch.zeros(capacity + 1, dtype=torch.float32, device=device),
            torch.full((capacity + 1,), -1, dtype=torch.int32,
                       device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def integrate_device_scan(state, locs, conf, cls_idx, ok,
                          threshold: int = 3):
    """The reference's cumulative integration on the device: the previous
    keepers (slot order), then the batch's detections (frame-major) build
    a fresh keeper list, equal to ``integrate(kept + new)`` on the host up
    to the order of labels.  One step per item, each a few tensor ops
    with no host sync (the JAX package's ``lax.scan``).  state:
    ``integrate_state_init``'s tuple; locs [B, K, 3] int32, conf, cls_idx,
    ok [B, K] from ``instances_device``.  Returns the new state."""
    kept_loc, kept_conf, kept_cls, m = state
    C = kept_loc.shape[0] - 1
    dev = kept_loc.device
    it_loc = torch.cat([kept_loc[:C], locs.reshape(-1, 3).to(torch.int32)])
    it_conf = torch.cat([kept_conf[:C], conf.reshape(-1)])
    it_cls = torch.cat([kept_cls[:C], cls_idx.reshape(-1).to(torch.int32)])
    it_ok = torch.cat([torch.arange(C, device=dev) < m, ok.reshape(-1)])
    slot = torch.arange(C, device=dev)
    k_loc, k_conf, k_cls, n = integrate_state_init(C, dev)
    garbage = torch.full((1,), C, device=dev)
    # one-element index tensors throughout: indexing by a 0-d tensor would
    # read it on the host
    for i in range(it_loc.shape[0]):
        loc, cf, cl, valid = (it_loc[i:i + 1], it_conf[i:i + 1],
                              it_cls[i:i + 1], it_ok[i:i + 1])
        d = (k_loc[:C] - loc).abs().sum(1)
        hit = (d <= threshold) & (k_cls[:C] == cl) & (slot < n) & valid
        any_hit = hit.any().reshape(1)
        j = torch.argmax(hit.to(torch.int32)).reshape(1)   # first hit
        upgrade = any_hit & (cf > k_conf.index_select(0, j))
        append = valid & ~any_hit & (n < C)
        widx = torch.where(upgrade, j, torch.where(append, n, garbage))
        k_loc.index_copy_(0, widx, loc)
        k_conf.index_copy_(0, widx, cf)
        k_cls.index_copy_(0, widx, cl)
        n = n + append.to(torch.int32)
    return k_loc, k_conf, k_cls, n.reshape(())


def instances_from_integrate_state(state, classes: Sequence[str]
                                   ) -> List[Dict]:
    """One small copy to the host -> instance dicts in slot order."""
    k_loc, k_conf, k_cls, m = (t.cpu().numpy() for t in state)
    return [{"label": classes[int(k_cls[i])], "loc": k_loc[i].tolist(),
             "confidence": float(k_conf[i])} for i in range(int(m))]


def filter_by_floor(instances: List[Dict], floor_min: int,
                    floor_max: int) -> List[Dict]:
    """Single-floor filter on the instance's height cell."""
    return [o for o in instances
            if floor_min <= o["loc"][2] <= floor_max]
