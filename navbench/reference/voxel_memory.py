"""Plain voxel token memory (BSC-Nav ``memory_2.py``'s ingest: the
``dist`` policy), in the order of its points.

Each batch of frames draws its pixel subset (``ceil(H*W / rate)`` pixels a
frame, with replacement) and one replacement row a point from a
``torch.Generator`` seeded with the memory's seed, in that order, as the
memory does.  Each drawn pixel is back-projected with the pinhole of the
sensor (depth along the optical axis) and carried into the world frame,
which is the first frame's robot base (x forward, y left, z up).  Its
voxel is (G/2 - int(x/cs), G/2 - int(y/cs), int(z/cs) - zmin), Python's
``int`` truncating toward zero; a point outside the depth range, the grid
or the height range is dropped.  Its patch token is the one whose cell of
the token grid the point projects into.  Then, in frame-major order:

- a voxel seen for the first time takes the next free slot (none once the
  capacity is reached: the point is dropped);
- the voxel's colour sums take alpha * rgb and alpha, alpha =
  exp(-|p_cam|^2 / (2 sigma^2));
- the top-down cell takes the point's colour and height when the height
  is at least the cell's highest so far;
- the token is appended while the voxel holds fewer than K, and otherwise
  replaces the row drawn for this point.

Geometry runs in float64 on the host; tokens are the reference encoder's
f32 tokens.  The rules above are applied to a batch's points at once, with
their order kept: a voxel's new points take its free rows in order, and
among the points of a top-down cell at its greatest height the last
wins.  State is keyed by voxel id, so the comparison never depends on slot
numbers.  ``added``, ``replaced`` and ``dropped`` count voxels that took
a slot, points that replaced a row, and points whose new voxel found the
store full; ``gated`` counts points outside the depth range, the grid or
the token grid.

A point that lies within ``edge_m`` of a cell's edge may fall on either
side of it in the program's float32 geometry: every voxel and top-down
cell it could fall into is marked ``unsure`` (``unsure_voxels``,
``unsure_cells``), and the comparison leaves their sums out.  With
``tf32`` the geometry's products take their operands rounded to TF32 and
sum in float32, as a float32 product with TF32 on does (the control).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _tf(pose: np.ndarray) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = _rot(np.asarray(pose[3:7], np.float64))
    t[:3, 3] = np.asarray(pose[:3], np.float64)
    return t


# habitat camera axes -> robot base axes (forward = -z, left = -x, up = y)
BASE = np.array([[0, 0, -1, 0], [-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]])


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as the tensor cores take a TF32 operand."""
    u = np.asarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def _cam_flip(sensor_height: float) -> np.ndarray:
    """Pinhole camera (x right, y down, z forward) -> the agent's habitat
    frame: y and z flipped, the sensor ``sensor_height`` up."""
    t = np.diag([1.0, -1.0, -1.0, 1.0])
    t[1, 3] = sensor_height
    return t


class VoxelMemory:
    """The store, keyed by voxel id.  ``m``: the configuration's
    ``memory``; ``s``: its ``sensor``."""

    def __init__(self, m: Dict, s: Dict, seed: int, device,
                 edge_m: float = 0.0, tf32: bool = False):
        self.m, self.s = m, s
        self.edge_m, self.tf32 = edge_m, tf32
        self.unsure_voxels, self.unsure_cells = set(), set()
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        K, D = m["cache_size"], m["token_dim"]
        self.slot: Dict[int, int] = {}
        self.feats = np.zeros((m["voxel_capacity"], K, D), np.float32)
        self.count = np.zeros(m["voxel_capacity"], np.int64)
        self.rgb_sum = np.zeros((m["voxel_capacity"], 3))
        self.weight = np.zeros(m["voxel_capacity"])
        self.cells: Dict[int, tuple] = {}      # cell -> (height, rgb)
        self.added = self.replaced = self.dropped = self.gated = 0
        self.world0 = None

    def _grid(self, pw: np.ndarray):
        """World points [n, 3] -> (row, col, height) cells, Python's int
        truncating toward zero."""
        G, cs = self.m["grid_size"], self.m["cell_size"]
        return (G // 2 - np.trunc(pw[:, 0] / cs).astype(np.int64),
                G // 2 - np.trunc(pw[:, 1] / cs).astype(np.int64),
                np.trunc(pw[:, 2] / cs).astype(np.int64))

    def _mark_unsure(self, pw: np.ndarray, zmin: int, Hc: int) -> None:
        """The voxels and cells of the points within ``edge_m`` of an
        edge, on both sides of it."""
        G = self.m["grid_size"]
        cells = [self._grid(pw)]
        for axis in range(3):
            for sign in (-1.0, 1.0):
                q = pw.copy()
                q[:, axis] += sign * self.edge_m
                cells.append(self._grid(q))
        r0, c0, h0 = cells[0]
        near = np.zeros(len(pw), bool)
        for r, c, h in cells[1:]:
            near |= (r != r0) | (c != c0) | (h != h0)
        for r, c, h in cells:
            r, c, h = r[near], c[near], h[near]
            self.unsure_voxels.update(((r * G + c) * Hc + h - zmin).tolist())
            self.unsure_cells.update((r * G + c).tolist())

    def ingest(self, rgb: np.ndarray, depth: np.ndarray, poses: np.ndarray,
               tokens: np.ndarray) -> None:
        """rgb [B, H, W, 3] uint8, depth [B, H, W] f32, poses [B, 7] f32,
        tokens [B, nh, nw, D] f32 (host arrays)."""
        m, s = self.m, self.s
        B, H, W = depth.shape
        P = -(-H * W // m["depth_sample_rate"])
        K, G, cs = m["cache_size"], m["grid_size"], m["cell_size"]
        zmin = int(m["floor_height"] / cs)
        zmax = int(m["map_height"] / cs)
        Hc = zmax - zmin
        pix = torch.randint(0, H * W, (B, P), generator=self.gen,
                            device=self.device).cpu().numpy()
        repl = torch.randint(0, K, (B * P,), generator=self.gen,
                             device=self.device).cpu().numpy()
        if self.world0 is None:
            self.world0 = np.linalg.inv(_tf(poses[0]))
        f = W / (2.0 * math.tan(math.radians(s["hfov_deg"]) / 2.0))
        nh, nw = tokens.shape[1], tokens.shape[2]
        flip = _cam_flip(s["sensor_height"])
        sigma2 = 2.0 * m["alpha_sigma_sq"]
        pts = []                     # per frame, its points that pass
        for b in range(B):
            cam2world = BASE @ self.world0 @ _tf(poses[b]) @ flip
            py, px = pix[b] // W, pix[b] % W
            z = depth[b, py, px].astype(np.float64)
            pc = np.stack([(px + 0.5 - W / 2) / f * z,
                           (py + 0.5 - H / 2) / f * z, z], -1)
            if self.tf32:
                pw = (_tf32(pc) @ _tf32(cam2world[:3, :3]).T
                      + cam2world[:3, 3].astype(np.float32)).astype(
                          np.float64)
            else:
                pw = pc @ cam2world[:3, :3].T + cam2world[:3, 3]
            row, col, hgt = self._grid(pw)
            with np.errstate(divide="ignore", invalid="ignore"):
                u = np.trunc((nw / 2) * pc[:, 0] / z + nw / 2 - 0.5)
                v = np.trunc((nh / 2) * pc[:, 1] / z + nh / 2 - 0.5)
            ok = ((z > s["min_depth"]) & (z < s["max_depth"])
                  & (row >= 0) & (row < G) & (col >= 0) & (col < G)
                  & (hgt >= zmin) & (hgt < zmax)
                  & (u >= 0) & (v >= 0) & (u < nw) & (v < nh))
            js = np.nonzero(ok)[0]
            self.gated += P - len(js)
            if self.edge_m > 0:
                self._mark_unsure(pw[js], zmin, Hc)
            pts.append((row[js], col[js], hgt[js] - zmin,
                        np.exp(-(pc[js] * pc[js]).sum(-1) / sigma2),
                        rgb[b, py[js], px[js]].astype(np.int64),
                        np.full(len(js), b), v[js].astype(np.int64),
                        u[js].astype(np.int64), repl[b * P + js]))
        r, c, h, alpha, colour, fb, vv, uu, rk = (
            np.concatenate(x) for x in zip(*pts))
        if not len(r):
            return
        # slots: new voxels in order of their first point, while room lasts
        vid = (r * G + c) * Hc + h
        uniq, first, inv = np.unique(vid, return_index=True,
                                     return_inverse=True)
        slot_of = np.empty(len(uniq), np.int64)
        for i in np.argsort(first, kind="stable"):
            key = int(uniq[i])
            sl = self.slot.get(key)
            if sl is None:
                if len(self.slot) >= m["voxel_capacity"]:
                    sl = -1
                else:
                    sl = self.slot[key] = len(self.slot)
                    self.added += 1
            slot_of[i] = sl
        slot = slot_of[inv]
        keep = slot >= 0
        self.dropped += int((~keep).sum())
        slot, r, c, h, alpha, colour, fb, vv, uu, rk = (
            x[keep] for x in (slot, r, c, h, alpha, colour, fb, vv, uu, rk))
        if not len(slot):
            return
        # colour sums and weights (order-free)
        lo, hi = slot.min(), slot.max() + 1
        self.weight[lo:hi] += np.bincount(slot - lo, alpha, hi - lo)
        for ch in range(3):
            self.rgb_sum[lo:hi, ch] += np.bincount(
                slot - lo, alpha * colour[:, ch], hi - lo)
        # top-down cells: the last point at a cell's greatest height
        cell = r * G + c
        n = np.arange(len(cell))
        order = np.lexsort((n, h, cell))
        last = np.r_[cell[order][1:] != cell[order][:-1], True]
        for j in order[last].tolist():
            seen = self.cells.get(int(cell[j]))
            if seen is None or h[j] >= seen[0]:
                self.cells[int(cell[j])] = (int(h[j]),
                                            tuple(colour[j].tolist()))
        # rows: a voxel's points take its free rows in order, then each
        # replaces the row drawn for it; the last write of a row wins
        order = np.argsort(slot, kind="stable")
        ss = slot[order]
        start = np.r_[0, np.nonzero(ss[1:] != ss[:-1])[0] + 1]
        rank = np.empty(len(ss), np.int64)
        rank[order] = n - np.repeat(start, np.diff(np.r_[start, len(ss)]))
        k = self.count[slot] + rank
        full = k >= K
        self.replaced += int(full.sum())
        k = np.where(full, rk, k)
        np.maximum.at(self.count, slot, np.minimum(self.count[slot] + rank
                                                   + 1, K))
        key = slot * K + k
        _, lastw = np.unique(key[::-1], return_index=True)
        w = len(key) - 1 - lastw
        self.feats[slot[w], k[w]] = tokens[fb[w], vv[w], uu[w]]
