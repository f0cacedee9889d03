"""A seeded furnished room, and a patrol through it in the habitat
agent's discrete actions, rendered on the card as RGB-D frames.

The room is a closed box (floor, ceiling, four walls) of a fixed
footprint with boxes of furniture against its walls and inside the
patrol's loop, all textured by checkers.  The seed draws the furniture,
the colours, the ceiling's height and where the room's walls fall
against the voxel grid (a sub-cell offset), as a real scene's surfaces
fall anywhere.  The floor lies at the agent's feet, y = 0.

The patrol is a sequence of the actions BSC-Nav gives the agent
(MOVE_FORWARD 0.25 m, TURN_LEFT / TURN_RIGHT 30 degrees), one RGB-D frame
a step: a look-around of twelve left turns at the start, then a loop
along the room, forward legs joined by three left turns, back to the
start.  The loop's poses are the bank rendered once in set-up; the walk
repeats the loop, so it revisits every place it has seen.

Coordinates are habitat's (x right, y up, z backwards; the agent starts
at the origin facing -z and yaws about y), and the camera is a pinhole of
the sensor's size and field of view whose depth is the distance along its
optical axis, as habitat's depth sensor gives it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

CELL = 0.1


def actions(p: Dict) -> list:
    """The loop as action names, one frame after each."""
    turn = ["turn_left"] * 3
    out = ["turn_left"] * p["look_around_turns"]
    for leg in (p["loop_steps_z"], p["loop_steps_x"]) * 2:
        out += ["move_forward"] * leg + turn
    return out


def bank_poses(p: Dict) -> np.ndarray:
    """[N, 7] f32 poses (px, py, pz, qx, qy, qz, qw) of one loop: the
    start, then the pose after each action but the last, which returns
    the agent to the start."""
    step, turn = p["forward_m"], math.radians(p["turn_deg"])
    pos, yaw = np.zeros(3), 0.0
    out = []
    for a in actions(p):
        out.append([*pos, 0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2)])
        if a == "move_forward":
            # habitat's forward is -z turned by the yaw about y
            pos = pos + step * np.round(
                [-math.sin(yaw), 0.0, -math.cos(yaw)], 12)
        else:
            yaw += turn if a == "turn_left" else -turn
    if np.abs(pos).max() > 1e-9 or abs(math.remainder(yaw, 2 * math.pi)) \
            > 1e-9:
        raise ValueError("the loop does not return to its start")
    return np.asarray(out, np.float32)


def walk_pose(bank: np.ndarray, n: int) -> np.ndarray:
    """The pose of frame ``n`` of the walk: the loop repeated."""
    return bank[n % bank.shape[0]]


def room(p: Dict, seed: int) -> Dict:
    """The room's bounds and its furniture, drawn from ``seed``: walls
    around the loop with the traffic's margins, moved by a sub-cell
    offset; boxes [M, 2, 3] (min, max corners) against the walls, clear
    of the loop, and inside it."""
    rng = np.random.default_rng([seed, 0x500E])
    step = p["forward_m"]
    lx, lz = p["loop_steps_x"] * step, p["loop_steps_z"] * step
    mx, mz = p["margin_x_m"], p["margin_z_m"]
    off = rng.uniform(0.0, CELL, 2)
    x0, x1 = -lx - mx + off[0], mx + off[0]
    z0, z1 = -lz - mz + off[1], mz + off[1]
    y1 = rng.uniform(*p["ceiling_m"])
    boxes = []
    depth_max = min(mx, mz) - p["clearance_m"]
    for i in range(p["wall_boxes"]):
        wall = i % 4
        d = rng.uniform(0.3, depth_max)
        w = rng.uniform(0.4, 1.6)
        h = rng.uniform(0.4, min(2.0, y1 - 0.2))
        if wall < 2:                              # walls at x0 / x1
            c = rng.uniform(z0 + w / 2, z1 - w / 2)
            xs = (x0, x0 + d) if wall == 0 else (x1 - d, x1)
            boxes.append([[xs[0], 0.0, c - w / 2], [xs[1], h, c + w / 2]])
        else:                                     # walls at z0 / z1
            c = rng.uniform(x0 + w / 2, x1 - w / 2)
            zs = (z0, z0 + d) if wall == 2 else (z1 - d, z1)
            boxes.append([[c - w / 2, 0.0, zs[0]], [c + w / 2, h, zs[1]]])
    inner = p["clearance_m"] + 0.2
    for _ in range(p["centre_boxes"]):
        w, d = rng.uniform(0.5, 1.2, 2)
        h = rng.uniform(0.4, 0.9)
        cx = rng.uniform(-lx + inner + w / 2, -inner - w / 2)
        cz = rng.uniform(-lz + inner + d / 2, -inner - d / 2)
        boxes.append([[cx - w / 2, 0.0, cz - d / 2],
                      [cx + w / 2, h, cz + d / 2]])
    return {"x": (x0, x1), "z": (z0, z1), "ceiling": y1,
            "boxes": np.asarray(boxes, np.float64)}


def _rotation(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x, y, z, w) unit quaternions -> [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _checker(a: torch.Tensor, b: torch.Tensor, size: float) -> torch.Tensor:
    return ((torch.floor(a / size) + torch.floor(b / size)) % 2)


@torch.no_grad()
def render(poses: np.ndarray, p: Dict, seed: int, height: int, width: int,
           hfov_deg: float, sensor_height: float, device,
           chunk: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """RGB uint8 [N, H, W, 3] and depth f32 [N, H, W] (metres along the
    optical axis; 0 where the ray meets nothing) of the views at ``poses``,
    rendered on ``device`` and returned as host arrays."""
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    r = room(p, seed)
    boxes = torch.as_tensor(r["boxes"], **f32)                  # [M, 2, 3]
    rng = np.random.default_rng([seed, 0xC010])
    box_rgb = torch.as_tensor(rng.uniform(40, 230, (boxes.shape[0], 3)), **f32)
    wall_rgb = torch.as_tensor(rng.uniform(60, 200, (4, 3)), **f32)
    floor_rgb = torch.as_tensor(rng.uniform(50, 180, (2, 3)), **f32)

    fx = width / (2.0 * math.tan(math.radians(hfov_deg) / 2))
    u = (torch.arange(width, **f32) + 0.5 - width / 2) / fx
    v = (torch.arange(height, **f32) + 0.5 - height / 2) / fx
    # habitat camera frame: x right, y up, looking down -z
    d_cam = torch.stack(torch.broadcast_tensors(
        u[None, :], -v[:, None], -torch.ones(height, 1, **f32)), -1)

    rgbs = np.empty((len(poses), height, width, 3), np.uint8)
    depths = np.empty((len(poses), height, width), np.float32)
    for c0 in range(0, len(poses), chunk):
        pose = torch.as_tensor(poses[c0:c0 + chunk], **f32)
        R = _rotation(pose[:, 3:7])                               # [C, 3, 3]
        d = torch.einsum("cij,hwj->chwi", R, d_cam)               # [C,H,W,3]
        o = pose[:, None, None, :3] + torch.tensor(
            [0.0, sensor_height, 0.0], **f32)
        inf = torch.full(d.shape[:-1], float("inf"), **f32)
        t_best = inf.clone()
        rgb = torch.zeros(d.shape, **f32)
        dx, dy, dz = d.unbind(-1)
        ox, oy, oz = o.unbind(-1)

        def take(t, colour):
            nonlocal t_best, rgb
            hit = (t > 1e-4) & (t < t_best)
            t_best = torch.where(hit, t, t_best)
            rgb = torch.where(hit[..., None], colour, rgb)

        # floor and ceiling
        for yp, tone in ((0.0, floor_rgb), (r["ceiling"], None)):
            t = torch.where(dy != 0, (yp - oy) / dy, inf)
            px, pz = ox + t * dx, oz + t * dz
            if tone is None:
                col = torch.full(d.shape, 215.0, **f32)
            else:
                k = _checker(px, pz, 0.4)[..., None]
                col = tone[0] * (1 - k) + tone[1] * k
            take(t, col)
        # walls: x0, x1 (checkered along z), z0, z1 (along x)
        for side, xp in enumerate(r["x"]):
            t = torch.where(dx != 0, (xp - ox) / dx, inf)
            k = _checker(oz + t * dz, (oy + t * dy) * 0.5, 0.8)[..., None]
            take(t, wall_rgb[side] * (0.8 + 0.2 * k))
        for side, zp in enumerate(r["z"]):
            t = torch.where(dz != 0, (zp - oz) / dz, inf)
            k = _checker(ox + t * dx, (oy + t * dy) * 0.5, 0.8)[..., None]
            take(t, wall_rgb[2 + side] * (0.8 + 0.2 * k))
        # furniture
        safe = lambda a: torch.where(a == 0, torch.full_like(a, 1e-12), a)
        idx, idy, idz = 1 / safe(dx), 1 / safe(dy), 1 / safe(dz)
        for b in range(boxes.shape[0]):
            lo, hi = boxes[b, 0], boxes[b, 1]
            tx0, tx1 = (lo[0] - ox) * idx, (hi[0] - ox) * idx
            ty0, ty1 = (lo[1] - oy) * idy, (hi[1] - oy) * idy
            tz0, tz1 = (lo[2] - oz) * idz, (hi[2] - oz) * idz
            tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                             torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
            tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                             torch.maximum(ty0, ty1)),
                               torch.maximum(tz0, tz1))
            t = torch.where((tn <= tf) & (tn > 1e-4), tn, inf)
            hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
            kk = _checker(hx + hz, hy, 0.2)[..., None]
            take(t, box_rgb[b] * (0.75 + 0.25 * kk))
        hit = torch.isfinite(t_best)
        depth = torch.where(hit, t_best, torch.zeros_like(t_best))
        rgbs[c0:c0 + chunk] = rgb.clamp(0, 255).round().to(
            torch.uint8).cpu().numpy()
        depths[c0:c0 + chunk] = depth.cpu().numpy()
    return rgbs, depths
