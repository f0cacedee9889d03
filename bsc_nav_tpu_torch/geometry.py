"""Pinhole / SE(3) / voxel-grid geometry on torch tensors.

Counterpart of ``bsc_nav_tpu/geometry.py`` with the same conventions:
point clouds are (N, 3) float32; integer grid conversion truncates toward
zero like Python's ``int()``, not floor.  Everything stays float32 (the
JAX package forces ``Precision.HIGHEST`` for these products; torch keeps
full float32 matmuls as long as TF32 stays off, which the port never
turns on).

Points on axis-aligned walls sit exactly on cell edges, so the integer
grid ids depend on the last bit of every float step.  Where the JAX
package's compiled ingest rounds in a particular way, the port rounds the
same way on every device: the world -> grid division by the cell size is
a multiply by its float32 reciprocal (XLA's rewrite of a division by a
constant), the quaternion norm is a fused multiply-add chain (XLA's CPU
reduction), and its square root is correctly rounded (taken in float64
and rounded once: PyTorch's vectorized float32 sqrt on AVX-512 CPUs is
not, and moved 670 of 4,096 norms by an ulp).  With these the port's
``quat_to_rot`` equals the JAX package's eager one bit for bit.  XLA's
jitted 3-term products are another matter: fused multiply-add chains on
some host codegens, plain products and sums on others, so no formulation
matches them everywhere; the parity tests hold those points to JAX's
within an ulp bound (``tests/torch_parity.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Intrinsics and fixed frames (host numpy, float64 -- as in the JAX package)
# ---------------------------------------------------------------------------

def camera_intrinsics(h: int, w: int, fov_deg: float = 90.0) -> np.ndarray:
    """3x3 pinhole intrinsics for a square-fov simulator camera."""
    f = w / (2.0 * np.tan(np.deg2rad(fov_deg / 2.0)))
    return np.array(
        [[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]], dtype=np.float64
    )


def patch_intrinsics(h: int, w: int) -> np.ndarray:
    """Intrinsics projecting points onto the ViT patch-token grid
    (focal w/2, principal point (w/2, h/2))."""
    return np.array(
        [[w / 2.0, 0.0, w / 2.0], [0.0, w / 2.0, h / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float64,
    )


def base_axes_transform(
    forward=(0, 0, -1), left=(-1, 0, 0), up=(0, 1, 0)
) -> np.ndarray:
    """Habitat camera axes -> robot base axes."""
    tf = np.eye(4)
    tf[0, :3] = forward
    tf[1, :3] = left
    tf[2, :3] = up
    return tf


def base_to_cam_transform(sensor_height: float) -> np.ndarray:
    """Base frame -> camera frame: 180-degree flip about x plus the sensor
    mounted ``sensor_height`` up the base y axis."""
    tf = np.eye(4)
    tf[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float64)
    tf[1, 3] = sensor_height
    return tf


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _sum_sq(q: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis as XLA's CPU reduction forms it:
    a fused multiply-add chain in index order.  Each step is exact in
    float64 and rounded once to float32, which is what an FMA does.  The
    norm of a quaternion then matches the JAX package bit for bit, which
    keeps world points that sit exactly on a cell edge (axis-aligned
    walls) in the same voxel."""
    acc = q[..., 0] * q[..., 0]
    for i in range(1, q.shape[-1]):
        acc = (q[..., i].double() ** 2 + acc.double()).to(q.dtype)
    return acc


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> 3x3 rotation (normalizing first, like
    scipy's Rotation.from_quat).  Batched over leading dims."""
    q = q / torch.sqrt(_sum_sq(q).double()).to(q.dtype)[..., None]
    x, y, z, w = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pose_vec_to_tf(pose: torch.Tensor) -> torch.Tensor:
    """(px, py, pz, qx, qy, qz, qw) -> 4x4 homogeneous transform.  Batched
    over leading dims."""
    tf = torch.zeros(pose.shape[:-1] + (4, 4), dtype=pose.dtype,
                     device=pose.device)
    tf[..., :3, :3] = quat_to_rot(pose[..., 3:7])
    tf[..., :3, 3] = pose[..., :3]
    tf[..., 3, 3] = 1.0
    return tf


def _inv(m: torch.Tensor) -> torch.Tensor:
    # inv_ex: no host sync for the singularity check (rigid transforms)
    return torch.linalg.inv_ex(m).inverse


def camera_to_world_transform(pose, inv_init_base_tf, base_transform,
                              base2cam_tf) -> torch.Tensor:
    """Camera -> allocentric-world transform: the agent pose conjugated
    into the base frame, expressed relative to the initial pose, composed
    with the base->camera mount.  ``pose`` may be batched [..., 7]."""
    habitat_tf = pose_vec_to_tf(pose)
    base_pose = base_transform @ habitat_tf @ _inv(base_transform)
    tf = inv_init_base_tf @ base_pose
    return tf @ base_transform @ base2cam_tf


def initial_base_inverse(pose0, base_transform) -> torch.Tensor:
    """inv(base @ T(pose0) @ base^-1)."""
    init = (base_transform @ pose_vec_to_tf(pose0)
            @ _inv(base_transform))
    return _inv(init)


# ---------------------------------------------------------------------------
# Grid indexing
# ---------------------------------------------------------------------------

def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """Truncate toward zero like Python int()."""
    return torch.trunc(x).to(torch.int32)


def _times_reciprocal(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as XLA compiles it for a constant c: x * float32(1 / f32(c))."""
    inv = np.float32(1.0) / np.float32(c)
    return x * torch.tensor(inv, dtype=x.dtype, device=x.device)


def world_to_grid(points: torch.Tensor, grid_size: int,
                  cell_size: float) -> torch.Tensor:
    """World (x, y, z) -> voxel (row, col, h) ids:
    row = gs/2 - int(x / cs);  col = gs/2 - int(y / cs);  h = int(z / cs)."""
    half = grid_size // 2
    row = half - _trunc_int(_times_reciprocal(points[..., 0], cell_size))
    col = half - _trunc_int(_times_reciprocal(points[..., 1], cell_size))
    hgt = _trunc_int(_times_reciprocal(points[..., 2], cell_size))
    return torch.stack([row, col, hgt], dim=-1)


def grid_in_range(rc: torch.Tensor, grid_size: int, zmin: int,
                  zmax: int) -> torch.Tensor:
    """Validity mask; height is compared against [zmin, zmax) before the
    -zmin shift."""
    row, col, hgt = rc.unbind(-1)
    return ((row >= 0) & (row < grid_size) & (col >= 0) & (col < grid_size)
            & (hgt >= zmin) & (hgt < zmax))


def project_points(intr: torch.Tensor, points: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points -> integer pixel coords, u = int(x/z - 0.5)
    truncated toward zero after the intrinsics.  Returns (px, py, z)."""
    uvw = points @ intr.to(points.dtype).T
    z = uvw[..., 2]
    u = uvw[..., 0] / z
    v = uvw[..., 1] / z
    return _trunc_int(u - 0.5), _trunc_int(v - 0.5), z


# ---------------------------------------------------------------------------
# Host (numpy) helpers
# ---------------------------------------------------------------------------

def grid_to_world_2d(grid_rc, origin_xzy, grid_size: int,
                     cell_size: float) -> np.ndarray:
    """Voxel (row, col[, h]) -> habitat world (x, z, y) at the memory
    origin's height (JAX ``geometry.py:262-272``)."""
    row, col = float(grid_rc[0]), float(grid_rc[1])
    ox, oz, oy = origin_xzy
    y = oy + (row - grid_size // 2) * cell_size
    x = ox + (col - grid_size // 2) * cell_size
    return np.array([x, oz, y])
