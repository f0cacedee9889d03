"""Synthetic box-world environment with raycast RGB-D rendering.

Test/bench double for habitat-sim (the reference's L0 layer): a room
with colored boxes, a navigable floor grid, and an agent with the
discrete action space of the reference (env.py:214-233: move_forward
0.25 m, turn 30 deg, look +/-15 deg).  Rendering is vectorized numpy
AABB raycasting producing habitat-convention observations:

  obs = {"rgb": uint8 [H, W, 4], "depth": float32 [H, W]}

with depth = planar z-distance in a camera frame (x right, y down,
z forward) so the backprojection chain in memory/ingest reproduces the
world geometry exactly.  This is what makes true end-to-end agent tests
possible without habitat (SURVEY §4 test plan, item c).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bsc_nav_tpu_torch.env.pathfinding import (
    AgentState, GridPathfinder, Quat, greedy_follow)


@dataclasses.dataclass
class Box:
    center: Sequence[float]          # world x, y, z
    size: Sequence[float]            # full extents
    color: Sequence[int]             # uint8 rgb
    label: str = ""


@dataclasses.dataclass
class BoxScene:
    bounds_min: Sequence[float]      # room AABB (interior)
    bounds_max: Sequence[float]
    boxes: List[Box]

    @staticmethod
    def default(seed: int = 0) -> "BoxScene":
        """A 8x8 m room with a few labeled furniture boxes."""
        return BoxScene(
            bounds_min=(-4.0, 0.0, -4.0),
            bounds_max=(4.0, 3.0, 4.0),
            boxes=[
                Box((2.5, 0.4, 2.5), (1.2, 0.8, 1.2), (200, 30, 30), "bed"),
                Box((-2.8, 0.5, -2.6), (0.8, 1.0, 0.8), (30, 180, 40), "plant"),
                Box((2.6, 0.35, -2.7), (1.0, 0.7, 0.6), (40, 60, 220), "sofa"),
                Box((-2.6, 0.5, 2.7), (0.7, 1.0, 0.5), (230, 220, 40), "tv monitor"),
                Box((0.0, 0.25, -1.2), (0.8, 0.5, 0.8), (150, 90, 40), "table"),
            ],
        )


def _make_navgrid(scene: BoxScene, resolution: float = 0.2,
                  agent_radius: float = 0.2) -> GridPathfinder:
    bmin = np.asarray(scene.bounds_min)
    bmax = np.asarray(scene.bounds_max)
    nx = int(round((bmax[0] - bmin[0]) / resolution))
    nz = int(round((bmax[2] - bmin[2]) / resolution))
    nav = np.ones((nx, nz), bool)
    # margin against the walls
    m = max(1, int(round(agent_radius / resolution)))
    nav[:m], nav[-m:], nav[:, :m], nav[:, -m:] = False, False, False, False
    xs = bmin[0] + (np.arange(nx) + 0.5) * resolution
    zs = bmin[2] + (np.arange(nz) + 0.5) * resolution
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    for b in scene.boxes:
        c, s = np.asarray(b.center), np.asarray(b.size) / 2
        blocked = ((np.abs(X - c[0]) < s[0] + agent_radius)
                   & (np.abs(Z - c[2]) < s[2] + agent_radius)
                   & (c[1] - s[1] < 1.2))   # only obstacles near the floor
        nav &= ~blocked
    return GridPathfinder(nav, (bmin[0], bmin[2]), resolution, floor_y=0.0)


class _Renderer:
    """Vectorized AABB raycaster."""

    def __init__(self, scene: BoxScene, h: int, w: int, hfov_deg: float):
        self.scene = scene
        self.h, self.w = h, w
        f = w / (2.0 * math.tan(math.radians(hfov_deg) / 2.0))
        u = (np.arange(w) + 0.5 - w / 2.0) / f
        v = (np.arange(h) + 0.5 - h / 2.0) / f
        V, U = np.meshgrid(v, u, indexing="ij")
        self.U, self.V = U.reshape(-1), V.reshape(-1)
        # precompute box arrays
        self.bmin = np.array([np.asarray(b.center) - np.asarray(b.size) / 2
                              for b in scene.boxes])
        self.bmax = np.array([np.asarray(b.center) + np.asarray(b.size) / 2
                              for b in scene.boxes])
        self.colors = np.array([b.color for b in scene.boxes], np.uint8)

    def render(self, cam_pos: np.ndarray, yaw: float, pitch: float,
               max_depth: float = 50.0) -> Tuple[np.ndarray, np.ndarray]:
        fwd = np.array([-math.sin(yaw), 0.0, -math.cos(yaw)])
        right = np.array([math.cos(yaw), 0.0, -math.sin(yaw)])
        up = np.array([0.0, 1.0, 0.0])
        # pitch about the right axis (look_up positive)
        fwd_p = math.cos(pitch) * fwd + math.sin(pitch) * up
        up_p = math.cos(pitch) * up - math.sin(pitch) * fwd

        # unnormalized rays with unit forward component: t == planar depth
        rays = (self.U[:, None] * right[None]
                - self.V[:, None] * up_p[None]
                + fwd_p[None])                              # [N, 3]
        N = rays.shape[0]
        t_hit = np.full(N, np.inf)
        color = np.zeros((N, 3), np.uint8)

        inv = np.where(np.abs(rays) > 1e-9, 1.0 / rays, 1e12)

        # boxes
        for k in range(len(self.bmin)):
            t0 = (self.bmin[k][None] - cam_pos[None]) * inv
            t1 = (self.bmax[k][None] - cam_pos[None]) * inv
            tmin = np.minimum(t0, t1).max(axis=1)
            tmax = np.maximum(t0, t1).min(axis=1)
            hit = (tmax >= np.maximum(tmin, 1e-6)) & (tmin < t_hit)
            t_hit = np.where(hit, tmin, t_hit)
            color[hit] = self.colors[k]

        # room interior: exit point of the ray
        bmin = np.asarray(self.scene.bounds_min)
        bmax = np.asarray(self.scene.bounds_max)
        t0 = (bmin[None] - cam_pos[None]) * inv
        t1 = (bmax[None] - cam_pos[None]) * inv
        texit_per_axis = np.maximum(t0, t1)
        texit = texit_per_axis.min(axis=1)
        axis = texit_per_axis.argmin(axis=1)
        wall_colors = np.array(
            [[205, 200, 195],     # x walls
             [110, 105, 100],     # floor/ceiling (y)
             [185, 190, 200]],    # z walls
            np.uint8)
        hit = (texit > 1e-6) & (texit < t_hit)
        t_hit = np.where(hit, texit, t_hit)
        color[hit] = wall_colors[axis[hit]]
        # make the floor darker than the ceiling
        floor_hit = hit & (axis == 1) & (rays[:, 1] < 0)
        color[floor_hit] = np.array([90, 85, 80], np.uint8)

        depth = np.where(np.isfinite(t_hit), t_hit, max_depth).astype(np.float32)
        rgb = np.concatenate(
            [color, np.full((N, 1), 255, np.uint8)], axis=1)
        return (rgb.reshape(self.h, self.w, 4),
                depth.reshape(self.h, self.w))


class _FakeSims:
    """Duck-types the habitat_sim.Simulator surface used by the agents
    (step / get_sensor_observations) -- see reference memory_2.py:1032,
    :1060, :1090."""

    def __init__(self, env: "FakeNavEnv"):
        self.env = env
        self.pathfinder = env.pathfinder

    def get_sensor_observations(self, agent_id: int = 0):
        return self.env._observe()

    def step(self, action: str):
        return self.env.step(action)


class _FakeAgent:
    def __init__(self, env: "FakeNavEnv"):
        self.env = env

    def get_state(self) -> AgentState:
        return AgentState(self.env.position.copy(),
                          Quat.from_yaw(self.env.yaw))

    def set_state(self, state: AgentState):
        self.env.position = np.asarray(state.position, np.float64).copy()
        self.env.yaw = state.rotation.yaw()
        self.env.pitch = 0.0


class _FakePlanner:
    """GreedyGeodesicFollower surface (find_path) + .pathfinder."""

    def __init__(self, env: "FakeNavEnv"):
        self.env = env
        self.pathfinder = env.pathfinder

    def find_path(self, goal) -> List[str]:
        wps = self.pathfinder.shortest_path(self.env.position, goal)
        if wps is None:
            raise RuntimeError("no path to goal")
        state = AgentState(self.env.position.copy(),
                           Quat.from_yaw(self.env.yaw))
        return greedy_follow(
            state, wps,
            move_amount=self.env.move_amount,
            turn_deg=self.env.turn_deg,
            is_navigable=self.pathfinder.is_navigable)


class FakeNavEnv:
    """Mirror of the reference NavEnv (env.py:49-163) over the box world.

    Exposes: .sims (step/get_sensor_observations), .agent
    (get_state/set_state), .plnner (find_path + .pathfinder),
    .original_state, .reset, .move2point, .get_navigable_point_near.
    """

    def __init__(self, cfg, scene: Optional[BoxScene] = None,
                 init_state: Optional[AgentState] = None,
                 build_map: bool = False, seed: int = 0):
        self.cfg = cfg
        self.scene = scene or BoxScene.default()
        self.move_amount = cfg.actions.move_forward
        self.turn_deg = cfg.actions.turn_left_deg
        self.look_deg = cfg.actions.look_deg
        self.sensor_height = cfg.sensor.sensor_height
        self.pathfinder = _make_navgrid(self.scene)
        self.pathfinder._rng = np.random.default_rng(seed)
        self._renderer = _Renderer(
            self.scene, cfg.sensor.height, cfg.sensor.width,
            cfg.sensor.hfov_deg)

        self.position = np.zeros(3)
        self.yaw = 0.0
        self.pitch = 0.0
        self._place(init_state, build_map)

        self.sims = _FakeSims(self)
        self.agent = _FakeAgent(self)
        self.plnner = _FakePlanner(self)
        self.original_state = self.agent.get_state()

    def _place(self, init_state, build_map):
        if init_state is not None:
            self.position = np.asarray(init_state.position, np.float64).copy()
            # build-map mode zeroes the rotation (reference env.py:66-70)
            self.yaw = 0.0 if build_map else init_state.rotation.yaw()
        else:
            self.position = self.pathfinder.get_random_navigable_point()
            self.yaw = 0.0
        self.pitch = 0.0

    def reset(self, cfg=None, init_state=None, build_map=False):
        if cfg is not None:
            self.cfg = cfg
        self._place(init_state, build_map)
        self.original_state = self.agent.get_state()

    # --- observation / stepping -------------------------------------------
    def _observe(self) -> Dict[str, np.ndarray]:
        cam = self.position + np.array([0.0, self.sensor_height, 0.0])
        rgb, depth = self._renderer.render(cam, self.yaw, self.pitch)
        return {"rgb": rgb, "depth": depth}

    def step(self, action: str) -> Dict[str, np.ndarray]:
        if action == "move_forward":
            d = np.array([-math.sin(self.yaw), 0.0, -math.cos(self.yaw)])
            new = self.position + self.move_amount * d
            if self.pathfinder.is_navigable(new):
                self.position = new
            # else: blocked (sliding disabled), stay
        elif action == "move_backward":
            d = np.array([-math.sin(self.yaw), 0.0, -math.cos(self.yaw)])
            new = self.position - 0.1 * d
            if self.pathfinder.is_navigable(new):
                self.position = new
        elif action == "turn_left":
            self.yaw += math.radians(self.turn_deg)
        elif action == "turn_right":
            self.yaw -= math.radians(self.turn_deg)
        elif action == "look_up":
            self.pitch = min(self.pitch + math.radians(self.look_deg),
                             math.radians(60))
        elif action == "look_down":
            self.pitch = max(self.pitch - math.radians(self.look_deg),
                             -math.radians(60))
        elif action == "stop":
            pass
        else:
            raise ValueError(f"unknown action {action!r}")
        return self._observe()

    # --- planning (reference env.py:131-163) -------------------------------
    def get_navigable_point_near(self, circle_center, max_tries: int = 500):
        island = self.pathfinder.get_island(self.position)
        return self.pathfinder.snap_point(circle_center, island_index=island)

    def move2point(self, goal):
        goal = np.asarray(goal, np.float64)
        if not self.pathfinder.is_navigable(goal):
            goal = self.get_navigable_point_near(goal)
        path = self.plnner.find_path(goal)
        return path, goal

    def agent_pose_vec(self) -> np.ndarray:
        """(px,py,pz,qx,qy,qz,qw) pose vector of the current agent state."""
        q = Quat.from_yaw(self.yaw)
        return np.array([*self.position, q.x, q.y, q.z, q.w], np.float32)
