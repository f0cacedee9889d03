"""Grid-based navigation mesh: islands, snapping, shortest paths, greedy
action following.

Host-side counterpart of habitat-sim's Recast/Detour pathfinder +
GreedyGeodesicFollower (used by the reference at env.py:85,131-163 and
memory_2.py:1112-1118).  The navigable surface is a 2D occupancy grid;
paths come from A* over 8-connected cells and are converted into the
discrete agent action vocabulary ('move_forward'/'turn_left'/
'turn_right'/'stop') by simulating the agent kinematics -- the same
contract the reference's follower provides.

World convention (habitat): y is up; agents move in the x-z plane; at
identity rotation the agent looks along -z; 'turn_left' is a positive
rotation about +y.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Quat:
    """Minimal quaternion with habitat-style .x/.y/.z/.w attributes."""
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    w: float = 1.0

    @staticmethod
    def from_yaw(yaw: float) -> "Quat":
        """Rotation of `yaw` radians about +y."""
        return Quat(0.0, math.sin(yaw / 2.0), 0.0, math.cos(yaw / 2.0))

    def yaw(self) -> float:
        """Heading about +y in radians."""
        siny = 2.0 * (self.w * self.y + self.x * self.z)
        cosy = 1.0 - 2.0 * (self.y * self.y + self.x * self.x)
        return math.atan2(siny, cosy)

    def as_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z, self.w])


@dataclasses.dataclass
class AgentState:
    """habitat_sim.AgentState equivalent."""
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    rotation: Quat = dataclasses.field(default_factory=Quat)


class GridPathfinder:
    """Pathfinder over a boolean navigability grid in the x-z plane."""

    def __init__(self, navigable: np.ndarray, origin_xz: Sequence[float],
                 resolution: float, floor_y: float = 0.0, seed: int = 0):
        self.nav = np.asarray(navigable, bool)
        self.origin = np.asarray(origin_xz, np.float64)  # world x,z of cell (0,0)
        self.res = float(resolution)
        self.floor_y = float(floor_y)
        self._rng = np.random.default_rng(seed)
        self._labels = self._label_islands()

    # --- coordinates -----------------------------------------------------
    def world_to_cell(self, p) -> Tuple[int, int]:
        i = int(math.floor((p[0] - self.origin[0]) / self.res))
        j = int(math.floor((p[2] - self.origin[1]) / self.res))
        return i, j

    def cell_to_world(self, i: int, j: int, y: Optional[float] = None):
        return np.array([
            self.origin[0] + (i + 0.5) * self.res,
            self.floor_y if y is None else y,
            self.origin[1] + (j + 0.5) * self.res,
        ])

    def _in_bounds(self, i, j):
        return 0 <= i < self.nav.shape[0] and 0 <= j < self.nav.shape[1]

    # --- islands (habitat pathfinder.get_island / island_area) -----------
    def _label_islands(self) -> np.ndarray:
        from scipy import ndimage
        labels, _ = ndimage.label(
            self.nav, structure=np.ones((3, 3), int))
        return labels - 1          # -1 = not navigable, islands from 0

    def get_island(self, p) -> int:
        i, j = self.world_to_cell(p)
        if not self._in_bounds(i, j):
            return -1
        return int(self._labels[i, j])

    def num_islands(self) -> int:
        return int(self._labels.max()) + 1

    def island_area(self, island: int) -> float:
        return float((self._labels == island).sum()) * self.res * self.res

    # --- queries ----------------------------------------------------------
    def is_navigable(self, p) -> bool:
        i, j = self.world_to_cell(p)
        return (self._in_bounds(i, j) and bool(self.nav[i, j])
                and abs(p[1] - self.floor_y) < 1.0)

    def get_random_navigable_point(self) -> np.ndarray:
        idx = np.argwhere(self.nav)
        i, j = idx[self._rng.integers(len(idx))]
        return self.cell_to_world(int(i), int(j))

    def snap_point(self, p, island_index: Optional[int] = None) -> np.ndarray:
        """Nearest navigable cell center (optionally on a given island)."""
        mask = self.nav if island_index is None else (
            self._labels == island_index)
        idx = np.argwhere(mask)
        if len(idx) == 0:
            return np.asarray(p, np.float64)
        ci, cj = self.world_to_cell(p)
        d = np.abs(idx[:, 0] - ci) + np.abs(idx[:, 1] - cj)
        i, j = idx[int(np.argmin(d))]
        return self.cell_to_world(int(i), int(j))

    # --- shortest path ------------------------------------------------------
    def shortest_path(self, start, goal) -> Optional[List[np.ndarray]]:
        """A* over 8-connected cells -> list of world waypoints
        (including snapped start and goal).  None if unreachable."""
        si, sj = self.world_to_cell(self.snap_point(start))
        gi, gj = self.world_to_cell(self.snap_point(goal))
        if not (self.nav[si, sj] and self.nav[gi, gj]):
            return None
        if self._labels[si, sj] != self._labels[gi, gj]:
            return None

        sqrt2 = math.sqrt(2.0)
        heur = lambda i, j: math.hypot(i - gi, j - gj)
        openq = [(heur(si, sj), 0.0, (si, sj))]
        best = {(si, sj): 0.0}
        came = {}
        moves = [(-1, 0, 1), (1, 0, 1), (0, -1, 1), (0, 1, 1),
                 (-1, -1, sqrt2), (-1, 1, sqrt2), (1, -1, sqrt2),
                 (1, 1, sqrt2)]
        found = False
        while openq:
            f, g, (i, j) = heapq.heappop(openq)
            if (i, j) == (gi, gj):
                found = True
                break
            if g > best.get((i, j), np.inf):
                continue
            for di, dj, c in moves:
                ni, nj = i + di, j + dj
                if not self._in_bounds(ni, nj) or not self.nav[ni, nj]:
                    continue
                # forbid diagonal corner-cutting
                if di and dj and not (self.nav[i + di, j] and self.nav[i, j + dj]):
                    continue
                ng = g + c
                if ng < best.get((ni, nj), np.inf):
                    best[(ni, nj)] = ng
                    came[(ni, nj)] = (i, j)
                    heapq.heappush(openq, (ng + heur(ni, nj), ng, (ni, nj)))
        if not found:
            return None
        cells = [(gi, gj)]
        while cells[-1] != (si, sj):
            cells.append(came[cells[-1]])
        cells.reverse()
        return [self.cell_to_world(i, j) for i, j in cells]

    def distance_field(self, start) -> np.ndarray:
        """Dijkstra geodesic distance (metres) from `start` to every
        navigable cell; +inf elsewhere."""
        si, sj = self.world_to_cell(self.snap_point(start))
        dist = np.full(self.nav.shape, np.inf)
        if not self.nav[si, sj]:
            return dist
        sqrt2 = math.sqrt(2.0)
        dist[si, sj] = 0.0
        openq = [(0.0, (si, sj))]
        moves = [(-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
                 (-1, -1, sqrt2), (-1, 1, sqrt2), (1, -1, sqrt2),
                 (1, 1, sqrt2)]
        while openq:
            g, (i, j) = heapq.heappop(openq)
            if g > dist[i, j]:
                continue
            for di, dj, c in moves:
                ni, nj = i + di, j + dj
                if not self._in_bounds(ni, nj) or not self.nav[ni, nj]:
                    continue
                if di and dj and not (self.nav[i + di, j] and self.nav[i, j + dj]):
                    continue
                ng = g + c
                if ng < dist[ni, nj]:
                    dist[ni, nj] = ng
                    heapq.heappush(openq, (ng, (ni, nj)))
        return dist * self.res

    def geodesic_distance(self, start, goal) -> float:
        """Habitat-style distance-to-goal: the goal may be non-navigable
        (an object's center); distance = min over navigable cells of
        (geodesic from start) + (straight-line tail to the goal)."""
        field = self.distance_field(start)
        goal = np.asarray(goal, np.float64)
        ii, jj = np.nonzero(np.isfinite(field))
        if len(ii) == 0:
            return float("inf")
        cx = self.origin[0] + (ii + 0.5) * self.res
        cz = self.origin[1] + (jj + 0.5) * self.res
        tail = np.hypot(cx - goal[0], cz - goal[2])
        return float(np.min(field[ii, jj] + tail))


def greedy_follow(state: AgentState, waypoints: List[np.ndarray],
                  move_amount: float = 0.25, turn_deg: float = 30.0,
                  goal_radius: float = 0.3, max_actions: int = 2000,
                  is_navigable=None) -> List[str]:
    """Convert a waypoint path into discrete actions by simulating the
    agent (GreedyGeodesicFollower.find_path contract: ends with 'stop').

    When `is_navigable` is given, the simulation models collisions
    exactly like the environment's step (a blocked move_forward leaves
    the agent in place), so open-loop execution of the returned actions
    reproduces the simulated trajectory.  Blocked moves trigger a turn
    toward the following waypoint; persistent blockage skips the
    waypoint.
    """
    if not waypoints:
        return ["stop"]
    pos = np.asarray(state.position, np.float64).copy()
    yaw = state.rotation.yaw()
    turn = math.radians(turn_deg)
    actions: List[str] = []
    wp_i = 0
    goal = waypoints[-1]
    blocked_streak = 0

    def target_point():
        # first waypoint further than half a step ahead
        nonlocal wp_i
        while (wp_i < len(waypoints) - 1
               and np.linalg.norm(
                   np.asarray(waypoints[wp_i])[[0, 2]] - pos[[0, 2]])
               < move_amount):
            wp_i += 1
        return np.asarray(waypoints[wp_i])

    while len(actions) < max_actions:
        if np.linalg.norm(np.asarray(goal)[[0, 2]] - pos[[0, 2]]) <= goal_radius:
            break
        t = target_point()
        d = t - pos
        desired = math.atan2(-d[0], -d[2])   # heading: -z forward, +yaw left
        diff = (desired - yaw + math.pi) % (2 * math.pi) - math.pi
        if abs(diff) > turn / 2:
            if diff > 0:
                actions.append("turn_left")
                yaw += turn
            else:
                actions.append("turn_right")
                yaw -= turn
            continue
        new_pos = pos.copy()
        new_pos[0] -= move_amount * math.sin(yaw)
        new_pos[2] -= move_amount * math.cos(yaw)
        if is_navigable is not None and not is_navigable(new_pos):
            # collision: same semantics as env.step (no motion); steer
            # toward the next waypoint, skip it if persistently blocked
            blocked_streak += 1
            if blocked_streak >= 4 and wp_i < len(waypoints) - 1:
                wp_i += 1
                blocked_streak = 0
                continue
            actions.append("turn_left" if diff >= 0 else "turn_right")
            yaw += turn if diff >= 0 else -turn
            continue
        blocked_streak = 0
        actions.append("move_forward")
        pos = new_pos
    actions.append("stop")
    return actions
