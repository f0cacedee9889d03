"""Benchmark environment protocol + fake implementation.

The drivers evaluate agents against a habitat.Env-like surface
(reference objnav_benchmark.py: benchmark_env.reset/step/get_metrics/
current_episode/sim.agents[0]).  This module defines that surface as a
protocol and provides:

  - FakeBenchmarkEnv: episodes over the synthetic box world with
    success / SPL / distance_to_goal computed from grid geodesics --
    the habitat Measure outputs the drivers record
    (objnav_benchmark.py:1309-1321).
  - (habitat adapter lives in env/habitat_env.py, import-gated.)

Copy of ``bsc_nav_tpu/env/benchmark.py``, which imports no JAX, over the
port's copies of ``env/{fake,pathfinding,vlnce_maps}.py``
(``tests/test_torch_host_copies.py`` holds the two equal).  The habitat
adapter is not ported (no habitat-sim on either machine).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat


@dataclasses.dataclass
class Episode:
    scene_id: str
    object_category: str
    start_position: Sequence[float]
    start_yaw: float
    goal_positions: List[Sequence[float]]       # acceptable goal locations
    instruction: Optional[str] = None           # VLN
    question: Optional[str] = None              # EQA
    goal_image: Optional[np.ndarray] = None     # imagenav
    intrinsic_attributes: Optional[str] = None  # textnav
    extrinsic_attributes: Optional[str] = None
    scene_dataset_config: str = ""


class BenchmarkEnv(Protocol):
    def reset(self): ...
    def step(self, action: str): ...
    def get_metrics(self) -> Dict: ...
    @property
    def current_episode(self) -> Episode: ...


class _SimFacade:
    """habitat Env.sim surface used by the robots (sim.agents[0],
    sim.get_sensor_observations, sim.pathfinder)."""

    def __init__(self, env: FakeNavEnv):
        self._env = env
        self.agents = [env.agent]
        self.pathfinder = env.pathfinder

    def get_sensor_observations(self, agent_id: int = 0):
        return self._env.sims.get_sensor_observations(agent_id)


class FakeBenchmarkEnv:
    """Episode-iterating benchmark env over the fake box world with
    habitat-style metrics."""

    def __init__(self, cfg, episodes: List[Episode],
                 scene: Optional[BoxScene] = None,
                 success_distance: float = 1.0, seed: int = 0,
                 topdown: str = "fog"):
        self.cfg = cfg
        self.episodes = episodes
        self.success_distance = success_distance
        self._env = FakeNavEnv(cfg, scene=scene, seed=seed)
        self.sim = _SimFacade(self._env)
        self._ep_idx = -1
        self.episode_over = False
        self._path_length = 0.0
        self._shortest = float("inf")
        self._called_stop = False
        self._min_dist = float("inf")
        self._len_at_min = 0.0
        self.topdown_kind = topdown
        if topdown == "vlnce":
            # connectivity-graph measure (reference vlnce_maps.py:382-614)
            from bsc_nav_tpu_torch.env.vlnce_maps import (
                TopDownMapVLNCE, sample_connectivity_graph)
            pf = self._env.pathfinder
            self.top_down_map = TopDownMapVLNCE(
                pf, graph=sample_connectivity_graph(pf))
        else:
            self.top_down_map = TopDownMapMeasure(self._env)

    # --- episode control ---------------------------------------------------
    @property
    def current_episode(self) -> Episode:
        return self.episodes[self._ep_idx % len(self.episodes)]

    @property
    def nav_env(self) -> FakeNavEnv:
        return self._env

    def reset(self):
        self._ep_idx += 1
        ep = self.current_episode
        self._env.agent.set_state(AgentState(
            np.asarray(ep.start_position, np.float64),
            Quat.from_yaw(ep.start_yaw)))
        self._env.pitch = 0.0
        self.episode_over = False
        self._called_stop = False
        self._path_length = 0.0
        self._min_dist = float("inf")
        self._len_at_min = 0.0
        self._shortest = min(
            (self._env.pathfinder.geodesic_distance(
                ep.start_position, g) for g in ep.goal_positions),
            default=float("inf"))
        if self.topdown_kind == "vlnce":
            goal = (ep.goal_positions[0] if ep.goal_positions
                    else ep.start_position)
            self.top_down_map.reset(ep.start_position, goal,
                                    start_yaw=ep.start_yaw)
            self.top_down_map.update(self._env.position, self._env.yaw)
        else:
            self.top_down_map.reset()
            self.top_down_map.update()
        return self._env.sims.get_sensor_observations(0)

    def step(self, action: str):
        prev = self._env.position.copy()
        obs = self._env.step(action)
        if self.topdown_kind == "vlnce":
            self.top_down_map.update(self._env.position, self._env.yaw)
        else:
            self.top_down_map.update()
        moved = float(np.linalg.norm(self._env.position - prev))
        self._path_length += moved
        if moved > 0:
            d = self._distance_to_goal()
            if d < self._min_dist:
                self._min_dist = d
                self._len_at_min = self._path_length
        if action == "stop":
            self.episode_over = True
            self._called_stop = True
        return obs

    # --- metrics (habitat success/spl/distance_to_goal semantics) ----------
    def _distance_to_goal(self) -> float:
        ep = self.current_episode
        return min(
            (self._env.pathfinder.geodesic_distance(
                self._env.position, g) for g in ep.goal_positions),
            default=float("inf"))

    def get_metrics(self) -> Dict:
        d = self._distance_to_goal()
        success = float(self._called_stop and d <= self.success_distance)
        spl = 0.0
        if success and np.isfinite(self._shortest):
            spl = self._shortest / max(self._shortest, self._path_length, 1e-6)
        # OracleSPL: SPL under oracle stopping at the best point visited
        # (reference vlnce_maps.py:26-43 OracleSPL measure)
        o_success = float(min(self._min_dist, d) <= self.success_distance)
        ospl = 0.0
        if o_success and np.isfinite(self._shortest):
            ospl = self._shortest / max(self._shortest, self._len_at_min, 1e-6)
        return {
            "success": success,
            "spl": spl,
            "oracle_spl": ospl,
            "distance_to_goal": d,
            "path_length": self._path_length,
            "top_down_map": (
                self.top_down_map.render() if self.topdown_kind == "vlnce"
                else self.top_down_map.render(
                    self.current_episode.goal_positions)),
        }


def episodes_for_scene(scene: BoxScene, n_per_object: int = 1,
                       start=(0.0, 0.0, 0.0), seed: int = 0
                       ) -> List[Episode]:
    """One episode per labeled box (test/demo dataset factory)."""
    rng = np.random.default_rng(seed)
    eps = []
    for box in scene.boxes:
        for _ in range(n_per_object):
            eps.append(Episode(
                scene_id="box_world",
                object_category=box.label,
                start_position=np.asarray(start, float),
                start_yaw=float(rng.uniform(-np.pi, np.pi)),
                goal_positions=[np.asarray(box.center, float)],
            ))
    return eps


class TopDownMapMeasure:
    """Fog-of-war top-down map over the navgrid (the habitat
    TopDownMap / TopDownMapVLNCE measure role, reference env.py:514-532,
    vlnce_maps.py:381): navigable area in light gray, revealed area in
    white, agent trail in blue, agent + goals marked.  Produces uint8
    frames for the drivers' topdown videos."""

    NAV = np.array([140, 140, 140], np.uint8)
    SEEN = np.array([245, 245, 245], np.uint8)
    TRAIL = np.array([60, 60, 220], np.uint8)
    AGENT = np.array([200, 40, 40], np.uint8)
    GOAL = np.array([40, 180, 40], np.uint8)

    def __init__(self, env: FakeNavEnv, visibility_dist: float = 5.0,
                 fov_deg: float = 90.0):
        self.env = env
        pf = env.pathfinder
        self.pf = pf
        self.vis_cells = int(visibility_dist / pf.res)
        self.fov = np.radians(fov_deg)
        self.seen = np.zeros(pf.nav.shape, bool)
        self.trail: List = []

    def reset(self):
        self.seen[:] = False
        self.trail = []

    def update(self):
        pf = self.pf
        i, j = pf.world_to_cell(self.env.position)
        self.trail.append((i, j))
        yaw = self.env.yaw
        # reveal a FOV wedge (fog of war)
        n = self.vis_cells
        ii, jj = np.mgrid[-n:n + 1, -n:n + 1]
        dist = np.hypot(ii, jj)
        # world heading: forward is (-sin yaw, -cos yaw) in (x, z) = (i, j)
        ang = np.arctan2(ii, jj)          # cell offset direction
        fwd = np.arctan2(-np.sin(yaw), -np.cos(yaw))
        diff = (ang - fwd + np.pi) % (2 * np.pi) - np.pi
        wedge = (dist <= n) & (np.abs(diff) <= self.fov / 2)
        ci, cj = np.nonzero(wedge)
        gi = np.clip(ci - n + i, 0, pf.nav.shape[0] - 1)
        gj = np.clip(cj - n + j, 0, pf.nav.shape[1] - 1)
        self.seen[gi, gj] = True

    def render(self, goals=()) -> np.ndarray:
        pf = self.pf
        img = np.zeros((*pf.nav.shape, 3), np.uint8)
        img[pf.nav] = self.NAV
        img[pf.nav & self.seen] = self.SEEN
        for (i, j) in self.trail:
            if 0 <= i < img.shape[0] and 0 <= j < img.shape[1]:
                img[i, j] = self.TRAIL
        for g in goals:
            gi, gj = pf.world_to_cell(g)
            img[max(gi - 1, 0):gi + 2, max(gj - 1, 0):gj + 2] = self.GOAL
        i, j = pf.world_to_cell(self.env.position)
        img[max(i - 1, 0):i + 2, max(j - 1, 0):j + 2] = self.AGENT
        return img
