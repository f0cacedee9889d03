"""Dynamic-object navigation tasks.

Host copy of ``bsc_nav_tpu/env/dynamic.py`` over the port's ``env/fake``;
it imports nothing of the JAX package.

Counterpart of the reference's WIP dynamic task layer (reference
dynamic_tasks/D_env.py:16-152): an environment whose labeled objects are
relocated periodically during operation (the reference mutates rigid
object poses every 5 s while mapping), a task iterator over the dynamic
objects, and a success metric that evaluates against the objects'
CURRENT positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from bsc_nav_tpu_torch.env.fake import (
    BoxScene, FakeNavEnv, _make_navgrid, _Renderer)


class DynamicFakeNavEnv(FakeNavEnv):
    """Fake env whose boxes teleport every `mutate_every` steps
    (D_env.py mutates object poses on a 5 s timer; steps are the
    simulation clock here)."""

    def __init__(self, cfg, scene: Optional[BoxScene] = None,
                 mutate_every: int = 50, seed: int = 0, **kwargs):
        super().__init__(cfg, scene=scene, seed=seed, **kwargs)
        self.mutate_every = mutate_every
        self._steps = 0
        self._mut_rng = np.random.default_rng(seed + 1)
        self.mutation_count = 0

    def _relocate_objects(self) -> None:
        bmin = np.asarray(self.scene.bounds_min)
        bmax = np.asarray(self.scene.bounds_max)
        for box in self.scene.boxes:
            size = np.asarray(box.size)
            lo = bmin[[0, 2]] + size[[0, 2]] / 2 + 0.3
            hi = bmax[[0, 2]] - size[[0, 2]] / 2 - 0.3
            x, z = self._mut_rng.uniform(lo, hi)
            box.center = (float(x), float(box.center[1]), float(z))
        # world changed: rebuild renderer + navgrid
        self._renderer = _Renderer(
            self.scene, self.cfg.sensor.height, self.cfg.sensor.width,
            self.cfg.sensor.hfov_deg)
        old_rng = self.pathfinder._rng
        self.pathfinder = _make_navgrid(self.scene)
        self.pathfinder._rng = old_rng
        self.sims.pathfinder = self.pathfinder
        self.plnner.pathfinder = self.pathfinder
        self.mutation_count += 1

    def step(self, action: str):
        obs = super().step(action)
        self._steps += 1
        if self.mutate_every and self._steps % self.mutate_every == 0:
            self._relocate_objects()
        return obs


@dataclasses.dataclass
class DynamicTask:
    object_category: str
    success_distance: float = 1.5


class DynamicTaskIterator:
    """Iterate navigation tasks over the scene's dynamic objects
    (D_env.py task iterator); success measured against the object's
    CURRENT location."""

    def __init__(self, env: DynamicFakeNavEnv,
                 success_distance: float = 1.5):
        self.env = env
        self.success_distance = success_distance
        self._i = -1

    def __iter__(self):
        return self

    def __next__(self) -> DynamicTask:
        self._i += 1
        boxes = self.env.scene.boxes
        if self._i >= len(boxes):
            raise StopIteration
        return DynamicTask(boxes[self._i].label, self.success_distance)

    def current_goal_position(self, task: DynamicTask) -> np.ndarray:
        for b in self.env.scene.boxes:
            if b.label == task.object_category:
                return np.asarray(b.center)
        raise KeyError(task.object_category)

    def evaluate(self, task: DynamicTask) -> Dict:
        goal = self.current_goal_position(task)
        d = self.env.pathfinder.geodesic_distance(self.env.position, goal)
        return {
            "success": float(d <= task.success_distance),
            "distance_to_goal": float(d),
            "object_goal": task.object_category,
            "mutations": self.env.mutation_count,
        }
