"""Episode dataset loaders (habitat-independent).

Host copy of ``bsc_nav_tpu/env/datasets.py`` on the port's
``env/benchmark.Episode``; it imports nothing of the JAX package.

Parses the public episode formats the reference consumes through
habitat-lab's registry into this framework's Episode records:

  - ObjectNav v1/v2 val splits (json.gz; goals either inline or
    deduplicated under ``goals_by_category`` -- the pattern the
    reference's OVONDatasetV1 re-implements, reference env.py:321-428);
  - OVON (open-vocab) episodes: same dedup layout, child categories kept;
  - VLN-CE R2R episodes (instruction.instruction_text);
  - OpenEQA HM3D subset question json (reference agent_eqa.py:273-311).

Having these parsed natively lets every driver iterate real episode
datasets even when habitat is only used as the renderer (or not at all
for offline analysis).
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional

import numpy as np

from bsc_nav_tpu_torch.env.benchmark import Episode


def _read_json_maybe_gz(path: str) -> Dict:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return json.load(f)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _quat_to_yaw(q) -> float:
    """habitat start_rotation [x, y, z, w] -> yaw about +y (shared
    formula: env.pathfinding.Quat.yaw)."""
    from bsc_nav_tpu_torch.env.pathfinding import Quat
    return Quat(*q).yaw()


def _goal_positions(ep: Dict, goals_by_category: Dict) -> List:
    goals = ep.get("goals") or []
    if not goals and goals_by_category:
        key = ep.get("goals_key")
        if key is None:
            # habitat goals_key convention: "{scene_basename}_{category}"
            scene = os.path.basename(ep["scene_id"])
            key = f"{scene}_{ep.get('object_category', '')}"
        goals = goals_by_category.get(key, [])
    out = []
    for g in goals:
        if isinstance(g, dict) and "position" in g:
            out.append(np.asarray(g["position"], float))
    return out


def load_objectnav_episodes(path: str,
                            limit: Optional[int] = None) -> List[Episode]:
    """ObjectNav/OVON val split -> Episode list."""
    data = _read_json_maybe_gz(path)
    gbc = data.get("goals_by_category", {})
    episodes = []
    for ep in data.get("episodes", []):
        category = ep.get("object_category")
        if category is None and ep.get("goals"):
            g0 = ep["goals"][0]
            category = g0.get("object_category") if isinstance(g0, dict) \
                else None
        episodes.append(Episode(
            scene_id=ep.get("scene_id", ""),
            object_category=category or "",
            start_position=np.asarray(ep["start_position"], float),
            start_yaw=_quat_to_yaw(ep.get("start_rotation", [0, 0, 0, 1])),
            goal_positions=_goal_positions(ep, gbc),
            scene_dataset_config=ep.get("scene_dataset_config", ""),
        ))
        if limit and len(episodes) >= limit:
            break
    return episodes


# OVON uses the identical dedup layout with children categories
load_ovon_episodes = load_objectnav_episodes


def load_r2r_episodes(path: str,
                      limit: Optional[int] = None) -> List[Episode]:
    """VLN-CE R2R split -> Episode list (instruction text included)."""
    data = _read_json_maybe_gz(path)
    episodes = []
    for ep in data.get("episodes", []):
        instr = ep.get("instruction", {})
        text = instr.get("instruction_text") if isinstance(instr, dict) \
            else str(instr)
        episodes.append(Episode(
            scene_id=ep.get("scene_id", ""),
            object_category="",
            start_position=np.asarray(ep["start_position"], float),
            start_yaw=_quat_to_yaw(ep.get("start_rotation", [0, 0, 0, 1])),
            goal_positions=[np.asarray(g["position"], float)
                            for g in ep.get("goals", [])
                            if isinstance(g, dict) and "position" in g],
            instruction=text,
        ))
        if limit and len(episodes) >= limit:
            break
    return episodes


def load_eqa_questions(path: str,
                       limit: Optional[int] = None) -> List[Dict]:
    """OpenEQA subset json -> [{question_id, question, episode_history,
    scene}] (reference agent_eqa.py:273,309-311 scene derivation)."""
    data = _read_json_maybe_gz(path)
    out = []
    for item in data:
        scene = item.get("episode_history", "").split("-")[-1]
        out.append({
            "question_id": item.get("question_id"),
            "question": item.get("question"),
            "episode_history": item.get("episode_history", ""),
            "scene": scene,
            "answer": item.get("answer"),
        })
        if limit and len(out) >= limit:
            break
    return out
