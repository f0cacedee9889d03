"""Batch memory pre-build across a dataset (reference
create_memory_for_dataset.py:54-137): per episode, derive scene +
navmesh island, size the exploration budget by island area
(random_move_num = area/2 + 1, :93), build by random-walk exploration,
and cache the bundle per scene+island.

  python -m bsc_nav_tpu_torch.drivers.create_memory --env fake --episodes 2

EQA variant (reference create_memory_for_eqa.py:44-82): the initial
agent state is seeded from the EQA dataset's FIRST FRAME pickle
(<frames_root>/<episode-dir>/00000.pkl -> ['agent_state']), the scene is
derived from the episode dir name, and bundles are cached per scene
(no island suffix):

  python -m bsc_nav_tpu_torch.drivers.create_memory --task eqa \\
      --eqa-frames-root data/frames/hm3d-v0

The port's counterpart of ``benchmarks/create_memory.py`` over the port's
``VoxelTokenMemory``; ``--device`` picks the card (default) or the CPU.
The bundle is the reference's HDF5 one (``memory.persistence``), so
``h5py`` is needed where a bundle is written.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle

import numpy as np

from bsc_nav_tpu_torch.drivers import common as C
from bsc_nav_tpu_torch.drivers import setup as S


def load_eqa_init_state(frames_dir: str):
    """Initial agent state from the episode's first frame pickle
    (reference create_memory_for_eqa.py:65-66).  Accepts either a
    habitat AgentState-like object (has .position/.rotation) or a plain
    dict {'position': [3], 'rotation': [x, y, z, w]}."""
    from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat

    with open(os.path.join(frames_dir, "00000.pkl"), "rb") as f:
        data = pickle.load(f)
    st = data["agent_state"] if isinstance(data, dict) else data
    if isinstance(st, dict):
        rot = st.get("rotation", (0.0, 0.0, 0.0, 1.0))
        return AgentState(np.asarray(st["position"], np.float64),
                          Quat(*[float(r) for r in rot]))
    return st


def eqa_scene_from_dirname(name: str) -> str:
    """Scene hash from an EQA frames episode dir name
    (reference create_memory_for_eqa.py:55: path.split('-')[2])."""
    parts = name.split("-")
    return parts[2] if len(parts) >= 3 else name


def build_eqa_memories(args, bench, memory) -> set:
    """Per-scene EQA prebuild, pose-seeded from the dataset frames."""
    built = set()
    ep_dirs = sorted(d for d in os.listdir(args.eqa_frames_root)
                     if os.path.isdir(os.path.join(args.eqa_frames_root, d)))
    if args.episodes:
        ep_dirs = ep_dirs[:args.episodes]
    current_scene = None
    for name in ep_dirs:
        scene = eqa_scene_from_dirname(name)
        path = os.path.join(args.memory_root, "eqa", scene)
        if path in built or os.path.exists(path):
            print(f"memory exists: {path}")
            continue
        if args.env == "habitat" and scene != current_scene:
            # EQA frames span many scenes: load THIS episode's scene
            # into the live sim before seeding the pose (otherwise every
            # bundle is built from whatever scene build_world loaded)
            memory.Env.reconfigure_scene(
                os.path.join(args.scene_prefix, scene))
            current_scene = scene
        state = load_eqa_init_state(os.path.join(args.eqa_frames_root, name))
        # island area AT the seeded pose sizes the exploration budget
        # (create_memory_for_eqa.py:76-79)
        pf = memory.Env.plnner.pathfinder
        island = pf.get_island(state.position)
        area = pf.island_area(island)
        n_moves = int(area / 2) + 1
        print(f"building {path} from seeded pose {state.position} "
              f"(random_move_num={n_moves})")
        memory.cfg = memory.cfg.replace(
            agent=dataclasses.replace(memory.cfg.agent,
                                      random_move_num=n_moves))
        memory.load_memory(init_state=state, build_map=True)
        memory.exploring_create_memory(save=False)
        memory.save(path)
        built.add(path)
        print(f"saved {int(memory.state.num_voxels)} voxels, "
              f"{len(memory.long_memory_dict)} instances -> {path}")
    return built


def main(argv=None):
    p = argparse.ArgumentParser()
    S.add_common_args(p)
    p.add_argument("--task", type=str, default="objectnav")
    p.add_argument("--eqa-frames-root", type=str, default=None,
                   help="EQA frames dataset root (episode dirs with "
                        "00000.pkl); required for --task eqa")
    args = p.parse_args(argv)

    if args.task == "eqa":
        assert args.eqa_frames_root, "--task eqa needs --eqa-frames-root"
        _, bench, memory, _ = S.build_world(args, task="eqa")
        return build_eqa_memories(args, bench, memory)

    cfg, bench, memory, extras = S.build_world(args, task="objnav")

    built = set()
    for i in range(args.episodes):
        bench.reset()
        ep = bench.current_episode
        island, area = S.island_stats(bench)
        path = C.memory_cache_path(args.memory_root, args.task,
                                   args.benchmark_dataset, ep.scene_id,
                                   island)
        if path in built or os.path.exists(path):
            print(f"memory exists: {path}")
            continue
        n_moves = int(area / 2) + 1
        print(f"building {path} (random_move_num={n_moves})")
        memory.cfg = memory.cfg.replace(
            agent=dataclasses.replace(memory.cfg.agent,
                                      random_move_num=n_moves))
        state = bench.sim.agents[0].get_state()
        memory.load_memory(init_state=state, build_map=True)
        memory.exploring_create_memory(save=False)
        memory.save(path)
        built.add(path)
        print(f"saved {int(memory.state.num_voxels)} voxels, "
              f"{len(memory.long_memory_dict)} instances -> {path}")
    return built


if __name__ == "__main__":
    main()
