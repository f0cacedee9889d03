"""World construction for the port's episode drivers.

Counterpart of ``benchmarks/setup.py``: builds (cfg, bench_env, memory,
robot deps) from CLI flags.  Two backends, both on ``--device`` (the card
unless the caller asks for the CPU):

  --env fake     the synthetic box world, the port's ``VoxelTokenMemory``,
                 the colour matchers and detector (whatever ``--detector``
                 says, as in the JAX package), the scene imagination;
  --env habitat  habitat-sim scenes (``env/habitat_env.build_habitat_world``:
                 the bf16 DINOv2 perception and, from the converted weights
                 under ``--weights-dir``, the MetaCLIP matcher, the patch
                 detector or with ``--detector grounding-dino`` Grounding
                 DINO, the SD3.5 imagination); it raises ImportError where
                 habitat-sim is not installed.

The judge is the mock oracle LLM, an OpenAI-compatible endpoint, or with
``--llm local --weights-dir <dir>`` the in-process Qwen2.5-VL
(``agents/local_vlm.py``; W8A8 decoder unless ``--int8`` leaves out
``llm``), so that every driver runs offline on the fake world.

``python -m bsc_nav_tpu_torch.drivers.setup --check`` is the readiness
check (``readiness_check``, JAX ``benchmarks/setup.py:318``).  The JAX
module's platform and compile-cache set-up is TPU only.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import math
import os
import re
import subprocess
import tempfile
from typing import Tuple

import numpy as np
import torch

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.agents import llm as L
from bsc_nav_tpu_torch.agents.matchers import ColorViewScorer
from bsc_nav_tpu_torch.agents.spatial_memory import (
    Perception, VoxelTokenMemory)
from bsc_nav_tpu_torch.config import (
    AgentConfig, Config, MemoryConfig, QueryConfig, SensorConfig)
from bsc_nav_tpu_torch.env.benchmark import (
    FakeBenchmarkEnv, episodes_for_scene)
from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.models.detector import ColorPrototypeDetector

FAKE_PROTOTYPES = {
    "bed": (200, 30, 30),
    "plant": (30, 180, 40),
    "sofa": (40, 60, 220),
    "tv monitor": (230, 220, 40),
    "table": (150, 90, 40),
}

# human color names for the fake objects (EQA ground truth + oracle)
FAKE_COLOR_NAMES = {
    "bed": "red",
    "plant": "green",
    "sofa": "blue",
    "tv monitor": "yellow",
    "table": "brown",
}


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--env", choices=["fake", "habitat"], default="fake")
    p.add_argument("--episodes", type=int, default=5)
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--llm", choices=["mock", "openai", "local"], default="mock")
    p.add_argument("--llm-model", type=str, default="gpt-4o")
    p.add_argument("--memory-root", type=str, default="./memory")
    p.add_argument("--weights-dir", type=str, default=None)
    p.add_argument("--record-video", action="store_true")
    p.add_argument("--log-root", type=str, default="./tmp")
    p.add_argument("--use-only-working-memory", action="store_true")
    p.add_argument("--load-single-floor", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    # habitat backend paths (reference args.py:90-107)
    p.add_argument("--benchmark-dataset", default="hm3d")
    p.add_argument("--scene-prefix", default="")
    p.add_argument("--episode-prefix", default="")
    p.add_argument("--success-distance", type=float, default=None)
    p.add_argument("--store-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="token-store precision")
    p.add_argument("--num-workers", type=int, default=1,
                   help="episode-farming worker count (strided episode "
                        "split; one CSV shard per worker)")
    p.add_argument("--worker-id", type=int, default=0)
    p.add_argument("--int8", default="clip,llm,diffusion",
                   help="comma list of int8-served stages: "
                        "encoder,clip,llm,diffusion (W8A8, ops/quant.py); "
                        "'none' disables all; the fake world serves none")
    p.add_argument("--detector", default="auto",
                   choices=["auto", "clip-patch", "grounding-dino"],
                   help="long-term-memory detector backend on the "
                        "habitat path")
    p.add_argument("--device", default="cuda",
                   help="torch device of the memory and the encoder (the "
                        "card unless the CPU is asked for)")


def fake_config(args) -> Config:
    return Config(
        sensor=SensorConfig(width=64, height=64),
        memory=MemoryConfig(
            grid_size=96, floor_height=-3.2, map_height=3.2, token_dim=32,
            cache_size=4, voxel_capacity=(1 << 13) - 8, depth_sample_rate=4),
        query=QueryConfig(top_k=32, query_width=56, query_height=56,
                          cluster_min_samples=3),
        agent=AgentConfig(
            random_move_num=3,
            use_only_working_memory=args.use_only_working_memory,
            load_single_floor=args.load_single_floor,
            max_path_len=500),
        memory_path=args.memory_root,
        seed=args.seed,
    )


def _int8_set(args):
    raw = getattr(args, "int8", "")
    if raw.strip() == "none":
        return set()
    return {t.strip() for t in raw.split(",") if t.strip()}


def habitat_config(args) -> Config:
    """The habitat world's Config: ``Config()`` at the published widths,
    the flags' memory root, working-memory and floor options, weights
    directory and int8 stages (JAX ``benchmarks/setup.py:126``)."""
    cfg = Config(memory_path=args.memory_root)
    int8 = _int8_set(args)
    return cfg.replace(
        agent=AgentConfig(
            use_only_working_memory=args.use_only_working_memory,
            load_single_floor=args.load_single_floor),
        models=cfg.models.__class__(
            weights_dir=args.weights_dir,
            encoder_int8="encoder" in int8,
            clip_int8="clip" in int8,
            llm_int8="llm" in int8,
            diffusion_int8="diffusion" in int8))


def make_llm(args, bench=None):
    if args.llm == "openai":
        return L.OpenAICompatClient()
    if args.llm == "local":
        # the in-process Qwen2.5-VL judge (reference objnav_benchmark.py:
        # 165-171 serves it remotely; here it runs on --device)
        from bsc_nav_tpu_torch.agents.local_vlm import load_local_vlm
        if not args.weights_dir:
            raise ValueError("--llm local needs --weights-dir (qwen_vl.npz "
                             "and tokenizer.json)")
        return load_local_vlm(args.weights_dir, device=args.device,
                              quantize="llm" in _int8_set(args))

    def _echo_braced_goal(t):
        # instruction text like "Walk to the X and stop ..." -> one subgoal
        m = re.search(r"Walk to the ([a-z ]+?) and stop", t)
        goal = m.group(1) if m else "bed"
        return f"1. Move to the {{{goal}}}"

    def _oracle_judge(t):
        # fake-world VLM judge: answer from the TRUE goal distance so
        # success reflects localization+navigation quality rather than
        # mock optimism (a real VLM sees the goal in the image)
        if bench is not None:
            d = bench.get_metrics()["distance_to_goal"]
            thr = getattr(bench, "success_distance", 1.5)
            if d <= thr:
                return "Success: yes\nneed forward: no"
            return "Success: no\ntoo far"
        return "Success: yes\nneed forward: no"

    def _oracle_answer(t):
        # fake-world EQA oracle: answer color questions from the scene's
        # true object colors (a real VLM reads them off the image), BUT
        # only when the agent actually got near the object -- otherwise
        # an honest "I cannot see it" (so accuracy tracks navigation)
        m = re.search(r"[Ww]hat color is the ([a-z ]+?)\?", t)
        if m and m.group(1) in FAKE_COLOR_NAMES:
            if bench is not None:
                d = bench.get_metrics()["distance_to_goal"]
                if d > getattr(bench, "success_distance", 1.5) + 1.0:
                    return "I cannot see it from here."
            return f"It is {FAKE_COLOR_NAMES[m.group(1)]}."
        return "mock answer"

    return L.MockLLMClient(responders=[
        (lambda t: "Judge whether" in t or "Compare the goal image" in t,
         _oracle_judge),
        (lambda t: "Rewrite the following" in t, lambda t: t[-500:]),
        (lambda t: "Merge the two descriptions" in t, lambda t: t[-500:]),
        (lambda t: "Decompose the indoor navigation" in t,
         _echo_braced_goal),
        (lambda t: "names a nearby target" in t,
         lambda t: (re.search(r"Instruction: ([a-zA-Z ]+?)\n", t)
                    or re.search(r"Instruction: ([a-zA-Z ]+)", t)
                    ).group(1) if re.search(
                        r"Instruction: ([a-zA-Z ]+)", t) else "a bed"),
        (lambda t: "navigates to the relevant instance" in t,
         lambda t: "Now, we need to go to {a %s}" % (
             (re.search(r"[Ww]hat color is the ([a-z ]+?)\?", t)
              or re.search(r"Question:.*?the ([a-z ]+?)\?", t)
              or re.search(r"(bed)", "bed")).group(1))),
        (lambda t: "Answer the question" in t, _oracle_answer),
    ])


class SceneImagination:
    """Fake-backend imagination: render the named scene object
    (stand-in for the SD3.5 text->image path, memory_2.py:258-276)."""

    def __init__(self, cfg, scene: BoxScene):
        self.scene = scene
        self.env = FakeNavEnv(cfg, scene=scene, seed=17)

    def __call__(self, text: str) -> np.ndarray:
        box = next(
            (b for b in self.scene.boxes
             if b.label and re.search(rf"\b{re.escape(b.label)}\b", text)),
            self.scene.boxes[0])
        c = np.asarray(box.center)
        views = []
        for off in [(-0.8, -0.8), (-0.9, 0.0), (0.0, -0.9)]:
            pos = c + np.array([off[0], -c[1], off[1]])
            yaw = math.atan2(-(c[0] - pos[0]), -(c[2] - pos[2]))
            self.env.agent.set_state(AgentState(pos, Quat.from_yaw(yaw)))
            self.env.pitch = -math.radians(45)
            obs = self.env.sims.get_sensor_observations(0)
            views.append(obs["rgb"][:, :, :3])
        return np.stack(views)


def fake_episodes(scene: BoxScene, task: str, seed: int):
    """One episode per scene object, with the task's instruction, question
    or attribute texts."""
    episodes = episodes_for_scene(scene, start=(0.0, 0.0, 0.0), seed=seed)
    if task == "vlnce":
        for ep in episodes:
            ep.instruction = (f"Walk to the {ep.object_category} and stop "
                              f"right in front of it.")
    if task == "eqa":
        for ep in episodes:
            ep.question = f"What color is the {ep.object_category}?"
    if task == "textnav":
        for ep in episodes:
            ep.intrinsic_attributes = f"a {ep.object_category}"
            ep.extrinsic_attributes = "in the corner of the room"
    return episodes


def build_world(args, task: str = "objnav"
                ) -> Tuple[Config, object, VoxelTokenMemory, dict]:
    """Returns (cfg, bench_env, memory, extras) with extras carrying the
    llm client / matcher / imagination for robot construction."""
    if args.env == "habitat":
        from bsc_nav_tpu_torch.env.habitat_env import build_habitat_world
        return build_habitat_world(args, task)
    # the fake world takes its colour detector whatever --detector says
    dev = resolve_device(args.device)
    cfg = fake_config(args)
    scene = BoxScene.default()
    bench = FakeBenchmarkEnv(
        cfg, fake_episodes(scene, task, args.seed), scene=scene,
        seed=args.seed, success_distance=args.success_distance or 1.5,
        topdown="vlnce" if task == "vlnce" else "fog")

    vit_cfg = vit.ViTConfig(img_size=56, patch_size=14, dim=32, depth=2,
                            heads=2, num_registers=1)
    perception = Perception.create(cfg, vit_cfg=vit_cfg,
                                   batch_size=args.batch_size, device=dev)
    detector = ColorPrototypeDetector(FAKE_PROTOTYPES, confidence=0.5)
    imagination = SceneImagination(cfg, scene)
    memory = VoxelTokenMemory(
        cfg, env=bench.nav_env, perception=perception, detector=detector,
        imagination=imagination,
        store_dtype=getattr(torch, args.store_dtype))

    extras = {
        "llm": make_llm(args, bench=bench),
        "matcher": ColorViewScorer(FAKE_PROTOTYPES),
        "imagination": imagination,
        "scene": scene,
    }
    return cfg, bench, memory, extras


def build_memory_fake(memory, bench) -> None:
    """Build the scene memory from the agent's current pose, restoring
    the pose afterwards (shared by drivers and demo)."""
    state = bench.sim.agents[0].get_state()
    bench.nav_env.reset(
        init_state=AgentState(np.asarray(state.position), Quat()),
        build_map=True)
    memory.exploring_create_memory(save=False)
    # restore the episode start pose
    bench.nav_env.agent.set_state(state)


def ensure_memory_fake(robot, bench) -> None:
    """Build the scene memory once (the per-scene caching of the
    reference drivers, objnav_benchmark.py:1289-1294)."""
    if int(robot.memory.state.num_voxels) > 0:
        return
    build_memory_fake(robot.memory, bench)


def island_stats(bench):
    pf = bench.sim.pathfinder
    state = bench.sim.agents[0].get_state()
    island = pf.get_island(state.position)
    return island, pf.island_area(island)


def _gpu_row(args):
    """(good, detail) of the card row: the CUDA device's name and the power
    limit nvidia-smi reports; without a card it is red unless the CPU was
    asked for."""
    dev = str(args.device)
    if not torch.cuda.is_available():
        if torch.device(dev).type == "cpu":
            return True, "no CUDA device; --device cpu asked for"
        return False, "torch.cuda.is_available() is False (pass --device " \
            "cpu to check the CPU path)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi: {type(e).__name__}"
    return True, f"{torch.cuda.get_device_name(0)} ({smi}); --device {dev}"


def _judge_probe(args) -> str:
    """One judge chat through the driver's own ``make_llm``: a fake-world
    view, PNG-packed, to ``succeed_determine_singleview``."""
    cfg = fake_config(args)
    env = FakeNavEnv(cfg, scene=BoxScene.default(), seed=args.seed)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    view = env.sims.get_sensor_observations(0)["rgb"][:, :, :3]
    client = make_llm(args)
    out = L.succeed_determine_singleview(client, "a bed", [view],
                                         model=args.llm_model)
    last = getattr(client, "last", {})
    return (f"{len(out)} chars, prompt {last.get('prompt_len', '?')} "
            f"tokens: {out[:40]!r}")


def readiness_check(args) -> int:
    """``python -m bsc_nav_tpu_torch.drivers.setup --check``: the port's
    readiness gate (JAX ``benchmarks/setup.py:318-440``).  Rows: the card,
    habitat-sim (optional unless asked for), the episode dataset and scene
    paths, the converted weights against ``tools/weights_manifest.json``,
    with ``--llm local`` one judge chat, one mocked episode through the
    port's objnav driver, and where habitat-sim, the scenes and the
    episodes are all there the habitat world built and reset.  Returns 0
    when every row is green, else 1."""
    ok = True

    def row(label, good, detail=""):
        nonlocal ok
        mark = "ok     " if good else "MISSING"
        print(f"  [{mark}] {label}" + (f" -- {detail}" if detail else ""))
        ok = ok and bool(good)
        return good

    print("== bsc-nav-tpu-torch readiness check ==")
    row("card", *_gpu_row(args))

    habitat_requested = bool(args.scene_prefix or args.episode_prefix
                             or args.env == "habitat")
    have_habitat = importlib.util.find_spec("habitat_sim") is not None
    if have_habitat or habitat_requested:
        row("habitat_sim importable", have_habitat,
            "" if have_habitat else "habitat-sim is not installed")
    else:
        print("  [absent ] habitat_sim (optional here; the fake backend is "
              "fully usable -- pass --scene-prefix/--episode-prefix to "
              "require it)")

    episodes = []
    if args.episode_prefix:
        from bsc_nav_tpu_torch.env import datasets as DS
        try:
            loader = (DS.load_r2r_episodes if args.task == "vlnce"
                      else DS.load_objectnav_episodes)
            episodes = loader(args.episode_prefix, limit=1)
            row("episode dataset parses", bool(episodes),
                args.episode_prefix)
        except Exception as e:                  # noqa: BLE001
            row("episode dataset parses", False,
                f"{args.episode_prefix}: {type(e).__name__}: {e}")
    else:
        print("  [skip   ] --episode-prefix not given")
    if args.scene_prefix:
        if episodes:
            sp = os.path.join(args.scene_prefix, episodes[0].scene_id)
            row("first episode scene file", os.path.exists(sp), sp)
        else:
            row("scene prefix exists", os.path.isdir(args.scene_prefix),
                args.scene_prefix)
    else:
        print("  [skip   ] --scene-prefix not given")

    if args.weights_dir:
        man = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tools", "weights_manifest.json")
        with open(man) as f:
            models = json.load(f)["models"]
        missing = [m["out"] for m in models.values()
                   if not os.path.exists(
                       os.path.join(args.weights_dir, m["out"]))]
        row("converted weights complete", not missing,
            "all present" if not missing else
            f"missing from {args.weights_dir}: {', '.join(missing)}")
    else:
        print("  [skip   ] --weights-dir not given (random-init serving)")

    if args.llm == "local":
        try:
            row("local judge chat", True, _judge_probe(args))
        except Exception as e:                  # noqa: BLE001
            row("local judge chat", False, f"{type(e).__name__}: {e}")

    from bsc_nav_tpu_torch.drivers import objnav
    with tempfile.TemporaryDirectory() as td:
        try:
            recs = objnav.main([
                "--env", "fake", "--episodes", "1", "--llm", "mock",
                "--device", str(args.device),
                "--csv", os.path.join(td, "check.csv"),
                "--log-root", td, "--memory-root", td])
            row("mocked episode end-to-end", bool(recs),
                f"success={recs[0].metrics['success']:.0f} "
                f"spl={recs[0].metrics['spl']:.2f}" if recs else "")
        except Exception as e:                  # noqa: BLE001
            row("mocked episode end-to-end", False,
                f"{type(e).__name__}: {e}")

    if have_habitat and episodes and args.scene_prefix:
        try:
            a = copy.copy(args)
            a.env, a.episodes = "habitat", 1
            _, bench, _, _ = build_world(a, task=args.task)
            bench.reset()
            m = bench.get_metrics()
            row("habitat world builds + resets", True,
                f"distance_to_goal={m['distance_to_goal']:.2f}")
        except Exception as e:                  # noqa: BLE001
            row("habitat world builds + resets", False,
                f"{type(e).__name__}: {e}")
    else:
        print("  [skip   ] habitat world (needs habitat_sim + "
              "--scene-prefix + --episode-prefix)")
    print(f"== readiness: {'READY' if ok else 'NOT READY'} ==")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="readiness check: python -m "
                    "bsc_nav_tpu_torch.drivers.setup --check")
    add_common_args(p)
    p.add_argument("--check", action="store_true")
    p.add_argument("--task", default="objnav",
                   choices=["objnav", "ovnav", "imagenav", "textnav",
                            "vlnce", "eqa"])
    a = p.parse_args(argv)
    if not a.check:
        p.error("this module is a library; the only CLI is --check")
    return readiness_check(a)


if __name__ == "__main__":
    raise SystemExit(main())
