"""Habitat-sim environment adapter (import-gated).

Host copy of ``bsc_nav_tpu/env/habitat_env.py``'s classes; it imports
nothing of the JAX package.  The wrapper mirrors the reference NavEnv
(reference env.py:49-297): scene loading, the 5-action agent (move 0.25 m,
turn 30 deg, look +/-15 deg), RGB/depth(/semantic) sensors at the
configured resolution, the greedy geodesic follower, and island-aware goal
snapping; the benchmark-env adapters expose the protocol of
``env/benchmark.FakeBenchmarkEnv`` over habitat.Env or habitat-sim alone.

habitat-sim is NOT a dependency of this package: the module imports
without it, and everything that needs it raises a clear ImportError.
``build_habitat_world`` is the drivers' ``--env habitat`` factory over the
port's own modules, on ``args.device`` (the card unless the CPU is asked
for).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np


def _require_habitat():
    try:
        import habitat_sim  # noqa: F401
        return habitat_sim
    except ImportError as e:
        raise ImportError(
            "habitat-sim is required for the habitat backend "
            "(conda install habitat-sim ...); the fake backend "
            "(--env fake) runs without it") from e


class HabitatNavEnv:
    """reference env.py:49 NavEnv equivalent."""

    def __init__(self, cfg, scene_path: str,
                 scene_dataset_config: str = "",
                 init_state=None, build_map: bool = False):
        habitat_sim = _require_habitat()
        import os
        os.environ.setdefault("MAGNUM_LOG", "quiet")
        os.environ.setdefault("HABITAT_SIM_LOG", "quiet")

        self.cfg = cfg
        self._hs = habitat_sim
        self.sims = habitat_sim.Simulator(
            self._make_cfg(scene_path, scene_dataset_config))
        self.agent = self.sims.initialize_agent(0)
        self._place(init_state, build_map)
        self.original_state = self.agent.get_state()
        self.plnner = habitat_sim.nav.GreedyGeodesicFollower(
            pathfinder=self.sims.pathfinder, agent=self.agent,
            goal_radius=0.3, stop_key="stop")

    # --- config (reference env.py:166-256) -------------------------------
    def _make_cfg(self, scene_path: str, scene_dataset_config: str):
        hs = self._hs
        sim_cfg = hs.SimulatorConfiguration()
        sim_cfg.gpu_device_id = 0
        sim_cfg.scene_id = scene_path
        sim_cfg.enable_physics = False
        if scene_dataset_config:
            sim_cfg.scene_dataset_config_file = scene_dataset_config

        s = self.cfg.sensor
        specs = []
        for uuid, stype, orientation in [
            ("back_rgb", hs.SensorType.COLOR, (-np.pi / 8, 0, 0)),
            ("rgb", hs.SensorType.COLOR, None),
            ("depth", hs.SensorType.DEPTH, None),
            ("semantic", hs.SensorType.SEMANTIC, None),
        ]:
            spec = hs.CameraSensorSpec()
            spec.uuid = uuid
            spec.sensor_type = stype
            spec.resolution = [s.height, s.width]
            spec.position = [0.0, s.sensor_height, 0.0]
            if orientation is not None:
                import magnum as mn
                spec.orientation = mn.Vector3(*orientation)
            spec.sensor_subtype = hs.SensorSubType.PINHOLE
            specs.append(spec)

        a = self.cfg.actions
        agent_cfg = hs.agent.AgentConfiguration()
        agent_cfg.sensor_specifications = specs
        agent_cfg.action_space = {
            "move_forward": hs.agent.ActionSpec(
                "move_forward", hs.agent.ActuationSpec(amount=a.move_forward)),
            "turn_left": hs.agent.ActionSpec(
                "turn_left", hs.agent.ActuationSpec(amount=a.turn_left_deg)),
            "turn_right": hs.agent.ActionSpec(
                "turn_right", hs.agent.ActuationSpec(amount=a.turn_right_deg)),
            "look_up": hs.agent.ActionSpec(
                "look_up", hs.agent.ActuationSpec(amount=a.look_deg)),
            "look_down": hs.agent.ActionSpec(
                "look_down", hs.agent.ActuationSpec(amount=a.look_deg)),
        }
        return hs.Configuration(sim_cfg, [agent_cfg])

    def _place(self, init_state, build_map: bool):
        hs = self._hs
        state = hs.AgentState()
        if init_state is not None:
            state.position = init_state.position
            if not build_map:
                # build-map mode keeps identity rotation so the
                # allocentric grid is axis-aligned (reference env.py:66-70)
                state.rotation = init_state.rotation
        else:
            state.position = self.sims.pathfinder.get_random_navigable_point()
        self.agent.set_state(state)

    def reset(self, cfg=None, init_state=None, build_map: bool = False):
        if cfg is not None:
            self.cfg = cfg
        self._place(init_state, build_map)
        self.original_state = self.agent.get_state()
        self.plnner = self._hs.nav.GreedyGeodesicFollower(
            pathfinder=self.sims.pathfinder, agent=self.agent,
            goal_radius=0.3, stop_key="stop")

    def reconfigure_scene(self, scene_path: str,
                          scene_dataset_config: str = ""):
        """Load a new scene into the live simulator and recompute the
        navmesh for the agent's radius/height (reference OVONSim
        env.py:432-469: reconfigure + NavMeshSettings + recompute on
        every scene change)."""
        hs = self._hs
        self.sims.reconfigure(
            self._make_cfg(scene_path, scene_dataset_config))
        settings = hs.nav.NavMeshSettings()
        settings.set_defaults()
        sim_cfg = getattr(self.cfg, "sim", None)
        settings.agent_radius = getattr(sim_cfg, "agent_radius", 0.18)
        settings.agent_height = getattr(sim_cfg, "agent_height", 0.88)
        self.sims.recompute_navmesh(self.sims.pathfinder, settings)
        self.agent = self.sims.initialize_agent(0)
        self._place(None, False)
        self.original_state = self.agent.get_state()
        self.plnner = hs.nav.GreedyGeodesicFollower(
            pathfinder=self.sims.pathfinder, agent=self.agent,
            goal_radius=0.3, stop_key="stop")

    # --- planning (reference env.py:131-163) ------------------------------
    def get_navigable_point_near(self, circle_center, max_tries: int = 500):
        island = self.plnner.pathfinder.get_island(
            self.agent.get_state().position)
        goal = self.plnner.pathfinder.snap_point(
            circle_center, island_index=island)
        return np.array([goal[0], goal[1], goal[2]])

    def move2point(self, goal):
        if not self.plnner.pathfinder.is_navigable(goal):
            goal = self.get_navigable_point_near(goal)
        path = self.plnner.find_path(goal)
        return path, goal


class HabitatLabBenchmarkEnv:
    """Adapter: habitat.Env -> the BenchmarkEnv protocol (for hosts that
    run the habitat-lab stack, reference get_objnav_env/hm3d_data_config,
    env.py:472-554)."""

    def __init__(self, habitat_env):
        self._env = habitat_env
        self.sim = habitat_env.sim

    def reset(self):
        return self._env.reset()

    def step(self, action: str):
        return self._env.step(action)

    def get_metrics(self) -> Dict:
        return self._env.get_metrics()

    @property
    def episode_over(self) -> bool:
        return self._env.episode_over

    @property
    def current_episode(self):
        return self._env.current_episode


class _HabitatSimFacade:
    def __init__(self, nav_env: "HabitatNavEnv"):
        self._nav = nav_env
        self.agents = [nav_env.agent]
        self.pathfinder = nav_env.sims.pathfinder

    def get_sensor_observations(self, agent_id: int = 0):
        return self._nav.sims.get_sensor_observations(agent_id)


class HabitatEpisodeBenchmarkEnv:
    """Episode benchmark over habitat-sim DIRECTLY -- no habitat-lab.

    The reference vendors a 403-file habitat-lab fork just to iterate
    episodes and compute success/SPL/distance (SURVEY §1 L6).  Here the
    episode datasets are parsed natively (env/datasets.py) and the
    metrics mirror the habitat Measure definitions on habitat-sim's own
    geodesic queries, so the only native dependency left is the
    simulator itself.
    """

    def __init__(self, nav_env: "HabitatNavEnv", episodes: List,
                 success_distance: float = 1.0, scene_prefix: str = ""):
        self._nav = nav_env
        self.episodes = episodes
        self.success_distance = success_distance
        self.scene_prefix = scene_prefix
        self._current_scene = episodes[0].scene_id if episodes else ""
        self.sim = _HabitatSimFacade(nav_env)
        self._ep_idx = -1
        self.episode_over = False
        self._called_stop = False
        self._path_length = 0.0
        self._shortest = float("inf")
        self._min_dist = float("inf")
        self._len_at_min = 0.0

    @property
    def current_episode(self):
        return self.episodes[self._ep_idx % len(self.episodes)]

    @property
    def nav_env(self):
        return self._nav

    def _geodesic(self, a, b) -> float:
        hs = self._nav._hs
        path = hs.ShortestPath()
        path.requested_start = np.asarray(a, np.float32)
        path.requested_end = np.asarray(b, np.float32)
        if self._nav.sims.pathfinder.find_path(path):
            return float(path.geodesic_distance)
        return float("inf")

    def _distance_to_goal(self) -> float:
        pos = self._nav.agent.get_state().position
        ep = self.current_episode
        return min((self._geodesic(pos, g) for g in ep.goal_positions),
                   default=float("inf"))

    def reset(self):
        import math
        self._ep_idx += 1
        ep = self.current_episode
        if ep.scene_id != self._current_scene:
            # scene change: reload + navmesh recompute (reference
            # OVONSim env.py:432-469)
            import os
            self._nav.reconfigure_scene(
                os.path.join(self.scene_prefix, ep.scene_id),
                getattr(ep, "scene_dataset_config", ""))
            self._current_scene = ep.scene_id
        hs = self._nav._hs
        state = hs.AgentState()
        state.position = np.asarray(ep.start_position, np.float32)
        yaw = ep.start_yaw
        state.rotation = np.quaternion(math.cos(yaw / 2), 0.0,
                                       math.sin(yaw / 2), 0.0) \
            if hasattr(np, "quaternion") else state.rotation
        self._nav.agent.set_state(state)
        self.episode_over = False
        self._called_stop = False
        self._path_length = 0.0
        self._min_dist = float("inf")
        self._len_at_min = 0.0
        self._shortest = min(
            (self._geodesic(ep.start_position, g)
             for g in ep.goal_positions), default=float("inf"))
        return self._nav.sims.get_sensor_observations(0)

    def step(self, action: str):
        prev = np.asarray(self._nav.agent.get_state().position)
        if action == "stop":
            obs = self._nav.sims.get_sensor_observations(0)
            self.episode_over = True
            self._called_stop = True
            return obs
        obs = self._nav.sims.step(action)
        cur = np.asarray(self._nav.agent.get_state().position)
        moved = float(np.linalg.norm(cur - prev))
        self._path_length += moved
        if moved > 0:
            d = self._distance_to_goal()
            if d < self._min_dist:
                self._min_dist = d
                self._len_at_min = self._path_length
        return obs

    def get_metrics(self) -> Dict:
        d = self._distance_to_goal()
        success = float(self._called_stop and d <= self.success_distance)
        spl = 0.0
        if success and np.isfinite(self._shortest):
            spl = self._shortest / max(self._shortest, self._path_length,
                                       1e-6)
        o_success = float(min(self._min_dist, d) <= self.success_distance)
        ospl = 0.0
        if o_success and np.isfinite(self._shortest):
            ospl = self._shortest / max(self._shortest, self._len_at_min,
                                        1e-6)
        return {"success": success, "spl": spl, "oracle_spl": ospl,
                "distance_to_goal": d, "path_length": self._path_length}


def build_habitat_world(args, task: str):
    """Driver-facing factory (``drivers/setup.build_world``'s habitat path,
    JAX ``habitat_env.py:311-442``): the scene of the first episode, native
    dataset parsing, the bf16 DINOv2 perception, and the models whose
    converted weights sit under ``--weights-dir``: with ``--detector
    grounding-dino`` the Grounding DINO detector (``grounding_dino_tiny.npz``
    and BERT's ``vocab.txt``); the MetaCLIP matcher, and its patch detector
    unless Grounding DINO was asked for; the SD3.5-medium imagination
    (int8 T5 quantized on the host under ``diffusion_int8``)."""
    import os

    import torch

    from bsc_nav_tpu_torch import resolve_device
    from bsc_nav_tpu_torch.agents.matchers import CLIPMatcher
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.config import HM3D_DETECT_CLASSES
    from bsc_nav_tpu_torch.drivers.setup import habitat_config, make_llm
    from bsc_nav_tpu_torch.env import datasets as DS
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import tokenizer as T
    from bsc_nav_tpu_torch.models import weights as WT
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector

    _require_habitat()
    dev = resolve_device(getattr(args, "device", "cuda"))
    cfg = habitat_config(args)
    if task in ("vlnce",):
        episodes = DS.load_r2r_episodes(args.episode_prefix,
                                        limit=args.episodes)
    else:
        episodes = DS.load_objectnav_episodes(args.episode_prefix,
                                              limit=args.episodes)
    if not episodes:
        raise ValueError(f"no episodes parsed from {args.episode_prefix}")

    scene_path = os.path.join(args.scene_prefix, episodes[0].scene_id)
    nav = HabitatNavEnv(cfg, scene_path,
                        scene_dataset_config=episodes[0].scene_dataset_config)
    bench = HabitatEpisodeBenchmarkEnv(
        nav, episodes,
        success_distance=args.success_distance or cfg.sim.success_distance,
        scene_prefix=args.scene_prefix)

    perception = Perception.create(cfg, batch_size=args.batch_size,
                                   compute_dtype=torch.bfloat16, device=dev)

    matcher = None
    detector = None
    imagination = None
    wd = args.weights_dir
    if getattr(args, "detector", "auto") == "grounding-dino":
        from bsc_nav_tpu_torch.models import grounding_dino as G
        from bsc_nav_tpu_torch.models.wordpiece import WordPieceTokenizer

        if not wd:
            raise ValueError("--detector grounding-dino needs "
                             "--weights-dir with grounding_dino_tiny.npz "
                             "and the BERT vocab.txt")
        gparams = WT.load_grounding_dino_npz(
            os.path.join(wd, "grounding_dino_tiny.npz"),
            G.GROUNDING_DINO_TINY, device=dev)
        tok = WordPieceTokenizer.from_vocab_file(
            os.path.join(wd, "vocab.txt"))
        detector = G.GroundingDinoDetector(
            gparams, G.GROUNDING_DINO_TINY, HM3D_DETECT_CLASSES,
            tokenizer=tok, confidence=cfg.detector.confidence)
    clip_npz = wd and os.path.join(wd, cfg.models.clip + ".npz")
    if clip_npz and os.path.exists(clip_npz):
        ccfg = C.CONFIGS[cfg.models.clip]
        cparams = WT.load_clip_npz(clip_npz, ccfg, device=dev)
        tok = T.default_tokenizer(
            os.path.join(wd, "bpe_simple_vocab_16e6.txt.gz"))
        matcher = CLIPMatcher(cparams, ccfg, tok,
                              quantize=cfg.models.clip_int8)
        if detector is None:
            detector = ClipPatchDetector(
                cparams, ccfg, tok, classes=HM3D_DETECT_CLASSES,
                confidence=cfg.detector.confidence)

    # SD3.5 "imagination" for text queries (reference memory_2.py:542-560):
    # converted weights under --weights-dir enable the triple-encoder stack
    # -- sd35_medium / sd3_vae / sd3_clip_l / sd3_clip_g (.npz), optional
    # t5_xxl.npz + spiece.model for the T5 stream
    sd3_npz = wd and os.path.join(wd, "sd35_medium.npz")
    if sd3_npz and os.path.exists(sd3_npz):
        from bsc_nav_tpu_torch.models import mmdit as MM
        from bsc_nav_tpu_torch.models import t5 as T5
        from bsc_nav_tpu_torch.models import vae as VV
        from bsc_nav_tpu_torch.models.imagination import DiffusionImagination
        from bsc_nav_tpu_torch.models.sentencepiece import (
            SentencePieceUnigram)

        bf16 = dict(dtype=torch.bfloat16, device=dev)
        t5_kw = {}
        if (os.path.exists(os.path.join(wd, "t5_xxl.npz"))
                and os.path.exists(os.path.join(wd, "spiece.model"))):
            t5_path = os.path.join(wd, "t5_xxl.npz")
            if cfg.models.diffusion_int8:
                # T5-XXL follows the MMDiT int8 knob: quantized on the host,
                # then ~4.8 GB of int8 uploaded in place of 9.4 GB of bf16
                with np.load(t5_path) as z:
                    t5_params = WT.t5_from_jax_params(
                        T5.quantize_params_host(WT.unflatten_params(
                            dict(z.items()))), T5.T5_XXL, **bf16)
            else:
                t5_params = WT.load_t5_xxl_npz(t5_path, T5.T5_XXL, **bf16)
            t5_kw = dict(
                t5_params=t5_params, t5_cfg=T5.T5_XXL,
                t5_tokenizer=SentencePieceUnigram.from_file(
                    os.path.join(wd, "spiece.model")))
        imagination = DiffusionImagination(
            mmdit_params=WT.load_sd35_medium_npz(
                sd3_npz, MM.SD35_MEDIUM, **bf16),
            mmdit_cfg=MM.SD35_MEDIUM,
            vae_params=WT.load_sd3_vae_npz(
                os.path.join(wd, "sd3_vae.npz"), VV.SD3_VAE, **bf16),
            vae_cfg=VV.SD3_VAE,
            clip_l_params=WT.load_clip_text_npz(
                os.path.join(wd, "sd3_clip_l.npz"), C.SD3_CLIP_L, **bf16),
            clip_l_cfg=C.SD3_CLIP_L,
            clip_g_params=WT.load_clip_text_npz(
                os.path.join(wd, "sd3_clip_g.npz"), C.SD3_CLIP_G, **bf16),
            clip_g_cfg=C.SD3_CLIP_G,
            tokenizer=T.default_tokenizer(
                os.path.join(wd, "bpe_simple_vocab_16e6.txt.gz")),
            quantize=cfg.models.diffusion_int8, **t5_kw)

    memory = VoxelTokenMemory(cfg, env=nav, perception=perception,
                              detector=detector, imagination=imagination,
                              store_dtype=getattr(
                                  torch, getattr(args, "store_dtype",
                                                 "float32")))
    extras = {"llm": make_llm(args), "matcher": matcher,
              "imagination": imagination}
    return cfg, bench, memory, extras
