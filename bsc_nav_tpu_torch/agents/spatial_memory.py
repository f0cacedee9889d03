"""Host-side spatial memory agent over the torch pipelines.

Counterpart of ``bsc_nav_tpu/agents/spatial_memory.py`` for the memory
spine and the long-term memory: frames are queued on the host and
ingested in fixed-size batches (short batches padded with zero-depth
frames, whose points all fail the min-depth gate), a detector's boxes
become located instances in ``long_memory_dict``, and image prompts are
localized against the store.  A host detector (``detect``) runs inline
per frame; one with ``detect_batch`` (``ClipPatchDetector``) runs once per
flush, and one with ``detect_batch_instances`` (``YoloWorldDetector``)
feeds the long-term memory from the device once per flush: forward,
decode, NMS and backprojection on the card, one small copy to the host.
A text prompt goes through the imagination (``DiffusionImagination``:
SD3.5-medium with CLIP-L/G and T5 conditioning) and the text-query steps
of ``memory.pipeline``, the imagined images staying on the device; an
imagination that is a plain callable (no ``imagine_core``) renders images
on the host, which then take the image query, as in the JAX package.
``voxel_localized_batch`` pools each distinct prompt once and localizes
all of them in one Q-query scan of the store, a region radius per query;
``save`` / ``load_memory`` write and read the reference's on-disk bundle
(``memory.persistence``), and a loaded memory takes its single-floor
height range from ``memory.floors``.  The store may be f32, bf16 or int8,
the replacement policy dist or surprise (``cfg.memory.replacement``), and
the encoder int8 W8A8 (``encoder_int8``).  ``segmented=True`` ingests into
a ``memory.segments.SegmentedStore`` that rotates after each build step;
once it holds several segments, queries localize in every segment and
merge (a text prompt through ``imaginary`` and the image query).
``excute`` steps the environment and pushes each frame;
``exploring_create_memory`` (random same-island waypoints, a turn in
place at each) and ``explore_entire_space`` (frontier targets from the
top-down map, ``memory.frontier``) build a memory headless.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bsc_nav_tpu_torch.config import Config
from bsc_nav_tpu_torch import geometry as G
from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.memory import floors as F
from bsc_nav_tpu_torch.memory import frontier as FR
from bsc_nav_tpu_torch.memory import longterm as LT
from bsc_nav_tpu_torch.memory import persistence as P
from bsc_nav_tpu_torch.memory.pipeline import (
    make_build_step, make_query_step, make_text_pool_step,
    make_text_query_step, pooled_query)
from bsc_nav_tpu_torch.memory.query import localize, localize_batch
from bsc_nav_tpu_torch.memory.segments import SegmentedStore
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.models.weights import load_dinov2_npz
from bsc_nav_tpu_torch.utils.profiling import SPANS, TELEMETRY


@dataclasses.dataclass
class Perception:
    """The encoder and the pipelines, shared across scenes.
    ``vit_params`` is the ViT module holding the weights (int8 W8A8 block
    matmuls when ``cfg.models.encoder_int8``); weights that ``create``
    loads or draws take ``compute_dtype``.  ``pool_step(params,
    images_uint8)`` gives a prompt's pooled query vector."""

    vit_params: vit.ViT
    vit_cfg: vit.ViTConfig
    build_step: Callable
    query_step: Callable
    pool_step: Optional[Callable] = None
    batch_size: int = 8
    compute_dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    @staticmethod
    def create(cfg: Config, vit_cfg: Optional[vit.ViTConfig] = None,
               vit_params: Optional[vit.ViT] = None, batch_size: int = 8,
               compute_dtype=torch.float32, seed: int = 0,
               device="cuda") -> "Perception":
        dev = resolve_device(device)
        vit_cfg = vit_cfg or vit.CONFIGS[cfg.models.encoder]
        if vit_params is None:
            weights = (os.path.join(cfg.models.weights_dir,
                                    cfg.models.encoder + ".npz")
                       if cfg.models.weights_dir else None)
            if weights and os.path.exists(weights):
                vit_params = load_dinov2_npz(weights, vit_cfg,
                                             dtype=compute_dtype,
                                             device=dev)
            else:
                if weights:
                    print(f"[perception] WARNING: encoder weights not found "
                          f"at {weights!r} -- using RANDOM-INIT "
                          f"{cfg.models.encoder} params", file=sys.stderr)
                gen = torch.Generator(device=dev).manual_seed(seed)
                vit_params = vit.init_params(vit_cfg, gen,
                                             dtype=compute_dtype,
                                             device=dev)
        if cfg.models.encoder_int8:
            # serving-only W8A8 (JAX spatial_memory.py:79-83): build,
            # query and pool steps all run the int8 leaves
            vit_params = vit.quantize_params(vit_params)

        def pool_step(params, images_uint8):
            return pooled_query(cfg, params, images_uint8, compute_dtype)

        return Perception(
            vit_params=vit_params,
            vit_cfg=vit_cfg,
            build_step=make_build_step(cfg, vit_cfg, compute_dtype),
            query_step=make_query_step(cfg, vit_cfg, compute_dtype),
            pool_step=pool_step,
            batch_size=batch_size,
            compute_dtype=compute_dtype,
            device=dev,
        )


def state_to_pose_vec(agent_state) -> np.ndarray:
    """habitat AgentState -> (px, py, pz, qx, qy, qz, qw)."""
    p, r = agent_state.position, agent_state.rotation
    return np.array([p[0], p[1], p[2], r.x, r.y, r.z, r.w], np.float32)


class VoxelTokenMemory:
    def __init__(self, cfg: Config, env, perception: Perception,
                 detector=None, imagination=None,
                 memory_path: Optional[str] = None,
                 store_dtype=torch.float32,
                 segmented: bool = False,
                 max_device_segments: int = 1,
                 text_query_split: Optional[bool] = None):
        self.cfg = cfg
        self.Env = env
        self.perception = perception
        self.detector = detector
        self.imagination = imagination
        self._text_query_step = None     # built at the first text query
        self._text_pool_step = None
        # split text query (imagination + encode + pool, then the scan) or
        # the single step; None chooses as the JAX package does
        self.text_query_split = text_query_split
        self.last_imagined = None        # device images of the last one
        self.memory_save_path = memory_path or os.path.join(
            cfg.memory_path, cfg.sim.scene_name)
        self.device = perception.device
        self.store_dtype = store_dtype
        self.segments = None
        if segmented:
            self.segments = SegmentedStore(
                cfg.memory, store_dtype=store_dtype,
                max_device_segments=max_device_segments, device=self.device)
            self.state = self.segments.state
        else:
            self.state = init_store(cfg.memory, store_dtype=store_dtype,
                                    device=self.device)
        self._generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        self._queue: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._inv_init_host: Optional[np.ndarray] = None
        self._base_tf = G.base_axes_transform()
        self._base2cam = G.base_to_cam_transform(cfg.sensor.sensor_height)
        self.long_memory_dict: List[dict] = []
        self.base_height: List[float] = []   # agent heights while mapping
        self.step_count = 0

        self.load_single_floor = cfg.agent.load_single_floor
        self.floor_min_height: Optional[int] = None
        self.floor_max_height: Optional[int] = None

        # the reference's names, used by the robots
        self.gs = cfg.memory.grid_size
        self.cs = cfg.memory.cell_size
        self.minh = cfg.memory.zmin
        self.maxh = cfg.memory.zmax

    # ------------------------------------------------------------------
    # frame ingestion
    # ------------------------------------------------------------------
    def _host_cam_to_world(self, pose: np.ndarray) -> np.ndarray:
        hab = G.pose_vec_to_tf(
            torch.as_tensor(pose, dtype=torch.float32)).numpy()
        base_pose = self._base_tf @ hab @ np.linalg.inv(self._base_tf)
        if self._inv_init_host is None:
            self._inv_init_host = np.linalg.inv(base_pose)
        tf = self._inv_init_host @ base_pose
        return tf @ self._base_tf @ self._base2cam

    def push_frame(self, obs, pose: np.ndarray) -> None:
        with SPANS("memory.push"):
            rgb = np.asarray(obs["rgb"])[:, :, :3]
            depth = np.asarray(obs["depth"], np.float32)
            cam_tf = self._host_cam_to_world(pose)
            self._queue.append((rgb, depth, np.asarray(pose, np.float32)))
            TELEMETRY.count("memory.frames_pushed")
            if self.detector is not None and not hasattr(self.detector,
                                                         "detect_batch"):
                # host detectors run inline; batch detectors once per flush
                self._add_instances(self.detector.detect(rgb), depth, cam_tf)
            if len(self._queue) >= self.perception.batch_size:
                self.flush()

    def flush(self) -> None:
        """Ingest all queued frames, padding the last batch with
        zero-depth frames; a segmented store rotates after each batch.
        Spans (``utils.profiling.SPANS``): memory.flush, and inside it
        memory.stage and memory.h2d a batch; the ingest's counts go to the
        device counters of ``TELEMETRY``."""
        if not self._queue:
            return
        with SPANS("memory.flush"):
            self._flush()
        TELEMETRY.count("memory.flushes")
        SPANS.next_flush()

    def _flush(self) -> None:
        B = self.perception.batch_size
        H, W = self.cfg.sensor.height, self.cfg.sensor.width
        if hasattr(self.detector, "detect_batch_instances"):
            # the device long-term feed: forward -> decode -> NMS ->
            # backprojection on the device, one small copy back
            new = self.detector.detect_batch_instances(
                np.stack([f[0] for f in self._queue]),
                np.stack([f[1] for f in self._queue]),
                np.stack([self._host_cam_to_world(f[2])
                          for f in self._queue]), self.cfg)
            if new:
                self.long_memory_dict.extend(new)
                self.long_memory_integration()
        elif hasattr(self.detector, "detect_batch"):
            all_dets = self.detector.detect_batch(
                np.stack([f[0] for f in self._queue]))
            for (_, depth_f, pose_f), dets in zip(self._queue, all_dets):
                if dets:
                    self.long_memory_dict.extend(LT.instances_from_detections(
                        dets, depth_f, self._host_cam_to_world(pose_f),
                        self.cfg))
            if any(all_dets):
                self.long_memory_integration()
        while self._queue:
            chunk, self._queue = self._queue[:B], self._queue[B:]
            with SPANS("memory.stage"):
                rgb = np.zeros((B, H, W, 3), np.uint8)
                depth = np.zeros((B, H, W), np.float32)
                poses = np.tile(chunk[0][2], (B, 1))
                for i, (r, d, p) in enumerate(chunk):
                    rgb[i], depth[i], poses[i] = r, d, p
            n_bytes = rgb.nbytes + depth.nbytes + poses.nbytes
            with SPANS("memory.h2d", count=n_bytes):
                frames = [torch.from_numpy(a).to(self.device)
                          for a in (rgb, depth, poses)]
            carry, stats = self.perception.build_step(
                (self.state, self._generator), self.perception.vit_params,
                *frames)
            TELEMETRY.count_ingest(stats)
            TELEMETRY.count("memory.frames_padded", B - len(chunk))
            TELEMETRY.count("memory.h2d_bytes", n_bytes)
            self.state, self._generator = carry
            if self.segments is not None:
                self.segments.state = self.state
                if self.segments.rotate_if_full():
                    self.state = self.segments.state

    def obs2voxeltoken(self, obs, pose: np.ndarray) -> None:
        self.push_frame(obs, np.asarray(pose, np.float32))

    # ------------------------------------------------------------------
    # long-term memory
    # ------------------------------------------------------------------
    def _add_instances(self, dets, depth: np.ndarray,
                       cam_tf: np.ndarray) -> None:
        if dets:
            self.long_memory_dict.extend(
                LT.instances_from_detections(dets, depth, cam_tf, self.cfg))
            self.long_memory_integration()

    def long_memory(self, obs) -> None:
        """Standalone detector pass on the agent's current view;
        ``push_frame`` already detects when a detector is configured."""
        if self.detector is None:
            return
        pose = state_to_pose_vec(self.Env.agent.get_state())
        rgb = np.asarray(obs["rgb"])[:, :, :3]
        dets = self.detector.detect(rgb)
        if dets:
            self.long_memory_dict.extend(LT.instances_from_detections(
                dets, np.asarray(obs["depth"], np.float32),
                self._host_cam_to_world(pose), self.cfg))
        self.long_memory_integration()

    def long_memory_integration(self, threshold: Optional[int] = None):
        self.long_memory_dict = LT.integrate(
            self.long_memory_dict,
            threshold or self.cfg.detector.dedup_l1_threshold)

    def long_memory_filter(self) -> List[dict]:
        if self.load_single_floor and self.floor_min_height is not None:
            return LT.filter_by_floor(
                self.long_memory_dict, self.floor_min_height,
                self.floor_max_height)
        return self.long_memory_dict

    # ------------------------------------------------------------------
    # env stepping
    # ------------------------------------------------------------------
    def excute(self, obs, actions: Sequence[str]):
        """Step the environment through ``actions`` ("stop" skipped),
        pushing each frame; every tenth step records the agent's height
        (JAX ``spatial_memory.py:285-297``).  Returns the last
        observation."""
        for action in actions:
            if action == "stop":
                continue
            obs = self.Env.sims.step(action)
            self.step_count += 1
            state = self.Env.agent.get_state()
            if self.step_count % 10 == 0:
                self.base_height.append(float(state.position[1]))
            self.push_frame(obs, state_to_pose_vec(state))
        return obs

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def _segmented(self) -> bool:
        """A segmented store of more than one segment: queries merge
        across segments."""
        return self.segments is not None and self.segments.num_segments > 1

    def _segment_query(self, pooled, K, region_radius, curr_grid):
        """One pooled query over every segment, as ``voxel_localized``'s
        tuple (JAX ``spatial_memory.py:443-462``)."""
        self.segments.state = self.state
        kwargs = {}
        if np.isfinite(region_radius):
            kwargs = dict(use_region=True, curr_grid=torch.as_tensor(
                np.array(curr_grid), dtype=torch.int32,
                device=self.device), region_radius=float(region_radius))
        if self.load_single_floor and self.floor_min_height is not None:
            kwargs.update(use_floor=True, floor_range=torch.tensor(
                [self.floor_min_height, self.floor_max_height],
                dtype=torch.int32, device=self.device))
        positions, scores = self.segments.localize(pooled, top_k=K, **kwargs)
        if len(positions) == 0:
            return (np.zeros((0, 3), int), np.zeros((0, 3), int),
                    np.zeros((0,), np.float32))
        return positions[:1], positions, scores

    def _mask_kwargs(self, region_radius: float, curr_grid):
        """Region + single-floor mask arguments of ``query_step``."""
        use_region = bool(np.isfinite(region_radius))
        use_floor = (self.load_single_floor
                     and self.floor_min_height is not None)
        return dict(
            use_region=use_region,
            curr_grid=torch.as_tensor(
                np.asarray(curr_grid if curr_grid is not None
                           else np.zeros(3)), dtype=torch.int32,
                device=self.device),
            region_radius=float(region_radius if use_region else 0.0),
            use_floor=bool(use_floor),
            floor_range=torch.as_tensor(
                [self.floor_min_height or 0, self.floor_max_height or 0],
                dtype=torch.int32, device=self.device),
        )

    @staticmethod
    def _live_topk(positions, scores):
        """Drop -inf (masked / empty-store) rows: (best [1, 3],
        positions [<=K, 3], scores [<=K])."""
        positions = positions.cpu().numpy()
        scores = scores.cpu().numpy()
        live = scores > -np.inf
        positions, scores = positions[live], scores[live]
        if len(positions) == 0:
            return np.zeros((0, 3), int), np.zeros((0, 3), int), scores
        return positions[:1], positions, scores

    def imaginary(self, text_prompt: str) -> np.ndarray:
        """text -> query images [N, H, W, 3] uint8 via the imagination."""
        if self.imagination is None:
            raise RuntimeError(
                "no imagination model configured (text queries need one; "
                "pass imagination= to VoxelTokenMemory)")
        return self.imagination(text_prompt)

    def _use_split_textq(self) -> bool:
        """The JAX package's choice (``spatial_memory.py:355-359``): split
        when T5 conditioning meets a store of more than 2^16 slots.  Both
        forms run the same work here; the choice picks the steps."""
        if self.text_query_split is not None:
            return self.text_query_split
        return (getattr(self.imagination, "t5_params", None) is not None
                and self.state.feat_count.shape[0] > (1 << 16))

    def voxel_localized_async(self, prompt, K: int = 100,
                              region_radius: float = np.inf,
                              curr_grid=None):
        """Queue a text query on the device without waiting: returns a
        zero-argument function giving ``voxel_localized``'s result, or None
        for a prompt that is not text, an imagination without
        ``imagine_core`` (none, or a plain callable: ``voxel_localized``
        renders its images through ``imaginary``) or a segmented store of
        more than one segment, as JAX ``spatial_memory.py:375-380``.
        Kernels run on the CUDA stream while the host goes on; the
        function's copy to the host waits for them."""
        if not (isinstance(prompt, str)
                and hasattr(self.imagination, "imagine_core")
                and not self._segmented()):
            return None
        self.flush()
        im = self.imagination
        inputs = im.prep_inputs(prompt)
        mask = self._mask_kwargs(region_radius, curr_grid)
        vit_params = self.perception.vit_params
        if self._use_split_textq():
            if self._text_pool_step is None:
                self._text_pool_step = make_text_pool_step(
                    self.cfg, self.perception.vit_cfg, im,
                    self.perception.compute_dtype)
            pooled, imgs = self._text_pool_step(vit_params, *inputs)
            positions, scores = localize(self.state, pooled, top_k=K, **mask)
        else:
            if self._text_query_step is None:
                self._text_query_step = make_text_query_step(
                    self.cfg, self.perception.vit_cfg, im,
                    self.perception.compute_dtype)
            positions, scores, imgs = self._text_query_step(
                self.state, vit_params, *inputs, top_k=K, **mask)

        def finish():
            self.last_imagined = imgs
            return self._live_topk(positions, scores)

        return finish

    def voxel_localized(self, prompt, K: int = 100,
                        region_radius: float = np.inf, curr_grid=None):
        """A text prompt, or image prompt(s) [H, W, 3] or [N, H, W, 3] ->
        (best_pos [1, 3], top_k_positions [<=K, 3], top_k_similarity
        [<=K]).  A text prompt takes ``voxel_localized_async``; where that
        returns None, ``imaginary`` renders the images (raising without an
        imagination), which take the image query (JAX
        ``spatial_memory.py:424-437``).  A segmented store of several
        segments pools the images and queries every segment."""
        self.flush()
        if isinstance(prompt, str):
            finish = self.voxel_localized_async(prompt, K, region_radius,
                                                curr_grid)
            if finish is not None:
                return finish()
            prompt = self.imaginary(prompt)
        arr = np.asarray(prompt)
        imgs = (arr[None] if arr.ndim == 3 else arr)[:, :, :, :3]
        imgs = torch.from_numpy(np.ascontiguousarray(
            imgs.astype(np.uint8))).to(self.device)
        if self._segmented():
            return self._segment_query(
                self.perception.pool_step(self.perception.vit_params, imgs),
                K, region_radius, curr_grid)
        positions, scores = self.perception.query_step(
            self.state, self.perception.vit_params, imgs, top_k=K,
            **self._mask_kwargs(region_radius, curr_grid))
        return self._live_topk(positions, scores)

    def voxel_localized_batch(self, prompts, K: int = 100,
                              region_radii=None, curr_grid=None):
        """Localize several prompts in one Q-query scan of the store (JAX
        ``spatial_memory.py:469-565``).  Each prompt is a str (rendered
        by ``imaginary``), an image [H, W, 3] or an image group
        [N, H, W, 3]; a repeated prompt (the same str, or the same array
        object) is pooled once.  ``region_radii`` gives one radius per
        prompt (np.inf: unrestricted) around ``curr_grid`` [3] or per
        prompt [Q, 3]; the single-floor mask applies as in
        ``voxel_localized``.  Returns one (best_pos [1, 3],
        top_k_positions, top_k_similarity) tuple per prompt.  A segmented
        store of several segments queries every segment once per prompt
        (JAX ``spatial_memory.py:527-544``)."""
        self.flush()
        pooled, cache = [], {}
        for p in prompts:
            key = p if isinstance(p, str) else id(p)
            if key not in cache:
                arr = np.asarray(self.imaginary(p) if isinstance(p, str)
                                 else p)
                imgs = (arr[None] if arr.ndim == 3 else arr)[:, :, :, :3]
                cache[key] = self.perception.pool_step(
                    self.perception.vit_params,
                    torch.from_numpy(np.ascontiguousarray(
                        imgs.astype(np.uint8))).to(self.device))
            pooled.append(cache[key])

        Q = len(prompts)
        radii = (np.full(Q, np.inf, np.float32) if region_radii is None
                 else np.asarray(region_radii, np.float32))
        grids = None
        if curr_grid is not None:
            grids = np.asarray(curr_grid, np.int32)
            if grids.ndim == 1:
                grids = np.broadcast_to(grids, (Q, 3))
        if grids is None and np.isfinite(radii).any():
            raise ValueError("finite region_radii need curr_grid")
        if self._segmented():
            return [self._segment_query(q, K, r, None if grids is None
                                        else grids[i])
                    for i, (q, r) in enumerate(zip(pooled, radii))]
        kwargs = {}
        if self.load_single_floor and self.floor_min_height is not None:
            kwargs.update(use_floor=True, floor_range=torch.tensor(
                [self.floor_min_height, self.floor_max_height],
                dtype=torch.int32, device=self.device))
        if np.isfinite(radii).any():
            kwargs.update(
                use_region=True,
                curr_grid=torch.from_numpy(np.ascontiguousarray(grids)).to(
                    self.device),
                region_radii=torch.from_numpy(radii).to(self.device))
        positions, scores = localize_batch(self.state, torch.stack(pooled),
                                           top_k=K, **kwargs)
        positions = positions.cpu().numpy()
        scores = scores.cpu().numpy()
        out = []
        for q in range(Q):
            live = scores[q] > -np.inf
            pos, sc = positions[q][live], scores[q][live]
            out.append((pos[:1], pos, sc) if len(pos) else
                       (np.zeros((0, 3), int), np.zeros((0, 3), int), sc))
        return out

    # ------------------------------------------------------------------
    # memory construction flows
    # ------------------------------------------------------------------
    def exploring_create_memory(self, save: bool = True) -> None:
        """Random-walk mapping (JAX ``spatial_memory.py:568-596``): visit
        ``random_move_num`` waypoints on the agent's island, turning 360
        degrees at each; a failed move is reported and skipped."""
        pf = self.Env.plnner.pathfinder
        obs = self.Env.sims.get_sensor_observations(0)
        self.push_frame(obs, state_to_pose_vec(self.Env.agent.get_state()))
        n_turns = int(360 / self.cfg.actions.turn_left_deg)
        for _ in range(self.cfg.agent.random_move_num):
            island_begin = pf.get_island(self.Env.agent.get_state().position)
            subgoal = pf.get_random_navigable_point()
            tries = 0
            while ((not pf.is_navigable(subgoal)
                    or pf.get_island(subgoal) != island_begin)
                   and tries < 100):
                subgoal = pf.get_random_navigable_point()
                tries += 1
            try:
                path, _ = self.Env.move2point(subgoal)
                obs = self.excute(obs, path)
                self.base_height.append(
                    float(self.Env.agent.get_state().position[1]))
                obs = self.excute(obs, ["turn_left"] * n_turns)
            except Exception as e:          # noqa: BLE001 (nav failures)
                print(f"move failed: {e}")
                continue
        self.flush()
        if save:
            self.save()

    def explore_entire_space(self, max_iterations: Optional[int] = None,
                             save: bool = True) -> None:
        """Frontier exploration (JAX ``spatial_memory.py:598-624``): turn
        in place, flush, move to the frontier target of largest
        information gain; stop when none is left."""
        max_iterations = (max_iterations
                          or self.cfg.agent.explore_max_iterations)
        n_turns = int(360 / self.cfg.actions.turn_left_deg)
        obs = self.Env.sims.get_sensor_observations(0)
        origin = np.asarray(self.Env.original_state.position)
        for _ in range(max_iterations):
            obs = self.excute(obs, ["turn_left"] * n_turns)
            self.flush()
            target = FR.select_frontier_target(
                self._known_mask(), self._navigable_mask(origin))
            if target is None:
                break
            subgoal = self.Env.get_navigable_point_near(
                self._grid2loc_2d(target[0], target[1], origin))
            try:
                path, _ = self.Env.move2point(subgoal)
                obs = self.excute(obs, path)
            except Exception as e:          # noqa: BLE001
                print(f"frontier move failed: {e}")
                continue
        self.flush()
        if save:
            self.save()

    def _known_mask(self) -> np.ndarray:
        """[gs, gs] cells of the active top-down map with a colour."""
        gs = self.gs
        cv = self.state.cv_map[:gs * gs].cpu().numpy().reshape(gs, gs, 3)
        return cv.sum(axis=-1) > 0

    def _navigable_mask(self, origin: np.ndarray) -> np.ndarray:
        """[gs, gs] navigability of the memory grid's cells (row = world
        z, col = world x around ``origin``): one lookup into a grid
        pathfinder's occupancy (``pf.nav``), else a query per cell."""
        gs, cs = self.gs, self.cs
        rows = origin[2] + (np.arange(gs) - gs // 2) * cs   # world z
        cols = origin[0] + (np.arange(gs) - gs // 2) * cs   # world x
        pf = self.Env.plnner.pathfinder
        if hasattr(pf, "nav"):
            i = np.floor((cols - pf.origin[0]) / pf.res).astype(int)
            j = np.floor((rows - pf.origin[1]) / pf.res).astype(int)
            ok_i = (i >= 0) & (i < pf.nav.shape[0])
            ok_j = (j >= 0) & (j < pf.nav.shape[1])
            ii = np.clip(i, 0, pf.nav.shape[0] - 1)
            jj = np.clip(j, 0, pf.nav.shape[1] - 1)
            return (pf.nav[ii[None, :], jj[:, None]]
                    & ok_i[None, :] & ok_j[:, None])
        out = np.zeros((gs, gs), bool)
        for r in range(gs):
            for c in range(gs):
                out[r, c] = pf.is_navigable(
                    np.array([cols[c], origin[1], rows[r]]))
        return out

    def _grid2loc_2d(self, x: float, y: float, origin: np.ndarray):
        """Frontier grid cell -> world point (``geometry.grid_to_world_2d``)."""
        return G.grid_to_world_2d((x, y), origin, self.gs, self.cs)

    def create_memory(self) -> None:
        """The reference's keyboard-driven build, headless: the exploring
        variant."""
        self.exploring_create_memory()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> None:
        """Flush, then write the reference's bundle (``memory.persistence
        .save_reference_format``) of the active store (segment) to
        ``path`` or ``memory_save_path``."""
        self.flush()
        P.save_reference_format(
            self.state, path or self.memory_save_path, self.cfg.memory,
            original_pos=np.asarray(self.Env.original_state.position),
            base_height=self.base_height,
            long_memory=self.long_memory_dict)

    def load_memory(self, init_state=None, build_map: bool = False,
                    path: Optional[str] = None) -> None:
        """Reset the environment and, unless ``build_map``, load the bundle
        at ``path`` or ``memory_save_path`` (JAX ``spatial_memory.py:678-
        710``): the store, the long-term memory, the mapping heights and
        the origin, the frame chain rebased to the saved origin, and the
        single-floor range when ``load_single_floor``."""
        path = path or self.memory_save_path
        self.Env.reset(init_state=init_state, build_map=build_map)
        if build_map:
            return
        self.state, meta = P.load_reference_format(
            path, self.cfg.memory, store_dtype=self.store_dtype,
            device=self.device)
        self.long_memory_dict = list(meta["long_memory"])
        self.base_height = list(meta["base_height"])
        self.Env.original_state.position = np.asarray(meta["original_pos"])
        # rebase the frame chain to the saved build-start pose (identity
        # rotation: build_map keeps the grid axis-aligned), so that further
        # frames and detections land in the loaded map's coordinates
        pose0 = torch.from_numpy(np.concatenate(
            [np.asarray(meta["original_pos"], np.float32),
             np.asarray([0, 0, 0, 1], np.float32)]))
        inv_init = G.initial_base_inverse(
            pose0, torch.as_tensor(self._base_tf, dtype=torch.float32))
        self.state.inv_init_base_tf.copy_(inv_init)
        self._inv_init_host = inv_init.numpy().astype(np.float64)
        if self.load_single_floor and len(self.base_height):
            n = int(self.state.num_voxels)
            heights = self.state.slot_pos[:n, 2].cpu().numpy()
            agent_h = float(self.Env.agent.get_state().position[1])
            _, self.floor_min_height, self.floor_max_height = (
                F.current_floor_range(self.base_height, agent_h, heights,
                                      self.cfg.memory.cell_size))
