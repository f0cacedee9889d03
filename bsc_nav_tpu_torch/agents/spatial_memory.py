"""Host-side spatial memory agent over the torch pipelines.

Counterpart of ``bsc_nav_tpu/agents/spatial_memory.py`` for the memory
spine: frames are queued on the host and ingested in fixed-size batches
(short batches padded with zero-depth frames, whose points all fail the
min-depth gate), and image prompts are localized against the store.

Not ported yet, and raising ``NotImplementedError`` when asked for:
text prompts (imagination), detectors and the long-term memory,
segmented stores, batched queries and persistence -- each is a later
item of ROADMAP.md Queue 1.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from bsc_nav_tpu.config import Config
from bsc_nav_tpu_torch import geometry as G
from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.memory.pipeline import make_build_step, make_query_step
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.models.weights import load_dinov2_npz


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to bsc_nav_tpu_torch yet (ROADMAP.md Queue 1 "
        f"item {item})")


@dataclasses.dataclass
class Perception:
    """The encoder and the two pipelines, shared across scenes.
    ``vit_params`` is the ViT module holding the weights."""

    vit_params: vit.ViT
    vit_cfg: vit.ViTConfig
    build_step: Callable
    query_step: Callable
    batch_size: int = 8
    compute_dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    @staticmethod
    def create(cfg: Config, vit_cfg: Optional[vit.ViTConfig] = None,
               vit_params: Optional[vit.ViT] = None, batch_size: int = 8,
               compute_dtype=torch.float32, seed: int = 0,
               device="cpu") -> "Perception":
        dev = resolve_device(device)
        vit_cfg = vit_cfg or vit.CONFIGS[cfg.models.encoder]
        if cfg.models.encoder_int8:
            raise _not_ported("the int8 W8A8 encoder (encoder_int8)", "5")
        if vit_params is None:
            weights = (os.path.join(cfg.models.weights_dir,
                                    cfg.models.encoder + ".npz")
                       if cfg.models.weights_dir else None)
            if weights and os.path.exists(weights):
                vit_params = load_dinov2_npz(weights, vit_cfg, device=dev)
            else:
                if weights:
                    print(f"[perception] WARNING: encoder weights not found "
                          f"at {weights!r} -- using RANDOM-INIT "
                          f"{cfg.models.encoder} params", file=sys.stderr)
                gen = torch.Generator(device=dev).manual_seed(seed)
                vit_params = vit.init_params(vit_cfg, gen, device=dev)
        return Perception(
            vit_params=vit_params,
            vit_cfg=vit_cfg,
            build_step=make_build_step(cfg, vit_cfg, compute_dtype),
            query_step=make_query_step(cfg, vit_cfg, compute_dtype),
            batch_size=batch_size,
            compute_dtype=compute_dtype,
            device=dev,
        )


class VoxelTokenMemory:
    def __init__(self, cfg: Config, env, perception: Perception,
                 detector=None, imagination=None,
                 store_dtype=torch.float32,
                 segmented: bool = False):
        if detector is not None:
            raise _not_ported("the detector feed", "10")
        if imagination is not None:
            raise _not_ported("imagination (text queries)", "13")
        if segmented:
            raise _not_ported("the segmented store", "11")
        self.cfg = cfg
        self.Env = env
        self.perception = perception
        self.device = perception.device
        self.state = init_store(cfg.memory, store_dtype=store_dtype,
                                device=self.device)
        self._generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed)
        self._queue: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._inv_init_host: Optional[np.ndarray] = None
        self._base_tf = G.base_axes_transform()
        self._base2cam = G.base_to_cam_transform(cfg.sensor.sensor_height)

        self.load_single_floor = cfg.agent.load_single_floor
        self.floor_min_height: Optional[int] = None
        self.floor_max_height: Optional[int] = None

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
        rgb = np.asarray(obs["rgb"])[:, :, :3]
        depth = np.asarray(obs["depth"], np.float32)
        self._host_cam_to_world(pose)      # fixes the host frame chain
        self._queue.append((rgb, depth, np.asarray(pose, np.float32)))
        if len(self._queue) >= self.perception.batch_size:
            self.flush()

    def flush(self) -> None:
        """Ingest all queued frames, padding the last batch with
        zero-depth frames."""
        B = self.perception.batch_size
        H, W = self.cfg.sensor.height, self.cfg.sensor.width
        while self._queue:
            chunk, self._queue = self._queue[:B], self._queue[B:]
            rgb = np.zeros((B, H, W, 3), np.uint8)
            depth = np.zeros((B, H, W), np.float32)
            poses = np.tile(chunk[0][2], (B, 1))
            for i, (r, d, p) in enumerate(chunk):
                rgb[i], depth[i], poses[i] = r, d, p
            dev = self.device
            carry, _ = self.perception.build_step(
                (self.state, self._generator), self.perception.vit_params,
                torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev),
                torch.from_numpy(poses).to(dev))
            self.state, self._generator = carry

    def obs2voxeltoken(self, obs, pose: np.ndarray) -> None:
        self.push_frame(obs, np.asarray(pose, np.float32))

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
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

    def voxel_localized(self, prompt, K: int = 100,
                        region_radius: float = np.inf, curr_grid=None):
        """Image prompt(s) [H, W, 3] or [N, H, W, 3] -> (best_pos [1, 3],
        top_k_positions [<=K, 3], top_k_similarity [<=K])."""
        if isinstance(prompt, str):
            raise _not_ported("text prompts (imagination)", "13")
        self.flush()
        arr = np.asarray(prompt)
        imgs = (arr[None] if arr.ndim == 3 else arr)[:, :, :, :3]
        imgs = torch.from_numpy(np.ascontiguousarray(
            imgs.astype(np.uint8))).to(self.device)
        positions, scores = self.perception.query_step(
            self.state, self.perception.vit_params, imgs, top_k=K,
            **self._mask_kwargs(region_radius, curr_grid))
        return self._live_topk(positions, scores)

    def voxel_localized_batch(self, prompts, K: int = 100,
                              region_radii=None, curr_grid=None):
        raise _not_ported("batched queries (localize_batch)", "6")

    def save(self, path: Optional[str] = None) -> None:
        raise _not_ported("memory persistence (save)", "9")

    def load_memory(self, init_state=None, build_map: bool = False,
                    path: Optional[str] = None) -> None:
        raise _not_ported("memory persistence (load_memory)", "9")
