"""Typed, immutable configuration: the port's own copy of
``bsc_nav_tpu/config.py``, field for field (a test holds the two equal).

Replaces the reference's flat mutable argparse namespace (reference
args.py:3-114) with frozen dataclasses.  The comments on defaults are the
JAX package's; its TPU measurements are not the port's (PERF.md).

Field defaults mirror the reference constants:
  - sensor 680x680, hfov 90           (args.py:27-28, :102)
  - move 0.25 m / turn 30 deg         (args.py:33-36)
  - query image 224x224               (args.py:42-43)
  - voxel grid 1000^2, cell 0.1 m,
    height in [-10, 10] m             (args.py:54-58)
  - DINOv2 ViT-L/14-reg tokens        (args.py:50, memory_2.py:107)
  - depth in [0.1, 10] m, sample 1000 (args.py:65-67)
  - detector classes / conf 0.55      (args.py:72-73)
  - voxel cache 10 tokens, flush 50k  (memory_2.py:109-111)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

HM3D_DETECT_CLASSES: Tuple[str, ...] = (
    "seating", "chest of drawers", "bed", "bathtub", "clothes", "toilet",
    "stool", "sofa", "sink", "tv monitor", "picture", "cushion", "towel",
    "shower", "counter", "fireplace", "chair", "table", "gym equipment",
    "cabinet", "plant",
)


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Camera sensor geometry (reference args.py:24-31, :102)."""

    width: int = 680
    height: int = 680
    hfov_deg: float = 90.0
    sensor_height: float = 1.5
    min_depth: float = 0.1
    max_depth: float = 10.0


@dataclasses.dataclass(frozen=True)
class ActionConfig:
    """Discrete agent action magnitudes (reference args.py:33-36)."""

    move_forward: float = 0.25
    move_backward: float = -0.1
    turn_left_deg: float = 30.0
    turn_right_deg: float = 30.0
    look_deg: float = 15.0


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Voxel token memory geometry and capacities.

    The reference stores tokens in ragged HDF5 groups keyed by voxel id
    (memory_2.py:330-354).  On TPU we use a dense, capacity-bounded token
    store: `feats[voxel_capacity, cache_size, token_dim]` plus a dense
    `occupied_ids[grid, grid, zmax-zmin]` index mirroring the on-disk
    contract (memory_2.py:716, SURVEY §2.5).
    """

    cell_size: float = 0.1                  # args.py:57
    grid_size: int = 1000                   # args.py:58
    floor_height: float = -10.0             # args.py:54
    map_height: float = 10.0                # args.py:55
    token_dim: int = 1024                   # memory_2.py:107
    cache_size: int = 10                    # memory_2.py:111
    flush_size: int = 50_000                # memory_2.py:109 (iter_size)
    depth_sample_rate: int = 1000           # args.py:67
    # TPU-side capacity bound (dynamic occupancy -> static shapes);
    # one capacity serves tokens + RGB fusion (unified slot store)
    voxel_capacity: int = 1 << 17           # max distinct occupied voxels
    # Gaussian observation weighting (memory_2.py:873-875)
    alpha_sigma_sq: float = 0.6
    # token replacement policy: "dist" = append + random replacement
    # (memory_2.py:326-358); "surprise" = neighborhood-novelty gating +
    # most-similar replacement (memory_2.py:364-536, TPU redesign: the
    # novelty baseline is the running mean token of each neighbor voxel)
    replacement: str = "dist"
    # surprise novelty baseline: False = running-mean token per neighbor
    # voxel (cheap approximation); True = exact reference semantics (min
    # cosine distance over every CACHED neighbor token,
    # memory_2.py:375-384), computed in chunks to bound the gather size
    surprise_exact: bool = False
    neighbor_radius: int = 1
    boring_threshold: float = 0.95
    surprise_threshold: float = 0.5

    @property
    def zmin(self) -> int:
        return int(self.floor_height / self.cell_size)

    @property
    def zmax(self) -> int:
        return int(self.map_height / self.cell_size)

    @property
    def num_height_cells(self) -> int:
        return self.zmax - self.zmin


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Query-time localization parameters (memory_2.py:563, :267-270)."""

    top_k: int = 100
    query_width: int = 224
    query_height: int = 224
    imaginary_num: int = 3                  # args.py:47
    gen_width: int = 512                    # args.py:45
    gen_height: int = 512
    diffusion_steps: int = 28               # memory_2.py:267
    guidance_scale: float = 7.0             # memory_2.py:269
    cluster_eps: float = 10.0               # objnav_benchmark.py:477
    cluster_min_samples: int = 5


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Open-vocab detector feeding long-term memory (args.py:72-73)."""

    classes: Tuple[str, ...] = HM3D_DETECT_CLASSES
    confidence: float = 0.55
    dedup_l1_threshold: int = 3             # memory_2.py:993


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Frozen perception model selection (SURVEY §2.2)."""

    encoder: str = "dinov2_vitl14_reg"      # args.py:50
    clip: str = "metaclip_vith14"           # objnav_benchmark.py:309
    detector: str = "patchsim"              # pluggable: patchsim | yoloworld
    diffusion: str = "sd35_medium"          # args.py:48
    dtype: str = "bfloat16"
    weights_dir: Optional[str] = None       # directory of converted .npz weights
    # int8 W8A8 encoder serving (vit.quantize_params): ViT-L forward
    # 38.8 -> 30.8 ms/b32 measured on TPU v5e, per-token feature cosine
    # > 0.995 and retrieval ranks stable (tests/test_quant.py).  Not
    # composable with tensor-parallel encoder sharding (TP keeps bf16).
    encoder_int8: bool = False
    # int8 W8A8 on the CLIP matcher towers (clip.quantize_params) and
    # the local Qwen-VL judge decoder (qwen_vl.quantize_params) — same
    # scheme, threaded through habitat_env/make_llm (the benchmarks/
    # scripts' --int8 clip,llm).  Correctness in tests/test_quant.py;
    # on-TPU A/B
    # (tools/tpu_smoke.py r4): CLIP-H image b12 38.4 -> 32.2 ms (1.19x);
    # Qwen-3B greedy decode 512+64tok 556 -> 309 ms (1.80x — decode is
    # weight-bandwidth-bound, int8 halves HBM traffic).  Default ON.
    clip_int8: bool = True
    llm_int8: bool = True
    # int8 W8A8 on the MMDiT token matmuls (the TPU-native counterpart
    # of the reference's NF4-quantized SD3.5, memory_2.py:542-560):
    # measured 116.8 -> 101.1 ms/b6 forward, sampler drift ~5% rel.
    diffusion_int8: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout.  dp shards frames/episodes, mp shards the token
    store and large encoder matmuls over ICI (SURVEY §2.4)."""

    dp: int = 1
    mp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.mp


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Habitat scene/dataset paths (reference args.py:8-16, :90-107).

    Only used by the host-side env layer; never traced.
    """

    dataset: str = "hm3d"
    dataset_dir: str = ""
    scene_dataset_config_file: str = ""
    scene_name: str = ""
    benchmark_dataset: str = "hm3d"
    hm3d_config_path: str = ""
    mp3d_config_path: str = ""
    hm3d_scene_prefix: str = ""
    hm3d_episode_prefix: str = ""
    mp3d_scene_prefix: str = ""
    mp3d_episode_prefix: str = ""
    nav_task: str = "objnav"
    eval_episodes: int = 1000
    max_episode_steps: int = 5000
    success_distance: float = 1.0
    # navmesh recompute on scene change (reference OVONSim env.py:443-469)
    agent_radius: float = 0.18
    agent_height: float = 0.88


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Agent loop knobs (reference args.py:75-87, objnav_benchmark.py)."""

    use_only_working_memory: bool = False
    load_single_floor: bool = False
    random_move_num: int = 30
    explore_max_iterations: int = 30
    max_path_len: int = 2000                # objnav_benchmark.py:886
    check_around_rounds: int = 2            # objnav_benchmark.py:698
    llm_model: str = "gpt-4o"
    llm_base_url: Optional[str] = None      # env BSC_NAV_LLM_BASE_URL
    llm_api_key_env: str = "BSC_NAV_LLM_API_KEY"


@dataclasses.dataclass(frozen=True)
class Config:
    """Root configuration object."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    actions: ActionConfig = dataclasses.field(default_factory=ActionConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    query: QueryConfig = dataclasses.field(default_factory=QueryConfig)
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    models: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    agent: AgentConfig = dataclasses.field(default_factory=AgentConfig)
    memory_path: str = "./memory"
    seed: int = 0

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def small_test_config() -> Config:
    """A tiny config for unit tests: small grid/capacities, tiny sensors."""

    return Config(
        sensor=SensorConfig(width=64, height=64),
        memory=MemoryConfig(
            grid_size=64,
            floor_height=-3.2,
            map_height=3.2,
            token_dim=32,
            cache_size=4,
            flush_size=512,
            voxel_capacity=1 << 10,
            depth_sample_rate=8,
        ),
        query=QueryConfig(top_k=16, query_width=28, query_height=28),
    )


def llm_api_key(cfg: AgentConfig) -> Optional[str]:
    """Secrets come from the environment, never hardcoded (the reference
    hardcodes proxy keys at BSCAgent.py:286-300 -- deliberately not
    reproduced)."""

    return os.environ.get(cfg.llm_api_key_env)
