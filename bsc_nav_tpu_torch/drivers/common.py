"""Shared episode-driver machinery.

Copy of ``benchmarks/common.py`` (no JAX there), which mirrors the
reference drivers' operational behavior (reference
objnav_benchmark.py:42-100, :1233-1327): append-only CSV metrics with
crash-resume via row count, per-scene memory caching keyed by
scene+island, per-episode video/log directories.  ``save_video`` imports
``imageio`` inside the function: a host without it skips the video.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


def write_metrics(metrics: Dict, path: str) -> None:
    """Append one metrics row (objnav_benchmark.py:42-51).

    Rows may carry differing key sets (e.g. eqa adds 'answer_correct'
    conditionally); columns are keyed to the file's header, never to the
    incoming row, so appended rows can't shift.  A row introducing new
    keys rewrites the file with the union header (row count — the
    resume cursor — is unchanged)."""
    if not os.path.exists(path):
        with open(path, mode="w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(metrics.keys()))
            writer.writeheader()
            writer.writerow(metrics)
        return
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        fieldnames = list(reader.fieldnames or [])
        extra = [k for k in metrics if k not in fieldnames]
        rows = list(reader) if extra else None
    if extra:
        fieldnames += extra
        with open(path, mode="w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames, restval="",
                                    extrasaction="ignore")
            writer.writeheader()
            for row in rows:
                row.pop(None, None)
                writer.writerow(row)
            writer.writerow(metrics)
    else:
        with open(path, mode="a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames, restval="",
                                    extrasaction="ignore")
            writer.writerow(metrics)


def get_start_episode(csv_path: str) -> int:
    """Resume: row count - header - last (possibly mid-crash) row
    (objnav_benchmark.py:90-100)."""
    if not os.path.exists(csv_path):
        return 0
    with open(csv_path) as f:
        rows = sum(1 for _ in f)
    return max(0, rows - 2)


def save_video(frames: List[np.ndarray], path: str, fps: int = 5) -> None:
    """Per-episode mp4 (objnav_benchmark.py:102-162; plain frame dump)."""
    try:
        import imageio
        with imageio.get_writer(path, fps=fps) as w:
            for fr in frames:
                arr = np.asarray(fr)
                if arr.dtype != np.uint8:
                    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
                w.append_data(arr[:, :, :3])
    except Exception as e:              # noqa: BLE001 (codec availability)
        print(f"video write skipped: {e}")


@dataclass
class EpisodeRecord:
    metrics: Dict
    episode_index: int


def memory_cache_path(memory_root: str, task: str, dataset: str,
                      scene: str, island: int) -> str:
    """Per-scene-island memory bundle path
    (objnav_benchmark.py:1280)."""
    return os.path.join(memory_root, task,
                        f"{dataset}_v2", f"{scene}_island_{island}")


def run_episodes(
    robot,
    bench,
    n_episodes: int,
    episode_fn: Callable,          # (robot, episode) -> None (runs task)
    metrics_fn: Callable,          # (robot, bench, episode) -> dict
    csv_path: str,
    log_root: str = "./tmp",
    record_video: bool = False,
    ensure_memory: Optional[Callable] = None,   # (robot, bench) -> None
    num_workers: int = 1,
    worker_id: int = 0,
) -> List[EpisodeRecord]:
    """The per-episode loop every driver shares
    (objnav_benchmark.py:1255-1321).

    Multi-host farming: with num_workers > 1 each
    worker walks the SAME deterministic episode sequence but only runs
    its strided share (i % num_workers == worker_id), writing its own
    CSV shard; resume counts completed rows within the worker's share.
    The reference's analog is per-GPU shell launches (scripts/*.sh)."""
    start = get_start_episode(csv_path)
    records: List[EpisodeRecord] = []
    own_seen = 0
    for i in range(n_episodes):
        obs = bench.reset()
        if i % max(1, num_workers) != worker_id:
            continue
        own_seen += 1
        if own_seen - 1 < start:
            continue
        log_dir = os.path.join(log_root, f"trajectory_{i}")
        os.makedirs(log_dir, exist_ok=True)
        if ensure_memory is not None:
            ensure_memory(robot, bench)
        robot.reset(obs, log_dir=log_dir)
        robot.record_topdowns = record_video
        episode_fn(robot, bench.current_episode)
        metrics = metrics_fn(robot, bench, bench.current_episode)
        write_metrics(metrics, csv_path)
        if record_video and robot.episode_images:
            save_video(robot.episode_images,
                       os.path.join(log_dir, "fps.mp4"))
            if getattr(robot, "episode_topdowns", None):
                save_video(robot.episode_topdowns,
                           os.path.join(log_dir, "metric.mp4"))
        records.append(EpisodeRecord(metrics, i))
    return records


def nav_telemetry(robot) -> Dict:
    """The three query-count columns every CSV carries
    (objnav_benchmark.py:1316-1318)."""
    return {
        "long_memory_query": robot.nav_log["long_memory_query"],
        "working_memory_query": robot.nav_log["working_memory_query"],
        "search_point": robot.nav_log["search_point"],
    }
