"""Episode farming over worker processes.

Counterpart of ``benchmarks/farm.py``: episode evaluation is
embarrassingly parallel, so farming is work partitioning plus result
merging -- not collectives.  This module provides both pieces:

  - `shard_episodes`: deterministic strided split of episode indices
    across processes (explicit --num-workers/--worker-id, else
    torch.distributed's rank and world size when a process group is
    initialised, like the reference's per-GPU shell launches);
  - `merge_csvs`: combine per-worker CSV shards into one results file
    for metric_summ.

  # worker i of N (any launcher: a bash loop, slurm, torchrun)
  python -m bsc_nav_tpu_torch.drivers.objnav --env fake --episodes 1000 \\
      --num-workers N --worker-id $I --csv results.worker$I.csv ...
  python -m bsc_nav_tpu_torch.drivers.farm merge --out results.csv \\
      'results.worker*.csv'
"""

from __future__ import annotations

import argparse
import csv
import glob
from typing import List, Optional


def process_info(num_workers: Optional[int] = None,
                 worker_id: Optional[int] = None):
    """(worker_id, num_workers) from explicit flags, else
    torch.distributed's (rank, world size) when a process group is
    initialised, else (0, 1)."""
    if num_workers is not None:
        return int(worker_id or 0), int(num_workers)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_episodes(n_episodes: int, num_workers: Optional[int] = None,
                   worker_id: Optional[int] = None) -> List[int]:
    """Strided episode-index assignment (stride keeps per-worker scene
    diversity high, so per-scene memory caches stay useful)."""
    wid, n = process_info(num_workers, worker_id)
    return list(range(wid, n_episodes, n))


def merge_csvs(paths: List[str], out: str) -> int:
    """Concatenate per-worker CSV shards (header written once)."""
    rows = []
    fieldnames = None
    for path in sorted(paths):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            # union headers across shards: workers may rewrite their CSV
            # with extra columns (write_metrics union-header behavior)
            for name in reader.fieldnames or []:
                if fieldnames is None:
                    fieldnames = []
                if name not in fieldnames:
                    fieldnames.append(name)
            rows.extend(reader)
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames or [],
                                restval="")
        writer.writeheader()
        for r in rows:
            writer.writerow(r)
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge")
    m.add_argument("shards", nargs="+")
    m.add_argument("--out", required=True)
    s = sub.add_parser("shard")
    s.add_argument("--episodes", type=int, required=True)
    s.add_argument("--num-workers", type=int, required=True)
    s.add_argument("--worker-id", type=int, required=True)
    args = p.parse_args(argv)
    if args.cmd == "merge":
        paths = []
        for pat in args.shards:
            paths.extend(glob.glob(pat))
        n = merge_csvs(paths, args.out)
        print(f"merged {len(paths)} shards, {n} rows -> {args.out}")
        return n
    idx = shard_episodes(args.episodes, args.num_workers, args.worker_id)
    print(" ".join(map(str, idx)))
    return idx


if __name__ == "__main__":
    main()
