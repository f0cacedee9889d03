"""Port parity: episode farming (``bsc_nav_tpu_torch/drivers/farm.py``)
against ``benchmarks/farm.py``.

``merge_csvs`` must write JAX's bytes on the same shards (the union of
their headers included) and ``shard_episodes`` JAX's split; two worker
processes of the port's objnav driver on the CPU, merged, must equal one
run over the same episodes (tests/test_farm.py's case, on the port).
"""

import csv
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from benchmarks import farm as jfarm
from bsc_nav_tpu_torch.drivers import farm as tfarm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODES = 4


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def test_merge_csvs_writes_jax_s_bytes(tmp_path):
    """Shards with differing headers (a worker that rewrote its CSV with
    an extra column), an empty shard and quoted cells."""
    _write(tmp_path / "r.worker1.csv", ["success", "spl", "object_goal"],
           [["1.0", "0.5", "bed"], ["0.0", "0.0", "a, b"]])
    _write(tmp_path / "r.worker0.csv",
           ["success", "spl", "object_goal", "answer_correct"],
           [["1.0", "0.25", "sofa", "1"]])
    _write(tmp_path / "r.worker2.csv", ["spl", "success"], [])
    shards = [str(p) for p in sorted(tmp_path.glob("r.worker*.csv"))][::-1]
    n = tfarm.merge_csvs(shards, str(tmp_path / "t.csv"))
    assert n == jfarm.merge_csvs(shards, str(tmp_path / "j.csv")) == 3
    got = (tmp_path / "t.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes()
    assert got.splitlines()[0] == b"success,spl,object_goal,answer_correct"
    # the CLI takes glob patterns
    assert tfarm.main(["merge", "--out", str(tmp_path / "c.csv"),
                       str(tmp_path / "r.worker*.csv")]) == 3
    assert (tmp_path / "c.csv").read_bytes() == got


@pytest.mark.parametrize("n,workers", [(10, 3), (7, 2), (2, 4)])
def test_shard_episodes_is_jax_s(n, workers):
    got = [tfarm.shard_episodes(n, num_workers=workers, worker_id=w)
           for w in range(workers)]
    assert got == [jfarm.shard_episodes(n, num_workers=workers, worker_id=w)
                   for w in range(workers)]
    assert sorted(sum(got, [])) == list(range(n))
    assert tfarm.main(["shard", "--episodes", str(n), "--num-workers",
                       str(workers), "--worker-id", "1"]) == got[1]


def test_process_info_reads_torch_distributed(monkeypatch):
    """Explicit flags first; else the process group's rank and size; else
    (0, 1)."""
    assert tfarm.process_info() == (0, 1)
    assert tfarm.process_info(4, None) == (0, 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert tfarm.process_info() == (2, 3)
    assert tfarm.shard_episodes(8) == [2, 5]
    assert tfarm.process_info(2, 1) == (1, 2)


def _run_driver(extra):
    code = ("from bsc_nav_tpu_torch.drivers import objnav\n"
            f"objnav.main({extra!r})\n")
    # three drivers at once beside the other test workers: two threads each
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_two_worker_farm_matches_single_run(tmp_path):
    shard = [str(tmp_path / "r.worker0.csv"), str(tmp_path / "r.worker1.csv")]
    common = ["--env", "fake", "--episodes", str(EPISODES), "--llm", "mock",
              "--device", "cpu", "--log-root", str(tmp_path / "logs"),
              "--memory-root", str(tmp_path / "mem")]
    procs = [_run_driver(common + ["--csv", s, "--num-workers", "2",
                                   "--worker-id", str(w)])
             for w, s in enumerate(shard)]
    single = str(tmp_path / "single.csv")
    procs.append(_run_driver(common + ["--csv", single]))
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]

    merged = str(tmp_path / "merged.csv")
    assert tfarm.merge_csvs(shard, merged) == EPISODES
    got = sorted(_rows(merged), key=lambda r: r["object_goal"])
    want = sorted(_rows(single), key=lambda r: r["object_goal"])
    assert len(got) == len(want) == EPISODES
    assert got == want
