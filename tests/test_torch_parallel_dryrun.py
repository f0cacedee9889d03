"""The port's multi-rank dry run (``bsc_nav_tpu_torch/parallel/dryrun.py``)
and its rank launcher (``parallel/launch.py``), after
``tests/test_multichip.py``'s dry runs.

``dryrun_all(2)`` runs through the command line a user calls (``python -m
bsc_nav_tpu_torch.parallel.dryrun --ranks 2 --device cpu``), ``dryrun_all(4)``
inside the parallel tests' rank worker, which also reports that no rank
imported JAX.  Each rank checks its own results (the distributed top-K
against ``localize`` on the whole store, the MMDiT tensor-parallel against
the whole forward at 2e-4) and raises on a failure, so a passing run is
one in which every rank's checks held.  A rank that fails fails its run at
once, and one that hangs fails it at the launcher's timeout.
"""

import subprocess
import sys
import time

import pytest

from bsc_nav_tpu_torch.parallel.launch import (RankFailure, RankTimeout,
                                               spawn)

from torch_parallel_worker import REPO, run_suite


def ok_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("dryrun_multichip OK: ")]


def test_dryrun_all_2_from_the_command_line():
    """(2, 1) with the fused text query, then (1, 2) with the MMDiT under
    TP, as JAX's dry run merges the splits of a prime count."""
    r = subprocess.run(
        [sys.executable, "-m", "bsc_nav_tpu_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cpu", "--timeout", "240"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = ok_lines(r.stdout)
    assert len(lines) == 2, r.stdout
    assert "mesh dp=2 mp=1" in lines[0] and "fused text query" in lines[0]
    assert "mesh dp=1 mp=2" in lines[1] and "mmdit-tp verified" in lines[1]
    assert all("distributed top-k verified" in ln for ln in lines)


def test_dryrun_all_4_in_four_ranks(tmp_path):
    outs, errs = run_suite("dryrun", 4, tmp_path)
    assert all("dryrun" not in e for e in errs), [e.get("dryrun")
                                                 for e in errs]
    assert [int(o["dryrun.ok"]) for o in outs] == [1] * 4
    assert [e["jax_imported"] for e in errs] == [False] * 4
    lines = ok_lines(errs[0]["dryrun.lines"])
    assert [ln.split(",")[0] for ln in lines] == [
        "dryrun_multichip OK: mesh dp=4 mp=1",
        "dryrun_multichip OK: mesh dp=2 mp=2",
        "dryrun_multichip OK: mesh dp=1 mp=4"]
    assert "fused text query" in lines[1]
    assert all("mmdit-tp verified" in ln for ln in lines[1:])


def test_a_failed_rank_fails_the_run_at_once(tmp_path):
    """Rank 1 exits 3 while rank 0 waits: the launcher kills rank 0 and
    raises well inside its timeout."""
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 of 2 exited 3"):
        spawn(lambda r: [sys.executable, "-c",
                         "import os, sys, time\n"
                         "if os.environ['RANK'] == '1': sys.exit(3)\n"
                         "time.sleep(60)"], 2, tmp_path, timeout_s=30)
    assert time.monotonic() - t0 < 20


def test_a_hung_rank_fails_the_run_at_the_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RankTimeout, match=r"ranks \[0, 1\] of 2"):
        spawn(lambda r: [sys.executable, "-c", "import time; time.sleep(60)"],
              2, tmp_path, timeout_s=2)
    assert time.monotonic() - t0 < 20


def test_a_backend_that_cannot_start_raises(tmp_path):
    """No fallback: a mesh asked for NCCL where NCCL cannot start (this
    CPU-only host) raises in make_mesh, and the launcher reports the rank."""
    code = ("from bsc_nav_tpu_torch.parallel.mesh import make_mesh\n"
            "make_mesh(1, 1, device='cpu', backend='nccl')\n")
    with pytest.raises(RankFailure, match="exited 1"):
        spawn(lambda r: [sys.executable, "-c", code], 1, tmp_path,
              timeout_s=60, cwd=str(REPO))
