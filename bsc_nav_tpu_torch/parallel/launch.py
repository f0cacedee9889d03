"""Start the ranks of a multi-process run and wait for them.

Each rank is a fresh ``python`` subprocess (never a fork of the caller, so
that it imports only what its own command imports) with ``RANK``,
``WORLD_SIZE`` and ``$BSC_NAV_INIT_FILE`` -- a file rendezvous in the
caller's working directory, which needs no TCP port -- in its
environment; ``parallel/mesh.make_mesh`` joins the process group from
them.  The launcher polls the ranks: when one exits non-zero it kills the
others and raises ``RankFailure``; past ``timeout_s`` it kills them all
and raises ``RankTimeout``.  Each rank's output goes to a file beside the
rendezvous, so that a rank that writes much cannot block on a pipe.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from bsc_nav_tpu_torch.parallel.mesh import INIT_FILE_ENV


class RankFailure(RuntimeError):
    """A rank exited with a non-zero code."""


class RankTimeout(RuntimeError):
    """The ranks did not all finish within the launcher's timeout."""


def rank_env(rank: int, world: int, workdir: Path,
             extra: Optional[dict] = None) -> dict:
    """The environment of rank ``rank`` of ``world``."""
    env = dict(os.environ, **(extra or {}))
    env.update(RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_RANK=str(rank),
               **{INIT_FILE_ENV: str(Path(workdir) / "rendezvous")})
    env.setdefault("OMP_NUM_THREADS", "1")
    try:
        socket.gethostbyname(socket.gethostname())
    except OSError:
        # gloo binds to the host name's address; use loopback where the
        # name does not resolve
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def _tail(path: Path, n: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def spawn(argv: Callable[[int], Sequence[str]], world: int, workdir,
          timeout_s: float, env: Optional[dict] = None,
          cwd: Optional[str] = None) -> List[str]:
    """Run ``argv(r)`` for r in 0..world-1 as rank r, all at once; return
    each rank's output (stdout and stderr) when all exit 0.  ``workdir``
    holds the rendezvous file (it must not exist yet) and the outputs."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if (workdir / "rendezvous").exists():
        raise FileExistsError(f"{workdir / 'rendezvous'}: a rendezvous file "
                              "must be fresh")
    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    list(argv(r)), stdout=out, stderr=subprocess.STDOUT,
                    env=rank_env(r, world, workdir, env), cwd=cwd))
        t_end = time.monotonic() + timeout_s
        while True:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                r = bad[0]
                raise RankFailure(
                    f"rank {r} of {world} exited {rcs[r]}:\n"
                    + _tail(logs[r]))
            if all(rc == 0 for rc in rcs):
                return [log.read_text(errors="replace") for log in logs]
            if time.monotonic() > t_end:
                late = [r for r, rc in enumerate(rcs) if rc is None]
                raise RankTimeout(
                    f"ranks {late} of {world} still running after "
                    f"{timeout_s:.0f} s:\n" + _tail(logs[late[0]]))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def python_argv(*args: str) -> Callable[[int], List[str]]:
    """argv of a rank that runs ``python args...`` (the same for every
    rank: it reads its rank from the environment)."""
    return lambda r: [sys.executable, *args]
