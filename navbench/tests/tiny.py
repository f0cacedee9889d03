"""A cell cut small enough for the CPU: every width and the scene shrunk,
the same code paths."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent


def config(name: str = "habitat-dinov2l") -> dict:
    c = json.loads((PKG / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    c["sensor"].update(width=64, height=64)
    c["memory"].update(grid_size=128, voxel_capacity=65536,
                       depth_sample_rate=16, token_dim=32, cache_size=4)
    c["query"].update(query_width=28, query_height=28)
    c["encoder"].update(img_size=28, dim=32, depth=2, heads=2)
    return c


def traffic(name: str = "room-patrol") -> dict:
    """A 40-step loop (12 turns, legs of 4 steps) in a 3 x 3 m room."""
    t = json.loads((PKG / "traffic" / f"{name}.json").read_text())
    t.update(loop_steps_z=4, loop_steps_x=4, margin_x_m=1.0, margin_z_m=1.0,
             wall_boxes=4, centre_boxes=0, warmup_flushes=1,
             trace_seconds=0.5)
    return t


def ctx(seconds=1.0, seed=7, trace=False, control=False, **over):
    from navbench.run import Ctx
    cell = {"name": "tiny", "chips": 1}
    return Ctx(cell=cell, config=over.get("config") or config(),
               traffic=over.get("traffic") or traffic(), seed=seed,
               seconds=seconds, trace=trace, t_start=time.perf_counter(),
               device="cpu", control=control)
