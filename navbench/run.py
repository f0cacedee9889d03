"""One run of one cell: ``python3 -m navbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The cell is looked up in ``BENCHMARK.json``; its configuration file, its
traffic file (which names the driver under ``navbench/drivers/``) and, in
a traced run, each per-layer metric's reader under ``navbench/metrics/``
are found by name.  The last line on stdout is the result (JSON); the
numbers the correctness check compared, each beside its limit, are the
last lines on stderr.  Without a CUDA card, or with fewer cards than the
cell asks for, the run exits 2 and prints no result; if the process has
loaded JAX or the JAX package once the window has closed, it exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bsc_nav_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Ctx:
    """Everything a driver is given."""

    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    control: bool = False

    def say(self, msg: str) -> None:
        print(f"[navbench] {msg}", file=sys.stderr, flush=True)


def cell_files(bench: Dict, workload: str):
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(PKG / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def reported_e2e(bench: Dict, workload: str):
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def reported_per_layer(bench: Dict, workload: str):
    e2e = {m["name"] for m in reported_e2e(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def metric_reader(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"navbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def result_line(ctx: Ctx, bench: Dict, out) -> Dict:
    """The contract's JSON object from a driver's outcome."""
    metrics = {}
    device = dict(out.device)
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed}
    if ctx.trace:
        for m in reported_per_layer(bench, ctx.cell["name"]):
            value = metric_reader(m["name"])(out, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        line["metrics"] = metrics
        line["device"] = device
        line["breakdown"] = out.trace.breakdown()
    else:
        for m in reported_e2e(bench, ctx.cell["name"]):
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]),
                                  "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = device
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m navbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="run the control: the program's lower-precision "
                         "path switched on (expected: correct false)")
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = cell_files(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("navbench: torch.cuda.is_available() is False; the benchmark "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"navbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    cache_dirs()
    ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), t_start=t_start,
              control=bool(args.control))
    ctx.say(f"{cell['name']} seed {args.seed} seconds {args.seconds} trace "
            f"{args.trace} control {args.control}")
    driver = importlib.import_module(f"navbench.drivers.{traffic['driver']}")
    out = driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"navbench: the process has loaded {found}; nothing the "
              "benchmark runs may import JAX or the JAX package",
              file=sys.stderr)
        return 3
    line = result_line(ctx, bench, out)
    ctx.say(f"card: {power_limit() or torch.cuda.get_device_name(0)}")
    for k, v in sorted(out.info.items()):
        ctx.say(f"{k}: {v}")
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}{' ' + c.note if c.note else ''}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
