"""What the benchmark loads: no module whose top-level name, compared
whole, is jax, jaxlib, flax or bsc_nav_tpu (bsc_nav_tpu_torch is the
program and allowed), and the references load nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from navbench import run as R

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(*modules) -> set:
    code = PROBE.format(imports="\n".join(f"import {m}" for m in modules))
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_cell_drivers_load_no_jax():
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    drivers = {R.cell_files(bench, w["name"])[2]["driver"]
               for w in bench["workloads"]}
    mods = ["navbench.run", "navbench.harness"] + [
        f"navbench.drivers.{d}" for d in sorted(drivers)]
    top = loaded(*mods, "bsc_nav_tpu_torch.agents.spatial_memory")
    assert "bsc_nav_tpu_torch" in top
    assert not top & set(R.FORBIDDEN), top & set(R.FORBIDDEN)


def test_references_load_nothing_of_the_program():
    refs = sorted(p.stem for p in (R.PKG / "reference").glob("*.py")
                  if p.stem != "__init__")
    top = loaded(*[f"navbench.reference.{r}" for r in refs])
    assert "bsc_nav_tpu_torch" not in top
    assert not top & set(R.FORBIDDEN)


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_shim_not_jax", sys)
    assert "jaxlib" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in R.forbidden_modules()
