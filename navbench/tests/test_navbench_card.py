"""On the card: one sound run of every cell comes out correct, and the
control -- the program's own lower-precision path switched on (the int8
W8A8 encoder for the bf16 ViT-L) -- comes out not correct, at the cell's
own size.  Run on a machine with a card:
``python3 -m pytest -m cuda navbench/tests/test_navbench_card.py``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from navbench import run as R


def _run(workload: str, seed: int, control: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "navbench", "--workload", workload, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", "--control",
         str(control)], cwd=R.ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cells():
    return [w["name"] for w in
            R.load_json(R.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_sound_run_is_correct_on_the_card(card, workload):
    line = _run(workload, 2 ** 31 + 17, 0)
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_control_is_not_correct_on_the_card(card, workload):
    line = _run(workload, 2 ** 31 + 18, 1)
    assert not line["correct"], line["checks"]
