"""On the card, at each cell's own size (``calibrate.py``, short windows):
one seed's served tokens within the cell's limit and both controls above
it (the reference in fp8, and the port on its own int8-row path), and a
fault planted underneath the timed path failing the check on every seed.
Run with ``pytest -m cuda perfbench/tests`` on a machine with an H100;
skips elsewhere."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _limit(cell):
    return json.loads((ROOT / "perfbench" / "cells"
                       / f"{cell}.json").read_text())["check"]["limit_gap_sd"]


def _calibrate(cell, seeds, *extra):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "perfbench/calibrate.py",
                        "--workload", cell, "--seconds", "10", "--seeds",
                        *map(str, seeds), *extra], cwd=ROOT,
                       capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(x) for x in p.stdout.strip().splitlines()[:-1]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_the_cells_limit(cell):
    limit = _limit(cell)
    (row,) = _calibrate(cell, [424242], "--control")
    assert row["widest_gap_sd"] <= limit < row["control_widest_gap_sd"]
    (row,) = _calibrate(cell, [424243], "--w4-act", "int8")
    assert row["correct"] is False and row["widest_gap_sd"] > limit


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_fails_on_every_seed(cell):
    limit = _limit(cell)
    rows = _calibrate(cell, [515151, 515152, 515153], "--fault",
                      "half_batch")
    assert len(rows) == 3
    for row in rows:
        assert row["correct"] is False and row["widest_gap_sd"] > limit
