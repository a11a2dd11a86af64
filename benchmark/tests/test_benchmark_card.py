"""On the card (marked ``gpu``; they skip without one): a short run of
each cell through the command the driver runs, and the control at the
cell's own size.

    python -m pytest -m gpu benchmark/tests/test_benchmark_card.py
"""

import json
import subprocess
import sys
import time

import pytest

import tiny

pytestmark = pytest.mark.gpu
CELLS = ["turbo-dictation", "v3-chunks", "turbo-chunks"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "5", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    from benchmark import harness
    c = harness.load_cell(tiny.ROOT, cell)
    out = harness.execute(c, 2**31 + 88, 5.0, False, time.perf_counter(),
                          control_bits=4)
    assert out["correct"], out["checks"]
    assert out["detail"]["control_widest_gap"] > c.limits["widest_gap"]
