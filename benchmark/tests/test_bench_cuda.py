"""On the card: one short run of each cell through the command the
driver runs, its line in the contract's form and correct.  Run there
with ``python -m pytest -q -m cuda benchmark/tests/test_bench_cuda.py``."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.manifest import ROOT, load_json

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         str(2 ** 33 + 7), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-2000:]
    assert list(line)[-1] == "check"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]
