"""On the card: each cell runs once, briefly, and its result line keeps to
the contract (run on the GPU machine with ``-m gpu``)."""

import json
import subprocess
import sys

import _perfbench_paths  # noqa: F401
import pytest
from _perfbench_paths import ROOT

from perfbench.harness import bench

CELLS = sorted(w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "8", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in bench.Cell(cell).end_to_end()}
    assert set(line["metrics"]) == want
