"""One short run of every cell on the card through the benchmark's own
command, each line checked for the keys the contract asks for."""

import json
import subprocess
import sys

import pytest

from small import ROOT, bench


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the hand kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "4000000017",
         "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    else:
        assert "setup_s" in line["metrics"]
