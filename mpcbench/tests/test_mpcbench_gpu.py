"""On the card: each cell's run prints a correct result line in the
contract's shape, traced and not.  Skips without a CUDA card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "mpcbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 999), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"] is True, result
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["metrics"] and result["attempted"] > 0
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
