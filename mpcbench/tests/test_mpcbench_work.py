"""The frozen work counts start where the program's own bounds stand:
at the cells' shapes they equal ``roofline.k1_work`` and ``k2_work``."""
import json
from pathlib import Path

import pytest

from mpcbench.work import k1, k2, peaks

from indy7_mpc_tpu_torch import roofline
from indy7_mpc_tpu_torch.config import CostConfig, SQPConfig

ROOT = Path(__file__).resolve().parents[2]


def cell_shapes():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = set()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        out.add((cfg["batch_size"], cfg["horizon"], cfg["sqp"]["max_iters"],
                 cfg["sqp"]["num_alphas"], cfg["plant"]["substeps"]))
    return sorted(out)


@pytest.mark.parametrize("B,N,iters,alphas,substeps", cell_shapes())
def test_counts_equal_the_programs_bounds(B, N, iters, alphas, substeps):
    assert k1.work(B, N, iters, alphas) == roofline.k1_work(
        B, N, CostConfig(), SQPConfig(max_iters=iters, num_alphas=alphas), use_wrench=True)
    # The loop's K2 (consensus and plant) and the controller's two calls.
    assert k2.work(B, substeps, True, True) == roofline.k2_work(B, substeps, True, True)
    assert k2.work(B, 0, False, False) == roofline.k2_work(B, 0, False, False)
    assert k2.work(1, substeps, True, True) == roofline.k2_work(1, substeps, True, True)


def test_bound_of_the_b64_n64_solve():
    """K1 at B=64/N=64 is bound by its operations, 19.23 µs (PERF.md)."""
    seconds, which = peaks.bound_s(*k1.work(64, 64, 2, 8))
    assert which == "operations"
    assert abs(seconds * 1e6 - 19.229) < 1e-3
