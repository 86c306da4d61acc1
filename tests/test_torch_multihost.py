"""The port's multi-process bench launcher (``python3 -m
indy7_mpc_tpu_torch.multihost_bench``) on the CPU: two gloo ranks against
one, as tests/test_multihost.py runs the JAX script.

The two runs solve the same B hypotheses from the same seed, split over
the ranks or not, so they must pick the same winner and give the same
control and wrench estimate (float32 on the kernels' plain versions).
Each run prints one JSON line, with a numeric consensus time at one rank
too.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("procs", "devices", "B", "N", "sqp_iters", "ticks", "chunk", "compile_s", "tick_s",
        "solves_per_sec", "tracking_last_chunk_mean_m", "best_idx", "u", "f_est",
        "consensus_us_per_tick", "consensus_bytes_per_tick")


def run_launcher(procs):
    out = subprocess.run(
        [sys.executable, "-m", "indy7_mpc_tpu_torch.multihost_bench",
         "--procs", str(procs), "--device", "cpu", "--backend", "gloo",
         "--B", "16", "--N", "4", "--ticks", "1", "--sqp-iters", "1"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:] + out.stdout[-500:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def runs():
    return {procs: run_launcher(procs) for procs in (2, 1)}


def test_two_process_consensus_matches_single_process(runs):
    multi, single = runs[2], runs[1]
    assert (multi["procs"], multi["devices"], single["devices"]) == (2, 2, 1)
    assert multi["best_idx"] == single["best_idx"]
    np.testing.assert_allclose(multi["u"], single["u"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(multi["f_est"], single["f_est"], rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite(multi["u"]))


@pytest.mark.parametrize("procs", [1, 2])
def test_launcher_prints_one_json_line_with_the_consensus_time(runs, procs):
    line = runs[procs]
    assert set(KEYS) <= set(line)
    assert (line["B"], line["N"], line["ticks"], line["sqp_iters"]) == (16, 4, 1, 1)
    us = line["consensus_us_per_tick"]
    assert isinstance(us, float) and np.isfinite(us) and us > 0.0
    # The (B,) errors and the winner's X, U, wrench and count, in float32.
    assert line["consensus_bytes_per_tick"] == 4 * (16 + 4 * 12 + 3 * 6 + 6 + 1)
