"""The port's diagnostic tools (``indy7_mpc_tpu_torch/tools/``) on the CPU,
at small sizes (B <= 8, N <= 8, ticks <= 20, ``--device cpu``).

Each tool's ``main`` prints a JSON line whose keys include those of its
counterpart in the repository's ``tools/`` (read from that script's source
with ast by ``chip_smoke.tpu_tool_keys``, or from the committed
``MULTIHOST_EFF.json``), and writes its own files, never the TPU tools'.
The stage table's linearization and QP rows compute what the TPU package's
``kkt.build_qp_gn`` and ``riccati.solve`` compute on the same numpy inputs
(float64, 1e-9); the QP A/B's two backends agree on its blocks.
"""
import gc
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from indy7_mpc_tpu.config import CostConfig as JCostConfig
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.ops import kkt as jkkt
from indy7_mpc_tpu.ops import riccati as jriccati
from indy7_mpc_tpu_torch import measure
from indy7_mpc_tpu_torch.config import CostConfig, SQPConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import riccati, riccati_pscan
from indy7_mpc_tpu_torch.ops.kernels import _build
from indy7_mpc_tpu_torch.parallel.sharding import consensus_bytes
from indy7_mpc_tpu_torch.tools import (
    consensus_collective_bench, latency_decomp, multihost_eff, profile_kernel_stages,
    profile_pscan, profile_solve,
)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = [latency_decomp, profile_kernel_stages, profile_solve, profile_pscan,
         consensus_collective_bench, multihost_eff]
DT = 0.01


def _name(module):
    return module.__name__.rsplit(".", 1)[-1]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("module", TOOLS, ids=_name)
def test_tools_default_to_the_card(module):
    """Without ``--device`` each tool runs on CUDA; where CUDA is missing it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


def test_latency_decomp_main(capsys, tmp_path, monkeypatch):
    for name, reps in (("RTT_REPS", 5), ("CHAIN", 2), ("CHAINS", 1), ("SOLVE_REPS", 2),
                       ("TICK_REPS", 2)):
        monkeypatch.setattr(latency_decomp, name, reps)
    out = tmp_path / "lat.md"
    assert latency_decomp.main(["--B", "4", "--N", "8", "--ticks", "6", "--stall-ms", "0",
                                "--device", "cpu", "--out", str(out)]) == 0
    (report,) = _json_lines(capsys.readouterr().out)
    assert chip_smoke.tpu_tool_keys("latency_decomp") <= set(report)
    assert report["config"] == "B=4 N=8 iters=2" and report["platform"] == "cpu"
    assert report["loop_ticks"] == 6 and report["solve_device_host_ahead"] is None
    # Every tick is over a 0 ms threshold; the loop builds nothing.
    assert [s["tick"] for s in report["stalls_over_thresh"]] == list(range(6))
    assert report["compiles_during_loop"] == report["gc_gen2_during_loop"]
    assert report["library_builds_or_loads_during_loop"] == 0
    # The seven rows of the TPU tool's table; the last five by its labels.
    row_labels = lambda text: [line.split(" | ")[0].lstrip("| ") for line in text.splitlines()
                               if line.startswith("| ") and not line.startswith("| quantity")]
    ours, theirs = row_labels(out.read_text()), row_labels((ROOT / "LATENCY.md").read_text())
    assert len(ours) == len(theirs) == 7
    assert ours[2:6] == theirs[2:6] and ours[6].split(" (")[0] == theirs[6].split(" (")[0]
    assert "## Stall hunt" in out.read_text() and "## Attribution" in out.read_text()
    default = Path(latency_decomp.build_parser().parse_args([]).out)
    assert default.name == "LATENCY_TORCH.md" and default != ROOT / "LATENCY.md"


def test_stall_hunt_counts_its_events():
    hunt = latency_decomp.StallHunt(torch.device("cpu"))
    before = hunt.counts()
    gc.collect()
    _build.counts["loads"] += 1
    try:
        after = hunt.counts()
    finally:
        _build.counts["loads"] -= 1
    assert set(before) == set(after) == set(latency_decomp.EVENT_KINDS)
    got = latency_decomp.diff(after, before)
    assert got["gc_gen2"] >= 1 and got["library_builds_or_loads"] == 1
    assert got["allocator_segments"] == got["alloc_retries"] == 0  # no CUDA allocator here


def test_profile_kernel_stages_has_no_cut_on_the_cpu():
    with pytest.raises(SystemExit, match="no stage cut"):
        profile_kernel_stages.main(["4", "8", "--device", "cpu"])


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    B, N = 3, 8
    w = rng.normal(size=(B, 6)) * 20
    w[:, 3:] = 0.0
    return {"xs": rng.normal(size=(B, 12)) * 0.05,
            "goals": np.tile(np.array([0.35, 0.35, 0.6]), (B, N, 1)),
            "X": rng.normal(size=(B, N, 12)) * 0.05, "U": rng.normal(size=(B, N - 1, 6)) * 0.5,
            "w": w}


def test_profile_solve_rows_match_jax(problem):
    """The linearization and QP rows against the TPU package's
    ``kkt.build_qp_gn`` and ``riccati.solve`` (the TPU tool's ``lin`` and
    ``qp``, rho 1e-6), float64."""
    p = {k: torch.as_tensor(v) for k, v in problem.items()}
    (_, lin), (_, qp), _ = profile_solve.stage_fns(
        indy7(torch.float64), CostConfig(), SQPConfig(max_iters=2), DT, p["xs"], p["goals"],
        p["X"], p["U"], p["w"], "cuda")
    blocks, sol = lin(), qp()
    jmodel, jcost = jax_indy7(dtype=jnp.float64), JCostConfig()
    jblocks = jax.jit(jax.vmap(lambda X, U, g, w: jkkt.build_qp_gn(
        jmodel, jcost, X, U, g, DT, wrench_world=w)))(
        problem["X"], problem["U"], problem["goals"], problem["w"])
    jsol = jax.jit(jax.vmap(lambda b, x: jriccati.solve(b, x, 1e-6)))(jblocks, problem["xs"])
    for got, want in ((blocks, jblocks), (sol, jsol)):
        for name in got._fields:
            np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=0, atol=1e-9, err_msg=name)


def test_profile_solve_main(capsys, tmp_path):
    assert profile_solve.main(["2", "4", "--iters", "1", "--device", "cpu",
                               "--trace", str(tmp_path / "trace")]) == 0
    (out,) = _json_lines(capsys.readouterr().out)
    assert {r["stage"].split(" (")[0] for r in out["rows"]} == chip_smoke.tpu_tool_keys(
        "profile_solve")
    assert out["rows"][-1]["stage"] == "full solve (cuda)"
    assert all(np.isfinite(r["us_per_call"]) and r["us_per_call"] > 0 for r in out["rows"])
    assert Path(out["trace"]).exists() and json.loads(Path(out["trace"]).read_text())


def test_profile_pscan_backends_agree(capsys):
    blocks, xs0, rho = measure.qp_blocks(torch.device("cpu"), 4, 8)
    seq = profile_pscan.chain(riccati.solve, blocks, xs0, rho, 3)
    scan = profile_pscan.chain(riccati_pscan.solve_pscan, blocks, xs0, rho, 3)
    np.testing.assert_allclose(scan.numpy(), seq.numpy(), rtol=1e-6, atol=1e-9)
    assert profile_pscan.main(["2", "4", "--chain", "2", "--device", "cpu"]) == 0
    (out,) = _json_lines(capsys.readouterr().out)
    assert {r["backend"] for r in out["rows"]} == chip_smoke.tpu_tool_keys("profile_pscan")
    a, b = (r["out_mean_abs"] for r in out["rows"])
    assert np.isfinite(a) and a == pytest.approx(b, rel=1e-6)


def test_consensus_bench_reports_the_consensus_bytes(capsys):
    assert consensus_collective_bench.main(["--device", "cpu", "--B", "8", "--N", "4"]) == 0
    (out,) = _json_lines(capsys.readouterr().out)
    assert chip_smoke.tpu_tool_keys("consensus_collective_bench") <= set(out)
    assert out["procs"] == out["devices"] == 2 and out["cards"] == 0
    assert out["bytes_per_tick"] == consensus_bytes(8, 4)
    assert len(out["us_per_tick_by_rank"]) == 2 and out["us_per_tick"] > 0


def test_multihost_eff_writes_its_own_file(capsys, tmp_path):
    path = tmp_path / "eff.json"
    assert multihost_eff.main(["--procs", "2", "--B", "8", "--N", "4", "--ticks", "1",
                               "--sqp-iters", "1", "--lanes-per-proc", "4", "--device", "cpu",
                               "--out", str(path)]) == 0
    doc = json.loads(path.read_text())
    want = chip_smoke.tpu_tool_keys("multihost_eff")
    assert want[""] | {"weak_scaling"} <= set(doc)
    for level in ("results", "collective_accounting"):
        (row,) = doc[level]
        assert want[level] <= set(row) and row["procs"] == 2
    assert doc["results"][0]["consensus_match"] is True
    assert [r["procs"] for r in doc["weak_scaling"]] == [1, 2]
    assert [r["B"] for r in doc["weak_scaling"]] == [4, 8]
    assert doc["config"]["backend"] == "gloo" and "plain versions" in doc["notes"]["cards"]
    default = Path(multihost_eff.build_parser().parse_args([]).out)
    assert default.name == "MULTIHOST_EFF_TORCH.json" and default != ROOT / "MULTIHOST_EFF.json"
