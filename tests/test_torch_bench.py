"""The port's solve benchmarks (``indy7_mpc_tpu_torch/bench.py``,
``indy7_mpc_tpu_torch/examples/scale_bench.py``) and its last helpers on
the CPU, against the TPU package, at small sizes (B <= 8, N <= 8).

The bench's solve and chain run on K1's plain version in float64 on the
bench's own inputs, with the JAX bench's wrench draws
(``init_wrench_batch(PRNGKey(42), ...)``, float32 as ``bench.py`` draws
them) injected, since ``jax.random`` streams cannot be reproduced with
torch generators.  The oracle is the TPU package's readable solver
(``solvers/sqp.py``, jitted once, float64) chained the same way: the
line-search alphas equal, X and U within 1e-9 (tests/test_torch_sqp.py's
bound).  The printed lines carry the keys of ``bench.py`` and
``examples/scale_bench.py``, read from their sources with ast
(``chip_smoke.tpu_tool_keys``); the sweep over 2 spawned gloo ranks gives
the one-process sweep's X and U within 1e-12.  The helpers equal the TPU
package's exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from indy7_mpc_tpu.config import (
    CostConfig as JCostConfig, MPCConfig as JMPCConfig, SampleConfig as JSampleConfig,
    SQPConfig as JSQPConfig,
)
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc import reference as jreference
from indy7_mpc_tpu.mpc.sampled import init_wrench_batch as jax_init_wrench_batch
from indy7_mpc_tpu.runtime.controller import SampledController as JaxController
from indy7_mpc_tpu.solvers import sqp as jax_sqp
from indy7_mpc_tpu_torch import bench, measure
from indy7_mpc_tpu_torch.config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from indy7_mpc_tpu_torch.examples import scale_bench
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.mpc import reference
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.runtime import SampledController
from indy7_mpc_tpu_torch.sim import native

B, N, DT = 4, 8, 0.01
CPU = torch.device("cpu")
ATOL = 1e-9
SWEEP_N, SWEEP_ITERS, SWEEP_BS = 4, 1, (4, 8)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def jax_solve():
    model = jax_indy7(dtype=jnp.float64)
    return jax.jit(lambda xs, g, X, U, w: jax_sqp.batch_solve(
        model, JCostConfig(), JSQPConfig(max_iters=bench.SQP_ITERS), DT, xs, g, X, U,
        wrench_world_batch=w))


def _bench_inputs():
    """The bench's inputs at (B, N) in float64, with ``bench.py``'s wrench
    draws."""
    xs, goals, X, U, _ = (t.double() for t in measure.production_inputs(CPU, B, N))
    w = jax_init_wrench_batch(jax.random.PRNGKey(42), JSampleConfig(batch_size=B, f_ext_std=20.0),
                              jnp.float32)
    return xs, goals, X, U, torch.as_tensor(np.asarray(w, np.float64))


@pytest.mark.parametrize("reps", [1, 3], ids=["solve", "chain3"])
def test_bench_solve_and_chain_match_jax(jax_solve, reps):
    args = _bench_inputs()
    before = sqp_solve.launches
    (xs, goals, X_in, U_in, w), res = bench.chain(bench.solver(CPU, torch.float64), *args,
                                                  reps=reps)
    assert sqp_solve.launches == before  # CPU tensors: K1's plain version
    xs_j, goals_j, X, U, w_j = (np.asarray(a) for a in args)
    for i in range(reps):
        if i == reps - 1:  # the chain's last solve starts where JAX's does
            np.testing.assert_allclose(X_in.numpy(), X, rtol=0, atol=ATOL)
            np.testing.assert_allclose(U_in.numpy(), U, rtol=0, atol=ATOL)
        ref = jax_solve(xs_j, goals_j, X, U, w_j)
        X, U = np.asarray(ref.X), np.asarray(ref.U)
    np.testing.assert_array_equal(res.stats.alphas.numpy(), np.asarray(ref.stats.alphas))
    np.testing.assert_allclose(res.X.numpy(), X, rtol=0, atol=ATOL)
    np.testing.assert_allclose(res.U.numpy(), U, rtol=0, atol=ATOL)
    assert res.X.dtype == torch.float64 and np.isfinite(X).all()


def test_bench_measure_on_the_cpu():
    """``measure`` at a small size: host-clock figures only (no device
    time on the CPU), the last chained solve the chain's."""
    before = sqp_solve.launches
    m = bench.measure(2, 4, CPU, reps=2, dispatch_iters=1, chain_iters=2)
    assert sqp_solve.launches == before
    assert m.chained_s > 0 and m.dispatch_s > 0
    assert m.chain_event_s is None and m.host_ahead is None
    (_, _, X0, U0, _), res0 = m.first  # the warm-up solve, from zeros
    assert not X0.any() and not U0.any() and torch.isfinite(res0.X).all()
    (xs, goals, X, U, w), res = m.last
    assert tuple(X.shape) == (2, 4, 12) and tuple(res.U.shape) == (2, 3, 6)
    assert torch.isfinite(res.X).all() and tuple(res.stats.alphas.shape) == (2, bench.SQP_ITERS)
    torch.testing.assert_close(w, measure.production_inputs(CPU, 2, 4)[4], rtol=0, atol=0)


def test_bench_main_prints_bench_py_line(monkeypatch, capsys):
    for name, value in (("B", 2), ("HORIZONS", (4, 6)), ("R", 2), ("DISPATCH_ITERS", 1),
                        ("CHAIN_ITERS", 1)):
        monkeypatch.setattr(bench, name, value)
    report = bench.main(["--device", "cpu"])
    out = capsys.readouterr()
    (line,) = _json_lines(out.out)
    assert set(line) == chip_smoke.tpu_tool_keys("bench")
    assert line == report["line"] and line["metric"] == "sqp_mpc_solves_per_sec_chip_b2_n6"
    assert line["unit"] == "solves/s" and line["value"] == line["median"] > 0
    assert line["min"] <= line["median"] <= line["max"]
    assert line["vs_baseline"] == round(line["median"] / bench.REF_SOLVES_PER_SEC, 3)
    # One stderr line a horizon, naming what ran; no device-time line.
    err = [s for s in out.err.splitlines() if s.startswith("# B=2 N=")]
    assert [s.split(":")[0] for s in err] == ["# B=2 N=4", "# B=2 N=6"]
    assert all(report["device"] in s for s in err) and "cpu" in report["device"]
    assert sorted(report["runs"]) == [4, 6] and all(len(v) == 3 for v in report["runs"].values())


@pytest.mark.parametrize("module", [bench, scale_bench], ids=["bench", "scale_bench"])
def test_benches_default_to_the_card(module):
    """Without ``--device`` each runs on CUDA; where CUDA is missing it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


@pytest.fixture(scope="module")
def one_process_sweep():
    before = sqp_solve.launches
    rows = []
    final, last = scale_bench.sweep(CPU, N=SWEEP_N, iters=SWEEP_ITERS, Bs=SWEEP_BS, reps=1,
                                    emit=rows.append)
    assert sqp_solve.launches == before
    return rows, final, last


def test_sweep_lines_have_scale_bench_keys(one_process_sweep):
    rows, final, last = one_process_sweep
    keys = chip_smoke.tpu_tool_keys("scale_bench")
    assert [set(r) for r in rows] == [keys["row"]] * len(SWEEP_BS)
    assert set(final) == keys["final"] and [set(r) for r in final["sweep"]] == [
        keys["final_row"]] * len(SWEEP_BS)
    assert [r["B"] for r in rows] == list(SWEEP_BS) and all(r["finite"] for r in rows)
    assert (final["N"], final["sqp_iters"], final["sharded_mesh"]) == (SWEEP_N, SWEEP_ITERS, None)
    assert final["sweep"][0]["scaling_efficiency_vs_b64"] == round(
        final["sweep"][0]["solves_per_sec"] / SWEEP_BS[0] / (rows[0]["solves_per_sec"] / 64), 3)
    for Bk in SWEEP_BS:
        (xs, goals, X, U, w), res = last[Bk]
        assert tuple(res.X.shape) == (Bk, SWEEP_N, 12) and torch.isfinite(res.X).all()
        torch.testing.assert_close(w, measure.production_inputs(CPU, Bk, SWEEP_N)[4],
                                   rtol=0, atol=0)


def test_scale_bench_main_prints_the_sweep(monkeypatch, capsys):
    monkeypatch.setattr(scale_bench, "BS", SWEEP_BS)
    monkeypatch.setattr(scale_bench, "default_reps", lambda B: 1)
    final, last = scale_bench.main([str(SWEEP_N), str(SWEEP_ITERS), "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    keys = chip_smoke.tpu_tool_keys("scale_bench")
    assert [set(x) for x in lines] == [keys["row"]] * len(SWEEP_BS) + [keys["final"]]
    assert lines[-1] == final and sorted(last) == list(SWEEP_BS)
    assert final["sharded_mesh"] is None and all(r["finite"] for r in final["sweep"])


def test_default_reps_are_scale_bench_py():
    assert [scale_bench.default_reps(b) for b in (8, 64, 256, 1024, 4096, 1 << 20)] == [
        2000, 2000, 500, 125, 31, 5]


def test_mesh_sweep_on_two_gloo_ranks_equals_one_process(monkeypatch, capsys, one_process_sweep):
    """``--mesh`` on the CPU: 2 spawned gloo ranks, each with its block of
    the inputs committed once; every row's final X and U (gathered) equal
    the one-process sweep's within 1e-12."""
    monkeypatch.setattr(scale_bench, "BS", SWEEP_BS)
    run_mesh = scale_bench.run_mesh
    monkeypatch.setattr(scale_bench, "run_mesh", lambda *a, **kw: run_mesh(*a, reps=1, **kw))
    final, ranks = scale_bench.main([str(SWEEP_N), str(SWEEP_ITERS), "--mesh", "--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    keys = chip_smoke.tpu_tool_keys("scale_bench")
    assert lines[0] == {"mesh_devices": 2, "backend": "kernel-gloo"}
    assert set(lines[0]) == keys["mesh"]
    assert [set(x) for x in lines[1:]] == [keys["row"]] * len(SWEEP_BS) + [keys["final"]]
    assert final["sharded_mesh"] == 2 and lines[-1] == final
    assert all(r["finite"] for r in final["sweep"])
    _, _, last = one_process_sweep
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["launches"] == 0 and r["final"] == final  # CPU tensors: the plain version
        for Bk in SWEEP_BS:
            np.testing.assert_allclose(r["X"][Bk], last[Bk][1].X.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(r["U"][Bk], last[Bk][1].U.numpy(), rtol=0, atol=1e-12)


def test_flatten6_matches_jax():
    ref = np.random.default_rng(3).normal(size=(7, 3))
    np.testing.assert_array_equal(reference.flatten6(ref), jreference.flatten6(ref))


@pytest.fixture(scope="module")
def fig8():
    return reference.with_padding(reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                                                    period=1, dt=DT, cycles=1), 20)


OFFSETS = {"start": 0, "mid": 55, "end": 112, "past_end": 140}


@pytest.mark.parametrize("offset", OFFSETS.values(), ids=OFFSETS.keys())
def test_goal_window_matches_jax(fig8, offset):
    got = reference.goal_window(fig8, offset, N)
    np.testing.assert_array_equal(got, jreference.goal_window(fig8, offset, N))
    assert got.shape == (max(0, min(N, fig8.shape[0] - offset)), 3)


@pytest.mark.parametrize("offset", [0.0, 55.7, 112.0, 140.2], ids=OFFSETS.keys())
def test_controller_goal_window_matches_jax(fig8, offset):
    """The window at ``int(ref_offset)``, clamped to the last N rows past
    the end as ``jax.lax.dynamic_slice_in_dim`` clamps."""
    mpc, sample = MPCConfig(N=N, dt=DT), SampleConfig(batch_size=2)
    ctl = SampledController(indy7(torch.float32), CostConfig(), SQPConfig(max_iters=1), mpc,
                            sample, fig8, warmup=False, device="cpu")
    jctl = JaxController(jax_indy7(dtype=jnp.float32), JCostConfig(), JSQPConfig(max_iters=1),
                         JMPCConfig(N=N, dt=DT), JSampleConfig(batch_size=2), fig8,
                         warmup=False)
    ctl.ref_offset = jctl.ref_offset = offset
    got = ctl.goal_window()
    assert tuple(got.shape) == (N, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jctl.goal_window()))


def test_native_available_reads_the_build_dir(tmp_path, monkeypatch):
    """``available()`` says whether the current sources' library exists
    under ``build_dir()``, and builds nothing."""
    assert native.available() == (native.build_dir() / native.LIB_NAME).exists()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    assert not native.available()
    assert list(tmp_path.iterdir()) == []  # nothing built
    native.build_dir().mkdir(parents=True)
    (native.build_dir() / native.LIB_NAME).write_bytes(b"")
    assert native.available()
