"""The port's lane sharding (``indy7_mpc_tpu_torch/parallel/``) over gloo
ranks on the CPU, against the TPU package; the cases of
tests/test_sharding.py.

Each rank is a process spawned by ``parallel._worker.spawn`` (the jobs
live in the package, so no rank imports this file or JAX); one spawn of 2
ranks and one of 4 run every job, and the tests read their results.  The
JAX oracles run here, float64:

  * the batch solve: ``solvers/sqp.py::batch_solve`` jitted, as
    tests/test_torch_sqp.py's oracle, at B=16, N=6;
  * the closed loop: the ``fused=False`` tick that ``run_sampled_mpc``
    scans, jitted and stepped for 4 ticks at B=8, N=6 from
    ``init_loop_carry``, each tick's draws replayed from its key as in
    tests/test_torch_slice.py.  Its tick calls ``sampled_tick``, so each
    step's carry before and after is also the oracle of the sharded host
    tick, with the same injected normals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
from indy7_mpc_tpu.dynamics import ee_pos as jax_ee_pos
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc.sampled import init_loop_carry, make_loop_tick
from indy7_mpc_tpu.solvers import sqp as jax_sqp
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.mpc import (
    SampledLoopCarry, TickDraws, resample_wrench_batch, run_sampled_mpc, sampled_tick,
)
from indy7_mpc_tpu_torch.parallel import (
    LaneMesh, make_lane_mesh, make_sharded_batch_solve, make_sharded_sampled_loop,
    make_sharded_sampled_tick, shard_lanes,
)
from indy7_mpc_tpu_torch.parallel import _worker, distributed
from indy7_mpc_tpu_torch.parallel.sharding import resolve_backend
from indy7_mpc_tpu_torch.solvers import sqp_cuda

DT = 0.01
SOLVE_B, SOLVE_N, SOLVE_SQP = 16, 6, cfg.SQPConfig(max_iters=2)
LOOP_B, LOOP_N, TICKS, LOOP_SQP = 8, 6, 4, cfg.SQPConfig(max_iters=1)
MPC = cfg.MPCConfig(N=LOOP_N, dt=DT)
SAMPLE = cfg.SampleConfig(batch_size=LOOP_B, f_ext_std=5.0)
F_TRUE0 = [4.0, 0.0, -6.0, 0.0, 0.0, 0.0]
SQP_ATOL = 1e-9  # tests/test_torch_sqp.py's ATOL
BACKENDS = ["kernel", "readable"]
CONSENSUS_LANES = 4  # a rank's lanes in the consensus cases


def _replay_draws(key):
    """One loop tick's draws, as the readable JAX tick consumes its key
    (no plant noise: the nominal plant)."""
    _, k_tick, k_walk, _ = jax.random.split(key, 4)
    key_r, _ = jax.random.split(k_tick)
    return TickDraws(
        resample=np.asarray(jax.random.normal(key_r, (LOOP_B, 6), jnp.float64)),
        walk=np.asarray(jax.random.normal(k_walk, (3,), jnp.float64)),
        plant=None,
    )


def _port_carry(carry):
    return SampledLoopCarry(*(
        np.asarray(getattr(carry, f), np.int64 if f == "ref_offset" else np.float64)
        for f in SampledLoopCarry._fields))


@pytest.fixture(scope="module")
def oracle():
    model = jax_indy7(dtype=jnp.float64)

    # The batch solve.
    rng = np.random.default_rng(21)
    B, N = SOLVE_B, SOLVE_N
    w = rng.normal(size=(B, 6)) * 8
    w[:, 3:] = 0.0
    arrays = (rng.normal(size=(B, 12)) * 0.05, rng.normal(size=(B, N, 3)) * 0.3,
              rng.normal(size=(B, N, 12)) * 0.05, rng.normal(size=(B, N - 1, 6)) * 0.5, w)
    solve = jax.jit(lambda xs, g, X, U, w: jax_sqp.batch_solve(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=2), DT, xs, g, X, U,
        wrench_world_batch=w))
    js = solve(*arrays)

    # The closed loop, holding the start's EE position.
    x0 = jnp.zeros(12, jnp.float64)
    ref = np.asarray(jnp.tile(jax_ee_pos(model, x0[:6]), (TICKS + LOOP_N + 1, 1)))
    tick = jax.jit(make_loop_tick(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=1), jcfg.MPCConfig(N=LOOP_N, dt=DT),
        jcfg.SampleConfig(batch_size=LOOP_B, f_ext_std=5.0), jnp.asarray(ref), fused=False))
    carry = init_loop_carry(model, jcfg.MPCConfig(N=LOOP_N, dt=DT),
                            jcfg.SampleConfig(batch_size=LOOP_B, f_ext_std=5.0), x0,
                            jnp.asarray(F_TRUE0), jax.random.PRNGKey(7))
    carries, draws, traces = [_port_carry(carry)], [], []
    for _ in range(TICKS):
        draws.append(_replay_draws(carry.key))
        carry, trace = tick(carry, None)
        carries.append(_port_carry(carry))
        traces.append(trace)
    trace = {f: np.stack([np.asarray(getattr(t, f)) for t in traces]) for f in traces[0]._fields}
    return {"solve": (arrays, {"X": np.asarray(js.X), "U": np.asarray(js.U)}),
            "ref": ref, "carries": carries, "draws": draws, "trace": trace}


def _tick_inputs(oracle, t):
    """The host tick's inputs at loop tick ``t`` (x_obs, x_last, u_last,
    goals, X_warm, U_warm, f_batch) and its normals."""
    c = oracle["carries"][t]
    goals = oracle["ref"][t:t + LOOP_N]
    return (c.x, c.x_last, c.u_last, goals, c.X_best, c.U_best, c.f_batch), \
        oracle["draws"][t].resample


def _consensus_cases(R):
    """name -> (full errors, expected winner) over R ranks of
    CONSENSUS_LANES lanes each."""
    b, B = CONSENSUS_LANES, CONSENSUS_LANES * R
    cases = {}
    err = np.arange(B, dtype=np.float64) + 1.0  # rank 0's lane 0 holds the least
    err[b + 2] = np.nan
    cases["nan_on_rank_1_beats_finite"] = (err, b + 2)
    err = err.copy()
    err[B - 1] = np.nan
    cases["first_nan_wins"] = (err, b + 2)
    err = np.full(B, 5.0)
    err[[b - 1, b, B - 1]] = 1.0
    cases["tie_to_lowest_global_lane"] = (err, b - 1)
    return cases


def _consensus_payload(R):
    rng = np.random.default_rng(5)
    B = CONSENSUS_LANES * R
    return (rng.normal(size=(B, 3, 12)), rng.normal(size=(B, 2, 6)), rng.normal(size=(B, 6)),
            np.arange(B, dtype=np.int64) % 3)


def _resample_case(R, best):
    rng = np.random.default_rng(6)
    B = CONSENSUS_LANES * R
    f = rng.normal(size=(B, 6)) * 5
    f[:, 3:] = 0.0
    return rng.normal(size=(B, 6)), f, best


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def ranks(request, oracle):
    """(R, per-rank results of every job) from one spawn of R ranks."""
    R = request.param
    jobs = {"solve": (_worker.batch_solve_job, dict(
        cost_cfg=cfg.CostConfig(), sqp_cfg=SOLVE_SQP, dt=DT, arrays=oracle["solve"][0]))}
    for be in BACKENDS:
        for t in range(TICKS):
            inputs, normals = _tick_inputs(oracle, t)
            jobs[f"tick_{be}_{t}"] = (_worker.tick_job, dict(
                cost_cfg=cfg.CostConfig(), sqp_cfg=LOOP_SQP, sample_cfg=SAMPLE, dt=DT,
                inputs=inputs, normals=normals, backend=be))
        jobs[f"loop_{be}"] = (_worker.loop_job, dict(
            cost_cfg=cfg.CostConfig(), sqp_cfg=LOOP_SQP, mpc_cfg=MPC, sample_cfg=SAMPLE,
            ref=oracle["ref"], ticks=TICKS, backend=be, carry0=oracle["carries"][0],
            draws=oracle["draws"]))
    X, U, f, iters = _consensus_payload(R)
    for name, (err, _) in _consensus_cases(R).items():
        jobs[name] = (_worker.consensus_job, dict(err=err, X=X, U=U, f_batch=f, iters=iters))
    B = CONSENSUS_LANES * R
    for best in (CONSENSUS_LANES + 1, B - 1):
        normals, f_full, _ = _resample_case(R, best)
        jobs[f"resample_{best}"] = (_worker.resample_job, dict(
            normals=normals, f_batch=f_full, best=best, sample_cfg=SAMPLE))
    jobs["reinit"] = (_worker.reinit_job, {})
    out = _worker.spawn(_worker.run_jobs, R, list(jobs.values()), device="cpu", timeout=240)
    return R, [dict(zip(jobs, rank)) for rank in out]


def test_sharded_batch_solve_matches_single_process_and_jax(ranks, oracle):
    """Each rank solves its block (the plain K1: no launch on the CPU); the
    gathered solve equals the single-process ``sqp_cuda.batch_solve`` to
    1e-12 on every rank, and the JAX readable solver at 1e-9."""
    R, res = ranks
    arrays, js = oracle["solve"]
    single = sqp_cuda.batch_solve(indy7(torch.float64), cfg.CostConfig(), SOLVE_SQP, DT,
                                  *map(torch.as_tensor, arrays[:4]),
                                  wrench_world_batch=torch.as_tensor(arrays[4]))
    for r in res:
        s = r["solve"]
        assert s["lanes"] == SOLVE_B // R and s["launches"] == 0
        np.testing.assert_array_equal(s["alphas"], single.stats.alphas.numpy())
        for f in ("X", "U"):
            np.testing.assert_allclose(s[f], getattr(single, f).numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(s[f], js[f], rtol=0, atol=SQP_ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_tick_matches_jax(ranks, oracle, backend):
    """The sharded host tick on each loop tick's inputs, with that tick's
    normals, against the JAX ``sampled_tick`` inside the JAX loop tick:
    the winner equal, u and the resampled hypotheses within rtol 1e-8 /
    atol 1e-10, on every rank."""
    R, res = ranks
    tr, carries = oracle["trace"], oracle["carries"]
    for t in range(TICKS):
        for r in res:
            out = r[f"tick_{backend}_{t}"]
            assert int(out["best_idx"]) == tr["best_idx"][t]
            np.testing.assert_allclose(out["u"], tr["u"][t], rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(out["f_est"], tr["f_est"][t], rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(out["f_batch"], carries[t + 1].f_batch,
                                       rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(out["X_best"], carries[t + 1].X_best,
                                       rtol=1e-8, atol=1e-10)


def test_sharded_tick_feedback_edge(ranks):
    """The returned f_batch is the rank's (B/R, 6) block, and the next
    tick takes it as it is."""
    R, res = ranks
    for r in res:
        for be in BACKENDS:
            out = r[f"tick_{be}_0"]
            assert out["f_batch_block"] == out["again_f_batch_block"] == (LOOP_B // R, 6)
            assert np.all(np.isfinite(out["again_u"]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_closed_loop_matches_jax(ranks, oracle, backend):
    """The sharded closed loop against the JAX ``fused=False`` loop with
    the same draws: winners equal, tracking error within rtol 1e-9 / atol
    1e-11, u within 1e-8 / 1e-10; every rank holds the same replicated
    state, and the hypotheses gathered match the JAX carry's."""
    R, res = ranks
    tr, final = oracle["trace"], oracle["carries"][-1]
    for r in res:
        out = r[f"loop_{backend}"]
        np.testing.assert_array_equal(out["trace"]["best_idx"], tr["best_idx"])
        np.testing.assert_allclose(out["trace"]["tracking_error"], tr["tracking_error"],
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(out["trace"]["u"], tr["u"], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(out["carry"]["f_batch"], final.f_batch, rtol=1e-8, atol=1e-10)
        assert out["f_batch_block"] == (LOOP_B // R, 6)
        assert out["launches"] == (0, 0)  # CPU tensors: the plain versions
        for f, v in out["trace"].items():
            np.testing.assert_array_equal(v, res[0][f"loop_{backend}"]["trace"][f], err_msg=f)


@pytest.mark.parametrize("case", ["nan_on_rank_1_beats_finite", "first_nan_wins",
                                  "tie_to_lowest_global_lane"])
def test_cross_rank_consensus_nan_and_ties(ranks, case):
    """A NaN error on rank 1's lane beats every finite error on rank 0 (the
    first NaN first), ties go to the lowest global lane, and every rank
    gets the winner's row whole."""
    R, res = ranks
    _, want = _consensus_cases(R)[case]
    X, U, f, iters = _consensus_payload(R)
    for r in res:
        w = r[case]
        assert int(w["best"]) == want
        np.testing.assert_array_equal(w["X_best"], X[want])
        np.testing.assert_array_equal(w["U_best"], U[want])
        np.testing.assert_array_equal(w["f_est"], f[want])
        assert int(w["sqp_iters"]) == iters[want]


def test_resampling_pins_only_global_lane_0(ranks):
    """Resampling each rank's block with global lane indices equals the
    single-process resampling: only global lane 0 is pinned (no rank's
    first lane but rank 0's), and the winner's row is restored on the rank
    that owns it."""
    R, res = ranks
    b = CONSENSUS_LANES
    for best in (b + 1, b * R - 1):
        normals, f_full, _ = _resample_case(R, best)
        want = resample_wrench_batch(torch.as_tensor(normals), torch.as_tensor(f_full),
                                     torch.tensor(best), SAMPLE).numpy()
        for r in res:
            got = r[f"resample_{best}"]
            np.testing.assert_array_equal(got, want)
            assert np.all(got[0] == 0.0)
            assert np.all(got[b::b, :3] != 0.0)  # every other rank's first lane


def test_initialize_is_idempotent_and_refuses_another_group(ranks):
    """``initialize`` in a process already in the group returns its mesh;
    asked for another group it raises instead of switching."""
    R, res = ranks
    for rank, r in enumerate(res):
        assert r["reinit"] == (rank, R, True, True)


def test_process_lane_slice_raises_when_lanes_do_not_divide():
    mesh = LaneMesh(None, 2, 3, torch.device("cpu"))
    assert distributed.process_lane_slice(mesh, 9) == slice(6, 9)
    with pytest.raises(ValueError, match="divide"):
        distributed.process_lane_slice(mesh, 8)
    with pytest.raises(ValueError, match="divide"):
        shard_lanes(mesh, np.zeros((8, 6)))


def test_one_rank_mesh_without_process_group(oracle):
    """Without a process group the mesh is one rank with no collectives;
    its sharded tick and loop are the single-process ones, exactly."""
    assert not torch.distributed.is_initialized()
    mesh = make_lane_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert make_lane_mesh().device.type == "cuda"  # the default device is the card
    model = indy7(torch.float64)
    inputs, normals = _tick_inputs(oracle, 1)
    t_in = [torch.tensor(a) for a in inputs]
    tick = make_sharded_sampled_tick(model, cfg.CostConfig(), LOOP_SQP, SAMPLE, DT, mesh)
    got, _ = tick(*t_in, normals=torch.tensor(normals))
    want = sampled_tick(model, cfg.CostConfig(), LOOP_SQP, SAMPLE, DT, None, *t_in,
                        normals=torch.tensor(normals))
    for f in ("u", "best_idx", "X_best", "U_best", "f_batch", "f_est", "sqp_iters"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, msg=f)

    loop, layout = make_sharded_sampled_loop(model, cfg.CostConfig(), LOOP_SQP, MPC, SAMPLE,
                                             mesh, oracle["ref"], TICKS)
    carry0 = shard_lanes(mesh, oracle["carries"][0], layout)
    draws = shard_lanes(mesh, oracle["draws"], None)
    _, got = loop(carry0, draws)
    _, want = run_sampled_mpc(model, cfg.CostConfig(), LOOP_SQP, MPC, SAMPLE, carry0.x,
                              oracle["ref"], TICKS, None, None, carry0=carry0, draws=draws)
    for f in got._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, msg=f)
    torch.testing.assert_close(mesh.gather(carry0.f_batch), carry0.f_batch, rtol=0, atol=0)


def test_distributed_names_on_one_rank():
    """The TPU package's names in ``distributed`` on a one-rank mesh with no
    process group: the mesh, the rank's block, a lane-sharded and a
    replicated placement, the gather and the host fetch."""
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_lane_mesh(device="cpu")
    assert mesh == make_lane_mesh(device="cpu") and mesh.size == 1
    assert distributed.process_lane_slice(mesh, 8) == slice(0, 8)
    full = np.arange(48.0).reshape(8, 6)
    block = distributed.global_lanes(mesh, full)
    assert block.shape == (8, 6) and block.device.type == "cpu"
    np.testing.assert_array_equal(distributed.fetch_replicated(
        distributed.gather_lanes(mesh, block)), full)
    rep = distributed.replicated_global(mesh, full[0])
    np.testing.assert_array_equal(distributed.fetch_replicated(rep), full[0])


def test_backend_is_chosen_explicitly():
    """``auto`` is the kernel inside K1's coverage and the readable layer
    outside it; the kernel outside its coverage and unknown names raise."""
    mesh = make_lane_mesh(device="cpu")
    ref_cost = cfg.CostConfig(formulation="reference")
    assert resolve_backend("auto", mesh, cfg.CostConfig(), LOOP_SQP) == "kernel"
    assert resolve_backend("auto", mesh, ref_cost, LOOP_SQP) == "readable"
    assert resolve_backend("readable", mesh, cfg.CostConfig(), LOOP_SQP) == "readable"
    with pytest.raises(ValueError, match="riccati"):
        make_sharded_batch_solve(indy7(torch.float64), ref_cost, LOOP_SQP, DT, mesh, "kernel")
    with pytest.raises(ValueError, match="backend"):
        make_sharded_sampled_tick(indy7(torch.float64), cfg.CostConfig(), LOOP_SQP, SAMPLE, DT,
                                  mesh, backend="pallas")
