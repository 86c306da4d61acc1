"""The plain reference against the program's plain versions, in float64 on
the CPU at small sizes: kinematics, dynamics, the plant, the consensus,
the resampling and the SQP solve agree to rounding."""
import numpy as np
import pytest
import torch

from mpcbench.reference import rbd, robot, sqp
from mpcbench.reference import tick as rt

from indy7_mpc_tpu_torch.config import PERTURBED_PLANT, CostConfig, SampleConfig, SQPConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.mpc.sampled import resample_wrench_batch
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue_plain
from indy7_mpc_tpu_torch.sim.plant import perturb_model, perturbation_scales, plant_step
from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

F64 = torch.float64
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]


def settings(cost=CostConfig(), s=SQPConfig(max_iters=2)):
    return sqp.SQPSettings(
        dQ=cost.dQ, R=cost.R, QN=cost.QN, regularize=cost.regularize, eps=cost.eps,
        q_barrier=cost.q_barrier, q_barrier_margin=cost.q_barrier_margin,
        max_iters=s.max_iters, merit_mu=s.merit_mu, num_alphas=s.num_alphas,
        step_tol=s.step_tol, rho=s.rho, rho_max=s.rho_max, rho_factor=s.rho_factor)


@pytest.fixture
def states():
    g = torch.Generator().manual_seed(3)
    L = 5
    x = 0.3 * torch.randn(L, 12, generator=g, dtype=F64)
    x[:, :6] += torch.tensor(INIT_Q, dtype=F64)
    return (x, 20.0 * torch.randn(L, 6, generator=g, dtype=F64),
            torch.cat([15.0 * torch.randn(L, 3, generator=g, dtype=F64),
                       torch.zeros(L, 3, dtype=F64)], 1),
            0.1 * torch.randn(L, 5, 6, generator=g, dtype=F64))


def lanes(t):
    return [t[:, i] for i in range(t.shape[1])]


def test_perturbation_draws_equal():
    np.testing.assert_array_equal(robot.uniform_draws(7, 12), perturbation_scales(7, 12))


def test_kinematics_and_dynamics(states):
    x, u, w, _ = states
    R, sm = robot.indy7(F64), LR.static_model(indy7(F64))
    q, v = x[:, :6], x[:, 6:]
    ee, J = rbd.ee_jacobian(R, q)
    ee_p, cols = LR.ee_pos_jacobian(sm, lanes(q))
    torch.testing.assert_close(ee, torch.stack(ee_p, -1), rtol=0, atol=1e-13)
    torch.testing.assert_close(J, torch.stack([torch.stack(c, -1) for c in cols], -1),
                               rtol=0, atol=1e-13)
    a = rbd.forward_dynamics(R, q, v, u, rbd.wrench_in_ee(R, q, w))
    a_p, _ = LR.forward_dynamics(sm, lanes(q), lanes(v), lanes(u),
                                 LR.f_ext_from_world(sm, lanes(q), w.T))
    torch.testing.assert_close(a, torch.stack(a_p, -1), rtol=1e-10, atol=1e-9)


def test_perturbed_plant(states):
    x, u, w, noise = states
    Rp = robot.perturbed(robot.indy7(F64), 0.04, 7)
    smp = LR.static_model(perturb_model(indy7(F64), PERTURBED_PLANT))
    got = rbd.plant_step(Rp, x, u, 0.01, w, 5, (0.05, 0.1), noise)
    for i in range(x.shape[0]):
        want = plant_step(smp, x[i][:, None], u[i][:, None], 0.01, wrench_world=w[i][:, None],
                          substeps=5, friction=(0.05, 0.1), noise=noise[i])[:, 0]
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-11)


def test_consensus_and_resampling(states):
    x, u, w, _ = states
    B = x.shape[0]
    dep = rt.Deployment.from_config(_config(B, 8))
    m = rt.Models(dep)
    sm = LR.static_model(indy7(F64))
    x_obs = x[0] + 1e-3
    dist = rt.consensus_distances(m, x_obs, x[1], u[1], w)
    ep = tick_epilogue_plain(sm, sm, None, 0.01, x_obs, x[1], u[1], w.T.contiguous(),
                             u.T.contiguous(), torch.zeros(6, dtype=F64), plant=False)
    torch.testing.assert_close(dist ** 2, ep.err, rtol=1e-12, atol=1e-15)
    assert int(torch.argmin(dist)) == int(ep.best)
    normals = torch.randn(B, 6, generator=torch.Generator().manual_seed(1), dtype=F64)
    got = rt.resample(dep, normals, w, torch.tensor(2))
    want = resample_wrench_batch(normals, w, torch.tensor(2), SampleConfig(batch_size=B))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)


def test_sqp_solve(states):
    x, _, w, _ = states
    L, N = x.shape[0], 8
    g = torch.Generator().manual_seed(5)
    goals = torch.tensor([0.3, 0.4, 0.6], dtype=F64) + 0.05 * torch.randn(L, N, 3, generator=g,
                                                                          dtype=F64)
    X = x[:, None].repeat(1, N, 1)
    U = torch.randn(L, N - 1, 6, generator=g, dtype=F64)
    Xr, Ur = sqp.solve(robot.indy7(F64), settings(), 0.01, x, goals, X, U, w)
    Xp, Up, *_ = solve_lane_major(LR.static_model(indy7(F64)), CostConfig(), SQPConfig(max_iters=2),
                                  0.01, x.T, goals.permute(1, 2, 0), X.permute(1, 2, 0),
                                  U.permute(1, 2, 0), wrench=w.T)
    torch.testing.assert_close(Xr, Xp.permute(2, 0, 1), rtol=0, atol=1e-8)
    torch.testing.assert_close(Ur, Up.permute(2, 0, 1), rtol=0, atol=1e-6)


def test_lower_precision_runs():
    """The control's precision: every step of a tick runs in bfloat16."""
    dep = rt.Deployment.from_config(_config(4, 6))
    m = rt.Models(dep, torch.bfloat16)
    x = torch.zeros(12, dtype=torch.bfloat16)
    x[:6] = torch.tensor(INIT_Q)
    goals = torch.tensor([0.3, 0.4, 0.6], dtype=torch.bfloat16).expand(6, 3)
    out = rt.controller_tick(m, x, x, torch.zeros(6, dtype=torch.bfloat16), goals,
                             x.expand(6, 12).clone(), torch.zeros(5, 6, dtype=torch.bfloat16),
                             torch.zeros(4, 6, dtype=torch.bfloat16),
                             torch.zeros(4, 6, dtype=torch.bfloat16))
    assert out.X.dtype == torch.bfloat16 and torch.isfinite(out.X.float()).all()


def _config(B, N):
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "fig8_b64_n64.json").read_text())
    cfg.update(batch_size=B, horizon=N)
    return cfg
