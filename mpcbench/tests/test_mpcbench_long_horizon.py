"""The plain reference past one block's 174 knots, in float64 on the CPU:
at N=180 (where K1 takes a cluster of 2 blocks a lane) its SQP solve
agrees with the program's plain solve to rounding, and three ticks of the
program's loop at B=2 are correct under the long-horizon cell's limits
(``compare.loop_gaps``).  K1's cluster split itself is held on the card
by the tests that give the same bits at every cluster size."""
import torch

from mpcbench import compare
from mpcbench.drivers import loop_clocked
from mpcbench.reference import robot, sqp

from indy7_mpc_tpu_torch.config import CostConfig, SQPConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

from .test_mpcbench_clocked import _context, clocked_cell
from .test_mpcbench_reference import INIT_Q, settings

F64 = torch.float64
N = 180


def test_n180_needs_a_cluster():
    assert K1.cluster_size(N) == 2


def test_sqp_solve_at_n180():
    """Two lanes from seeded random states, goals, warm starts and wrenches."""
    g = torch.Generator().manual_seed(180)
    L = 2
    x = 0.3 * torch.randn(L, 12, generator=g, dtype=F64)
    x[:, :6] += torch.tensor(INIT_Q, dtype=F64)
    w = torch.cat([15.0 * torch.randn(L, 3, generator=g, dtype=F64),
                   torch.zeros(L, 3, dtype=F64)], 1)
    goals = torch.tensor([0.3, 0.4, 0.6], dtype=F64) + 0.05 * torch.randn(L, N, 3, generator=g,
                                                                          dtype=F64)
    X = x[:, None].repeat(1, N, 1) + 0.01 * torch.randn(L, N, 12, generator=g, dtype=F64)
    U = torch.randn(L, N - 1, 6, generator=g, dtype=F64)
    Xr, Ur = sqp.solve(robot.indy7(F64), settings(), 0.01, x, goals, X, U, w)
    Xp, Up, *_ = solve_lane_major(LR.static_model(indy7(F64)), CostConfig(),
                                  SQPConfig(max_iters=2), 0.01, x.T, goals.permute(1, 2, 0),
                                  X.permute(1, 2, 0), U.permute(1, 2, 0), wrench=w.T)
    torch.testing.assert_close(Xr, Xp.permute(2, 0, 1), rtol=0, atol=1e-8)
    torch.testing.assert_close(Ur, Up.permute(2, 0, 1), rtol=0, atol=1e-6)


def test_three_loop_ticks_at_n180_are_correct():
    """The clocked cell's driver on the CPU at B=2, N=180: one chunk of 3
    ticks, all compared against the reference followed from the program's
    state."""
    c = clocked_cell(B=2, N=N, chunk_ticks=3, span_ticks=3)
    run = loop_clocked.run(_context(c))
    assert (run.attempted, run.failed) == (3, 0)
    assert len(run.values["spans"]) == 1 and run.values["spans"][0].ticks == 3
    assert set(run.gaps) == set(compare.NAMES) == set(c.limits)
    assert compare.within(run.gaps, c.limits), run.gaps
