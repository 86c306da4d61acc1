"""``run_mpc``'s tick (``mpc/point_to_goal.py::make_mpc_tick``) against the
benchmark's plain reference of the point-to-goal tick
(``mpcbench/reference/goal_chain.py``), on the CPU in float64.

The tick runs K1's and K2's plain versions; the reference is its own
Gauss-Newton SQP, rho carried from tick to tick, and its own plant.  At
N=8, from the warm-up solve on, five ticks agree to rounding: the state,
the shifted warm start, the solver's rho, the goal distance and index.
One case switches goals at 0.1 m and one freezes the whole carry past
1.1 m.  The reference imports neither JAX nor the program.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from indy7_mpc_tpu_torch.config import CostConfig, MPCConfig, SQPConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.mpc.point_to_goal import make_mpc_tick
from mpcbench.reference import goal_chain as rg
from mpcbench.reference import rbd

ROOT = Path(__file__).resolve().parents[1]
N, TICKS = 8, 5
# Rounding in float64 (largest readings over the cases, ~10x under the
# tolerances): the torques out of a Riccati sweep whose Quu carries
# rho = 1e-6 beside 2R = 2e-5 agree to 2.0e-7 N m, the states they drive
# to 8.6e-9, the goal distance to 5.0e-12 m.
ATOL_X, ATOL_U, ATOL_DIST = 1e-7, 2e-6, 1e-10


def _config():
    cfg = json.loads((ROOT / "mpcbench/configs/p2g_b1_n32.json").read_text())
    cfg["horizon"] = N
    return cfg


def _start(case: str, dep):
    """(x0 (12,), goals (3, 3)) of a case, float64."""
    x0 = rg.start_state(dep)
    ee0 = rg.goal_chain(dep)[0] - torch.tensor(dep.offsets[0], dtype=torch.float64)
    if case.startswith("random"):
        g = torch.Generator().manual_seed(int(case.split("-")[1]))
        x0[:6] += 0.3 * torch.randn(6, generator=g, dtype=torch.float64)
        x0[6:] = 0.2 * torch.randn(6, generator=g, dtype=torch.float64)
        ee = rbd.ee_position(rg.Models(dep).ctl, x0[:6])
        return x0, ee + 0.3 * torch.rand((3, 3), generator=g, dtype=torch.float64) - 0.15
    first = {"switch": [0.05, 0.0, 0.0], "freeze": [1.2, 0.0, 0.0]}[case]
    goals = ee0 + torch.tensor([first, [-0.15, 0.05, -0.2], [0.05, 0.15, -0.05]],
                               dtype=torch.float64)
    return x0, goals


def _program(cfg, x0, goals):
    mpc = MPCConfig(N=N, dt=cfg["dt"], sim_substeps=cfg["plant"]["substeps"],
                    goal_switch_dist=cfg["switch_dist"], divergence_dist=cfg["divergence_dist"])
    return make_mpc_tick(indy7(torch.float64), CostConfig(**cfg["cost"]),
                         SQPConfig(**cfg["sqp"]), mpc, x0, goals)


def _agree(carry, ref: rg.Carry):
    torch.testing.assert_close(carry.x, ref.x[0], atol=ATOL_X, rtol=0)
    torch.testing.assert_close(carry.X, ref.X[0], atol=ATOL_X, rtol=0)
    torch.testing.assert_close(carry.U, ref.U[0], atol=ATOL_U, rtol=0)
    assert int(carry.goal_idx) == int(ref.goal_idx[0])
    assert bool(carry.alive) == bool(ref.alive[0])
    # rho is carried in float32 (SolverState.init) and takes powers of 4
    # times the configured value.
    assert float(carry.state.rho) == pytest.approx(float(ref.rho[0]), rel=1e-6)


@pytest.mark.parametrize("case", ["random-0", "random-1", "random-2", "switch", "freeze"])
def test_tick_equals_the_plain_reference(case):
    cfg = _config()
    dep = rg.Deployment.from_config(cfg)
    m = rg.Models(dep)
    x0, goals = _start(case, dep)
    tick, carry = _program(cfg, x0, goals)
    ref = rg.warm_start(m, x0[None], goals)
    _agree(carry, ref)
    for t in range(TICKS):
        before = carry
        carry, row = tick(carry)
        out = rg.tick(m, ref, goals)
        ref = out.carry
        _agree(carry, ref)
        torch.testing.assert_close(row.goal_dist, out.goal_dist[0], atol=ATOL_DIST, rtol=0)
        torch.testing.assert_close(row.u, out.u[0], atol=ATOL_U, rtol=0)
        assert int(row.goal_idx) == int(carry.goal_idx)
        if case == "switch" and t == 0:
            assert float(row.goal_dist) < dep.switch_dist and int(row.goal_idx) == 1
        if case == "freeze":
            # Past divergence_dist the whole carry holds, rho included, and
            # the applied torque reads 0.
            assert float(row.goal_dist) > dep.divergence_dist and not bool(carry.alive)
            for a, b in zip([*carry[:4], carry.state.rho], [*before[:4], before.state.rho]):
                assert torch.equal(a, b)
            assert torch.equal(row.u, torch.zeros_like(row.u))
    if case.startswith("random"):
        assert bool(carry.alive)


def test_the_reference_imports_no_jax_and_nothing_of_the_program():
    code = (f"import json, sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            "import mpcbench.reference.goal_chain\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "mpcbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "indy7_mpc_tpu", "indy7_mpc_tpu_torch"}
