"""A run with the timed path broken underneath reads not correct.

Each fault is planted in the program's own functions, as the cells' timed
paths call them, and the harness then drives the rest of a run on the CPU
(the look for a card skipped): a step that leaves its state unchanged,
half of the lanes left out of the solve, one lane's solve left at its
warm start, and an answer altered where it is produced.  The exchange
between chips has no place here: every cell runs on one card."""
import pytest
import torch

from indy7_mpc_tpu_torch.mpc import fused_tick
from indy7_mpc_tpu_torch.runtime import transport

from . import tiny

CELLS = ["fig8_b64_n64.loop", "fig8_b64_n64.ctl100hz"]


def unchanged_state(monkeypatch, cell):
    """The plant's step returns the state it was given."""
    if cell.endswith(".loop"):
        real = fused_tick.tick_epilogue

        def step(smc, smp, cfg, dt, x_cur, *args, **kw):
            ep = real(smc, smp, cfg, dt, x_cur, *args, **kw)
            return ep if ep.x_next is None else ep._replace(x_next=x_cur.clone())

        monkeypatch.setattr(fused_tick, "tick_epilogue", step)
    else:
        monkeypatch.setattr(transport, "kernel_plant_step",
                            lambda smc, smp, cfg, dt, x, u, *a, **k: (x.clone(), None))


def half_the_lanes(monkeypatch, cell):
    """K1 solves the first half of the lanes; the rest keep their warm start."""
    real = fused_tick.sqp_solve

    def solve(sm, cost, sqp, dt, xs, goals, X, U, wrench=None, **kw):
        h = xs.shape[-1] // 2
        Xh, Uh, rho, alphas, steps = real(sm, cost, sqp, dt, xs[:, :h].contiguous(),
                                          goals[..., :h].contiguous(), X[..., :h].contiguous(),
                                          U[..., :h].contiguous(), wrench=wrench[:, :h].contiguous(),
                                          **kw)
        pad = lambda t, full: torch.cat([t, full[..., h:]], -1)
        return (pad(Xh, X), pad(Uh, U), pad(rho, torch.ones_like(xs[0])),
                pad(alphas, torch.zeros_like(alphas[:, :1]).expand(-1, X.shape[-1])),
                pad(steps, torch.zeros_like(steps[:, :1]).expand(-1, X.shape[-1])))

    monkeypatch.setattr(fused_tick, "sqp_solve", solve)


def one_lane(monkeypatch, lane: int):
    """K1 leaves lane ``lane``'s solve at its warm start; the others solve."""
    real = fused_tick.sqp_solve

    def solve(sm, cost, sqp, dt, xs, goals, X, U, wrench=None, **kw):
        out = list(real(sm, cost, sqp, dt, xs, goals, X, U, wrench=wrench, **kw))
        for i, warm in ((0, X), (1, U)):
            out[i] = out[i].clone()
            out[i][..., lane] = warm[..., lane]
        return tuple(out)

    monkeypatch.setattr(fused_tick, "sqp_solve", solve)


def altered_answer(monkeypatch, cell):
    """K2's consensus answer turned round: the worst lane wins."""
    real = fused_tick.tick_epilogue

    def epilogue(*args, **kw):
        ep = real(*args, **kw)
        worst = torch.argmax(ep.err)
        return ep._replace(err=-ep.err, best=worst,
                           u=args[8].index_select(1, worst.view(1))[:, 0],
                           f_est=args[7].index_select(1, worst.view(1))[:, 0])

    monkeypatch.setattr(fused_tick, "tick_epilogue", epilogue)


@pytest.mark.parametrize("fault", [unchanged_state, half_the_lanes, altered_answer])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    c = tiny.cell(name)
    fault(monkeypatch, name)
    result = tiny.execute(c)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_path_is_correct(name):
    result = tiny.execute(tiny.cell(name))
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 or name.endswith("ctl100hz")


def _winners(run) -> list:
    """The winning lane of every compared tick of ``run``."""
    if "spans" in run.values:
        return [int(b) for sp in run.values["spans"] for b in sp.rows["best_idx"].round()]
    return [int(round(float(t.host[6]))) for t in run.values["ticks"]]


@pytest.mark.parametrize("name", CELLS)
def test_one_faulty_lane_that_wins_a_compared_tick_is_not_correct(monkeypatch, name):
    """Only the winner's solve leaves a tick, so a fault in one lane shows
    on the ticks that lane wins.  The lane that wins the fewest compared
    ticks of a sound run, and at least one, is broken: the run reads not
    correct."""
    c = tiny.cell(name)
    wins = _winners(tiny.run(c))
    lane = min(set(wins), key=wins.count)
    one_lane(monkeypatch, lane)
    result = tiny.execute(c)
    assert result["correct"] is False, (lane, wins, result["checks"])
