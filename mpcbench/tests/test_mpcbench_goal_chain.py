"""The point-to-goal cell: the harness finds its files; its driver runs
``run_mpc``'s tick on the CPU at a tiny size and reads correct; a broken
plant step or solve, and the reference in bfloat16 in the program's
place, read not correct; its readers on a synthetic trace, and None
without a trace, K1's clocks or the host's replay time."""
import json
import time

import pytest
import torch

from mpcbench import compare, goal_compare, harness, profiling
from mpcbench.goal_control import control_gaps

CELL = "p2g_b1_n32.goal_chain"
READERS = ("k1_roofline.goal_chain", "k2_roofline.loop", "graph_other_us.loop",
           "k1_riccati_us.loop_clocked", "p2g_ops_tick.goal_chain", "p2g_replay_us.goal_chain")
SEED = 2**31 + 77


def tiny_cell(N: int = 8) -> harness.Cell:
    """The cell at a size the CPU holds: N=8, chunks of 20 ticks, two
    spans of 10 compared, 2 ticks traced."""
    c = harness.load_cell(CELL)
    c.config = json.loads(json.dumps(c.config))
    c.config.update(horizon=N)
    c.mix = dict(c.mix, chunk_ticks=20, span_ticks=10, warmup_chunks=0, check_spans=2,
                 trace_ticks=2)
    return c


def _context(c, trace=False, seconds=0.0):
    return harness.Context(c, SEED, seconds, trace, torch.device("cpu"), time.perf_counter(),
                           lambda s: None)


@pytest.fixture(scope="module")
def sound():
    """One chunk of the tiny cell, its spans compared: (cell, run)."""
    c = tiny_cell()
    return c, harness.load_driver(c.mix).run(_context(c))


def test_the_cell_is_found_by_name():
    c = harness.load_cell(CELL)
    assert (c.config_name, c.traffic, c.chips) == ("p2g_b1_n32", "goal_chain", 1)
    assert c.config["name"] == c.config_name and c.mix["name"] == c.traffic
    assert harness.load_driver(c.mix).__name__ == "mpcbench.drivers.goal_chain"
    assert set(c.limits) == set(goal_compare.NAMES)
    assert [m["name"] for m in c.end_to_end] == ["loop_tick_us", "setup_s"]
    assert sorted(m["name"] for m in c.per_layer) == sorted(READERS)
    assert all(callable(harness.load_reader(m["name"])) for m in c.per_layer)


def test_the_driver_runs_run_mpcs_tick_and_reads_correct(sound):
    c, run = sound
    assert (run.attempted, run.failed) == (20, 0)
    assert compare.within(run.gaps, c.limits), run.gaps
    assert set(run.end_to_end) == {"loop_tick_us", "setup_s"}
    assert len(run.values["spans"]) == 1 and run.values["spans"][0].ticks == 10
    assert run.values["switches"] >= 1  # from the start pose the first goal is 0.17 m off


def test_the_traced_run_hands_the_replay_time_to_the_reader():
    c = tiny_cell()
    result = harness.execute(_context(c, trace=True))
    assert result["correct"] is True, result["checks"]
    # On the CPU every tick runs eagerly, the profiler sees no device and
    # K1 has no clocks: only the host's time in the runner is read.
    assert set(result["metrics"]) == {"p2g_replay_us.goal_chain"}
    assert result["metrics"]["p2g_replay_us.goal_chain"]["value"] > 0


def test_the_control_is_not_correct(sound):
    c, run = sound
    gaps = control_gaps(c, run, 1)
    assert not compare.within(gaps, c.limits), gaps


def _frozen_plant(monkeypatch):
    from indy7_mpc_tpu_torch.mpc import point_to_goal

    monkeypatch.setattr(point_to_goal, "kernel_plant_step",
                        lambda smc, smp, cfg, dt, x, u, *a, **k: (x.clone(), None))


def _warm_start_solve(monkeypatch):
    from indy7_mpc_tpu_torch.solvers import select, sqp

    real = select.default_single_solve_fn

    def factory(*args, **kw):
        fn = real(*args, **kw)

        def solve(xs, goals, X, U, state=None, wrench_world=None):
            res = fn(xs, goals, X, U, state, wrench_world)
            return sqp.SQPResult(X, U, res.state, res.stats)

        return solve

    monkeypatch.setattr(select, "default_single_solve_fn", factory)


@pytest.mark.parametrize("fault", [_frozen_plant, _warm_start_solve])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    c = tiny_cell()
    result = harness.execute(_context(c))
    assert result["correct"] is False, result["checks"]


CYCLES = {"prologue": 1, "linearize": 3, "riccati": 4, "rollout": 1, "linesearch": 1,
          "epilogue": 0, "total": 10, "blocks": 2, "handoff": 0, "rcp_slow": 0}


def _trace():
    ops = [("void sqp_kernel<false>(...)", 0.0, 300.0), ("tick_kernel(...)", 300.0, 90.0),
           ("mul", 390.0, 2.0), ("add", 400.0, 2.0),
           ("void sqp_kernel<false>(...)", 700.0, 320.0), ("tick_kernel(...)", 1020.0, 90.0),
           ("mul", 1110.0, 2.0), ("Memcpy DtoD", 1120.0, 4.0)]
    return profiling.Trace(ops, [(profiling.WINDOW, 0.0, 1200.0)], (0.0, 1200.0), 2)


def test_readers_on_a_synthetic_trace():
    cell = harness.load_cell(CELL)
    run = harness.Run(2, 0, {}, {}, 0, trace=_trace(),
                      values={"replay_s": 90e-6, "replay_ticks": 20, "k1_stage_cycles": CYCLES})
    read = lambda m, r=run: harness.load_reader(m)(r, cell)
    assert read("graph_other_us.loop") == pytest.approx(5.0)
    assert read("k1_riccati_us.loop_clocked") == pytest.approx(0.4 * 310.0)
    assert read("p2g_ops_tick.goal_chain") == pytest.approx(4.0)
    assert read("p2g_replay_us.goal_chain") == pytest.approx(4.5)
    assert 0 < read("k1_roofline.goal_chain") < read("k1_roofline.loop")


@pytest.mark.parametrize("reader", READERS)
def test_readers_read_nothing_without_a_trace_or_values(reader):
    """A run without a trace, or without the host's replay time or K1's
    clocks (the driver hands None off the card), gives None."""
    cell = harness.load_cell(CELL)
    read = harness.load_reader(reader)
    assert read(harness.Run(2, 0, {}, {}, 0), cell) is None
    empty = profiling.Trace([], [], (0.0, 1.0), 1)
    for values in ({}, {"replay_s": None, "replay_ticks": None, "k1_stage_cycles": None},
                   {"replay_s": 90e-6, "replay_ticks": None},
                   {"replay_s": None, "replay_ticks": 20}):
        assert read(harness.Run(2, 0, {}, {}, 0, trace=empty, values=values), cell) is None
