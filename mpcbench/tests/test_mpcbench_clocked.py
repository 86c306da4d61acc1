"""The ``loop_clocked`` mix: its driver is the ``loop`` driver untraced,
switches the program's tracing on and hands K1's stage cycles to the
readers traced; its two readers turn a slot's share of the cycles into
K1's device µs; the new cells' controls read not correct at a size the
CPU holds."""
import json

import pytest
import torch

from mpcbench import compare, harness, profiling
from mpcbench.control import control_gaps
from mpcbench.drivers import loop, loop_clocked

from indy7_mpc_tpu_torch import tracing

from . import tiny

CLOCKED = "fig8_b64_n256.loop_clocked"
READERS = ("k1_handoff_us.loop_clocked", "k1_riccati_us.loop_clocked")
LOOP_MIX = dict(chunk_ticks=20, span_ticks=20, warmup_chunks=0, check_spans=1, trace_chunks=1)


def clocked_cell(B: int = 4, N: int = 8, **mix) -> harness.Cell:
    """The clocked loop cell at a size the CPU holds (``tiny.cell`` sizes
    the ``loop`` driver's mixes)."""
    c = harness.load_cell(CLOCKED)
    c.config = json.loads(json.dumps(c.config))
    c.config.update(batch_size=B, horizon=N)
    c.mix = dict(c.mix, **LOOP_MIX)
    c.mix.update(mix)
    return c


def _context(c, trace=False):
    return harness.Context(c, tiny.SEED, 0.0, trace, torch.device("cpu"), 0.0, lambda s: None)


def _trace():
    """Two K1 launches of 500 and 520 µs."""
    ops = [("void sqp_kernel<true>(...)", 0.0, 500.0), ("tick_kernel(...)", 500.0, 90.0),
           ("void sqp_kernel<true>(...)", 700.0, 520.0), ("tick_kernel(...)", 1220.0, 90.0)]
    return profiling.Trace(ops, [(profiling.WINDOW, 0.0, 1400.0)], (0.0, 1400.0), 2)


CYCLES = {"prologue": 10, "linearize": 300, "riccati": 450, "rollout": 100, "linesearch": 120,
          "epilogue": 20, "total": 1000, "blocks": 256, "handoff": 250}


def test_clocked_readers_on_a_synthetic_trace():
    cell = harness.load_cell(CLOCKED)
    run = harness.Run(20, 0, {}, {}, 0, trace=_trace(), values={"k1_stage_cycles": CYCLES})
    read = lambda m, r=run: harness.load_reader(m)(r, cell)
    assert read("k1_handoff_us.loop_clocked") == pytest.approx(0.25 * 510.0)
    assert read("k1_riccati_us.loop_clocked") == pytest.approx(0.45 * 510.0)
    parent = {k: v for k, v in CYCLES.items() if k != "handoff"}  # a program without the slot
    for m in READERS:
        assert read(m, harness.Run(20, 0, {}, {}, 0, values={"k1_stage_cycles": CYCLES})) is None
        assert read(m, harness.Run(20, 0, {}, {}, 0, trace=_trace())) is None
        assert read(m, harness.Run(20, 0, {}, {}, 0, trace=_trace(),
                                   values={"k1_stage_cycles": None})) is None
        assert read(m, harness.Run(20, 0, {}, {}, 0, trace=_trace(),
                                   values={"k1_stage_cycles": parent})) is None
        empty = profiling.Trace([], [], (0.0, 1.0), 1)
        assert read(m, harness.Run(20, 0, {}, {}, 0, trace=empty,
                                   values={"k1_stage_cycles": CYCLES})) is None


def test_untraced_clocked_run_is_the_loop_run():
    """Untraced, the clocked driver's run equals the ``loop`` driver's at
    the same seed (one chunk each): the same ticks, numbers and records."""
    c = clocked_cell()
    plain = dict(c.mix, name="loop", driver="loop")
    a = loop_clocked.run(_context(c))
    b = loop.run(_context(harness.Cell(**dict(vars(c), mix=plain))))
    assert (a.attempted, a.failed, a.gaps, a.memory_peak_bytes, a.trace) == (
        b.attempted, b.failed, b.gaps, b.memory_peak_bytes, b.trace)
    assert set(a.end_to_end) == set(b.end_to_end) == {"loop_tick_us", "setup_s"}
    assert set(a.values) == set(b.values) == {"spans", "reference"}
    for sa, sb in zip(a.values["spans"], b.values["spans"]):
        for part in ("pre", "post", "rows", "draws"):
            x, y = getattr(sa, part), getattr(sb, part)
            assert all(torch.equal(x[k], y[k]) for k in x) and set(x) == set(y)
    assert not tracing.enabled()


def test_traced_clocked_run_switches_tracing_around_the_loop(monkeypatch):
    """Traced, tracing is on while the loop runs and off after it, and the
    cycles read after the loop go to the readers; on the CPU K1 keeps no
    clocks, so the readers read nothing."""
    seen = []

    def run(ctx):
        seen.append(tracing.enabled())
        return harness.Run(1, 0, {}, {}, 0, trace=_trace())

    monkeypatch.setattr(loop, "run", run)
    out = loop_clocked.run(_context(clocked_cell(), trace=True))
    assert seen == [True] and not tracing.enabled()
    assert "k1_stage_cycles" in out.values and out.values["k1_stage_cycles"] is None
    cell = harness.load_cell(CLOCKED)
    assert all(harness.load_reader(m)(out, cell) is None for m in READERS)


@pytest.mark.parametrize("name", [CLOCKED, "fig8_b256_n32.ctl100hz"])
def test_the_new_cells_control_is_not_correct(name):
    """At B=4/N=8 the program's run is correct under the new cells' limits
    and the reference in bfloat16 in its place is not."""
    c = clocked_cell() if name == CLOCKED else tiny.cell(name)
    run = harness.load_driver(c.mix).run(tiny.context(c, None, tiny.SEED))
    assert compare.within(run.gaps, c.limits), run.gaps
    gaps = control_gaps(c, run, 2)
    assert not compare.within(gaps, c.limits), gaps
