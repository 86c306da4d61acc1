"""The port's tracing (``indy7_mpc_tpu_torch/tracing.py``): spans, stall
counters and K1's stage clocks.

On the CPU: spans record nothing while tracing is off, nest with their
parent and tick id while it is on, show in a ``torch.profiler`` trace and
stay bounded; the counters count; the controller's tick records its four
spans; ``StallHunt`` reads the counters under its own keys; K1's clock
slots mirror the kernel's.  The cases that need a card (K1's outputs the
same bits with the stage clocks on and off, the cycles they count, the
graph captures counted, and the clocks switched inside a captured graph)
decide inside the test and skip without one.  The file imports no JAX:
on the card run it as ``python -m pytest --noconftest tests/test_torch_tracing.py``.
"""
import gc
import re

import numpy as np
import pytest
import torch

from indy7_mpc_tpu_torch import tracing
from indy7_mpc_tpu_torch.config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops.kernels import _build
from indy7_mpc_tpu_torch.runtime import SampledController
from indy7_mpc_tpu_torch.tools import latency_decomp

CTL_SPANS = ("ctl.on_state", "ctl.input", "ctl.replay", "ctl.fetch")
DT = 0.01


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    tracing.clear()
    tracing.enable()
    try:
        yield
    finally:
        tracing.enable(False)
        tracing.clear()


def test_spans_off_record_nothing():
    tracing.enable(False)
    tracing.clear()
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b", 3)  # the shared no-op
    with tracing.span("a", 0):
        with tracing.span("b"):
            pass
    assert tracing.records() == [] and tracing.dropped() == 0


def test_nested_spans_have_their_parent_and_tick(traced):
    with tracing.span("outer", 7):
        with tracing.span("inner"):
            with tracing.span("leaf", 9):
                pass
        with tracing.span("second"):
            pass
    with tracing.span("alone"):
        pass
    recs = {r.name: r for r in tracing.records()}
    assert [r.name for r in tracing.records()] == ["leaf", "inner", "second", "outer", "alone"]
    assert (recs["outer"].parent, recs["outer"].tick) == (None, 7)
    assert (recs["inner"].parent, recs["inner"].tick) == ("outer", 7)
    assert (recs["leaf"].parent, recs["leaf"].tick) == ("inner", 9)
    assert (recs["second"].parent, recs["alone"].parent, recs["alone"].tick) == ("outer", None,
                                                                                  None)
    for child, parent in (("inner", "outer"), ("second", "outer"), ("leaf", "inner")):
        c, p = recs[child], recs[parent]
        assert p.t0_ns <= c.t0_ns <= c.t1_ns <= p.t1_ns
    assert recs["inner"].t1_ns <= recs["second"].t0_ns
    tracing.clear()
    assert tracing.records() == []


def test_span_names_show_in_a_profiler_trace(traced):
    from torch.profiler import ProfilerActivity, profile

    with tracing.span("outside"):  # no profiler: no record_function
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ctl.on_state", 0):
            with tracing.span("ctl.fetch"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert {"indy7.ctl.on_state", "indy7.ctl.fetch"} <= set(names)
    assert "indy7.outside" not in names
    assert [r.name for r in tracing.records()] == ["outside", "ctl.fetch", "ctl.on_state"]


def test_records_are_bounded(traced, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    for i in range(5):
        with tracing.span("s", i):
            pass
    assert [r.tick for r in tracing.records()] == [0, 1, 2] and tracing.dropped() == 2
    tracing.clear()
    assert tracing.dropped() == 0


def test_counters_count():
    keys = {"graph_captures", "library_builds", "library_loads", "allocator_segments",
            "alloc_retries", "gc_gen2"}
    before = tracing.counters("cpu")
    assert set(before) == keys
    gc.collect(2)
    _build.counts["loads"] += 1
    try:
        after = tracing.counters("cpu")
    finally:
        _build.counts["loads"] -= 1
    assert after["gc_gen2"] >= before["gc_gen2"] + 1
    assert after["library_loads"] == before["library_loads"] + 1
    assert after["allocator_segments"] == after["alloc_retries"] == 0  # no CUDA allocator


def test_stall_hunt_reads_the_counters():
    """``StallHunt`` keeps its keys (those of ``LATENCY_TORCH.md``'s stall
    hunt) and reads their counts from ``tracing.counters()``."""
    counts = latency_decomp.StallHunt(torch.device("cpu")).counts()
    c = tracing.counters("cpu")
    assert tuple(counts) == latency_decomp.EVENT_KINDS == (
        "library_builds_or_loads", "allocator_segments", "alloc_retries", "gc_gen2")
    assert counts["library_builds_or_loads"] == c["library_builds"] + c["library_loads"]
    assert counts["alloc_retries"] == c["alloc_retries"]


def test_controller_tick_records_its_spans(traced):
    """A CPU ``SampledController``: each ``on_state`` records
    ``ctl.on_state`` (its tick id the tick count) around ``ctl.input``,
    ``ctl.replay`` and ``ctl.fetch``, once each, in that order;
    ``solve_time_us`` lies inside ``ctl.on_state``."""
    ref = np.tile(np.array([0.3, 0.4, 0.5], np.float32), (40, 1))
    ctl = SampledController(
        indy7(torch.float32), CostConfig(), SQPConfig(max_iters=1), MPCConfig(N=6, dt=DT),
        SampleConfig(batch_size=4, f_ext_std=5.0, f_ext_resample_std=0.5), ref,
        f_ext_actual=[3.0, 0.0, -5.0], device="cpu")
    tracing.clear()  # the warm-up tick is no on_state
    x = np.zeros(12, np.float32)
    infos = [ctl.on_state(x, DT)[1] for _ in range(3)]
    recs = tracing.records()
    assert [r.name for r in recs] == ["ctl.input", "ctl.replay", "ctl.fetch",
                                      "ctl.on_state"] * 3
    assert [r.tick for r in recs] == [t for t in range(3) for _ in range(4)]
    assert [r.parent for r in recs] == ["ctl.on_state"] * 3 + [None] + \
        (["ctl.on_state"] * 3 + [None]) * 2
    for t, info in enumerate(infos):
        inp, rep, fet, tick = recs[4 * t:4 * t + 4]
        assert tick.t0_ns <= inp.t0_ns <= inp.t1_ns <= rep.t0_ns <= rep.t1_ns <= fet.t0_ns
        assert fet.t1_ns <= tick.t1_ns
        assert info["solve_time_us"] <= (tick.t1_ns - tick.t0_ns) * 1e-3
    assert ctl.tick_count == 3


def test_k1_clock_slots_mirror_the_source():
    """``tracing.K1_SLOTS`` are the kernel's kClk* slots in order, and the
    accumulator holds kClockSlots of them."""
    text = (_build.CSRC_DIR / "sqp_kernel.cu").read_text()
    slots = dict((name, int(v)) for name, v in re.findall(r"\b(kClk\w+) = (\d+)", text))
    assert int(re.search(r"constexpr int kClockSlots = (\d+);", text).group(1)) == len(
        tracing.K1_SLOTS)
    names = {"Prologue": "prologue", "Linearize": "linearize", "Riccati": "riccati",
             "Rollout": "rollout", "LineSearch": "linesearch", "Epilogue": "epilogue",
             "Total": "total", "Blocks": "blocks", "Handoff": "handoff",
             "RcpSlow": "rcp_slow"}
    assert {names[k[len("kClk"):]]: v for k, v in slots.items()} == {
        s: i for i, s in enumerate(tracing.K1_SLOTS)}


def test_k1_stage_cycles_without_a_card():
    assert tracing.k1_stage_cycles("cpu") is None


# ---- On the card ----

COST, SQP = CostConfig(), SQPConfig(max_iters=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(dev, B, N, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, B)) * 8
    w[3:] = 0.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    args = [f32(rng.normal(size=shape) * scale) for shape, scale in (
        ((12, B), 0.05), ((N, 3, B), 0.3), ((N, 12, B), 0.05), ((N - 1, 6, B), 0.5))]
    return args, f32(w)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,horizon", [(64, 64), (64, 256)])
def test_k1_same_bits_with_stage_clocks(cuda, traced, lanes, horizon):
    """K1's outputs are the same bits with the stage clocks off and on (B=64
    at N=64, one block a lane, and at N=256, clusters of 2); on, every
    stage counts cycles, the stages sum to no more than the blocks' whole
    time, and every block of the launch is timed once."""
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1

    sm = LR.static_model(indy7(torch.float32, cuda))
    args, w = _k1_inputs(cuda, lanes, horizon)
    tracing.enable(False)
    off = K1.sqp_solve(sm, COST, SQP, DT, *args, wrench=w)
    assert tracing.k1_stage_cycles(cuda) == dict.fromkeys(tracing.K1_SLOTS, 0)
    tracing.enable()
    on = K1.sqp_solve(sm, COST, SQP, DT, *args, wrench=w)
    cycles = tracing.k1_stage_cycles(cuda)
    for a, b in zip(off, on):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert all(cycles[s] > 0 for s in tracing.K1_STAGES), cycles
    assert sum(cycles[s] for s in tracing.K1_STAGES) <= cycles["total"]
    assert cycles["blocks"] == lanes * K1.cluster_size(horizon)
    assert tracing.k1_stage_cycles(cuda) == dict.fromkeys(tracing.K1_SLOTS, 0)  # zeroed


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,horizon", [(64, 64), (64, 256)])
def test_k1_handoff_clock_counts_the_cluster_wait(cuda, traced, lanes, horizon):
    """The ``handoff`` slot counts the blocks' wait at the cluster barriers
    between segments of the Riccati sweep and the rollout: at N=256 (C=2)
    more than 0 and less than those two stages together; at N=64 (C=1,
    no cluster) 0."""
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1

    sm = LR.static_model(indy7(torch.float32, cuda))
    args, w = _k1_inputs(cuda, lanes, horizon)
    K1.sqp_solve(sm, COST, SQP, DT, *args, wrench=w)
    tracing.k1_stage_cycles(cuda)
    K1.sqp_solve(sm, COST, SQP, DT, *args, wrench=w)
    cycles = tracing.k1_stage_cycles(cuda)
    assert cycles["blocks"] == lanes * K1.cluster_size(horizon)
    if K1.cluster_size(horizon) == 1:
        assert cycles["handoff"] == 0, cycles
    else:
        assert 0 < cycles["handoff"] < cycles["riccati"] + cycles["rollout"], cycles


@pytest.mark.gpu
@pytest.mark.parametrize("lanes,horizon", [(64, 64), (64, 256)])
def test_k1_factor_reciprocals_stay_on_the_fast_path(cuda, traced, lanes, horizon):
    """``rcp_slow`` reads 0 after a clocked launch on the seeded inputs (one
    block a lane at N=64, clusters of 2 at N=256): every pivot of Quu,
    whose diagonal carries 2R + rho > 0, takes rcp_rn's fast path.  The
    slot does count: with R at 1e38, Quu's pivots (2R scaled by the cost's
    1/(|err| + eps), + rho) reach 2^126 or inf, past the fast range."""
    import dataclasses

    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1

    sm = LR.static_model(indy7(torch.float32, cuda))
    args, w = _k1_inputs(cuda, lanes, horizon)
    tracing.k1_stage_cycles(cuda)
    K1.sqp_solve(sm, COST, SQP, DT, *args, wrench=w)
    cycles = tracing.k1_stage_cycles(cuda)
    assert cycles["blocks"] == lanes * K1.cluster_size(horizon) and cycles["rcp_slow"] == 0, cycles
    K1.sqp_solve(sm, dataclasses.replace(COST, R=1e38), SQP, DT, *args, wrench=w)
    assert tracing.k1_stage_cycles(cuda)["rcp_slow"] > 0


# ptxas's figures of the one-block K1 entry (registers, stack frame, spill
# stores, spill loads): the hand-off clock lives in the cluster kernel only.
K1_PLAIN_PTXAS = (255, 64, 12, 16)


@pytest.mark.gpu
def test_one_block_k1_ptxas_line_is_unchanged(cuda):
    """``sqp_kernel<false>`` compiles as it did before the cluster kernel's
    hand-off clock: the same registers, stack frame and spills."""
    from indy7_mpc_tpu_torch import measure

    _build.load_library()
    k1 = measure.ptxas_figures(measure.ptxas_lines(_build.build_log(), "sqp_kernel"))
    assert [f for n, f in k1.items() if "ILb0" in n] == [K1_PLAIN_PTXAS], k1


@pytest.mark.gpu
def test_graph_captures_counted_and_clocks_switched_in_replays(cuda):
    """A loop runner's capture adds its graph count to ``graph_captures``;
    ``enable()`` after the capture switches K1's stage clocks in the
    replays: on, 10 replayed ticks count 10 launches' blocks; off, none."""
    from indy7_mpc_tpu_torch.mpc import init_loop_carry, make_loop_tick, reference
    from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner

    B, N = 8, 8
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    model = indy7(torch.float32, cuda)
    mpc, sample = MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.zeros(12, dtype=torch.float32, device=cuda)
    tick = make_loop_tick(model, COST, SQP, mpc, sample,
                          torch.as_tensor(ref, dtype=torch.float32, device=cuda), generator=gen)
    runner = LoopTickRunner(tick, init_loop_carry(model, mpc, sample, x0, [0.0] * 6, gen), 20)
    try:
        tracing.enable(False)
        runner.run(1)  # eager
        before = tracing.counters(cuda)["graph_captures"]
        runner.run(10)  # captures both graphs, replays the 10-tick one
        assert tracing.counters(cuda)["graph_captures"] - before == len(runner.graphs) == 2
        tracing.k1_stage_cycles(cuda)
        tracing.enable()
        runner.run(10)
        on = tracing.k1_stage_cycles(cuda)
        tracing.enable(False)
        runner.run(10)
        off = tracing.k1_stage_cycles(cuda)
    finally:
        tracing.enable(False)
    assert on["blocks"] == 10 * B and all(on[s] > 0 for s in tracing.K1_STAGES)
    assert off == dict.fromkeys(tracing.K1_SLOTS, 0)
