"""The point-to-goal loop, as ``run_mpc`` runs it.

``make_mpc_tick`` builds the tick and its carry after the warm-up solve,
with the default single-lane solver (K1 at B=1 on the card, its rho
carried in ``SolverState``) and K2 at B=1 as the nominal plant;
``graphed.TickRunner`` ticks it on fixed buffers, replaying its captured
graphs of 10 ticks.  The goals are the configuration's offsets added to
the start pose's end effector (``reference.goal_chain.goal_chain``), in
float32.  The loop draws nothing: the seed picks only the spans compared.

The window is made of whole chunks of ``chunk_ticks`` ticks, each ended
by a synchronization; ``loop_tick_us`` is the window's host-clock time
over its ticks.  The carry runs on across chunks, so the arm keeps
cycling its goals.  A chunk is up to three ``run`` calls: ``span_ticks``
ticks (one graph) start at a multiple of ``span_ticks`` drawn from the
seed, and the carry is copied before and after them.  A tick fails where
its state or torque is not finite, or where it ran on a frozen carry (its
goal distance past ``divergence_dist``).  After the window, ``check_spans``
of the chunks, drawn from the seed, go to the comparison
(``goal_compare.goal_gaps``).  With tracing, ``trace_ticks`` more ticks
run after the window with the program's tracing on: the host's time in
``runner.run`` before the sync (the enqueue of the captured graphs) goes
to the readers as ``values["replay_s"]`` over ``values["replay_ticks"]``,
and K1's cycles by stage over those ticks
(``tracing.k1_stage_cycles()``; None off the card) as
``values["k1_stage_cycles"]``.  Then ``trace_ticks`` more run under the
profiler, the program's tracing off.  The two are apart because the
profiler's own cost at each of a graph's ~8,000 launches, paid in the
replay, would read as the host's.

Mix keys: ``chunk_ticks``, ``span_ticks``, ``warmup_chunks``,
``check_spans``, ``trace_ticks``.
"""
from __future__ import annotations

import random
import time
from typing import List

import torch

from .. import compare, goal_compare, harness, profiling, timing
from ..harness import Context, Run
from ..reference import goal_chain as rg

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(cfg: dict, dev):
    """(tick, carry, goals (G, 3) float32 on the CPU) of ``cfg`` on ``dev``,
    as ``run_mpc`` builds them."""
    from indy7_mpc_tpu_torch.config import CostConfig, MPCConfig, SQPConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc.point_to_goal import make_mpc_tick

    if cfg["dtype"] != "float32" or cfg["batch_size"] != 1:
        raise ValueError("run_mpc runs one arm in float32")
    dep = rg.Deployment.from_config(cfg)  # refuses a plant other than run_mpc's nominal one
    goals = rg.goal_chain(dep).to(torch.float32)
    x0 = rg.start_state(dep, torch.float32).to(dev)
    mpc = MPCConfig(N=cfg["horizon"], dt=cfg["dt"], sim_substeps=cfg["plant"]["substeps"],
                    goal_switch_dist=cfg["switch_dist"],
                    divergence_dist=cfg["divergence_dist"])
    tick, carry = make_mpc_tick(indy7(torch.float32, dev), CostConfig(**cfg["cost"]),
                                SQPConfig(**cfg["sqp"]), mpc, x0, goals.to(dev))
    return tick, carry, goals


def run(ctx: Context) -> Run:
    from indy7_mpc_tpu_torch.mpc.graphed import TickRunner

    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    chunk, span = mix["chunk_ticks"], mix["span_ticks"]
    if chunk % span or chunk < span or mix["trace_ticks"] > chunk:
        raise ValueError("chunk_ticks must be a multiple of span_ticks and hold trace_ticks")
    tick, carry, goals = build(cfg, dev)
    runner = TickRunner(tick, carry, chunk, what="run_mpc's tick")
    starts = random.Random(ctx.seed)
    zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    state = {"bad": zero(), "switches": zero(), "last": carry.goal_idx.clone()}
    div = cfg["divergence_dist"]

    def run_ticks(n: int, traced: bool = False):
        with profiling.span("run", traced):
            tr = runner.run(n)
            ok = torch.isfinite(tr.x).all(1) & torch.isfinite(tr.u).all(1)
            state["bad"] += (~ok | (tr.goal_dist > div)).sum()
            before = torch.cat([state["last"].reshape(1), tr.goal_idx[:-1]])
            state["switches"] += (tr.goal_idx != before).sum()
            state["last"] = tr.goal_idx[-1]
        return tr

    def one_chunk(keep: bool):
        """A chunk; returns its span's record when ``keep``."""
        j0 = span * starts.randrange(chunk // span)
        record = None
        for i, n in enumerate((j0, span, chunk - j0 - span)):
            if n == 0:
                continue
            if i == 1:
                pre = goal_compare.carry_dict(runner.carry_bufs)
            tr = run_ticks(n)
            if i == 1 and keep:
                record = (pre, goal_compare.carry_dict(runner.carry_bufs),
                          {k: getattr(tr, k) for k in goal_compare.ROWS})
        _sync(dev)
        return record

    for _ in range(mix["warmup_chunks"]):
        one_chunk(False)
    state["bad"].zero_()
    state["switches"].zero_()
    card_before = harness.card_state() if dev.type == "cuda" else "cpu"
    t_first = time.perf_counter()
    records: List[tuple] = []
    while True:
        records.append(one_chunk(True))
        elapsed = time.perf_counter() - t_first
        if elapsed >= ctx.seconds:
            break
    ticks = len(records) * chunk
    card_after = harness.card_state() if dev.type == "cuda" else "cpu"
    bad, switches = int(state["bad"]), int(state["switches"])
    trace, values = None, {}
    if ctx.trace:
        from indy7_mpc_tpu_torch import tracing

        n_tr = mix["trace_ticks"]
        tracing.enable()
        try:
            tracing.k1_stage_cycles(dev)  # zeroes K1's clocks
            t_replay = time.perf_counter()
            runner.run(n_tr)
            values["replay_s"] = time.perf_counter() - t_replay
            _sync(dev)
            values["replay_ticks"] = n_tr
            values["k1_stage_cycles"] = tracing.k1_stage_cycles(dev)
        finally:
            tracing.enable(False)

        def traced_ticks():
            run_ticks(n_tr, True)
            with profiling.span("sync", True):
                _sync(dev)

        trace = profiling.traced(traced_ticks, n_tr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del runner, tick, carry

    # ---- the check: spans drawn from the seed ----
    pick = compare.subsample(len(records), mix["check_spans"],
                             torch.Generator().manual_seed(ctx.seed))
    spans = [goal_compare.GoalSpan(*({k: v.cpu() for k, v in part.items()}
                                     for part in records[i])) for i in pick]
    del records
    t_check = time.perf_counter()
    gaps = goal_compare.goal_gaps(rg.Models(rg.Deployment.from_config(cfg)), goals, spans,
                                  ctx.cell.limits.get("trace_gap", 0.0))
    ctx.say(f"card before the window: {card_before}; after: {card_after}")
    ctx.say(f"goal chain {ctx.cell.name}: {ticks} ticks in {elapsed:.6f} s of window, "
            f"{switches} goal switches, {len(spans)} spans of {span} ticks compared in "
            f"{time.perf_counter() - t_check:.1f} s, {bad} ticks failed")
    values.update(spans=spans, goals=goals, switches=switches)
    return Run(
        attempted=ticks, failed=bad,
        end_to_end={"loop_tick_us": timing.per_tick_us(elapsed, ticks),
                    "setup_s": t_first - ctx.t0},
        gaps=gaps, memory_peak_bytes=peak, trace=trace, values=values,
    )
