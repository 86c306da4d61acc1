"""The device-resident closed loop, as ``run_sampled_mpc`` runs it.

``make_loop_tick`` builds the two-kernel ``FusedLoopTick`` (K1 the batched
SQP solve, K2 the consensus, plant step and trace), ``init_loop_carry``
the cold start, and ``LoopTickRunner`` ticks it on fixed buffers, replaying
its captured graphs of 10 ticks.  Its random draws come from a generator
on the card seeded with ``--seed``.

The window is made of whole chunks of ``chunk_ticks`` ticks, each ended by
a synchronization; ``loop_tick_us`` is the window's host-clock time over
its ticks.  A chunk is up to three ``run`` calls: ``span_ticks`` ticks
(one graph) start at a multiple of ``span_ticks`` drawn from the seed, and
the carry is copied (``runner.carry()``) before and after them.  Between
chunks the reference offset moves back by whole periods of the fig-8
(``traffic.wrapped_offset``).  After the window, ``check_spans`` of the
chunks, drawn from the seed, go to the comparison (``compare.loop_gaps``)
with their draws, which a second generator replays from the first one's
state.  With tracing, ``trace_chunks`` more chunks run under the profiler
after the window.

Mix keys: ``chunk_ticks``, ``span_ticks``, ``warmup_chunks``,
``check_spans``, ``trace_chunks``.
"""
from __future__ import annotations

import random
import time
from typing import List

import torch

from .. import compare, profiling, program, timing, traffic
from .. import harness
from ..harness import Context, Run
from ..reference import tick as rt


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _draws(dev, state, ticks: int, B: int, substeps: int):
    """The draws of ``ticks`` ticks of ``draw_tick`` from a generator at
    ``state``: per tick the (B, 6) resampling normals, the (3,) walk and
    the (substeps, 6) actuation noise."""
    g = torch.Generator(device=dev)
    g.set_state(state)
    out = {"resample": [], "walk": [], "plant": []}
    for _ in range(ticks):
        out["resample"].append(torch.randn((B, 6), generator=g, device=dev))
        out["walk"].append(torch.randn(3, generator=g, device=dev))
        out["plant"].append(torch.randn((substeps, 6), generator=g, device=dev))
    return {k: torch.stack(v).cpu() for k, v in out.items()}


def run(ctx: Context) -> Run:
    from indy7_mpc_tpu_torch.mpc import init_loop_carry, make_loop_tick
    from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner

    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    chunk, span = mix["chunk_ticks"], mix["span_ticks"]
    if chunk % span or chunk < span:
        raise ValueError("chunk_ticks must be a multiple of span_ticks")
    s = program.setup(cfg, dev)
    ref_rows = program.reference_rows(cfg, chunk)
    ref = torch.as_tensor(ref_rows, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    tick = make_loop_tick(s.model, s.cost, s.sqp, s.mpc, s.sample, ref, f_true_walk=True,
                          plant_cfg=s.plant, generator=gen)
    gen_start = gen.get_state()
    carry = init_loop_carry(s.model, s.mpc, s.sample, s.x0, s.f_true0, gen)
    f_start = carry.f_batch.clone()
    runner = LoopTickRunner(tick, carry, chunk)
    starts = random.Random(ctx.seed)
    state = {"offset": 0, "bad": torch.zeros((), dtype=torch.int64, device=dev)}

    def one_chunk(keep: bool, traced: bool = False):
        """A chunk; returns its span's record when ``keep``."""
        wrapped = traffic.wrapped_offset(cfg, state["offset"])
        if wrapped != state["offset"]:
            runner.carry_bufs.ref_offset.sub_(state["offset"] - wrapped)
            state["offset"] = wrapped
        j0 = span * starts.randrange(chunk // span)
        parts = [n for n in (j0, span, chunk - j0 - span)]
        record = None
        for i, n in enumerate(parts):
            if n == 0:
                continue
            if i == 1:
                with profiling.span("snapshot", traced):
                    pre, gstate = runner.carry(), gen.get_state()
            with profiling.span("run", traced):
                tr = runner.run(n)
                state["bad"] += (~(torch.isfinite(tr.x).all(1) & torch.isfinite(tr.u).all(1))).sum()
            if i == 1:
                with profiling.span("snapshot", traced):
                    post = runner.carry()
                if keep:
                    record = (pre._asdict(), post._asdict(),
                              {k: getattr(tr, k) for k in compare.ROWS}, gstate)
            state["offset"] += n
        with profiling.span("sync", traced):
            _sync(dev)
        return record

    for _ in range(mix["warmup_chunks"]):
        one_chunk(False)
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
    trace = None
    if ctx.trace:
        n_tr = mix["trace_chunks"]
        trace = profiling.traced(lambda: [one_chunk(False, True) for _ in range(n_tr)],
                                 n_tr * chunk)
    bad = int(state["bad"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del runner, tick, carry

    # ---- the check: spans drawn from the seed, then the draws replayed ----
    pick = compare.subsample(len(records), mix["check_spans"],
                             torch.Generator().manual_seed(ctx.seed))
    spans = []
    for i in pick:
        pre, post, rows, gstate = records[i]
        draws = _draws(dev, gstate, span, cfg["batch_size"], cfg["plant"]["substeps"])
        spans.append(compare.LoopSpan({k: v.cpu() for k, v in pre.items()},
                                      {k: v.cpu() for k, v in post.items()},
                                      {k: v.cpu() for k, v in rows.items()}, draws))
    del records
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    models = rt.Models(rt.Deployment.from_config(cfg))
    g = torch.Generator(device=dev)
    g.set_state(gen_start)
    gaps = compare.start_gaps(models, compare.loop_gaps(models, ref_rows, spans), f_start,
                              torch.randn((cfg["batch_size"], 6), generator=g, device=dev))
    ctx.say(f"card before the window: {card_before}; after: {card_after}")
    ctx.say(f"loop {ctx.cell.name}: {ticks} ticks in {elapsed:.6f} s of window, "
            f"{len(spans)} spans of {span} ticks compared in "
            f"{time.perf_counter() - t_check:.1f} s, {bad} ticks not finite")
    return Run(
        attempted=ticks, failed=bad,
        end_to_end={"loop_tick_us": timing.per_tick_us(elapsed, ticks),
                    "setup_s": t_first - ctx.t0},
        gaps=gaps, memory_peak_bytes=peak, trace=trace,
        values={"spans": spans, "reference": ref_rows},
    )
