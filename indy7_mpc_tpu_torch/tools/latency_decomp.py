"""Decompose the controller tick's latency on the card (port of
``tools/latency_decomp.py``).

At the production configuration (B=64, N=64, 2 SQP iterations, the fig-8
reference after 200 rows of padding, true wrench [-60, 20, -40] N) it
takes six direct measurements:

  null_rtt         a one-element add on the card, then
                   ``torch.cuda.synchronize()`` (the floor of any blocking
                   host -> device -> host call);
  fetch_rtt        ``.cpu()`` of a ready 8-float tensor (the transfer path);
  solve_device     per solve of 20 warm-started K1 solves
                   (``solvers.select.default_batch_solve_fn``, B-major, as
                   the TPU tool's) chained with no host read, by CUDA
                   events from the first to the last,
                   queued behind a device sleep so that the host's launch
                   path is not timed (whether the host kept ahead is
                   reported);
  solve_pipelined  30 solves enqueued, then one sync;
  solve_block      one solve and a sync each call;
  tick_block       ``SampledController.on_state``: solve, consensus,
                   resample and the one synchronizing fetch;

then the closed loop: ``run_control_loop`` against ``InProcessPlant`` with
the perturbed plant for ``--ticks`` ticks without the wall clock, and the
``solve_times`` it records.  One ``on_state`` is also profiled
(``measure.launch_work``): its device kernels and copies and their device
time split the residual (tick_block - null_rtt - fetch_rtt - solve_device,
the TPU tool's attribution) into the tick's other device work and the
host's share (``tick_host_us``), which its host-side launches
(``tick_host_launches``) turn into µs a launch.  On the card ``on_state``
replays the tick as one captured CUDA graph, so those launches are the
input copy, the graph launch (with PyTorch's two fills of the generator's
seed and offset) and the fetch; the graph's kernels are device work.

The stall hunt, this port's counterpart of the TPU tool's JIT-compile log,
counts what happens in the loop after its first tick (the first tick's
allocator growth is warm-up), from the port's stall counters
(``tracing.counters()``): builds and loads of the kernel library, growth
of the CUDA caching allocator (segments and allocation retries) and
Python generation-2 collections, and lists every tick above
``--stall-ms`` with the events that fell in it.

Writes ``--out`` (``LATENCY_TORCH.md``; never the TPU tool's
``LATENCY.md``) and prints one JSON line with the TPU tool's keys.

Usage: python3 -m indy7_mpc_tpu_torch.tools.latency_decomp [--ticks 600]
           [--stall-ms 100] [--B 64] [--N 64] [--out LATENCY_TORCH.md]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .. import measure, tracing
from ..config import PERTURBED_PLANT, CostConfig, SQPConfig
from ..examples import protocol
from ..models import indy7
from ..runtime import InProcessPlant, run_control_loop
from ..solvers.select import default_batch_solve_fn

ROOT = Path(__file__).resolve().parents[2]
DT = 0.01
# Repetitions: the TPU tool's.  solve_device is CHAINS chains of CHAIN
# solves each.
RTT_REPS, CHAIN, CHAINS, SOLVE_REPS, TICK_REPS = 50, 20, 5, 30, 30
EVENT_KINDS = ("library_builds_or_loads", "allocator_segments", "alloc_retries", "gc_gen2")


def pct(a, q):
    return float(np.percentile(np.asarray(a), q))


def p50_p95(a):
    return {"p50": pct(a, 50), "p95": pct(a, 95)}


class StallHunt:
    """Running counts of the events that can stall a control tick on
    ``dev``, by :data:`EVENT_KINDS`, read from ``tracing.counters()``:
    kernel library builds and loads, CUDA caching-allocator segments and
    allocation retries (on a card), and Python generation-2 collections."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def counts(self) -> dict:
        c = tracing.counters(self.dev)
        return {"library_builds_or_loads": c["library_builds"] + c["library_loads"],
                **{k: c[k] for k in EVENT_KINDS[1:]}}


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in EVENT_KINDS}


def closed_loop(model, B, N, ticks, dev):
    """The stall hunt: ``run_control_loop`` of a fresh controller against
    the perturbed in-process plant for ``ticks`` ticks without the wall
    clock.  Returns (the recorded tick µs, each tick's events, the events
    after the first tick)."""
    ctl = measure.runtime_controller(dev, B, N)
    plant = InProcessPlant(model, np.zeros(12), DT, plant_cfg=PERTURBED_PLANT, device=dev)
    hunt = StallHunt(dev)
    marks = [hunt.counts()]
    inner = ctl.on_state

    def on_state(x, elapsed):
        out = inner(x, elapsed)
        marks.append(hunt.counts())  # after the tick's own clock stopped
        return out

    ctl.on_state = on_state
    rec = run_control_loop(ctl, plant, duration=1e9, rate_hz=100, walk_disturbance=True,
                           realtime=False, max_ticks=ticks)
    plant.close()
    tick_us = rec._fetch("solve_times")
    per_tick = [diff(b, a) for a, b in zip(marks, marks[1:])]
    return tick_us, per_tick, diff(marks[-1], marks[1])


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--stall-ms", type=float, default=100.0)
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--out", default=str(ROOT / "LATENCY_TORCH.md"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = protocol.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B, N = args.B, args.N
    model = indy7(torch.float32, dev)
    solve = default_batch_solve_fn(model, CostConfig(), SQPConfig(max_iters=2), DT, dev)

    # 1. Dispatch floor: a one-element add, then a sync.
    x1 = torch.zeros((), device=dev)
    null_rtt = measure.blocking_us(lambda: x1 + 1.0, RTT_REPS, dev)

    # 2. Transfer path: fetch a small READY tensor.
    small = torch.zeros(8, device=dev)
    protocol.synchronize(dev)
    fetch_rtt = measure.blocking_us(lambda: small.cpu(), RTT_REPS, dev)

    # 3-5. The solve at the production configuration.
    xs_b, goals_b, X_b, U_b, wrench_b = measure.production_inputs(dev, B, N)
    res = solve(xs_b, goals_b, X_b, U_b, wrench_b)
    Xw, Uw = res.X, res.U
    XU = (Xw, Uw)

    def chained():
        nonlocal XU
        r = solve(xs_b, goals_b, *XU, wrench_b)
        XU = (r.X, r.U)

    if dev.type == "cuda":
        chains = [measure.queued_events(chained, CHAIN) for _ in range(CHAINS)]
        solve_device_us = float(np.mean([ms for ms, _ in chains])) * 1e3
        host_ahead = all(ahead for _, ahead in chains)
    else:  # no device clock: the host clock over the chain
        solve_device_us = measure.pipelined_ms(chained, CHAINS * CHAIN, dev) * 1e3
        host_ahead = None
    one = lambda: solve(xs_b, goals_b, Xw, Uw, wrench_b)
    solve_block = measure.blocking_us(one, SOLVE_REPS, dev)
    solve_pipelined_us = measure.pipelined_ms(one, SOLVE_REPS, dev, warmup=3) * 1e3

    # 6. The full controller tick, and its device work.
    ctl = measure.runtime_controller(dev, B, N)
    x0 = np.zeros(12, np.float32)
    tick_block = measure.blocking_us(lambda: ctl.on_state(x0, DT), TICK_REPS, dev)
    tick_launches = tick_device_ms = tick_host_us = tick_host_launches = None
    if dev.type == "cuda":
        tick_host_launches, tick_launches, tick_device_ms = measure.launch_work(
            lambda: ctl.on_state(x0, DT))

    # 7. The stall hunt: the closed loop against the perturbed plant.
    tick_us, per_tick, loop_events = closed_loop(model, B, N, args.ticks, dev)
    stalls = [{"tick": int(i), "us": float(tick_us[i]),
               "events": {k: v for k, v in per_tick[i].items() if v}}
              for i in np.nonzero(tick_us > args.stall_ms * 1e3)[0]]

    card = protocol.device_label(dev)
    residual_us = (pct(tick_block, 50) - pct(null_rtt, 50) - pct(fetch_rtt, 50)
                   - solve_device_us)
    if tick_device_ms is not None:  # the residual less the tick's other device work
        tick_host_us = residual_us + solve_device_us - tick_device_ms * 1e3
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "card": card,
        "config": f"B={B} N={N} iters=2",
        "null_rtt_us": p50_p95(null_rtt),
        "fetch_rtt_us": p50_p95(fetch_rtt),
        "solve_device_us": round(solve_device_us, 1),
        "solve_device_host_ahead": host_ahead,
        "solve_pipelined_us": round(solve_pipelined_us, 1),
        "solve_block_us": p50_p95(solve_block),
        "tick_block_us": p50_p95(tick_block),
        "host_residual_us": residual_us,
        "tick_device_launches": tick_launches,
        "tick_host_launches": tick_host_launches,
        "tick_device_ms": tick_device_ms,
        "tick_host_us": tick_host_us,
        "loop_ticks": int(len(tick_us)),
        "loop_tick_us": {**p50_p95(tick_us), "max": float(tick_us.max())},
        "stalls_over_thresh": stalls[:20],
        "event_ticks": [{"tick": i, "us": float(tick_us[i]),
                         "events": {k: v for k, v in e.items() if v}}
                        for i, e in enumerate(per_tick) if i and any(e.values())][:20],
        "compiles_during_loop": sum(loop_events.values()),
        **{f"{k}_during_loop": v for k, v in loop_events.items()},
    }
    print(json.dumps(report), flush=True)
    write_report(args, report, len(stalls))
    print(f"# wrote {args.out}", file=sys.stderr)
    return 0


def write_report(args, r, n_stalls):
    us = lambda v: f"{v:,.1f} us"
    solve_us, residual = r["solve_device_us"], r["host_residual_us"]
    if r["solve_device_host_ahead"] is None:
        chain_note = "by the host clock: no device clock on the CPU"
    elif r["solve_device_host_ahead"]:
        chain_note = (f"by CUDA events; the host had queued all {CHAIN} solves before the first "
                      "ran, so no host time is in it")
    else:
        chain_note = (f"by CUDA events, but the host had NOT queued all {CHAIN} solves before the "
                      "first ran: the host's launch path is in this figure")
    if r["tick_device_launches"]:
        n, host, h = r["tick_device_launches"], r["tick_host_us"], r["tick_host_launches"]
        per = f", {us(host / h)} for each of its {h} host-side launches" if h else ""
        work = (f"One `on_state` runs {n} device kernels and copies with "
                f"{us(r['tick_device_ms'] * 1e3)} of device time (`measure.launch_work`), "
                f"launched by {h} host-side calls (the input copy, the replay of the tick's "
                f"CUDA graph with the generator's seed and offset fills, the fetch): "
                f"{us(residual - host)} of the residual is device work besides the solve (K2 as "
                f"the consensus and the tick's small kernels), the other {us(host)} is the "
                f"host's{per}.")
    else:
        work = "Launches a tick: not measured (no card)."
    events = {k: r[f"{k}_during_loop"] for k in EVENT_KINDS}
    lines = [
        "# LATENCY_TORCH — per-tick control latency decomposition of the PyTorch/CUDA port",
        "",
        f"Measured by `python3 -m indy7_mpc_tpu_torch.tools.latency_decomp --ticks "
        f"{args.ticks}` on {r['card']}, config {r['config'].replace('iters=2', '2 SQP iterations')}"
        f", the fig-8 reference after 200 rows of padding, true wrench [-60, 20, -40] N. "
        f"Every figure below was taken on that device; none is a TPU's (the TPU package's "
        f"decomposition is `LATENCY.md`).",
        "",
        "| quantity | p50 | p95 |",
        "|---|---|---|",
        f"| one-element add on the card + `torch.cuda.synchronize()`, blocking round trip | "
        f"{us(r['null_rtt_us']['p50'])} | {us(r['null_rtt_us']['p95'])} |",
        f"| `.cpu()` of a ready 8-float tensor | {us(r['fetch_rtt_us']['p50'])} | "
        f"{us(r['fetch_rtt_us']['p95'])} |",
        f"| full solve, device-chained (device compute) | {us(solve_us)} | — |",
        f"| full solve, pipelined enqueue | {us(r['solve_pipelined_us'])} | — |",
        f"| full solve, blocking each call | {us(r['solve_block_us']['p50'])} | "
        f"{us(r['solve_block_us']['p95'])} |",
        f"| controller tick (on_state: solve+consensus+fetch) | "
        f"{us(r['tick_block_us']['p50'])} | {us(r['tick_block_us']['p95'])} |",
        f"| closed-loop tick incl. plant ({r['loop_ticks']} ticks) | "
        f"{us(r['loop_tick_us']['p50'])} | {us(r['loop_tick_us']['p95'])} "
        f"(max {us(r['loop_tick_us']['max'])}) |",
        "",
        "## Attribution",
        "",
        f"A blocking tick on this device pays the dispatch round trip "
        f"({us(r['null_rtt_us']['p50'])} for a one-element add) plus the result fetch "
        f"({us(r['fetch_rtt_us']['p50'])}) besides the device compute, {us(solve_us)} per "
        f"solve ({chain_note}). Blocking on each solve costs {us(r['solve_block_us']['p50'])}"
        f", enqueuing them back to back {us(r['solve_pipelined_us'])} a solve. Residual "
        f"host-side work in on_state (tick_block - null_rtt - fetch_rtt - solve_device): "
        f"{us(residual)}. {work} The device-resident loop (`run_sampled_mpc`) has no "
        f"fetch a tick, only its launches.",
        "",
        "## Stall hunt",
        "",
        f"{r['loop_ticks']}-tick perturbed closed loop (`run_control_loop` against "
        f"`InProcessPlant(PERTURBED_PLANT)`, no wall clock): {n_stalls} ticks over "
        f"{args.stall_ms:g} ms. After the first tick (whose allocator growth is warm-up and "
        f"is not counted): {events['library_builds_or_loads']} kernel-library builds or loads, "
        f"{events['allocator_segments']} new caching-allocator segments, "
        f"{events['alloc_retries']} allocation retries, {events['gc_gen2']} Python "
        f"generation-2 collections ({r['compiles_during_loop']} events in all).",
        "",
    ]
    if r["stalls_over_thresh"]:
        lines += ["Stall ticks (first 20): " + ", ".join(
            f"#{s['tick']}={s['us'] / 1e3:,.1f}ms" + (f" {s['events']}" if s["events"] else "")
            for s in r["stalls_over_thresh"]), ""]
    if r["event_ticks"]:
        lines += ["Ticks after the first with events (first 20): " + ", ".join(
            f"#{e['tick']}={e['us'] / 1e3:,.2f}ms {e['events']}" for e in r["event_ticks"]), ""]
    with open(args.out, "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    sys.exit(main())
