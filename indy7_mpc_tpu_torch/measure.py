"""Time the port's kernels and closed-loop tick on one CUDA card, or record
a long host-dispatch run.

Usage: python3 -m indy7_mpc_tpu_torch.measure [--out PATH]
           [--runtime [--stats-dir DIR] | --udp | --k2 [--baseline DIR] | --readable | --qp
            | --loops | --horizon]

Without ``--runtime`` it prints, and writes as JSON to ``--out``:
  * the card's name and power limit (nvidia-smi);
  * kernel K1 (``sqp_solve``) alone: CUDA-event ms per launch and
    lane-solves/s over a sweep of lane counts B, horizons N and SQP
    iteration counts, on random inputs like tests/test_pallas_kernel.py,
    each row with its blocks a lane and a block's shared bytes, its
    floating-point operations and bytes
    (``roofline.k1_work``: the kernel's own arithmetic), the bound they
    give on an H100 (67 TFLOP/s float32, 3.35 TB/s) and the share of that
    bound reached;
  * K1 at B=64, N=64, 2 SQP iterations at 256 and 128 threads a block, in
    turns, and cumulatively at its profiling cut, stages 1, 1-2, 1-3 and
    1-4;
  * the closed-loop tick at the fig-8 configuration (N=64, 2 SQP
    iterations, perturbed plant) at B = 64, 256 and 1,024, eager (a Python
    loop over the tick module) and graphed (``mpc.graphed.LoopTickRunner``,
    replayed CUDA graphs) in turns (``loop_modes``): µs per tick by CUDA
    events and by the host clock, host-side launches, device kernels and
    device µs a tick under ``torch.profiler``, and the busy share;
  * the runtime's controller tick (B=64, N=64, without a plant), graphed
    (``SampledController.on_state``) and eager (its ``ControllerTick``
    called directly) in turns: host-clock p50/p95 and the launches and
    device time of one tick;
  * kernel K2 (``tick_epilogue``, see ``--k2``).

With ``--k2`` it runs only K2's section: CUDA-event ms per launch over 50
launches after a warm-up (``k2_times``), for each of K2's three calls (the
device loop's at B=64 on the perturbed plant, the controller's consensus
at B=64 with the plant skipped, the in-process plant's step at B=1 on the
perturbed plant) and for the device loop's call at B = 64, 256, 1,024 and
4,096, each beside its flops and bytes (``roofline.k2_work``), its bound
and its chain of dependent forward-dynamics calls; at 512 and 256 threads,
in turns; and ptxas's line for ``tick_kernel``.  ``--baseline DIR`` adds
the K2 of the checkout in DIR, in turns with this one: the same
``k2_times`` runs in a subprocess against DIR's package, which builds its
kernels from its own sources and is called through its own wrapper (at
its default launch; a wrapper without ``plant`` runs the consensus with
its plant step).

With ``--runtime`` it instead records the host-dispatch run of the TPU
package's ``stats_tpu/perturbed_b64`` golden (examples/record_runs.py:
B=64, N=64, 2 SQP iterations, fig-8 of 10 cycles after 200 rows of
padding, true wrench [-60, 20, -40] N, 3,500 ticks): ``SampledController``
against ``InProcessPlant(PERTURBED_PLANT)``, both on the card, through
``run_control_loop`` without the wall clock.  ``RunRecorder``
writes the run into ``<--stats-dir>/perturbed_b64/`` (by default
``build/stats_torch/perturbed_b64/``), and
``tools/analyze_stats.py`` prints it beside the golden.

With ``--udp`` it instead runs the same controller over UDP against
``plant_node`` (the perturbed plant's flags, ports 7620/7621), 300 ticks
twice at each setting: ``--realtime-scale 4`` (the ``perturbed_b64_udp``
golden's), scale 4 with each command held 23 ms after the tick (the
24-25 ms tick of the thread-per-lane K1), and real time.  Per tick it
logs when the state was read and the command sent, and gives the
command's lag behind the plant's publication of the state it answers, in
plant physics steps (2 ms of plant time): the number of the next
period's 5 steps that still ran the previous command.  It prints the
wrench-estimate error overall and grouped by that number.

With ``--readable`` it instead takes the readable tick
(``make_loop_tick(fused=False)``, the same fig-8 configuration) apart:
the whole tick and each of its parts on the tick's own state after two
warm ticks (the batched solve, and inside it the QP blocks, the Riccati
sweep and one line search's merit over 9 candidates; the consensus; the
plant step), each by the host clock (mean of 3 calls after a warm-up) and
under ``torch.profiler`` (one call: device time, kernel launches, busy
share).

With ``--qp`` it instead times the QP step alone, the readable solver's
four backends (``riccati``, ``riccati_pscan``, ``pcg``, ``admm`` at their
default settings) on the same random float32 blocks at B=64, N=64 (like
tools/profile_pscan.py's): per call the host-clock ms and the CUDA-event
ms from the first launch to the last (mean of 3 calls after a warm-up),
the device kernels and device ms of one call (``torch.profiler``'s raw
CUDA events), and the host syncs (``torch.cuda.set_sync_debug_mode``),
with the CG and ADMM iteration counts.

With ``--loops`` it instead times the other loops that replay captured
graphs, each eager and graphed in turns (``modes_in_turns``): the
single-lane ticks of ``run_mpc`` (N=32, 3 SQP iterations) and
``run_tracking_mpc`` (N=32, 2) in runs of 100 ticks (``single_lane_modes``),
the readable tick at B=64, N=64 on the Riccati and the PCG backends in
runs of 2 ticks with its graph's capture seconds and pool bytes
(``readable_loop_modes``), and the readable controller tick
(formulation "reference") over 5 ticks of each (``controller_timing``).

With ``--horizon`` it instead times K1 past one block's shared memory,
N = 175, 256 and 512 at B = 1, 64 and 256 and then B=64, N=64 again
(``K1_HORIZONS``, each row with its blocks a lane and shared bytes), the
graphed and eager B=64 closed loop at N=256 in runs of 100 ticks
(``loop_modes``) and the controller tick at N=256 (``controller_timing``).

It checks nothing; ``chip_smoke.py`` is the correctness run.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig
from .examples.protocol import synchronize
from .models import indy7
from .mpc import init_loop_carry, make_loop_tick, reference
from .mpc.graphed import LoopTickRunner
from .ops import lane_rbd as LR
from .ops.kernels import sqp_kernel as K1
from .ops.kernels.sqp_kernel import sqp_solve
from .ops.kernels import _build
from .ops.kernels import tick_kernel as K2
from .roofline import bound_ms, k1_work, k2_work
from .runtime import (
    InProcessPlant, RunRecorder, SampledController, UdpTransport, run_control_loop,
)

ROOT = Path(__file__).resolve().parents[1]
DT = 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
# (B, N, SQP iterations); the first is repeated last to show drift.
# (1, 32, 3) is the single-lane solve of run_mpc at the point-to-goal
# configuration; N=256 and 512 take clusters of 2 and 3 blocks a lane.
K1_SWEEP = [(64, 64, 2), (64, 64, 1), (64, 32, 2), (256, 64, 2),
            (1024, 64, 2), (4096, 64, 2), (1, 32, 3), (64, 256, 2), (64, 512, 2),
            (64, 64, 2)]
# Past one block's 174 knots (a cluster of 2, 2 and 3 blocks a lane), at
# one lane, the main path's 64 and 256; then the main path's N=64 again.
K1_HORIZONS = [(B, N, 2) for N in (175, 256, 512) for B in (1, 64, 256)] + [(64, 64, 2)]


# A device sleep that the timed launches queue behind: about 55 ms at the
# H100's clocks, longer than the host takes to enqueue them.
SLEEP_CYCLES = 100_000_000


def queued_events(fn, reps, warmup=True):
    """(mean device ms per call of ``fn`` over ``reps`` calls by CUDA events,
    whether the host had queued every call before the first ran), after a
    warm-up call unless ``warmup`` is false.  The calls queue behind a
    device sleep, so while the host keeps ahead of the sleep a launch whose
    host side takes longer than its kernel is timed by the kernel; the
    second value says whether it did."""
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ahead = not start.query()  # the sleep still runs
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ahead


def _events_ms(fn, reps):
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events,
    :func:`queued_events`)."""
    return queued_events(fn, reps)[0]


def blocking_us(fn, reps, dev, warmup=3):
    """Host-clock microseconds of each of ``reps`` calls of ``fn``, each
    followed by a sync of ``dev``, after ``warmup`` calls: what a caller
    that waits for every result pays."""
    for _ in range(warmup):
        fn()
        synchronize(dev)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        out.append((time.perf_counter() - t0) * 1e6)
    return np.asarray(out)


def pipelined_ms(fn, reps, dev, warmup=2):
    """Mean host-clock ms per call of ``fn`` over ``reps`` calls queued back
    to back, from the first call to a sync of ``dev`` after the last, after
    ``warmup`` calls: the module call plus a sync, as a JAX tool times a
    jitted call."""
    for _ in range(warmup):
        fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def k1_inputs(dev, B, N, seed=11):
    """Random lane-major K1 inputs (xs, goals, X, U) and wrench, like
    tests/test_pallas_kernel.py's."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    w = rng.normal(size=(6, B)) * 8
    w[3:] = 0.0
    args = (f32(rng.normal(size=(12, B)) * 0.05), f32(rng.normal(size=(N, 3, B)) * 0.3),
            f32(rng.normal(size=(N, 12, B)) * 0.05), f32(rng.normal(size=(N - 1, 6, B)) * 0.5))
    return args, f32(w)


def production_inputs(dev, B, N):
    """The TPU tools' B-major solve inputs (tools/latency_decomp.py,
    tools/profile_solve.py): xs (B, 12), X (B, N, 12) and U (B, N-1, 6)
    zero, goals (B, N, 3) all at [0.35, 0.35, 0.6], and the wrench
    hypotheses (B, 6) of ``init_wrench_batch`` (sigma 20 N, generator seed
    42); float32 on ``dev``."""
    from .mpc.sampled import init_wrench_batch

    gen = torch.Generator(device=dev).manual_seed(42)
    wrench = init_wrench_batch(gen, SampleConfig(batch_size=B, f_ext_std=20.0), torch.float32,
                               dev)
    goals = torch.tensor([0.35, 0.35, 0.6], device=dev).expand(B, N, 3).contiguous()
    return (torch.zeros((B, 12), device=dev), goals, torch.zeros((B, N, 12), device=dev),
            torch.zeros((B, N - 1, 6), device=dev), wrench)


def k1_sweep(dev, card, reps=20, sweep=K1_SWEEP):
    """K1 at each (B, N, SQP iterations) of ``sweep``: CUDA-event ms per
    launch, its blocks a lane and a block's shared bytes, the bound and
    its share."""
    sm = LR.static_model(indy7(torch.float32, dev))
    cost, rows = CostConfig(), []
    print(f"K1 sweep on {card}; bounds against the H100 SXM's published 67 TFLOP/s "
          "float32 and 3.35 TB/s (at 700 W)", flush=True)
    for B, N, iters in sweep:
        args, w = k1_inputs(dev, B, N)
        sqp = SQPConfig(max_iters=iters)
        ms = _events_ms(lambda: sqp_solve(sm, cost, sqp, DT, *args, wrench=w), reps)
        flops, nbytes = k1_work(B, N, cost, sqp)
        bound, by = bound_ms(flops, nbytes)
        cluster, smem = K1.check_horizon(N, sqp.num_alphas)
        rows.append({"B": B, "N": N, "iters": iters, "ms": ms,
                     "lane_solves_per_s": B / (ms * 1e-3), "flops": flops, "bytes": nbytes,
                     "bound_us": bound * 1e3, "bound_by": by, "share_of_bound": bound / ms,
                     "cluster": cluster, "smem_bytes": smem})
        print(f"K1 B={B} N={N} iters={iters}: {ms:.4f} ms/launch, "
              f"{B / (ms * 1e-3):.1f} lane-solves/s; {cluster} block(s) a lane of {smem} "
              f"bytes of shared memory; {flops} flop, {nbytes} B, "
              f"bound {bound * 1e3:.3f} us ({by}), {100 * bound / ms:.3f}% of it", flush=True)
    return rows


def k1_variants(dev, reps=50, B=64, N=64, iters=2):
    """K1 at 256 and 128 threads a block, in turns (A B B A), and at its
    profiling cut (stages 1, 1-2, 1-3, 1-4), CUDA-event ms per launch."""
    sm = LR.static_model(indy7(torch.float32, dev))
    cost, sqp = CostConfig(), SQPConfig(max_iters=iters)
    args, w = k1_inputs(dev, B, N)
    times = {256: [], 128: []}
    for t in (256, 128, 128, 256):
        times[t].append(_events_ms(lambda: sqp_solve(
            sm, cost, sqp, DT, *args, wrench=w, threads=t), reps))
    out = {"variants": [{"threads": t, "ms": ms} for t, l in times.items() for ms in l]}
    for t, l in times.items():
        print(f"K1 B={B} N={N} iters={iters} threads={t}: {l[0]:.4f}, {l[1]:.4f} ms", flush=True)
    out["stages"] = []
    for stages in (1, 2, 3, 4):
        ms = _events_ms(lambda: sqp_solve(sm, cost, sqp, DT, *args, wrench=w, stages=stages), reps)
        out["stages"].append({"stages": stages, "ms": ms})
        print(f"K1 B={B} N={N} iters={iters} stages 1-{stages}: {ms:.4f} ms", flush=True)
    return out


def fig8_loop(dev, B, N=64, sqp_cfg=None, fused=True):
    """The closed-loop tick of the fig-8 configuration (N=64, 2 SQP
    iterations, perturbed plant) at B lanes: (the tick module, its cold
    carry), both drawing from one generator seeded 42.  ``sqp_cfg``
    replaces the solver's configuration; ``fused=False`` gives the
    readable tick."""
    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=1), 200)
    model = indy7(torch.float32, dev)
    mpc_cfg, sample_cfg = MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B)
    gen = torch.Generator(device=dev).manual_seed(42)
    tick = make_loop_tick(
        model, CostConfig(), sqp_cfg or SQPConfig(max_iters=2), mpc_cfg, sample_cfg,
        torch.as_tensor(ref, dtype=torch.float32, device=dev),
        plant_cfg=PERTURBED_PLANT, generator=gen, fused=fused,
    )
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    return tick, init_loop_carry(model, mpc_cfg, sample_cfg, x0, F_TRUE0, gen)


def eager_loop(tick, carry, ticks):
    """``run()``: ``ticks`` eager calls of ``tick`` (a Python loop, the port
    before its graphs), each run going on from the last one's carry."""
    state = [carry]

    def run():
        for _ in range(ticks):
            state[0], _ = tick(state[0])

    return run


def loop_modes(dev, B, ticks=100, N=64):
    """The fig-8 closed-loop tick at B lanes and horizon N, eager (a Python
    loop over the tick module) and graphed (``mpc.graphed.LoopTickRunner``,
    as ``run_sampled_mpc`` runs it), in turns (:func:`modes_in_turns`)."""
    tick, carry = fig8_loop(dev, B, N)
    runner = LoopTickRunner(tick, carry, ticks)
    return modes_in_turns(f"closed-loop tick B={B} N={N} perturbed", ticks, {
        "eager": eager_loop(tick, carry, ticks), "graphed": lambda: runner.run(ticks)})


def readable_loop_modes(dev, B=64, N=64, ticks=2, qp_backend="riccati"):
    """The readable fig-8 tick (``make_loop_tick(fused=False)`` on the QP
    backend ``qp_backend``) at B lanes and horizon N, eager and graphed (on
    ``LoopTickRunner`` one tick a graph, as ``run_sampled_mpc`` runs it),
    in turns (:func:`modes_in_turns`); the graphed entry adds its graph's
    capture-and-instantiate seconds and pool bytes."""
    sqp_cfg = SQPConfig(max_iters=2, qp_backend=qp_backend)
    tick, carry = fig8_loop(dev, B, N, sqp_cfg, fused=False)
    runner = LoopTickRunner(tick, carry, ticks, ticks_per_graph=1)
    out = modes_in_turns(f"readable tick ({qp_backend}) B={B} N={N} perturbed", ticks, {
        "eager": eager_loop(tick, carry, ticks), "graphed": lambda: runner.run(ticks)})
    g = runner.graphs[0]
    out["graphed"].update(capture_s=g.seconds, pool_bytes=g.pool_bytes)
    print(f"  its graph: {g.seconds:.2f} s to capture and instantiate, "
          f"{g.pool_bytes / 2**20:.1f} MiB pool", flush=True)
    return out


def single_lane_loop(dev, loop):
    """``run_mpc`` at the point-to-goal configuration (N=32, 3 SQP
    iterations, examples/point_to_goal.py's goal chain, from the state at
    zero) or ``run_tracking_mpc`` on the fig-8 (N=32, 2 SQP iterations,
    from INIT_Q): ``(make, run)``, ``make()`` giving its tick and carry
    (``make_mpc_tick``, ``make_tracking_tick``), ``run(n)`` the loop's
    ``n`` ticks."""
    from .mpc import run_mpc, run_tracking_mpc
    from .mpc.point_to_goal import make_mpc_tick
    from .mpc.tracking import make_tracking_tick

    model, x0 = indy7(torch.float32, dev), torch.zeros(12, dtype=torch.float32, device=dev)
    if loop == "run_mpc":
        ee0 = torch.stack(LR.ee_pos(LR.static_model(model), list(x0[:6]))).cpu().numpy()
        goals = np.stack([ee0 + [0.10, -0.10, -0.10], ee0 + [-0.15, 0.05, -0.20],
                          ee0 + [0.05, 0.15, -0.05]])
        args = (model, CostConfig(), SQPConfig(max_iters=3), MPCConfig(N=32, dt=DT), x0, goals)
        return lambda: make_mpc_tick(*args), lambda n: run_mpc(*args, n)
    x0[:6] = torch.tensor(INIT_Q)
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=2), 200)
    args = (model, CostConfig(), SQPConfig(max_iters=2), MPCConfig(N=32, dt=DT), x0, ref)
    return lambda: make_tracking_tick(*args), lambda n: run_tracking_mpc(*args, n)


def single_lane_modes(dev, loop, ticks=100):
    """``run_mpc``'s or ``run_tracking_mpc``'s tick (:func:`single_lane_loop`),
    eager and graphed (on ``mpc.graphed.TickRunner``, as the loop runs it),
    in turns (:func:`modes_in_turns`)."""
    from .mpc.graphed import TickRunner

    tick, carry = single_lane_loop(dev, loop)[0]()
    runner = TickRunner(tick, carry, ticks)
    return modes_in_turns(f"{loop} tick B=1 N=32", ticks, {
        "eager": eager_loop(tick, carry, ticks), "graphed": lambda: runner.run(ticks)})


def modes_in_turns(label, ticks, modes):
    """``modes`` (name -> a run of ``ticks`` ticks, eager and graphed), each
    run once as a warm-up (the graphed one captures), then in turns
    (eager, graphed, graphed, eager): µs a tick by CUDA events (no device
    sleep: the host's launch path is in it) and by the host clock; then
    one more run of each under the profiler: host-side launches, device
    kernels and copies, and device µs a tick, and the busy share (device
    µs over the CUDA-event µs)."""
    for fn in modes.values():
        fn()
    out = {name: {"event_us": [], "host_us": []} for name in modes}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for name in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        modes[name]()
        end.record()
        torch.cuda.synchronize()
        out[name]["host_us"].append((time.perf_counter() - t0) * 1e6 / ticks)
        out[name]["event_us"].append(start.elapsed_time(end) * 1e3 / ticks)
    for name, fn in modes.items():
        o = out[name]
        o["us_per_tick"] = float(np.mean(o["event_us"]))
        host, kernels, device_ms = launch_work(fn)
        o.update(host_launches_per_tick=host / ticks, device_launches_per_tick=kernels / ticks,
                 device_us_per_tick=device_ms * 1e3 / ticks,
                 busy_share=device_ms * 1e3 / ticks / o["us_per_tick"] if kernels else None)
    print(f"{label}, {ticks} ticks a run: " + "; ".join(
        f"{name} {o['us_per_tick']:.1f} us/tick (CUDA events, runs "
        + "/".join(f"{v:.1f}" for v in o["event_us"]) + "; host clock "
        + "/".join(f"{v:.1f}" for v in o["host_us"])
        + f"), {o['host_launches_per_tick']:.2f} host-side launches and "
        f"{o['device_launches_per_tick']:.2f} device kernels and copies a tick, "
        f"{o['device_us_per_tick']:.1f} us device time, busy "
        + ("not measured" if o["busy_share"] is None else f"{100 * o['busy_share']:.1f}%")
        for name, o in out.items()), flush=True)
    return out


def tick_timing(dev, lanes=(64, 256, 1024)):
    """:func:`loop_modes` at each B of ``lanes``."""
    return {str(B): loop_modes(dev, B) for B in lanes}


def profile_device(run, n):
    """Device time per kernel over ``run(n)`` under ``torch.profiler``; the
    device time over the window's wall time is the busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.self_device_time_total / 1e3 / n, evt.count / n)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"profiled_ticks": n, "prof_wall_ms_per_tick": wall_ms / n,
            "device_ms_per_tick": busy_ms, "busy_share": busy_ms * n / wall_ms,
            "kernels_ms_per_tick": [{"name": k, "ms": ms, "launches_per_tick": c}
                                    for k, (ms, c) in top],
            "kernel_launches_per_tick": sum(c for _, c in kernels.values())}


def _profile_line(prof):
    lines = [f"profiler: {prof['device_ms_per_tick']:.4f} ms device time in "
             f"{prof['prof_wall_ms_per_tick']:.4f} ms wall per tick, busy "
             f"{100 * prof['busy_share']:.2f}%, "
             f"{prof['kernel_launches_per_tick']:g} launches per tick"]
    for k in prof["kernels_ms_per_tick"][:8]:
        lines.append(f"  {k['ms']:.4f} ms/tick  x{k['launches_per_tick']:g}  {k['name'][:100]}")
    return "\n".join(lines)


def readable_section(dev, reps=3):
    """The readable tick at the fig-8 configuration, whole and by part."""
    from .mpc import make_loop_tick
    from .mpc.fused_tick import reference_window
    from .mpc.readable_tick import readable_consensus
    from .ops import kkt, riccati
    from .sim.plant import plant_friction
    from .sim.readable_plant import plant_step
    from .solvers import sqp as readable

    B, N = 64, 64
    cost, sqp = CostConfig(), SQPConfig(max_iters=2)
    model = indy7(torch.float32, dev)
    mpc_cfg, sample_cfg = MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B)
    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=1), 200)
    gen = torch.Generator(device=dev).manual_seed(42)
    tick = make_loop_tick(model, cost, sqp, mpc_cfg, sample_cfg,
                          torch.as_tensor(ref, dtype=torch.float32, device=dev),
                          plant_cfg=PERTURBED_PLANT, fused=False, generator=gen)
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    c = init_loop_carry(model, mpc_cfg, sample_cfg, x0, F_TRUE0, gen)
    for _ in range(2):
        c, _ = tick(c)
    (m,) = tick.sampled.models(torch.float32)
    (plant,) = tick.plant.models(torch.float32)
    goals = reference_window(tick.ref_traj, c.ref_offset, N)
    lanes = lambda t: t[None].expand((B,) + t.shape)
    X_b, U_b, g_b = lanes(torch.cat([c.x[None], c.X_best[1:]])), lanes(c.U_best), lanes(goals)
    blocks = kkt.build_qp_gn(m, cost, X_b, U_b, g_b, DT, wrench_world=c.f_batch)
    sol = riccati.solve(blocks, torch.zeros_like(X_b[:, 0]), torch.full((B,), sqp.rho, device=dev))
    alf = torch.tensor([0.5 ** i for i in range(8)] + [0.0], device=dev)[:, None, None, None]
    noise = PERTURBED_PLANT.torque_noise_std * torch.randn(
        (PERTURBED_PLANT.substeps, 6), generator=gen, device=dev)
    parts = {
        "tick": lambda: tick(c),
        "batch_solve": lambda: readable.batch_solve(
            m, cost, sqp, DT, X_b[:, 0], g_b, X_b, U_b, wrench_world_batch=c.f_batch),
        "build_qp_gn": lambda: kkt.build_qp_gn(m, cost, X_b, U_b, g_b, DT,
                                               wrench_world=c.f_batch),
        "riccati": lambda: riccati.solve(blocks, torch.zeros_like(X_b[:, 0]),
                                         torch.full((B,), sqp.rho, device=dev)),
        "merit_9_candidates": lambda: readable.merit(
            m, cost, sqp.merit_mu, X_b + alf * sol.X, U_b + alf * sol.U, g_b, X_b[:, 0], DT,
            c.f_batch),
        "consensus": lambda: readable_consensus(m, c.x_last, c.u_last, c.x, DT, c.f_batch),
        "plant_step": lambda: plant_step(
            plant, c.x, c.u_last, DT, wrench_world=c.f_true,
            substeps=PERTURBED_PLANT.substeps, friction=plant_friction(PERTURBED_PLANT),
            noise=noise),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        prof = profile_device(lambda n: [fn() for _ in range(n)], 1)
        out[name] = {"host_ms": host_ms, "device_ms": prof["device_ms_per_tick"],
                     "launches": prof["kernel_launches_per_tick"],
                     "busy_share": prof["busy_share"]}
        print(f"readable {name}: {host_ms:.1f} ms (host clock), {prof['device_ms_per_tick']:.2f} "
              f"ms device time, {prof['kernel_launches_per_tick']:g} kernel launches, busy "
              f"{100 * prof['busy_share']:.1f}% under the profiler", flush=True)
    return out


# The CUDA API calls (runtime ``cuda*`` and low-level ``cu*``) by which the
# host puts work on a stream; a graph replay is one ``cudaGraphLaunch``
# whatever the graph holds.
HOST_LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemcpy",
    "cudaMemsetAsync", "cudaMemset",
})


def launch_work(fn):
    """One call of ``fn`` under ``torch.profiler``: (its host-side launches,
    the calls of :data:`HOST_LAUNCH_CALLS` the profiler records; its device
    kernels and copies; their device ms), from the raw events (aggregating
    them with ``key_averages`` takes over a minute at 77k events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    host = sum(e.device_type() == torch.autograd.DeviceType.CPU and e.name() in HOST_LAUNCH_CALLS
               for e in events)
    return host, len(on_device), sum(e.duration_ns() for e in on_device) / 1e6


def call_costs(fn, reps=3):
    """One call of ``fn`` on the card, costed: host-clock ms and CUDA-event
    ms from its first launch to its last, and its host syncs (each
    synchronizing CUDA operation warns under ``set_sync_debug_mode``),
    means over ``reps`` calls after a warm-up (no device sleep: run
    eagerly, PCG and ADMM read the host inside a call); the device kernels and
    device ms of one more call (:func:`launch_work`).
    Returns (dict, the warm-up call's result)."""
    import warnings

    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    event_ms = start.elapsed_time(end) / reps
    syncs = sum("synchronizing" in str(w.message) for w in caught) / reps
    _, kernels, device_ms = launch_work(fn)
    return {"host_ms": host_ms, "event_ms": event_ms, "syncs": syncs, "kernels": kernels,
            "device_ms": device_ms, "busy_share": device_ms / host_ms}, out


def qp_blocks(dev, B, N, seed=0, dtype=torch.float32):
    """Random well-posed QP blocks at B lanes and N knots, like
    tools/profile_pscan.py's, with xs and rho; all on ``dev``."""
    from .ops.kkt import QPBlocks

    rng = np.random.default_rng(seed)
    nx, nu = 12, 6
    Qh = rng.normal(size=(B, N, nx, nx)) * 0.1
    Rh = rng.normal(size=(B, N - 1, nu, nu)) * 0.1
    arrays = (rng.normal(size=(B, N - 1, nx, nx)) * 0.1 + np.eye(nx),
              rng.normal(size=(B, N - 1, nx, nu)) * 0.1,
              rng.normal(size=(B, N - 1, nx)) * 0.01,
              Qh @ Qh.swapaxes(-1, -2) + 0.1 * np.eye(nx),
              rng.normal(size=(B, N, nx)) * 0.1,
              Rh @ Rh.swapaxes(-1, -2) + 0.5 * np.eye(nu),
              rng.normal(size=(B, N - 1, nu)) * 0.1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return (QPBlocks(*map(t, arrays)), t(rng.normal(size=(B, nx)) * 0.1),
            torch.full((B,), 1e-6, dtype=dtype, device=dev))


def qp_section(dev, B=64, N=64):
    """The QP step alone on each readable backend, same blocks."""
    from .ops import admm, pcg, riccati, riccati_pscan

    blocks, xs, rho = qp_blocks(dev, B, N)
    sqp = SQPConfig()
    steps = {
        "riccati": lambda: riccati.solve(blocks, xs, rho),
        "riccati_pscan": lambda: riccati_pscan.solve_pscan(blocks, xs, rho),
        "pcg": lambda: pcg.solve(blocks, xs, rho, primal_reg=sqp.pcg_primal_reg,
                                 tol=sqp.pcg_tol, max_iters=sqp.pcg_max_iters),
        "admm": lambda: admm.solve(blocks, xs, rho, sigma=sqp.admm_sigma, rho_admm=sqp.admm_rho,
                                   alpha=sqp.admm_alpha, eps_abs=sqp.admm_eps,
                                   eps_rel=sqp.admm_eps, max_iters=sqp.admm_max_iters),
    }
    out = {}
    for name, fn in steps.items():
        cost, sol = call_costs(fn)
        its = getattr(sol, "iterations", None)
        if its is not None:
            its = its.cpu().numpy()
            cost["iterations"] = {"min": int(its.min()), "p50": float(np.median(its)),
                                  "max": int(its.max())}
        out[name] = cost
        print(f"QP step {name} B={B} N={N} float32: {cost['event_ms']:.2f} ms (CUDA events), "
              f"{cost['host_ms']:.2f} ms (host clock); {cost['kernels']:g} device kernels, "
              f"{cost['device_ms']:.3f} ms device time, {cost['syncs']} host syncs a call"
              + ("" if its is None else
                 f"; iterations min {its.min()}, p50 {np.median(its):g}, max {its.max()}"),
              flush=True)
    return out


def runtime_controller(dev, B=64, N=64, cost_cfg=None):
    """The controller of the host-dispatch goldens (examples/record_runs.py:
    B=64, N=64, 2 SQP iterations, fig-8 of 10 cycles after 200 rows of
    padding, true wrench [-60, 20, -40] N; tools/latency_decomp.py's) on
    ``dev``, at B lanes and horizon N (``cost_cfg`` in place of the
    default cost, e.g. the "reference" formulation, which K1 does not
    cover); constructing it runs the warm-up tick."""
    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=10), 200)
    return SampledController(
        indy7(torch.float32), cost_cfg or CostConfig(), SQPConfig(max_iters=2),
        MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B, f_ext_std=20.0,
                                            f_ext_resample_std=1.0),
        ref, f_ext_actual=F_TRUE0[:3], device=dev,
    )


def controller_timing(dev, warm=10, steady=50, cost_cfg=None, N=64):
    """The controller tick without a plant (the same host state every
    tick), graphed (``SampledController.on_state``: its own host-clock
    ``solve_time_us``) and eager (the controller's ``ControllerTick`` called
    on the same state buffers, from the state's upload to the fetch, as
    ``on_state`` ran before its graph), in turns, one tick of each after
    the other; p50/p95 over ``steady`` ticks of each after ``warm``, and
    one tick of each under the profiler (host-side launches, device
    kernels and copies, device µs).  ``cost_cfg``: the controller's cost,
    ``N`` its horizon (:func:`runtime_controller`)."""
    ctl = runtime_controller(dev, N=N, cost_cfg=cost_cfg)
    x = np.zeros(12, np.float32)
    x[:6] = INIT_Q

    def graphed():
        return ctl.on_state(x, DT)[1]["solve_time_us"]

    def eager():
        t0 = time.perf_counter()
        xd = torch.as_tensor(x).to(dev)
        x_last = ctl.x_last if ctl.x_last is not None else xd
        _, host = ctl._tick(int(ctl.ref_offset), xd, x_last, ctl.u_last, ctl.X_best,
                            ctl.U_best, ctl.f_batch)
        host.cpu()
        return (time.perf_counter() - t0) * 1e6

    modes = {"graphed": graphed, "eager": eager}
    times = {name: [] for name in modes}
    for i in range(warm + steady):
        for name, fn in modes.items():
            us = fn()
            if i >= warm:
                times[name].append(us)
    out = {}
    for name, fn in modes.items():
        us = np.asarray(times[name])
        host, kernels, device_ms = launch_work(fn)
        out[name] = {"solve_time_us_p50": float(np.percentile(us, 50)),
                     "solve_time_us_p95": float(np.percentile(us, 95)),
                     "host_launches": host, "device_launches": kernels,
                     "device_us": device_ms * 1e3}
    print(f"controller tick ({type(ctl._tick.sampled).__name__}) B=64 N={N}, {steady} ticks of "
          "each in turns: " + "; ".join(
        f"{name} p50 {o['solve_time_us_p50']:.1f} us, p95 {o['solve_time_us_p95']:.1f} us, "
        f"{o['host_launches']} host-side launches, {o['device_launches']} device kernels and "
        f"copies, {o['device_us']:.1f} us device time" for name, o in out.items()), flush=True)
    return out


def runtime_run(dev, out_dir, ticks=3500):
    t0 = time.perf_counter()
    ctl = runtime_controller(dev)
    init_s = time.perf_counter() - t0
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    plant = InProcessPlant(indy7(torch.float32), x0, DT, plant_cfg=PERTURBED_PLANT)
    run_dir = os.path.join(out_dir, "perturbed_b64")
    rec = RunRecorder(out_dir=run_dir, save_interval=1e9)
    t0 = time.perf_counter()
    rec = run_control_loop(ctl, plant, duration=1e9, rate_hz=100.0, recorder=rec,
                           walk_disturbance=True, realtime=False, max_ticks=ticks)
    wall = time.perf_counter() - t0
    stem = rec.save()
    st, te = rec._fetch("solve_times"), rec._fetch("tracking_errors")
    result = {"ticks": int(te.shape[0]), "stem": stem, "init_s": init_s, "wall_s": wall,
              "finite": bool(np.isfinite(te).all()), **rec.summary()}
    print(json.dumps(result), flush=True)
    table = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "analyze_stats.py"), run_dir,
         str(ROOT / "stats_tpu" / "perturbed_b64")],
        capture_output=True, text=True, timeout=600,
    )
    print(table.stdout + table.stderr, flush=True)
    result["analyze_stats"] = table.stdout
    return result


def ptxas_lines(log, kernel):
    """ptxas's lines (registers, stack frame and spills) for the kernel
    entries whose mangled name contains ``kernel``."""
    out, take = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            take = kernel in line
        if take and any(k in line for k in ("registers", "spill", "stack frame", "Compiling")):
            out.append(line.strip())
    return out


def ptxas_figures(lines):
    """{entry's mangled name: (registers, stack frame bytes, spill store
    bytes, spill load bytes)} from ptxas lines such as ``ptxas_lines``'."""
    import re

    out, name = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            name = m.group(1) or m.group(2)
            out.setdefault(name, [0, 0, 0, 0])
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name][1:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


# K2's three calls: (lanes, plant step run).  The device loop's call runs
# at each B of K2_SWEEP too.
K2_CALLS = {"device_loop": (64, True), "consensus": (64, False), "plant_step": (1, True)}
K2_SWEEP = (64, 256, 1024, 4096)


def k2_times(reps, dt, init_q, f_true, sweep, **launch):
    """ms per launch of K2 through the ``tick_epilogue`` wrapper of the
    ``indy7_mpc_tpu_torch`` package on ``sys.path``, keyed as K2_CALLS
    and ``device_loop_B<B>`` for B in ``sweep``; ``launch`` goes to each
    call (``threads=``).  The inputs are chip_smoke.py phase 4's: the
    device loop's call on the perturbed plant with its noise, the
    controller's consensus (``consensus_args``, the plant skipped where
    the wrapper takes ``plant``), the in-process plant's step at B=1
    (``kernel_plant_args``).  It imports by absolute name and calls only
    the wrappers' public API, so ``_k2_times_at`` runs its source against
    another checkout's package."""
    import inspect

    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import PERTURBED_PLANT as cfg, SampleConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc.fused_tick import consensus_args
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue
    from indy7_mpc_tpu_torch.sim.kernel_plant import kernel_plant_args
    from indy7_mpc_tpu_torch.sim.plant import perturb_model

    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    model = indy7(torch.float32, dev)
    smc, smp = LR.static_model(model), LR.static_model(perturb_model(model, cfg))

    def inputs(B):  # (x_cur, x_last, u_last, f_batch (6, B), U0 (6, B), f_true, noise)
        rng = np.random.default_rng(2)
        x_cur = np.r_[init_q, 0.1 * np.ones(6)]
        f_batch = rng.normal(size=(6, B)) * SampleConfig().f_ext_std
        f_batch[3:] = 0.0
        f_batch[:, 0] = 0.0
        return (f32(x_cur), f32(x_cur + 0.01 * rng.normal(size=12)),
                f32(5.0 * rng.normal(size=6)), f32(f_batch), f32(3.0 * rng.normal(size=(6, B))),
                f32(f_true), f32(cfg.torque_noise_std * rng.normal(size=(cfg.substeps, 6))))

    skip = {"plant": False} if "plant" in inspect.signature(tick_epilogue).parameters else {}
    a64, a1 = inputs(64), inputs(1)
    calls = {"device_loop": ((smc, smp, cfg), a64, {}),
             "consensus": ((smc, smc, None), consensus_args(*a64[:5]), skip),
             "plant_step": ((smc, smp, cfg), kernel_plant_args(a1[0], a1[2], a1[5], a1[6]), {})}
    calls.update({f"device_loop_B{B}": ((smc, smp, cfg), inputs(B), {}) for B in sweep})
    return {name: _events_ms(lambda: tick_epilogue(*m, dt, *a, **kw, **launch), reps)
            for name, (m, a, kw) in calls.items()}


def _k2_times_at(root, reps):
    """``k2_times`` run in a subprocess against the checkout at ``root``,
    whose kernels it builds there from its own sources: (times, ptxas
    lines of its ``tick_kernel``)."""
    code = "\n".join([
        "import json, torch", f"SLEEP_CYCLES = {SLEEP_CYCLES}",
        inspect.getsource(queued_events), inspect.getsource(_events_ms),
        inspect.getsource(ptxas_lines),
        inspect.getsource(k2_times),
        "from indy7_mpc_tpu_torch.ops.kernels import _build",
        f"t = k2_times({reps}, {DT!r}, {INIT_Q!r}, {F_TRUE0!r}, {K2_SWEEP!r})",
        "print(json.dumps([t, ptxas_lines(_build.build_log(), 'tick_kernel')]))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"K2 of {root} failed: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def k2_section(baseline=None, reps=50):
    """K2's timings (see module doc); ``baseline`` a checkout directory."""
    _build.load_library()
    out = {"ptxas": ptxas_lines(_build.build_log(), "tick_kernel"), "threads": K2.THREADS}
    for line in out["ptxas"]:
        print(f"K2 ptxas: {line}", flush=True)
    this = lambda threads: k2_times(reps, DT, INIT_Q, F_TRUE0, K2_SWEEP, threads=threads)
    runs = {f"ms_{K2.THREADS}": [], "ms_256": [], "baseline_ms": []}
    for key in ("baseline_ms", f"ms_{K2.THREADS}", "ms_256", "ms_256", f"ms_{K2.THREADS}",
                "baseline_ms"):
        if key == "baseline_ms":
            if baseline:
                times, out["baseline_ptxas"] = _k2_times_at(baseline, reps)
                runs[key].append(times)
        else:
            runs[key].append(this(int(key[3:])))
    for line in out.get("baseline_ptxas", []):
        print(f"K2 baseline ptxas: {line}", flush=True)
    cfg = PERTURBED_PLANT
    friction = bool(cfg.viscous_friction or cfg.coulomb_friction)
    out["calls"] = []
    for name, (B, plant) in [*K2_CALLS.items(),
                             *((f"device_loop_B{B}", (B, True)) for B in K2_SWEEP)]:
        substeps = cfg.substeps if plant else 0
        flops, nbytes = k2_work(B, substeps, friction, plant, cfg.velocity_saturation)
        bound, by = bound_ms(flops, nbytes)
        row = {"call": name, "B": B, "plant": plant, "flops": flops, "bytes": nbytes,
               "bound_us": bound * 1e3, "bound_by": by, "fd_chain": 4 * (1 + substeps),
               **{key: [t[name] for t in ts] for key, ts in runs.items() if ts}}
        out["calls"].append(row)
        print(f"K2 {name} B={B}: " + "; ".join(
            f"{key} {', '.join(f'{v:.4f}' for v in row[key])}" for key in runs if key in row)
            + f"; {flops} flop, bound {bound * 1e3:.4f} us ({by}); chain of "
            f"{row['fd_chain']} forward-dynamics calls", flush=True)
    return out


UDP_PORTS = (7621, 7620)  # plant, controller
UDP_RUNS = [(4, 0.0), (4, 0.023), (1, 0.0)]  # (--realtime-scale, command hold s)
PHYS_DT, SUBSTEPS = DT / 5, 5  # plant_node's physics step and steps a period


class _TimedTransport:
    """A UdpTransport that logs when each state is read (wall clock, with
    the plant's sim time) and each command is sent, holding every command
    ``hold_s`` first: a slower controller tick."""

    def __init__(self, inner, hold_s):
        self.inner, self.hold_s, self.reads, self.sends = inner, hold_s, [], []

    def recv_state(self):
        state = self.inner.recv_state()
        if state is not None:
            self.reads.append((time.time(), state.sim_time))
        return state

    def send_command(self, u):
        if self.hold_s:
            time.sleep(self.hold_s)
        self.inner.send_command(u)
        self.sends.append(time.time())

    def send_wrench(self, w):
        self.inner.send_wrench(w)


def udp_run(dev, scale, hold_s, ticks=300):
    """One UDP run (see module doc).  The plant publishes the state of sim
    time T at its start + T * scale of wall clock; the start is taken as
    the least (read - T * scale) over the run."""
    from .sim import native

    ctl = runtime_controller(dev)
    plant_port, ctl_port = UDP_PORTS
    proc = subprocess.Popen(
        [native.plant_node_path(), str(PHYS_DT), str(SUBSTEPS), "--perturb", "0.04", "7",
         "--friction", "0.05", "0.1", "--noise", "0.1", "--realtime-scale", str(scale),
         "--ports", str(plant_port), str(ctl_port)],
        stdout=subprocess.DEVNULL,
    )
    transport = None
    try:
        transport = UdpTransport(plant_addr=("127.0.0.1", plant_port),
                                 listen_addr=("127.0.0.1", ctl_port))
        transport.wait_for_state(timeout=30.0)
        timed = _TimedTransport(transport, hold_s)
        rec = run_control_loop(ctl, timed, duration=600, rate_hz=100.0 / scale,
                               recorder=RunRecorder(save_interval=1e9),
                               walk_disturbance=True, realtime=True, max_ticks=ticks)
    finally:
        if transport is not None:
            transport.close()
        proc.kill()
        proc.wait()
    read, sim_t = np.asarray(timed.reads).T
    pub = sim_t * scale
    start = (read - pub).min()
    lag_ms = (np.asarray(timed.sends) - pub - start) * 1e3
    stale = np.minimum(SUBSTEPS, np.floor(lag_ms / (PHYS_DT * scale * 1e3))).astype(int)
    f = {k: rec._fetch(k) for k in ("f_est", "f_true", "tracking_errors", "solve_times")}
    f_err = np.linalg.norm(f["f_est"][:, :3] - f["f_true"][:, :3], axis=1)
    # Tick k+1's consensus judges the period that tick k's command drove.
    by_stale = {int(n): {"ticks": int((stale[:-1] == n).sum()),
                         "f_err_p50": float(np.percentile(f_err[1:][stale[:-1] == n], 50))}
                for n in np.unique(stale[:-1])}
    out = {"scale": scale, "hold_ms": hold_s * 1e3, "ticks": len(f_err),
           "tick_us_p50": float(np.percentile(f["solve_times"], 50)),
           "read_lag_ms_p50": float(np.percentile((read - pub - start) * 1e3, 50)),
           "lag_ms_p50": float(np.percentile(lag_ms, 50)),
           "f_err_p50": float(np.percentile(f_err, 50)),
           "f_err_p95": float(np.percentile(f_err, 95)),
           "tracking_mean": float(f["tracking_errors"].mean()), "by_stale_steps": by_stale}
    print(f"UDP scale {scale}, command held {hold_s * 1e3:.0f} ms: {len(f_err)} ticks, tick p50 "
          f"{out['tick_us_p50']:.0f} us; state read {out['read_lag_ms_p50']:.2f} ms and command "
          f"sent {out['lag_ms_p50']:.2f} ms after its publication (p50); wrench error p50 "
          f"{out['f_err_p50']:.2f} N, p95 {out['f_err_p95']:.2f} N; tracking mean "
          f"{out['tracking_mean']:.4f} m; wrench error p50 by the steps of the period run on "
          "the previous command: " + ", ".join(
              f"{n}: {v['f_err_p50']:.1f} N ({v['ticks']} ticks)" for n, v in by_stale.items()),
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--runtime", action="store_true",
                    help="record the 3,500-tick host-dispatch run instead")
    ap.add_argument("--stats-dir", default=str(ROOT / "build" / "stats_torch"),
                    help="where --runtime writes its .npy recording")
    ap.add_argument("--udp", action="store_true",
                    help="run the controller over UDP at each of UDP_RUNS instead")
    ap.add_argument("--k2", action="store_true", help="run only K2's section")
    ap.add_argument("--baseline", help="a checkout whose K2 K2's section times too, in turns")
    ap.add_argument("--readable", action="store_true",
                    help="take the readable tick apart instead")
    ap.add_argument("--qp", action="store_true",
                    help="time the QP step alone on each readable backend instead")
    ap.add_argument("--loops", action="store_true",
                    help="time the single-lane and readable loops, eager and graphed, instead")
    ap.add_argument("--horizon", action="store_true",
                    help="time K1 past one block (K1_HORIZONS), the B=64 loop and the "
                    "controller tick at N=256, instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    if args.runtime:
        result["runtime"] = runtime_run(dev, args.stats_dir)
    elif args.udp:
        result["udp"] = [udp_run(dev, scale, hold) for scale, hold in UDP_RUNS for _ in range(2)]
    elif args.k2:
        result["k2"] = k2_section(args.baseline)
    elif args.readable:
        result["readable"] = readable_section(dev)
    elif args.qp:
        result["qp"] = qp_section(dev)
    elif args.horizon:
        result["horizon"] = {
            "k1": k1_sweep(dev, card, sweep=K1_HORIZONS),
            "loop_n256": loop_modes(dev, 64, 100, N=256),
            "controller_n256": controller_timing(dev, N=256),
        }
    elif args.loops:
        result["loops"] = {
            **{loop: single_lane_modes(dev, loop) for loop in ("run_mpc", "run_tracking_mpc")},
            **{f"readable_{be}": readable_loop_modes(dev, qp_backend=be)
               for be in ("riccati", "pcg")},
            "readable_controller": controller_timing(
                dev, warm=1, steady=5, cost_cfg=CostConfig(formulation="reference")),
        }
    else:
        print(f"K1: {K1.THREADS} threads a block by default, "
              f"{K1.shared_bytes(64)} bytes of shared memory at N=64; a cluster of blocks a "
              f"lane past N={K1.MAX_SEGMENT} (N <= {K1.MAX_N})", flush=True)
        result.update(k1=k1_sweep(dev, card), k1_variants=k1_variants(dev), tick=tick_timing(dev),
                      controller=controller_timing(dev), k2=k2_section(args.baseline))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
