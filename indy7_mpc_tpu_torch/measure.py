"""Time the port's kernels and closed-loop tick on one CUDA card, or record
a long host-dispatch run.

Usage: python3 -m indy7_mpc_tpu_torch.measure [--out PATH] [--runtime [--stats-dir DIR] | --udp]

Without ``--runtime`` it prints, and writes as JSON to ``--out``:
  * the card's name and power limit (nvidia-smi);
  * kernel K1 (``sqp_solve``) alone: CUDA-event ms per launch and
    lane-solves/s over a sweep of lane counts B, horizons N and SQP
    iteration counts, on random inputs like tests/test_pallas_kernel.py,
    each row with its floating-point operations and bytes
    (``roofline.k1_work``: the kernel's own arithmetic), the bound they
    give on an H100 (67 TFLOP/s float32, 3.35 TB/s) and the share of that
    bound reached;
  * K1 at B=64, N=64, 2 SQP iterations at 256 and 128 threads a block, in
    turns, and cumulatively at its profiling cut, stages 1, 1-2, 1-3 and
    1-4;
  * the closed-loop tick at the fig-8 configuration (B=64, N=64, 2 SQP
    iterations, perturbed plant): ms per tick by CUDA events and by the
    host clock over steady ticks, then a ``torch.profiler`` window whose
    device time per kernel, divided by the window's wall time, gives the
    device's busy share;
  * the runtime's controller tick (``SampledController.on_state`` at the
    same sizes, without a plant): its host-clock ``solve_time_us`` and a
    profiler window.

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

It checks nothing; ``chip_smoke.py`` is the correctness run.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig
from .models import indy7
from .mpc import init_loop_carry, make_fused_loop_tick, reference
from .ops import lane_rbd as LR
from .ops.kernels import sqp_kernel as K1
from .ops.kernels.sqp_kernel import sqp_solve
from .roofline import bound_ms, k1_work
from .runtime import (
    InProcessPlant, RunRecorder, SampledController, UdpTransport, run_control_loop,
)

ROOT = Path(__file__).resolve().parents[1]
DT = 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
# (B, N, SQP iterations); the first is repeated last to show drift.
# (1, 32, 3) is the single-lane solve of run_mpc at the point-to-goal
# configuration.
K1_SWEEP = [(64, 64, 2), (64, 64, 1), (64, 32, 2), (256, 64, 2),
            (1024, 64, 2), (4096, 64, 2), (1, 32, 3), (64, 64, 2)]


def _events_ms(fn, reps):
    fn()  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def k1_sweep(dev, card, reps=20):
    sm = LR.static_model(indy7(torch.float32, dev))
    cost, rows = CostConfig(), []
    print(f"K1 sweep on {card}; bounds against the H100 SXM's published 67 TFLOP/s "
          "float32 and 3.35 TB/s (at 700 W)", flush=True)
    for B, N, iters in K1_SWEEP:
        args, w = k1_inputs(dev, B, N)
        sqp = SQPConfig(max_iters=iters)
        ms = _events_ms(lambda: sqp_solve(sm, cost, sqp, DT, *args, wrench=w), reps)
        flops, nbytes = k1_work(B, N, cost, sqp)
        bound, by = bound_ms(flops, nbytes)
        rows.append({"B": B, "N": N, "iters": iters, "ms": ms,
                     "lane_solves_per_s": B / (ms * 1e-3), "flops": flops, "bytes": nbytes,
                     "bound_us": bound * 1e3, "bound_by": by, "share_of_bound": bound / ms})
        print(f"K1 B={B} N={N} iters={iters}: {ms:.4f} ms/launch, "
              f"{B / (ms * 1e-3):.1f} lane-solves/s; {flops} flop, {nbytes} B, "
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


def tick_timing(dev, warm=20, steady=50, profiled=20):
    B, N = 64, 64
    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=1), 200)
    model = indy7(torch.float32, dev)
    mpc_cfg, sample_cfg = MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B)
    gen = torch.Generator(device=dev).manual_seed(42)
    tick = make_fused_loop_tick(
        model, CostConfig(), SQPConfig(max_iters=2), mpc_cfg, sample_cfg,
        torch.as_tensor(ref, dtype=torch.float32, device=dev),
        plant_cfg=PERTURBED_PLANT, generator=gen,
    )
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    carry = init_loop_carry(model, mpc_cfg, sample_cfg, x0, F_TRUE0, gen)

    def run(n):
        nonlocal carry
        for _ in range(n):
            carry, _ = tick(carry)

    run(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steady)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steady
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(steady)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / steady

    prof = _profile(run, profiled)
    print(f"tick B={B} N={N} perturbed: {event_ms:.4f} ms/tick (CUDA events, {steady} ticks), "
          f"{host_ms:.4f} ms/tick (host clock); {_profile_line(prof)}", flush=True)
    return {"event_ms_per_tick": event_ms, "host_ms_per_tick": host_ms, **prof}


def _profile(run, n):
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


def runtime_controller(dev):
    """The controller of the host-dispatch goldens (examples/record_runs.py:
    B=64, N=64, 2 SQP iterations, fig-8 of 10 cycles after 200 rows of
    padding, true wrench [-60, 20, -40] N) on ``dev``; constructing it runs
    the warm-up tick."""
    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=10), 200)
    return SampledController(
        indy7(torch.float32), CostConfig(), SQPConfig(max_iters=2),
        MPCConfig(N=64, dt=DT), SampleConfig(batch_size=64, f_ext_std=20.0,
                                             f_ext_resample_std=1.0),
        ref, f_ext_actual=F_TRUE0[:3], device=dev,
    )


def controller_timing(dev, warm=10, steady=50, profiled=20):
    """``SampledController.on_state`` alone (no plant: the same host state
    every tick): its own host-clock ``solve_time_us`` and a profile."""
    ctl = runtime_controller(dev)
    x = torch.zeros(12)
    x[:6] = torch.tensor(INIT_Q)
    times = []

    def run(n):
        for _ in range(n):
            times.append(ctl.on_state(x, DT)[1]["solve_time_us"])

    run(warm)
    del times[:]
    run(steady)
    us = np.asarray(times)
    prof = _profile(run, profiled)
    print(f"controller tick B=64 N=64: solve_time_us p50 {np.percentile(us, 50):.1f}, "
          f"p95 {np.percentile(us, 95):.1f} ({steady} ticks); {_profile_line(prof)}",
          flush=True)
    return {"solve_time_us_p50": float(np.percentile(us, 50)),
            "solve_time_us_p95": float(np.percentile(us, 95)), **prof}


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
    else:
        print(f"K1: {K1.THREADS} threads a block by default, "
              f"{K1.shared_bytes(64)} bytes of shared memory at N=64 (N <= {K1.MAX_N})",
              flush=True)
        result.update(k1=k1_sweep(dev, card), k1_variants=k1_variants(dev), tick=tick_timing(dev),
                      controller=controller_timing(dev))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
