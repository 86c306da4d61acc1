"""The host-driven controller at the plant's rate, an open loop.

``SampledController`` (its tick captured as a CUDA graph at construction;
``on_state`` copies the state in, replays the graph and fetches the packed
command) answers ``InProcessPlant`` (the perturbed plant, K2 at B=1 on the
card), as ``run_control_loop`` wires them without the wall clock: the
reference advances one row a period, the command goes back through
``send_command`` and the true wrench walks as the loop walks it.  A state
is due every ``1 / rate_hz`` seconds on a fixed schedule; the harness
sleeps until ``spin_s`` before it and spins to it.  Each tick's latency
runs from its due time to the command in host memory, so a late tick also
delays the ones after it.  A tick whose command comes after the period, or
is not finite, has failed.

The controller's state is copied (after the command, outside the
latency) around ``check_ticks`` ticks drawn from the seed, which go to the
comparison (``compare.ctl_gaps``) with the controller's and the plant's
draws replayed.  With tracing, ``trace_ticks`` more ticks run on the same
schedule under the profiler after the window.

Mix keys: ``rate_hz``, ``spin_s``, ``warmup_ticks``, ``check_ticks``,
``trace_ticks``.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import compare, profiling, program, timing, traffic
from .. import harness
from ..harness import Context, Run
from ..reference import tick as rt

# The plant's actuation noise seed, as an offset from --seed.
PLANT_SEED_OFFSET = 1


def _snapshot(ctl, plant) -> Dict[str, object]:
    r = ctl.runner
    return {"X_best": r.X_best.clone(), "U_best": r.U_best.clone(),
            "f_batch": r.f_batch.clone(), "x_last": r.x_last.clone(),
            "u_last": r.u_last.clone(), "x_obs": plant.x, "gen": ctl.generator.get_state()}


def _wait(due: float, spin_s: float) -> float:
    """Sleep until ``spin_s`` before ``due``, spin to it; the wake time."""
    now = time.perf_counter()
    if due - now > spin_s:
        time.sleep(due - now - spin_s)
    while time.perf_counter() < due:
        pass
    return time.perf_counter()


def run(ctx: Context) -> Run:
    from indy7_mpc_tpu_torch.runtime import InProcessPlant, SampledController

    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    period = 1.0 / mix["rate_hz"]
    s = program.setup(cfg, dev)
    ref_rows = program.reference_rows(cfg, 1)
    ctl = SampledController(s.model, s.cost, s.sqp, s.mpc, s.sample, ref_rows, seed=ctx.seed,
                            f_ext_actual=s.f_true0[:3], device=dev)
    f_start = ctl.runner.f_batch.clone()
    plant = InProcessPlant(s.model, s.x0, s.mpc.dt, plant_cfg=s.plant,
                           noise_seed=ctx.seed + PLANT_SEED_OFFSET, device=dev)
    walk_rng = np.random.default_rng(ctx.seed)
    plant.send_wrench(ctl.f_ext_actual)
    sent = [0]  # send_command calls: the plant noise's draw index

    def tick(traced: bool = False):
        """One tick; returns (command, info, t_done, wrench, plant draw,
        reference offset)."""
        with profiling.span("on_state", traced):
            u, info = ctl.on_state(plant.recv_state().x, s.mpc.dt)
            t_done = time.perf_counter()
        wrench, draw, offset = plant.wrench, sent[0], int(ctl.ref_offset)
        with profiling.span("send_command", traced):
            plant.send_command(u)
            sent[0] += 1
        w = ctl.maybe_walk_disturbance(walk_rng)
        if w is not None:
            plant.send_wrench(w)
        wrapped = traffic.wrapped_offset(cfg, int(ctl.ref_offset))
        ctl.ref_offset -= int(ctl.ref_offset) - wrapped
        return u, info, t_done, wrench, draw, offset

    for _ in range(mix["warmup_ticks"]):
        tick()
    _sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    _sync()
    n = int(round(ctx.seconds * mix["rate_hz"]))
    pick = set(compare.subsample(n - 1, mix["check_ticks"],
                                 torch.Generator().manual_seed(ctx.seed)))
    pick = {k + 1 for k in pick}  # a checked tick has a tick before it
    dues, dones, late, bad = [], [], [], 0
    pending, checks = {}, []
    card_before = harness.card_state() if dev.type == "cuda" else "cpu"
    t_first = time.perf_counter() + period
    for k in range(n):
        due = t_first + k * period
        late.append(_wait(due, mix["spin_s"]) - due)
        u, info, t_done, wrench, draw, offset = tick()
        dues.append(due)
        dones.append(t_done)
        if not (np.isfinite(u).all() and np.isfinite(info["f_est"]).all()):
            bad += 1
        if k + 1 in pick:
            pending[k + 1] = _snapshot(ctl, plant)
        if k in pending:
            pre = pending.pop(k)
            post = _snapshot(ctl, plant)
            host = np.concatenate([u, [info["best_idx"]], info["f_est"], info["ee_ref"],
                                   info["ee_pos"], [info["tracking_error"]]])
            checks.append((pre, post, host, offset, wrench, draw))
    window_s = time.perf_counter() - t_first
    card_after = harness.card_state() if dev.type == "cuda" else "cpu"
    lat_us = timing.latencies_us(dues, dones)
    misses = sum(1 for x in lat_us if x > period * 1e6)
    trace = None
    values = {"window_latencies_us": lat_us}
    if ctx.trace:
        n_tr = mix["trace_ticks"]

        def traced_ticks():
            t0 = time.perf_counter() + period
            for k in range(n_tr):
                with profiling.span("wait", True):
                    _wait(t0 + k * period, mix["spin_s"])
                tick(True)
            _sync()

        trace = profiling.traced(traced_ticks, n_tr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # ---- the check: the draws replayed, then the reference ----
    B, substeps = cfg["batch_size"], cfg["plant"]["substeps"]
    g_plant = torch.Generator(device=dev).manual_seed(ctx.seed + PLANT_SEED_OFFSET)
    plant_draws = [torch.randn((substeps, 6), generator=g_plant, device=dev).cpu()
                   for _ in range(max((c[5] for c in checks), default=-1) + 1)]
    ticks: List[compare.CtlTick] = []
    for pre, post, host, offset, wrench, draw in checks:
        g = torch.Generator(device=dev)
        g.set_state(pre["gen"])
        normals = torch.randn((B, 6), generator=g, device=dev).cpu()
        p = {k: v.cpu() for k, v in pre.items() if k not in ("gen",)}
        p["offset"] = torch.tensor(offset)
        q = {k: post[k].cpu() for k in ("X_best", "U_best", "f_batch", "x_last", "u_last")}
        ticks.append(compare.CtlTick(p, normals, q, torch.as_tensor(host), wrench.cpu(),
                                     plant_draws[draw], post["x_obs"].cpu()))
    del ctl, plant
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    models = rt.Models(rt.Deployment.from_config(cfg))
    g = torch.Generator(device=dev).manual_seed(ctx.seed)
    gaps = compare.start_gaps(models, compare.ctl_gaps(models, ref_rows, ticks), f_start,
                              torch.randn((B, 6), generator=g, device=dev))
    values.update(ticks=ticks, reference=ref_rows)
    ctx.say(f"card before the window: {card_before}; after: {card_after}")
    ctx.say(f"ctl {ctx.cell.name}: {n} ticks due every {period * 1e3:g} ms over "
            f"{window_s:.6f} s; the schedule ran late by p50 "
            f"{statistics.median(late) * 1e6:.1f} us, max {max(late) * 1e6:.1f} us; "
            f"{misses} commands after the period, {bad} not finite; latency p50 "
            f"{timing.percentile(lat_us, 50):.1f} us, p95 {timing.percentile(lat_us, 95):.1f} us, "
            f"p99 {timing.percentile(lat_us, 99):.1f} us, max {max(lat_us):.1f} us; "
            f"{len(ticks)} ticks compared in {time.perf_counter() - t_check:.1f} s")
    return Run(
        attempted=n, failed=misses + bad,
        end_to_end={"ctl_latency_p50_us": timing.percentile(lat_us, 50),
                    "setup_s": t_first - ctx.t0},
        gaps=gaps, memory_peak_bytes=peak, trace=trace, values=values,
    )
