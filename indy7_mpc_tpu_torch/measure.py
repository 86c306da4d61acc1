"""Time the port's kernels and closed-loop tick on one CUDA card.

Usage: python3 -m indy7_mpc_tpu_torch.measure [--out PATH]

It prints, and writes as JSON to ``--out``:
  * the card's name and power limit (nvidia-smi);
  * kernel K1 (``sqp_solve``) alone: CUDA-event ms per launch and
    lane-solves/s over a sweep of lane counts B, horizons N and SQP
    iteration counts, on random inputs like tests/test_pallas_kernel.py;
  * the closed-loop tick at the fig-8 configuration (B=64, N=64, 2 SQP
    iterations, perturbed plant): ms per tick by CUDA events and by the
    host clock over steady ticks, then a ``torch.profiler`` window whose
    device time per kernel, divided by the window's wall time, gives the
    device's busy share.

It checks nothing; ``chip_smoke.py`` is the correctness run.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .config import PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig
from .models import indy7
from .mpc import init_loop_carry, make_fused_loop_tick, reference
from .ops import lane_rbd as LR
from .ops.kernels.sqp_kernel import sqp_solve

DT = 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
# (B, N, SQP iterations); the first is repeated last to show drift.
K1_SWEEP = [(64, 64, 2), (64, 64, 1), (64, 32, 2), (256, 64, 2),
            (1024, 64, 2), (4096, 64, 2), (64, 64, 2)]


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


def k1_sweep(dev, reps=10):
    sm = LR.static_model(indy7(torch.float32, dev))
    cost, rows = CostConfig(), []
    for B, N, iters in K1_SWEEP:
        rng = np.random.default_rng(11)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
        w = rng.normal(size=(6, B)) * 8
        w[3:] = 0.0
        w = f32(w)
        args = (f32(rng.normal(size=(12, B)) * 0.05), f32(rng.normal(size=(N, 3, B)) * 0.3),
                f32(rng.normal(size=(N, 12, B)) * 0.05), f32(rng.normal(size=(N - 1, 6, B)) * 0.5))
        sqp = SQPConfig(max_iters=iters)
        ms = _events_ms(lambda: sqp_solve(sm, cost, sqp, DT, *args, wrench=w), reps)
        rows.append({"B": B, "N": N, "iters": iters, "ms": ms,
                     "lane_solves_per_s": B / (ms * 1e-3)})
        print(f"K1 B={B} N={N} iters={iters}: {ms:.4f} ms/launch, "
              f"{B / (ms * 1e-3):.1f} lane-solves/s", flush=True)
    return rows


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

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(profiled)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.self_device_time_total / 1e3 / profiled, evt.count / profiled)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    print(f"tick B={B} N={N} perturbed: {event_ms:.4f} ms/tick (CUDA events, {steady} ticks), "
          f"{host_ms:.4f} ms/tick (host clock); profiler: {busy_ms:.4f} ms device time "
          f"in {wall_ms / profiled:.4f} ms wall per tick, busy {100 * busy_ms * profiled / wall_ms:.2f}%",
          flush=True)
    for name, (ms, count) in top[:8]:
        print(f"  {ms:.4f} ms/tick  x{count:g}  {name[:100]}", flush=True)
    return {"event_ms_per_tick": event_ms, "host_ms_per_tick": host_ms,
            "profiled_ticks": profiled, "prof_wall_ms_per_tick": wall_ms / profiled,
            "device_ms_per_tick": busy_ms, "busy_share": busy_ms * profiled / wall_ms,
            "kernels_ms_per_tick": [{"name": k, "ms": ms, "launches_per_tick": c}
                                    for k, (ms, c) in top],
            "kernel_launches_per_tick": sum(c for _, c in kernels.values())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
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
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "k1": k1_sweep(dev), "tick": tick_timing(dev)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
