"""BASELINE.md's comparison table on this device (port of
``examples/baseline_table.py``).

For each batch size the reference recorded (stats/{single,16,32,64}:
solve time mean/p50/p95/max and fig-8 tracking mean/p50/p95 at N=64,
dt=10 ms, true wrench [-60, 20, -40] N), run the same work here and print
both side by side:

  * the batched solve alone (``ops/kernels/sqp_kernel.py::sqp_solve``,
    the solve of ``solvers.select.default_batch_solve_fn`` with the model
    constants built once, as the controller's tick holds them: K1 on the
    card, its plain version on the CPU) from a warm start, in 4 chunks of
    ``--solve-iters`` / 4 solves; on the card each chunk is timed by CUDA
    events with its launches queued behind a device sleep (the kernel's
    time, not the host's launch path), on the CPU by the host clock;
  * the closed-loop fig-8 (``run_sampled_mpc`` on the two-kernel tick,
    nominal plant, from rest at zero), run twice from the same seed and
    the second run timed by the host clock after a sync.

Usage: python3 -m indy7_mpc_tpu_torch.examples.baseline_table [ticks=1000]
           [--json out.json] [--solve-iters 400] [--batches 1,16,32,64]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..measure import SLEEP_CYCLES
from ..models import indy7
from ..mpc import init_wrench_batch, run_sampled_mpc
from ..ops import lane_rbd as LR
from ..ops.kernels.sqp_kernel import sqp_solve
from . import protocol
from .protocol import DT, F_TRUE0, N, REF_ROWS


def _chunk_us(dev, fn, n):
    """µs per call of ``fn`` over ``n`` calls (see the module doc)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ticks", nargs="?", type=int, default=1000)
    ap.add_argument("--json", default=None)
    ap.add_argument("--solve-iters", type=int, default=400)
    ap.add_argument("--batches", default=",".join(map(str, REF_ROWS)),
                    help="batch sizes (default: the reference's, 1,16,32,64)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)
    ticks = args.ticks
    model = indy7(torch.float32, dev)
    sm = LR.static_model(model)
    ref = protocol.fig8_reference(ticks)
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    label = protocol.device_label(dev)

    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        cost_cfg, sqp_cfg, mpc_cfg, sample_cfg = protocol.configs(B)

        # The batched solve alone, the unit of the reference's solve_times,
        # lane-major from zeros, then timed from its own warm start.
        gen = torch.Generator(device=dev).manual_seed(42)
        wrench = init_wrench_batch(gen, sample_cfg, torch.float32, dev).T.contiguous()
        lanes = lambda t: t[..., None].expand(t.shape + (B,)).contiguous()
        xs = lanes(torch.zeros(12, device=dev))
        goals = lanes(torch.as_tensor(ref[:N], dtype=torch.float32, device=dev))
        X0, U0 = torch.zeros((N, 12), device=dev), torch.zeros((N - 1, 6), device=dev)
        X, U, *_ = sqp_solve(sm, cost_cfg, sqp_cfg, DT, xs, goals, lanes(X0), lanes(U0),
                             wrench=wrench)

        def solve():
            return sqp_solve(sm, cost_cfg, sqp_cfg, DT, xs, goals, X, U, wrench=wrench)

        chunk = max(args.solve_iters // 4, 1)
        times = np.asarray([_chunk_us(dev, solve, chunk) for _ in range(4)])

        # The closed-loop fig-8 under the true wrench.
        def run():
            g = torch.Generator(device=dev).manual_seed(42)
            res = run_sampled_mpc(model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, x0,
                                  ref[: ticks + N], ticks, F_TRUE0, g)
            protocol.synchronize(dev)
            return res

        run()  # warm-up
        t0 = time.perf_counter()
        _, trace = run()
        tick_us = (time.perf_counter() - t0) / ticks * 1e6
        te = trace.tracking_error.cpu().numpy().astype(np.float64)

        (r_st, r_te) = REF_ROWS.get(B, ((None,) * 4, (None,) * 3))
        rows.append({
            "B": B,
            "solve_us_mean": float(times.mean()),
            "solve_us_worst_chunk": float(times.max()),
            "closed_loop_tick_us": float(tick_us),
            "ref_solve_us_mean": r_st[0],
            "ref_solve_us_p95": r_st[2],
            "te_mean": float(te.mean()),
            "te_p50": float(np.percentile(te, 50)),
            "te_p95": float(np.percentile(te, 95)),
            "ref_te_mean": r_te[0],
            "ref_te_p50": r_te[1],
            "ref_te_p95": r_te[2],
            "solves_per_sec": B / (times.mean() / 1e6),
            "ref_solves_per_sec": None if r_st[0] is None else B / (r_st[0] / 1e6),
            "device": label,
        })
        print(f"# B={B} done", file=sys.stderr, flush=True)

    na = lambda v, spec: "n/a" if v is None else format(v, spec)
    hdr = (f"{'B':>4} | {'solve us':>8} | {'tick us':>8} | {'ref solve us':>12} | "
           f"{'te mean/p50/p95':>22} | {'ref te mean/p50/p95':>22} | {'solves/s':>9} | "
           f"{'ref':>6}")
    print(f"# {label}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        ref_te = "/".join(na(r[k], ".3f") for k in ("ref_te_mean", "ref_te_p50", "ref_te_p95"))
        print(f"{r['B']:>4} | {r['solve_us_mean']:>8.0f} | {r['closed_loop_tick_us']:>8.0f} | "
              f"{na(r['ref_solve_us_mean'], '.0f'):>12} | "
              f"{r['te_mean']:>6.3f}/{r['te_p50']:>6.3f}/{r['te_p95']:>6.3f} | {ref_te:>22} | "
              f"{r['solves_per_sec']:>9.0f} | {na(r['ref_solves_per_sec'], '.0f'):>6}",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
