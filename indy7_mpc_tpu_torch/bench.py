"""Benchmark: batched SQP-MPC solves/s on one card (port of ``bench.py``).

Usage: python3 -m indy7_mpc_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line on stdout, with ``bench.py``'s keys:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "median": N, "min": N, "max": N}

The unit of work is ``bench.py``'s: one batched solve of B=64 lanes at
horizon N (float32, ``CostConfig()``, 2 SQP iterations), each lane under
its own wrench hypothesis, warm-started from the previous solve.  Its
inputs: the state zero, every goal at [0.35, 0.35, 0.6], X and U zero,
and the hypotheses of ``init_wrench_batch`` (sigma 20 N) from a generator
seeded 42 (``measure.production_inputs``).  The solve is kernel K1 through
``solvers/sqp_cuda.py::batch_solve_fn``, whose model constants are built
once.  The headline is at N=64, the configuration of the reference's
recorded B=64 solve times (8,964 us mean, so 7,140 solves/s implied:
``vs_baseline``); the N=32 line goes to stderr.

Each measurement warms up both programs (``solve``, one solve, and the
chain, R warm-started solves queued back to back with no host sync, X and
U feeding the next and no solver state carried), then times, on the host
clock: 50 blocking solves, each followed by a sync; and 20 chains with
one sync at the end (the throughput).  On a card the warm-up chain is
also timed by CUDA events behind a device sleep, with whether the host
had queued it all before the device started (``measure.queued_events``):
stderr prints that device figure beside the host clock's, so a
host-bound chain cannot pass for device time.  Three repeats at each N;
the JSON line gives their median, min and max.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple, Optional

import torch

from . import measure as timing
from .config import CostConfig, SQPConfig
from .examples import protocol
from .models import indy7
from .solvers import sqp_cuda

REF_SOLVES_PER_SEC = 7140.0  # reference B=64/N=64 implied throughput
B, HORIZONS, REPEATS, SQP_ITERS, DT = 64, (32, 64), 3, 2, 0.01
R, DISPATCH_ITERS, CHAIN_ITERS = 10, 50, 20


class Measurement(NamedTuple):
    """One measurement at (B, N); the first two fields are ``bench.py``'s
    ``measure`` return."""

    chained_s: float  # host clock per solve over the chains
    dispatch_s: float  # host clock per blocking solve
    chain_event_s: Optional[float]  # CUDA events per solve of the warm-up chain (None: CPU)
    host_ahead: Optional[bool]  # the host queued that chain before the device began
    first: tuple  # the warm-up solve from zeros: (its inputs (xs, goals, X, U, w), its SQPResult)
    last: tuple  # the last chained solve, the same


def solver(dev, dtype=torch.float32, dt=DT):
    """``bench.py``'s ``solve``: ``(xs, goals, X, U, w) -> SQPResult`` on K1
    (its plain version for CPU tensors), the model constants built once."""
    return sqp_cuda.batch_solve_fn(indy7(dtype, dev), CostConfig(),
                                   SQPConfig(max_iters=SQP_ITERS), dt)


def chain(solve, xs, goals, X, U, w, reps=R):
    """``bench.py``'s ``solve_chain``: ``reps`` warm-started solves queued
    back to back, X and U feeding the next.  Returns the last solve's
    inputs and result."""
    for _ in range(reps):
        args = (xs, goals, X, U, w)
        res = solve(*args)
        X, U = res.X, res.U
    return args, res


def measure(B, N, dev, dt=DT, *, reps=R, dispatch_iters=DISPATCH_ITERS,
            chain_iters=CHAIN_ITERS) -> Measurement:
    """One measurement at B lanes and horizon N on ``dev``: 1 + reps +
    dispatch_iters + chain_iters * reps solves."""
    solve = solver(dev, dt=dt)
    xs, goals, X, U, w = timing.production_inputs(dev, B, N)

    # Warm up both programs: the first solve builds and loads K1.
    res = solve(xs, goals, X, U, w)
    first = ((xs, goals, X, U, w), res)
    protocol.synchronize(dev)
    if dev.type == "cuda":
        box = []
        ms, host_ahead = timing.queued_events(
            lambda: box.append(chain(solve, xs, goals, res.X, res.U, w, reps)), 1,
            warmup=False)
        event_s = ms * 1e-3 / reps
        (_, out), = box
    else:
        _, out = chain(solve, xs, goals, res.X, res.U, w, reps)
        event_s = host_ahead = None

    # Blocking single-dispatch latency: a sync after every call.
    X_w, U_w = res.X, res.U
    t0 = time.perf_counter()
    for _ in range(dispatch_iters):
        r = solve(xs, goals, X_w, U_w, w)
        X_w, U_w = r.X, r.U
        protocol.synchronize(dev)
    t_dispatch = (time.perf_counter() - t0) / dispatch_iters

    # Throughput: chained back-to-back solves, one sync at the end.
    t0 = time.perf_counter()
    for _ in range(chain_iters):
        last = chain(solve, xs, goals, out.X, out.U, w, reps)
        out = last[1]
    protocol.synchronize(dev)
    per_solve_s = (time.perf_counter() - t0) / (chain_iters * reps)
    return Measurement(per_solve_s, t_dispatch, event_s, host_ahead, first, last)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Run the bench; prints its lines and returns ``{"line": the JSON
    line, "runs": {N: [Measurement per repeat]}, "device": label}``."""
    args = build_parser().parse_args(argv)
    dev = protocol.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kind = protocol.device_label(dev)
    line, runs = None, {}
    for N in HORIZONS:
        meas = runs[N] = [measure(B, N, dev, reps=R, dispatch_iters=DISPATCH_ITERS,
                                  chain_iters=CHAIN_ITERS) for _ in range(REPEATS)]
        sps_reps = sorted(B / m.chained_s for m in meas)
        t_dispatch = min(m.dispatch_s for m in meas)
        sps = sps_reps[len(sps_reps) // 2]  # the median
        print(
            f"# B={B} N={N}: {1e6 * B / sps:.0f} us/solve chained on device (median of "
            f"{REPEATS} runs: {sps_reps[0]:,.0f}/{sps:,.0f}/{sps_reps[-1]:,.0f} solves/s), "
            f"{t_dispatch * 1e6:.0f} us blocking single-dispatch  ({SQP_ITERS} SQP iters, "
            f"{kind})",
            file=sys.stderr, flush=True,
        )
        if dev.type == "cuda":
            print(
                f"# B={B} N={N}: the chain by CUDA events "
                + ", ".join(f"{m.chain_event_s * 1e6:.1f}" for m in meas)
                + " us/solve (host ahead of the device: "
                + ", ".join("yes" if m.host_ahead else "no" for m in meas)
                + "); by the host clock "
                + ", ".join(f"{m.chained_s * 1e6:.1f}" for m in meas) + " us/solve",
                file=sys.stderr, flush=True,
            )
        if N == HORIZONS[-1]:
            line = {
                "metric": f"sqp_mpc_solves_per_sec_chip_b{B}_n{N}",
                "value": round(sps, 1),
                "unit": "solves/s",
                "vs_baseline": round(sps / REF_SOLVES_PER_SEC, 3),
                "median": round(sps, 1),
                "min": round(sps_reps[0], 1),
                "max": round(sps_reps[-1], 1),
            }
            print(json.dumps(line), flush=True)
    return {"line": line, "runs": runs, "device": kind}


if __name__ == "__main__":
    main()
