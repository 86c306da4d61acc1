"""Closed-loop figure-8 tracking run (port of ``examples/fig8_closed_loop.py``).

The recorded-run configuration (``protocol.py``: N=64, dt=10 ms, fig-8,
true wrench [-60, 20, -40] N with its walk, B hypotheses with sigma 20 N
and resample sigma 1 N) as one device loop, ``run_sampled_mpc`` on the
two-kernel tick: B SQP solves (K1), consensus, plant and trace FK (K2),
resampling.  The loop runs twice from the same seed, the first time as
the warm-up (kernel build and first launches); the second is timed by the
host clock after a sync and recorded through ``RunRecorder`` into
``--out``.  Prints a JSON summary with the TPU script's keys (plus
``device``).

Usage: python3 -m indy7_mpc_tpu_torch.examples.fig8_closed_loop [B=16] [ticks=1000]
           [--perturbed] [--out build/stats_torch] [--device cuda|cpu]

``--perturbed`` runs the ground-truth plant with PERTURBED_PLANT (seeded
~4% inertial error, friction, actuation noise, 5 substeps).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import PERTURBED_PLANT
from ..models import indy7
from ..mpc import run_sampled_mpc
from ..runtime.stats import RunRecorder
from . import protocol
from .protocol import DT, F_TRUE0, N, REF_ROWS
from .record_runs import DEFAULT_OUT, DEFAULT_SEED


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=16)
    ap.add_argument("ticks", nargs="?", type=int, default=1000)
    ap.add_argument("--perturbed", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="where the recording goes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)
    B, ticks = args.B, args.ticks

    model = indy7(torch.float32, dev)
    cost_cfg, sqp_cfg, mpc_cfg, sample_cfg = protocol.configs(B)
    ref = protocol.fig8_reference(ticks)[: ticks + N]
    x0 = protocol.initial_state(torch.float32, dev)

    def run():
        gen = torch.Generator(device=dev).manual_seed(DEFAULT_SEED)
        out = run_sampled_mpc(model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, x0, ref, ticks,
                              F_TRUE0, gen,
                              plant_cfg=PERTURBED_PLANT if args.perturbed else None)
        protocol.synchronize(dev)
        return out

    run()  # warm-up: kernel build and first launches
    t0 = time.perf_counter()
    _, trace = run()
    wall = time.perf_counter() - t0

    te = trace.tracking_error.cpu().numpy().astype(np.float64)
    per_tick_us = wall / ticks * 1e6
    rec = RunRecorder(out_dir=args.out)
    rec.record_trace(trace, DT, per_tick_us)
    stem = rec.save()
    summary = {
        "config": f"B={B} N={N} dt={DT} ticks={ticks}",
        "tracking_error_mean": float(te.mean()),
        "tracking_error_p50": float(np.percentile(te, 50)),
        "tracking_error_p95": float(np.percentile(te, 95)),
        # The 200 padded warm-up ticks left out, like the reference's
        # fig-8 region of interest.
        "tracking_error_mean_after_warmup": float(te[200:].mean()) if ticks > 200 else None,
        "per_tick_us_incl_plant": per_tick_us,
        "realtime_ok": bool(per_tick_us < 10000),
        "stats_stem": stem,
        "reference_tracking_error_mean": {f"batch{b}": r[1][0] for b, r in REF_ROWS.items()},
        "device": protocol.device_label(dev),
    }
    print(json.dumps(summary, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
