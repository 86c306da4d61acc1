"""Stage table and device trace of the batched solve (port of
``tools/profile_solve.py``).

Three rows at B lanes and horizon N: the readable linearization and cost
(``ops/kkt.py::build_qp_gn`` over the lanes), the readable Riccati QP
(``ops/riccati.py::solve``), and the full solve through ``--backend``:
``cuda`` is K1 through ``solvers/sqp_cuda.py::batch_solve_fn`` (the TPU
tool's ``pallas``), ``readable`` the readable solver ``solvers/sqp.py``
(its ``vmap``).  Each row is the module call plus a sync, timed over ``--iters``
calls queued back to back after a warm-up (``measure.pipelined_ms``), and
given per call, per lane and as solves/s.  ``--trace DIR`` writes a
``torch.profiler`` Chrome trace of one full solve to
``DIR/profile_solve_trace.json``, which Perfetto opens (device kernels
included on a card).  Prints the TPU tool's lines, then one JSON line.

Usage: python3 -m indy7_mpc_tpu_torch.tools.profile_solve [B] [N]
           [--trace DIR] [--backend cuda|readable] [--iters 20]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .. import measure
from ..config import CostConfig, SQPConfig
from ..examples import protocol
from ..models import indy7
from ..ops import kkt, riccati
from ..solvers import sqp as sqp_readable
from ..solvers import sqp_cuda

DT = 0.01
TRACE_FILE = "profile_solve_trace.json"


def stage_fns(model, cost_cfg, sqp_cfg, dt, xs_b, goals_b, X_b, U_b, wrench_b, backend):
    """The table's rows: [(name, call)].  The QP row solves the blocks of
    the linearization row at rho 1e-6 (the TPU tool's)."""
    solve = (sqp_cuda if backend == "cuda" else sqp_readable).batch_solve_fn(
        model, cost_cfg, sqp_cfg, dt)

    def lin():
        return kkt.build_qp_gn(model, cost_cfg, X_b, U_b, goals_b, dt, wrench_world=wrench_b)

    blocks = lin()
    rho = torch.full((xs_b.shape[0],), 1e-6, dtype=xs_b.dtype, device=xs_b.device)
    return [
        ("linearize+cost (readable)", lin),
        ("riccati QP (readable)", lambda: riccati.solve(blocks, xs_b, rho)),
        (f"full solve ({backend})", lambda: solve(xs_b, goals_b, X_b, U_b, wrench_b)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("N", nargs="?", type=int, default=32)
    ap.add_argument("--trace", default=None, help="directory for a torch.profiler trace")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "readable"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B, N = args.B, args.N
    model = indy7(torch.float32, dev)
    stages = stage_fns(model, CostConfig(), SQPConfig(max_iters=2), DT,
                       *measure.production_inputs(dev, B, N), args.backend)

    label = protocol.device_label(dev)
    print(f"# device={label} backend={args.backend} B={B} N={N}", flush=True)
    print(f"{'stage':<28} {'per call':>12} {'per lane':>12} {'solves/s':>12}")
    rows = []
    for name, fn in stages:
        t = measure.pipelined_ms(fn, args.iters, dev) * 1e-3
        print(f"{name:<28} {t * 1e6:>10.0f}us {t / B * 1e6:>10.1f}us {B / t:>12.0f}", flush=True)
        rows.append({"stage": name, "us_per_call": t * 1e6, "us_per_lane": t / B * 1e6,
                     "solves_per_s": B / t})

    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if dev.type == "cuda" else [])
        full = stages[-1][1]
        with profile(activities=activities) as prof:
            full()
            protocol.synchronize(dev)
        os.makedirs(args.trace, exist_ok=True)
        trace = os.path.join(args.trace, TRACE_FILE)
        prof.export_chrome_trace(trace)
        print(f"# trace written to {trace} (open with Perfetto)", flush=True)
    print(json.dumps({"device": label, "backend": args.backend, "B": B, "N": N,
                      "iters": args.iters, "rows": rows, "trace": trace}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
