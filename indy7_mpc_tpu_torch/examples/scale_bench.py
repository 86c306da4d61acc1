"""Lane-scaling benchmark: batched SQP throughput against the batch size
(port of ``examples/scale_bench.py``).

Usage: python3 -m indy7_mpc_tpu_torch.examples.scale_bench [N] [iters]
           [--mesh] [--device cuda|cpu]

Covers the BASELINE.json scale configurations (64 / 256 / 1,024 / 4,096
lanes) with per-lane wrench hypotheses and warm-started solves.  Each B
solves ``bench.py``'s inputs (``measure.production_inputs``) on kernel K1
(``solvers/sqp_cuda.py::batch_solve_fn``): one warm-up solve, then
``max(5, 2000 // max(B // 64, 1))`` warm-started solves queued back to
back with one sync at the end, on the host clock.  Prints one JSON line
a row (``B``, ``us_per_batch``, ``solves_per_sec``, ``finite``: X finite
after the last solve, read once after the timing), then the final line
with ``N``, ``sqp_iters``, ``sharded_mesh`` and the rows, each with its
``scaling_efficiency_vs_b64``.

``--mesh`` runs the same sweep through the lane-sharded path
(``parallel.make_sharded_batch_solve(..., backend="kernel")``): one
process a rank (``parallel/_worker.py::spawn``), one rank a visible card
over NCCL (with ``--device cpu``, 2 ranks over gloo).  Each rank commits
its block of the inputs once with ``shard_lanes`` before the timing, and
a row's time is the slowest rank's.  It first prints
``{"mesh_devices": R, "backend": "kernel-nccl"}`` (or ``kernel-gloo``).
On one card the mesh is one rank: the code path, not a scaling figure.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as tdist

from .. import measure
from ..config import CostConfig, SQPConfig
from ..models import indy7
from ..parallel import _worker, make_sharded_batch_solve, shard_lanes
from ..solvers import sqp_cuda
from . import protocol

BS, DT, CPU_RANKS = (64, 256, 1024, 4096), 0.01, 2


def default_reps(B: int) -> int:
    """The solves timed at B lanes (``examples/scale_bench.py``'s)."""
    return max(5, 2000 // max(B // 64, 1))


def sweep(dev, N=32, iters=2, Bs=BS, reps=None, mesh=None, emit=None):
    """The sweep over ``Bs`` at horizon N and ``iters`` SQP iterations, on
    ``dev``, or on this rank's lane block of ``mesh`` (call it on every
    rank).  ``reps`` overrides :func:`default_reps`; ``emit(row)`` gets
    each row as it is measured.  Returns (the final line, ``{B: (inputs of
    the last solve, its SQPResult)}``), this rank's block under a mesh."""
    model = indy7(torch.float32, dev)
    cost, sqp = CostConfig(), SQPConfig(max_iters=iters)
    if mesh is None:
        solve = sqp_cuda.batch_solve_fn(model, cost, sqp, DT)
    else:
        solve = make_sharded_batch_solve(model, cost, sqp, DT, mesh, backend="kernel")
    rows, last = [], {}
    for B in Bs:
        xs, goals, X, U, w = args = measure.production_inputs(dev, B, N)
        if mesh is not None:
            # Commit the block once: the deployed steady state keeps the
            # warm starts and hypotheses on the device between ticks.
            xs, goals, X, U, w = args = shard_lanes(mesh, args)
        r = solve(*args)
        protocol.synchronize(dev)
        n = reps or default_reps(B)
        if mesh is not None:
            mesh.all_reduce(torch.zeros(1, device=dev))  # start together
        t0 = time.perf_counter()
        for _ in range(n):
            args = (xs, goals, r.X, r.U, w)
            r = solve(*args)
        protocol.synchronize(dev)
        t = time.perf_counter() - t0
        # One host read: the slowest rank's time and whether any X is not
        # finite.
        stat = torch.stack([torch.tensor(t, dtype=torch.float64, device=r.X.device),
                            (~torch.isfinite(r.X).all()).to(torch.float64)])
        if mesh is not None and mesh.size > 1:
            tdist.all_reduce(stat, op=tdist.ReduceOp.MAX, group=mesh.group)
        t, bad = stat.tolist()
        t /= n
        row = dict(B=B, us_per_batch=round(t * 1e6), solves_per_sec=round(B / t),
                   finite=not bad)
        rows.append(row)
        last[B] = (args, r)
        if emit is not None:
            emit(dict(row))
    base = rows[0]["solves_per_sec"] / 64
    for row in rows:
        row["scaling_efficiency_vs_b64"] = round(row["solves_per_sec"] / row["B"] / base, 3)
    final = {"N": N, "sqp_iters": iters,
             "sharded_mesh": None if mesh is None else mesh.size, "sweep": rows}
    return final, last


def sweep_job(mesh, N, iters, Bs, reps):
    """:func:`sweep` on one rank: its printed rows, the final line, this
    rank's K1 launches and each row's final X and U, whole (numpy)."""
    from ..ops.kernels.sqp_kernel import sqp_solve

    rows = []
    final, last = sweep(mesh.device, N, iters, Bs, reps, mesh, emit=rows.append)
    whole = lambda t: mesh.gather(t).cpu().numpy()
    return {"rank": mesh.rank, "rows": rows, "final": final, "launches": sqp_solve.launches,
            "X": {B: whole(r.X) for B, (_, r) in last.items()},
            "U": {B: whole(r.U) for B, (_, r) in last.items()}}


def mesh_layout(dev):
    """(ranks, process-group backend) of ``--mesh`` on ``dev``: a rank a
    visible card over NCCL, or CPU_RANKS ranks over gloo on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device_count(), "nccl"
    return CPU_RANKS, "gloo"


def run_mesh(dev, N=32, iters=2, Bs=BS, reps=None, timeout=900.0) -> list:
    """:func:`sweep_job` on every rank of :func:`mesh_layout`, each a
    process of its own; the ranks' results in rank order."""
    ranks, backend = mesh_layout(dev)
    return _worker.spawn(sweep_job, ranks, N, iters, tuple(Bs), reps,
                         device=None if dev.type == "cuda" else "cpu", backend=backend,
                         timeout=timeout)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("N", nargs="?", type=int, default=32)
    ap.add_argument("iters", nargs="?", type=int, default=2)
    ap.add_argument("--mesh", action="store_true",
                    help="run the sweep through the lane-sharded path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Run the sweep and print its lines.  Returns (the final line, the
    outputs): without ``--mesh`` :func:`sweep`'s ``{B: (inputs, result)}``,
    with it the ranks' :func:`sweep_job` results."""
    args = build_parser().parse_args(argv)
    dev = protocol.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    emit = lambda row: print(json.dumps(row), flush=True)
    if args.mesh:
        ranks, backend = mesh_layout(dev)
        print(json.dumps({"mesh_devices": ranks, "backend": f"kernel-{backend}"}), flush=True)
        out = run_mesh(dev, args.N, args.iters, BS)
        final = out[0]["final"]
        for row in out[0]["rows"]:
            emit(row)
    else:
        final, out = sweep(dev, args.N, args.iters, BS, emit=emit)
    print(json.dumps(final), flush=True)
    return final, out


if __name__ == "__main__":
    main()
